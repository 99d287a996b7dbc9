"""Batch structures of the sampled GNN path: plain dataclasses of tensors.

Port of ``LayerAdjacency`` (:32-48), ``NeighborBatch`` (:53-82) and
``NodeBatch`` (:87-92) of ``marius_tpu/data/batch.py`` (reference
data/batch.h:32-90, DENSEGraph graph.h:108). Every tensor has a static shape
set by the hop caps and the fanouts, with explicit validity masks, so a batch
never depends on the data for its size and nothing is read back to the host
while one is built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LayerAdjacency:
    """Sampled adjacency of one GNN hop in batch-local index space.

    Indices point into the *previous* (outer) layer's node array; the padded
    fanout layout (n, F) makes aggregation one gather-sum over fixed slots.
    """

    self_idx: Tensor       # (n,) int32 — position of each target node in the outer node array
    in_nbr_idx: Tensor     # (n, F_in) int32 positions of sampled incoming nbrs
    in_mask: Tensor        # (n, F_in) bool
    out_nbr_idx: Tensor    # (n, F_out) int32
    out_mask: Tensor       # (n, F_out) bool
    node_mask: Tensor      # (n,) bool — valid target nodes
    in_rel: Optional[Tensor] = None   # (n, F_in) int32 relation ids or None
    out_rel: Optional[Tensor] = None  # (n, F_out) int32


@dataclasses.dataclass(frozen=True)
class NeighborBatch:
    """Multi-hop sampled neighbourhood.

    ``node_ids[0]`` is the outermost (hop-L) node set, ``node_ids[-1]`` the
    seeds; ``layers[l]`` maps node set l+1's targets into node set l's index
    space, so GNN layer l consumes representations on node set l and
    produces them on node set l+1.
    """

    node_ids: Tuple[Tensor, ...]    # per-hop global node ids, padded with num_nodes
                                    # (frontier-prefix order: each hop's set is a
                                    # prefix of the next; sorted on the fallback path)
    node_masks: Tuple[Tensor, ...]  # per-hop validity
    layers: Tuple[LayerAdjacency, ...]
    # distinct NEW neighbour ids dropped by tight hop caps across all hops (0
    # under worst-case caps), a device scalar; the highest ids drop first
    overflow: Optional[Tensor] = None

    @property
    def seed_ids(self) -> Tensor:
        return self.node_ids[-1]

    @property
    def seed_mask(self) -> Tensor:
        return self.node_masks[-1]


@dataclasses.dataclass(frozen=True)
class NodeBatch:
    """A node-classification batch: seeds + labels."""

    seeds: Tensor          # (B,) node ids
    labels: Tensor         # (B,)
    mask: Tensor           # (B,) bool
