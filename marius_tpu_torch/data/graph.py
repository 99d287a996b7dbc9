"""Graph structure (CSR both directions) and degrees, built on the host.

Port of ``marius_tpu/data/graph.py`` (DeviceGraph :25-44,
build_device_graph :54-83; reference data/graph.cpp:16-44): edge lists
sorted by src and by dst with searchsorted offsets, built once with numpy
and held as int32 tensors on ``device``. The neighbour sampler walks the
CSR; the full-graph NC trainer reads only ``num_nodes`` from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """CSR adjacency in both directions + degrees.

    Offsets have length num_nodes+2: index with ids clamped to num_nodes for
    padded lookups (degree 0 at the sentinel row).
    """

    out_offsets: Tensor   # (num_nodes+2,) int32 — CSR over src-sorted edges
    out_cols: Tensor      # (E,) int32 dst of src-sorted edges
    out_rels: Optional[Tensor]
    in_offsets: Tensor    # (num_nodes+2,) int32 — CSR over dst-sorted edges
    in_cols: Tensor       # (E,) int32 src of dst-sorted edges
    in_rels: Optional[Tensor]
    degrees: Tensor       # (num_nodes+1,) int32 total (in+out) degree; sentinel 0
    num_nodes: int
    num_relations: int

    @property
    def num_edges(self) -> int:
        return int(self.out_cols.shape[0])

    def to(self, device) -> "DeviceGraph":
        """The same graph with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), Tensor)})


def _csr_from_sorted(anchor_sorted: np.ndarray, num_nodes: int) -> np.ndarray:
    """Offsets (num_nodes+2,) from a sorted anchor column (graph.cpp:26-32)."""
    offsets = np.searchsorted(anchor_sorted, np.arange(num_nodes + 1)).astype(np.int32)
    return np.concatenate([offsets, offsets[-1:]]).astype(np.int32)


def build_device_graph(edges: np.ndarray, num_nodes: int, num_relations: int = 0,
                       device="cpu") -> DeviceGraph:
    """Build both-direction CSR from an (E, 2|3) numpy edge array."""
    e = np.asarray(edges)
    has_rel = e.shape[-1] == 3
    src = e[:, 0].astype(np.int32)
    dst = e[:, -1].astype(np.int32)
    rel = e[:, 1].astype(np.int32) if has_rel else None

    src_order = np.argsort(src, kind="stable")
    dst_order = np.argsort(dst, kind="stable")

    deg = np.zeros(num_nodes + 1, np.int32)
    np.add.at(deg, src, 1)
    np.add.at(deg, dst, 1)
    deg[num_nodes] = 0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return DeviceGraph(
        out_offsets=t(_csr_from_sorted(src[src_order], num_nodes)),
        out_cols=t(dst[src_order]),
        out_rels=t(rel[src_order]) if has_rel else None,
        in_offsets=t(_csr_from_sorted(dst[dst_order], num_nodes)),
        in_cols=t(src[dst_order]),
        in_rels=t(rel[dst_order]) if has_rel else None,
        degrees=t(deg),
        num_nodes=int(num_nodes),
        num_relations=int(num_relations),
    )
