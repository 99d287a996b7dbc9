"""Neighbour-sampling configuration.

The ``NeighborSamplingConfig`` of ``marius_tpu/data/samplers/neighbor.py``
(:43-51), which the config loader fills from a GNN encoder's
``train_neighbor_sampling`` and ``eval_neighbor_sampling`` entries. The
sampler itself comes with the sampled-GNN slice; the full-graph NC path
needs no sampler.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NeighborSamplingConfig:
    """One entry per GNN layer, outermost hop first (NeighborSamplingConfig,
    marius_config.py; layer types options.h:80)."""

    sampling_type: str = "UNIFORM"   # ALL | UNIFORM | DROPOUT
    max_neighbors: int = 10          # fanout cap (datatypes.py:192)
    rate: float = 0.0                # dropout rate (DROPOUT)
    use_incoming: bool = True
    use_outgoing: bool = True
