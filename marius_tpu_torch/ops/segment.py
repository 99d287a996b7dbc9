"""Segment reductions over a flat slot axis.

Port of ``segment_sum`` from ``marius_tpu/ops/segment.py`` (:75). The
seed-restricted final GNN stage sums each seed's flat neighbour slots with
it; the JAX package computes it outside Pallas, so the port uses PyTorch's
``index_add_`` (differentiable in ``data``). The masked and softmax
variants come with the sampled-GNN slice.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(num_segments, ...) sums of ``data`` rows by ``segment_ids``, which
    must lie in [0, num_segments) (``jax.ops.segment_sum`` drops ids outside
    it; callers reserve a last segment for padding instead)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)
