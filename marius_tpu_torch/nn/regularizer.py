"""Norm regularization over embedding batches.

Port of ``marius_tpu/nn/regularizer.py`` (reference nn/regularizer.cpp:6):
coefficient * mean of the p-th power of row norms, addable to any loss. As in
the reference it is wired into no trainer; add the result to a loss when
composing models through the Python API.
"""

from __future__ import annotations

import torch


def norm_regularizer(embeddings: torch.Tensor, p: int = 2,
                     coefficient: float = 1.0) -> torch.Tensor:
    """coefficient * mean_i ||e_i||_p^p (NormRegularizer::operator())."""
    return coefficient * (embeddings.abs() ** p).sum(dim=-1).mean()
