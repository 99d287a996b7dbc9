"""Fixed-size unique ids for batch-local index mapping.

Port of ``unique_padded`` from ``marius_tpu/ops/unique.py`` (:28-38). The
bitmap and prefix variants there belong to the GNN slice. ``torch.unique``
has a data-dependent output size, so on a CUDA tensor this reads the count
back to the host (one synchronisation per call).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class UniqueResult(NamedTuple):
    ids: torch.Tensor      # (size,) sorted unique ids, padded with fill_value
    inverse: torch.Tensor  # same shape as input; input[i] == ids[inverse[i]]
    count: torch.Tensor    # scalar number of valid unique ids


def unique_padded(ids: torch.Tensor, size: int, fill_value: int) -> UniqueResult:
    """Sorted unique with static output size.

    ``fill_value`` must compare greater than every valid id (use num_nodes) so
    padding sorts to the tail and updates to it are dropped as out of range.
    ``size`` must be at least the number of distinct ids.
    """
    flat = ids.reshape(-1)
    uniq, inverse = torch.unique(flat, sorted=True, return_inverse=True)
    out = torch.full((size,), fill_value, dtype=ids.dtype, device=ids.device)
    m = min(size, uniq.shape[0])
    out[:m] = uniq[:m]
    count = (out < fill_value).sum()
    return UniqueResult(out, inverse.reshape(ids.shape), count)
