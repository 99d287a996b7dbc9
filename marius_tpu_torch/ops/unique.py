"""Fixed-size unique ids for batch-local index mapping.

Port of ``unique_padded`` from ``marius_tpu/ops/unique.py`` (:28-38). The
bitmap and prefix variants there belong to the GNN slice. Built from one
sort, a cumulative sum and two scatters, all of static shape: unlike
``torch.unique``, whose output size depends on the data, it never reads a
count back to the host, so a CUDA caller is not synchronised once per batch.
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
    sorted_ids, order = torch.sort(flat)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = torch.cumsum(first, 0) - 1          # each sorted id's place among the uniques
    inverse = torch.empty_like(rank)
    inverse[order] = rank
    out = torch.full((size,), fill_value, dtype=ids.dtype, device=ids.device)
    # every copy of an id writes the same value to the same place
    out.scatter_(0, rank.clamp(max=size - 1), sorted_ids)
    count = (out < fill_value).sum()
    return UniqueResult(out, inverse.reshape(ids.shape), count)
