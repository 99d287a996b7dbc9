"""Fixed-size unique ids for batch-local index mapping.

Port of ``marius_tpu/ops/unique.py``: ``unique_padded`` (:28-38),
``unique_padded_bitmap`` (:41-72), ``prefix_unique_padded`` (:75-144) and
``unique_padded_auto`` (:154-163). All of static shape: unlike
``torch.unique``, whose output size depends on the data, none of them reads
a count back to the host, so a CUDA caller is not synchronised once per
batch. They are integer code and give the JAX functions' results exactly.

JAX's ``.at[idx].set(v, mode="drop")`` drops out-of-range writes; PyTorch
raises on them. Each such scatter here writes into a buffer with one extra
row that takes the dropped indices, and that row is sliced off. A constant
goes in with ``fill_`` or ``index_fill_``: assigning a Python number by
index copies it from the host and synchronises a CUDA caller.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

#: prefix_unique allocates O(num_nodes) temporaries per hop; above this the
#: sampler keeps the sorted path with overflow-free worst-case caps
PREFIX_BITMAP_LIMIT = 256_000_000

BITMAP_THRESHOLD = 65_536


class UniqueResult(NamedTuple):
    ids: Tensor      # (size,) sorted unique ids, padded with fill_value
    inverse: Tensor  # same shape as input; input[i] == ids[inverse[i]]
    count: Tensor    # scalar number of valid unique ids


def _set_dropping(size: int, fill_value: int, target: Tensor, values: Tensor) -> Tensor:
    """``full((size,), fill_value).at[target].set(values, mode="drop")`` for
    targets in [0, size]: index ``size`` is the dropped row."""
    out = torch.full((size + 1,), fill_value, dtype=values.dtype, device=values.device)
    out[target] = values
    return out[:size]


def unique_padded(ids: Tensor, size: int, fill_value: int) -> UniqueResult:
    """Sorted unique with static output size (``jnp.unique(size=...)``).

    ``fill_value`` must compare greater than every valid id (use num_nodes) so
    padding sorts to the tail and updates to it are dropped as out of range.
    With more distinct ids than ``size`` the output keeps the ``size``
    smallest and the inverse of the others points past the end, as in JAX.
    """
    flat = ids.reshape(-1)
    sorted_ids, order = torch.sort(flat)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = torch.cumsum(first, 0) - 1          # each sorted id's place among the uniques
    inverse = torch.empty_like(rank)
    inverse[order] = rank
    # every copy of an id writes the same value to the same place
    out = _set_dropping(size, fill_value, rank.clamp(max=size), sorted_ids)
    count = (out < fill_value).sum()
    return UniqueResult(out, inverse.reshape(ids.shape), count)


def unique_padded_bitmap(ids: Tensor, size: int, fill_value: int) -> UniqueResult:
    """Dedup via a node-id-space bitmap (reference computeDeltaIds,
    neighbor.cpp:511-524): mark every candidate, number the marked ids with
    a cumulative sum, scatter each into its slot, and read the inverse back
    with one gather. Sorted output like :func:`unique_padded`; needs
    ``fill_value`` == max valid id + 1."""
    flat = ids.reshape(-1).long()
    dev = flat.device
    mark = torch.zeros(fill_value + 1, dtype=torch.int32, device=dev)
    mark.index_fill_(0, flat, 1)
    mark[fill_value:].zero_()
    slot = torch.cumsum(mark, 0) - 1                # 0-based slots
    count = (slot[-1] + 1).to(torch.int32)
    target = torch.where((mark == 1) & (slot < size), slot, size)
    all_ids = torch.arange(fill_value + 1, dtype=ids.dtype, device=dev)
    uniq = _set_dropping(size, fill_value, target, all_ids)
    inverse = slot[flat].clamp(max=size - 1).to(torch.int32)
    return UniqueResult(uniq, inverse.reshape(ids.shape), count)


class PrefixUniqueResult(NamedTuple):
    ids: Tensor       # (size,) cur_ids ++ new unique ids, padded with fill
    inverse: Tensor   # candidates' shape: positions of the candidates
    count: Tensor     # scalar int32 total valid ids (cur + new)
    overflow: Tensor  # scalar int32 distinct new ids dropped by the cap


def prefix_unique_padded(cur_ids: Tensor, cur_mask: Tensor, candidates: Tensor,
                         size: int, fill_value: int) -> PrefixUniqueResult:
    """Frontier-prefix dedup: the output id set starts with ``cur_ids``
    verbatim (slots [0, n), invalid rows as fill); new candidate ids not
    already in cur fill the holes of invalid rows first, then slots n, n+1,
    ..., in ascending id order. When ``size`` leaves no room, the highest new
    ids drop; their candidates' inverse entries alias a kept slot (callers
    mask with ``ids[inverse] == candidate``) and ``overflow`` counts them.

    Requires fill_value == max valid id + 1 (the bitmaps are fill_value + 1
    wide) and ``size`` >= n.
    """
    n = cur_ids.shape[0]
    if size < n:
        raise ValueError(f"prefix cap {size} < current frontier {n}")
    dev = cur_ids.device
    i64 = torch.int64
    flat = candidates.reshape(-1).long()
    # position of each valid cur id (invalid rows leave HOLES that new ids
    # reclaim — without this, worst-case caps would spuriously overflow)
    pos_cur = torch.full((fill_value + 1,), -1, dtype=i64, device=dev)
    pos_cur[torch.where(cur_mask, cur_ids.long(), fill_value)] = torch.arange(n, device=dev)
    pos_cur[fill_value:].fill_(-1)
    is_new = torch.zeros(fill_value + 1, dtype=i64, device=dev)
    is_new.index_fill_(0, flat, 1)
    is_new[fill_value:].zero_()
    is_new = torch.where(pos_cur >= 0, 0, is_new)   # already resident in cur
    rank = torch.cumsum(is_new, 0)                   # 1-based ranks of new ids
    new_count = rank[-1]

    # free slots: holes in [0, n) first (ascending), then the tail [n, size)
    hole = ~cur_mask
    hrank = torch.cumsum(hole.long(), 0)             # 1-based hole ranks
    num_holes = hrank[-1]
    hole_pos = torch.full((n + 1,), size, dtype=i64, device=dev)
    hole_pos[torch.where(hole, hrank - 1, n)] = torch.arange(n, device=dev)
    hole_pos = hole_pos[:n]
    # rank 0 reads index -1, which JAX's plain indexing takes as n - 1
    # (the ids concerned are never new, so only masked slots see the value)
    at = (rank - 1).clamp(max=n - 1)
    at = torch.where(at < 0, at + n, at)
    slot_for_rank = torch.where(rank <= num_holes, hole_pos[at], n + (rank - 1) - num_holes)
    slot = torch.where(pos_cur >= 0, pos_cur, slot_for_rank)

    ids = torch.full((size + 1,), fill_value, dtype=cur_ids.dtype, device=dev)
    ids[:n] = torch.where(cur_mask, cur_ids, fill_value)
    target = torch.where((is_new == 1) & (slot < size), slot, size)
    ids[target] = torch.arange(fill_value + 1, dtype=cur_ids.dtype, device=dev)
    ids = ids[:size]
    inverse = slot[flat].clamp(max=size - 1).to(torch.int32)
    capacity = num_holes + (size - n)
    count = (cur_mask.sum() + torch.minimum(new_count, capacity)).to(torch.int32)
    overflow = (new_count - capacity).clamp(min=0).to(torch.int32)
    return PrefixUniqueResult(ids, inverse.reshape(candidates.shape), count, overflow)


def unique_padded_auto(ids: Tensor, size: int, fill_value: int) -> UniqueResult:
    """The bitmap for large candidate sets that are at least comparable to
    the id space, the sort otherwise (its O(fill_value) temporaries would
    dominate a small input in a huge graph). Requires fill_value == max
    valid id + 1."""
    if ids.numel() >= BITMAP_THRESHOLD and fill_value <= 8 * ids.numel():
        return unique_padded_bitmap(ids, size, fill_value)
    return unique_padded(ids, size, fill_value)
