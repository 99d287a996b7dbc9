"""Edge membership tests (false-negative filtering) via int32 triples.

Port of ``marius_tpu/ops/edge_keys.py`` (:28-168; reference
data/samplers/negative.cpp:50-197). "Is (anchor, rel, other) a true edge?"
is answered for whole score matrices with one vectorized lexicographic binary
search over a pre-sorted edge set.

Keys stay THREE int32 components compared lexicographically and are never
packed into one int64: at Freebase86m's 86,054,151 nodes and 14,824
relations, N² · R exceeds 2⁶³. The JAX package's ``take_1d`` (a TPU
lane-layout gather) is plain indexing here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

_INT32_MAX = int(np.iinfo(np.int32).max)


class EdgeKeySet(NamedTuple):
    """Lexicographically sorted (anchor, rel, other) triples, int32."""

    anchor: Tensor  # (E,)
    rel: Tensor     # (E,) zeros for untyped graphs
    other: Tensor   # (E,)

    def to(self, device) -> "EdgeKeySet":
        return EdgeKeySet(*(t.to(device) for t in self))


def build_edge_key_set(edges: np.ndarray, corrupt_dst: bool, device="cpu") -> EdgeKeySet:
    """Sort edges into a key set for membership queries, on ``device``.

    corrupt_dst=True  -> anchored on (src, rel), candidates are dst nodes.
    corrupt_dst=False -> anchored on (dst, rel), candidates are src nodes.
    Accepts (E, 3) or (E, 2) edge arrays.
    """
    e = np.asarray(edges)
    has_rel = e.shape[-1] == 3
    src = e[:, 0].astype(np.int32)
    dst = e[:, -1].astype(np.int32)
    rel = e[:, 1].astype(np.int32) if has_rel else np.zeros_like(src)
    anchor, other = (src, dst) if corrupt_dst else (dst, src)
    order = np.lexsort((other, rel, anchor))
    anchor, rel, other = anchor[order], rel[order], other[order]
    # dedupe exact triples: membership is unchanged, and the rank correction
    # must count each true candidate exactly once
    if len(anchor):
        keep = np.concatenate([[True], (np.diff(anchor) != 0)
                               | (np.diff(rel) != 0) | (np.diff(other) != 0)])
        anchor, rel, other = anchor[keep], rel[keep], other[keep]
    return EdgeKeySet(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in (anchor, rel, other)))


def max_anchor_tail(edges: np.ndarray, corrupt_dst: bool) -> int:
    """Max number of DISTINCT candidates sharing one (anchor, rel) key —
    the static pad width of per-edge true-candidate lists."""
    e = np.asarray(edges)
    has_rel = e.shape[-1] == 3
    src = e[:, 0].astype(np.int64)
    dst = e[:, -1].astype(np.int64)
    rel = e[:, 1].astype(np.int64) if has_rel else np.zeros_like(src)
    anchor, other = (src, dst) if corrupt_dst else (dst, src)
    trip = np.unique(np.stack([anchor, rel, other], 1), axis=0)
    if not len(trip):
        return 1
    pair = trip[:, 0] * (trip[:, 1].max() + 1) + trip[:, 1]
    _, counts = np.unique(pair, return_counts=True)
    return int(counts.max())


def lexsort(keys: Sequence[Tensor]) -> Tensor:
    """``np.lexsort`` on the device: the order sorting by the LAST key first,
    ties broken by the earlier keys (stable sorts from the least significant)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _lex_less(a1, r1, o1, a2, r2, o2):
    return (a1 < a2) | ((a1 == a2) & ((r1 < r2) | ((r1 == r2) & (o1 < o2))))


def _lex_lower_bound(keys: EdgeKeySet, qa: Tensor, qr: Tensor, qo: Tensor) -> Tensor:
    """Insertion point of each flat (qa, qr, qo) query in the sorted set."""
    n = keys.anchor.shape[0]
    if n >= _INT32_MAX:
        raise ValueError("edge key set exceeds int32 rows; shard the filter edge set")
    steps = max(1, math.ceil(math.log2(max(n, 2))) + 1)
    lo = torch.zeros_like(qa)
    hi = torch.full_like(qa, n)
    for _ in range(steps):
        # overflow-safe midpoint: hi - lo <= n stays in int32 where lo + hi
        # would wrap (E > 2^30)
        mid = lo + (hi - lo) // 2
        midc = mid.clamp(max=n - 1).long()
        less = _lex_less(keys.anchor[midc], keys.rel[midc], keys.other[midc], qa, qr, qo)
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less, hi, mid)
    # a query above every key converges to n, and each further step compares
    # it with the clamped key n - 1 and moves lo to n + 1; the JAX search
    # returns that n + 1, which lengthens the LAST (anchor, rel) run of the
    # set by one repeated row in anchor_ranges
    return lo.clamp(max=n)


def isin_triples(keys: EdgeKeySet, anchor: Tensor, rel: Optional[Tensor],
                 other: Tensor) -> Tensor:
    """Vectorized membership of (anchor, rel, other) queries (any broadcastable
    shapes) against the sorted key set. Returns a bool tensor of the query shape."""
    qa, qr, qo = torch.broadcast_tensors(
        anchor.to(torch.int32),
        (rel if rel is not None else torch.zeros_like(anchor)).to(torch.int32),
        other.to(torch.int32))
    shape = qa.shape
    qa, qr, qo = qa.reshape(-1), qr.reshape(-1), qo.reshape(-1)
    n = keys.anchor.shape[0]
    lo = _lex_lower_bound(keys, qa, qr, qo)
    pos = lo.clamp(max=n - 1).long()
    found = ((lo < n) & (keys.anchor[pos] == qa) & (keys.rel[pos] == qr)
             & (keys.other[pos] == qo))
    return found.reshape(shape)


def anchor_ranges(keys: EdgeKeySet, anchors: Tensor, rels: Optional[Tensor]):
    """Per-query [lo, hi) row range of the key set holding (anchor, rel, *):
    two binary searches per query. The set is (anchor, rel, other)-sorted, so
    an edge's TRUE-candidate list is exactly this contiguous run."""
    qa = anchors.to(torch.int32)
    qr = (rels if rels is not None else torch.zeros_like(anchors)).to(torch.int32)
    lo = _lex_lower_bound(keys, qa, qr, torch.full_like(qa, -1))
    hi = _lex_lower_bound(keys, qa, qr, torch.full_like(qa, _INT32_MAX))
    return lo, hi


def filter_mask_all_nodes(keys: EdgeKeySet, anchors: Tensor, rels: Optional[Tensor],
                          num_nodes: int) -> Tensor:
    """(B, num_nodes) bool: True where (anchor_i, rel_i, j) is a known true edge
    (apply_score_filter, negative.cpp:306-311)."""
    cand = torch.arange(num_nodes, dtype=torch.int32, device=anchors.device)[None, :]
    return isin_triples(keys, anchors[:, None], None if rels is None else rels[:, None], cand)


def filter_mask_sampled(keys: EdgeKeySet, anchors: Tensor, rels: Optional[Tensor],
                        neg_ids: Tensor) -> Tensor:
    """(B, N) bool filter for chunked sampled negatives ``neg_ids (C, N)``:
    edge i in chunk c is tested against chunk c's shared negatives
    (compute_filter_corruption, negative.cpp:50-197)."""
    b = anchors.shape[0]
    c, n = neg_ids.shape
    a = anchors.reshape(c, b // c, 1)
    r = None if rels is None else rels.reshape(c, b // c, 1)
    cand = neg_ids.to(torch.int32)[:, None, :]
    return isin_triples(keys, a, r, cand).reshape(b, n)
