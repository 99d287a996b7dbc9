"""Full-graph padded adjacency and the exact ALL-neighbour sum over it.

Port of ``marius_tpu/data/full_graph.py`` (FullGraphAdjacency :44-93,
_greedy_buckets :96-118, build_full_graph_adjacency :121-192 with
``locality_reorder``,
host_csr_from_adjacency :195-220, device_csr :223-230,
device_seed_flat_lists :233-267, make_nbr_sums :333-408, build_inverse_map
:411-437, make_permuters :440-455, make_gather_blocks :458-487). Every GNN layer
runs over ALL nodes with one fixed adjacency and the batch's rows are sliced
from the result, which equals unbounded ALL sampling.

- **One symmetrised structure.** Each node's in- and out-neighbours form
  ONE combined list. The combined multiset is symmetric, so the
  neighbour-sum operator equals its transpose and its backward is the same
  gather-sum on the cotangent: no scatter.
- **Greedy degree buckets**, the same numpy as the JAX package, so the
  buckets match exactly: nodes in ascending-degree order, each bucket padded
  to its own max degree with the padding id N.
- **The kernel's own layout.** Where the JAX package lays each bucket out
  for XLA (``transpose_buckets``, ``_chunked_gather_sum``,
  ``relabel_buckets_sorted``, the ``sorted_space`` mode: TPU layout trades),
  the port hands every bucket to one call of the hand-written gather-sum
  kernel (``ops/cuda/nbr_sum.py``): each sorted row is written straight to
  its original-order row, and padding ids add zero without a sentinel row.

GAT weighs each slot, so it gathers every bucket's (n_b, cap_b, d) slot
block (``make_gather_blocks``, the row-gather kernel) and backs through the
inverse occurrence map (``build_inverse_map``): by symmetry each node's
occurrences as a neighbour fill a row of the same bucket shapes, so the
gather's backward is one more gather-sum kernel call, never a scatter. RGCN
reads the directional, per-relation companion (``data/full_graph_rel.py``),
built with ``with_relations=True``.

``locality_reorder`` relabels the gather SOURCE by reverse Cuthill-McKee
(scipy): bucket slots hold positions in a permuted copy of x
(``loc_perm[p]`` = the original id at position p), so one bucket's slots read
rows near each other. Each pass of the neighbour sum permutes its input with
the row-gather kernel (one-to-one, no atomics) before the gather-sum; the
composite operator is the plain one, symmetric, so the backward is the same
pair of calls on the cotangent. Inputs and outputs stay in original order, and
``host_csr_from_adjacency`` still gives original ids. Plain SAGE/GCN sums
only: not with the relational companion nor the inverse map.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from marius_tpu_torch.ops.cuda import nbr_sum as nbr_sum_kernel
from marius_tpu_torch.ops.cuda.gather import gather_rows

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FullGraphAdjacency:
    """Bucketed padded combined (in+out) neighbour lists for ALL nodes.

    Nodes are reordered ascending by total degree; bucket ``b`` occupies
    sorted rows [starts[b], starts[b] + nbrs[b].shape[0]). ``inv_pos[i]`` is
    node i's row in sorted order. Neighbour ids are ORIGINAL node ids;
    padding slots hold ``N``.
    """

    nbrs: Tuple[Tensor, ...]   # per bucket: (n_b, cap_b) int32, pad id = N
    inv_pos: Tensor            # (N,) int32: original id -> sorted row
    in_deg: Tensor             # (N,) int32, original order
    out_deg: Tensor            # (N,) int32, original order
    num_nodes: int
    # build_inverse_map: the buckets' shapes; sorted row r slot t = the flat
    # (bucket-major) slot of node perm[r]'s t-th occurrence as a neighbour,
    # pad = total_slots
    inv_map: Optional[Tuple[Tensor, ...]] = None
    # the directional per-relation companion RGCN stages read
    # (data/full_graph_rel.py RelFullGraph), with_relations=True
    rel: Optional[object] = None
    # locality_reorder=True: (N,) int32, the ORIGINAL id at each locality
    # position; bucket slots then hold locality positions
    loc_perm: Optional[Tensor] = None

    @property
    def total_slots(self) -> int:
        return sum(int(a.numel()) for a in self.nbrs)

    @property
    def bucket_starts(self) -> Tuple[int, ...]:
        out, s = [], 0
        for b in self.nbrs:
            out.append(s)
            s += int(b.shape[0])
        return tuple(out)

    @property
    def device(self) -> torch.device:
        return self.inv_pos.device

    def to(self, device) -> "FullGraphAdjacency":
        return dataclasses.replace(
            self, nbrs=tuple(b.to(device) for b in self.nbrs), inv_pos=self.inv_pos.to(device),
            in_deg=self.in_deg.to(device), out_deg=self.out_deg.to(device),
            inv_map=None if self.inv_map is None else tuple(b.to(device) for b in self.inv_map),
            rel=None if self.rel is None else self.rel.to(device),
            loc_perm=None if self.loc_perm is None else self.loc_perm.to(device))


def _greedy_buckets(deg_sorted: np.ndarray, waste: float = 1.15,
                    max_buckets: int = 40) -> np.ndarray:
    """Split an ascending degree sequence into bucket boundaries. A bucket
    closes when its max/min degree ratio exceeds ``waste``; then the
    cheapest adjacent pairs (least added padding) are merged until at most
    ``max_buckets`` remain, so a lone hub never forces wide padding onto a
    block of low-degree rows."""
    n = len(deg_sorted)
    bounds = [0]
    i = 0
    while i < n:
        lo = max(int(deg_sorted[i]), 1)
        j = int(np.searchsorted(deg_sorted, lo * waste, side="right"))
        i = min(max(j, i + 1), n)
        bounds.append(i)
    bounds = np.asarray(bounds, np.int64)
    while len(bounds) - 1 > max_buckets:
        caps = np.maximum(deg_sorted[bounds[1:] - 1], 1)
        rows = np.diff(bounds)
        merge_cost = rows[:-1] * (caps[1:] - caps[:-1])
        k = int(np.argmin(merge_cost))
        bounds = np.delete(bounds, k + 1)
    return bounds


def build_full_graph_adjacency(
        edges: np.ndarray, num_nodes: int,
        with_relations: bool = False,
        locality_reorder: bool = False) -> Optional[FullGraphAdjacency]:
    """Build the bucketed symmetric adjacency on the host (CPU tensors; the
    trainer moves it to its device). ``with_relations`` also builds the
    directional per-relation companion RGCN stages read;
    ``locality_reorder`` relabels the gather source by reverse
    Cuthill-McKee (see ``loc_perm``)."""
    if locality_reorder and with_relations:
        raise ValueError("locality_reorder supports the plain SAGE/GCN neighbour-sum path, "
                         "not the relational companion")
    e = np.asarray(edges)
    if len(e) == 0 or num_nodes == 0:
        return None
    src = e[:, 0].astype(np.int64)
    dst = e[:, -1].astype(np.int64)
    # combined multiset: anchor sees BOTH directions (self-transpose)
    anchor = np.concatenate([dst, src])
    other = np.concatenate([src, dst]).astype(np.int32)
    order = np.argsort(anchor, kind="stable")
    nbrs_sorted = other[order]
    offsets = np.searchsorted(anchor[order], np.arange(num_nodes + 1))
    loc_perm = None
    if locality_reorder:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        m = sp.csr_matrix((np.ones(len(anchor), np.int8), (anchor, other.astype(np.int64))),
                          shape=(num_nodes, num_nodes))
        loc_perm = np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True), np.int64)
        loc_inv = np.empty(num_nodes + 1, np.int32)
        loc_inv[loc_perm] = np.arange(num_nodes, dtype=np.int32)
        loc_inv[num_nodes] = num_nodes          # the padding id stays the padding id
        nbrs_sorted = loc_inv[nbrs_sorted]      # slot ids -> locality positions
    in_deg = np.bincount(dst, minlength=num_nodes).astype(np.int32)
    out_deg = np.bincount(src, minlength=num_nodes).astype(np.int32)
    deg = (offsets[1:] - offsets[:-1]).astype(np.int64)

    perm = np.argsort(deg, kind="stable")
    inv_pos = np.empty(num_nodes, np.int32)
    inv_pos[perm] = np.arange(num_nodes, dtype=np.int32)
    bounds = _greedy_buckets(deg[perm])

    buckets = []
    for s, t in zip(bounds[:-1], bounds[1:]):
        nodes = perm[s:t]
        d_b = deg[nodes]
        cap = max(int(d_b.max()) if len(d_b) else 0, 1)
        nbr = np.full((len(nodes), cap), num_nodes, np.int32)  # sentinel pad
        rows = np.repeat(np.arange(len(nodes)), d_b)
        cols = np.arange(int(d_b.sum())) - np.repeat(np.cumsum(d_b) - d_b, d_b)
        nbr[rows, cols] = nbrs_sorted[np.repeat(offsets[nodes], d_b) + cols]
        buckets.append(torch.from_numpy(nbr))

    rel = None
    if with_relations:
        from marius_tpu_torch.data.full_graph_rel import build_rel_full_graph
        rel = build_rel_full_graph(e, num_nodes)
    return FullGraphAdjacency(
        nbrs=tuple(buckets), inv_pos=torch.from_numpy(inv_pos),
        in_deg=torch.from_numpy(in_deg), out_deg=torch.from_numpy(out_deg),
        num_nodes=int(num_nodes), rel=rel,
        loc_perm=None if loc_perm is None else torch.from_numpy(loc_perm.astype(np.int32)))


def host_csr_from_adjacency(adj: FullGraphAdjacency) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side combined-neighbour CSR (offsets int64, nbrs int32) in
    ORIGINAL node order, derived from the buckets (no re-sort of the edge
    list). It feeds the per-batch seed lists of the seed-restricted final
    GNN stage."""
    deg = (adj.in_deg.cpu().numpy() + adj.out_deg.cpu().numpy()).astype(np.int64)
    offsets = np.zeros(adj.num_nodes + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    nbrs = np.empty(int(offsets[-1]), np.int32)
    perm = np.argsort(adj.inv_pos.cpu().numpy(), kind="stable")  # sorted row -> id
    row0 = 0
    for b in adj.nbrs:
        nb_ = b.cpu().numpy()
        nodes = perm[row0:row0 + nb_.shape[0]]
        d = deg[nodes]
        rows = np.repeat(np.arange(nb_.shape[0]), d)
        cols = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
        nbrs[np.repeat(offsets[nodes], d) + cols] = nb_[rows, cols]
        row0 += nb_.shape[0]
    if adj.loc_perm is not None:
        # bucket slots hold locality positions; the CSR holds original ids
        nbrs = np.concatenate([adj.loc_perm.cpu().numpy().astype(np.int32),
                               np.asarray([adj.num_nodes], np.int32)])[nbrs]
    return offsets, nbrs


def device_csr(csr, device) -> Tuple[Tensor, Tensor]:
    """int32 copy of ``host_csr_from_adjacency``'s output on ``device``."""
    offsets, nbrs = csr
    if int(offsets[-1]) >= np.iinfo(np.int32).max:
        raise ValueError("full-graph CSR exceeds int32 slots; use the sampled path")
    return (torch.as_tensor(offsets.astype(np.int32), device=device),
            torch.as_tensor(nbrs, device=device))


def device_seed_flat_lists(csr_dev: Tuple[Tensor, Tensor], seeds: Tensor, mask: Tensor,
                           budget: int, num_nodes: int) -> Tuple[Tensor, Tensor]:
    """Flat CSR neighbour list of one seed batch, built on the device.

    Returns (flat_nbr, flat_seg), both (budget,) int64: ``flat_nbr`` holds
    the concatenated neighbour ids of the batch's valid seeds (pad =
    num_nodes), ``flat_seg`` the seed row each slot belongs to (pad =
    batch size, dropped by segment ops). Masked seeds contribute no slots;
    slots are in seed-major CSR order. The caller passes a ``budget`` of at
    least the batch's degree sum; the trainer passes exactly that sum."""
    offsets, nbrs = csr_dev
    offsets = offsets.long()
    b = seeds.shape[0]
    s = seeds.long().clamp(max=num_nodes - 1)
    deg = (offsets[s + 1] - offsets[s]) * mask.long()
    cum = torch.cumsum(deg, 0)
    slots = torch.arange(budget, device=seeds.device)
    seg = torch.searchsorted(cum, slots, right=True)
    valid = slots < cum[-1]
    seg_c = seg.clamp(max=b - 1)
    start = cum[seg_c] - deg[seg_c]
    idx = offsets[s[seg_c]] + (slots - start)
    vals = nbrs[idx.clamp(0, max(nbrs.shape[0] - 1, 0))].long()
    flat_nbr = torch.where(valid, vals, num_nodes)
    flat_seg = torch.where(valid, seg_c, b)
    return flat_nbr, flat_seg


class _NbrSum(torch.autograd.Function):
    """(A x)^T's vjp is A^T u = A u: the combined multiset is symmetric, so
    the backward is the same gather-sum on the cotangent."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout, ctx.dtype = layout, x.dtype
        return nbr_sum_kernel.nbr_sum(x.contiguous(), layout).to(x.dtype)

    @staticmethod
    def backward(ctx, u):
        g = nbr_sum_kernel.nbr_sum(u.to(ctx.dtype).contiguous(), ctx.layout)
        return g.to(ctx.dtype), None


def nbr_sum_layout(adj: FullGraphAdjacency) -> nbr_sum_kernel.GatherSumLayout:
    """One kernel call's layout over every bucket: sorted row r writes the
    original-order row perm[r]."""
    perm = torch.argsort(adj.inv_pos.long(), stable=True)  # sorted row -> id
    return nbr_sum_kernel.bucket_layout(adj.nbrs, perm, adj.num_nodes)


class _LocalityNbrSum(torch.autograd.Function):
    """The neighbour sum over a locality adjacency: x permuted into locality
    order by the row-gather kernel (``x[loc_perm]``, one-to-one), then the
    gather-sum. The composite operator is the plain adjacency's, symmetric,
    so the backward is the same two kernel calls on the cotangent."""

    @staticmethod
    def forward(ctx, x, perm, layout):
        ctx.perm, ctx.layout, ctx.dtype = perm, layout, x.dtype
        return nbr_sum_kernel.nbr_sum(gather_rows(x.contiguous(), perm), layout).to(x.dtype)

    @staticmethod
    def backward(ctx, u):
        g = nbr_sum_kernel.nbr_sum(gather_rows(u.to(ctx.dtype).contiguous(), ctx.perm),
                                   ctx.layout)
        return g.to(ctx.dtype), None, None


def make_nbr_sums(adj: FullGraphAdjacency):
    """Returns ``nbr_sum``: x:(N, d) -> (N, d), the sum of each node's
    combined (in+out) neighbour rows, in original node order. One kernel
    call per pass, forward and backward alike; with ``loc_perm`` each pass
    first permutes its input into locality order (one row-gather call)."""
    layout = nbr_sum_layout(adj)
    if adj.loc_perm is None:
        def nbr_sum(x: Tensor) -> Tensor:
            return _NbrSum.apply(x, layout)
        return nbr_sum
    perm = adj.loc_perm

    def nbr_sum_local(x: Tensor) -> Tensor:
        return _LocalityNbrSum.apply(x, perm, layout)

    return nbr_sum_local


def build_inverse_map(adj: FullGraphAdjacency) -> FullGraphAdjacency:
    """Fill ``inv_map``: for each node, the flat (bucket-major) slots where
    it appears as a neighbour. By symmetry a node occurs exactly
    combined-degree times, so the map has the SAME bucket shapes as
    ``nbrs``. Host numpy, one stable argsort over the slots; the map lands
    on the adjacency's device."""
    if adj.inv_map is not None:
        return adj
    if adj.loc_perm is not None:
        raise ValueError("locality_reorder supports the plain SAGE/GCN neighbour-sum path, "
                         "not the inverse map")
    nbrs = [b.cpu().numpy() for b in adj.nbrs]
    flat = np.concatenate([b.reshape(-1) for b in nbrs])
    total = flat.shape[0]
    order = np.argsort(flat, kind="stable").astype(np.int64)
    occ_off = np.searchsorted(flat[order], np.arange(adj.num_nodes + 1))
    perm = np.argsort(adj.inv_pos.cpu().numpy(), kind="stable")   # sorted row -> id
    inv_buckets = []
    row0 = 0
    for b in nbrs:
        n_b, cap = b.shape
        nodes = perm[row0:row0 + n_b]
        d = (occ_off[nodes + 1] - occ_off[nodes]).astype(np.int64)
        inv = np.full((n_b, cap), total, np.int32)
        rows = np.repeat(np.arange(n_b), d)
        cols = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
        inv[rows, cols] = order[np.repeat(occ_off[nodes], d) + cols]
        inv_buckets.append(torch.from_numpy(inv).to(adj.device))
        row0 += n_b
    return dataclasses.replace(adj, inv_map=tuple(inv_buckets))


class _RowPermute(torch.autograd.Function):
    """``x[fwd]`` whose backward is the gather ``u[bwd]`` (a permutation's
    inverse), never a scatter."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return x[fwd]

    @staticmethod
    def backward(ctx, u):
        return u[ctx.bwd], None, None


def make_permuters(adj: FullGraphAdjacency):
    """(to_sorted, to_orig): row permutations into and out of the degree-
    sorted order, each with a gather-only backward."""
    inv_pos = adj.inv_pos.long()
    perm = torch.argsort(inv_pos, stable=True)          # sorted row -> id

    def to_sorted(x: Tensor) -> Tensor:
        return _RowPermute.apply(x, perm, inv_pos)

    def to_orig(x: Tensor) -> Tensor:
        return _RowPermute.apply(x, inv_pos, perm)

    return to_sorted, to_orig


class _PaddedGather(torch.autograd.Function):
    """(S, d) rows of x at the flat ids, the id N reading zeros (JAX's
    ``mode="fill"``): the row-gather kernel over x with a zero row appended.
    The backward is one gather-sum kernel call over ``layout``, the ids'
    occurrence lists (padding occurrences add zero)."""

    @staticmethod
    def forward(ctx, x, ids, layout):
        ctx.layout, ctx.dtype = layout, x.dtype
        x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        return gather_rows(x_pad, ids)

    @staticmethod
    def backward(ctx, u):
        g = nbr_sum_kernel.nbr_sum(u.to(ctx.dtype).contiguous(), ctx.layout)
        return g.to(ctx.dtype), None, None


def make_gather_blocks(adj: FullGraphAdjacency):
    """Returns ``gather_blocks``: x:(N, d) -> tuple of (n_b, cap_b, d)
    neighbour blocks, padding slots reading zeros. The backward sums each
    node's occurrences over ``inv_map`` in one gather-sum kernel call, the
    sorted rows landing in their original-order rows, so per-slot weighted
    aggregations (GAT) stay scatter-free."""
    if adj.inv_map is None:
        raise ValueError("call build_inverse_map(adj) first (needed for weighted aggregation)")
    ids = torch.cat([b.reshape(-1) for b in adj.nbrs])
    perm = torch.argsort(adj.inv_pos.long(), stable=True)   # sorted row -> id
    layout = nbr_sum_kernel.bucket_layout(adj.inv_map, perm, adj.num_nodes)
    shapes = [tuple(b.shape) for b in adj.nbrs]

    def gather_blocks(x: Tensor):
        flat = _PaddedGather.apply(x.contiguous(), ids, layout)
        parts = flat.split([n * cap for n, cap in shapes])
        return tuple(p.view(n, cap, x.shape[1]) for p, (n, cap) in zip(parts, shapes))

    return gather_blocks
