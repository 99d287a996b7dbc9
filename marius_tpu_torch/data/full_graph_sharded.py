"""Node-sharded full-graph aggregation: the ring of block rotations.

Port of ``marius_tpu/data/full_graph_sharded.py`` (ShardedFullGraph :41,
build_sharded_full_graph :67, build_sharded_from_csr :84, _build_from_pairs
:95, shard_rows :130, place_on_mesh :142, make_nbr_sum_sharded :161,
make_gat_ring :205-301) on ``torch.distributed``. Node rows (activations,
features, degrees) are sharded over one mesh axis in original id order:
node i lives on shard i // n_loc at local row i % n_loc, n_loc = ceil(N/S),
and rows past N are padding. Each layer's combined (in+out) neighbour sum
runs as an S-step ring:

  step k: every shard sums the edge block whose SOURCES live on shard
          (s - k) mod S, the block that is visiting it, then the block
          moves one hop on (``Mesh.ring_start``, JAX's ``lax.ppermute``).

The hop of step k is posted before step k's local sum and waited for
after it, so the transfer overlaps the sum. A rank holds its own n_loc
rows, one visiting block and its accumulators; no rank assembles an (N, d)
activation.

- **The neighbour sum** (SAGE, GCN). Each step's ``blk[nbr]`` + sorted
  ``segment_sum`` is one launch of the gather-sum kernel
  (``ops/cuda/nbr_sum.py``) over a layout built once at set-up from that
  step's ``flat_nbr``/``flat_seg``: destination rows bucketed by their slot
  count as the full-graph adjacency's, padding ids n_loc reading nothing.
  The combined multiset is symmetric, so the backward is the same ring on
  the upstream gradient.
- **GAT** (``GatRing``). Slot logits decompose as leaky(L_i + R_j), so only
  the (n_loc, h) R block and the (n_loc, h*hd) value block rotate: a max
  pass (R only, no gradient: the caller stops it) and a sum pass (R and t)
  returning (denom, numer). Per-slot rows come through the row-gather
  kernel, per-anchor sums through the gather-sum kernel over slot
  positions. JAX differentiates its sum pass through ``ppermute``; here the
  backward is written out: dL sums locally, dR and dt of a visiting block
  sum beside it (the gather-sum kernel over each visiting row's slots,
  never a scatter) and ride with it around the ring, and one more hop after
  step S-1 brings them home. Attention dropout masks e in the numerator
  only; the mask of (shard, step k) comes from ``key.fold(shard * S + k)``
  as JAX's ``fold_in`` (``nn/layers`` ``DropoutKey``).

The ring-sharded RGCN (two schedules) lives beside the single-device one in
``data/full_graph_rel.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from marius_tpu_torch.data.full_graph import _greedy_buckets
from marius_tpu_torch.ops.cuda import nbr_sum as nbr_sum_kernel
from marius_tpu_torch.ops.cuda.gather import gather_rows
from marius_tpu_torch.ops.segment import segment_max

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ShardedFullGraph:
    """Ring-scheduled edge blocks for an S-way node sharding.

    ``flat_nbr[k]`` / ``flat_seg[k]``: (S, cap_k) int32 (one row, this
    rank's, once :func:`place_on_mesh` has placed it). Shard s's row holds
    the edges whose destination s owns and whose source t = (s-k) mod S
    owns: ``flat_nbr`` is the source's LOCAL row in t's block (pad =
    n_loc), ``flat_seg`` the destination's local row (pad = n_loc). Within a
    row, slots are destination-major (CSR order), so segment ids are sorted.
    """

    flat_nbr: Tuple[Tensor, ...]
    flat_seg: Tuple[Tensor, ...]
    num_nodes: int
    num_shards: int
    n_loc: int

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.n_loc


def build_sharded_full_graph(edges: np.ndarray, num_nodes: int, num_shards: int,
                             pad_multiple: int = 128) -> ShardedFullGraph:
    """Split the combined (in+out) edge multiset into the S x S ring blocks:
    exact slot counts per block, each step's blocks padded to the step's
    largest over shards, rounded up to ``pad_multiple``."""
    e = np.asarray(edges)
    src = e[:, 0].astype(np.int64)
    dst = e[:, -1].astype(np.int64)
    # every edge contributes both directions
    return _build_from_pairs(np.concatenate([dst, src]), np.concatenate([src, dst]),
                             num_nodes, num_shards, pad_multiple)


def build_sharded_from_csr(offsets: np.ndarray, nbrs: np.ndarray, num_nodes: int,
                           num_shards: int, pad_multiple: int = 128) -> ShardedFullGraph:
    """The same from an already combined symmetric CSR (``data/full_graph.py``
    ``host_csr_from_adjacency``'s output)."""
    deg = np.diff(np.asarray(offsets)).astype(np.int64)
    a = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    return _build_from_pairs(a, np.asarray(nbrs).astype(np.int64), num_nodes, num_shards,
                             pad_multiple)


def _build_from_pairs(a: np.ndarray, o: np.ndarray, num_nodes: int, num_shards: int,
                      pad_multiple: int) -> ShardedFullGraph:
    s = num_shards
    n_loc = -(-num_nodes // s)
    a_shard, a_local = a // n_loc, a % n_loc
    o_shard, o_local = o // n_loc, o % n_loc
    step = (a_shard - o_shard) % s
    # destination-major order within each (step, anchor-shard) block
    order = np.lexsort((a_local, a_shard, step))
    a_shard, a_local = a_shard[order], a_local[order]
    o_local, step = o_local[order], step[order]

    flat_nbr, flat_seg = [], []
    for k in range(s):
        in_k = step == k
        caps = np.bincount(a_shard[in_k], minlength=s)
        cap = int(caps.max()) if caps.size else 0
        cap = max(-(-max(cap, 1) // pad_multiple) * pad_multiple, pad_multiple)
        nbr = np.full((s, cap), n_loc, np.int32)
        seg = np.full((s, cap), n_loc, np.int32)
        for sh in range(s):
            m = in_k & (a_shard == sh)
            cnt = int(m.sum())
            nbr[sh, :cnt] = o_local[m]
            seg[sh, :cnt] = a_local[m]
        flat_nbr.append(torch.from_numpy(nbr))
        flat_seg.append(torch.from_numpy(seg))
    return ShardedFullGraph(flat_nbr=tuple(flat_nbr), flat_seg=tuple(flat_seg),
                            num_nodes=int(num_nodes), num_shards=s, n_loc=n_loc)


def shard_rows(x, n_loc: int, shard: int, device, dtype: Optional[torch.dtype] = None
               ) -> Tensor:
    """Shard ``shard``'s (n_loc, d) rows of the (N, d) ``x`` (numpy or a
    tensor), padding rows zero, on ``device`` (in ``dtype`` if given)."""
    x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    part = x[shard * n_loc:(shard + 1) * n_loc]
    out = torch.zeros((n_loc,) + tuple(x.shape[1:]), dtype=dtype or x.dtype, device=device)
    out[:part.shape[0]] = part.to(device=device, dtype=out.dtype)
    return out


def _place(v, shard: int, device):
    if isinstance(v, torch.Tensor):
        return (v[shard:shard + 1] if v.dim() > 1 else v).to(device)
    if isinstance(v, tuple):
        return tuple(_place(a, shard, device) for a in v)
    if dataclasses.is_dataclass(v):
        return dataclasses.replace(v, **{f.name: _place(getattr(v, f.name), shard, device)
                                         for f in dataclasses.fields(v)})
    return v


def place_on_mesh(graph, mesh, axis: str):
    """A ring structure with this rank's row of every leading-S array (kept
    as a leading dimension of 1) on the mesh's device; 1-D arrays (relation
    ids) are moved whole. Works for ShardedFullGraph and the relational
    ShardedRelGraph alike."""
    return _place(graph, mesh.axis_index(axis), mesh.device)


def csr_layout(seg: np.ndarray, vals: np.ndarray, num_out: int, pad: int,
               device) -> nbr_sum_kernel.GatherSumLayout:
    """One gather-sum call's layout: output row r sums ``vals`` at the slots
    whose ``seg`` is r, in slot order; slots with ``seg`` >= ``num_out`` are
    padding and dropped. Rows are bucketed by slot count as the full-graph
    adjacency's (``_greedy_buckets``); bucket padding holds ``pad``, which
    must lie outside the summed tensor's rows."""
    seg = np.asarray(seg).astype(np.int64)
    vals = np.asarray(vals).astype(np.int64)
    real = seg < num_out
    order = np.argsort(seg[real], kind="stable")
    seg_r, vals_r = seg[real][order], vals[real][order]
    counts = np.bincount(seg_r, minlength=num_out).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    perm = np.argsort(counts, kind="stable")
    bounds = _greedy_buckets(counts[perm])
    buckets = []
    for s, t in zip(bounds[:-1], bounds[1:]):
        rows = perm[s:t]
        c = counts[rows]
        cap = max(int(c.max()) if len(c) else 0, 1)
        blk = np.full((len(rows), cap), pad, np.int32)
        r_i = np.repeat(np.arange(len(rows)), c)
        cols = np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)
        blk[r_i, cols] = vals_r[np.repeat(offsets[rows], c) + cols]
        buckets.append(torch.from_numpy(blk).to(device))
    return nbr_sum_kernel.bucket_layout(buckets, torch.from_numpy(perm).to(device), num_out)


class _RingBase:
    """One rank's side of a ring over a placed ShardedFullGraph: per step,
    its slot rows and the layouts of their sums."""

    def __init__(self, graph: ShardedFullGraph, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.num_shards, self.n_loc = graph.num_shards, graph.n_loc
        self.shard = mesh.axis_index(axis)
        self.nbr = [b[0] for b in graph.flat_nbr]
        self.seg = [b[0] for b in graph.flat_seg]

    def _start(self, tensors, k: int):
        """Post the hop that brings step k + 1's block (None after the last step)."""
        return self.mesh.ring_start(tensors, self.axis) if k + 1 < self.num_shards else None


class NbrSumRing(_RingBase):
    """The combined neighbour sum as the S-step ring: one gather-sum launch
    per step over the visiting block."""

    def __init__(self, graph: ShardedFullGraph, mesh, axis: str):
        super().__init__(graph, mesh, axis)
        dev = mesh.device
        self.layouts = [csr_layout(seg.cpu().numpy(), nbr.cpu().numpy(), self.n_loc,
                                   self.n_loc, dev) for nbr, seg in zip(self.nbr, self.seg)]

    def run(self, x: Tensor) -> Tensor:
        """(n_loc, d) f32 sums of this rank's rows' neighbours."""
        acc, block = None, x.contiguous()
        for k in range(self.num_shards):
            pending = self._start([block], k)
            part = nbr_sum_kernel.nbr_sum(block, self.layouts[k])
            acc = part if acc is None else acc + part
            if pending is not None:
                block = pending.wait()[0]
        return acc


class _RingNbrSum(torch.autograd.Function):
    """(A x)^T's vjp is A^T u = A u: the combined multiset is symmetric, so
    the backward is the same ring on the cotangent."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring, ctx.dtype = ring, x.dtype
        return ring.run(x).to(x.dtype)

    @staticmethod
    def backward(ctx, u):
        return ctx.ring.run(u.to(ctx.dtype)).to(ctx.dtype), None


def make_nbr_sum_sharded(graph: ShardedFullGraph, mesh, axis: str):
    """``nbr_sum``: this rank's (n_loc, d) rows -> their combined neighbour
    sums, the S-step ring over the placed ``graph``."""
    ring = NbrSumRing(graph, mesh, axis)

    def nbr_sum(x: Tensor) -> Tensor:
        return _RingNbrSum.apply(x, ring)

    return nbr_sum


def _leaky(z: Tensor, slope: float) -> Tensor:
    """``jax.nn.leaky_relu``: where(z >= 0, z, slope z)."""
    return torch.where(z >= 0, z, slope * z)


class GatRing(_RingBase):
    """GAT's two ring passes (JAX ``make_gat_ring``): :meth:`max` and
    :meth:`sum`."""

    def __init__(self, graph: ShardedFullGraph, mesh, axis: str):
        super().__init__(graph, mesh, axis)
        dev = mesh.device
        self.pos_layouts, self.inv_layouts = [], []
        for nbr, seg in zip(self.nbr, self.seg):
            nbr_h, seg_h = nbr.cpu().numpy(), seg.cpu().numpy()
            pos = np.arange(len(seg_h))
            # per destination row its slots; per visiting row its slots
            self.pos_layouts.append(csr_layout(seg_h, pos, self.n_loc, len(pos), dev))
            self.inv_layouts.append(csr_layout(nbr_h, pos, self.n_loc, len(pos), dev))

    @torch.no_grad()
    def max(self, l_vec: Tensor, r_vec: Tensor, slope: float) -> Tensor:
        """(n_loc, h) max over each row's neighbour slots of leaky(L_i + R_j)
        (-inf for a row without neighbours); rotates R."""
        n_loc = self.n_loc
        l_vec = l_vec.contiguous()
        m = torch.full_like(l_vec, float("-inf"))
        block = r_vec.contiguous()
        for k in range(self.num_shards):
            pending = self._start([block], k)
            seg = self.seg[k]
            lg = _leaky(gather_rows(l_vec, seg) + gather_rows(block, self.nbr[k]), slope)
            m = torch.maximum(m, segment_max(lg, seg.long(), n_loc + 1)[:n_loc])
            if pending is not None:
                block = pending.wait()[0]
        return m

    def keep_masks(self, shape_h: int, drop_rate: float, key, device):
        """Per step the (cap_k, h) keep-mask of this shard's slots, from
        ``key.fold(shard * S + k)``. Every shard's masks are drawn, in one
        order on every rank, so a key that draws in call order (the
        default ``DropoutKey``) stays the same on every rank and gives each
        shard its own bits."""
        s = self.num_shards
        return [[key.fold(sh * s + k).keep((self.seg[k].shape[0], shape_h), 1.0 - drop_rate,
                                           device) for sh in range(s)][self.shard]
                for k in range(s)]

    def sum(self, l_vec: Tensor, r_vec: Tensor, t: Tensor, m: Tensor, slope: float,
            drop_rate: float = 0.0, drop_key=None):
        """(denom (n_loc, h), numer (n_loc, h*hd)): per row, the sums over its
        neighbour slots of e = exp(leaky(L_i + R_j) - m_i) and of e * t_j
        (e dropped out in the numerator only); rotates R and t.
        Differentiable in l_vec, r_vec and t (m is a constant)."""
        masks = None
        if drop_key is not None and drop_rate > 0.0:
            masks = self.keep_masks(l_vec.shape[1], drop_rate, drop_key, l_vec.device)
        else:
            drop_rate = 0.0
        return _GatRingSum.apply(l_vec, r_vec, t, m.detach(), self, slope, drop_rate, masks)

    def _slot_terms(self, k, l_vec, m, rb, tb, slope, drop_rate, masks):
        """Step k's slot tensors: (z, e, e_num, vt) over the (cap_k,) slots."""
        seg, nbr = self.seg[k], self.nbr[k]
        z = gather_rows(l_vec, seg) + gather_rows(rb, nbr)
        e = torch.exp(_leaky(z, slope) - gather_rows(m, seg))
        e_num = e if masks is None else torch.where(masks[k], e / (1.0 - drop_rate), 0.0)
        return z, e, e_num, gather_rows(tb, nbr)


class _GatRingSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l_vec, r_vec, t, m, ring, slope, drop_rate, masks):
        ctx.save_for_backward(l_vec, r_vec, t, m)
        ctx.ring, ctx.slope, ctx.drop_rate, ctx.masks = ring, slope, drop_rate, masks
        h = l_vec.shape[1]
        hd = t.shape[1] // h
        l_vec, m = l_vec.contiguous(), m.contiguous()
        rb, tb = r_vec.contiguous(), t.contiguous()
        denom = numer = None
        for k in range(ring.num_shards):
            pending = ring._start([rb, tb], k)
            _, e, e_num, vt = ring._slot_terms(k, l_vec, m, rb, tb, slope, drop_rate, masks)
            weighted = (e_num[:, :, None] * vt.view(-1, h, hd)).reshape(-1, h * hd)
            d_k = nbr_sum_kernel.nbr_sum(e, ring.pos_layouts[k])
            n_k = nbr_sum_kernel.nbr_sum(weighted.contiguous(), ring.pos_layouts[k])
            denom = d_k if denom is None else denom + d_k
            numer = n_k if numer is None else numer + n_k
            if pending is not None:
                rb, tb = pending.wait()
        return denom, numer

    @staticmethod
    def backward(ctx, g_denom, g_numer):
        l_vec, r_vec, t, m = ctx.saved_tensors
        ring, slope, drop_rate, masks = ctx.ring, ctx.slope, ctx.drop_rate, ctx.masks
        h = l_vec.shape[1]
        hd = t.shape[1] // h
        l_vec, m = l_vec.contiguous(), m.contiguous()
        g_denom = (torch.zeros_like(l_vec) if g_denom is None else g_denom).contiguous()
        g_numer = (torch.zeros_like(t) if g_numer is None else g_numer).contiguous()
        rb, tb = r_vec.contiguous(), t.contiguous()
        dl = None
        drb, dtb = torch.zeros_like(rb), torch.zeros_like(tb)
        for k in range(ring.num_shards):
            pending = ring._start([rb, tb], k)
            z, e, e_num, vt = ring._slot_terms(k, l_vec, m, rb, tb, slope, drop_rate, masks)
            seg = ring.seg[k]
            gn = gather_rows(g_numer, seg).view(-1, h, hd)
            dot = (gn * vt.view(-1, h, hd)).sum(-1)                     # (cap, h)
            if masks is not None:
                dot = torch.where(masks[k], dot / (1.0 - drop_rate), 0.0)
            dz = (gather_rows(g_denom, seg) + dot) * e * torch.where(z >= 0, 1.0, slope)
            dz = dz.contiguous()
            dl_k = nbr_sum_kernel.nbr_sum(dz, ring.pos_layouts[k])
            dl = dl_k if dl is None else dl + dl_k
            # the visiting block's gradients sum beside it, per visiting row
            drb = drb + nbr_sum_kernel.nbr_sum(dz, ring.inv_layouts[k])
            dtb = dtb + nbr_sum_kernel.nbr_sum(
                (e_num[:, :, None] * gn).reshape(-1, h * hd).contiguous(), ring.inv_layouts[k])
            if pending is not None:
                rb, tb = pending.wait()
                drb, dtb = ring.mesh.ring_shift([drb, dtb], ring.axis)
        if ring.num_shards > 1:
            # one more hop brings the accumulators home
            drb, dtb = ring.mesh.ring_shift([drb, dtb], ring.axis)
        return dl, drb, dtb, None, None, None, None, None


def make_gat_ring(graph: ShardedFullGraph, mesh, axis: str) -> GatRing:
    """GAT's ring passes over the placed ``graph`` (``ring.max``, ``ring.sum``)."""
    return GatRing(graph, mesh, axis)
