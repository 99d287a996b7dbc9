"""Relational full-graph structure: exact-ALL RGCN on one device.

Port of the single-device parts of ``marius_tpu/data/full_graph_rel.py``
(RelFullGraph, _bucketize_groups and build_rel_full_graph :43-163,
make_rel_sum :165-226 as :class:`RelSum`, host_out_csr, device_rel_csr,
device_seed_flat_lists_rel and edges_from_rel_graph :229-292). The sampled
RGCN layer (rgcn_layer.cpp) computes, for anchor i with out-edges (i, r, j),

    out_i = mean_e( x_j @ W_{r_e} ) + x_i @ W_self

and under unbounded ALL sampling the mean runs over ALL out-edges. Here it
runs for every node at once:

- **Relation-bucketed batched matmul.** Edges are grouped by relation,
  relations count-sorted and greedily bucketed (the degree buckets'
  ``_greedy_buckets``), each bucket padded to its largest count; one
  bucket's transform is one (n_rel, cap, d_in) x (n_rel, d_in, d_out)
  batched matmul.
- **Padding reads zeros.** Padding slots gather the zero row appended to x,
  so they transform to zeros.
- **Two gather-sum kernel calls, no edge-sized scatter.** The per-anchor sum
  of the transformed slots is one call over the anchor buckets; the slot
  gather's backward one call over each node's occurrence buckets. The
  anchor sum's backward is a plain gather (each slot feeds one anchor), and
  the only scatter is the W rows' backward, over relations.

The ring-sharded twins (:294-531: ``_RingRelCells``, ``ShardedRelGraph``,
``_build_ring_cells``, ``build_sharded_rel_graph``, ``make_rel_sum_sharded``)
run the node-sharded RGCN over ``torch.distributed``, in the row layout of
``data/full_graph_sharded.py``, with two ring schedules: **fwd** (anchor =
src) rotates x; **bwd** (anchor = dst: the directional operator is not
symmetric) rotates x and the cotangent u together. Per cell the visiting
rows come through the row-gather kernel, each relation bucket is one
batched matmul, and ``t_pad[perm]`` + the sorted segment sum is one
gather-sum launch (ids ``perm``, rows ``seg``). The relation weights'
gradient accumulates per relation bucket on each rank; its sum over the
ring axis is the trainer's one all_reduce of the batch's dense gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from marius_tpu_torch.data.full_graph import _greedy_buckets
from marius_tpu_torch.data.full_graph_sharded import csr_layout
from marius_tpu_torch.ops.cuda import nbr_sum as nbr_sum_kernel
from marius_tpu_torch.ops.cuda.gather import gather_rows

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RelFullGraph:
    """Relation- and anchor-bucketed views of one directed edge set.

    Flat slot space: relation buckets flattened bucket-major, row-major;
    ``total_slots`` = sum of n_b x cap_b over relation buckets. A slot is
    one (possibly padding) out-edge.
    """

    rel_nbr: Tuple[Tensor, ...]       # per bucket (n_rel_b, cap_b) int32 dst id, pad = N
    rel_ids: Tuple[Tensor, ...]       # per bucket (n_rel_b,) int64 W rows
    anchor_slots: Tuple[Tensor, ...]  # per bucket (n_b, capA_b) int32 slots, pad = T
    anchor_inv_pos: Tensor            # (N,) int32: original id -> sorted anchor row
    slot_src: Tensor                  # (T,) int32 anchor id of each slot, pad = N
    occ_slots: Tuple[Tensor, ...]     # per bucket (n_b, capO_b) int32 slots, pad = T
    occ_inv_pos: Tensor               # (N,) int32: original id -> sorted occurrence row
    out_deg: Tensor                   # (N,) int32
    num_nodes: int
    total_slots: int

    def to(self, device) -> "RelFullGraph":
        def move(v):
            return tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device)

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)
            if f.name not in ("num_nodes", "total_slots")})


def _bucketize_groups(group_of_item: np.ndarray, item_vals: np.ndarray, num_groups: int,
                      pad_val: int):
    """Per-group padded value lists, groups sorted ascending by size and
    greedily bucketed. Returns (buckets, group_row_ids, inv_pos):
    ``group_row_ids[b]`` are the ORIGINAL group ids of bucket b's rows and
    ``inv_pos`` maps group id -> global sorted row."""
    counts = np.bincount(group_of_item, minlength=num_groups).astype(np.int64)
    order = np.argsort(group_of_item, kind="stable")
    vals_sorted = item_vals[order]
    offsets = np.searchsorted(group_of_item[order], np.arange(num_groups + 1))

    perm = np.argsort(counts, kind="stable")
    inv_pos = np.empty(num_groups, np.int32)
    inv_pos[perm] = np.arange(num_groups, dtype=np.int32)
    bounds = _greedy_buckets(counts[perm])

    buckets, row_ids = [], []
    for s, t in zip(bounds[:-1], bounds[1:]):
        groups = perm[s:t]
        c = counts[groups]
        cap = max(int(c.max()) if len(c) else 0, 1)
        blk = np.full((len(groups), cap), pad_val, np.int32)
        rows = np.repeat(np.arange(len(groups)), c)
        cols = np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)
        blk[rows, cols] = vals_sorted[np.repeat(offsets[groups], c) + cols]
        buckets.append(blk)
        row_ids.append(groups.astype(np.int32))
    return buckets, row_ids, inv_pos


def build_rel_full_graph(edges: np.ndarray, num_nodes: int) -> RelFullGraph:
    """Build from an (E, 3) [src, rel, dst] (or (E, 2): all relation 0) edge
    array, on the host (CPU tensors)."""
    e = np.asarray(edges)
    src = e[:, 0].astype(np.int64)
    dst = e[:, -1].astype(np.int64)
    rel = e[:, 1].astype(np.int64) if e.shape[1] >= 3 else np.zeros(len(e), np.int64)
    num_rels = int(rel.max()) + 1 if len(rel) else 1

    # relation buckets over dst values; each real edge's flat slot
    rel_buckets, rel_row_ids, _ = _bucketize_groups(rel, dst.astype(np.int32), num_rels,
                                                    pad_val=num_nodes)
    counts = np.bincount(rel, minlength=num_rels).astype(np.int64)
    order_e = np.argsort(rel, kind="stable")
    offsets_e = np.searchsorted(rel[order_e], np.arange(num_rels + 1))
    slot_src, edge_slot = [], np.empty(len(e), np.int64)
    base = 0
    for blk, rows in zip(rel_buckets, rel_row_ids):
        n_b, cap = blk.shape
        s_blk = np.full((n_b, cap), num_nodes, np.int64)
        for i, r in enumerate(rows):
            c = int(counts[r])
            eidx = order_e[offsets_e[r]:offsets_e[r] + c]
            s_blk[i, :c] = src[eidx]
            edge_slot[eidx] = base + i * cap + np.arange(c, dtype=np.int64)
        slot_src.append(s_blk.reshape(-1))
        base += n_b * cap
    total_slots = base
    slot_src = np.concatenate(slot_src) if slot_src else np.empty(0, np.int64)
    if total_slots >= np.iinfo(np.int32).max:
        raise ValueError("relational full graph exceeds int32 slots; use the sampled path")

    # anchor buckets: each src sums its own edges' transformed slots;
    # occurrence buckets: each dst's slots, for the slot gather's backward
    anchor_buckets, _, anchor_inv = _bucketize_groups(src, edge_slot, num_nodes,
                                                      pad_val=total_slots)
    occ_buckets, _, occ_inv = _bucketize_groups(dst, edge_slot, num_nodes, pad_val=total_slots)

    def tensors(arrays):
        return tuple(torch.from_numpy(a) for a in arrays)

    return RelFullGraph(
        rel_nbr=tensors(rel_buckets),
        rel_ids=tuple(torch.from_numpy(r.astype(np.int64)) for r in rel_row_ids),
        anchor_slots=tensors(anchor_buckets), anchor_inv_pos=torch.from_numpy(anchor_inv),
        slot_src=torch.from_numpy(slot_src.astype(np.int32)),
        occ_slots=tensors(occ_buckets), occ_inv_pos=torch.from_numpy(occ_inv),
        out_deg=torch.from_numpy(np.bincount(src, minlength=num_nodes).astype(np.int32)),
        num_nodes=int(num_nodes), total_slots=int(total_slots))


def _layout(buckets, inv_pos: Tensor, num_nodes: int) -> nbr_sum_kernel.GatherSumLayout:
    """One gather-sum call over ``buckets``, sorted row r writing node perm[r]."""
    return nbr_sum_kernel.bucket_layout(buckets, torch.argsort(inv_pos.long(), stable=True),
                                        num_nodes)


class _RelGather(torch.autograd.Function):
    """x:(N, d) -> (T, d) rows at the relation buckets' slots, padding slots
    reading zeros; backward: one gather-sum call over each node's occurrence
    slots (padding occurrences, id T, add zero)."""

    @staticmethod
    def forward(ctx, x, ids, occ_layout):
        ctx.layout = occ_layout
        return gather_rows(torch.cat([x, x.new_zeros((1, x.shape[1]))]), ids)

    @staticmethod
    def backward(ctx, u):
        return nbr_sum_kernel.nbr_sum(u.contiguous(), ctx.layout), None, None


class _AnchorSum(torch.autograd.Function):
    """t:(T, d) -> (N, d): each node's sum over its out-edges' slots, one
    gather-sum call (padding slots, id T, add zero); backward: each slot's
    anchor row, a plain gather (padding slots, anchor N, read zeros)."""

    @staticmethod
    def forward(ctx, t, anchor_layout, slot_src):
        ctx.slot_src = slot_src
        return nbr_sum_kernel.nbr_sum(t, anchor_layout)

    @staticmethod
    def backward(ctx, u):
        u_pad = torch.cat([u, u.new_zeros((1, u.shape[1]))])
        return gather_rows(u_pad.contiguous(), ctx.slot_src), None, None


class RelSum:
    """``rel_sum(x, w_stack) -> (N, d_out)``: for every node, the SUM over
    its out-edges of x[dst] @ W[rel] (the caller divides by the out-degree
    for the RGCN mean). :meth:`gather_blocks` and :meth:`from_blocks` split
    the call so a constant input's slot gather can be cached while W stays
    live (``nn/full_graph_encoder.py`` ``_const_first_agg``)."""

    def __init__(self, rg: RelFullGraph):
        self.rg = rg
        self.ids = torch.cat([b.reshape(-1) for b in rg.rel_nbr])
        self.occ_layout = _layout(rg.occ_slots, rg.occ_inv_pos, rg.num_nodes)
        self.anchor_layout = _layout(rg.anchor_slots, rg.anchor_inv_pos, rg.num_nodes)

    def gather_blocks(self, x: Tensor) -> Tensor:
        """(T, d_in) rows of x at every relation slot (padding: zeros)."""
        return _RelGather.apply(x.contiguous(), self.ids, self.occ_layout)

    def from_blocks(self, flat: Tensor, w_stack: Tensor) -> Tensor:
        """Transform each bucket's slots by its relations' matrices, then sum
        per anchor."""
        d_out = w_stack.shape[-1]
        parts, s = [], 0
        for nbr, rids in zip(self.rg.rel_nbr, self.rg.rel_ids):
            n_b, cap = nbr.shape
            blk = flat[s:s + n_b * cap].view(n_b, cap, flat.shape[1])
            parts.append(torch.bmm(blk, w_stack[rids]).reshape(-1, d_out))
            s += n_b * cap
        t_flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        return _AnchorSum.apply(t_flat.contiguous(), self.anchor_layout, self.rg.slot_src)

    def __call__(self, x: Tensor, w_stack: Tensor) -> Tensor:
        return self.from_blocks(self.gather_blocks(x), w_stack)


def edges_from_rel_graph(rg: RelFullGraph) -> np.ndarray:
    """The (E, 3) [src, rel, dst] edge array back from the buckets."""
    src = rg.slot_src.cpu().numpy().astype(np.int64)
    dst = np.concatenate([b.cpu().numpy().reshape(-1) for b in rg.rel_nbr]).astype(np.int64)
    rel = np.concatenate([np.repeat(r.cpu().numpy(), b.shape[1])
                          for r, b in zip(rg.rel_ids, rg.rel_nbr)]).astype(np.int64)
    valid = src < rg.num_nodes
    return np.stack([src[valid], rel[valid], dst[valid]], 1)


def host_out_csr(rg: RelFullGraph):
    """Directed out-CSR with per-slot relation ids, ORIGINAL src order:
    (offsets (N+1,) int64, dst (E,) int32, rel (E,) int32). Backs the
    seed-restricted RGCN final stage."""
    e = edges_from_rel_graph(rg)
    src = e[:, 0]
    order = np.argsort(src, kind="stable")
    offsets = np.searchsorted(src[order], np.arange(rg.num_nodes + 1))
    return (offsets.astype(np.int64), e[order, 2].astype(np.int32),
            e[order, 1].astype(np.int32))


def device_rel_csr(csr, device) -> Tuple[Tensor, Tensor, Tensor]:
    """int32 copy of :func:`host_out_csr`'s output on ``device``."""
    offsets, dst, rel = csr
    if int(offsets[-1]) >= np.iinfo(np.int32).max:
        raise ValueError("relational CSR exceeds int32 slots; use the sampled path")
    return (torch.as_tensor(offsets.astype(np.int32), device=device),
            torch.as_tensor(dst, device=device), torch.as_tensor(rel, device=device))


def device_seed_flat_lists_rel(csr_dev, seeds: Tensor, mask: Tensor, budget: int,
                               num_nodes: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The flat OUT-edge lists of one seed batch, built on the device:
    (flat_nbr, flat_rel, flat_seg), each (budget,) int64, pads num_nodes, 0
    and the batch size. Slots are in seed-major CSR order; masked seeds have
    none."""
    offsets, nbrs, rels = csr_dev
    offsets = offsets.long()
    b = seeds.shape[0]
    s = seeds.long().clamp(max=num_nodes - 1)
    deg = (offsets[s + 1] - offsets[s]) * mask.long()
    cum = torch.cumsum(deg, 0)
    slots = torch.arange(budget, device=seeds.device)
    seg_c = torch.searchsorted(cum, slots, right=True).clamp(max=b - 1)
    valid = slots < cum[-1]
    idx = (offsets[s[seg_c]] + slots - (cum[seg_c] - deg[seg_c])).clamp(
        0, max(nbrs.shape[0] - 1, 0))
    return (torch.where(valid, nbrs[idx].long(), num_nodes),
            torch.where(valid, rels[idx].long(), 0),
            torch.where(valid, seg_c, b))


# --------------------------------------------------------------------------
# Ring-sharded RGCN: node-sharded exact-ALL relational aggregation
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _RingRelCells:
    """One direction's ring schedule. For ring step k, shard s owns the
    ANCHOR side of the cell's edges and gathers values from the visiting
    block (originally shard (s-k) mod S), relation-bucketed per step with
    shapes uniform across shards.

    nbr[k][b]:  (S, n_b, cap) gathered node's LOCAL row in the visiting
                block, pad = n_loc (reads the block's zero row)
    rel[k][b]:  (n_b,) relation ids (the same on every shard)
    anch[k][b]: (S, n_b, cap) anchor's LOCAL row, pad = n_loc
    perm[k]:    (S, T_k) anchor-sorted position -> flat (bucket-major) slot,
                pad = T_k
    seg[k]:     (S, T_k) anchor local row at each sorted position, sorted
                ascending, pad = n_loc
    """

    nbr: Tuple[Tuple[Tensor, ...], ...]
    rel: Tuple[Tuple[Tensor, ...], ...]
    anch: Tuple[Tuple[Tensor, ...], ...]
    perm: Tuple[Tensor, ...]
    seg: Tuple[Tensor, ...]


@dataclasses.dataclass(frozen=True)
class ShardedRelGraph:
    """Ring schedules for both flow directions of the RGCN operator: fwd
    (anchor = src: out_i sums its out-edges' transformed dst rows) and bwd
    (anchor = dst: the x-cotangent sums u[src] @ W^T per dst)."""

    fwd: _RingRelCells
    bwd: _RingRelCells
    num_nodes: int
    num_shards: int
    n_loc: int


def _build_ring_cells(anchor: np.ndarray, gathered: np.ndarray, rel: np.ndarray,
                      num_rels: int, num_shards: int, n_loc: int) -> _RingRelCells:
    s = num_shards
    a_own, a_loc = anchor // n_loc, anchor % n_loc
    g_own, g_loc = gathered // n_loc, gathered % n_loc
    step = ((a_own - g_own) % s).astype(np.int64)
    # one global stable sort by (step, anchor shard, relation): every cell is
    # then a contiguous run
    key = (step * s + a_own) * num_rels + rel
    order = np.argsort(key, kind="stable")
    off = np.searchsorted(key[order], np.arange(s * s * num_rels + 1))
    g_l, a_l = g_loc[order], a_loc[order]

    nbr_all, rel_all, anch_all, perm_all, seg_all = [], [], [], [], []
    for k in range(s):
        o0 = k * s * num_rels
        cnt = (off[o0 + 1:o0 + s * num_rels + 1] - off[o0:o0 + s * num_rels]).reshape(
            s, num_rels)
        maxcnt = cnt.max(axis=0)
        active = np.flatnonzero(maxcnt > 0)
        if len(active) == 0:
            nbr_all.append(())
            rel_all.append(())
            anch_all.append(())
            perm_all.append(torch.zeros((s, 0), dtype=torch.int32))
            seg_all.append(torch.zeros((s, 0), dtype=torch.int32))
            continue
        rows_order = active[np.argsort(maxcnt[active], kind="stable")]
        bounds = _greedy_buckets(maxcnt[rows_order])
        nbr_k, rel_k, anch_k = [], [], []
        slot_lists = [[] for _ in range(s)]   # (flat slot, anchor local row)
        base = 0
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            rows = rows_order[lo:hi]
            cap = max(int(maxcnt[rows].max()), 1)
            n_b = len(rows)
            nbr_b = np.full((s, n_b, cap), n_loc, np.int32)
            anch_b = np.full((s, n_b, cap), n_loc, np.int32)
            for sh in range(s):
                for i, r in enumerate(rows):
                    c = int(cnt[sh, r])
                    if c == 0:
                        continue
                    e0 = off[o0 + sh * num_rels + r]
                    nbr_b[sh, i, :c] = g_l[e0:e0 + c]
                    anch_b[sh, i, :c] = a_l[e0:e0 + c]
                    slots = base + i * cap + np.arange(c, dtype=np.int64)
                    slot_lists[sh].append((slots, a_l[e0:e0 + c].astype(np.int64)))
            nbr_k.append(torch.from_numpy(nbr_b))
            anch_k.append(torch.from_numpy(anch_b))
            rel_k.append(torch.from_numpy(rows.astype(np.int32)))
            base += n_b * cap
        t_k = base
        perm_k = np.full((s, t_k), t_k, np.int32)
        seg_k = np.full((s, t_k), n_loc, np.int32)
        for sh in range(s):
            if not slot_lists[sh]:
                continue
            slots = np.concatenate([p[0] for p in slot_lists[sh]])
            anchs = np.concatenate([p[1] for p in slot_lists[sh]])
            o = np.lexsort((slots, anchs))
            perm_k[sh, :len(slots)] = slots[o]
            seg_k[sh, :len(slots)] = anchs[o]
        nbr_all.append(tuple(nbr_k))
        rel_all.append(tuple(rel_k))
        anch_all.append(tuple(anch_k))
        perm_all.append(torch.from_numpy(perm_k))
        seg_all.append(torch.from_numpy(seg_k))
    return _RingRelCells(nbr=tuple(nbr_all), rel=tuple(rel_all), anch=tuple(anch_all),
                         perm=tuple(perm_all), seg=tuple(seg_all))


def build_sharded_rel_graph(edges: np.ndarray, num_nodes: int,
                            num_shards: int) -> ShardedRelGraph:
    """Both ring schedules from an (E, 3) [src, rel, dst] array, in the row
    layout of ShardedFullGraph (node i on shard i // n_loc at local row
    i % n_loc, n_loc = ceil(N/S)). Host tensors; ``place_on_mesh`` keeps a
    rank's rows."""
    e = np.asarray(edges)
    src = e[:, 0].astype(np.int64)
    dst = e[:, -1].astype(np.int64)
    rel = e[:, 1].astype(np.int64) if e.shape[1] >= 3 else np.zeros(len(e), np.int64)
    num_rels = int(rel.max()) + 1 if len(rel) else 1
    n_loc = -(-num_nodes // num_shards)
    return ShardedRelGraph(
        fwd=_build_ring_cells(src, dst, rel, num_rels, num_shards, n_loc),
        bwd=_build_ring_cells(dst, src, rel, num_rels, num_shards, n_loc),
        num_nodes=int(num_nodes), num_shards=int(num_shards), n_loc=int(n_loc))


class _RingCells:
    """One schedule's cells for this rank (a placed _RingRelCells): per
    step, per bucket (flat gathered rows, flat anchor rows, relation ids,
    n_b, cap), and the anchor sum's layout."""

    def __init__(self, cells: _RingRelCells, n_loc: int, device):
        self.buckets, self.layouts = [], []
        for k in range(len(cells.perm)):
            self.buckets.append([
                (nbr[0].reshape(-1).contiguous(), anch[0].reshape(-1).contiguous(),
                 rel.long(), int(nbr.shape[1]), int(nbr.shape[2]))
                for nbr, anch, rel in zip(cells.nbr[k], cells.anch[k], cells.rel[k])])
            perm = cells.perm[k][0].cpu().numpy()
            self.layouts.append(csr_layout(cells.seg[k][0].cpu().numpy(), perm, n_loc,
                                           len(perm), device))


class ShardedRelSum:
    """``rel_sum(x_loc, w_stack) -> (n_loc, d_out)``: this rank's rows' sums
    over their out-edges of x[dst] @ W[rel], as the ring (JAX
    ``make_rel_sum_sharded``). Differentiable in both; the gradient of the
    replicated ``w_stack`` is this rank's part."""

    def __init__(self, srg: ShardedRelGraph, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.num_shards, self.n_loc = srg.num_shards, srg.n_loc
        self.fwd = _RingCells(srg.fwd, srg.n_loc, mesh.device)
        self.bwd = _RingCells(srg.bwd, srg.n_loc, mesh.device)

    def _start(self, tensors, k: int):
        return self.mesh.ring_start(tensors, self.axis) if k + 1 < self.num_shards else None

    def cell_sums(self, cells: _RingCells, k: int, blk_pad: Tensor, w: Tensor,
                  transpose: bool) -> Optional[Tensor]:
        """Step k's per-anchor sums: the visiting rows gathered, transformed
        by W (or W^T) per relation bucket, summed per anchor in one
        gather-sum launch; None for a step without edges."""
        d = blk_pad.shape[1]
        parts = []
        for ids, _, rel, n_b, cap in cells.buckets[k]:
            rows = gather_rows(blk_pad, ids).view(n_b, cap, d)
            wb = w[rel]
            parts.append(torch.bmm(rows, wb.transpose(1, 2) if transpose else wb)
                         .reshape(n_b * cap, -1))
        if not parts:
            return None
        t_flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        return nbr_sum_kernel.nbr_sum(t_flat.contiguous(), cells.layouts[k])

    def __call__(self, x: Tensor, w_stack: Tensor) -> Tensor:
        return _RingRelSum.apply(x, w_stack, self)


def _pad_row(x: Tensor) -> Tensor:
    """``x`` with a zero row appended (the row padding ids read)."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))]).contiguous()


class _RingRelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ring):
        ctx.save_for_backward(x, w)
        ctx.ring = ring
        w = w.contiguous()
        acc = x.new_zeros((ring.n_loc, w.shape[-1]), dtype=torch.float32)
        xb = _pad_row(x)
        for k in range(ring.num_shards):
            pending = ring._start([xb], k)
            part = ring.cell_sums(ring.fwd, k, xb, w, False)
            if part is not None:
                acc = acc + part
            if pending is not None:
                xb = pending.wait()[0]
        return acc.to(x.dtype)

    @staticmethod
    def backward(ctx, u):
        x, w = ctx.saved_tensors
        ring = ctx.ring
        d_in, d_out = w.shape[-2], w.shape[-1]
        u_pad = _pad_row(u.to(x.dtype))
        xb, ub = _pad_row(x), u_pad
        dx = x.new_zeros((ring.n_loc, d_in), dtype=torch.float32)
        dw = torch.zeros_like(w)
        for k in range(ring.num_shards):
            pending = ring._start([xb, ub], k)
            # W's gradient from the forward schedule: x visiting, u local
            for ids, anch, rel, n_b, cap in ring.fwd.buckets[k]:
                xs = gather_rows(xb, ids).view(n_b, cap, d_in)
                us = gather_rows(u_pad, anch).view(n_b, cap, d_out)
                dw.index_add_(0, rel, torch.bmm(xs.transpose(1, 2), us))
            # x's gradient from the transposed schedule: u visiting, anchor = dst
            part = ring.cell_sums(ring.bwd, k, ub, w, True)
            if part is not None:
                dx = dx + part
            if pending is not None:
                xb, ub = pending.wait()
        return dx.to(x.dtype), dw, None


def make_rel_sum_sharded(srg: ShardedRelGraph, mesh, axis: str) -> ShardedRelSum:
    """The ring-sharded relational sum over the placed ``srg``."""
    return ShardedRelSum(srg, mesh, axis)
