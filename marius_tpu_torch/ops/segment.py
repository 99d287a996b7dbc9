"""Segment reductions, masked fanout reductions and the sampled neighbour sums.

Port of ``marius_tpu/ops/segment.py``: the masked reductions over a padded
(n, F, d) fanout block (:33-60), ``segment_sum``, ``segment_max`` and
``segment_softmax`` (:75-100). The seed-restricted final GNN stage reduces
each seed's flat neighbour slots with them; the JAX package computes these
outside Pallas, so the port uses PyTorch's ``index_add_`` and
``scatter_reduce_`` (differentiable in ``data``).

:func:`sampled_nbr_sum` is what a sampled GNN layer's aggregation computes
(``marius_tpu/ops/pallas/__init__.py:62-71`` ``gather_sum_auto``, and
``layers.py:162-163`` as gather + ``masked_sum``): the sum over a target's
valid in- and out-neighbour slots. Its forward is ONE call of the gather-sum
kernel (``ops/cuda/nbr_sum.py`` ``gather_sum``) on the (n, F_in + F_out)
slot ids, masked slots given the padding id n_x, which adds zero: the
(n, F, d) block the JAX layers gather is never materialised. Its backward
adds each slot's output gradient into x's row with ``index_add_``, as JAX's
autodiff scatters it outside any Pallas kernel. The kernel accumulates in
float32 whatever x's dtype; the sums come back in x's dtype (ROADMAP C9:
JAX's default sampled path, ``masked_sum`` over the gathered block, returns
x's dtype), so bfloat16 features take the kernel's bfloat16 entry and give
bfloat16 sums.

:func:`relational_nbr_sum` is the sampled RGCN layer's aggregation: per
target and relation, the sum over its valid out-slots of that relation, one
gather-sum kernel call on (n x R, F) slot ids. :func:`slot_gather` is the
(n, S, d) slot block a GAT layer weighs per slot: one call of the row-gather
kernel (``ops/cuda/gather.py``), its backward an ``index_add_``.
"""

from __future__ import annotations

from typing import Optional

import torch

from marius_tpu_torch.ops.cuda.gather import gather_rows
from marius_tpu_torch.ops.cuda.nbr_sum import gather_sum

Tensor = torch.Tensor

#: the backward's expanded gradient rows are built this many elements at a
#: time (256 MB of f32), a few slot columns per ``index_add_``
_BACKWARD_CHUNK_ELEMS = 1 << 26


def masked_sum(nbr: Tensor, mask: Tensor) -> Tensor:
    """(n, F, d), (n, F) -> (n, d) sum over valid fanout slots."""
    return torch.einsum("nfd,nf->nd", nbr, mask.to(nbr.dtype))


def masked_mean(nbr: Tensor, mask: Tensor) -> Tensor:
    """Mean over valid fanout slots; all-masked rows yield zeros."""
    m = mask.to(nbr.dtype)
    total = torch.einsum("nfd,nf->nd", nbr, m)
    return total / m.sum(dim=1, keepdim=True).clamp(min=1.0)


def masked_max(nbr: Tensor, mask: Tensor, neg_fill: float = -1e9) -> Tensor:
    return torch.where(mask[..., None], nbr, torch.full_like(nbr, neg_fill)).amax(dim=1)


def masked_softmax(logits: Tensor, mask: Tensor, dim: int = 1) -> Tensor:
    """Softmax over the fanout axis with invalid slots at 0 probability;
    fully masked rows return all zeros (GAT attention_softmax,
    layer_helpers.cpp:44-66)."""
    neg = torch.finfo(logits.dtype).min
    masked_logits = torch.where(mask, logits, torch.full_like(logits, neg))
    m = masked_logits.amax(dim=dim, keepdim=True).detach()
    e = torch.exp(masked_logits - m) * mask.to(logits.dtype)
    return e / e.sum(dim=dim, keepdim=True).clamp(min=1e-16)


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """(num_segments, ...) sums of ``data`` rows by ``segment_ids``, which
    must lie in [0, num_segments) (``jax.ops.segment_sum`` drops ids outside
    it; callers reserve a last segment for padding instead)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_max(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """(num_segments, ...) maxima of ``data`` rows by ``segment_ids`` (in
    [0, num_segments)); an empty segment gives -inf, as in JAX."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), float("-inf"))
    idx = segment_ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)


def segment_softmax(logits: Tensor, segment_ids: Tensor, num_segments: int,
                    mask: Optional[Tensor] = None) -> Tensor:
    """Per-segment softmax over the rows of ``logits`` (GAT's flat-slot
    form); masked rows get 0, a segment without a valid row all zeros."""
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    seg_max = segment_max(logits, segment_ids, num_segments).detach()
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    e = torch.exp(logits - seg_max[segment_ids])
    if mask is not None:
        e = e * mask.to(e.dtype)
    denom = segment_sum(e, segment_ids, num_segments)
    return e / denom.clamp(min=1e-16)[segment_ids]


class _SampledNbrSum(torch.autograd.Function):
    """``out[r] = sum_t x[ids[r, t]]``, ids == n_x adding zero."""

    @staticmethod
    def forward(ctx, x: Tensor, ids: Tensor) -> Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = x.shape[0]
        return gather_sum(x, ids).to(x.dtype)

    @staticmethod
    def backward(ctx, grad: Tensor):
        (ids,) = ctx.saved_tensors
        n_x = ctx.num_rows
        n, width = ids.shape
        d = grad.shape[1]
        idx = _own_rows(ids, n_x)
        acc = grad.new_zeros((n_x + n, d))
        cols = max(1, min(width, _BACKWARD_CHUNK_ELEMS // max(n * d, 1)))
        for c0 in range(0, width, cols):
            c1 = min(c0 + cols, width)
            src = grad[:, None, :].expand(n, c1 - c0, d).reshape(-1, d)
            acc.index_add_(0, idx[:, c0:c1].reshape(-1), src)
        return acc[:n_x], None


def slot_ids(n_x: int, idx: Tensor, mask: Tensor) -> Tensor:
    """Slot indices into an ``n_x``-row array: valid slots clamped to its last
    row, as JAX's gathers clamp; masked slots the padding id ``n_x``."""
    return torch.where(mask, idx.clamp(max=n_x - 1), n_x)


def _own_rows(ids: Tensor, n_x: int) -> Tensor:
    """Backward targets of (n, w) slot ids: a padding slot adds into a
    scratch row of its own target, n_x + r: atomics on one shared padding
    row would serialise millions of adds."""
    own = n_x + torch.arange(ids.shape[0], device=ids.device)[:, None]
    return torch.where(ids < n_x, ids.long(), own)


def sampled_nbr_sum(x: Tensor, in_idx: Tensor, in_mask: Tensor, out_idx: Tensor,
                    out_mask: Tensor) -> Tensor:
    """(n, d) sums, in ``x``'s dtype, of ``x``'s rows over each target's
    valid in- and out-neighbour slots, in that order. Slot indices past the
    end of ``x`` read its last row, as JAX's clamped gathers do."""
    n_x = x.shape[0]
    ids = torch.cat([slot_ids(n_x, in_idx, in_mask), slot_ids(n_x, out_idx, out_mask)], dim=1)
    return _SampledNbrSum.apply(x.contiguous(), ids.to(torch.int32).contiguous())


class _RelNbrSum(torch.autograd.Function):
    """``out[r, k] = sum_t x[ids[r, t]] over rel[r, t] == k``, ids == n_x
    adding zero. The forward is one gather-sum call on (n x R, F) ids; the
    backward adds each slot's gradient row (its target's, at its relation)
    into x's row with ``index_add_``."""

    @staticmethod
    def forward(ctx, x: Tensor, ids: Tensor, rel: Tensor, num_rels: int) -> Tensor:
        ctx.save_for_backward(ids, rel)
        ctx.num_rows = n_x = x.shape[0]
        n, width = ids.shape
        kinds = torch.arange(num_rels, device=ids.device)[None, :, None]
        per_rel = torch.where(rel[:, None, :] == kinds, ids[:, None, :], n_x)
        out = gather_sum(x, per_rel.reshape(n * num_rels, width).to(torch.int32).contiguous())
        return out.view(n, num_rels, x.shape[1]).to(x.dtype)

    @staticmethod
    def backward(ctx, grad: Tensor):
        ids, rel = ctx.saved_tensors
        n_x = ctx.num_rows
        n, width = ids.shape
        num_rels, d = grad.shape[1], grad.shape[2]
        idx = _own_rows(ids, n_x)
        src_row = torch.arange(n, device=ids.device)[:, None] * num_rels + rel.long()
        flat = grad.reshape(n * num_rels, d)
        acc = grad.new_zeros((n_x + n, d))
        cols = max(1, min(width, _BACKWARD_CHUNK_ELEMS // max(n * d, 1)))
        for c0 in range(0, width, cols):
            c1 = min(c0 + cols, width)
            acc.index_add_(0, idx[:, c0:c1].reshape(-1), flat[src_row[:, c0:c1].reshape(-1)])
        return acc[:n_x], None, None, None


def relational_nbr_sum(x: Tensor, idx: Tensor, mask: Tensor, rel: Tensor,
                       num_rels: int) -> Tensor:
    """(n, num_rels, d) in ``x``'s dtype: per target and relation, the sum of
    ``x``'s rows over the target's valid slots of that relation (slots whose
    relation lies outside [0, num_rels) add nothing)."""
    rel = rel.long()
    valid = mask & (rel >= 0) & (rel < num_rels)
    ids = slot_ids(x.shape[0], idx, valid).to(torch.int32)
    return _RelNbrSum.apply(x.contiguous(), ids, rel.clamp(0, num_rels - 1), num_rels)


class _SlotGather(torch.autograd.Function):
    """(n, S, d) rows of x at (n, S) slot ids through the row-gather kernel
    (padding ids n_x read x's last row, which the caller weighs 0)."""

    @staticmethod
    def forward(ctx, x: Tensor, ids: Tensor) -> Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = x.shape[0]
        n, width = ids.shape
        return gather_rows(x, ids.reshape(-1)).view(n, width, x.shape[1])

    @staticmethod
    def backward(ctx, grad: Tensor):
        (ids,) = ctx.saved_tensors
        n_x = ctx.num_rows
        d = grad.shape[-1]
        acc = grad.new_zeros((n_x + ids.shape[0], d))
        acc.index_add_(0, _own_rows(ids, n_x).reshape(-1), grad.reshape(-1, d))
        return acc[:n_x], None


def slot_gather(x: Tensor, ids: Tensor) -> Tensor:
    """(n, S, d) f32 block of ``x``'s rows at the (n, S) ``ids`` (from
    :func:`slot_ids`); differentiable in ``x``."""
    return _SlotGather.apply(x.contiguous(), ids.to(torch.int32).contiguous())
