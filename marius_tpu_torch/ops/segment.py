"""Segment reductions, masked fanout reductions and the sampled neighbour sum.

Port of ``marius_tpu/ops/segment.py``: the masked reductions over a padded
(n, F, d) fanout block (:33-60) and ``segment_sum`` (:75). The seed-restricted
final GNN stage sums each seed's flat neighbour slots with ``segment_sum``;
the JAX package computes it outside Pallas, so the port uses PyTorch's
``index_add_`` (differentiable in ``data``).

:func:`sampled_nbr_sum` is what a sampled GNN layer's aggregation computes
(``marius_tpu/ops/pallas/__init__.py:62-71`` ``gather_sum_auto``, and
``layers.py:162-163`` as gather + ``masked_sum``): the sum over a target's
valid in- and out-neighbour slots. Its forward is ONE call of the gather-sum
kernel (``ops/cuda/nbr_sum.py`` ``gather_sum``) on the (n, F_in + F_out)
slot ids, masked slots given the padding id n_x, which adds zero: the
(n, F, d) block the JAX layers gather is never materialised. Its backward
adds each slot's output gradient into x's row with ``index_add_``, as JAX's
autodiff scatters it outside any Pallas kernel.
"""

from __future__ import annotations

import torch

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


class _SampledNbrSum(torch.autograd.Function):
    """``out[r] = sum_t x[ids[r, t]]``, ids == n_x adding zero."""

    @staticmethod
    def forward(ctx, x: Tensor, ids: Tensor) -> Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = x.shape[0]
        return gather_sum(x, ids)

    @staticmethod
    def backward(ctx, grad: Tensor):
        (ids,) = ctx.saved_tensors
        n_x = ctx.num_rows
        n, width = ids.shape
        d = grad.shape[1]
        # a padding slot adds into a scratch row of its own target, n_x + r:
        # atomics on one shared padding row would serialise millions of adds
        own = n_x + torch.arange(n, device=ids.device)[:, None]
        idx = torch.where(ids < n_x, ids.long(), own)
        acc = grad.new_zeros((n_x + n, d))
        cols = max(1, min(width, _BACKWARD_CHUNK_ELEMS // max(n * d, 1)))
        for c0 in range(0, width, cols):
            c1 = min(c0 + cols, width)
            src = grad[:, None, :].expand(n, c1 - c0, d).reshape(-1, d)
            acc.index_add_(0, idx[:, c0:c1].reshape(-1), src)
        return acc[:n_x], None


def sampled_nbr_sum(x: Tensor, in_idx: Tensor, in_mask: Tensor, out_idx: Tensor,
                    out_mask: Tensor) -> Tensor:
    """(n, d) f32 sums of ``x``'s rows over each target's valid in- and
    out-neighbour slots, in that order. Slot indices past the end of ``x``
    read its last row, as JAX's clamped gathers do."""
    n_x = x.shape[0]
    last = n_x - 1
    ids = torch.cat([torch.where(in_mask, in_idx.clamp(max=last), n_x),
                     torch.where(out_mask, out_idx.clamp(max=last), n_x)], dim=1)
    return _SampledNbrSum.apply(x.contiguous(), ids.to(torch.int32).contiguous())
