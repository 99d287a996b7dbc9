"""Loss functions: score-based for link prediction, softmax CE for node
classification.

Port of ``marius_tpu/nn/losses.py`` (:24-180; reference nn/loss.cpp:51-198):
SoftmaxCE, Ranking, CrossEntropy, BCEAfterSigmoid, BCEWithLogits, MSE,
SoftPlus, and the classification cross-entropy (:140-146), each with
SUM/MEAN/NONE reductions and an optional per-example validity mask so padded
batches contribute exactly zero.
``softplus`` is the exact ``logaddexp(x, 0)``, as ``jax.nn.softplus`` is
(``torch.nn.functional.softplus`` switches to ``x`` above 20).

Score losses take ``pos_scores (B,)`` and ``neg_scores (B, N)``.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _reduce(per_example: Tensor, mask: Optional[Tensor], reduction: str) -> Tensor:
    """SUM/MEAN reduction over valid examples (loss.cpp reduction options)."""
    if mask is not None:
        per_example = per_example * mask.to(per_example.dtype)
    r = reduction.upper()
    if r == "SUM":
        return per_example.sum()
    if r == "MEAN":
        if mask is None:
            return per_example.mean()
        denom = mask.to(per_example.dtype).sum().clamp(min=1.0)
        return per_example.sum() / denom
    if r == "NONE":
        return per_example
    raise ValueError(f"Unknown reduction: {reduction}")


def _flat_mask(mask: Optional[Tensor], n: int) -> Optional[Tensor]:
    """Broadcast a (B,) edge mask to the flattened (B*N,) negative layout."""
    if mask is None:
        return None
    return mask.repeat_interleave(n)


def _pos_neg_mask(mask: Optional[Tensor], n: int) -> Optional[Tensor]:
    if mask is None:
        return None
    return torch.cat([mask, _flat_mask(mask, n)])


def softmax_ce(pos_scores: Tensor, neg_scores: Tensor, *, reduction: str = "MEAN",
               mask: Optional[Tensor] = None, neg_mask: Optional[Tensor] = None) -> Tensor:
    """2-way CE between pos and logsumexp(neg): loss.cpp:51-68.

    per-edge loss = logsumexp([pos, lse(neg)]) - pos = softplus(lse(neg) - pos).
    ``neg_mask (B, N)`` excludes padded negative slots from the logsumexp.
    """
    if neg_mask is not None:
        neg_scores = neg_scores.masked_fill(~neg_mask, float("-inf"))
    lse = torch.logsumexp(neg_scores, dim=1)
    return _reduce(softplus(lse - pos_scores), mask, reduction)


def ranking_loss(pos_scores: Tensor, neg_scores: Tensor, *, margin: float = 0.1,
                 reduction: str = "MEAN", mask: Optional[Tensor] = None,
                 neg_mask: Optional[Tensor] = None) -> Tensor:
    """Margin ranking loss with target=-1 (loss.cpp:70-87):
    elementwise max(0, neg - pos + margin), reduced over all (B, N) elements."""
    per_elem = (neg_scores - pos_scores[:, None] + margin).clamp(min=0.0)
    m = None
    if mask is not None:
        m = mask[:, None].expand(per_elem.shape)
    if neg_mask is not None:
        m = neg_mask if m is None else (m & neg_mask)
    return _reduce(per_elem.reshape(-1), None if m is None else m.reshape(-1), reduction)


def cross_entropy_scores(pos_scores: Tensor, neg_scores: Tensor, *, reduction: str = "MEAN",
                         mask: Optional[Tensor] = None,
                         neg_mask: Optional[Tensor] = None) -> Tensor:
    """CE over [pos, neg_0..neg_N] with target index 0 (loss.cpp:89-102):
    per-edge = logsumexp(all scores) - pos."""
    if neg_mask is not None:
        neg_scores = neg_scores.masked_fill(~neg_mask, float("-inf"))
    all_scores = torch.cat([pos_scores[:, None], neg_scores], dim=1)
    per_edge = torch.logsumexp(all_scores, dim=1) - pos_scores
    return _reduce(per_edge, mask, reduction)


def _binary_targets_flat(pos_scores: Tensor, neg_scores: Tensor):
    """cat([pos, neg.flatten()]) with labels cat([1s, 0s]) — scores_to_labels
    (loss.cpp:37-48) for the one_hot=true losses."""
    y = torch.cat([pos_scores, neg_scores.reshape(-1)])
    t = torch.cat([torch.ones_like(pos_scores), torch.zeros_like(neg_scores).reshape(-1)])
    return y, t


def bce_after_sigmoid(pos_scores: Tensor, neg_scores: Tensor, *, reduction: str = "MEAN",
                      mask: Optional[Tensor] = None) -> Tensor:
    """BCE on sigmoid(scores) vs {1,0} targets (loss.cpp:104-119)."""
    y, t = _binary_targets_flat(pos_scores, neg_scores)
    p = torch.sigmoid(y).clamp(1e-12, 1.0 - 1e-12)
    per = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    return _reduce(per, _pos_neg_mask(mask, neg_scores.shape[1]), reduction)


def bce_with_logits(pos_scores: Tensor, neg_scores: Tensor, *, reduction: str = "MEAN",
                    mask: Optional[Tensor] = None) -> Tensor:
    """Numerically-stable BCE-with-logits (loss.cpp:121-136)."""
    y, t = _binary_targets_flat(pos_scores, neg_scores)
    per = y.clamp(min=0.0) - y * t + softplus(-y.abs())
    return _reduce(per, _pos_neg_mask(mask, neg_scores.shape[1]), reduction)


def mse_loss(pos_scores: Tensor, neg_scores: Tensor, *, reduction: str = "MEAN",
             mask: Optional[Tensor] = None) -> Tensor:
    """MSE of raw scores vs {1,0} targets (loss.cpp:138-153)."""
    y, t = _binary_targets_flat(pos_scores, neg_scores)
    per = (y - t) ** 2
    return _reduce(per, _pos_neg_mask(mask, neg_scores.shape[1]), reduction)


def softplus_loss(pos_scores: Tensor, neg_scores: Tensor, *, reduction: str = "MEAN",
                  mask: Optional[Tensor] = None) -> Tensor:
    """softplus(-label * score) with labels in {+1,-1} (loss.cpp:155-175)."""
    y, t = _binary_targets_flat(pos_scores, neg_scores)
    labels = 2.0 * t - 1.0
    per = softplus(-labels * y)
    return _reduce(per, _pos_neg_mask(mask, neg_scores.shape[1]), reduction)


def classification_cross_entropy(logits: Tensor, labels: Tensor, *, reduction: str = "MEAN",
                                 mask: Optional[Tensor] = None) -> Tensor:
    """Standard softmax CE for node classification (loss.cpp CrossEntropyLoss,
    classification branch)."""
    logp = torch.log_softmax(logits, dim=-1)
    per = -logp.gather(1, labels.long()[:, None])[:, 0]
    return _reduce(per, mask, reduction)


_SCORE_LOSSES = {
    "SOFTMAX_CE": softmax_ce,
    "RANKING": ranking_loss,
    "CROSS_ENTROPY": cross_entropy_scores,
    "BCE_AFTER_SIGMOID": bce_after_sigmoid,
    "BCE_WITH_LOGITS": bce_with_logits,
    "MSE": mse_loss,
    "SOFTPLUS": softplus_loss,
}


def get_loss_function(loss_type: str, *, reduction: str = "MEAN", margin: float = 0.1):
    """Factory mirroring getLossFunction (loss.cpp:177-198). Returns
    f(pos_scores, neg_scores, mask=None, neg_mask=None) -> scalar; names
    registered in ``nn/registry.py`` work as the built-in ones do."""
    lt = loss_type.upper()
    custom = None
    if lt not in _SCORE_LOSSES:
        from marius_tpu_torch.nn import registry
        custom = registry.loss(lt)
        if custom is None:
            raise ValueError(f"Unsupported loss function type: {loss_type}")
    fn = custom or _SCORE_LOSSES[lt]

    def apply(pos_scores, neg_scores, mask=None, neg_mask=None):
        kwargs = dict(reduction=reduction, mask=mask)
        if custom is not None or lt in ("SOFTMAX_CE", "RANKING", "CROSS_ENTROPY"):
            kwargs["neg_mask"] = neg_mask
        if lt == "RANKING":
            kwargs["margin"] = margin
        return fn(pos_scores, neg_scores, **kwargs)

    return apply
