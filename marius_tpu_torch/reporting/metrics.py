"""Evaluation statistics: ranking (MRR / Hits@k / MeanRank) and accuracy.

Port of ``marius_tpu/reporting/metrics.py`` (compute_ranks,
rank_statistics and finalize_rank_statistics :20-58,
categorical_accuracy_statistics :61-67; reference reporting.cpp:11-57).
Ranks reduce to float32 sums on the device, per batch and direction, which
the evaluator adds in the JAX scan's order and reads back once.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Tensor = torch.Tensor


def compute_ranks(pos_scores: Tensor, neg_scores: Tensor,
                  neg_mask: Optional[Tensor] = None) -> Tensor:
    """rank_i = |{j : neg_ij >= pos_i}| + 1 (reporting.cpp:55-57), int32.

    ``neg_mask (B, N)`` marks valid negative slots; padded slots never count.
    """
    ge = neg_scores >= pos_scores[:, None]
    if neg_mask is not None:
        ge = ge & neg_mask
    return ge.sum(dim=1, dtype=torch.int32) + 1


def rank_statistics(ranks: Tensor, mask: Optional[Tensor] = None,
                    hits_ks=(1, 3, 5, 10, 50, 100)) -> Dict[str, Tensor]:
    """Streaming-accumulable float32 sums: {count, rr_sum, rank_sum, hits{k}_sum}."""
    r = ranks.float()
    m = torch.ones_like(r) if mask is None else mask.float()
    out = {
        "count": m.sum(),
        "rr_sum": (m / r).sum(),
        "rank_sum": (m * r).sum(),
    }
    for k in hits_ks:
        out[f"hits{k}_sum"] = (m * (r <= k)).sum()
    return out


def finalize_rank_statistics(acc: Dict[str, float]) -> Dict[str, float]:
    """Turn accumulated sums into MRR / MeanRank / Hits@k."""
    count = max(float(acc["count"]), 1.0)
    out = {
        "num_evaluated": float(acc["count"]),
        "mrr": float(acc["rr_sum"]) / count,
        "mean_rank": float(acc["rank_sum"]) / count,
    }
    for key, val in acc.items():
        if key.startswith("hits") and key.endswith("_sum"):
            out["hits@" + key[4:-4]] = float(val) / count
    return out


def categorical_accuracy_statistics(logits: Tensor, labels: Tensor,
                                    mask: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Streaming (correct, count) for NC accuracy, as float32 scalars."""
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels.to(pred.dtype)).float()
    m = torch.ones_like(correct) if mask is None else mask.float()
    return {"correct": (correct * m).sum(), "count": m.sum()}
