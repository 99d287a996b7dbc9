"""Evaluation statistics.

Port of ``categorical_accuracy_statistics`` from
``marius_tpu/reporting/metrics.py`` (:61-67; reference reporting.cpp:33),
the node-classification accuracy. The link-prediction rank statistics come
with the evaluation slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def categorical_accuracy_statistics(logits: torch.Tensor, labels: torch.Tensor,
                                    mask: Optional[torch.Tensor] = None
                                    ) -> Dict[str, torch.Tensor]:
    """Streaming (correct, count) for NC accuracy, as float32 scalars."""
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels.to(pred.dtype)).float()
    m = torch.ones_like(correct) if mask is None else mask.float()
    return {"correct": (correct * m).sum(), "count": m.sum()}
