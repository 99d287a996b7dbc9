"""Host-side link-prediction reporter: aggregates metric sums, prints, exports.

Port of ``LinkPredictionReporter`` from ``marius_tpu/reporting/reporters.py``
(:23-76; reference reporting.cpp:49-181). The node-classification and
progress reporters are not needed by the ported paths.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from marius_tpu_torch.reporting.metrics import finalize_rank_statistics

logger = logging.getLogger("marius_tpu_torch")


class LinkPredictionReporter:
    def __init__(self, hits_ks=(1, 3, 5, 10, 50, 100)):
        self.hits_ks = hits_ks
        self._acc: Optional[Dict[str, float]] = None
        self._ranks: List[np.ndarray] = []
        self._scores: List[np.ndarray] = []

    def add_statistics(self, stats: Dict) -> None:
        stats = {k: float(v) for k, v in stats.items()}
        if self._acc is None:
            self._acc = dict(stats)
        else:
            for k, v in stats.items():
                self._acc[k] = self._acc.get(k, 0.0) + v

    def add_ranks(self, ranks: np.ndarray, scores: Optional[np.ndarray] = None) -> None:
        self._ranks.append(np.asarray(ranks))
        if scores is not None:
            self._scores.append(np.asarray(scores))

    def results(self) -> Dict[str, float]:
        if self._acc is None:
            return {}
        return finalize_rank_statistics(self._acc)

    def report(self) -> str:
        res = self.results()
        lines = [
            "=================================",
            f"Link Prediction: {int(res.get('num_evaluated', 0))} edges evaluated",
            f"Mean Rank: {res.get('mean_rank', float('nan')):.6f}",
            f"MRR: {res.get('mrr', float('nan')):.6f}",
        ]
        for k in self.hits_ks:
            key = f"hits@{k}"
            if key in res:
                lines.append(f"Hits@{k}: {res[key]:.6f}")
        lines.append("=================================")
        text = "\n".join(lines)
        logger.info(text)
        return text

    def save(self, directory: str, scores: bool = False, ranks: bool = True) -> None:
        os.makedirs(directory, exist_ok=True)
        if ranks and self._ranks:
            np.concatenate(self._ranks).tofile(os.path.join(directory, "ranks.csv"), sep="\n")
        if scores and self._scores:
            np.concatenate(self._scores).tofile(os.path.join(directory, "scores.csv"), sep="\n")

    def clear(self) -> None:
        self._acc = None
        self._ranks = []
        self._scores = []
