"""An FB15K-237-shaped link-prediction dataset, made from a seed.

A frozen copy of the generator the port's chip checks used
(``chip_smoke.py`` ``synthetic_edges`` and ``write_fb15k_shaped``), with the
draws taken from ``seed``: FB15K-237's sizes (14,541 nodes, 237 relations,
272,115 / 17,535 / 20,466 train / valid / test edges), each (src, rel, dst)
drawn uniformly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def generate(spec: Dict, seed: int) -> Dict:
    """The dataset of ``spec`` (the configuration's ``dataset`` block) for
    ``seed``: (E, 3) int32 train, valid and test edges."""
    n, r = int(spec["num_nodes"]), int(spec["num_relations"])
    n_train, n_valid, n_test = (int(spec["num_train"]), int(spec["num_valid"]),
                                int(spec["num_test"]))
    total = n_train + n_valid + n_test
    rng = np.random.default_rng([int(seed), 23])
    edges = np.stack([rng.integers(0, n, total), rng.integers(0, r, total),
                      rng.integers(0, n, total)], axis=1).astype(np.int32)
    return {"task": "lp", "num_nodes": n, "num_relations": r,
            "train_edges": edges[:n_train], "valid_edges": edges[n_train:n_train + n_valid],
            "test_edges": edges[n_train + n_valid:]}
