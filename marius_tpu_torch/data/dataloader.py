"""Host-side dataset preparation helpers: random edge and node splits.

A copy of ``marius_tpu/data/dataloader.py`` (:16-36). The reference
DataLoader (data/dataloader.cpp) owns per-batch sampling and parameter
gathers on CPU threads; here those run on the device (train/trainer.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def split_edges(edges: np.ndarray, train_frac: float, valid_frac: float,
                seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random train/valid/test split (torch_converter.py:374 split_edges)."""
    rng = np.random.default_rng(seed)
    e = np.asarray(edges)
    perm = rng.permutation(e.shape[0])
    n_train = int(train_frac * e.shape[0])
    n_valid = int(valid_frac * e.shape[0])
    return (e[perm[:n_train]], e[perm[n_train:n_train + n_valid]],
            e[perm[n_train + n_valid:]])


def split_nodes(num_nodes: int, train_frac: float, valid_frac: float,
                seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Node-id splits for node classification (io.cpp:226 initializeNodeIds)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(train_frac * num_nodes)
    n_valid = int(valid_frac * num_nodes)
    return (perm[:n_train], perm[n_train:n_train + n_valid],
            perm[n_train + n_valid:])
