"""Synthetic random dataset generation, used by the e2e test matrix.

Parity with the reference's test data generator (test/test_data/generate.py:
244 generate_random_dataset -> :186 _lp / :73 _nc): uniform random edges over
N nodes and R relations, split into train/valid/test fractions, written in the
framework's binary dataset layout with dataset.yaml stats. A copy of
``marius_tpu/tools/preprocess/generate.py``: the same seed writes the same
files.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from marius_tpu_torch.storage.dataset import (
    DatasetStats,
    save_node_array,
    save_split,
    save_stats,
)


def _random_edges(rng: np.random.Generator, num_nodes: int, num_edges: int,
                  num_relations: int) -> np.ndarray:
    src = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    dst = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    if num_relations > 1:
        rel = rng.integers(0, num_relations, num_edges, dtype=np.int32)
        return np.stack([src, rel, dst], axis=1)
    return np.stack([src, dst], axis=1)


def generate_random_dataset_lp(
    output_dir: str,
    num_nodes: int = 100,
    num_edges: int = 1000,
    num_relations: int = 10,
    splits: Sequence[float] = (0.9, 0.05, 0.05),
    seed: int = 0,
) -> DatasetStats:
    """Random link-prediction dataset (generate.py:186)."""
    rng = np.random.default_rng(seed)
    edges = _random_edges(rng, num_nodes, num_edges, num_relations)
    perm = rng.permutation(num_edges)
    n_train = int(splits[0] * num_edges)
    n_valid = int(splits[1] * num_edges)
    train = edges[perm[:n_train]]
    valid = edges[perm[n_train:n_train + n_valid]]
    test = edges[perm[n_train + n_valid:]]

    os.makedirs(output_dir, exist_ok=True)
    save_split(output_dir, "train", train)
    save_split(output_dir, "valid", valid)
    save_split(output_dir, "test", test)
    stats = DatasetStats(
        num_nodes=num_nodes, num_edges=num_edges, num_relations=num_relations,
        num_edge_cols=3 if num_relations > 1 else 2,
        num_train=len(train), num_valid=len(valid), num_test=len(test))
    save_stats(output_dir, stats)
    return stats


def generate_random_dataset_nc(
    output_dir: str,
    num_nodes: int = 100,
    num_edges: int = 1000,
    num_classes: int = 10,
    feature_dim: int = 10,
    splits: Sequence[float] = (0.8, 0.1, 0.1),
    seed: int = 0,
) -> DatasetStats:
    """Random node-classification dataset (generate.py:73)."""
    rng = np.random.default_rng(seed)
    edges = _random_edges(rng, num_nodes, num_edges, 1)

    os.makedirs(output_dir, exist_ok=True)
    save_split(output_dir, "train", edges)

    features = rng.standard_normal((num_nodes, feature_dim)).astype(np.float32)
    labels = rng.integers(0, num_classes, num_nodes, dtype=np.int32)
    save_node_array(output_dir, "features", features)
    save_node_array(output_dir, "labels", labels)

    perm = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(splits[0] * num_nodes)
    n_valid = int(splits[1] * num_nodes)
    save_node_array(output_dir, "train_nodes", perm[:n_train])
    save_node_array(output_dir, "valid_nodes", perm[n_train:n_train + n_valid])
    save_node_array(output_dir, "test_nodes", perm[n_train + n_valid:])

    stats = DatasetStats(
        num_nodes=num_nodes, num_edges=num_edges, num_relations=1,
        num_edge_cols=2,
        num_train=n_train, num_valid=n_valid, num_test=num_nodes - n_train - n_valid,
        num_classes=num_classes, feature_dim=feature_dim)
    save_stats(output_dir, stats)
    return stats
