"""Dataset directory layout: binary edge/feature files + dataset.yaml stats.

A copy of ``marius_tpu/storage/dataset.py`` (the same layout, so datasets
written by ``marius_tpu.tools.preprocess`` feed the port unchanged), itself
compatible with the reference's preprocessing output (tools/preprocess/
converters/torch_converter.py + writers): <dir>/edges/{train,validation,test}
_edges.bin as int32 [src(,rel),dst] rows, <dir>/nodes/features.bin,
labels.bin, and dataset.yaml with counts.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import yaml


EDGE_FILES = {
    "train": os.path.join("edges", "train_edges.bin"),
    "valid": os.path.join("edges", "validation_edges.bin"),
    "test": os.path.join("edges", "test_edges.bin"),
}
NODE_FILES = {
    "features": os.path.join("nodes", "features.bin"),
    "labels": os.path.join("nodes", "labels.bin"),
    "train_nodes": os.path.join("nodes", "train_nodes.bin"),
    "valid_nodes": os.path.join("nodes", "validation_nodes.bin"),
    "test_nodes": os.path.join("nodes", "test_nodes.bin"),
}


@dataclasses.dataclass
class DatasetStats:
    num_nodes: int = 0
    num_edges: int = 0
    num_relations: int = 1
    num_edge_cols: int = -1   # explicit on-disk row width; -1 = infer
    num_train: int = 0
    num_valid: int = 0
    num_test: int = 0
    num_classes: int = -1
    feature_dim: int = -1


def save_stats(dataset_dir: str, stats: DatasetStats) -> None:
    os.makedirs(dataset_dir, exist_ok=True)
    with open(os.path.join(dataset_dir, "dataset.yaml"), "w") as f:
        yaml.safe_dump(dataclasses.asdict(stats), f)


def load_stats(dataset_dir: str) -> DatasetStats:
    with open(os.path.join(dataset_dir, "dataset.yaml")) as f:
        raw = yaml.safe_load(f) or {}
    fields = {f.name for f in dataclasses.fields(DatasetStats)}
    return DatasetStats(**{k: v for k, v in raw.items() if k in fields})


def _edge_cols(stats: DatasetStats) -> int:
    if stats.num_edge_cols > 0:
        return stats.num_edge_cols
    # legacy datasets without num_edge_cols: single-relation typed graphs are
    # ambiguous here, which is why the converter now records the width
    return 3 if stats.num_relations > 1 else 2


def save_split(dataset_dir: str, split: str, edges: np.ndarray) -> None:
    path = os.path.join(dataset_dir, EDGE_FILES[split])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.ascontiguousarray(edges, np.int32).tofile(path)

def load_split(dataset_dir: str, split: str, stats: Optional[DatasetStats] = None,
               mmap: bool = False) -> np.ndarray:
    """Load an edge split. ``mmap=True`` returns a read-only np.memmap over
    the binary file (the FLAT_FILE storage tier, storage.h:149): rows are
    paged in on access instead of materialized in RAM."""
    stats = stats or load_stats(dataset_dir)
    path = os.path.join(dataset_dir, EDGE_FILES[split])
    cols = _edge_cols(stats)
    if mmap:
        n = os.path.getsize(path) // (4 * cols)
        return np.memmap(path, np.int32, mode="r", shape=(n, cols))
    return np.fromfile(path, np.int32).reshape(-1, cols)


def save_node_array(dataset_dir: str, name: str, arr: np.ndarray) -> None:
    path = os.path.join(dataset_dir, NODE_FILES[name])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.ascontiguousarray(arr).tofile(path)


def load_features(dataset_dir: str, stats: Optional[DatasetStats] = None) -> np.ndarray:
    stats = stats or load_stats(dataset_dir)
    path = os.path.join(dataset_dir, NODE_FILES["features"])
    return np.fromfile(path, np.float32).reshape(stats.num_nodes, stats.feature_dim)


def load_labels(dataset_dir: str, stats: Optional[DatasetStats] = None) -> np.ndarray:
    stats = stats or load_stats(dataset_dir)
    path = os.path.join(dataset_dir, NODE_FILES["labels"])
    return np.fromfile(path, np.int32)


def load_node_split(dataset_dir: str, split: str) -> np.ndarray:
    path = os.path.join(dataset_dir, NODE_FILES[f"{split}_nodes"])
    return np.fromfile(path, np.int32)
