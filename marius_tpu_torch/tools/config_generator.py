"""Generate training YAML configs from dataset stats + flags.

Port of ``marius_tpu/tools/config_generator.py`` (reference
marius_config_generator, tools/marius_config_generator.py, 310 LoC): given a
preprocessed dataset directory, emit a complete config for a chosen
model/task with sensible defaults. Where a link-prediction config is sized
(``num_partitions`` None), the partition buffer is sized against the GPU's
memory as torch reports it; with no card to read, the caller passes
``hbm_bytes`` or a partition count.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import yaml

from marius_tpu_torch.storage.dataset import load_stats

LP_DECODERS = ("DISTMULT", "COMPLEX", "TRANSE")

# fraction of device memory usable by the resident embedding working set; the
# rest is headroom for batch blocks, scatter temps, and dense params
_HBM_WORKING_FRACTION = 0.6


def _device_hbm_bytes(device=None) -> float:
    """Total memory of the CUDA device ``device`` (None: the current one).
    Without one there is nothing to size from, and no size is assumed."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            "sizing the partition buffer needs a CUDA device to read its memory; "
            "pass hbm_bytes, or --num_partitions on the command line")
    return float(torch.cuda.get_device_properties(dev).total_memory)


def size_partition_buffer(
    num_nodes: int,
    embedding_dim: int,
    hbm_bytes: Optional[float] = None,
    dtype_bytes: int = 4,
    optimizer_state_factor: float = 2.0,  # values + Adagrad accumulator
    device=None,
) -> Optional[dict]:
    """Partition-count / buffer-capacity sizing from dataset stats — the
    reference generator's partition heuristics (marius_config_generator.py
    sizing block), re-derived for the GPU's memory.

    Returns None when the full table (+ optimizer state) fits the device's
    working fraction (no buffer needed); otherwise the smallest schedule that
    fits: capacity 8 (COMET-compatible: divisible by the fine-to-coarse
    ratio 2 with coarse capacity >= 2) and the smallest even partition count
    with capacity/num_partitions * table <= budget. More partitions than
    necessary only adds swap traffic (each admit moves psize*dim rows both
    ways), so the count is minimized, not maximized."""
    hbm = hbm_bytes if hbm_bytes is not None else _device_hbm_bytes(device)
    budget = hbm * _HBM_WORKING_FRACTION
    table = float(num_nodes) * embedding_dim * dtype_bytes * optimizer_state_factor
    if table <= budget:
        return None
    capacity = 8
    # capacity/n <= budget/table  =>  n >= capacity * table / budget
    n = capacity * table / budget
    num_partitions = int(-(-n // 2) * 2)  # round up to even (COMET ratio 2)
    num_partitions = max(num_partitions, capacity * 2)
    return {"num_partitions": num_partitions, "buffer_capacity": capacity,
            "edge_bucket_ordering": "COMET"}


def generate_config(
    dataset_dir: str,
    output_path: Optional[str] = None,
    task: str = "LINK_PREDICTION",
    model: str = "DISTMULT",
    embedding_dim: int = 50,
    num_epochs: int = 10,
    batch_size: int = 1000,
    learning_rate: float = 0.1,
    num_partitions: Optional[int] = None,  # None = size from stats + HBM
    buffer_capacity: int = 8,
    hbm_bytes: Optional[float] = None,
    device=None,
) -> dict:
    stats = load_stats(dataset_dir)
    task = task.upper()
    model = model.upper()

    if task == "LINK_PREDICTION":
        if model in LP_DECODERS:
            encoder = {"layers": [[{"type": "EMBEDDING", "output_dim": embedding_dim}]]}
            decoder = {"type": model, "options": {"input_dim": embedding_dim}}
        else:  # GNN link prediction
            encoder = {
                "layers": [
                    [{"type": "EMBEDDING", "output_dim": embedding_dim}],
                    [{"type": "GNN", "input_dim": embedding_dim,
                      "output_dim": embedding_dim,
                      "options": {"type": model, "aggregator": "MEAN"}}],
                ],
                "train_neighbor_sampling": [
                    {"type": "UNIFORM", "options": {"max_neighbors": 10}}],
            }
            decoder = {"type": "DISTMULT", "options": {"input_dim": embedding_dim}}
        cfg_model = {
            "learning_task": task,
            "encoder": encoder,
            "decoder": decoder,
            "loss": {"type": "SOFTMAX_CE", "options": {"reduction": "SUM"}},
            "dense_optimizer": {"type": "ADAM",
                                "options": {"learning_rate": learning_rate}},
            "sparse_optimizer": {"type": "ADAGRAD",
                                 "options": {"learning_rate": learning_rate}},
        }
        training = {
            "batch_size": batch_size,
            "negative_sampling": {"num_chunks": 10, "negatives_per_positive": 500,
                                  "degree_fraction": 0.0, "filtered": False},
            "num_epochs": num_epochs,
        }
        evaluation = {"batch_size": batch_size,
                      "negative_sampling": {"filtered": True}}
    else:  # NODE_CLASSIFICATION
        feat_dim = max(stats.feature_dim, 1)
        cfg_model = {
            "learning_task": task,
            "encoder": {
                "layers": [
                    [{"type": "FEATURE", "output_dim": feat_dim}],
                    [{"type": "GNN", "input_dim": feat_dim, "output_dim": embedding_dim,
                      "options": {"type": model if model not in LP_DECODERS else "GRAPH_SAGE",
                                  "aggregator": "MEAN"}, "activation": "RELU"}],
                    [{"type": "GNN", "input_dim": embedding_dim,
                      "output_dim": max(stats.num_classes, 2),
                      "options": {"type": model if model not in LP_DECODERS else "GRAPH_SAGE",
                                  "aggregator": "MEAN"}}],
                ],
                "train_neighbor_sampling": [
                    {"type": "UNIFORM", "options": {"max_neighbors": 10}},
                    {"type": "UNIFORM", "options": {"max_neighbors": 10}}],
            },
            "loss": {"type": "CROSS_ENTROPY", "options": {"reduction": "SUM"}},
            "dense_optimizer": {"type": "ADAM",
                                "options": {"learning_rate": learning_rate / 10}},
        }
        training = {"batch_size": batch_size, "num_epochs": num_epochs}
        evaluation = {"batch_size": batch_size}

    storage: dict = {"device_type": "cuda",
                     "dataset": {"dataset_dir": os.path.abspath(dataset_dir)}}
    if num_partitions is None and task == "LINK_PREDICTION":
        # size the storage tier from dataset stats + chip memory
        sized = size_partition_buffer(stats.num_nodes, embedding_dim,
                                      hbm_bytes=hbm_bytes, device=device)
        if sized is not None:
            storage["embeddings"] = {"type": "PARTITION_BUFFER",
                                     "options": sized}
    elif num_partitions is not None and num_partitions > 1:
        storage["embeddings"] = {
            "type": "PARTITION_BUFFER",
            "options": {"num_partitions": num_partitions,
                        "buffer_capacity": buffer_capacity}}

    raw = {"model": cfg_model, "storage": storage,
           "training": training, "evaluation": evaluation}
    if output_path:
        with open(output_path, "w") as f:
            yaml.safe_dump(raw, f, sort_keys=False)
    return raw
