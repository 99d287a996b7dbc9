"""ogbn-arxiv GraphSAGE node classification through the PyTorch port's
Python API.

The ``marius_tpu_torch`` twin of ``examples/python/ogbn_arxiv_nc.py``:
download and preprocess the dataset with the built-in preprocessor (only
when the directory holds no ``dataset.yaml``), build a 3-layer GraphSAGE
model programmatically, train with ``NodeClassificationTrainer`` and report
categorical accuracy.

Run:  python examples/python_torch/ogbn_arxiv_nc.py [dataset_dir] [--device cpu]

The download needs a network; point ``dataset_dir`` at a preprocessed copy to
skip it. It trains on the GPU unless ``--device cpu`` (or
``main(device="cpu")``) asks for the CPU; with no GPU and no such request
it raises.
"""

import argparse
import os
import sys

from marius_tpu_torch.data.graph import build_device_graph
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig
from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model
from marius_tpu_torch.nn.optimizers import OptimizerConfig
from marius_tpu_torch.storage.dataset import (
    load_features,
    load_labels,
    load_node_split,
    load_split,
    load_stats,
)
from marius_tpu_torch.tools.preprocess.datasets import DATASET_REGISTRY
from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer


def _cli(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dataset_dir", nargs="?", default="datasets/ogbn_arxiv/")
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    return parser.parse_known_args(argv)[0]


ARGS = _cli(sys.argv[1:])
DATASET_DIR = ARGS.dataset_dir
NUM_EPOCHS = 10
BATCH_SIZE = 1000
FANOUT = 15


def init_model(feature_dim: int, num_classes: int) -> Model:
    # a FEATURE input stage and 3 GraphSAGE stages, the last one emitting
    # class logits; decoder=None is the no-op node decoder
    stages = (
        (LayerConfig(layer_type="FEATURE", output_dim=feature_dim),),
        (LayerConfig(layer_type="GNN", gnn_type="GRAPH_SAGE", bias=True,
                     input_dim=feature_dim, output_dim=feature_dim,
                     activation="RELU"),),
        (LayerConfig(layer_type="GNN", gnn_type="GRAPH_SAGE", bias=True,
                     input_dim=feature_dim, output_dim=feature_dim,
                     activation="RELU"),),
        (LayerConfig(layer_type="GNN", gnn_type="GRAPH_SAGE", bias=True,
                     input_dim=feature_dim, output_dim=num_classes),),
    )
    return Model(
        learning_task=NODE_CLASSIFICATION,
        encoder=EncoderConfig(stages=stages),
        decoder=None,
        loss_type="CROSS_ENTROPY",
        loss_reduction="SUM",
        dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.01),
    )


def main(device=None):
    if not os.path.exists(os.path.join(DATASET_DIR, "dataset.yaml")):
        ds = DATASET_REGISTRY["ogbn_arxiv"](DATASET_DIR)
        ds.download()
        ds.preprocess()

    stats = load_stats(DATASET_DIR)
    edges = load_split(DATASET_DIR, "train", stats)
    features = load_features(DATASET_DIR, stats)
    labels = load_labels(DATASET_DIR, stats)
    train_nodes = load_node_split(DATASET_DIR, "train")
    test_nodes = load_node_split(DATASET_DIR, "test")

    graph = build_device_graph(edges, stats.num_nodes)
    model = init_model(stats.feature_dim, stats.num_classes)
    samplers = [NeighborSamplingConfig("UNIFORM", max_neighbors=FANOUT)] * 3

    trainer = NodeClassificationTrainer(
        model, graph, features, labels, train_nodes, samplers,
        batch_size=BATCH_SIZE, device=device)
    evaluator = NodeClassificationEvaluator(trainer, test_nodes)

    for epoch in range(NUM_EPOCHS):
        s = trainer.train_epoch()
        print(f"epoch {epoch + 1}: loss={s['loss']:.1f} "
              f"{s['nodes_per_sec']:.0f} nodes/s")
    results = evaluator.evaluate(trainer.state)
    print({k: round(float(v), 4) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main(ARGS.device)
