"""A custom node-classification dataset (CORA) and GraphSAGE with the
PyTorch port.

The ``marius_tpu_torch`` twin of ``examples/python/custom_nc_graphsage.py``:
define a node-classification dataset class that downloads CORA, converts the
citation edges with ``EdgeListConverter``, remaps the node features, labels
and splits, then trains a 2-layer GraphSAGE classifier programmatically.

Run:  python examples/python_torch/custom_nc_graphsage.py [output_dir] [--device cpu]

The download needs a network; it runs only when ``output_dir`` holds no
``dataset.yaml``. It trains on the GPU unless ``--device cpu`` (or
``main(device="cpu")``) asks for the CPU; with no GPU and no such request
it raises.
"""

import argparse
import sys
import tarfile
from pathlib import Path

import numpy as np

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
    save_node_array,
    save_stats,
)
from marius_tpu_torch.tools.preprocess.converter import EdgeListConverter
from marius_tpu_torch.tools.preprocess.datasets import NodeClassificationDataset, remap_node_data
from marius_tpu_torch.tools.preprocess.utils import download_url
from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer


def _cli(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("output_dir", nargs="?", default="datasets/cora/")
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    return parser.parse_known_args(argv)[0]


ARGS = _cli(sys.argv[1:])
OUTPUT_DIR = ARGS.output_dir
NUM_EPOCHS = 10
BATCH_SIZE = 500
HIDDEN_DIM = 64
FANOUT = 10

CLASS_NAMES = [
    "Neural_Networks", "Rule_Learning", "Reinforcement_Learning",
    "Probabilistic_Methods", "Theory", "Genetic_Algorithms", "Case_Based",
]


class Cora(NodeClassificationDataset):
    """The CORA citation graph: 2708 papers, 1433-dim bag-of-words features,
    7 classes."""

    dataset_name = "cora"
    dataset_url = "http://www.cs.umd.edu/~sen/lbc-proj/data/cora.tgz"

    def download(self, overwrite: bool = False) -> None:
        content = self.output_directory / "cora" / "cora.content"
        cites = self.output_directory / "cora" / "cora.cites"
        if not (content.exists() and cites.exists()) or overwrite:
            archive = download_url(self.dataset_url, self.output_directory, overwrite)
            with tarfile.open(archive) as tf:
                tf.extractall(self.output_directory)
        self.content_file, self.cites_file = content, cites

    def preprocess(self, num_partitions: int = 1, remap_ids: bool = True,
                   splits=(0.8, 0.1, 0.1), **kwargs):
        # cora.content rows: <paper_id> <1433 x 0/1 words> <class_name>
        with open(self.content_file) as f:
            rows = [line.split() for line in f]
        paper_ids = np.array([int(r[0]) for r in rows], np.int64)
        features = np.array([[float(x) for x in r[1:-1]] for r in rows], np.float32)
        labels = np.array([CLASS_NAMES.index(r[-1]) for r in rows], np.int32)
        # rows keyed by raw paper id, so the converter's remap can reorder them
        order = np.argsort(paper_ids)
        paper_ids, features, labels = paper_ids[order], features[order], labels[order]

        rng = np.random.default_rng(0)
        perm = rng.permutation(len(paper_ids))
        n_train = int(splits[0] * len(perm))
        n_valid = int(splits[1] * len(perm))
        node_splits = {
            "train": paper_ids[perm[:n_train]],
            "valid": paper_ids[perm[n_train:n_train + n_valid]],
            "test": paper_ids[perm[n_train + n_valid:]],
        }

        result = EdgeListConverter(
            output_dir=str(self.output_directory),
            train_edges=str(self.cites_file),
            delim="\t",
            src_column=0,
            dst_column=1,
            edge_type_column=None,
            remap_ids=remap_ids,
            known_node_ids=[paper_ids],
            num_partitions=num_partitions,
        ).convert()

        if remap_ids:
            # remap_node_data indexes feature rows by raw id: dense raw-indexed arrays first
            dense_feat = np.zeros((paper_ids.max() + 1, features.shape[1]), np.float32)
            dense_feat[paper_ids] = features
            dense_lab = np.zeros(paper_ids.max() + 1, np.int32)
            dense_lab[paper_ids] = labels
            node_splits, features, labels = remap_node_data(
                result.node_mapping, node_splits, dense_feat, dense_lab)

        out = str(self.output_directory)
        save_node_array(out, "features", features)
        save_node_array(out, "labels", labels)
        for s in ("train", "valid", "test"):
            save_node_array(out, f"{s}_nodes", node_splits[s].astype(np.int32))
        stats = result.stats
        stats.num_train = len(node_splits["train"])
        stats.num_valid = len(node_splits["valid"])
        stats.num_test = len(node_splits["test"])
        stats.feature_dim = features.shape[1]
        stats.num_classes = len(CLASS_NAMES)
        save_stats(out, stats)
        return result


def main(device=None):
    ds = Cora(Path(OUTPUT_DIR))
    if not (ds.output_directory / "dataset.yaml").exists():
        ds.download()
        ds.preprocess()

    stats = load_stats(OUTPUT_DIR)
    graph = build_device_graph(load_split(OUTPUT_DIR, "train", stats), stats.num_nodes)
    features = load_features(OUTPUT_DIR, stats)
    labels = load_labels(OUTPUT_DIR, stats)

    model = Model(
        learning_task=NODE_CLASSIFICATION,
        encoder=EncoderConfig(stages=(
            (LayerConfig(layer_type="FEATURE", output_dim=stats.feature_dim),),
            (LayerConfig(layer_type="GNN", gnn_type="GRAPH_SAGE", bias=True,
                         input_dim=stats.feature_dim, output_dim=HIDDEN_DIM,
                         activation="RELU"),),
            (LayerConfig(layer_type="GNN", gnn_type="GRAPH_SAGE", bias=True,
                         input_dim=HIDDEN_DIM, output_dim=stats.num_classes),),
        )),
        decoder=None,
        loss_type="CROSS_ENTROPY",
        loss_reduction="SUM",
        dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.01),
    )

    trainer = NodeClassificationTrainer(
        model, graph, features, labels, load_node_split(OUTPUT_DIR, "train"),
        [NeighborSamplingConfig("UNIFORM", max_neighbors=FANOUT)] * 2,
        batch_size=BATCH_SIZE, device=device)
    evaluator = NodeClassificationEvaluator(trainer, load_node_split(OUTPUT_DIR, "test"))

    for epoch in range(NUM_EPOCHS):
        s = trainer.train_epoch()
        print(f"epoch {epoch + 1}: loss={s['loss']:.1f} "
              f"{s['nodes_per_sec']:.0f} nodes/s")
    results = evaluator.evaluate(trainer.state)
    print({k: round(float(v), 4) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main(ARGS.device)
