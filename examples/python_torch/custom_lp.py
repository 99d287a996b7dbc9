"""A custom link-prediction dataset and a programmatic model with the
PyTorch port.

The ``marius_tpu_torch`` twin of ``examples/python/custom_lp.py``: define a
dataset class (download, then preprocess with ``EdgeListConverter``), build
a DistMult model through the Python API, train and evaluate filtered MRR.

Run:  python examples/python_torch/custom_lp.py [output_dir] [--device cpu]

The download needs a network; it runs only when ``output_dir`` holds no
``dataset.yaml`` and no ``edge.csv``. It trains on the GPU unless
``--device cpu`` (or ``main(device="cpu")``) asks for the CPU; with no GPU
and no such request it raises.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig
from marius_tpu_torch.nn.model import LINK_PREDICTION, Model
from marius_tpu_torch.nn.optimizers import OptimizerConfig
from marius_tpu_torch.storage.dataset import load_split, load_stats
from marius_tpu_torch.tools.preprocess.converter import EdgeListConverter
from marius_tpu_torch.tools.preprocess.datasets import LinkPredictionDataset
from marius_tpu_torch.tools.preprocess.utils import download_url, extract_file
from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
from marius_tpu_torch.train.trainer import LinkPredictionTrainer


def _cli(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("output_dir", nargs="?", default="datasets/custom_lp/")
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    return parser.parse_known_args(argv)[0]


ARGS = _cli(sys.argv[1:])
OUTPUT_DIR = ARGS.output_dir
EMBEDDING_DIM = 50
NUM_EPOCHS = 10
BATCH_SIZE = 1000
NUM_CHUNKS, NEGATIVES = 10, 500


class MyDataset(LinkPredictionDataset):
    """An edge CSV from a URL, split into train / valid / test."""

    dataset_name = "my_dataset"
    dataset_url = "http://snap.stanford.edu/ogb/data/nodeproppred/arxiv.zip"

    def download(self, overwrite: bool = False) -> None:
        self.input_train_edges_file = self.output_directory / "edge.csv"
        if not self.input_train_edges_file.exists():
            archive = download_url(self.dataset_url, self.output_directory, overwrite)
            extract_file(archive, remove_input=False)
            extract_file(self.output_directory / "arxiv" / "raw" / "edge.csv.gz")
            (self.output_directory / "arxiv" / "raw" / "edge.csv").rename(
                self.input_train_edges_file)

    def preprocess(self, num_partitions: int = 1, remap_ids: bool = True,
                   splits=(0.8, 0.1, 0.1), **kwargs):
        converter = EdgeListConverter(
            output_dir=str(self.output_directory),
            train_edges=str(self.input_train_edges_file),
            delim=",",
            src_column=0,
            dst_column=1,
            edge_type_column=None,      # the CSV has no relation column
            splits=list(splits),
            remap_ids=remap_ids,
            num_partitions=num_partitions,
        )
        return converter.convert()


def main(device=None):
    ds = MyDataset(Path(OUTPUT_DIR))
    if not (ds.output_directory / "dataset.yaml").exists():
        ds.download()
        ds.preprocess()

    stats = load_stats(OUTPUT_DIR)
    train_edges = load_split(OUTPUT_DIR, "train", stats)
    valid_edges = load_split(OUTPUT_DIR, "valid", stats)
    test_edges = load_split(OUTPUT_DIR, "test", stats)
    num_rels = max(stats.num_relations, 1)

    encoder = EncoderConfig(stages=(
        (LayerConfig(layer_type="EMBEDDING", output_dim=EMBEDDING_DIM),),))
    model = Model(
        learning_task=LINK_PREDICTION,
        encoder=encoder,
        decoder=EdgeDecoder("DISTMULT", num_rels, EMBEDDING_DIM, use_inverse_relations=True),
        loss_type="SOFTMAX_CE",
        loss_reduction="SUM",
        dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.1),
        sparse_lr=0.1,
    )

    trainer = LinkPredictionTrainer(
        model, stats.num_nodes, num_rels, train_edges,
        NegativeSamplingConfig(num_chunks=NUM_CHUNKS, negatives_per_positive=NEGATIVES),
        batch_size=BATCH_SIZE, device=device)

    all_edges = np.concatenate([train_edges, valid_edges, test_edges])
    evaluator = LinkPredictionEvaluator(
        model, stats.num_nodes, num_rels, test_edges,
        all_edges=all_edges, batch_size=BATCH_SIZE, filtered=True, device=device)

    for epoch in range(NUM_EPOCHS):
        s = trainer.train_epoch()
        print(f"epoch {epoch + 1}: loss={s['loss']:.1f} "
              f"{s['edges_per_sec']:.0f} edges/s")
    results = evaluator.evaluate(trainer.state)
    print({k: round(float(v), 4) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main(ARGS.device)
