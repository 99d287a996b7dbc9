"""FB15K-237 DistMult link prediction through the PyTorch port's Python API.

The ``marius_tpu_torch`` twin of ``examples/python/fb15k_237.py``: build the
model programmatically, train with ``LinkPredictionTrainer`` and evaluate
filtered MRR with ``LinkPredictionEvaluator``. Run ``marius_preprocess_torch
--dataset fb15k_237 --output_directory datasets/fb15k_237/`` first (it
downloads), or point the first argument at a preprocessed copy.

Run:  python examples/python_torch/fb15k_237.py [dataset_dir] [--device cpu]

It trains on the GPU unless ``--device cpu`` (or ``main(device="cpu")``)
asks for the CPU; with no GPU and no such request it raises.
"""

import argparse
import sys

import numpy as np

from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig
from marius_tpu_torch.nn.model import LINK_PREDICTION, Model
from marius_tpu_torch.nn.optimizers import OptimizerConfig
from marius_tpu_torch.storage.dataset import load_split, load_stats
from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
from marius_tpu_torch.train.trainer import LinkPredictionTrainer


def _cli(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dataset_dir", nargs="?", default="datasets/fb15k_237/")
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    return parser.parse_known_args(argv)[0]


ARGS = _cli(sys.argv[1:])
DATASET_DIR = ARGS.dataset_dir
EMBEDDING_DIM = 50
NUM_EPOCHS = 10
BATCH_SIZE = 1000
NUM_CHUNKS, NEGATIVES = 10, 500


def main(device=None):
    stats = load_stats(DATASET_DIR)
    train_edges = load_split(DATASET_DIR, "train", stats)
    valid_edges = load_split(DATASET_DIR, "valid", stats)
    test_edges = load_split(DATASET_DIR, "test", stats)

    encoder = EncoderConfig(stages=(
        (LayerConfig(layer_type="EMBEDDING", output_dim=EMBEDDING_DIM),),))
    model = Model(
        learning_task=LINK_PREDICTION,
        encoder=encoder,
        decoder=EdgeDecoder("DISTMULT", stats.num_relations, EMBEDDING_DIM,
                            use_inverse_relations=True),
        loss_type="SOFTMAX_CE",
        loss_reduction="SUM",
        dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.1),
        sparse_lr=0.1,
    )

    trainer = LinkPredictionTrainer(
        model, stats.num_nodes, stats.num_relations, train_edges,
        NegativeSamplingConfig(num_chunks=NUM_CHUNKS, negatives_per_positive=NEGATIVES),
        batch_size=BATCH_SIZE, device=device)

    all_edges = np.concatenate([train_edges, valid_edges, test_edges])
    evaluator = LinkPredictionEvaluator(
        model, stats.num_nodes, stats.num_relations, test_edges,
        all_edges=all_edges, batch_size=BATCH_SIZE, filtered=True, device=device)

    for epoch in range(NUM_EPOCHS):
        s = trainer.train_epoch()
        print(f"epoch {epoch + 1}: loss={s['loss']:.1f} "
              f"{s['edges_per_sec']:.0f} edges/s")
    results = evaluator.evaluate(trainer.state)
    print({k: round(v, 4) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main(ARGS.device)
