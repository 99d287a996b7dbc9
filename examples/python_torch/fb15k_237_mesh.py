"""FB15K-237 DistMult link prediction over a mesh of ranks with the PyTorch
port.

The ``marius_tpu_torch`` twin of ``examples/python/fb15k_237_mesh.py``.
Every process is one rank of a ``torch.distributed`` process group and
drives one device; the same ``LinkPredictionTrainer`` takes a
``parallel.mesh.Mesh`` with a ``data`` axis (batch parallelism: the dense
gradients are summed with one all_reduce) and a ``node`` axis (the
embedding table's rows sharded over the ranks' device memory). The mesh is
``{data: world / node, node: 2}`` when the world size is even, else
``{data: world, node: 1}``. Rank 0 prints.

Run one process per rank under torchrun, which sets the environment
``initialize_distributed`` reads (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK, LOCAL_RANK):

    torchrun --nproc_per_node 2 examples/python_torch/fb15k_237_mesh.py \\
        [dataset_dir] [--device cpu]

Ranks take NCCL when each has a GPU of its own, else gloo (``--device cpu``,
or ranks sharing a GPU). Without ``--device cpu`` a rank with no GPU raises.
Run ``marius_preprocess_torch --dataset fb15k_237 --output_directory
datasets/fb15k_237/`` first, or point ``dataset_dir`` at a preprocessed copy.
"""

import argparse
import sys

import numpy as np
import torch.distributed as dist

from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig
from marius_tpu_torch.nn.model import LINK_PREDICTION, Model
from marius_tpu_torch.nn.optimizers import OptimizerConfig
from marius_tpu_torch.parallel import multihost
from marius_tpu_torch.parallel.launch import global_mesh, initialize_distributed
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
    dev = initialize_distributed(device=device)   # torchrun's environment
    try:
        return _train(dev)
    finally:
        multihost.shutdown()


def _train(dev):
    stats = load_stats(DATASET_DIR)
    train_edges = load_split(DATASET_DIR, "train", stats)
    valid_edges = load_split(DATASET_DIR, "valid", stats)
    test_edges = load_split(DATASET_DIR, "test", stats)

    # every rank: batches over `data`, table rows over `node`
    world = dist.get_world_size()
    num_node = 2 if world % 2 == 0 and world > 1 else 1
    mesh = global_mesh(num_node=num_node, device=dev)
    lead = mesh.rank == 0
    if lead:
        print(f"mesh: {dict(mesh.shape)} over {world} ranks ({mesh.backend})")

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
        batch_size=BATCH_SIZE, mesh=mesh, device=dev)

    all_edges = np.concatenate([train_edges, valid_edges, test_edges])
    evaluator = LinkPredictionEvaluator(
        model, stats.num_nodes, stats.num_relations, test_edges,
        all_edges=all_edges, batch_size=BATCH_SIZE, filtered=True, mesh=mesh, device=dev)

    for epoch in range(NUM_EPOCHS):
        s = trainer.train_epoch()
        if lead:
            print(f"epoch {epoch + 1}: loss={s['loss']:.1f} "
                  f"({s['edges_per_sec']:.0f} edges/s)")

    metrics = evaluator.evaluate(trainer.state)   # every rank: the table is gathered
    if lead:
        print({k: round(v, 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main(ARGS.device)
