"""Registering a custom GNN layer, edge decoder and loss with the PyTorch
port, and training a config that names them.

The ``marius_tpu_torch`` twin of ``examples/python/custom_layer.py``. A
custom component is a pair of plain functions (init, forward) registered
under a name in ``marius_tpu_torch.nn.registry``; after registration the
name is valid everywhere the built-in names are, YAML configs included,
with no edit to the package. An init function takes a ``torch.Generator``
(its device is where the parameters go); a forward function takes and
returns tensors.

Run:  python examples/python_torch/custom_layer.py [--device cpu]

It trains on the GPU unless ``--device cpu`` (or ``main(device="cpu")``)
asks for the CPU; with no GPU and no such request it raises.
"""

import argparse
import sys
import tempfile

from marius_tpu_torch.config import load_config
from marius_tpu_torch.manager import marius_train
from marius_tpu_torch.nn import registry
from marius_tpu_torch.nn.initialization import initialize_tensor
from marius_tpu_torch.nn.losses import softmax_ce
from marius_tpu_torch.ops.segment import masked_mean
from marius_tpu_torch.tools.preprocess.generate import generate_random_dataset_lp


def _cli(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    return parser.parse_known_args(argv)[0]


ARGS = _cli(sys.argv[1:])
NUM_EPOCHS = 3
NUM_NODES, NUM_EDGES, NUM_RELATIONS = 80, 800, 5


# -- 1. a custom GNN layer: mean-of-neighbours residual ---------------------

def mean_residual_init(generator, cfg, dtype):
    return {"w": initialize_tensor(generator, cfg.init, (cfg.input_dim, cfg.output_dim),
                                   dtype)}


def mean_residual_forward(cfg, params, x, adj, **ctx):
    """(self + mean over in-neighbours) @ w: any torch function of the padded
    adjacency works; ctx carries degrees, node_ids_outer, train and
    dropout_key for layers that need them."""
    nbr = masked_mean(x[adj.in_nbr_idx.long()], adj.in_mask)
    return (x[adj.self_idx.long()] + nbr) @ params["w"]


registry.register_gnn_layer("MEAN_RESIDUAL", mean_residual_init, mean_residual_forward)


# -- 2. a custom edge decoder: scaled DistMult ------------------------------

registry.register_relation_op("SCALED_HADAMARD",
                              lambda embs, rels: embs * rels * 0.5
                              if rels is not None else embs)
registry.register_edge_decoder("SCALED_DISTMULT", "DOT", "SCALED_HADAMARD",
                               relation_init="ones")


# -- 3. a custom loss: squared softmax-CE -----------------------------------

def sq_softmax_ce(pos, neg, *, reduction="MEAN", mask=None, neg_mask=None):
    base = softmax_ce(pos, neg, reduction=reduction, mask=mask, neg_mask=neg_mask)
    return base + 0.01 * base ** 2


registry.register_loss("SQUARED_SOFTMAX_CE", sq_softmax_ce)


CONFIG = {
    "model": {
        "learning_task": "LINK_PREDICTION",
        "encoder": {
            "layers": [
                [{"type": "EMBEDDING", "output_dim": 16}],
                [{"type": "GNN", "input_dim": 16, "output_dim": 16,
                  "options": {"type": "MEAN_RESIDUAL"}}],
            ],
            "train_neighbor_sampling": [
                {"type": "UNIFORM", "options": {"max_neighbors": 4}}],
        },
        "decoder": {"type": "SCALED_DISTMULT", "options": {"input_dim": 16}},
        "loss": {"type": "SQUARED_SOFTMAX_CE", "options": {"reduction": "SUM"}},
        "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": 0.1}},
        "sparse_optimizer": {"type": "ADAGRAD", "options": {"learning_rate": 0.1}},
    },
    "storage": {"dataset": {"dataset_dir": ""}, "save_model": False},
    "training": {
        "batch_size": 100,
        "negative_sampling": {"num_chunks": 4, "negatives_per_positive": 16},
        "num_epochs": NUM_EPOCHS,
    },
    "evaluation": {"batch_size": 100, "negative_sampling": {"filtered": True}},
}


def main(device=None):
    with tempfile.TemporaryDirectory() as d:
        generate_random_dataset_lp(d, num_nodes=NUM_NODES, num_edges=NUM_EDGES,
                                   num_relations=NUM_RELATIONS)
        CONFIG["storage"]["dataset"]["dataset_dir"] = d
        CONFIG["training"]["num_epochs"] = NUM_EPOCHS
        result = marius_train(load_config(CONFIG), device=device)
    print("losses:", [round(e["loss"], 1) for e in result["epochs"]])
    print("test MRR:", round(result["test"]["mrr"], 4))
    return result


if __name__ == "__main__":
    main(ARGS.device)
