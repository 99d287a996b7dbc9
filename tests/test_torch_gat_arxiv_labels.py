"""gat8 on arxiv-shaped labels, on the CPU: the port against the JAX package.

chip_smoke.py's ``nc_gat`` trains ogbn_arxiv.yaml with its GraphSAGE layers
switched to gat8 (8 averaged heads, d = 128 -> 128 -> 40, bias, UNIFORM 32
in and out) on labels that are a random linear function of each node's own
features (``chip_smoke.nc_data``). Here the same model, the same fanouts and
the same label function run on a cut of the same arxiv-shaped graph
(``chip_smoke.arxiv_edges`` at 6,000 nodes: the same mean in-degree, the hub
scaled with the node count; hop caps tight enough to truncate, as the YAML's
are at arxiv size), 6 epochs, through both packages with JAX's sampler
numbers and epoch permutation injected into the port. The two trainers
agree: each epoch's loss to rtol 1e-4, as in the other trainer tests, the
same truncated frontier ids, and test predictions that differ on at most 2
of the 2,778 evaluated nodes (float32 rounding drifts over 24 Adam steps and
turns near-ties of the argmax). GraphSAGE, whose self term reads the node's
own features apart from its neighbours, fits the same labels far better
through the port: the low GAT accuracy is the model's on this data, not a
fault of the port.

Run with ``-s`` to see the accuracies.
"""

import dataclasses

import jax
import numpy as np
import torch

from chip_smoke import ARXIV_CLASSES, ARXIV_EDGES, ARXIV_HUB, ARXIV_NODES, ARXIV_TRAIN
from chip_smoke import arxiv_edges, nc_data
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOptimizerConfig
from marius_tpu.train import nc as jnc
from marius_tpu_torch.convert import copy_train_state_, train_state_from_jax
from marius_tpu_torch.data.graph import build_device_graph as t_graph
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOptimizerConfig
from marius_tpu_torch.train import nc as tnc
from tests.test_torch_gat import SampledKeyReplay
from tests.test_torch_neighbor_sampler import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 6000
FEATS, DIM, HEADS, FANOUT, BATCH, EPOCHS = 128, 128, 8, 32, 1000, 6
HOP_CAPS = (1000, 3000, 5000, N)   # tight enough to truncate, as the YAML's caps do
RTOL = 1e-4


def _data():
    edges = arxiv_edges(N, round(N * ARXIV_EDGES / ARXIV_NODES),
                        round(ARXIV_HUB * N / ARXIV_NODES))
    return nc_data(0, edges, N, FEATS, ARXIV_CLASSES, round(N * ARXIV_TRAIN / ARXIV_NODES))


def _model(model_cls, enc_cls, layer_cls, opt_cls, gnn_type):
    opts = (dict(gnn_type="GAT", num_heads=HEADS, average_heads=True) if gnn_type == "GAT"
            else dict(gnn_type="GRAPH_SAGE", aggregator="MEAN"))
    stages = [(layer_cls("FEATURE", output_dim=FEATS, bias=True),)]
    for din, dout in ((FEATS, DIM), (DIM, DIM), (DIM, ARXIV_CLASSES)):
        stages.append((layer_cls("GNN", input_dim=din, output_dim=dout, bias=True, **opts),))
    return model_cls("NODE_CLASSIFICATION", enc_cls(tuple(stages)), None,
                     loss_type="CROSS_ENTROPY", loss_reduction="SUM",
                     dense_optimizer=opt_cls("ADAM", learning_rate=0.01))


def _port_trainer(gnn_type, edges, feats, labels, train):
    return tnc.NodeClassificationTrainer(
        _model(TModel, TEncoderConfig, TLayerConfig, TOptimizerConfig, gnn_type),
        t_graph(edges, N), feats, labels, train, [TNbr("UNIFORM", FANOUT)] * 3,
        batch_size=BATCH, hop_caps=HOP_CAPS, seed=0, device="cpu")


def test_gat8_on_arxiv_shaped_labels_matches_jax_and_trails_sage():
    edges, feats, labels, train = _data()
    eval_nodes = np.setdiff1d(np.arange(N), train)
    jtr = jnc.NodeClassificationTrainer(
        _model(JModel, JEncoderConfig, JLayerConfig, JOptimizerConfig, "GAT"),
        j_graph(edges, N), feats, labels, train, [JNbr("UNIFORM", FANOUT)] * 3,
        batch_size=BATCH, hop_caps=HOP_CAPS, seed=0)
    ttr = _port_trainer("GAT", edges, feats, labels, train)
    assert ttr.hop_caps == jtr.hop_caps
    size = jtr.num_batches * BATCH
    ttr._epoch_permutation = lambda p: torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(jax.random.key(54321), p), size))).long()
    replay = SampledKeyReplay(jax.random.wrap_key_data(
        np.array(jax.random.key_data(jtr.state.key))))
    ttr._batch_draws, ttr._dropout_key = replay, replay.dropout
    copy_train_state_(ttr.state, train_state_from_jax(
        jax.tree.map(np.asarray, dataclasses.replace(jtr.state, key=None))))

    losses, truncated = [], 0
    for _ in range(EPOCHS):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        losses.append((jres["loss"], tres["loss"]))
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        assert tres["truncated_frontier_ids"] == jres["truncated_frontier_ids"]
        truncated += tres["truncated_frontier_ids"]
    jev = jnc.NodeClassificationEvaluator(jtr, eval_nodes)
    tev = tnc.NodeClassificationEvaluator(ttr, eval_nodes)
    tev._batch_draws = lambda i: jax_draws(jax.random.fold_in(jax.random.key(11), i))
    jacc, tacc = jev.evaluate(jtr.state)["accuracy"], tev.evaluate(ttr.state)["accuracy"]

    sage = _port_trainer("GRAPH_SAGE", edges, feats, labels, train)
    sage.train(EPOCHS)
    sacc = tnc.NodeClassificationEvaluator(sage, eval_nodes).evaluate(sage.state)["accuracy"]
    print(f"\n{N} nodes, {len(edges)} edges, {len(train)} train, {len(eval_nodes)} evaluated, "
          f"{EPOCHS} epochs, {truncated} frontier ids truncated: gat8 losses (JAX, port) "
          f"{losses}; test accuracy JAX {jacc:.6f}, port {tacc:.6f}; GraphSAGE (port) "
          f"{sacc:.6f}; chance {1 / ARXIV_CLASSES}")
    assert truncated > 0
    assert abs(round(tacc * len(eval_nodes)) - round(jacc * len(eval_nodes))) <= 2
    assert 1 / ARXIV_CLASSES < jacc < sacc - 0.2
