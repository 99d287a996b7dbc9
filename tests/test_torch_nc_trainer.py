"""The port's full-graph NodeClassificationTrainer against marius_tpu's.

Both trainers start from the JAX initial state (carried across with
``train_state_from_jax``) and see the same permutation (JAX's, passed
through the port's ``_epoch_permutation`` seam). They train 2 epochs on a
220-node power-law graph with hub rows wider than 256 slots, FEATURE (bias)
+ 3 x GraphSAGE MEAN (bias), CE SUM, Adam lr 0.01: on the linear-collapse
path (the default for this activation-free model), on the general
seed-restricted path (``fg_linear_collapse=False``) and on the general all-N
path (``fg_seed_restrict=False``). After each epoch the loss, the parameters
and the Adam slots must agree to rtol 1e-4, atol 1e-5 (the LP trainer test's
tolerance): both run float32, but sums run in another order, and 8 Adam
steps carry those differences forward. Evaluation (accuracy and the
predicted labels) must then agree exactly. An EMBEDDING + FEATURE encoder
(the general seed-restricted path, a table-shaped Adagrad step per batch)
agrees the same way, its table and Adagrad state included.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from marius_tpu.data import full_graph as jfg
from marius_tpu.data.graph import build_device_graph as j_build_graph
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOptimizerConfig
from marius_tpu.train import nc as jnc
from marius_tpu_torch.convert import copy_train_state_, train_state_from_jax
from marius_tpu_torch.data import full_graph as tfg
from marius_tpu_torch.data.graph import build_device_graph as t_build_graph
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOptimizerConfig
from marius_tpu_torch.nn.optimizers import tree_map
from marius_tpu_torch.train import nc as tnc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
N, N_LINKED, E, F, CLASSES, DIMS, B = 220, 200, 2000, 8, 5, (16, 16, 5), 32


def _data():
    rng = np.random.default_rng(0)
    w = (np.arange(N_LINKED) + 1.0) ** -1.0
    dst = rng.permutation(N_LINKED)[rng.choice(N_LINKED, E, p=w / w.sum())]
    edges = np.stack([rng.integers(0, N_LINKED, E), dst], 1).astype(np.int32)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    labels = np.argmax(feats @ rng.standard_normal((F, CLASSES)), 1).astype(np.int32)
    train = rng.permutation(N)[:120].astype(np.int32)
    return edges, feats, labels, train


def _model(model_cls, enc_cls, layer_cls, opt_cls, activation="NONE"):
    stages = [(layer_cls("FEATURE", output_dim=F, bias=True),)]
    for din, dout in zip((F,) + DIMS[:-1], DIMS):
        stages.append((layer_cls("GNN", input_dim=din, output_dim=dout, gnn_type="GRAPH_SAGE",
                                 aggregator="MEAN", bias=True, activation=activation),))
    return model_cls("NODE_CLASSIFICATION", enc_cls(tuple(stages)), None,
                     loss_type="CROSS_ENTROPY", loss_reduction="SUM",
                     dense_optimizer=opt_cls("ADAM", learning_rate=0.01))


def _np_state(jstate):
    # the typed PRNG key has no numpy form and no counterpart in the port
    return jax.tree.map(np.asarray, dataclasses.replace(jstate, key=None))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _trainers(fg_kwargs, activation="NONE"):
    edges, feats, labels, train = _data()
    jmodel = _model(JModel, JEncoderConfig, JLayerConfig, JOptimizerConfig, activation)
    jtr = jnc.NodeClassificationTrainer(
        jmodel, j_build_graph(edges, N), feats, labels, train,
        [NeighborSamplingConfig("ALL", max_neighbors=1)] * 3, batch_size=B, seed=0,
        full_graph=jfg.build_full_graph_adjacency(edges, N), **fg_kwargs)
    tmodel = _model(TModel, TEncoderConfig, TLayerConfig, TOptimizerConfig, activation)
    ttr = tnc.NodeClassificationTrainer(
        tmodel, t_build_graph(edges, N), feats, labels, train, batch_size=B, seed=0,
        full_graph=tfg.build_full_graph_adjacency(edges, N), device="cpu", **fg_kwargs)
    size = jtr.num_batches * B
    ttr._epoch_permutation = lambda e: torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(jax.random.key(54321), e), size))).long()
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    return jtr, ttr, np.setdiff1d(np.arange(N), train)


PATHS = {"collapse": {}, "general-seed-restrict": {"fg_linear_collapse": False},
         "general-all-n": {"fg_seed_restrict": False}}


@pytest.mark.parametrize("path", list(PATHS))
def test_nc_trainer_matches_jax_over_two_epochs(path):
    jtr, ttr, eval_nodes = _trainers(PATHS[path])
    assert (ttr._fg_collapse is not None) == (path == "collapse")
    assert ttr._fg_seed_restrict == jtr._fg_seed_restrict == (path == "general-seed-restrict")
    for _ in range(2):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        assert tres["num_nodes"] == jres["num_nodes"]
        js, ts = _np_state(jtr.state), ttr.state
        assert ts.table is None and js.table is None
        for t_stage, j_stage in zip(ts.params["encoder"], js.params["encoder"]):
            for k, t in t_stage[0].items():
                _close(t, j_stage[0][k])
        for slot in ("exp_avg", "exp_avg_sq"):
            for t_stage, j_stage in zip(ts.opt_state.slots[slot]["encoder"],
                                        js.opt_state.slots[slot]["encoder"]):
                for k, t in t_stage[0].items():
                    _close(t, j_stage[0][k])
        assert ts.opt_state.step == int(js.opt_state.step) and ts.epoch == int(js.epoch)

    jev = jnc.NodeClassificationEvaluator(jtr, eval_nodes)
    tev = tnc.NodeClassificationEvaluator(ttr, eval_nodes)
    jacc, tacc = jev.evaluate(jtr.state), tev.evaluate(ttr.state)
    assert set(tacc) == set(jacc)
    assert tacc["num_evaluated"] == jacc["num_evaluated"] == len(eval_nodes)
    assert tacc["accuracy"] == pytest.approx(jacc["accuracy"], abs=1e-12)
    np.testing.assert_array_equal(tev.predict_labels(ttr.state), jev.predict_labels(jtr.state))


def test_nc_trainer_with_activation_takes_the_general_path():
    """A RELU encoder cannot collapse: the auto choice is the seed-restricted
    general path on both sides; one epoch agrees."""
    jtr, ttr, _ = _trainers({}, activation="RELU")
    assert ttr._fg_collapse is None and jtr._fg_collapse is None
    assert ttr._fg_seed_restrict and jtr._fg_seed_restrict
    np.testing.assert_allclose(ttr.train_epoch()["loss"], jtr.train_epoch()["loss"], rtol=RTOL)


def test_nc_trainer_rejects_later_slices():
    edges, feats, labels, train = _data()
    model = _model(TModel, TEncoderConfig, TLayerConfig, TOptimizerConfig)
    graph, adj = t_build_graph(edges, N), tfg.build_full_graph_adjacency(edges, N)
    gat = dataclasses.replace(model, encoder=TEncoderConfig(
        model.encoder.stages[:1] + ((TLayerConfig("GNN", input_dim=F, output_dim=CLASSES,
                                                  gnn_type="GAT"),),)))
    # on a mesh the linear collapse is ported (tests/test_torch_mesh_nc.py); a
    # non-LINEAR full-graph encoder takes the node-sharded ring over the mesh's
    # one non-trivial axis (tests/test_torch_mesh_ring.py), which trains the
    # whole graph and needs one such axis
    mesh = types.SimpleNamespace(shape={"data": 2, "node": 1}, axis_index=lambda a: 0,
                                 device=torch.device("cpu"))
    assert tnc.NodeClassificationTrainer(model, graph, feats, labels, train,
                                         [TNbr("UNIFORM", 4)], batch_size=B, device="cpu",
                                         full_graph=adj, mesh=mesh)._fg_collapse is not None
    ring = tnc.NodeClassificationTrainer(gat, graph, feats, labels, train, [TNbr("UNIFORM", 4)],
                                         batch_size=B, device="cpu", full_graph=adj, mesh=mesh)
    assert ring._ring_axis == "data" and "gat_ring" in ring._fg_ops
    with pytest.raises(ValueError, match="seed_restrict"):
        tnc.NodeClassificationTrainer(gat, graph, feats, labels, train, [TNbr("UNIFORM", 4)],
                                      batch_size=B, device="cpu", full_graph=adj, mesh=mesh,
                                      fg_seed_restrict=True)
    square = types.SimpleNamespace(shape={"data": 2, "node": 2}, axis_index=lambda a: 0,
                                   device=torch.device("cpu"))
    with pytest.raises(ValueError, match="ONE mesh axis"):
        tnc.NodeClassificationTrainer(gat, graph, feats, labels, train, [TNbr("UNIFORM", 4)],
                                      batch_size=B, device="cpu", full_graph=adj, mesh=square)
    # bf16 is ported (tests/test_torch_bf16.py): features, parameters and sums in bf16
    bf16 = tnc.NodeClassificationTrainer(model, graph, feats, labels, train, [TNbr("UNIFORM", 4)],
                                         batch_size=B, device="cpu", full_graph=adj,
                                         dtype=torch.bfloat16)
    assert bf16.features.dtype == bf16._fg_collapse.phi.dtype == torch.bfloat16
    # GAT stages train sampled and full-graph (held against JAX in
    # tests/test_torch_gat.py); an EMBEDDING table in full-graph mode waits
    sampled = tnc.NodeClassificationTrainer(gat, graph, feats, labels, train,
                                            [TNbr("UNIFORM", 4)], batch_size=B, device="cpu")
    full = tnc.NodeClassificationTrainer(gat, graph, feats, labels, train, batch_size=B,
                                         full_graph=adj, device="cpu")
    assert full.full_graph.inv_map is not None and sampled.full_graph is None
    # an EMBEDDING table trains full-graph too (held against JAX below), with
    # or without features, on the general path
    emb = dataclasses.replace(model, encoder=TEncoderConfig(
        ((TLayerConfig("EMBEDDING", output_dim=F),),) + model.encoder.stages[1:]))
    for f in (feats, None):
        tr = tnc.NodeClassificationTrainer(emb, graph, f, labels, train, batch_size=B,
                                           full_graph=adj, device="cpu")
        assert tr._fg_collapse is None and tr.state.table.values.shape == (N, F)
    with pytest.raises(ValueError):
        tnc.NodeClassificationTrainer(dataclasses.replace(model, learning_task="LINK_PREDICTION"),
                                      graph, feats, labels, train, full_graph=adj, device="cpu")
    with pytest.raises(ValueError, match="features or an EMBEDDING"):
        tnc.NodeClassificationTrainer(model, graph, None, labels, train, full_graph=adj,
                                      device="cpu")


def _embedding_model(model_cls, enc_cls, layer_cls, opt_cls):
    """FEATURE (bias) beside EMBEDDING 4, concatenated, 2 x GraphSAGE MEAN
    (RELU between): the general seed-restricted path, a table-shaped
    EMBEDDING gradient every batch."""
    stages = ((layer_cls("FEATURE", output_dim=F, bias=True),
               layer_cls("EMBEDDING", output_dim=4)),
              (layer_cls("REDUCTION", input_dim=F + 4, output_dim=F + 4, reduction="CONCAT"),),
              (layer_cls("GNN", input_dim=F + 4, output_dim=16, gnn_type="GRAPH_SAGE",
                         aggregator="MEAN", bias=True, activation="RELU"),),
              (layer_cls("GNN", input_dim=16, output_dim=CLASSES, gnn_type="GRAPH_SAGE",
                         aggregator="MEAN", bias=True),))
    return model_cls("NODE_CLASSIFICATION", enc_cls(stages), None, loss_type="CROSS_ENTROPY",
                     loss_reduction="SUM", dense_optimizer=opt_cls("ADAM", learning_rate=0.01),
                     sparse_lr=0.1)


def test_nc_trainer_embedding_and_features_match_jax():
    """EMBEDDING + FEATURE full-graph NC (JAX _batch_step_full_graph with
    ``table_values``, :431-460): 2 epochs from JAX's initial state and
    table, then evaluate and predict_labels (JAX :748-760, :819-838). The
    loss, the parameters, the Adam slots, the table and its Adagrad state
    agree to rtol 1e-4 / atol 1e-5; accuracy and labels exactly."""
    edges, feats, labels, train = _data()
    jtr = jnc.NodeClassificationTrainer(
        _embedding_model(JModel, JEncoderConfig, JLayerConfig, JOptimizerConfig),
        j_build_graph(edges, N), feats, labels, train,
        [NeighborSamplingConfig("ALL", max_neighbors=1)] * 2, batch_size=B, seed=0,
        full_graph=jfg.build_full_graph_adjacency(edges, N))
    ttr = tnc.NodeClassificationTrainer(
        _embedding_model(TModel, TEncoderConfig, TLayerConfig, TOptimizerConfig),
        t_build_graph(edges, N), feats, labels, train, batch_size=B, seed=0,
        full_graph=tfg.build_full_graph_adjacency(edges, N), device="cpu")
    assert ttr._fg_seed_restrict and jtr._fg_seed_restrict
    assert ttr._fg_collapse is None and jtr._fg_collapse is None
    size = jtr.num_batches * B
    ttr._epoch_permutation = lambda e: torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(jax.random.key(54321), e), size))).long()
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    before = ttr.state.table.values.clone()
    for _ in range(2):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        js, ts = _np_state(jtr.state), ttr.state
        for t, j in ((ts.params, js.params), (ts.opt_state.slots, js.opt_state.slots)):
            pairs = []
            tree_map(lambda a, b: pairs.append((a, b)), t, j)
            assert pairs
            for a, b in pairs:
                _close(a, b)
        _close(ts.table.values, js.table.values)
        _close(ts.table.state, js.table.state)
        assert ts.opt_state.step == int(js.opt_state.step)
    assert not torch.equal(ttr.state.table.values, before)
    eval_nodes = np.setdiff1d(np.arange(N), train)
    jev = jnc.NodeClassificationEvaluator(jtr, eval_nodes)
    tev = tnc.NodeClassificationEvaluator(ttr, eval_nodes)
    jacc, tacc = jev.evaluate(jtr.state), tev.evaluate(ttr.state)
    assert tacc["num_evaluated"] == jacc["num_evaluated"] == len(eval_nodes)
    assert tacc["accuracy"] == pytest.approx(jacc["accuracy"], abs=1e-12)
    np.testing.assert_array_equal(tev.predict_labels(ttr.state), jev.predict_labels(jtr.state))
