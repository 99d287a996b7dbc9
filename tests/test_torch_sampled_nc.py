"""The port's sampled GNN layers, encoder and NodeClassificationTrainer
against marius_tpu's, on the CPU.

Layers and the encoder see the same neighbour batch (JAX's, carried across)
and the same inputs; forward values and gradients must agree to rtol 1e-5 /
atol 1e-6 (float32 on both sides; the port's gather-sum adds a target's slots
in another order than JAX's masked einsum).

The trainers start from JAX's initial state (``train_state_from_jax``), see
JAX's permutation (the ``_epoch_permutation`` seam) and JAX's sampler numbers
(the ``_batch_draws`` seam replays JAX's key schedule: ``split(state.key)``
per batch, ``fold_in(k_s, depth)`` and ``fold_in(., direction)`` per hop).
Over 2 epochs the loss, the parameters, the Adam slots and, with an
EMBEDDING stage, the table and its Adagrad state must agree to rtol 1e-4 /
atol 1e-5 (the LP trainer test's tolerance: sums run in another order and
Adam carries the differences forward), and the truncated frontier ids
exactly, including a tight-cap case that overflows. Evaluation (with
``fold_in(key(11), batch)``'s draws) must then give the same accuracy and
predicted labels, and the all-node export (``fold_in(key(13), batch)``) of
one trained state the same encodings to the layers' tolerance.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marius_tpu.nn.encoder as jenc
import marius_tpu.nn.layers.layers as jlayers
import marius_tpu_torch.nn.encoder as tenc
import marius_tpu_torch.nn.layers.layers as tlayers
import marius_tpu_torch.train.graph_encoder as tge
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.data.samplers.neighbor import estimate_hop_caps, sample_neighbor_batch
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOptimizerConfig
from marius_tpu.train import nc as jnc
from marius_tpu.train.graph_encoder import encode_all_nodes as j_encode_all
from marius_tpu_torch.convert import copy_train_state_, train_state_from_jax
from marius_tpu_torch.data.batch import LayerAdjacency, NeighborBatch
from marius_tpu_torch.data.graph import build_device_graph as t_graph
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOptimizerConfig
from marius_tpu_torch.ops.cuda import gather as gather_kernel
from marius_tpu_torch.ops.cuda import nbr_sum as nbr_sum_kernel
from marius_tpu_torch.train import nc as tnc
from tests.test_torch_neighbor_sampler import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 1e-5
N, E, F, CLASSES, B = 260, 2000, 8, 5, 32


def _graph_data():
    rng = np.random.default_rng(0)
    w = (np.arange(N) + 1.0) ** -0.9      # power-law in-degrees: hubs above the fanout
    edges = np.stack([rng.integers(0, N, E), rng.choice(N, E, p=w / w.sum())],
                     1).astype(np.int32)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    labels = np.argmax(feats @ rng.standard_normal((F, CLASSES)), 1).astype(np.int32)
    train = rng.permutation(N)[:150].astype(np.int32)
    return edges, feats, labels, train


def to_torch_batch(jb) -> NeighborBatch:
    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))
    layers = tuple(LayerAdjacency(**{f.name: t(getattr(l, f.name))
                                     for f in dataclasses.fields(l)}) for l in jb.layers)
    return NeighborBatch(tuple(t(a) for a in jb.node_ids), tuple(t(a) for a in jb.node_masks),
                         layers, t(jb.overflow))


def _close(t, j, rtol=RTOL, atol=ATOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _jax_batch(configs, caps=None):
    edges, _, _, _ = _graph_data()
    jg = j_graph(edges, N)
    caps = caps or estimate_hop_caps(B, configs, N)
    seeds = np.random.default_rng(1).permutation(N)[:B].astype(np.int32)
    mask = np.arange(B) < B - 4
    jb = sample_neighbor_batch(jax.random.key(3), jg, jnp.asarray(seeds), jnp.asarray(mask),
                               configs, caps)
    return jg, jb


# -- layers ------------------------------------------------------------------

LAYERS = {
    "sage-mean": dict(gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True, activation="RELU"),
    "sage-gcn": dict(gnn_type="GRAPH_SAGE", aggregator="GCN", bias=False),
    "gcn-degrees": dict(gnn_type="GCN", bias=True),
    "gcn-sampled-counts": dict(gnn_type="GCN", bias=False, activation="SIGMOID"),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_sampled_gnn_layer_matches_jax(name):
    """The layer of the outermost hop (prefix layout, hubs above the fanout)
    and of a saturated hop, forward and gradients."""
    for caps in (None, [B, 120, N + 1]):
        jg, jb = _jax_batch([JNbr("UNIFORM", 6)] * 2, caps)
        tb = to_torch_batch(jb)
        kw = LAYERS[name]
        jl, tl = JLayerConfig("GNN", input_dim=7, output_dim=6, **kw), \
            TLayerConfig("GNN", input_dim=7, output_dim=6, **kw)
        rng = np.random.default_rng(2)
        n_x, n = jb.node_ids[0].shape[0], jb.node_ids[1].shape[0]
        x = rng.standard_normal((n_x, 7)).astype(np.float32)
        u = rng.standard_normal((n, 6)).astype(np.float32)
        jp = jlayers.init_layer_params(jax.random.key(0), jl)
        tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
        degrees = None if name == "gcn-sampled-counts" else jg.degrees

        def jf(x_, p_):
            out = jenc._apply_gnn(jl, p_, x_, jb.layers[0], degrees, jb.node_ids[0], True, None)
            return jnp.sum(out * u), out

        (_, jout), (jgx, jgp) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jp)
        tx = torch.from_numpy(x).requires_grad_(True)
        tdeg = None if degrees is None else torch.from_numpy(np.array(degrees))
        tout = tenc._apply_gnn(tl, tp, tx, tb.layers[0], tdeg, tb.node_ids[0], True, None)
        (tout * torch.from_numpy(u)).sum().backward()
        _close(tout, jout, LAYER_RTOL, LAYER_ATOL)
        _close(tx.grad, jgx, LAYER_RTOL, LAYER_ATOL)
        for k in jp:
            _close(tp[k].grad, jgp[k], LAYER_RTOL, LAYER_ATOL)


@pytest.mark.parametrize("reduction", ["CONCAT", "LINEAR"])
def test_reduction_layer_matches_jax(reduction):
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((9, 4)).astype(np.float32),
          rng.standard_normal((9, 3)).astype(np.float32)]
    d_out = 7 if reduction == "CONCAT" else 5
    jl = JLayerConfig("REDUCTION", input_dim=7, output_dim=d_out, reduction=reduction, bias=True)
    tl = TLayerConfig("REDUCTION", input_dim=7, output_dim=d_out, reduction=reduction, bias=True)
    jp = jlayers.init_layer_params(jax.random.key(1), jl)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
    assert set(tp) == set(tlayers.init_layer_params(torch.Generator().manual_seed(0), tl))
    _close(tlayers.reduction_layer(tl, tp, [torch.from_numpy(x) for x in xs]),
           jlayers.reduction_layer(jl, jp, [jnp.asarray(x) for x in xs]),
           LAYER_RTOL, LAYER_ATOL)


def _encoder(layer_cls, enc_cls):
    """FEATURE + EMBEDDING, two parallel SAGE layers, a LINEAR reduction, GCN."""
    return enc_cls((
        (layer_cls("FEATURE", output_dim=F, bias=True), layer_cls("EMBEDDING", output_dim=4)),
        (layer_cls("GNN", input_dim=F + 4, output_dim=6, gnn_type="GRAPH_SAGE",
                   aggregator="MEAN", bias=True, activation="RELU"),
         layer_cls("GNN", input_dim=F + 4, output_dim=6, gnn_type="GRAPH_SAGE",
                   aggregator="GCN")),
        (layer_cls("REDUCTION", input_dim=12, output_dim=7, reduction="LINEAR", bias=True),),
        (layer_cls("GNN", input_dim=7, output_dim=CLASSES, gnn_type="GCN", bias=True),),
    ))


def test_encoder_forward_matches_jax():
    jg, jb = _jax_batch([JNbr("UNIFORM", 5), JNbr("DROPOUT", 4, rate=0.3)])
    tb = to_torch_batch(jb)
    jcfg, tcfg = _encoder(JLayerConfig, JEncoderConfig), _encoder(TLayerConfig, TEncoderConfig)
    jp = jenc.init_encoder_params(jax.random.key(5), jcfg)
    tp = [[{k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in d.items()}
           for d in stage] for stage in jp]
    rng = np.random.default_rng(4)
    n_x = jb.node_ids[0].shape[0]
    feats = rng.standard_normal((n_x, F)).astype(np.float32)
    emb = rng.standard_normal((n_x, 4)).astype(np.float32)
    u = rng.standard_normal((B, CLASSES)).astype(np.float32)

    def jf(emb_, p_):
        out = jenc.encoder_forward(jcfg, p_, emb_, jnp.asarray(feats), jb, degrees=jg.degrees,
                                   train=True)
        return jnp.sum(out * u), out

    (_, jout), (jge, jgp) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(emb), jp)
    temb = torch.from_numpy(emb).requires_grad_(True)
    tout = tenc.encoder_forward(tcfg, tp, temb, torch.from_numpy(feats), tb,
                                degrees=torch.from_numpy(np.array(jg.degrees)), train=True)
    (tout * torch.from_numpy(u)).sum().backward()
    _close(tout, jout, LAYER_RTOL, LAYER_ATOL)
    _close(temb.grad, jge, LAYER_RTOL, LAYER_ATOL)
    for ts, js in zip(tp, jgp):
        for td, jd in zip(ts, js):
            for k in jd:
                _close(td[k].grad, jd[k], LAYER_RTOL, LAYER_ATOL)


def test_sampled_encoder_rejects_gat_and_rgcn():
    """The sampled encoder runs GAT and RGCN stages now: over JAX's batch,
    from JAX's parameters, it gives JAX's encodings (the layers' forms and
    gradients are held in tests/test_torch_gat.py and test_torch_rgcn.py)."""
    jg, jb = _jax_batch([JNbr("UNIFORM", 5), JNbr("UNIFORM", 4)])
    tb = to_torch_batch(jb)
    feats = np.random.default_rng(6).standard_normal((jb.node_ids[0].shape[0], 4)).astype(
        np.float32)
    for gnn in ("GAT", "RGCN"):
        def stages(L):
            return ((L("FEATURE", output_dim=4),),
                    (L("GNN", input_dim=4, output_dim=6, gnn_type=gnn, num_heads=2,
                       activation="RELU"),),
                    (L("GNN", input_dim=6, output_dim=2, gnn_type=gnn, num_heads=2),))
        jcfg, tcfg = JEncoderConfig(stages(JLayerConfig)), TEncoderConfig(stages(TLayerConfig))
        jp = jenc.init_encoder_params(jax.random.key(1), jcfg)
        tp = [[{k: torch.from_numpy(np.array(v)) for k, v in d.items()} for d in s] for s in jp]
        _close(tenc.encoder_forward(tcfg, tp, None, torch.from_numpy(feats), tb),
               jenc.encoder_forward(jcfg, jp, None, jnp.asarray(feats), jb),
               LAYER_RTOL, LAYER_ATOL)


# -- the trainer -------------------------------------------------------------

def _model(model_cls, enc_cls, layer_cls, opt_cls, variant):
    if variant == "arxiv":
        stages = [(layer_cls("FEATURE", output_dim=F, bias=True),),
                  (layer_cls("GNN", input_dim=F, output_dim=16, gnn_type="GRAPH_SAGE",
                             aggregator="MEAN", bias=True),),
                  (layer_cls("GNN", input_dim=16, output_dim=CLASSES, gnn_type="GRAPH_SAGE",
                             aggregator="MEAN", bias=True),)]
    else:   # a learnable table beside the features, RELU, a GCN stage
        stages = [(layer_cls("FEATURE", output_dim=F), layer_cls("EMBEDDING", output_dim=4)),
                  (layer_cls("GNN", input_dim=F + 4, output_dim=12, gnn_type="GRAPH_SAGE",
                             aggregator="MEAN", bias=True, activation="RELU"),),
                  (layer_cls("GNN", input_dim=12, output_dim=CLASSES, gnn_type="GCN",
                             bias=True),)]
    return model_cls("NODE_CLASSIFICATION", enc_cls(tuple(stages)), None,
                     loss_type="CROSS_ENTROPY", loss_reduction="SUM",
                     dense_optimizer=opt_cls("ADAM", learning_rate=0.01), sparse_lr=0.1)


VARIANTS = {
    # worst-case caps (the last hop saturates at N + 1): no overflow
    "arxiv": (("UNIFORM", 6), None),
    # tight caps: frontier ids drop and are counted
    "embedding-tight": (("DROPOUT", 6, 0.25), [B, 90, 180]),
}


class KeyReplay:
    """The port's ``_batch_draws`` seam: JAX's per-batch key schedule
    (``key, k_s = split(state.key)``, nc.py:474)."""

    def __init__(self, key):
        self.key = key

    def __call__(self):
        self.key, k_s = jax.random.split(self.key)
        return jax_draws(k_s)


def _np_state(jstate):
    return jax.tree.map(np.asarray, dataclasses.replace(jstate, key=None))


def _trainers(variant):
    edges, feats, labels, train = _graph_data()
    nbr, caps = VARIANTS[variant]
    jmodel = _model(JModel, JEncoderConfig, JLayerConfig, JOptimizerConfig, variant)
    tmodel = _model(TModel, TEncoderConfig, TLayerConfig, TOptimizerConfig, variant)
    jtr = jnc.NodeClassificationTrainer(jmodel, j_graph(edges, N), feats, labels, train,
                                        [JNbr(*nbr)] * 2, batch_size=B, hop_caps=caps, seed=0)
    ttr = tnc.NodeClassificationTrainer(tmodel, t_graph(edges, N), feats, labels, train,
                                        [TNbr(*nbr)] * 2, batch_size=B, hop_caps=caps, seed=0,
                                        device="cpu")
    assert ttr.hop_caps == jtr.hop_caps and ttr.num_batches == jtr.num_batches
    size = jtr.num_batches * B
    ttr._epoch_permutation = lambda p: torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(jax.random.key(54321), p), size))).long()
    # the key outlives JAX's donated state
    ttr._batch_draws = KeyReplay(jax.random.wrap_key_data(
        np.array(jax.random.key_data(jtr.state.key))))
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    return jtr, ttr, np.setdiff1d(np.arange(N), train)


def _check_states(js, ts):
    for t_stage, j_stage in zip(ts.params["encoder"], js.params["encoder"]):
        for td, jd in zip(t_stage, j_stage):
            for k, t in td.items():
                _close(t, jd[k])
    for slot in ("exp_avg", "exp_avg_sq"):
        for t_stage, j_stage in zip(ts.opt_state.slots[slot]["encoder"],
                                    js.opt_state.slots[slot]["encoder"]):
            for td, jd in zip(t_stage, j_stage):
                for k, t in td.items():
                    _close(t, jd[k])
    assert (ts.table is None) == (js.table is None)
    if ts.table is not None:
        _close(ts.table.values, js.table.values)
        _close(ts.table.state, js.table.state)
    assert ts.opt_state.step == int(js.opt_state.step) and ts.epoch == int(js.epoch)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sampled_nc_trainer_matches_jax(monkeypatch, variant):
    jtr, ttr, eval_nodes = _trainers(variant)
    launches = (gather_kernel.launches, nbr_sum_kernel.launches)
    for _ in range(2):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        assert tres["num_nodes"] == jres["num_nodes"]
        assert tres["truncated_frontier_ids"] == jres["truncated_frontier_ids"]
        assert (tres["truncated_frontier_ids"] > 0) == (variant == "embedding-tight")
        _check_states(_np_state(jtr.state), ttr.state)
    # the CPU runs the kernels' plain versions
    assert (gather_kernel.launches, nbr_sum_kernel.launches) == launches

    jev = jnc.NodeClassificationEvaluator(jtr, eval_nodes, batch_size=40)
    tev = tnc.NodeClassificationEvaluator(ttr, eval_nodes, batch_size=40)
    assert tev.hop_caps == jev.hop_caps
    tev._batch_draws = lambda i: jax_draws(jax.random.fold_in(jax.random.key(11), i))
    jacc, tacc = jev.evaluate(jtr.state), tev.evaluate(ttr.state)
    assert set(tacc) == set(jacc)
    assert tacc["num_evaluated"] == jacc["num_evaluated"] == len(eval_nodes)
    assert tacc["accuracy"] == jacc["accuracy"]
    np.testing.assert_array_equal(tev.predict_labels(ttr.state), jev.predict_labels(jtr.state))

    # all-node export from the same trained state, the draws of key(13)
    # folded with the batch
    monkeypatch.setattr(tge, "seeded_draws", lambda seed, i, dev: jax_draws(
        jax.random.fold_in(jax.random.key(seed), i)))
    js = jtr.state
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(js)))
    jenc_all = j_encode_all(jtr.model, js.params, None if js.table is None else js.table.values,
                            graph=jtr.graph, nbr_configs=jtr.nbr_configs,
                            features=jtr.features, batch_size=50)
    ts = ttr.state
    tenc_all = tge.encode_all_nodes(ttr.model, ts.params,
                                    None if ts.table is None else ts.table.values,
                                    graph=ttr.graph, nbr_configs=ttr.nbr_configs,
                                    features=ttr.features, batch_size=50)
    assert tenc_all.shape == (N, CLASSES)
    _close(tenc_all, jenc_all, LAYER_RTOL, LAYER_ATOL)


def test_sampled_trainer_rejects_later_slices():
    edges, feats, labels, train = _graph_data()
    model = _model(TModel, TEncoderConfig, TLayerConfig, TOptimizerConfig, "arxiv")
    graph = t_graph(edges, N)
    with pytest.raises(ValueError, match="neighbour config"):
        tnc.NodeClassificationTrainer(model, graph, feats, labels, train, device="cpu")
    # data-parallel meshes are ported (tests/test_torch_mesh_nc.py): the data
    # axis must divide the batch, and each index's hop caps cover its share
    mesh = types.SimpleNamespace(shape={"data": 3, "node": 1}, axis_index=lambda a: 0,
                                 device=torch.device("cpu"))
    with pytest.raises(ValueError, match="data axis"):
        tnc.NodeClassificationTrainer(model, graph, feats, labels, train,
                                      [TNbr("UNIFORM", 4)] * 2, device="cpu", mesh=mesh,
                                      batch_size=32)
    mesh.shape["data"] = 2
    dp = tnc.NodeClassificationTrainer(model, graph, feats, labels, train,
                                       [TNbr("UNIFORM", 4)] * 2, device="cpu", mesh=mesh,
                                       batch_size=32)
    assert dp.hop_caps[0] == 16
    # bf16 is ported (tests/test_torch_bf16.py)
    bf16 = tnc.NodeClassificationTrainer(model, graph, feats, labels, train,
                                         [TNbr("UNIFORM", 4)] * 2, device="cpu",
                                         dtype=torch.bfloat16)
    assert bf16.features.dtype == torch.bfloat16
