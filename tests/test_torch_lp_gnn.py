"""Link prediction with GNN and FEATURE encoders: the port against
marius_tpu, on the CPU (mirrors tests/test_lp_gnn.py).

The trainers start from JAX's initial state (``train_state_from_jax``), see
the same negatives (a deterministic function of the batch, patched into
JAX's ``sample_negatives`` and the port's ``_sample_negatives`` seam), JAX's
permutation (``_epoch_permutation``) and JAX's neighbour draws: the port's
``_batch_draws`` seam replays JAX's per-batch key schedule
(``key, k_dst, k_src = split(state.key, 3)``, then ``k_nb, key =
split(key)`` for the sampler and ``k_drop, key = split(key)``,
trainer.py:408-478). Over 2 epochs the loss, the table and its Adagrad
state, the parameters and the optimizer slots must agree to rtol 1e-4 /
atol 1e-5 (float32 on both sides; sums, the gather-sum and gradient
scatters run in another order). The graph has 1,000 nodes, so the first hop
takes the frontier-prefix branch and a second hop saturates.

One step from the same state agrees to ~1e-6, but 2 epochs of 94 batches
carry float32 noise forward, and three things in the model amplify it
(ROADMAP C5): Adagrad's step lr * g / sqrt(G) keeps a gradient's relative
error whatever its size, so the small, cancelling gradients of rows
reached through a sampled layer show at lr x that error; Adam's first steps
do the same for the dense parameters; a RELU input within float32 noise of
0 switches a gradient on or off. So the trainers here run dense Adagrad at
lr 0.1, the table at lr 0.02 and no RELU: the worst element then stays
within a quarter of the tolerance (with Adam at lr 0.01 or the table at lr
0.1 the trajectories reached it).

Evaluation ranks must be EQUAL to JAX's: the table, features, weights and
relations are quantized, and every node has in- and out-degree >= 2 under a
fanout of 2, so each neighbour sum has exactly 4 slots and the mean divides
by 4: every encoding and score is exact in float32 whatever the summation
order. The evaluator's sampler numbers replay JAX's (``fold_in(key(13),
tile)``). Host-tiled GNN evaluation equals device evaluation (the same
draws, the same tiles), and exact-ALL full-graph evaluation with an
EMBEDDING input equals sampled ALL evaluation, as in the JAX tests.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marius_tpu.train.evaluator as jevaluator
import marius_tpu.train.trainer as jtrainer_mod
import marius_tpu_torch.train.graph_encoder as tge
from marius_tpu.data.full_graph import build_full_graph_adjacency as j_adjacency
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNeg
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn.decoders.edge import EdgeDecoder as JEdgeDecoder
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.train.graph_encoder import encode_all_nodes as j_encode_all
from marius_tpu.train.graph_encoder import encode_all_nodes_host as j_encode_host
from marius_tpu_torch.convert import copy_train_state_, train_state_from_jax
from marius_tpu_torch.data.full_graph import build_full_graph_adjacency as t_adjacency
from marius_tpu_torch.data.graph import build_device_graph as t_graph
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig as TNeg
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.data.samplers.neighbor import resolve_all_caps_from_edges
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder as TEdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOpt
from marius_tpu_torch.ops.cuda import adagrad as adagrad_kernel
from marius_tpu_torch.ops.cuda import gather as gather_kernel
from marius_tpu_torch.ops.cuda import nbr_sum as nbr_sum_kernel
from marius_tpu_torch.train import evaluator as tevaluator
from marius_tpu_torch.train.trainer import LinkPredictionTrainer as TTrainer
from tests.test_lp_e2e import NUM_NODES, NUM_RELS, generate_random_lp_dataset
from tests.test_torch_lp_eval import jax_search_clamped  # noqa: F401  (a fixture)
from tests.test_torch_lp_trainer import (
    ATOL,
    RTOL,
    _np_state,
    fake_negatives_jax,
    fake_negatives_torch,
)
from tests.test_torch_neighbor_sampler import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6
N, R, E, F, B, C, NEG = 1000, 4, 3000, 6, 32, 2, 8


def _graph_edges(n=N, e=E, seed=0):
    rng = np.random.default_rng(seed)
    w = (np.arange(n) + 1.0) ** -0.8      # power-law destinations: hubs above the fanout
    return np.stack([rng.integers(0, n, e), rng.integers(0, R, e),
                     rng.choice(n, e, p=w / w.sum())], 1).astype(np.int32)


def _features(n=N, f=F, seed=1):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


def _stages(L, variant, d=8):
    """The encoder of each variant, with the JAX or the port's LayerConfig."""
    emb = (L("EMBEDDING", output_dim=d),)
    sage = dict(gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True)
    return {
        "sage-mean": (emb, (L("GNN", input_dim=d, output_dim=d, **sage),)),
        "sage-relu": (emb, (L("GNN", input_dim=d, output_dim=d, activation="RELU", **sage),)),
        "gcn": (emb, (L("GNN", input_dim=d, output_dim=d, gnn_type="GCN", bias=True),)),
        "sage-2-layers": (emb, (L("GNN", input_dim=d, output_dim=d, **sage),),
                          (L("GNN", input_dim=d, output_dim=d, **sage),)),
        "gnn-feature": ((L("EMBEDDING", output_dim=d - F), L("FEATURE", output_dim=F)),
                        (L("GNN", input_dim=d, output_dim=d, **sage),)),
        "embedding-feature": ((L("EMBEDDING", output_dim=d), L("FEATURE", output_dim=F)),),
        "pure-feature": ((L("FEATURE", output_dim=F, bias=True),),),
        # the reference's gat_1_layer and rgcn_1_layer fragments (tests/test_manager.py:239)
        "gat": (emb, (L("GNN", input_dim=d, output_dim=d, gnn_type="GAT", num_heads=2),)),
        "rgcn": (emb, (L("GNN", input_dim=d, output_dim=d, gnn_type="RGCN", num_relations=R,
                         bias=True),)),
    }[variant]


def _out_dim(variant, d=8):
    return {"embedding-feature": d + F, "pure-feature": F}.get(variant, d)


def _models(variant, d=8, r=R, lr=0.1, sparse_lr=0.02, opt="ADAGRAD"):
    dd = _out_dim(variant, d)
    return (JModel("LINK_PREDICTION", JEncoderConfig(_stages(JLayerConfig, variant, d)),
                   JEdgeDecoder("DISTMULT", r, dd), loss_type="SOFTMAX_CE",
                   loss_reduction="SUM", dense_optimizer=JOpt(opt, learning_rate=lr),
                   sparse_lr=sparse_lr),
            TModel("LINK_PREDICTION", TEncoderConfig(_stages(TLayerConfig, variant, d)),
                   TEdgeDecoder("DISTMULT", r, dd), loss_type="SOFTMAX_CE",
                   loss_reduction="SUM", dense_optimizer=TOpt(opt, learning_rate=lr),
                   sparse_lr=sparse_lr))


NBR = {"sage-mean": [("UNIFORM", 3)], "sage-relu": [("UNIFORM", 3)], "gcn": [("DROPOUT", 3, 0.3)],
       "sage-2-layers": [("UNIFORM", 2), ("UNIFORM", 3)], "gnn-feature": [("UNIFORM", 3)],
       "embedding-feature": [], "pure-feature": [], "gat": [("UNIFORM", 3)],
       "rgcn": [("UNIFORM", 3)]}


class KeyReplay:
    """The port's ``_batch_draws`` seam: JAX's per-batch key schedule."""

    def __init__(self, key):
        self.key = key

    def __call__(self):
        self.key, _, _ = jax.random.split(self.key, 3)   # k_dst, k_src: the negatives
        k_nb, self.key = jax.random.split(self.key)
        _, self.key = jax.random.split(self.key)         # k_drop
        return jax_draws(k_nb)


def trainer_pair(monkeypatch, variant, edges=None, features=None, n=N, train_edges=None,
                 models=None, **kw):
    """A JAX and a port trainer on the same data (``models``: a pair from
    :func:`_models`, by default the variant's); the port's state, negatives,
    permutation and draws are JAX's."""
    edges = _graph_edges() if edges is None else edges
    train_edges = edges if train_edges is None else train_edges
    features = (_features(n) if "feature" in variant else None) if features is None else features
    jmodel, tmodel = models or _models(variant)
    nbr = NBR[variant]
    monkeypatch.setattr(jtrainer_mod, "sample_negatives", fake_negatives_jax)
    jtr = jtrainer_mod.LinkPredictionTrainer(
        jmodel, n, R, train_edges, JNeg(C, NEG), batch_size=B, seed=0,
        graph=j_graph(edges, n, R) if nbr else None, nbr_configs=[JNbr(*c) for c in nbr],
        features=features, **kw)
    ttr = TTrainer(tmodel, n, R, train_edges, TNeg(C, NEG), batch_size=B, seed=0,
                   graph=t_graph(edges, n, R) if nbr else None,
                   nbr_configs=[TNbr(*c) for c in nbr], features=features, device="cpu", **kw)
    assert ttr.hop_caps == jtr.hop_caps and ttr.dense_accum == jtr.dense_accum
    cfg = ttr.neg_config
    monkeypatch.setattr(ttr, "_sample_negatives",
                        lambda edges_b, inverse: fake_negatives_torch(cfg, edges_b, n, inverse))
    size = jtr.num_batches * B
    monkeypatch.setattr(ttr, "_epoch_permutation", lambda e: torch.from_numpy(np.array(
        jax.random.permutation(jax.random.fold_in(jax.random.key(12345), e), size))).long())
    # the key outlives JAX's donated state
    ttr._batch_draws = KeyReplay(jax.random.wrap_key_data(
        np.array(jax.random.key_data(jtr.state.key))))
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    return jtr, ttr


def _close(t, j, rtol=RTOL, atol=ATOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _close_tree(t, j):
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            _close_tree(t[k], j[k])
    elif isinstance(t, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _close_tree(a, b)
    else:
        _close(t, j)


def check_states(ts, js):
    assert (ts.table is None) == (js.table is None)
    if ts.table is not None:
        _close(ts.table.values, js.table.values)
        _close(ts.table.state, js.table.state)
    _close_tree(ts.params, js.params)
    _close_tree(ts.opt_state.slots, js.opt_state.slots)
    assert ts.opt_state.step == int(js.opt_state.step) and ts.epoch == int(js.epoch)


# -- the trainer -------------------------------------------------------------

@pytest.mark.parametrize("variant", ["sage-mean", "gcn", "sage-2-layers", "gnn-feature",
                                     "embedding-feature", "pure-feature", "gat", "rgcn"])
def test_gnn_lp_trainer_matches_jax(monkeypatch, variant):
    jtr, ttr = trainer_pair(monkeypatch, variant)
    if NBR[variant]:
        # the outermost hop's node set: a frontier prefix, or every id
        assert ttr.hop_caps[-1] == (N + 1 if variant == "sage-2-layers" else 672)
    assert (ttr.state.table is None) == (variant == "pure-feature")
    launches = (gather_kernel.launches, nbr_sum_kernel.launches, adagrad_kernel.launches)
    for _ in range(2):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        check_states(ttr.state, _np_state(jtr.state))
    # the CPU runs the kernels' plain versions
    assert (gather_kernel.launches, nbr_sum_kernel.launches, adagrad_kernel.launches) == \
        launches


@pytest.mark.parametrize("batches", [1, 2])
def test_gnn_lp_steps_at_the_yaml_settings_match_jax(monkeypatch, batches):
    """The GNN LP step at examples/configuration/fb15k_237.yaml's optimizers
    (dense Adam at lr 0.1, table Adagrad at lr 0.1) with the gs_1_layer
    encoder's GraphSAGE MEAN stage and a RELU, from JAX's state over one
    epoch of 1 or 2 batches: the state at the trajectory tolerance (the
    worst element sits at 0.07 and 0.58 of it; from the third batch on,
    float32 noise grows past it, ROADMAP C5)."""
    edges = _graph_edges()
    jtr, ttr = trainer_pair(monkeypatch, "sage-relu", edges=edges,
                            train_edges=edges[:batches * B],
                            models=_models("sage-relu", lr=0.1, sparse_lr=0.1, opt="ADAM"))
    assert ttr.num_batches == jtr.num_batches == batches
    jres, tres = jtr.train_epoch(), ttr.train_epoch()
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
    check_states(ttr.state, _np_state(jtr.state))


def test_gnn_lp_trains_and_evaluates():
    """tests/test_lp_gnn.py's first case on the port alone: the loss falls and
    the filtered MRR beats twice a random ranking's."""
    train, valid, test = generate_random_lp_dataset()
    _, model = _models("sage-mean", d=16, r=NUM_RELS, lr=0.05, sparse_lr=0.1, opt="ADAM")
    nbr = [TNbr("UNIFORM", max_neighbors=5)]
    graph = t_graph(train, NUM_NODES, NUM_RELS)
    trainer = TTrainer(model, NUM_NODES, NUM_RELS, train, TNeg(5, 20), batch_size=100,
                       seed=0, graph=graph, nbr_configs=nbr, device="cpu")
    stats = trainer.train(4)
    assert np.isfinite(stats[-1]["loss"]) and stats[-1]["loss"] < stats[0]["loss"]
    ev = tevaluator.LinkPredictionEvaluator(
        model, NUM_NODES, NUM_RELS, train[:100], all_edges=np.concatenate([train, valid, test]),
        batch_size=100, graph=graph, nbr_configs=nbr, device="cpu")
    res = ev.evaluate(trainer.state)
    random_mrr = sum(1.0 / r for r in range(1, NUM_NODES + 1)) / NUM_NODES
    assert res["mrr"] > 2 * random_mrr, res


def test_gnn_lp_trainer_validates_its_inputs():
    _, model = _models("sage-mean")
    edges = _graph_edges()
    with pytest.raises(ValueError, match="neighbour config"):
        TTrainer(model, N, R, edges, TNeg(C, NEG), batch_size=B, device="cpu")
    with pytest.raises(ValueError, match="DeviceGraph"):
        TTrainer(model, N, R, edges, TNeg(C, NEG), batch_size=B,
                 nbr_configs=[TNbr("UNIFORM", 3)], device="cpu")
    _, feat_model = _models("pure-feature")
    with pytest.raises(ValueError, match="feature matrix"):
        TTrainer(feat_model, N, R, edges, TNeg(C, NEG), batch_size=B, device="cpu")


# -- evaluation ---------------------------------------------------------------

EN, EB = 200, 50


def _eval_edges():
    """Every node with in- and out-degree >= 2 (i -> i+1, i -> i+7) plus
    random edges: a fanout of 2 gives every neighbour sum exactly 4 slots."""
    rng = np.random.default_rng(4)
    i = np.arange(EN)
    ring = np.concatenate([np.stack([i, rng.integers(0, R, EN), (i + k) % EN], 1)
                           for k in (1, 7)])
    extra = np.stack([rng.integers(0, EN, 600), rng.integers(0, R, 600),
                      rng.integers(0, EN, 600)], 1)
    edges = np.unique(np.concatenate([ring, extra]), axis=0).astype(np.int32)
    test = edges[rng.permutation(len(edges))[:120]]
    return edges, test


def _quantized(rng, shape, k=4, lim=1):
    """Multiples of 1/k in [-lim/k, lim/k] (small: sums stay exact)."""
    return rng.integers(-lim, lim + 1, shape).astype(np.float32) / k


@pytest.mark.parametrize("variant", ["sage-mean", "gnn-feature", "embedding-feature"])
def test_gnn_evaluator_ranks_equal_jax(monkeypatch, jax_search_clamped, variant):  # noqa: F811
    edges, test = _eval_edges()
    rng = np.random.default_rng(5)
    features = _quantized(rng, (EN, F)) if "feature" in variant else None
    jmodel, tmodel = _models(variant)
    nbr = [("UNIFORM", 2)] if variant != "embedding-feature" else []
    jgraph = j_graph(edges, EN, R)
    jtr = jtrainer_mod.LinkPredictionTrainer(
        jmodel, EN, R, edges, JNeg(C, NEG), batch_size=EB, graph=jgraph if nbr else None,
        nbr_configs=[JNbr(*c) for c in nbr], features=features)
    s = jtr.state
    # weights in {-1/2 .. 1/2} / 2, relations in {-1 .. 1}: exact encodings and scores
    params = jax.tree.map(lambda a: jnp.asarray(_quantized(rng, a.shape, 4, 2)), s.params)
    params["decoder"] = {k: jnp.asarray(_quantized(rng, v.shape, 1, 1))
                         for k, v in s.params["decoder"].items()}
    js = dataclasses.replace(s, params=params, table=dataclasses.replace(
        s.table, values=jnp.asarray(_quantized(rng, s.table.values.shape))))
    ts = train_state_from_jax(_np_state(js))

    kw = dict(all_edges=edges, batch_size=EB, filtered=True, node_chunk=64)
    tfeats = None if features is None else torch.from_numpy(
        np.concatenate([features, np.zeros((1, F), np.float32)]))
    jev = jevaluator.LinkPredictionEvaluator(
        jmodel, EN, R, test, graph=jgraph if nbr else None, nbr_configs=[JNbr(*c) for c in nbr],
        features=None if features is None else jtr.features, **kw)
    tev = tevaluator.LinkPredictionEvaluator(
        tmodel, EN, R, test, graph=t_graph(edges, EN, R) if nbr else None,
        nbr_configs=[TNbr(*c) for c in nbr], features=tfeats, device="cpu", **kw)
    monkeypatch.setattr(tge, "seeded_draws", lambda seed, i, dev: jax_draws(
        jax.random.fold_in(jax.random.key(seed), i)))
    jranks, jscores = jev.compute_all_ranks(js)
    tranks, tscores = tev.compute_all_ranks(ts)
    assert tranks.shape == jranks.shape == (2, len(test))
    np.testing.assert_array_equal(tranks, jranks)
    np.testing.assert_array_equal(tscores, jscores)
    assert (jranks > 1).any() and (jranks < EN // 2).any()
    jres, tres = jev.evaluate(js), tev.evaluate(ts)
    for k in jres:
        if k != "eval_time_s":
            np.testing.assert_allclose(tres[k], jres[k], rtol=1e-6, err_msg=k)


def test_gnn_host_tiled_eval_matches_device_eval(monkeypatch):
    """tests/test_lp_gnn.py:62 on the port: the table stays in host RAM, node
    tiles are sampled and encoded on the device, and the filtered metrics
    equal the in-memory path's (the same batch size: the same draws). The
    host encodings of a GNN + FEATURE model equal JAX's with its draws."""
    train, valid, test = generate_random_lp_dataset()
    _, model = _models("sage-mean", d=16, r=NUM_RELS, lr=0.05, sparse_lr=0.1, opt="ADAM")
    nbr = [TNbr("UNIFORM", max_neighbors=5)]
    graph = t_graph(train, NUM_NODES, NUM_RELS)
    trainer = TTrainer(model, NUM_NODES, NUM_RELS, train, TNeg(5, 20), batch_size=100,
                       seed=0, graph=graph, nbr_configs=nbr, device="cpu")
    trainer.train(2)
    ev = tevaluator.LinkPredictionEvaluator(
        model, NUM_NODES, NUM_RELS, test, all_edges=np.concatenate([train, valid, test]),
        batch_size=50, graph=graph, nbr_configs=nbr, device="cpu")
    res_dev = ev.evaluate(trainer.state)
    host = trainer.state.table.values.numpy()
    res_host = ev.evaluate_from_host_table(host, trainer.state.params, edge_slice=32,
                                           node_tile=16)
    assert abs(res_dev["mrr"] - res_host["mrr"]) < 1e-5
    assert abs(res_dev["mean_rank"] - res_host["mean_rank"]) < 1e-3
    np.testing.assert_array_equal(
        tge.encode_all_nodes_host(model, trainer.state.params, host, "cpu", graph=graph,
                                  nbr_configs=nbr, batch_size=50),
        ev._encode(trainer.state).numpy())

    # GNN + FEATURE host encodings against JAX's, with JAX's draws
    edges = _graph_edges()
    features = _features()
    jtr, ttr = trainer_pair(monkeypatch, "gnn-feature", edges=edges, features=features)
    js = _np_state(jtr.state)
    monkeypatch.setattr(tge, "seeded_draws", lambda seed, i, dev: jax_draws(
        jax.random.fold_in(jax.random.key(seed), i)))
    jnbr, tnbr = [JNbr("UNIFORM", 3)], [TNbr("UNIFORM", 3)]
    jout = j_encode_host(jtr.model, jtr.state.params, js.table.values, graph=jtr.graph,
                         nbr_configs=jnbr, features_host=features, batch_size=128)
    tout = tge.encode_all_nodes_host(ttr.model, ttr.state.params, js.table.values, "cpu",
                                     graph=ttr.graph, nbr_configs=tnbr, features_host=features,
                                     batch_size=128)
    assert tout.shape == (N, 8)
    _close(tout, jout, LAYER_RTOL, LAYER_ATOL)


def test_full_graph_eval_matches_sampled_all():
    """tests/test_lp_gnn.py:164 on the port: exact-ALL full-graph encoding
    with an EMBEDDING input equals sampled ALL (cap >= max degree); and the
    full-graph encodings equal JAX's."""
    train, valid, test = generate_random_lp_dataset()
    _, model = _models("sage-mean", d=16, r=NUM_RELS, lr=0.05, sparse_lr=0.1, opt="ADAM")
    graph = t_graph(train, NUM_NODES, NUM_RELS)
    max_deg = int(graph.degrees.max())
    nbr_all = [TNbr("ALL", max_neighbors=max_deg)]
    trainer = TTrainer(model, NUM_NODES, NUM_RELS, train, TNeg(5, 20), batch_size=100,
                       seed=0, graph=graph, nbr_configs=nbr_all, device="cpu")
    trainer.train(2)
    kw = dict(all_edges=np.concatenate([train, valid, test]), batch_size=100, graph=graph,
              nbr_configs=nbr_all, device="cpu")
    sampled = tevaluator.LinkPredictionEvaluator(model, NUM_NODES, NUM_RELS, train[:100], **kw)
    fg = tevaluator.LinkPredictionEvaluator(model, NUM_NODES, NUM_RELS, train[:100],
                                            full_graph=t_adjacency(train, NUM_NODES), **kw)
    a, b = sampled.evaluate(trainer.state), fg.evaluate(trainer.state)
    assert abs(a["mrr"] - b["mrr"]) < 1e-4, (a["mrr"], b["mrr"])
    assert abs(a["hits@10"] - b["hits@10"]) < 1e-6
    _close(fg._encode(trainer.state), sampled._encode(trainer.state), LAYER_RTOL, LAYER_ATOL)

    # the same table and weights through JAX's full-graph encoder
    jmodel, _ = _models("sage-mean", d=16, r=NUM_RELS)
    params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), trainer.state.params)
    jout = j_encode_all(jmodel, params, jnp.asarray(trainer.state.table.values.numpy()),
                        nbr_configs=[JNbr("ALL", max_neighbors=max_deg)],
                        full_graph=j_adjacency(train, NUM_NODES))
    _close(fg._encode(trainer.state), jout, LAYER_RTOL, LAYER_ATOL)


def test_all_cap_truncation_warning():
    """tests/test_lp_gnn.py:123: hubs above all_cap_limit log a warning with
    the truncated-node count and neighbour-mass share; under the cap, none."""

    class Capture(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.records = []

        def emit(self, record):
            self.records.append(record)

    log = logging.getLogger("marius_tpu_torch")
    cap = Capture()
    log.addHandler(cap)
    old_level = log.level
    log.setLevel(logging.WARNING)
    try:
        # star graph: node 0 has 100 outgoing edges, cap at 10
        edges = np.stack([np.zeros(100, np.int32), np.zeros(100, np.int32),
                          np.arange(1, 101, dtype=np.int32)], axis=1)
        out = resolve_all_caps_from_edges([TNbr("ALL")], edges, 101, cap_limit=10)
        assert out[0].max_neighbors == 10
        assert any("uniformly truncated" in r.getMessage() for r in cap.records), cap.records
        cap.records.clear()
        assert resolve_all_caps_from_edges([TNbr("ALL")], edges, 101,
                                           cap_limit=128)[0].max_neighbors == 100
        assert not cap.records
    finally:
        log.removeHandler(cap)
        log.setLevel(old_level)
