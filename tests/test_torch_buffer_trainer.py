"""The port's PartitionBufferLPTrainer against marius_tpu's, over 2 epochs.

Both trainers start from the JAX trainer's weights (its padded host table and
Adagrad state, dense parameters and optimizer state, carried across with
``copy_buffer_trainer_from_jax_``). The JAX draws cannot be injected into its
compiled state function, so the test replays JAX's key schedule eagerly
(threefry gives the same values as under ``jit``): the epoch's key is
``fold_in(key(seed + 7), epoch)``; each scan step, the fully masked padding
steps included, splits it in three, and each direction's key in three again
for the slot, offset and batch-row ``randint``s. Those draws go through the
port's ``_in_buffer_draws`` seam by step. The orderings, the bucket layout
and the per-state shuffles are numpy and native code, equal by construction.

After each epoch the loss, and after both the flushed host table and Adagrad
state and the dense parameters, must agree to rtol 1e-4, atol 1e-5 (the
in-memory trainers' tolerance: float32 sums and gradient scatters run in
another order).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNeg
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn.decoders.edge import EdgeDecoder as JEdgeDecoder
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.ops.edge_keys import build_edge_key_set as j_keys
from marius_tpu.train.buffer_trainer import PartitionBufferLPTrainer as JTrainer
from marius_tpu_torch.convert import copy_buffer_trainer_from_jax_
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig as TNeg
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder as TEdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOpt
from marius_tpu_torch.ops.edge_keys import build_edge_key_set as t_keys
from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer as TTrainer
from tests.test_torch_neighbor_sampler import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5


class JaxDraws:
    """JAX's in-buffer draws, replayed step by step from its key schedule;
    with a GNN encoder each step also splits off the sampler's key and the
    dropout key (buffer_trainer.py:378, :385)."""

    def __init__(self, jtr):
        cfg = jtr.neg_config
        self.seed, self.c, self.n = jtr.seed, cfg.num_chunks, cfg.negatives_per_positive
        self.num_deg = int(cfg.negatives_per_positive * cfg.degree_fraction)
        self.b, self.psize, self.capacity = jtr.batch_size, jtr.buffer.psize, jtr.capacity
        self.gnn = bool(jtr.nbr_configs)
        self.epoch, self.keys = None, []

    def _keys(self, epoch: int, step: int):
        """(k_dst, k_src, k_nb) of ``step``."""
        if epoch != self.epoch:
            self.epoch, self.keys = epoch, []
            self.key = jax.random.fold_in(jax.random.key(self.seed + 7), epoch)
        while len(self.keys) <= step:
            self.key, k_dst, k_src = jax.random.split(self.key, 3)
            k_nb = None
            if self.gnn:
                k_nb, self.key = jax.random.split(self.key)
                _, self.key = jax.random.split(self.key)     # k_drop
            self.keys.append((k_dst, k_src, k_nb))
        return self.keys[step]

    def sampler(self, epoch: int, step: int):
        """The neighbour sampler's draws of ``step`` (the ``_gnn_draws`` seam)."""
        return jax_draws(self._keys(epoch, step)[2])

    def __call__(self, epoch: int, step: int, inverse: bool):
        k1, k2, k3 = jax.random.split(self._keys(epoch, step)[int(inverse)], 3)
        t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))  # noqa: E731
        slots = t(jax.random.randint(k1, (self.c, self.n), 0, self.capacity))
        offs = t(jax.random.randint(k2, (self.c, self.n), 0, self.psize))
        rows = (t(jax.random.randint(k3, (self.c, self.num_deg), 0, self.b, dtype=jnp.int32))
                if self.num_deg else None)
        return slots, offs, rows


def _embedding_stages(L, d):
    return ((L("EMBEDDING", output_dim=d),),)


def _models(decoder, d, r, opt, stages=_embedding_stages, sparse_lr=0.1):
    """``stages(LayerConfig, d)``: the encoder, whose output width is d."""
    # Adam at lr 0.01: every Adam step moves a parameter by about lr whatever
    # its gradient, and the ~100 steps of two epochs (the padded ones
    # included) would carry float32 noise past the tolerance at lr 0.1
    lr = 0.01 if opt == "ADAM" else 0.1
    return (JModel("LINK_PREDICTION", JEncoderConfig(stages(JLayerConfig, d)),
                   JEdgeDecoder(decoder, r, d), dense_optimizer=JOpt(opt, learning_rate=lr),
                   sparse_lr=sparse_lr),
            TModel("LINK_PREDICTION", TEncoderConfig(stages(TLayerConfig, d)),
                   TEdgeDecoder(decoder, r, d), dense_optimizer=TOpt(opt, learning_rate=lr),
                   sparse_lr=sparse_lr))


def _edges(n, r, e, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, r, e),
                     rng.integers(0, n, e)], 1).astype(np.int32)


def pair(n, r, d, e, *, parts, cap, ordering, deg, opt="ADAGRAD", decoder="DISTMULT",
         b=100, chunks=2, negs=16, filtered=False, seed=0, sparse_writeback=True,
         stages=_embedding_stages, nbr=(), features=None, sparse_lr=0.1):
    """A JAX and a port trainer on the same edges, the port's weights and
    draws the JAX trainer's; ``nbr``: (type, fanout) per GNN stage."""
    edges = _edges(n, r, e, seed + 3)
    jmodel, tmodel = _models(decoder, d, r, opt, stages, sparse_lr)
    kw = dict(batch_size=b, num_partitions=parts, buffer_capacity=cap, seed=seed,
              ordering=ordering, sparse_writeback=sparse_writeback, features=features)
    jtr = JTrainer(jmodel, n, r, edges, JNeg(chunks, negs, deg, filtered=filtered),
                   train_filter_keys=((j_keys(edges, True), j_keys(edges, False))
                                      if filtered else None),
                   nbr_configs=[JNbr(*c) for c in nbr], **kw)
    ttr = TTrainer(tmodel, n, r, edges, TNeg(chunks, negs, deg, filtered=filtered),
                   train_filter_keys=((t_keys(edges, True), t_keys(edges, False))
                                      if filtered else None),
                   nbr_configs=[TNbr(*c) for c in nbr], device="cpu", **kw)
    assert ttr.hop_caps == jtr.hop_caps
    # rows of +-0.1 (Glorot at 160k nodes gives ~0.006): the first
    # Adagrad step of a row is lr * g / |g|, so a near-cancelling gradient
    # of a tiny row would turn summation-order noise into a visible step
    rng = np.random.default_rng(seed + 5)
    jtr.buffer.host_values[:n] = rng.uniform(
        -0.1, 0.1, (n, jtr.buffer.dim)).astype(np.float32)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    copy_buffer_trainer_from_jax_(ttr, np.asarray(jtr.buffer.host_values),
                                  np.asarray(jtr.buffer.host_state), np_tree(jtr.params),
                                  np_tree(jtr.opt_state), jtr.epoch)
    draws = JaxDraws(jtr)
    ttr._in_buffer_draws = lambda step, inverse: draws(ttr.epoch, step, inverse)
    ttr._gnn_draws = lambda step: draws.sampler(ttr.epoch, step)
    return jtr, ttr


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t.detach() if isinstance(t, torch.Tensor) else t),
                               np.asarray(j), rtol=RTOL, atol=ATOL)


def _close_tree(t, j):
    """Leaves matched by key and position (JAX's dicts come back key-sorted)."""
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


def run_and_compare(jtr, ttr, epochs=2):
    for _ in range(epochs):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        for k in ("edges_trained", "num_buffer_states", "states_run"):
            assert tres[k] == jres[k], k
    jtr.buffer.flush()
    _close(ttr.buffer.host_values, jtr.buffer.host_values)
    _close(ttr.buffer.host_state, jtr.buffer.host_state)
    _close_tree(ttr.params, jax.tree.map(np.asarray, jtr.params))
    _close_tree(ttr.opt_state.slots, jax.tree.map(np.asarray, jtr.opt_state.slots))
    assert ttr.opt_state.step == int(jtr.opt_state.step)
    return tres


@pytest.mark.parametrize("ordering,deg,opt,decoder", [
    ("BETA", 0.0, "ADAGRAD", "DISTMULT"),
    ("COMET", 0.5, "ADAM", "COMPLEX"),
    ("COMET", 0.0, "ADAM", "DISTMULT"),
    ("BETA", 0.5, "ADAGRAD", "COMPLEX"),
], ids=["beta-uniform-adagrad", "comet-deg-adam-complex", "comet-uniform-adam",
        "beta-deg-adagrad-complex"])
def test_dense_accum_branch_matches_jax(ordering, deg, opt, decoder):
    jtr, ttr = pair(240, 5, 16, 3000, parts=8, cap=4, ordering=ordering, deg=deg, opt=opt,
                    decoder=decoder)
    assert jtr.dense_accum and ttr.dense_accum
    res = run_and_compare(jtr, ttr)
    # the padded steps JAX runs are the port's skipped ones: counted, not lost
    assert res["masked_batches"] > 0
    assert res["batches_run"] + res["masked_batches"] == res["states_run"] * res["max_batches"]


@pytest.mark.parametrize("ordering,opt", [("COMET", "ADAGRAD"), ("BETA", "ADAM")],
                         ids=["comet-adagrad", "beta-adam"])
def test_unique_branch_matches_jax(ordering, opt):
    # buffer_rows x d = 4 x 20,000 x 112 = 8.96M > 8M: the unique-id branch
    jtr, ttr = pair(160_000, 4, 112, 1500, parts=8, cap=4, ordering=ordering, deg=0.5,
                    opt=opt, decoder="COMPLEX", b=100, chunks=2, negs=8)
    assert not jtr.dense_accum and not ttr.dense_accum
    run_and_compare(jtr, ttr)


def test_train_filter_keys_match_jax():
    jtr, ttr = pair(120, 3, 8, 1500, parts=4, cap=2, ordering="BETA", deg=0.5,
                    filtered=True, opt="ADAM")
    assert ttr.train_filter_keys is not None
    run_and_compare(jtr, ttr)


def test_full_writeback_and_inline_prep_match_jax():
    """sparse_writeback off (whole-slot evictions) and prefetching off."""
    jtr, ttr = pair(200, 4, 8, 1200, parts=8, cap=4, ordering="COMET", deg=0.25,
                    sparse_writeback=False)
    assert ttr.buffer.dirty is None and jtr.buffer.dirty is None
    ttr.prefetching = jtr.prefetching = False
    run_and_compare(jtr, ttr)


def test_partial_epoch_and_state_view():
    jtr, ttr = pair(200, 4, 8, 1200, parts=8, cap=4, ordering="COMET", deg=0.0)
    jres, tres = jtr.train_epoch(max_states=2), ttr.train_epoch(max_states=2)
    assert tres["states_run"] == jres["states_run"] == 2
    assert 0 < tres["edges_trained"] == jres["edges_trained"] < tres["num_edges"]
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
    js, ts = jtr.state, ttr.state
    _close(ts.table.values, js.table.values)
    _close(ts.table.state, js.table.state)
    assert ts.table.values.shape == (200, 8) and ts.epoch == int(js.epoch) == 1
    # the view shares the host arrays; the setter copies a state back in
    assert ts.table.values.data_ptr() == ttr.buffer.host_values.ctypes.data
    ts.table.values.mul_(0.5)
    ttr.state = ts
    np.testing.assert_array_equal(ttr.buffer.host_values[:200], ts.table.values.numpy())
    m = ttr.train_epoch()
    assert m["edges_trained"] == m["num_edges"] == 1200 and np.isfinite(m["loss"])


def _gnn_stages(L, d):
    """EMBEDDING, then GraphSAGE MEAN over the resident subgraph."""
    return ((L("EMBEDDING", output_dim=d),),
            (L("GNN", input_dim=d, output_dim=d, gnn_type="GRAPH_SAGE", aggregator="MEAN",
               bias=True),))


def _gnn_feature_stages(L, d, f=6):
    """EMBEDDING beside FEATURE, a CONCAT reduction, GraphSAGE MEAN
    (tests/test_buffer.py:235)."""
    return ((L("EMBEDDING", output_dim=d - f), L("FEATURE", output_dim=f)),
            (L("REDUCTION", reduction="CONCAT", output_dim=d),),
            (L("GNN", input_dim=d, output_dim=d, gnn_type="GRAPH_SAGE", aggregator="MEAN"),))


def _gat_stages(L, d):
    """EMBEDDING, then GAT with 2 averaged heads (gat_1_layer)."""
    return ((L("EMBEDDING", output_dim=d),),
            (L("GNN", input_dim=d, output_dim=d, gnn_type="GAT", num_heads=2),))


def _rgcn_stages(L, d, r=4):
    """EMBEDDING, then RGCN over the resident subgraph's relations (rgcn_1_layer)."""
    return ((L("EMBEDDING", output_dim=d),),
            (L("GNN", input_dim=d, output_dim=d, gnn_type="RGCN", num_relations=r, bias=True),))


def _feature_stages(L, d, f=6):
    """Shallow EMBEDDING + FEATURE, concatenated (tests/test_buffer.py:297)."""
    return ((L("EMBEDDING", output_dim=d - f), L("FEATURE", output_dim=f, bias=True)),)


BUFFER_ENCODERS = {
    # the resident subgraph of 1,000 rows: the hop is a frontier prefix
    "gnn-comet": dict(n=2000, stages=_gnn_stages, nbr=[("UNIFORM", 2)], ordering="COMET",
                      b=50),
    # 80 nodes (tests/test_buffer.py:181): the hop covers every resident row
    "gnn-beta-dropout": dict(n=80, stages=_gnn_stages, nbr=[("DROPOUT", 4, 0.25)],
                             ordering="BETA", b=100),
    "gnn-feature-comet": dict(n=80, stages=_gnn_feature_stages, nbr=[("UNIFORM", 4)],
                              ordering="COMET", b=100, features=True),
    "gnn-feature-beta": dict(n=2000, stages=_gnn_feature_stages, nbr=[("UNIFORM", 2)],
                             ordering="BETA", b=50, features=True),
    "feature-comet": dict(n=80, stages=_feature_stages, nbr=[], ordering="COMET", b=100,
                          features=True),
    "gat-comet": dict(n=2000, stages=_gat_stages, nbr=[("UNIFORM", 2)], ordering="COMET",
                      b=50),
    "rgcn-beta": dict(n=80, stages=_rgcn_stages, nbr=[("UNIFORM", 4)], ordering="BETA", b=100),
}


@pytest.mark.parametrize("name", list(BUFFER_ENCODERS))
def test_gnn_and_feature_encoders_match_jax(name):
    """GNN and FEATURE encoders over the buffer (tests/test_buffer.py:181, 235,
    297) against JAX, 2 epochs: the state graph of each state, the sampler
    over it with JAX's draws, the slot-mirrored feature cache."""
    cfg = dict(BUFFER_ENCODERS[name])
    n, features = cfg.pop("n"), cfg.pop("features", False)
    feats = (np.random.default_rng(6).standard_normal((n, 6)).astype(np.float32)
             if features else None)
    # table lr 0.02: Adagrad's step lr * g / sqrt(G) keeps a gradient's relative
    # float32 error whatever its size, so the small, cancelling gradients of
    # rows reached through the sampled layer show at lr x that error (ROADMAP C5)
    jtr, ttr = pair(n, 4, 12, 1500, parts=4, cap=2, deg=0.0, chunks=2, negs=8,
                    features=feats, sparse_lr=0.02, **cfg)
    assert ttr.dense_accum == jtr.dense_accum == (not cfg["nbr"])
    assert (ttr.feature_cache is None) == (not features)
    res = run_and_compare(jtr, ttr)
    if cfg["nbr"]:
        assert ttr.hop_caps[-1] == (660 if n == 2000 else ttr.buffer.buffer_rows + 1)
        assert res["max_graph_edges"] > 0 and len(ttr.last_graph_seconds) == res["states_run"]
    if features:
        # the cache mirrors the embedding buffer's last layout
        np.testing.assert_array_equal(ttr.feature_cache.resident, jtr.feature_cache.resident)


@pytest.mark.parametrize("name", ["gnn-comet", "gnn-feature-beta"])
def test_gnn_buffer_states_at_the_yaml_lr_match_jax(name):
    """The GNN branch at examples/configuration/freebase86m_comet.yaml's
    optimizers (ComplEx, dense and table Adagrad at lr 0.1) against JAX over
    the first two buffer states of an epoch (a swap and a prefetched state
    graph between them), at the trajectory tolerance: the worst element sits
    at 0.07-0.28 of it; a third state takes float32 noise past it
    (ROADMAP C5)."""
    cfg = dict(BUFFER_ENCODERS[name])
    n, features = cfg.pop("n"), cfg.pop("features", False)
    feats = (np.random.default_rng(6).standard_normal((n, 6)).astype(np.float32)
             if features else None)
    jtr, ttr = pair(n, 4, 12, 1500, parts=4, cap=2, deg=0.0, chunks=2, negs=8,
                    decoder="COMPLEX", features=feats, sparse_lr=0.1, **cfg)
    jres, tres = jtr.train_epoch(max_states=2), ttr.train_epoch(max_states=2)
    assert tres["states_run"] == jres["states_run"] == 2 and tres["batches_run"] > 1
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
    jtr.buffer.flush()
    _close(ttr.buffer.host_values, jtr.buffer.host_values)
    _close(ttr.buffer.host_state, jtr.buffer.host_state)
    _close_tree(ttr.params, jax.tree.map(np.asarray, jtr.params))
    _close_tree(ttr.opt_state.slots, jax.tree.map(np.asarray, jtr.opt_state.slots))


def test_state_graph_matches_jax():
    """One state's resident-subgraph CSR, built from its planned layout,
    equals JAX's ``_state_graph`` exactly."""
    from marius_tpu_torch.train.buffer_trainer import state_graph

    jtr, ttr = pair(300, 4, 8, 1500, parts=4, cap=2, ordering="BETA", deg=0.0,
                    stages=_gnn_stages, nbr=[("UNIFORM", 2)], b=50)
    states, _ = jtr._plan_epoch()
    jtr.buffer.load(states[0])
    jtr.buffer.swap_to_state(states[1])
    jg = jtr._state_graph(1 << 12)
    tg = state_graph(ttr.edges_by_bucket, ttr.bucket_offsets, jtr.buffer.resident,
                     4, ttr.buffer.psize, 1 << 12, "cpu")
    assert tg.num_nodes == jg.num_nodes
    for name in ("out_offsets", "out_cols", "out_rels", "in_offsets", "in_cols", "in_rels",
                 "degrees"):
        t, j = getattr(tg, name), getattr(jg, name)
        assert (t is None) == (j is None), name
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def test_unported_options_raise():
    from marius_tpu_torch.nn.model import Model

    _, tmodel = _models("DISTMULT", 8, 3, "ADAGRAD")
    edges, neg = _edges(40, 3, 100, 0), TNeg(2, 4)
    kw = dict(batch_size=20, num_partitions=4, buffer_capacity=2, device="cpu")
    gnn = TModel("LINK_PREDICTION", TEncoderConfig((
        (TLayerConfig("EMBEDDING", output_dim=8),),
        (TLayerConfig("GNN", input_dim=8, output_dim=8),))), TEdgeDecoder("DISTMULT", 3, 8))
    feat = TModel("LINK_PREDICTION", TEncoderConfig(
        ((TLayerConfig("EMBEDDING", output_dim=4), TLayerConfig("FEATURE", output_dim=4)),)),
        TEdgeDecoder("DISTMULT", 3, 8))
    rel = Model("LINK_PREDICTION", tmodel.encoder,
                TEdgeDecoder("DISTMULT", 3, 8, decoder_method="CORRUPT_REL"))
    # meshes are ported (tests/test_torch_mesh_buffer.py): a one-rank mesh
    # shards nothing and turns sparse writeback off, as JAX does under a mesh
    one = types.SimpleNamespace(shape={"data": 1, "node": 1}, axis_index=lambda axis: 0,
                                device=torch.device("cpu"))
    meshed = TTrainer(tmodel, 40, 3, edges, neg, **kw, mesh=one)
    assert not meshed.sparse_writeback and meshed.buffer.dirty is None
    assert meshed.buffer.shard_size == meshed.buffer.buffer_rows
    # CORRUPT_REL is ported (tests/test_torch_corrupt_rel.py); it needs typed edges
    assert TTrainer(rel, 40, 3, edges, neg, **kw).decoder_method == "CORRUPT_REL"
    with pytest.raises(ValueError, match="typed"):
        TTrainer(rel, 40, 3, edges[:, [0, 2]], neg, **kw)
    # GNN and FEATURE encoders are ported (test_gnn_and_feature_encoders_match_jax);
    # each needs what it reads
    with pytest.raises(ValueError, match="neighbour config"):
        TTrainer(gnn, 40, 3, edges, neg, **kw)
    with pytest.raises(ValueError, match="feature matrix"):
        TTrainer(feat, 40, 3, edges, neg, **kw)
    for model, extra in ((gnn, {"nbr_configs": [TNbr("UNIFORM", 2)]}),
                         (feat, {"features": np.ones((40, 4), np.float32)})):
        res = TTrainer(model, 40, 3, edges, neg, **kw, **extra).train_epoch()
        assert res["edges_trained"] == 100 and np.isfinite(res["loss"])
