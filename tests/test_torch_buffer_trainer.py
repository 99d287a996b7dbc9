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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNeg
from marius_tpu.nn.decoders.edge import EdgeDecoder as JEdgeDecoder
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.ops.edge_keys import build_edge_key_set as j_keys
from marius_tpu.train.buffer_trainer import PartitionBufferLPTrainer as JTrainer
from marius_tpu_torch.convert import copy_buffer_trainer_from_jax_
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig as TNeg
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder as TEdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOpt
from marius_tpu_torch.ops.edge_keys import build_edge_key_set as t_keys
from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer as TTrainer

RTOL, ATOL = 1e-4, 1e-5


class JaxDraws:
    """JAX's in-buffer draws, replayed step by step from its key schedule."""

    def __init__(self, jtr):
        cfg = jtr.neg_config
        self.seed, self.c, self.n = jtr.seed, cfg.num_chunks, cfg.negatives_per_positive
        self.num_deg = int(cfg.negatives_per_positive * cfg.degree_fraction)
        self.b, self.psize, self.capacity = jtr.batch_size, jtr.buffer.psize, jtr.capacity
        self.epoch, self.keys = None, []

    def __call__(self, epoch: int, step: int, inverse: bool):
        if epoch != self.epoch:
            self.epoch, self.keys = epoch, []
            self.key = jax.random.fold_in(jax.random.key(self.seed + 7), epoch)
        while len(self.keys) <= step:
            self.key, k_dst, k_src = jax.random.split(self.key, 3)
            self.keys.append((k_dst, k_src))
        k1, k2, k3 = jax.random.split(self.keys[step][int(inverse)], 3)
        t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))  # noqa: E731
        slots = t(jax.random.randint(k1, (self.c, self.n), 0, self.capacity))
        offs = t(jax.random.randint(k2, (self.c, self.n), 0, self.psize))
        rows = (t(jax.random.randint(k3, (self.c, self.num_deg), 0, self.b, dtype=jnp.int32))
                if self.num_deg else None)
        return slots, offs, rows


def _models(decoder, d, r, opt):
    # Adam at lr 0.01: every Adam step moves a parameter by about lr whatever
    # its gradient, and the ~100 steps of two epochs (the padded ones
    # included) would carry float32 noise past the tolerance at lr 0.1
    lr = 0.01 if opt == "ADAM" else 0.1
    stages = lambda L: (((L("EMBEDDING", output_dim=d),),))  # noqa: E731
    return (JModel("LINK_PREDICTION", JEncoderConfig(stages(JLayerConfig)),
                   JEdgeDecoder(decoder, r, d), dense_optimizer=JOpt(opt, learning_rate=lr)),
            TModel("LINK_PREDICTION", TEncoderConfig(stages(TLayerConfig)),
                   TEdgeDecoder(decoder, r, d), dense_optimizer=TOpt(opt, learning_rate=lr)))


def _edges(n, r, e, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, r, e),
                     rng.integers(0, n, e)], 1).astype(np.int32)


def pair(n, r, d, e, *, parts, cap, ordering, deg, opt="ADAGRAD", decoder="DISTMULT",
         b=100, chunks=2, negs=16, filtered=False, seed=0, sparse_writeback=True):
    """A JAX and a port trainer on the same edges, the port's weights and
    draws the JAX trainer's."""
    edges = _edges(n, r, e, seed + 3)
    jmodel, tmodel = _models(decoder, d, r, opt)
    kw = dict(batch_size=b, num_partitions=parts, buffer_capacity=cap, seed=seed,
              ordering=ordering, sparse_writeback=sparse_writeback)
    jtr = JTrainer(jmodel, n, r, edges, JNeg(chunks, negs, deg, filtered=filtered),
                   train_filter_keys=((j_keys(edges, True), j_keys(edges, False))
                                      if filtered else None), **kw)
    ttr = TTrainer(tmodel, n, r, edges, TNeg(chunks, negs, deg, filtered=filtered),
                   train_filter_keys=((t_keys(edges, True), t_keys(edges, False))
                                      if filtered else None), device="cpu", **kw)
    # rows of +-0.1 (Glorot at 160k nodes gives ~0.006): the first
    # Adagrad step of a row is lr * g / |g|, so a near-cancelling gradient
    # of a tiny row would turn summation-order noise into a visible step
    rng = np.random.default_rng(seed + 5)
    jtr.buffer.host_values[:n] = rng.uniform(-0.1, 0.1, (n, d)).astype(np.float32)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    copy_buffer_trainer_from_jax_(ttr, np.asarray(jtr.buffer.host_values),
                                  np.asarray(jtr.buffer.host_state), np_tree(jtr.params),
                                  np_tree(jtr.opt_state), jtr.epoch)
    draws = JaxDraws(jtr)
    ttr._in_buffer_draws = lambda step, inverse: draws(ttr.epoch, step, inverse)
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
    cases = [(gnn, {}, "GNN"), (feat, {}, "FEATURE"), (tmodel, {"mesh": object()}, "mesh"),
             (rel, {}, "CORRUPT_REL"), (tmodel, {"nbr_configs": (object(),)}, "GNN")]
    for model, extra, what in cases:
        with pytest.raises(NotImplementedError, match=what):
            TTrainer(model, 40, 3, edges, neg, **kw, **extra)
