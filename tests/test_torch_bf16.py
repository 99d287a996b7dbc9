"""bfloat16 tables, parameters and features: the port against marius_tpu, on
the CPU (the kernels' bf16 entries against their plain versions on the card
are the ``cuda`` tests of tests/test_torch_kernels.py).

What is exact, and what is held to the bf16 tolerance:

- The row gather copies: bit for bit against JAX's ``gather_rows``.
- Adagrad over unique ids: XLA compiles JAX's plain ``sparse_adagrad_update``
  on bf16 rows to one rounding to bf16 after each operation, with lr and eps
  rounded to bf16 (Python scalars are weakly typed); the port's plain version
  runs that sequence and equals JAX bit for bit (0 ulp, below the stated 1).
  The dense-accumulate variant sums duplicate ids' gradients in bf16, XLA in
  order and ``index_add_`` in its own order: the Adagrad state is held to 2
  bf16 ulps of its largest element (one rounding of a partial sum placed
  differently, squared), untouched rows bit for bit.
- The dense optimizers on bf16 leaves: bit for bit against JAX's
  ``apply_optimizer``, which computes what its weak types give, not what its
  docstring says: SGD, the Adagrad sum and Adam's moments in bf16, the
  Adagrad and Adam parameter updates in float32 (the step-dependent scalars
  are float32 arrays) rounded once. The "all step math in float32" reading
  of the docstring gives other bits, and the test shows it.
- Trainers: XLA and torch round each elementwise op alike, but sums over
  the embedding width, the loss's reductions and gradient scatters run in
  other orders, so a trajectory drifts by a few bf16 ulps, and Adagrad's
  first step lr * g / |g| turns a gradient's relative error into a step
  (ROADMAP C5): over 2 epochs (the same seams and starting state as the
  float32 parity tests) states agree to rtol 2^-4 (8 bf16 ulps) / atol
  2^-5, losses to rtol 2^-6 (an NC model's batch loss is itself a bf16
  number: 2 ulps).
- The sampled neighbour sum of bf16 features returns bf16 (ROADMAP C9),
  f32-accumulated and rounded once: within 1 bf16 ulp of JAX's
  ``masked_sum`` (its einsum's own order).
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import marius_tpu.train.trainer as jtrainer_mod
from marius_tpu.data import full_graph as jfg
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNeg
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn import optimizers as jopt
from marius_tpu.nn.decoders.edge import EdgeDecoder as JEdgeDecoder
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.ops.segment import masked_sum as j_masked_sum
from marius_tpu.parallel import embedding_table as jet
from marius_tpu.storage import checkpoint as jckpt
from marius_tpu.train import nc as jnc
from marius_tpu.train.buffer_trainer import PartitionBufferLPTrainer as JBufferTrainer
from marius_tpu_torch.config.schema import load_config
from marius_tpu_torch.convert import (
    copy_buffer_trainer_from_jax_,
    copy_train_state_,
    train_state_from_jax,
)
from marius_tpu_torch.data import full_graph as tfg
from marius_tpu_torch.data.graph import build_device_graph as t_graph
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig as TNeg
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.manager import marius_eval, marius_init, marius_train
from marius_tpu_torch.nn import optimizers as topt
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder as TEdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOpt
from marius_tpu_torch.ops import segment as tseg
from marius_tpu_torch.ops.cuda import adagrad as tadagrad
from marius_tpu_torch.ops.cuda import gather as tgather
from marius_tpu_torch.parallel import embedding_table as tet
from marius_tpu_torch.storage import checkpoint as tckpt
from marius_tpu_torch.storage import transfer
from marius_tpu_torch.storage.partition_buffer import PartitionBuffer
from marius_tpu_torch.train import nc as tnc
from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer as TBufferTrainer
from marius_tpu_torch.train.trainer import LinkPredictionTrainer as TTrainer
from tests.test_torch_buffer_trainer import JaxDraws
from tests.test_torch_lp_trainer import _edges, fake_negatives_jax, fake_negatives_torch
from tests.test_torch_manager import _lp_config, _nc_raw
from tests.test_torch_nc_trainer import _data as fg_data
from tests.test_torch_nc_trainer import _model as fg_model
from tests.test_torch_sampled_nc import N as SAMPLED_N
from tests.test_torch_sampled_nc import KeyReplay as NCKeyReplay
from tests.test_torch_sampled_nc import _graph_data as sampled_data
from tests.test_torch_sampled_nc import _model as sampled_model
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16_RTOL, BF16_ATOL = 2 ** -4, 2 ** -5
LOSS_RTOL = 2 ** -6
BF = torch.bfloat16


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bits(a) -> np.ndarray:
    """The bf16 bit patterns of a bf16 tensor or JAX array, as int32."""
    return torch.from_numpy(_f32(a)).to(BF).view(torch.int16).numpy().astype(np.int32)


def _close(t, j, rtol=BF16_RTOL, atol=BF16_ATOL):
    np.testing.assert_allclose(_f32(t), _f32(j), rtol=rtol, atol=atol)


def _close_tree(t, j):
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            _close_tree(t[k], j[k])
    elif isinstance(t, (list, tuple)):
        for a, b in zip(t, j):
            _close_tree(a, b)
    else:
        _close(t, j)


def _np_state(jstate):
    return jax.tree.map(np.asarray, dataclasses.replace(jstate, key=None))


# -- the plain versions of the kernels ---------------------------------------------

def test_plain_gather_bf16_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    n, d = 300, 50
    table = jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16)
    ids = rng.integers(-2, n + 3, 777).astype(np.int32)
    ids[:4] = n                                     # the padding id
    ref = jet.gather_rows(table, jnp.asarray(np.clip(ids, 0, None)))
    out = tet.gather_rows(tckpt.from_numpy(np.asarray(table)), torch.from_numpy(ids).long())
    assert out.dtype == BF
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8, 50, 100, 101, 128])
@pytest.mark.parametrize("offset", [0, 2, 4, 8])
def test_gather_plan_bf16(d, offset):
    """2-byte rows: 16-, 8-, 4- or 2-byte vectors, whichever divides the
    row's 2d bytes and the table's offset. fb15k_237's d = 50 (100-byte
    rows) takes 4-byte vectors, freebase86m's d = 100 8-byte ones."""
    base = 0x7F3A_0000_0000
    p = tgather.plan(d, base + offset, base + (1 << 30), 12000, 132, 16, elem_bytes=2)
    row_vec = next(v for v in (16, 8, 4, 2) if (2 * d) % v == 0)
    assert p.vec_bytes == min(row_vec, offset or 16)
    assert p.vectors_per_row * p.vec_bytes == 2 * d
    assert p.unroll * p.vec_bytes == tgather.THREAD_BYTES
    if offset == 0:
        assert p.vec_bytes == {50: 4, 100: 8}.get(d, p.vec_bytes)


def _adagrad_inputs(n=300, d=50, k=240, pad=True, unique=True, seed=3):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, d)).astype(np.float32) * 0.1
    state = np.abs(rng.standard_normal((n, d)).astype(np.float32)) * 0.01
    state[::7] = 0.0                              # rows never updated before
    ids = (rng.permutation(n)[:k] if unique else rng.integers(0, n, k)).astype(np.int32)
    if pad:
        ids[-10:] = n                             # padding ids: dropped / skipped
    grads = rng.standard_normal((k, d)).astype(np.float32) * 0.05
    grads[:5] = 0.0
    return vals, state, ids, grads


def test_plain_adagrad_bf16_matches_jax_bit_for_bit():
    vals, state, ids, grads = _adagrad_inputs()
    j = jet.sparse_adagrad_update(
        jet.EmbeddingTable(jnp.asarray(vals, jnp.bfloat16), jnp.asarray(state, jnp.bfloat16)),
        jnp.asarray(ids), jnp.asarray(grads, jnp.bfloat16), 0.1)
    tv, ts = torch.from_numpy(vals).to(BF), torch.from_numpy(state).to(BF)
    tadagrad.sparse_adagrad_update_(tv, ts, torch.from_numpy(ids).long(),
                                    torch.from_numpy(grads).to(BF), 0.1)
    np.testing.assert_array_equal(_bits(tv), _bits(j.values))
    np.testing.assert_array_equal(_bits(ts), _bits(j.state))
    # the plain version's sequence is not float32 math rounded once
    g32 = torch.from_numpy(grads).to(BF).float()[:-10]
    rows = torch.from_numpy(ids[:-10]).long()
    s32 = torch.from_numpy(state).to(BF).float()[rows] + g32 * g32
    v32 = (torch.from_numpy(vals).to(BF).float()[rows]
           - 0.1 * g32 / (torch.sqrt(s32) + 1e-10)).to(BF)
    assert (_bits(v32) != _bits(tv[rows])).any()


def test_plain_dense_accum_bf16_matches_jax():
    vals, state, ids, grads = _adagrad_inputs(n=200, d=16, k=700, pad=True, unique=False)
    j = jet.sparse_adagrad_update_dense_accum(
        jet.EmbeddingTable(jnp.asarray(vals, jnp.bfloat16), jnp.asarray(state, jnp.bfloat16)),
        jnp.asarray(ids), jnp.asarray(grads, jnp.bfloat16), 0.1)
    t = tet.EmbeddingTable(torch.from_numpy(vals).to(BF), torch.from_numpy(state).to(BF))
    tet.sparse_adagrad_update_dense_accum(t, torch.from_numpy(ids).long(),
                                          torch.from_numpy(grads).to(BF), 0.1)
    assert t.values.dtype == t.state.dtype == BF
    # the per-row gradient sums differ in order only: 2 bf16 ulps of the
    # largest state; Adagrad's first step turns that into at most lr
    ulp = float(np.abs(_f32(j.state)).max()) * 2 ** -7
    np.testing.assert_allclose(_f32(t.state), _f32(j.state), rtol=0, atol=2 * ulp)
    _close(t.values, j.values, rtol=0, atol=0.2 + 2 ** -7)
    untouched = np.setdiff1d(np.arange(200), ids)
    np.testing.assert_array_equal(_bits(t.values[untouched]), _bits(j.values[untouched]))


def test_sampled_nbr_sum_of_bf16_features_is_bf16():
    """ROADMAP C9: JAX's default sampled path (gather + masked_sum) returns
    x's dtype; the port's kernel path accumulates in f32 and rounds once."""
    rng = np.random.default_rng(5)
    n_x, n, fi, fo, d = 90, 40, 4, 3, 24
    x = rng.standard_normal((n_x, d)).astype(np.float32)
    ii, io = rng.integers(0, n_x, (n, fi)), rng.integers(0, n_x, (n, fo))
    mi, mo = rng.random((n, fi)) < 0.7, rng.random((n, fo)) < 0.7
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = (j_masked_sum(xb[jnp.asarray(ii)], jnp.asarray(mi))
           + j_masked_sum(xb[jnp.asarray(io)], jnp.asarray(mo)))
    xt = torch.from_numpy(x).to(BF).requires_grad_(True)
    out = tseg.sampled_nbr_sum(xt, torch.from_numpy(ii), torch.from_numpy(mi),
                               torch.from_numpy(io), torch.from_numpy(mo))
    assert out.dtype == BF and ref.dtype == jnp.bfloat16
    # one bf16 rounding of each partial sum, in either order: 2^-7 of the
    # sum of the slots' magnitudes bounds the difference
    ax = jnp.abs(xb)
    mag = _f32(j_masked_sum(ax[jnp.asarray(ii)], jnp.asarray(mi))
               + j_masked_sum(ax[jnp.asarray(io)], jnp.asarray(mo)))
    assert (np.abs(_f32(out) - _f32(ref)) <= mag * 2 ** -7).all()
    out.float().sum().backward()
    assert xt.grad.dtype == BF


# -- the dense optimizers on bf16 leaves ----------------------------------------------

OPTS = {"adam": ("ADAM", {}), "adam-amsgrad": ("ADAM", {"amsgrad": True}),
        "adagrad-decay": ("ADAGRAD", {"lr_decay": 0.01}),
        "sgd-momentum-wd": ("SGD", {"momentum": 0.9, "weight_decay": 0.01}), "sgd": ("SGD", {})}


@pytest.mark.parametrize("name", list(OPTS))
def test_bf16_optimizer_steps_match_jax_bit_for_bit(name):
    ot, kw = OPTS[name]
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64, 16)).astype(np.float32)
    gs = [rng.standard_normal((64, 16)).astype(np.float32) * 0.1 for _ in range(3)]
    jc, tc = jopt.OptimizerConfig(ot, learning_rate=0.1, **kw), TOpt(ot, learning_rate=0.1, **kw)
    jp = {"w": jnp.asarray(p0, jnp.bfloat16)}
    js = jopt.init_optimizer(jc, jp)
    tp = {"w": torch.from_numpy(p0).to(BF)}
    ts = topt.init_optimizer(tc, tp)
    # the docstring's reading: every step in float32 from the bf16 values,
    # the parameter rounded to bf16 after each step
    fp = {"w": torch.from_numpy(p0).to(BF).float()}
    fs = topt.init_optimizer(tc, fp)
    for g in gs:
        jp, js = jopt.apply_optimizer(jc, jp, js, {"w": jnp.asarray(g, jnp.bfloat16)})
        tp, ts = topt.apply_optimizer(tc, tp, ts, {"w": torch.from_numpy(g).to(BF)})
        fp, fs = topt.apply_optimizer(tc, fp, fs, {"w": torch.from_numpy(g).to(BF).float()})
        fp = {"w": fp["w"].to(BF).float()}
    assert tp["w"].dtype == BF and all(s.dtype == BF for s in topt.tree_leaves(ts.slots))
    np.testing.assert_array_equal(_bits(tp["w"]), _bits(jp["w"]))
    for (tk, tv), (jk, jv) in zip(sorted(ts.slots.items()), sorted(js.slots.items())):
        np.testing.assert_array_equal(_bits(tv["w"]), _bits(jv["w"]))
    assert (_bits(fp["w"]) != _bits(jp["w"])).any()


# -- the trainers ------------------------------------------------------------------------

def _lp_models(decoder="DISTMULT", d=16, r=4, opt="ADAM", lr=0.1):
    return [M("LINK_PREDICTION", Enc(((L("EMBEDDING", output_dim=d),),)), Dec(decoder, r, d),
              dense_optimizer=O(opt, learning_rate=lr))
            for M, Enc, L, Dec, O in ((JModel, JEncoderConfig, JLayerConfig, JEdgeDecoder, JOpt),
                                      (TModel, TEncoderConfig, TLayerConfig, TEdgeDecoder, TOpt))]


@pytest.mark.parametrize("dense_accum", [True, False], ids=["dense", "unique"])
def test_bf16_lp_trainer_matches_jax(monkeypatch, dense_accum):
    n, r, b = 64, 4, 32
    edges = _edges(True)
    monkeypatch.setattr(jtrainer_mod, "sample_negatives", fake_negatives_jax)
    jm, tm = _lp_models(r=r)
    jtr = jtrainer_mod.LinkPredictionTrainer(jm, n, r, edges, JNeg(4, 8, 0.25), batch_size=b,
                                             seed=0, dtype=jnp.bfloat16)
    ttr = TTrainer(tm, n, r, edges, TNeg(4, 8, 0.25), batch_size=b, seed=0, device="cpu",
                   dtype=BF)
    cfg = ttr.neg_config
    ttr._sample_negatives = lambda e, inverse: fake_negatives_torch(cfg, e, n, inverse)
    size = jtr.num_batches * b
    ttr._epoch_permutation = lambda e: torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(jax.random.key(12345), e), size))).long()
    jtr.dense_accum = ttr.dense_accum = dense_accum
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    ts = ttr.state
    assert ts.table.values.dtype == ts.params["decoder"]["relations"].dtype == BF
    assert all(s.dtype == BF for s in topt.tree_leaves(ts.opt_state.slots))
    for _ in range(2):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=LOSS_RTOL)
        js = _np_state(jtr.state)
        _close(ts.table.values, js.table.values)
        _close(ts.table.state, js.table.state)
        _close_tree(ts.params["decoder"], js.params["decoder"])
        _close_tree(ts.opt_state.slots, js.opt_state.slots)


def test_bf16_buffer_trainer_matches_jax():
    """The buffer's host table, slots and swaps in bf16 (uint16 host arrays):
    one epoch of BETA states against JAX's, whose dense parameters stay f32."""
    n, r, d = 200, 6, 8
    rng = np.random.default_rng(9)
    edges = np.stack([rng.integers(0, n, 800), rng.integers(0, r, 800),
                      rng.integers(0, n, 800)], 1).astype(np.int32)
    jm, tm = _lp_models("COMPLEX", d, r, "ADAGRAD")
    kw = dict(batch_size=100, num_partitions=4, buffer_capacity=2, seed=0, ordering="BETA")
    jtr = JBufferTrainer(jm, n, r, edges, JNeg(2, 16, 0.5), dtype=ml_dtypes.bfloat16, **kw)
    ttr = TBufferTrainer(tm, n, r, edges, TNeg(2, 16, 0.5), device="cpu", dtype=BF, **kw)
    assert ttr.buffer.host_values.dtype == np.uint16 and jtr.buffer.host_values.dtype.itemsize == 2
    jtr.buffer.host_values[:n] = rng.uniform(-0.1, 0.1, (n, d)).astype(ml_dtypes.bfloat16)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    copy_buffer_trainer_from_jax_(ttr, np.asarray(jtr.buffer.host_values),
                                  np.asarray(jtr.buffer.host_state), np_tree(jtr.params),
                                  np_tree(jtr.opt_state), jtr.epoch)
    np.testing.assert_array_equal(ttr.buffer.host_values, jtr.buffer.host_values.view(np.uint16))
    draws = JaxDraws(jtr)
    ttr._in_buffer_draws = lambda step, inverse: draws(ttr.epoch, step, inverse)
    transfer.bytes_h2d = 0
    jres, tres = jtr.train_epoch(), ttr.train_epoch()
    assert tres["states_run"] == jres["states_run"] >= 2
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=LOSS_RTOL)
    jtr.buffer.flush()
    st = ttr.state
    assert st.table.values.dtype == BF
    _close(st.table.values, jtr.buffer.host_values[:n])
    _close(st.table.state, jtr.buffer.host_state[:n])
    _close_tree(ttr.params, np_tree(jtr.params))
    assert all(p.dtype == torch.float32 for p in topt.tree_leaves(ttr.params))


def test_bf16_host_table_init_and_swap_bytes():
    """A bf16 buffer is drawn in f32 and rounded (JAX :110-139), chunked
    above HOST_INIT_ELEMENTS, and its swaps move half a float32 buffer's bytes."""
    f32 = PartitionBuffer.create(3, 1000, 8, 4, 2)
    bf = PartitionBuffer.create(3, 1000, 8, 4, 2, dtype=BF)
    np.testing.assert_array_equal(bf.host_values,
                                  transfer.as_array(torch.from_numpy(f32.host_values).to(BF)))
    big = PartitionBuffer.create(3, 600_000, 8, 4, 2, dtype=BF)
    big32 = PartitionBuffer.create(3, 600_000, 8, 4, 2)
    np.testing.assert_array_equal(big.host_values,
                                  transfer.as_array(torch.from_numpy(big32.host_values).to(BF)))
    before = transfer.as_tensor(bf.host_values, BF).clone()
    moved = []
    for buf in (f32, bf):
        transfer.bytes_h2d = transfer.bytes_d2h = 0
        buf.load([0, 1])
        buf.device_values += 1
        buf.swap_to_state([0, 2])
        buf.flush()
        moved.append((transfer.bytes_h2d, transfer.bytes_d2h))
    assert moved[1][0] * 2 == moved[0][0] and moved[1][1] * 2 == moved[0][1]
    # partitions 0 and 1 (rows 0-499) took +1 in bf16; partition 2 came in after
    after = transfer.as_tensor(bf.host_values, BF)
    assert torch.equal(after[:500], before[:500] + 1) and torch.equal(after[500:], before[500:])


def _fg_trainers(fg_kwargs):
    edges, feats, labels, train = fg_data()
    jm = fg_model(JModel, JEncoderConfig, JLayerConfig, JOpt)
    tm = fg_model(TModel, TEncoderConfig, TLayerConfig, TOpt)
    jtr = jnc.NodeClassificationTrainer(
        jm, j_graph(edges, 220), feats, labels, train, [JNbr("ALL", max_neighbors=1)] * 3,
        batch_size=32, seed=0, full_graph=jfg.build_full_graph_adjacency(edges, 220),
        dtype=jnp.bfloat16, **fg_kwargs)
    ttr = tnc.NodeClassificationTrainer(
        tm, t_graph(edges, 220), feats, labels, train, batch_size=32, seed=0,
        full_graph=tfg.build_full_graph_adjacency(edges, 220), device="cpu", dtype=BF,
        **fg_kwargs)
    size = jtr.num_batches * 32
    ttr._epoch_permutation = lambda e: torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(jax.random.key(54321), e), size))).long()
    return jtr, ttr


def _sampled_trainers():
    edges, feats, labels, train = sampled_data()
    n = SAMPLED_N
    jm = sampled_model(JModel, JEncoderConfig, JLayerConfig, JOpt, "arxiv")
    tm = sampled_model(TModel, TEncoderConfig, TLayerConfig, TOpt, "arxiv")
    jtr = jnc.NodeClassificationTrainer(jm, j_graph(edges, n), feats, labels, train,
                                        [JNbr("UNIFORM", 6)] * 2, batch_size=32, seed=0,
                                        dtype=jnp.bfloat16)
    ttr = tnc.NodeClassificationTrainer(tm, t_graph(edges, n), feats, labels, train,
                                        [TNbr("UNIFORM", 6)] * 2, batch_size=32, seed=0,
                                        device="cpu", dtype=BF)
    size = jtr.num_batches * 32
    ttr._epoch_permutation = lambda p: torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(jax.random.key(54321), p), size))).long()
    ttr._batch_draws = NCKeyReplay(jax.random.wrap_key_data(
        np.array(jax.random.key_data(jtr.state.key))))
    return jtr, ttr


@pytest.mark.parametrize("path", ["sampled", "collapse", "general-all-n"])
def test_bf16_nc_trainer_matches_jax(path):
    """bf16 features (zero sentinel row), parameters and sums: the sampled
    path (layer-0 sums through the gather-sum's bf16 entry, rounded to bf16),
    the full-graph general path and the linear collapse, 2 epochs."""
    if path == "sampled":
        jtr, ttr = _sampled_trainers()
    else:
        jtr, ttr = _fg_trainers({"collapse": {}, "general-all-n": {"fg_seed_restrict": False,
                                                                    "fg_linear_collapse": False}}
                                [path])
        assert (ttr._fg_collapse is not None) == (jtr._fg_collapse is not None) == \
            (path == "collapse")
    assert ttr.features.dtype == BF and jtr.features.dtype == jnp.bfloat16
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    assert all(p.dtype == BF for p in topt.tree_leaves(ttr.state.params))
    for _ in range(2):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=LOSS_RTOL)
        js = _np_state(jtr.state)
        _close_tree(ttr.state.params, js.params)


# -- checkpoints and the JAX state ----------------------------------------------------

def test_bf16_state_checkpoints_and_jax_state(tmp_path, monkeypatch):
    """A JAX bf16 TrainState (ml_dtypes leaves) comes across through uint16
    bits; a bf16 checkpoint written by JAX loads into the port; the port's
    own bf16 checkpoint round-trips bit for bit and records its leaves as
    JAX does ('<V2')."""
    monkeypatch.setattr(jtrainer_mod, "sample_negatives", fake_negatives_jax)
    jm, tm = _lp_models(opt="ADAGRAD")
    edges = _edges(True)
    jtr = jtrainer_mod.LinkPredictionTrainer(jm, 64, 4, edges, JNeg(4, 8), batch_size=32,
                                             dtype=jnp.bfloat16)
    jtr.train_epoch()
    js = _np_state(jtr.state)
    assert js.table.values.dtype == ml_dtypes.bfloat16
    ts = train_state_from_jax(js)
    np.testing.assert_array_equal(_bits(ts.table.values), _bits(js.table.values))
    jckpt.save_state(str(tmp_path / "jax"), jtr.state)
    ttr = TTrainer(tm, 64, 4, edges, TNeg(4, 8), batch_size=32, device="cpu", dtype=BF)
    loaded, _ = tckpt.load_state(str(tmp_path / "jax"), ttr.state)
    pairs = [(loaded.table.values, ts.table.values), (loaded.table.state, ts.table.state)]
    pairs += [(loaded.params["decoder"][k], ts.params["decoder"][k])
              for k in ("relations", "inverse_relations")]
    pairs += [(loaded.opt_state.slots["sum"]["decoder"][k], ts.opt_state.slots["sum"]["decoder"][k])
              for k in ("relations", "inverse_relations")]
    for a, b in pairs:
        assert a.dtype == BF and torch.equal(a.view(torch.int16), b.view(torch.int16))
    tckpt.save_state(str(tmp_path / "port"), loaded)
    assert np.load(tmp_path / "port" / "table__values.npy").dtype == \
        np.load(tmp_path / "jax" / "table__values.npy").dtype == np.dtype("V2")
    again, _ = tckpt.load_state(str(tmp_path / "port"), ttr.state)
    assert torch.equal(again.table.values.view(torch.int16), ts.table.values.view(torch.int16))


# -- the manager: tests/test_config_matrix.py's bf16 rows (:89-90) and bf16 NC -------

BF16 = {"storage.embeddings": {"type": "DEVICE_MEMORY", "options": {"dtype": "bfloat16"}}}
GS = {"layers": [[{"type": "EMBEDDING", "output_dim": 16}],
                 [{"type": "GNN", "input_dim": 16, "output_dim": 16,
                   "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}]],
      "train_neighbor_sampling": [{"type": "UNIFORM", "options": {"max_neighbors": 4}}]}
BF16_LP = {
    "distmult-sync-filtered": {},
    "gs_1_layer-async-unfiltered": {
        "model.encoder": GS, "training.pipeline": {"sync": False, "staleness_bound": 4},
        "evaluation.negative_sampling": {"filtered": False, "num_chunks": 2,
                                         "negatives_per_positive": 8}},
    "buffer": {"storage.embeddings": {"type": "PARTITION_BUFFER", "options": {
        "num_partitions": 4, "buffer_capacity": 2, "dtype": "bfloat16"}}},
}


@pytest.mark.parametrize("variant", list(BF16_LP))
def test_bf16_lp_configs_train_and_reload(tmp_path, variant):
    over = {**copy.deepcopy(BF16), **copy.deepcopy(BF16_LP[variant])}
    raw = _lp_config(tmp_path, variant, **over)
    raw["storage"]["save_model"] = True
    raw["storage"]["model_dir"] = str(tmp_path / f"model_{variant}")
    res = marius_train(load_config(raw), device="cpu")
    tr = res["runtime"].trainer
    st = tr.state
    assert st.table.values.dtype == BF
    dense = [p.dtype for p in topt.tree_leaves(st.params)]
    # the buffer trainer keeps f32 dense parameters, as JAX's does
    assert set(dense) == ({torch.float32} if variant == "buffer" else {BF})
    assert all(np.isfinite(e["loss"]) for e in res["epochs"])
    assert 0.0 < res["test"]["mrr"] <= 1.0
    again = marius_eval(load_config(raw), device="cpu")
    assert again["test"]["mrr"] == pytest.approx(res["test"]["mrr"], abs=1e-12)


def test_bf16_nc_manager_and_the_buffer_nc_trainer(tmp_path):
    """ogbn_arxiv.yaml's model in bf16 trains and reloads; a PARTITION_BUFFER
    NC config ignores the dtype, as JAX's manager does (it passes none to
    PartitionBufferNCTrainer): both packages' features stay f32."""
    from marius_tpu.config.schema import load_config as j_load_config
    from marius_tpu.manager import marius_init as j_marius_init

    raw = _nc_raw(tmp_path, "bf16", **{**copy.deepcopy(BF16), "storage.save_model": True,
                                       "storage.model_dir": str(tmp_path / "nc_model")})
    raw["training"]["num_epochs"] = 2
    res = marius_train(load_config(raw), device="cpu")
    tr = res["runtime"].trainer
    assert tr.features.dtype == BF
    assert all(np.isfinite(e["loss"]) for e in res["epochs"])
    again = marius_eval(load_config(raw), device="cpu")
    assert again["test"]["accuracy"] == res["test"]["accuracy"]
    braw = _nc_raw(tmp_path, "bf16_buffer", **copy.deepcopy(BF16))
    braw["storage"]["features"] = {"type": "PARTITION_BUFFER"}
    braw["storage"]["embeddings"]["options"].update(num_partitions=4, buffer_capacity=2)
    t = marius_init(load_config(copy.deepcopy(braw)), device="cpu").trainer
    j = j_marius_init(j_load_config(copy.deepcopy(braw))).trainer
    assert type(t).__name__ == type(j).__name__ == "PartitionBufferNCTrainer"
    assert t.cache.host.dtype == np.float32 and np.asarray(j.cache.host).dtype == np.float32
    assert all(p.dtype == torch.float32 for p in topt.tree_leaves(t.params))
    assert all(np.asarray(p).dtype == np.float32 for p in jax.tree.leaves(j.params))
    assert os.path.exists(raw["storage"]["model_dir"])
