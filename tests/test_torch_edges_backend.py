"""HOST_MEMORY and FLAT_FILE edge streaming: the port's LinkPredictionTrainer
against marius_tpu's over 2 epochs.

The edges stay in host RAM (a numpy array) or in a memory-mapped binary file
and stream to the device in chunks, shuffled by numpy exactly as the JAX
package shuffles them (a full permutation in RAM; chunk order plus a
permutation inside each chunk for a memmap). Chunks are cut to 3 batches so
the epoch has several, the last one short: the JAX chunk function runs its
fully masked batches, the port gives the dense optimizer (Adam, which moves
on zero gradients) their zero-gradient steps. Negatives are the same
deterministic function of the batch on both sides, as in
test_torch_lp_trainer.py, and the tolerance is that file's.
"""

import jax
import numpy as np
import pytest

import marius_tpu.train.trainer as jtrainer_mod
from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNeg
from marius_tpu_torch.convert import copy_train_state_, train_state_from_jax
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig as TNeg
from marius_tpu_torch.train.trainer import LinkPredictionTrainer as TTrainer
from tests.test_torch_lp_trainer import (
    ATOL,
    RTOL,
    _np_state,
    fake_negatives_jax,
    fake_negatives_torch,
)
from tests.test_torch_lp_eval import _models
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, R, D, B, E = 96, 4, 16, 40, 530   # 14 batches: 4 chunks of 3, the last of 2


def _pair(monkeypatch, edges, backend, chunk_batches=3, dense_accum=True):
    monkeypatch.setattr(jtrainer_mod, "sample_negatives", fake_negatives_jax)
    jmodel, tmodel = _models("DISTMULT", D, R)
    jtr = jtrainer_mod.LinkPredictionTrainer(jmodel, N, R, edges, JNeg(4, 8, 0.25),
                                             batch_size=B, edges_backend=backend)
    ttr = TTrainer(tmodel, N, R, edges, TNeg(4, 8, 0.25), batch_size=B,
                   edges_backend=backend, device="cpu")
    for t in (jtr, ttr):
        t.chunk_batches = chunk_batches
        t.dense_accum = dense_accum
    jtr._chunk_fn = jax.jit(jtr._build_chunk_fn(), donate_argnums=(0,))
    tcfg = ttr.neg_config
    monkeypatch.setattr(ttr, "_sample_negatives",
                        lambda edges_b, inverse: fake_negatives_torch(tcfg, edges_b, N, inverse))
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    return jtr, ttr


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _run(jtr, ttr, epochs=2):
    for _ in range(epochs):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        assert tres["num_edges"] == jres["num_edges"] == E
    js, ts = _np_state(jtr.state), ttr.state
    _close(ts.table.values, js.table.values)
    _close(ts.table.state, js.table.state)
    for name in ("relations", "inverse_relations"):
        _close(ts.params["decoder"][name], js.params["decoder"][name])
        for slot in ("exp_avg", "exp_avg_sq"):
            _close(ts.opt_state.slots[slot]["decoder"][name],
                   js.opt_state.slots[slot]["decoder"][name])
    # 5 chunks of 3 batches per epoch, the last 2 real and 1 fully masked
    assert ts.opt_state.step == int(js.opt_state.step) == 2 * 15
    assert ts.epoch == int(js.epoch) == 2


def _edges(seed=4):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, N, E), rng.integers(0, R, E),
                     rng.integers(0, N, E)], 1).astype(np.int32)


@pytest.mark.parametrize("dense_accum", [True, False], ids=["dense", "unique"])
def test_host_memory_edges_match_jax(monkeypatch, dense_accum):
    jtr, ttr = _pair(monkeypatch, _edges(), "HOST_MEMORY", dense_accum=dense_accum)
    assert ttr.edges is None and ttr.edges_host is not None
    _run(jtr, ttr)


def test_flat_file_edges_match_jax(monkeypatch, tmp_path):
    path = tmp_path / "train_edges.bin"
    _edges(5).tofile(path)
    mm = np.memmap(path, np.int32, mode="r", shape=(E, 3))
    jtr, ttr = _pair(monkeypatch, mm, "FLAT_FILE")
    assert isinstance(ttr.edges_host, np.memmap)
    # the memmap path: chunk order, then a permutation inside each chunk
    chunks = [c.copy() for c in ttr._host_chunks()]
    assert sorted(len(c) for c in chunks) == [E - 4 * 3 * B] + [3 * B] * 4
    np.testing.assert_array_equal(np.sort(np.concatenate(chunks), axis=0), np.sort(mm, axis=0))
    _run(jtr, ttr)


@pytest.mark.parametrize("chunked", [False, True], ids=["in-memory-shuffle", "memmap-shuffle"])
def test_flat_file_storage_matches_jax(monkeypatch, tmp_path, chunked):
    """FlatFile and the edge-file helpers against the JAX package's: the same
    appends, ranged write, index_add and seeded shuffle leave equal files,
    read back equally by every reader."""
    from marius_tpu.storage import flat_file as jff
    from marius_tpu_torch.storage import flat_file as tff

    if chunked:   # files above the shuffle chunk take the memmap permutation
        for mod in (jff, tff):
            monkeypatch.setattr(mod, "MAX_SHUFFLE_CHUNK", 60)
    rows = np.random.default_rng(7).standard_normal((40, 6)).astype(np.float32)
    files = []
    for mod, name in ((jff, "jax.bin"), (tff, "port.bin")):
        f = mod.FlatFile(str(tmp_path / name), 6, create=True)
        f.append(rows[:25])
        f.append(rows[25:])
        f.write_range(3, 2 * rows[:2])
        f.index_add(np.array([0, 7, 39]), np.ones((3, 6), np.float32))
        f.shuffle(seed=5)
        files.append(f)
    jf, tf = files
    assert tf.num_rows == jf.num_rows == 40
    np.testing.assert_array_equal(tf.read_all(), jf.read_all())
    assert not np.array_equal(tf.read_all(), rows)
    np.testing.assert_array_equal(tf.read_range(5, 10), jf.read_range(5, 10))
    ids = np.array([1, 38, 4])
    np.testing.assert_array_equal(tf.index_read(ids), jf.index_read(ids))
    with pytest.raises(ValueError, match="width"):
        tf.append(rows[:, :3])
    edges = _edges(6)
    for mod, name in ((jff, "jax_edges.bin"), (tff, "port_edges.bin")):
        mod.write_edges(str(tmp_path / name), np.concatenate([edges, edges]))
        mod.write_edges(str(tmp_path / name), edges)   # truncates the longer old file
    np.testing.assert_array_equal(tff.read_edges(str(tmp_path / "port_edges.bin")), edges)
    np.testing.assert_array_equal(jff.read_edges(str(tmp_path / "jax_edges.bin")), edges)


def test_host_shuffle_follows_epochs_per_shuffle(monkeypatch):
    _, ttr = _pair(monkeypatch, _edges(), "HOST_MEMORY")
    ttr.epochs_per_shuffle = 2
    first = np.concatenate(list(ttr._host_chunks()))
    ttr._host_epoch = 1
    np.testing.assert_array_equal(np.concatenate(list(ttr._host_chunks())), first)
    ttr._host_epoch = 2
    assert not np.array_equal(np.concatenate(list(ttr._host_chunks())), first)
