"""The port's PartitionBuffer, transfer module and buffer Adagrad against
marius_tpu's, on the CPU.

Both buffers start from one host table and Adagrad state, then take the same
swap sequence (load, swaps, a shrink and a regrow, an eviction re-admitted
before its writeback landed) with the same device-side row edits and dirty
marks between swaps. After every swap the resident set, the slot table and
the kind of each deferred writeback must be equal, and after every flush the
host arrays, exactly (rows are copied, never computed). Both writeback
modes run: whole slots, and dirty rows only (with a slot more than 95% dirty,
which goes whole). The ``cuda`` tests run the copy-stream paths on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marius_tpu.data.ordering import beta_ordering
from marius_tpu.storage import partition_buffer as jpb
from marius_tpu_torch.storage import partition_buffer as tpb
from marius_tpu_torch.storage import transfer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# (new resident set, edits: (partition, rows within it as a fraction of psize))
SEQUENCE = [
    ([0, 1, 2, 3], [(0, 0.3), (2, 1.0)]),
    ([1, 2, 3, 4], [(4, 0.5), (1, 0.05)]),
    ([1, 2], [(2, 0.2)]),                      # shrink: evict 3 and 4, admit nothing
    ([1, 2, 3, 4], [(3, 0.4)]),                # regrow: 3 and 4 come back
    ([1, 2, 5, 0], [(0, 0.96), (5, 0.1)]),
    ([1, 2, 3, 0], [(3, 0.2)]),                # 5 out, 3 in
    ([1, 2, 5, 0], []),                        # 5 back before any other drain
    ([6, 7, 5, 0], [(6, 0.7), (7, 1.0)]),
]


def _buffers(sparse, n=83, d=5, parts=8, cap=4):
    jb = jpb.PartitionBuffer.create(jax.random.key(0), n, d, parts, cap)
    tb = tpb.PartitionBuffer.create(1, n, d, parts, cap)
    rng = np.random.default_rng(1)
    table = rng.standard_normal(tb.host_values.shape).astype(np.float32)
    state = rng.random(tb.host_values.shape).astype(np.float32)
    state[tb.part_rows(6)] = 0.0   # a never-trained partition: admitted as zeros
    for b in (jb, tb):
        b.host_values[...] = table
        b.host_state[...] = state
        if sparse:
            b.enable_dirty_tracking()
    return jb, tb


def _edit(jb, tb, p, share, rng):
    """The same in-place edit of partition p's rows in both device buffers,
    the edited rows marked dirty."""
    slot = int(tb.part_to_slot[p])
    assert slot == int(jb.part_to_slot[p])
    k = max(1, int(share * tb.psize))
    rows = slot * tb.psize + np.sort(rng.choice(tb.psize, k, replace=False))
    dv = rng.standard_normal((k, tb.dim)).astype(np.float32)
    ds = rng.random((k, tb.dim)).astype(np.float32)
    jb.device_values = jb.device_values.at[rows].add(dv)
    jb.device_state = jb.device_state.at[rows].add(ds)
    tb.device_values[rows] += torch.from_numpy(dv)
    tb.device_state[rows] += torch.from_numpy(ds)
    if jb.dirty is not None:
        padded = np.concatenate([rows, [tb.buffer_rows]])   # the padding id is dropped
        jb.dirty = jpb.mark_dirty(jb.dirty, jnp.asarray(padded))
        tpb.mark_dirty(tb.dirty, torch.from_numpy(padded))


def _same(jb, tb):
    np.testing.assert_array_equal(tb.resident, jb.resident)
    np.testing.assert_array_equal(tb.part_to_slot, jb.part_to_slot)
    assert [e[0] for e in tb.pending_writebacks] == [e[0] for e in jb.pending_writebacks]
    np.testing.assert_array_equal(tb.device_values.numpy(), np.asarray(jb.device_values))
    np.testing.assert_array_equal(tb.device_state.numpy(), np.asarray(jb.device_state))
    if jb.dirty is not None:
        np.testing.assert_array_equal(tb.dirty[:-1].numpy(), np.asarray(jb.dirty))


def _hosts_equal(jb, tb):
    np.testing.assert_array_equal(tb.host_values, jb.host_values)
    np.testing.assert_array_equal(tb.host_state, jb.host_state)


@pytest.mark.parametrize("sparse", [True, False], ids=["dirty-rows", "whole-slots"])
def test_swap_sequence_matches_jax(sparse):
    jb, tb = _buffers(sparse)
    rng = np.random.default_rng(2)
    before = tb.host_values.copy()
    for i, (parts, edits) in enumerate(SEQUENCE):
        if i == 0:
            jb.load(parts)
            tb.load(parts)
        else:
            jb.swap_to_state(parts)
            tb.swap_to_state(parts)
        _same(jb, tb)
        for p, share in edits:
            _edit(jb, tb, p, share, rng)
        if i == 3:   # a flush in the middle: every resident slot lands
            jb.flush()
            tb.flush()
            _hosts_equal(jb, tb)
            _same(jb, tb)
    jb.flush()
    tb.flush()
    _hosts_equal(jb, tb)
    assert not (tb.host_values == before).all()
    assert not tb.pending_writebacks
    if sparse:
        assert tb.sparse_evictions > 0


def test_state_machine_accessors_match_jax():
    jb, tb = _buffers(True, n=37, d=4, parts=8, cap=3)
    assert tb.psize == jb.psize == 5 and tb.part_valid_count(7) == jb.part_valid_count(7) == 2
    for b in (jb, tb):
        b.load([7, 1, 2])
    np.testing.assert_array_equal(tb.slot_valid_counts(), jb.slot_valid_counts())
    ids = np.array([5, 10, 36])
    np.testing.assert_array_equal(tb.global_to_local(ids), jb.global_to_local(ids))
    with pytest.raises(ValueError, match="not resident"):
        tb.global_to_local(np.array([0]))
    tb.swap_to_state([1, 2])
    assert tb.slot_valid_counts().tolist() == [0, 5, 5]
    with pytest.raises(ValueError, match="capacity"):
        tb.load([0, 1, 2, 3])
    tb.release()
    assert tb.device_values is None and tb.resident is None
    tb.flush()   # nothing resident: a no-op


def test_round_trip_preserves_the_table():
    _, tb = _buffers(False, n=32, d=4, parts=8, cap=4)
    before = tb.host_values.copy()
    states = beta_ordering(8, 4, seed=0)
    tb.load(states[0])
    for st in states[1:]:
        tb.swap_to_state(st)
    tb.flush()
    np.testing.assert_array_equal(tb.host_values, before)


def test_host_init_chunked_and_small():
    small = tpb.init_host_table(3, 30, 32, 4)
    assert small.shape == (32, 4) and not small[30:].any() and small[:30].any()
    bound = np.sqrt(6.0 / (30 + 4))
    assert np.abs(small).max() <= bound
    big = tpb.init_host_table(3, 1_000_000, 1_000_008, 5)   # above 4M elements
    assert not big[1_000_000:].any()
    bound = np.sqrt(6.0 / (1_000_000 + 5))
    assert np.abs(big).max() <= bound * (1 + 1e-6) and big.std() > bound / 2
    np.testing.assert_array_equal(big, tpb.init_host_table(3, 1_000_000, 1_000_008, 5))


@pytest.mark.parametrize("k,d", [(777, 128), (50, 100)])
def test_sparse_adagrad_update_buffer_matches_jax(k, d):
    rng = np.random.default_rng(k)
    n = 1000
    values = rng.standard_normal((n, d)).astype(np.float32)
    state = rng.random((n, d)).astype(np.float32)
    ids = rng.permutation(n)[:k].astype(np.int64)
    ids[::7] = n                                    # the padding id, buffer_rows
    grads = rng.standard_normal((k, d)).astype(np.float32)
    jv, js = jpb.sparse_adagrad_update_buffer(jnp.asarray(values), jnp.asarray(state),
                                              jnp.asarray(ids.astype(np.int32)),
                                              jnp.asarray(grads), 0.1)
    tv, ts = torch.from_numpy(values.copy()), torch.from_numpy(state.copy())
    tpb.sparse_adagrad_update_buffer(tv, ts, torch.from_numpy(ids), torch.from_numpy(grads),
                                     0.1)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)
    untouched = np.setdiff1d(np.arange(n), ids)
    np.testing.assert_array_equal(tv.numpy()[untouched], values[untouched])


def test_mark_dirty_drops_out_of_range_ids():
    j = jpb.mark_dirty(jnp.zeros(10, bool), jnp.asarray([0, 3, 10, 12, 3]))
    t = torch.zeros(11, dtype=torch.bool)
    tpb.mark_dirty(t, torch.tensor([0, 3, 10, 12, 3]))
    np.testing.assert_array_equal(t[:10].numpy(), np.asarray(j))


def test_transfer_round_trip_on_cpu():
    rng = np.random.default_rng(0)
    host = rng.standard_normal((1000, 7)).astype(np.float32)
    buf = transfer.alloc_rows(1500, 7, np.float32, "cpu")
    assert transfer.write_rows(buf, host, 300) is None
    np.testing.assert_array_equal(transfer.read_rows(buf, 300, 1000), host)
    assert not buf[:300].any() and not buf[1300:].any()
    h = transfer.read_rows_async(buf, 350, 500)
    buf.zero_()   # the read took a snapshot
    np.testing.assert_array_equal(transfer.drain_read(h), host[50:550])
    transfer.write_rows(buf, host[:10], 0)
    transfer.zero_rows(buf, 2, 5)
    assert not buf[2:7].any() and buf[7:10].all()


# -- the read-only feature cache ------------------------------------------------

def _caches(device="cpu", n=83, f=6, parts=8, cap=4):
    feats = np.random.default_rng(3).standard_normal((n, f)).astype(np.float32)
    return (jpb.ReadOnlyPartitionCache.create(feats, n, parts, cap),
            tpb.ReadOnlyPartitionCache.create(feats, n, parts, cap, device=device))


def _cache_same(jc, tc):
    np.testing.assert_array_equal(tc.resident, jc.resident)
    np.testing.assert_array_equal(tc.part_to_slot, jc.part_to_slot)
    rows = tc.device_rows.cpu().numpy()
    np.testing.assert_array_equal(rows[:tc.buffer_rows], np.asarray(jc.device))
    assert rows.shape[0] == tc.buffer_rows + 1 and not rows[-1].any()   # the zero row


def test_read_only_cache_matches_jax():
    """create (zero-padded partitions), load, swap_to_state over the swap
    sequence, and mirror_layout to a buffer's slots (its empty slots keep
    whatever they held): device rows and slot tables equal JAX's exactly."""
    jc, tc = _caches()
    assert (tc.psize, tc.buffer_rows) == (jc.psize, jc.buffer_rows)
    # the port keeps the caller's rows unpadded; its partitions are JAX's
    # padded ones less the zero rows, which the device slot gets instead
    assert tc.host.shape == (83, jc.host.shape[1])
    for p in range(tc.num_partitions):
        rows = tc.partition_rows(p)
        np.testing.assert_array_equal(rows, jc.host[p * tc.psize:p * tc.psize + len(rows)])
        assert not jc.host[p * tc.psize + len(rows):(p + 1) * tc.psize].any()
    for i, (parts, _) in enumerate(SEQUENCE):
        for c in (jc, tc):
            c.load(parts) if i == 0 else c.swap_to_state(parts)
        _cache_same(jc, tc)
    # a fresh cache mirrors a buffer's layout through its state sequence
    jb, tb = _buffers(False)
    jc, tc = _caches()
    for i, (parts, _) in enumerate(SEQUENCE):
        for b in (jb, tb):
            b.load(parts) if i == 0 else b.swap_to_state(parts)
        np.testing.assert_array_equal(tb.resident, jb.resident)
        jc.mirror_layout(jb.resident)
        tc.mirror_layout(tb.resident)
        _cache_same(jc, tc)
        for slot, p in enumerate(tc.resident):
            if p >= 0:
                np.testing.assert_array_equal(
                    tc.device_rows[slot * tc.psize:(slot + 1) * tc.psize].numpy(),
                    jc.host[p * tc.psize:(p + 1) * tc.psize])


def test_read_only_cache_reads_a_mapped_file(tmp_path):
    """Over a read-only memmap of a features file the cache makes no host
    copy (its host array is the map), and every admitted slot holds the
    file's rows followed by zero padding rows; the last partition (5 of its
    11 rows past the file) is admitted into a slot that held another
    partition's rows, which the padding overwrites with zeros."""
    n, f, parts, cap = 83, 6, 8, 4
    feats = np.random.default_rng(4).standard_normal((n, f)).astype(np.float32)
    path = tmp_path / "features.bin"
    feats.tofile(path)
    mapped = np.memmap(path, np.float32, mode="r", shape=(n, f))
    tc = tpb.ReadOnlyPartitionCache.create(mapped, n, parts, cap)
    assert tc.host is mapped and tc.psize == 11
    tc.load([0, 1, 2, 3])
    tc.swap_to_state([0, 1, 2, 7])
    slot = int(tc.part_to_slot[7])
    block = tc.device_rows[slot * 11:(slot + 1) * 11].numpy()
    np.testing.assert_array_equal(block[:6], feats[77:])
    assert not block[6:].any() and not tc.device_rows[-1].any()
    for p in (0, 1, 2):
        s = int(tc.part_to_slot[p])
        np.testing.assert_array_equal(tc.device_rows[s * 11:(s + 1) * 11].numpy(),
                                      feats[p * 11:(p + 1) * 11])


def test_swap_layout_is_the_buffers():
    """The planned slot table of each state equals the one the swap makes."""
    _, tb = _buffers(False)
    layout = tpb.initial_layout(SEQUENCE[0][0], tb.capacity)
    for i, (parts, _) in enumerate(SEQUENCE):
        tb.load(parts) if i == 0 else tb.swap_to_state(parts)
        if i:
            layout = tpb.swap_layout(layout, parts)
        np.testing.assert_array_equal(tb.resident, layout)
    with pytest.raises(ValueError, match="capacity"):
        tpb.swap_layout(layout, [0, 1, 2, 3, 4])


# -- the copy stream on the card ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this comparison on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_transfer_chunks_and_ordering(cuda_device, monkeypatch):
    monkeypatch.setattr(transfer, "CHUNK_BYTES", 4096)   # many chunks through the ring
    monkeypatch.setattr(transfer, "_staging", {})
    rng = np.random.default_rng(0)
    host = rng.standard_normal((1000, 7)).astype(np.float32)
    buf = transfer.alloc_rows(1500, 7, np.float32, cuda_device)
    transfer.write_rows(buf, host, 300)
    buf[300:1300] *= 2   # on the compute stream, after the copy
    np.testing.assert_array_equal(transfer.read_rows(buf, 300, 1000), 2 * host)
    h = transfer.read_rows_async(buf, 300, 1000)
    buf.zero_()
    np.testing.assert_array_equal(transfer.drain_read(h), 2 * host)
    transfer.write_rows(buf, host, 0)
    transfer.zero_rows(buf, 10, 20)
    out = transfer.read_rows(buf, 0, 1000)
    assert not out[10:30].any()
    np.testing.assert_array_equal(out[30:], host[30:])


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [True, False], ids=["dirty-rows", "whole-slots"])
def test_cuda_swap_sequence_matches_cpu(cuda_device, sparse):
    _, cpu = _buffers(sparse)
    _, gpu = _buffers(sparse)
    gpu.device = cuda_device
    if sparse:
        gpu.enable_dirty_tracking()
    rng_c, rng_g = np.random.default_rng(2), np.random.default_rng(2)
    for i, (parts, edits) in enumerate(SEQUENCE):
        for b in (cpu, gpu):
            b.load(parts) if i == 0 else b.swap_to_state(parts)
        for b, rng in ((cpu, rng_c), (gpu, rng_g)):
            for p, share in edits:
                slot = int(b.part_to_slot[p])
                k = max(1, int(share * b.psize))
                rows = slot * b.psize + np.sort(rng.choice(b.psize, k, replace=False))
                dv = torch.from_numpy(rng.standard_normal((k, b.dim)).astype(np.float32))
                idx = torch.from_numpy(rows).to(b.device)
                b.device_values[idx] += dv.to(b.device)
                if b.dirty is not None:
                    tpb.mark_dirty(b.dirty, idx)
    for b in (cpu, gpu):
        b.flush()
    np.testing.assert_array_equal(gpu.host_values, cpu.host_values)
    np.testing.assert_array_equal(gpu.host_state, cpu.host_state)


@pytest.mark.cuda
def test_cuda_read_only_cache_matches_cpu(cuda_device):
    _, cpu = _caches()
    _, gpu = _caches(cuda_device)
    for i, (parts, _) in enumerate(SEQUENCE):
        for c in (cpu, gpu):
            c.load(parts) if i == 0 else c.swap_to_state(parts)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(gpu.resident, cpu.resident)
        np.testing.assert_array_equal(gpu.device_rows.cpu().numpy(), cpu.device_rows.numpy())
