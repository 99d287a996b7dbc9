"""The port's kernels (marius_tpu_torch/ops/cuda) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the Pallas kernels in interpret mode (as tests/test_pallas_kernels.py
runs them) and against the XLA table ops of marius_tpu/parallel/
embedding_table.py. The hand-written CUDA kernels are held against the plain
versions in the tests marked ``cuda``, which skip without a GPU (chip_smoke.py
runs the same comparison on the card).

Tolerances: a gather copies, so it must match exactly. The Adagrad update is
a handful of float32 operations per element; XLA may fuse them differently,
so it is held to rtol=1e-6, atol=1e-7, and untouched rows must be
bit-identical. The gather-sum's plain version is held against the Pallas
kernel in tests/test_torch_full_graph.py. The CUDA kernels round every
operation on its own and must match the plain versions bit for bit.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marius_tpu.ops.pallas.adagrad import sparse_adagrad_update_pallas
from marius_tpu.ops.pallas.gather import gather_rows_pallas
from marius_tpu.parallel import embedding_table as jet
from marius_tpu_torch.ops.cuda import adagrad as tadagrad
from marius_tpu_torch.ops.cuda import build
from marius_tpu_torch.ops.cuda import gather as tgather
from marius_tpu_torch.ops.cuda import nbr_sum as tns
from marius_tpu_torch.ops import segment as tseg
from marius_tpu_torch.parallel import embedding_table as tet
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this comparison on the card")
    return torch.device("cuda")


def test_plain_gather_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((777, 128)).astype(np.float32)
    ids = rng.integers(0, 777, 2048).astype(np.int32)
    ref = gather_rows_pallas(jnp.asarray(table), jnp.asarray(ids), interpret=True)
    out = tgather.gather_rows(torch.from_numpy(table), torch.from_numpy(ids).long())
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_plain_gather_matches_jax_gather_rows_with_padding():
    rng = np.random.default_rng(1)
    n, d = 300, 50
    table = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(0, n + 1, 1111).astype(np.int32)   # n == padding id
    ids[:5] = n
    ref = jet.gather_rows(jnp.asarray(table), jnp.asarray(ids))
    before = tgather.launches
    out = tet.gather_rows(torch.from_numpy(table), torch.from_numpy(ids).long())
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert tgather.launches == before  # CPU tensors never launch the kernel


def _adagrad_inputs(rng, n, d, k, pad):
    vals = rng.standard_normal((n, d)).astype(np.float32)
    state = np.abs(rng.standard_normal((n, d))).astype(np.float32)
    uids = rng.permutation(n)[:k].astype(np.int32)
    if pad:
        uids[-pad:] = n   # padding id, dropped
    grads = rng.standard_normal((k, d)).astype(np.float32)
    return vals, state, uids, grads


def _plain_adagrad(vals, state, ids, grads, lr=0.1):
    v, s = torch.from_numpy(vals.copy()), torch.from_numpy(state.copy())
    tadagrad.sparse_adagrad_update_(v, s, torch.from_numpy(ids).long(),
                                    torch.from_numpy(grads), lr)
    return v.numpy(), s.numpy()


def test_plain_adagrad_matches_pallas_interpret():
    """The Pallas kernel pads with a scratch row (here row n of an n + 1-row
    table) whose gradients are zero; the port pads with id n and skips it."""
    rng = np.random.default_rng(2)
    n, pad = 600, 20
    vals, state, uids, grads = _adagrad_inputs(rng, n, 128, 256, pad=pad)
    grads[-pad:] = 0.0
    scratch = rng.standard_normal((1, 128)).astype(np.float32)
    nv, ns = sparse_adagrad_update_pallas(
        jnp.asarray(np.concatenate([vals, scratch])),
        jnp.asarray(np.concatenate([state, np.abs(scratch)])),
        jnp.asarray(uids), jnp.asarray(grads), 0.1, interpret=True)
    nv, ns = np.asarray(nv), np.asarray(ns)
    np.testing.assert_array_equal(nv[n], scratch[0])   # the scratch row is unchanged
    v, s = _plain_adagrad(vals, state, uids, grads)
    np.testing.assert_allclose(s, ns[:n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(v, nv[:n], rtol=RTOL, atol=ATOL)
    rest = np.setdiff1d(np.arange(n), uids)
    np.testing.assert_array_equal(v[rest], vals[rest])
    np.testing.assert_array_equal(s[rest], state[rest])


def test_plain_adagrad_matches_jax_sparse_update_with_padding():
    rng = np.random.default_rng(3)
    n, d = 400, 50
    vals, state, uids, grads = _adagrad_inputs(rng, n, d, 150, pad=7)
    ref = jet.sparse_adagrad_update(
        jet.EmbeddingTable(jnp.asarray(vals), jnp.asarray(state)),
        jnp.asarray(uids), jnp.asarray(grads), 0.1)
    table = tet.EmbeddingTable(torch.from_numpy(vals.copy()), torch.from_numpy(state.copy()))
    tet.sparse_adagrad_update(table, torch.from_numpy(uids).long(),
                              torch.from_numpy(grads), 0.1)
    np.testing.assert_allclose(table.state.numpy(), np.asarray(ref.state), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(table.values.numpy(), np.asarray(ref.values),
                               rtol=RTOL, atol=ATOL)
    rest = np.setdiff1d(np.arange(n), uids)
    np.testing.assert_array_equal(table.values.numpy()[rest], vals[rest])
    np.testing.assert_array_equal(table.state.numpy()[rest], state[rest])


def test_plain_dense_accum_matches_jax():
    rng = np.random.default_rng(4)
    n, d = 120, 50
    vals = rng.standard_normal((n, d)).astype(np.float32)
    state = np.abs(rng.standard_normal((n, d))).astype(np.float32)
    ids = rng.integers(0, n // 2, 300).astype(np.int32)   # duplicates, half the rows
    ids[-9:] = n                                          # padding
    grads = rng.standard_normal((300, d)).astype(np.float32)
    ref = jet.sparse_adagrad_update_dense_accum(
        jet.EmbeddingTable(jnp.asarray(vals), jnp.asarray(state)),
        jnp.asarray(ids), jnp.asarray(grads), 0.1)
    table = tet.EmbeddingTable(torch.from_numpy(vals.copy()), torch.from_numpy(state.copy()))
    tet.sparse_adagrad_update_dense_accum(table, torch.from_numpy(ids).long(),
                                          torch.from_numpy(grads), 0.1)
    # duplicate ids sum in another order: 1e-5 relative covers float32 sums of ~10 terms
    np.testing.assert_allclose(table.state.numpy(), np.asarray(ref.state), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(table.values.numpy(), np.asarray(ref.values),
                               rtol=1e-5, atol=1e-6)
    rest = np.setdiff1d(np.arange(n), ids)
    np.testing.assert_array_equal(table.values.numpy()[rest], vals[rest])
    np.testing.assert_array_equal(table.state.numpy()[rest], state[rest])


PLAN_BASE = 0x7F3A_0000_0000   # a device address on a 512-byte boundary
PLAN_SMS, PLAN_RESIDENT = 132, 16   # an H100: 132 SMs, 16 blocks of 128 threads each


@pytest.mark.parametrize("k", [0, 1, 31, 33, 12000, 30000])
@pytest.mark.parametrize("offset", [0, 4, 8])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8, 50, 100, 128, 257])
def test_gather_plan(d, offset, k):
    """The gather's launch plan, made on the host: the widest vector that the
    row and a table at ``offset`` bytes past a boundary allow, tiles of
    THREADS x U vectors, at most one wave, no block without work."""
    p = tgather.plan(d, PLAN_BASE + offset, PLAN_BASE + (1 << 30), k, PLAN_SMS, PLAN_RESIDENT)
    row_vec = 16 if d % 4 == 0 else 8 if d % 2 == 0 else 4
    assert p.vec_bytes == min(row_vec, {0: 16, 4: 4, 8: 8}[offset])
    assert p.vectors_per_row * p.vec_bytes == 4 * d
    assert p.unroll * p.vec_bytes == tgather.THREAD_BYTES
    total, tile, wave = k * p.vectors_per_row, tgather.THREADS * p.unroll, PLAN_SMS * PLAN_RESIDENT
    assert (p.grid == 0) == (k == 0)
    assert 0 <= p.grid <= wave and p.grid * tile < 2 ** 32   # the kernel counts in 32 bits
    assert (p.grid - 1) * tile < total or k == 0              # every block has work
    assert p.grid * tile >= total or p.grid == wave           # one pass, or a full wave looping
    if offset == 0 and (d, k) == (50, 12000):   # the flagship batch: one pass of one wave
        assert p.vectors_per_row == 25 and p.grid * tile >= total


PLAN_L2 = 50 << 20   # an H100's 50 MB of L2


@pytest.mark.parametrize("k", [0, 1, 31, 33, 14541, 31000])
@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("d", [1, 2, 3, 33, 50, 100, 128, 257])
def test_adagrad_plan(d, elem_bytes, k):
    """The Adagrad kernel's launch plan, made on the host, with each of
    values, state and grads 0, 2, 4 or 8 bytes past a 512-byte boundary: the
    widest whole-element vector that the row and all three addresses allow
    (an address off its element boundary is refused), 8 bytes or more per
    lane, G lanes x U vectors covering a row with most slots busy, at most
    one wave, no block without work; evict-first stores only for a table
    pair larger than L2."""
    row_bytes = elem_bytes * d
    n_rows = max(k, 1)
    for offsets in itertools.product((0, 2, 4, 8), repeat=3):
        ptrs = [PLAN_BASE + i * (1 << 30) + off for i, off in enumerate(offsets)]
        if any(off % elem_bytes for off in offsets):
            with pytest.raises(ValueError, match="element boundary"):
                tadagrad.plan(d, *ptrs, k, PLAN_SMS, PLAN_RESIDENT, elem_bytes=elem_bytes,
                              n_rows=n_rows, l2_bytes=PLAN_L2)
            continue
        p = tadagrad.plan(d, *ptrs, k, PLAN_SMS, PLAN_RESIDENT, elem_bytes=elem_bytes,
                          n_rows=n_rows, l2_bytes=PLAN_L2)
        fits = [v for v in (16, 8, 4, 2) if v >= elem_bytes and row_bytes % v == 0
                and all(q % v == 0 for q in ptrs)]
        assert p.vec_bytes == fits[0]                        # the widest that fits
        assert p.vectors_per_row * p.vec_bytes == row_bytes
        assert p.unroll * p.vec_bytes >= 8 and p.unroll in (1, 2, 4)
        assert p.lanes in (1, 2, 4, 8, 16, 32)
        chunk = p.lanes * p.unroll
        chunks = -(-p.vectors_per_row // chunk)
        assert chunks == 1 or p.lanes == 32                   # only rows wider than a warp loop
        assert 2 * p.vectors_per_row > chunks * chunk or p.vectors_per_row < p.unroll
        rows_per_block = (32 // p.lanes) * (tadagrad.THREADS // 32)
        wave = PLAN_SMS * PLAN_RESIDENT
        assert (p.grid == 0) == (k == 0)
        assert 0 <= p.grid <= wave
        assert (p.grid - 1) * rows_per_block < k or k == 0       # every block has work
        assert p.grid * rows_per_block >= k or p.grid == wave    # one pass, or a full wave looping
        assert p.stream_stores == (2 * n_rows * row_bytes > PLAN_L2)
    # the buffer pair (43,027,080 rows) stores evict-first; nothing else changes
    big = tadagrad.plan(d, PLAN_BASE, PLAN_BASE, PLAN_BASE, k, PLAN_SMS, PLAN_RESIDENT,
                        elem_bytes=elem_bytes, n_rows=43_027_080, l2_bytes=PLAN_L2)
    assert big.stream_stores and big._replace(stream_stores=False) == tadagrad.plan(
        d, PLAN_BASE, PLAN_BASE, PLAN_BASE, k, PLAN_SMS, PLAN_RESIDENT, elem_bytes=elem_bytes,
        n_rows=1, l2_bytes=PLAN_L2)
    main = {(50, 4): (8, 32, 1), (100, 4): (16, 32, 1), (100, 2): (8, 32, 1), (50, 2): (4, 16, 2),
            (128, 4): (16, 32, 1)}
    if (d, elem_bytes) in main:   # the main paths' rows: 25 or 32 vectors
        assert (big.vec_bytes, big.lanes, big.unroll) == main[d, elem_bytes]


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


# -- CUDA kernels against their plain versions (GPU only) ------------------

SHAPES = [(14541, 50, 12000), (100, 1, 37), (1000, 33, 1001), (77, 257, 333), (500, 128, 2048),
          (3000, 100, 4099), (3000, 50, 1), (3000, 100, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("offset", ["none", "row", "4 bytes", "8 bytes"])
def test_cuda_gather_matches_plain(cuda_device, n, d, k, id_dtype, offset):
    """Tables that are contiguous views into their storage (``big[1:]``, or
    4 or 8 bytes past a boundary) take narrower vectors; ids below 0 and at or
    above N read the end rows."""
    g = torch.Generator(device=cuda_device).manual_seed(n + d + k)
    skip = {"none": 0, "row": d, "4 bytes": 1, "8 bytes": 2}[offset]
    big = torch.randn(n * d + skip, device=cuda_device, generator=g)
    table = big[skip:].view(n, d)
    ids = torch.randint(-3, n + 3, (k,), device=cuda_device, generator=g).to(id_dtype)
    before = tgather.launches
    out = tgather.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert tgather.launches == before + 1
    assert torch.equal(out, tgather.gather_rows_plain(table, ids))


def _cuda_adagrad_inputs(dev, n, d, k, dtype, id_dtype, offsets):
    """values, state, ids, grads: each of the three tensors a contiguous view
    ``offsets`` elements into its storage; ids unique, some below 0 and some
    at or above N (padding); bf16 grads scaled to keep its steps small."""
    g = torch.Generator(device=dev).manual_seed(n + d + k + sum(offsets))

    def view(rows, fill, off):
        base = torch.empty(rows * d + off, device=dev)
        fill(base, g)
        return base.to(dtype)[off:].view(rows, d)

    vals = view(n, lambda t, g: t.normal_(generator=g), offsets[0])
    state = view(n, lambda t, g: t.uniform_(generator=g), offsets[1])
    state[::5] = 0
    ids = (torch.randperm(n + 10, device=dev, generator=g)[:min(k, n)] - 5).to(id_dtype)
    scale = 0.1 if dtype == torch.bfloat16 else 1.0
    grads = view(ids.shape[0], lambda t, g: t.normal_(generator=g).mul_(scale), offsets[2])
    return vals, state, ids, grads


def _check_cuda_adagrad(vals, state, ids, grads):
    """The kernel, in place on the views, against the plain version on
    clones, bit for bit, with one launch counted; rows no id names unchanged."""
    v1, s1 = vals.clone(), state.clone()
    v2, s2 = vals.clone(), state.clone()
    before = tadagrad.launches
    tadagrad.sparse_adagrad_update_(vals, state, ids, grads, 0.1)
    tadagrad.sparse_adagrad_update_plain_(v2, s2, ids, grads, 0.1)
    torch.cuda.synchronize()
    assert tadagrad.launches == before + 1
    bits = torch.int16 if vals.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(vals.view(bits), v2.view(bits)) and torch.equal(state.view(bits),
                                                                       s2.view(bits))
    untouched = torch.ones(vals.shape[0], dtype=torch.bool, device=vals.device)
    named = ids[(ids >= 0) & (ids < vals.shape[0])].long()
    untouched[named] = False
    assert torch.equal(vals[untouched].view(bits), v1[untouched].view(bits))
    assert torch.equal(state[untouched].view(bits), s1[untouched].view(bits))


# (values, state, grads) element offsets into their storage: aligned, each
# tensor 1-3 elements in, all three at once
ADAGRAD_OFFSETS = [(0, 0, 0), (1, 0, 0), (0, 2, 0), (0, 0, 3), (1, 2, 3), (3, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("offsets", ADAGRAD_OFFSETS)
def test_cuda_adagrad_matches_plain(cuda_device, n, d, k, id_dtype, offsets):
    _check_cuda_adagrad(*_cuda_adagrad_inputs(cuda_device, n, d, k, torch.float32, id_dtype,
                                                offsets))


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    table = torch.randn(10, 4, device=cuda_device)
    with pytest.raises(TypeError):
        tgather.gather_rows(table.double(), torch.zeros(3, dtype=torch.long, device=cuda_device))
    with pytest.raises(ValueError):
        tgather.gather_rows(table.t(), torch.zeros(3, dtype=torch.long, device=cuda_device))
    with pytest.raises(ValueError):
        tgather.gather_rows(table, torch.zeros(3, dtype=torch.long))


# caps from one slot to a 13k-slot hub (split into 256-slot pieces and folded
# on-chip), with the split's edges: 256 slots (one task), 257 and 512 (two pieces)
SUM_SHAPES = [(1000, 1), (777, 3), (300, 40), (5, 256), (4, 257), (3, 512), (20, 700),
              (2, 13161)]
# the neighbour sum's widths (1, 33, 128, 129, 259, 519) and the edges of the
# kernel's 128-byte column slabs: 32 f32 or 64 bf16 columns, 16-byte loads
# where d % 4 (f32) or d % 8 (bf16) is 0
SUM_DIMS = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 128, 129, 259, 519]


@pytest.mark.cuda
@pytest.mark.parametrize("d", SUM_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gather_sum_matches_plain(cuda_device, d, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn(5000, d, device=cuda_device, generator=g).to(dtype)
    # the same values one element past a 16-byte boundary: the one-element loads
    x_off = torch.empty(5000 * d + 1, device=cuda_device, dtype=dtype)[1:].view(5000, d)
    x_off.copy_(x)
    buckets = []
    for rows, cap in SUM_SHAPES:
        ids = torch.randint(0, 5001, (rows, cap), device=cuda_device, generator=g,
                            dtype=torch.int32)   # 5000 = padding id
        buckets.append(ids)
        for xs in (x, x_off):
            before = tns.launches
            out = tns.gather_sum(xs, ids)
            torch.cuda.synchronize()
            assert tns.launches == before + 1 and out.dtype == torch.float32
            assert torch.equal(out, tns.gather_sum_plain(x, ids))
    # one call over several buckets: empty buckets and rows that are all padding
    pad = lambda rows, cap: torch.full((rows, cap), 5000, dtype=torch.int32, device=cuda_device)
    empty = lambda cap: torch.zeros((0, cap), dtype=torch.int32, device=cuda_device)
    mixed = [buckets[1], empty(9), pad(7, 5), buckets[4], pad(6, 300), buckets[-1], empty(400)]
    sizes = [b.shape[0] for b in mixed]
    out_rows = torch.randperm(sum(sizes), device=cuda_device, generator=g)
    layout = tns.bucket_layout(mixed, out_rows, sum(sizes))
    out = tns.nbr_sum(x, layout)
    torch.cuda.synchronize()
    assert torch.equal(out, tns.nbr_sum_plain(x, layout))
    first = np.cumsum([0] + sizes)
    for k in (2, 4):   # the all-padding buckets sum to +0.0
        assert torch.equal(out[out_rows[first[k]:first[k + 1]]],
                           torch.zeros(sizes[k], d, device=cuda_device))


@pytest.mark.cuda
def test_cuda_nbr_sum_forward_and_backward_match_plain(cuda_device):
    from marius_tpu_torch.data import full_graph as tfg

    rng = np.random.default_rng(5)
    n, e = 3000, 40000
    w = (np.arange(n) + 1.0) ** -1.0
    edges = np.stack([rng.integers(0, n, e), rng.choice(n, e, p=w / w.sum())], 1)
    adj = tfg.build_full_graph_adjacency(edges, n).to(cuda_device)
    layout = tfg.nbr_sum_layout(adj)
    assert layout.num_partials > 0
    x = torch.randn(n, 128, device=cuda_device, requires_grad=True)
    u = torch.randn(n, 128, device=cuda_device)
    y = tfg.make_nbr_sums(adj)(x)
    y.backward(u)
    torch.cuda.synchronize()
    assert torch.equal(y, tns.nbr_sum_plain(x.detach(), layout))
    assert torch.equal(x.grad, tns.nbr_sum_plain(u, layout))


@pytest.mark.cuda
def test_cuda_gather_sum_rejects_bad_inputs(cuda_device):
    ids = torch.zeros((3, 2), dtype=torch.int32, device=cuda_device)
    x = torch.randn(10, 4, device=cuda_device)
    with pytest.raises(TypeError):
        tns.gather_sum(x.double(), ids)
    with pytest.raises(ValueError):
        tns.gather_sum(x.t(), ids)
    with pytest.raises(ValueError):
        tns.nbr_sum(x, tns.bucket_layout([ids.cpu()], torch.arange(3), 3))


# -- the bf16 entries (storage.embeddings.options.dtype: bfloat16) -------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(14541, 50, 12000), (3000, 100, 4099), (1000, 33, 1001),
                                   (77, 1, 333), (500, 128, 2048), (3000, 7, 1)])
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_cuda_gather_bf16_matches_plain(cuda_device, n, d, k, offset):
    """bf16 tables, also views 2, 4 or 8 bytes into their storage (2-byte
    vectors where nothing wider divides)."""
    g = torch.Generator(device=cuda_device).manual_seed(n + d + k)
    big = torch.randn(n * d + offset, device=cuda_device, generator=g).to(torch.bfloat16)
    table = big[offset:].view(n, d)
    for id_dtype in (torch.int64, torch.int32):
        ids = torch.randint(-3, n + 3, (k,), device=cuda_device, generator=g).to(id_dtype)
        before = tgather.launches
        out = tgather.gather_rows(table, ids)
        torch.cuda.synchronize()
        assert tgather.launches == before + 1 and out.dtype == torch.bfloat16
        assert torch.equal(out.view(torch.int16),
                           tgather.gather_rows_plain(table, ids).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(14541, 50, 14541), (3000, 100, 2000), (77, 257, 60),
                                   (100, 1, 37), (500, 200, 333), (1000, 3, 999)])
@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("offsets", ADAGRAD_OFFSETS)
def test_cuda_adagrad_bf16_matches_plain(cuda_device, n, d, k, id_dtype, offsets):
    _check_cuda_adagrad(*_cuda_adagrad_inputs(cuda_device, n, d, k, torch.bfloat16, id_dtype,
                                                offsets))


@pytest.mark.cuda
def test_cuda_bf16_sampled_sum_and_wrappers(cuda_device):
    """The sampled sum of bf16 rows launches the gather-sum's bf16 entry and
    rounds its f32 sums to bf16; wrappers refuse a dtype they have no entry
    for (no fallback)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(5000, 128, device=cuda_device, generator=g).to(torch.bfloat16)
    idx = torch.randint(0, 5000, (700, 10), device=cuda_device, generator=g)
    mask = torch.rand(700, 10, device=cuda_device, generator=g) < 0.8
    before = tns.launches
    out = tseg.sampled_nbr_sum(x, idx, mask, idx[:, :3], mask[:, :3])
    torch.cuda.synchronize()
    assert tns.launches == before + 1 and out.dtype == torch.bfloat16
    ids = torch.cat([tseg.slot_ids(5000, idx, mask), tseg.slot_ids(5000, idx[:, :3],
                                                                  mask[:, :3])], 1)
    ref = tns.gather_sum_plain(x, ids.to(torch.int32)).to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    half = torch.randn(10, 4, device=cuda_device).half()
    ids1 = torch.zeros(3, dtype=torch.long, device=cuda_device)
    with pytest.raises(TypeError):
        tgather.gather_rows(half, ids1)
    with pytest.raises(TypeError):
        tadagrad.sparse_adagrad_update_(half, half.clone(), ids1, half[:3].clone(), 0.1)
    with pytest.raises(TypeError):   # mixed dtypes
        bf = half.to(torch.bfloat16)
        tadagrad.sparse_adagrad_update_(bf, bf.clone(), ids1, half[:3].float(), 0.1)
