"""The port's unique-id functions and neighbour sampler against marius_tpu's.

Integer code, held exactly: ``unique_padded`` (with jnp.unique's truncation),
``unique_padded_bitmap``, ``prefix_unique_padded`` (with holes and with
overflow) and ``unique_padded_auto`` on the same numpy inputs; then
``sample_neighbor_batch`` on a 300-node graph with relations and degrees
above and below the fanout, over the saturated, prefix and sorted dedup
branches, ALL / UNIFORM / DROPOUT, incoming only / outgoing only / both. The
JAX sampler draws from its key; the port's ``Draws`` seam replays the same
numbers (``randint`` and ``uniform`` of JAX's key schedule), and every field
of the two NeighborBatches must then be equal, masked slots included. Last,
the hop-cap estimators and the ALL-cap resolvers give the same numbers.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marius_tpu.data.samplers.neighbor as jn
import marius_tpu.ops.unique as ju
import marius_tpu_torch.data.samplers.neighbor as tn
import marius_tpu_torch.ops.unique as tu
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu_torch.data.graph import build_device_graph as t_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 300


def jax_draws(key):
    """The port's Draws seam fed with the numbers JAX's sampler draws from
    ``key`` (sample_neighbor_batch :222-238, _sample_direction :166-175)."""

    def draw(depth, direction, n, fanout, dropout):
        k = jax.random.fold_in(jax.random.fold_in(key, depth), direction)
        rand = jax.random.randint(k, (n, fanout), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
        uni = jax.random.uniform(jax.random.fold_in(k, 1), (n, fanout)) if dropout else None
        return (torch.from_numpy(np.array(rand)),
                None if uni is None else torch.from_numpy(np.array(uni)))

    return draw


def _eq(t, j, what=""):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=what)


def assert_batches_equal(tb, jb):
    assert len(tb.node_ids) == len(jb.node_ids) and len(tb.layers) == len(jb.layers)
    for h, (ti, ji, tm, jm) in enumerate(zip(tb.node_ids, jb.node_ids, tb.node_masks,
                                             jb.node_masks)):
        _eq(ti, ji, f"node_ids[{h}]")
        _eq(tm, jm, f"node_masks[{h}]")
    for h, (tl, jl) in enumerate(zip(tb.layers, jb.layers)):
        for f in ("self_idx", "in_nbr_idx", "in_mask", "out_nbr_idx", "out_mask", "node_mask",
                  "in_rel", "out_rel"):
            tv, jv = getattr(tl, f), getattr(jl, f)
            assert (tv is None) == (jv is None), f
            if tv is not None:
                _eq(tv, jv, f"layers[{h}].{f}")
    _eq(tb.overflow, jb.overflow, "overflow")


# -- unique ------------------------------------------------------------------

def test_unique_padded_bitmap_matches_jax():
    rng = np.random.default_rng(0)
    fill = 90
    for size, n in ((60, 200), (20, 200), (90, 5)):   # roomy, truncating, sparse
        ids = np.where(rng.random(n) < 0.2, fill, rng.integers(0, fill, n)).astype(np.int32)
        j = ju.unique_padded_bitmap(jnp.asarray(ids), size, fill)
        t = tu.unique_padded_bitmap(torch.from_numpy(ids), size, fill)
        for a, b in zip(t, j):
            _eq(a, b)


def test_unique_padded_sorted_matches_jax_with_truncation():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (7, 9)).astype(np.int32)
    for size in (63, 30):     # room for every distinct id, then fewer slots than ids
        j = ju.unique_padded(jnp.asarray(ids), size, 50)
        t = tu.unique_padded(torch.from_numpy(ids), size, 50)
        for a, b in zip(t, j):
            _eq(a, b)
    assert int(t.count) == 30 and int(t.inverse.max()) >= 30


@pytest.mark.parametrize("case", ["holes", "overflow", "full_cur", "no_new"])
def test_prefix_unique_padded_matches_jax(case):
    rng = np.random.default_rng(2)
    fill, n = 120, 24
    cur = rng.permutation(fill)[:n].astype(np.int32)
    mask = rng.random(n) < (0.6 if case == "holes" else 1.0)
    cands = np.where(rng.random(200) < 0.25, fill,
                     rng.integers(0, fill, 200)).astype(np.int32)
    if case == "no_new":
        cands = np.where(rng.random(200) < 0.5, fill, cur[rng.integers(0, n, 200)])
        cands = cands.astype(np.int32)
    size = {"holes": 110, "overflow": 40, "full_cur": 119, "no_new": 30}[case]
    j = ju.prefix_unique_padded(jnp.asarray(cur), jnp.asarray(mask), jnp.asarray(cands), size,
                                fill)
    t = tu.prefix_unique_padded(torch.from_numpy(cur), torch.from_numpy(mask),
                                torch.from_numpy(cands), size, fill)
    for a, b in zip(t, j):
        _eq(a, b)
    assert (int(t.overflow) > 0) == (case == "overflow")
    with pytest.raises(ValueError):
        tu.prefix_unique_padded(torch.from_numpy(cur), torch.from_numpy(mask),
                                torch.from_numpy(cands), n - 1, fill)


@pytest.mark.parametrize("n", [100, 70_000])
def test_unique_padded_auto_matches_jax(n):
    """Below the bitmap threshold the sort, above it the bitmap."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 5000, n).astype(np.int32)
    j = ju.unique_padded_auto(jnp.asarray(ids), 6000, 5000)
    t = tu.unique_padded_auto(torch.from_numpy(ids), 6000, 5000)
    for a, b in zip(t, j):
        _eq(a, b)


# -- the sampler ---------------------------------------------------------------

def _edges(rels: bool):
    rng = np.random.default_rng(4)
    e = 2400
    w = (np.arange(N) + 1.0) ** -0.8          # skewed: some degrees far above the fanout
    src = rng.integers(0, N - 20, e)          # the last 20 ids have no out-edges
    dst = rng.choice(N - 10, e, p=w[:N - 10] / w[:N - 10].sum())
    cols = [src, rng.integers(0, 4, e), dst] if rels else [src, dst]
    return np.stack(cols, 1).astype(np.int32)


def _graphs(rels):
    edges = _edges(rels)
    return edges, j_graph(edges, N, 4 if rels else 1), t_graph(edges, N, 4 if rels else 1)


C = jn.NeighborSamplingConfig
T = tn.NeighborSamplingConfig
B = 24

# (configs outermost first, hop caps innermost first, relations)
CASES = {
    "uniform-both-prefix": ([("UNIFORM", 6, 0.0, True, True)] * 2, "worst", False),
    "uniform-tight-overflow": ([("UNIFORM", 8, 0.0, True, True)] * 2, [B, 60, 90], False),
    "all-in-saturated": ([("ALL", 12, 0.0, True, False)] * 2, [B, 200, N + 1], True),
    "dropout-out-only": ([("DROPOUT", 5, 0.4, False, True)] * 2, "worst", True),
    "mixed-sorted-shrink": ([("UNIFORM", 3, 0.0, True, True), ("ALL", 4, 0.0, False, True)],
                            [B, 20, 40], False),
    "uniform-sorted-no-bitmap": ([("UNIFORM", 6, 0.0, True, True)] * 2, "worst", True),
    "three-hops-saturate": ([("UNIFORM", 5, 0.0, True, True)] * 3, [B, 150, N + 1, N + 1],
                            False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_neighbor_batch_matches_jax(monkeypatch, case):
    spec, caps, rels = CASES[case]
    _, jg, tg = _graphs(rels)
    jcfg = [C(*s) for s in spec]
    tcfg = [T(*s) for s in spec]
    if caps == "worst":
        caps = jn.estimate_hop_caps(B, jcfg, N)
        assert caps == tn.estimate_hop_caps(B, tcfg, N)
    if case == "uniform-sorted-no-bitmap":
        # a graph beyond the prefix-bitmap limit keeps the sorted path
        monkeypatch.setattr(jn, "PREFIX_BITMAP_LIMIT", N - 1)
        monkeypatch.setattr(tn, "PREFIX_BITMAP_LIMIT", N - 1)
    rng = np.random.default_rng(5)
    seeds = rng.permutation(N)[:B].astype(np.int32)
    mask = np.ones(B, bool)
    mask[-5:] = False                          # padded seeds, as a last batch has
    key = jax.random.key(7)
    jb = jn.sample_neighbor_batch(key, jg, jnp.asarray(seeds), jnp.asarray(mask), jcfg, caps)
    tb = tn.sample_neighbor_batch(jax_draws(key), tg, torch.from_numpy(seeds),
                                  torch.from_numpy(mask), tcfg, caps)
    assert_batches_equal(tb, jb)
    if case == "uniform-tight-overflow":
        assert int(tb.overflow) > 0
    if case in ("all-in-saturated", "three-hops-saturate"):
        assert tb.node_ids[0].shape[0] == N + 1
    if case == "mixed-sorted-shrink":
        assert caps[1] < B or caps[2] < caps[1] * 4


def test_hop_cap_estimates_match_jax():
    edges = _edges(False)
    for spec in ([("UNIFORM", 6, 0.0, True, True)] * 2, [("UNIFORM", 3, 0.0, False, True)] * 3):
        jcfg, tcfg = [C(*s) for s in spec], [T(*s) for s in spec]
        assert tn.estimate_hop_caps(50, tcfg, N) == jn.estimate_hop_caps(50, jcfg, N)
        for kw in ({}, {"seed": 3, "seed_pool": np.arange(0, N, 2)}):
            assert (tn.estimate_hop_caps_empirical(edges, N, tcfg, 50, **kw)
                    == jn.estimate_hop_caps_empirical(edges, N, jcfg, 50, **kw))
    assert tn.estimate_hop_caps_empirical(edges[:0], N, tcfg, 50) == \
        jn.estimate_hop_caps_empirical(edges[:0], N, jcfg, 50)


def test_resolve_all_caps_match_jax(caplog, monkeypatch):
    # a manager run earlier in the process sets up the packages' loggers, which
    # stop propagating to the root logger that caplog reads
    for name in ("marius_tpu", "marius_tpu_torch"):
        monkeypatch.setattr(logging.getLogger(name), "propagate", True)
    edges, jg, tg = _graphs(True)
    spec = [("ALL", 10, 0.0, True, True), ("UNIFORM", 4, 0.0, True, True),
            ("ALL", 10, 0.0, False, True)]
    jcfg, tcfg = [C(*s) for s in spec], [T(*s) for s in spec]
    for limit in (4096, 20):
        j = jn.resolve_all_caps(jcfg, np.asarray(jg.in_offsets), np.asarray(jg.out_offsets),
                                cap_limit=limit)
        t = tn.resolve_all_caps(tcfg, tg.in_offsets, tg.out_offsets, cap_limit=limit)
        assert [dataclass_tuple(c) for c in t] == [dataclass_tuple(c) for c in j]
        j = jn.resolve_all_caps_from_edges(jcfg, edges, N, cap_limit=limit)
        t = tn.resolve_all_caps_from_edges(tcfg, edges, N, cap_limit=limit)
        assert [dataclass_tuple(c) for c in t] == [dataclass_tuple(c) for c in j]
    assert "ALL neighbor sampling capped at 20" in caplog.text
    uniform = [T("UNIFORM", 4)]
    assert tn.resolve_all_caps_from_edges(uniform, edges, N) == tuple(uniform)


def dataclass_tuple(c):
    return (c.sampling_type, c.max_neighbors, c.rate, c.use_incoming, c.use_outgoing)


def test_generator_draws_shapes_and_range():
    draw = tn.generator_draws(torch.Generator().manual_seed(0))
    rand, uni = draw(0, 1, 7, 3, True)
    assert rand.shape == (7, 3) and rand.dtype == torch.int32 and int(rand.min()) >= 0
    assert uni.shape == (7, 3) and 0.0 <= float(uni.min()) and float(uni.max()) < 1.0
    assert draw(0, 0, 2, 2, False)[1] is None
    a, _ = tn.seeded_draws(11, 3, "cpu")(0, 0, 4, 4, False)
    b, _ = tn.seeded_draws(11, 3, "cpu")(0, 0, 4, 4, False)
    assert torch.equal(a, b)


# -- the CUDA path's wrapper ------------------------------------------------------

def _meta_inputs(case):
    """(graph, seeds, mask, draws) that take the kernel path (not the CPU) and
    are wrong in one way; on the meta device nothing can launch."""
    _, _, tg = _graphs(False)
    meta = torch.device("meta")
    graph = tg if case == "mixed_devices" else tg.to(meta)
    seeds = torch.empty((B,), dtype=torch.int64, device=meta)
    if case == "dtype":
        seeds = seeds.float()
    if case == "non_contiguous":
        seeds = torch.empty((2 * B,), dtype=torch.int64, device=meta)[::2]
    draw_dtype = torch.int64 if case == "draws_dtype" else torch.int32

    def draws(depth, direction, n, fanout, dropout):
        return torch.empty((n, fanout), dtype=draw_dtype, device=meta), None

    return graph, seeds, torch.ones((B,), dtype=torch.bool, device=meta), draws


def test_sampler_takes_the_plain_path_for_cpu_tensors(monkeypatch):
    def no_kernels(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel path")

    monkeypatch.setattr(tn.sampler_kernels, "sample_hop", no_kernels)
    _, _, tg = _graphs(True)
    cfg = [T("UNIFORM", 6, 0.0, True, True)] * 2
    caps = tn.estimate_hop_caps(B, cfg, N)
    seeds, mask = torch.arange(B, dtype=torch.int64) * 7, torch.ones(B, dtype=torch.bool)
    got = tn.sample_neighbor_batch(tn.generator_draws(torch.Generator().manual_seed(3)), tg,
                                   seeds, mask, cfg, caps)
    want = tn.sample_neighbor_batch_plain(tn.generator_draws(torch.Generator().manual_seed(3)),
                                          tg, seeds, mask, cfg, caps)
    assert_batches_equal(got, want)


@pytest.mark.parametrize("case,error", [("device", ValueError), ("dtype", TypeError),
                                        ("non_contiguous", ValueError),
                                        ("mixed_devices", ValueError),
                                        ("draws_dtype", TypeError)])
def test_sampler_kernel_path_raises_on_inputs_it_does_not_take(monkeypatch, case, error):
    """A tensor off the CPU always takes the kernel path, which raises, before
    building or launching anything, on an input the kernels do not take."""
    def no_build(name):
        raise AssertionError("the kernels were built for a bad input")

    monkeypatch.setattr(tn.sampler_kernels.build, "library", no_build)
    graph, seeds, mask, draws = _meta_inputs(case)
    cfg = [T("UNIFORM", 6, 0.0, True, True)] * 2
    with pytest.raises(error):
        tn.sample_neighbor_batch(draws, graph, seeds, mask, cfg, [B, 100, N + 1])
