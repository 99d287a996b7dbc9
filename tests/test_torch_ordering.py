"""The port's host-side out-of-core pieces against marius_tpu's, exactly:
the BETA and COMET orderings and both edge-bucket assignments, the
partitioner, and the port's own loader of ``native/marius_native.cpp`` (each
entry point against the JAX package's loader and against its numpy plain
version)."""

import numpy as np
import pytest

from marius_tpu import native as jnative
from marius_tpu.data import ordering as jordering
from marius_tpu.tools.preprocess import partitioner as jpartitioner
from marius_tpu_torch import native as tnative
from marius_tpu_torch.data import ordering as tordering
from marius_tpu_torch.tools.preprocess import partitioner as tpartitioner
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _same_states(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,c,seed", [(16, 8, 0), (16, 8, 3), (8, 4, 1), (20, 3, 2),
                                      (5, 3, 0), (4, 4, 0)])
def test_beta_ordering_and_assignments_match(n, c, seed):
    states = tordering.beta_ordering(n, c, seed=seed)
    _same_states(states, jordering.beta_ordering(n, c, seed=seed))
    assert tordering.assign_edge_buckets(states, n, seed=seed) == \
        jordering.assign_edge_buckets(states, n, seed=seed)
    assert tordering.assign_edge_buckets(states, n, randomly=False) == \
        jordering.assign_edge_buckets(states, n, randomly=False)
    assert tordering.greedy_assign_edge_buckets(states, n) == \
        jordering.greedy_assign_edge_buckets(states, n)


@pytest.mark.parametrize("n,c,ratio,cache,seed", [(16, 8, 2, 0, 0), (16, 8, 2, 0, 5),
                                                  (32, 8, 2, 0, 1), (16, 8, 2, 1, 2),
                                                  (24, 12, 3, 0, 4), (32, 16, 4, 1, 0)])
def test_comet_ordering_matches(n, c, ratio, cache, seed):
    states = tordering.comet_ordering(n, c, ratio, cache, seed=seed)
    _same_states(states, jordering.comet_ordering(n, c, ratio, cache, seed=seed))
    assert tordering.assign_edge_buckets(states, n, seed=seed) == \
        jordering.assign_edge_buckets(states, n, seed=seed)


def test_freebase86m_schedule_at_seed_0():
    """freebase86m_comet.yaml's schedule (16 partitions, capacity 8, ratio 2):
    10 states, 18 partitions admitted after the first load."""
    states = tordering.comet_ordering(16, 8, 2, 0, seed=0)
    admits = sum(len(set(b.tolist()) - set(a.tolist())) for a, b in zip(states, states[1:]))
    assert (len(states), admits) == (10, 18)
    sizes = [len(a) for a in tordering.assign_edge_buckets(states, 16, seed=0)]
    assert sum(sizes) == 256 and min(sizes) >= 1


def test_node_orderings_match():
    for n, c in [(10, 3), (16, 4)]:
        _same_states(tordering.sequential_node_ordering(n, c),
                     jordering.sequential_node_ordering(n, c))
        _same_states(tordering.dispersed_node_ordering(n, c, seed=2),
                     jordering.dispersed_node_ordering(n, c, seed=2))


@pytest.mark.parametrize("cols,num_nodes,parts", [(3, 1000, 16), (2, 97, 4), (3, 50, 7)])
def test_partition_edges_matches(cols, num_nodes, parts):
    rng = np.random.default_rng(cols + parts)
    edges = rng.integers(0, num_nodes, (5000, cols)).astype(np.int32)
    out, sizes = tpartitioner.partition_edges(edges, num_nodes, parts)
    jout, jsizes = jpartitioner.partition_edges(edges, num_nodes, parts)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(sizes, jsizes)
    order, osizes = tpartitioner.partition_order(edges, num_nodes, parts)
    jorder, josizes = jpartitioner.partition_order(edges, num_nodes, parts)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(out, edges[order])
    np.testing.assert_array_equal(osizes, josizes)


# -- the native library ----------------------------------------------------------

def test_native_builds_its_own_copy():
    lib = tnative.load()
    assert lib is tnative.load()
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert "marius_tpu_torch" in path.parts and path.name != "_marius_native.so"


def test_gather_remap_buckets_matches():
    rng = np.random.default_rng(0)
    P, psize = 4, 10
    edges = rng.integers(0, P * psize, (500, 3)).astype(np.int32)
    grouped, sizes = tpartitioner.partition_edges(edges, P * psize, P)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    part_to_slot = np.array([2, -1, 0, 1], np.int32)
    bucket_ids = np.array([0 * P + 2, 2 * P + 3, 3 * P + 0, 0], np.int32)
    out = tnative.gather_remap_buckets(grouped, offsets, bucket_ids, part_to_slot, psize)
    np.testing.assert_array_equal(
        out, jnative.gather_remap_buckets(grouped, offsets, bucket_ids, part_to_slot, psize))
    np.testing.assert_array_equal(out, tnative.gather_remap_buckets_plain(
        grouped, offsets, bucket_ids, part_to_slot, psize))
    assert len(tnative.gather_remap_buckets(grouped, offsets, bucket_ids[:0],
                                            part_to_slot, psize)) == 0


@pytest.mark.parametrize("rows,cols,seed", [(100, 3, 1), (257, 2, 12345), (1, 3, 0)])
def test_shuffle_rows_matches(rows, cols, seed):
    data = np.arange(rows * cols, dtype=np.int32).reshape(rows, cols)
    out = tnative.shuffle_rows(data.copy(), seed)
    np.testing.assert_array_equal(out, jnative.shuffle_rows(data.copy(), seed))
    np.testing.assert_array_equal(out, tnative.shuffle_rows_plain(data, seed))
    np.testing.assert_array_equal(np.sort(out[:, 0]), data[:, 0])
    if rows > 1:
        assert not np.array_equal(out, data)
    # in place on a contiguous int32 array
    buf = data.copy()
    assert tnative.shuffle_rows(buf, seed) is buf


def test_global_to_local_matches():
    part_to_slot = np.array([1, -1, 0, 3], np.int32)
    ids = np.array([0, 5, 10, 25, 39, 31], np.int32)
    out, misses = tnative.global_to_local(ids, part_to_slot, 10, fill=999)
    jout, jmisses = jnative.global_to_local(ids, part_to_slot, 10, fill=999)
    pout, pmisses = tnative.global_to_local_plain(ids, part_to_slot, 10, 999)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, pout)
    assert misses == jmisses == pmisses == 1
    assert out.tolist() == [10, 15, 999, 5, 39, 31]
    assert ids.tolist() == [0, 5, 10, 25, 39, 31]   # the input is not touched


def test_csr_offsets_matches():
    rng = np.random.default_rng(1)
    anchor = np.sort(rng.integers(0, 50, 400)).astype(np.int32)
    out = tnative.csr_offsets(anchor, 50)
    np.testing.assert_array_equal(out, jnative.csr_offsets(anchor, 50))
    np.testing.assert_array_equal(out, tnative.csr_offsets_plain(anchor, 50))


def test_partition_rows_matches():
    rng = np.random.default_rng(3)
    e = np.stack([rng.integers(0, 100, 5000), rng.integers(0, 5, 5000),
                  rng.integers(0, 100, 5000)], axis=1).astype(np.int32)
    out, sizes = tnative.partition_rows(e, 100, 8)
    jout, jsizes = jnative.partition_rows(e, 100, 8)
    order, psizes = tpartitioner.partition_order(e, 100, 8)   # the plain version
    for a, b in ((out, jout), (sizes, jsizes), (out, e[order]), (sizes, psizes)):
        np.testing.assert_array_equal(a, b)
    empty, esizes = tnative.partition_rows(e[:0], 100, 8)
    assert empty.shape == (0, 3) and not esizes.any()


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.load()
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="missing"):
        tnative.build()
