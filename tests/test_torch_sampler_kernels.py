"""The neighbour sampler's CUDA kernels (marius_tpu_torch/csrc/sampler.cu)
against its plain PyTorch version.

On a CUDA tensor ``sample_neighbor_batch`` runs each hop as the kernels; the
tests marked ``cuda`` hold that path against ``sample_neighbor_batch_plain``
on the card, bit for bit over every field of the NeighborBatch (dtypes
included), for the same draws, at each of chip_smoke.py's SAMPLER_CASES: the
ogbn-arxiv cell's batch, a tight cap with overflow, padded and masked seeds,
DROPOUT (uniforms on the rate's boundary), ALL with relations, one direction
at a time with int32 seeds, the GNN LP hop (saturated) and the sorted branch
(sort and bitmap). They skip without a GPU. The CPU test checks that each
case exercises what it names, on the plain version. This file imports
nothing of JAX, so that the card's tests run without it.
"""

import pytest
import torch

from chip_smoke import (
    SAMPLER_CASES,
    batch_mismatch,
    recorded_draws,
    sampler_case,
    sampler_graphs,
)
from marius_tpu_torch.data.samplers import neighbor as tn
from marius_tpu_torch.ops.cuda import sampler as sampler_kernels
from marius_tpu_torch.reporting import profiling
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def card_graphs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this comparison on the card")
    return sampler_graphs(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_kernels_match_plain_bit_for_bit(card_graphs, case):
    graph, seeds, mask, cfgs, caps, draws = sampler_case(case, card_graphs, seed=11)
    record, replay = recorded_draws(draws)
    before = sampler_kernels.launches
    got = tn.sample_neighbor_batch(record, graph, seeds, mask, cfgs, caps)
    assert sampler_kernels.launches > before
    want = tn.sample_neighbor_batch_plain(replay, graph, seeds, mask, cfgs, caps)
    torch.cuda.synchronize()
    assert batch_mismatch(got, want) == []
    if case == "tight_cap":
        assert int(got.overflow) > 0


@pytest.mark.cuda
def test_sampler_kernels_make_no_host_sync(card_graphs):
    graph, seeds, mask, cfgs, caps, draws = sampler_case("nc_cell", card_graphs)
    tn.sample_neighbor_batch(draws, graph, seeds, mask, cfgs, caps)   # built and warm
    with profiling.recording() as log:
        tn.sample_neighbor_batch(draws, graph, seeds, mask, cfgs, caps)
        torch.cuda.synchronize()
    spans = [s for s in log.spans if s.name == "sample"]
    assert len(spans) == 1
    assert (spans[0].counts or {}).get("host_syncs", 0) == 0


def test_sampler_cases_exercise_what_they_name():
    """On the CPU, with the plain version: the tight cap overflows (the NC
    cell's caps do too, as in the benchmark), the saturated hops give every
    id, the sorted cases' caps lie below their frontiers, and padded seeds
    leave holes."""
    graphs = sampler_graphs(torch.device("cpu"))
    for case, (_, _, (b, padded, masked), dtype, spec, caps) in SAMPLER_CASES.items():
        graph, seeds, mask, cfgs, caps, draws = sampler_case(case, graphs)
        nb = tn.sample_neighbor_batch(draws, graph, seeds, mask, cfgs, caps)
        assert seeds.dtype == dtype and int((~mask).sum()) == padded + masked + (
            500 if case == "lp_gs1" else 0)
        if case == "tight_cap":
            assert int(nb.overflow) > 0
        if case == "lp_gs1" or case.startswith("sorted"):   # no prefix hop, no overflow
            assert int(nb.overflow) == 0
        if caps[-1] == graph.num_nodes + 1:
            assert torch.equal(nb.node_ids[0].long(), torch.arange(caps[-1]))
        if case.startswith("sorted"):
            assert all(caps[i + 1] < caps[i] for i in range(len(caps) - 1))
        if case == "dropout":
            assert spec[0][0] == "DROPOUT" and 0 < int(nb.layers[-1].in_mask.sum()) < b * 16
