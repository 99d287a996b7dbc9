"""The GAT cell (``arxiv_gat.sampled``): its files are found by name, its
two readers read the program's ``gat.layer`` spans and ``gat.slot_bytes``
counter and give None where a program has neither, every reader of every
cell gives a number or None on a program that has only the sampled cells'
older spans and counters, and a small copy of the cell runs correct on the
CPU while the control and each fault do not."""

from __future__ import annotations

import math
import shutil
import tempfile
import time

import bench_tiny
import pytest
import torch

from benchmark.harness import compare, cycles, spec
from benchmark.harness.faults import of_task
from benchmark.harness.tasks import nc_gat

CELL = "arxiv_gat.sampled"
NEW = ("slot_gib_per_batch.gat", "gat_ms_per_batch.gat")


def _gat(din, heads, size, average, activation):
    return [{"type": "GNN", "options": {"type": "GAT", "num_heads": heads,
                                        "average_heads": average, "negative_slope": 0.2,
                                        "input_dropout": 0.0, "attention_dropout": 0.0},
             "input_dim": din, "output_dim": size if average else heads * size, "bias": True,
             "activation": activation}]


#: the small copy: bench_tiny's graph, narrow features, and the cell's three
#: layers in small (aggregate-first, then project-first twice)
TINY = {"dataset": dict(bench_tiny.NC["dataset"], feature_dim=8, num_classes=4),
        "marius_config": {
            "model": {"encoder": {
                "hop_caps": [100, 1200, 2400, 3001],
                "layers": [[{"type": "FEATURE", "output_dim": 8, "bias": True}],
                           _gat(8, 4, 8, False, "RELU"), _gat(32, 4, 8, False, "RELU"),
                           _gat(32, 6, 4, True, "NONE")]}},
            "training": {"batch_size": 100}, "evaluation": {"batch_size": 100}}}
#: the small copy's slot bytes a training batch: (targets x 65 slots x width x 4 B)
TINY_SLOT_BYTES = 4 * 65 * (2400 * (8 + 4) + 1200 * 32 + 100 * 24)


def test_the_configuration_and_the_cell_are_found():
    w = spec.workload(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("ogbn_arxiv_gat", "as_configured", 1)
    cell = cycles.cell_config(CELL)
    cfg = cell["config"]
    assert cfg["task"] == "nc_gat" and cfg["dataset"] == spec.config("ogbn_arxiv_sage")["dataset"]
    shapes = nc_gat.param_shapes(cfg, None)
    # the paper's widths: 4 x 256 concatenated twice, then 6 heads averaged
    assert shapes["encoder.1.0.w"] == (128, 1024) and shapes["encoder.1.0.a_l"] == (4, 256)
    assert shapes["encoder.2.0.w"] == (1024, 1024) and shapes["encoder.2.0.a_r"] == (4, 256)
    assert shapes["encoder.3.0.w"] == (1024, 240) and shapes["encoder.3.0.bias"] == (40,)
    bench = spec.benchmark_spec()
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "train_nodes_per_s"
    names = {m["name"] for m in spec.metrics_of(CELL, "per_layer")}
    assert set(NEW) <= names and "gather_sum_roofline.nc" not in names
    assert {m["name"] for m in spec.metrics_of(CELL, "end_to_end")} == {"train_nodes_per_s",
                                                                        "setup_s"}


def _row(name, parent, start, end, syncs=0):
    return (name, parent, start, end, syncs)


def _program(gat: bool, batches: int = 4):
    """A made-up ``ctx["program"]``: the sampled NC loop's spans and counters
    (train.epoch, train.batch with sample, gather, forward, backward and
    dense_update, train.readback, eval.evaluate, eval.batch), each forward
    holding three 2 ms ``gat.layer`` spans and counting slot bytes when
    ``gat``."""
    ms = 1_000_000
    spans, t = [_row("train.epoch", -1, 0, 0)], 0
    for _ in range(batches):
        b = len(spans)
        spans.append(_row("train.batch", 0, t, t + 20 * ms))
        spans.append(_row("sample", b, t, t + ms))
        spans.append(_row("gather", b, t + ms, t + 2 * ms))
        f = len(spans)
        spans.append(_row("forward", b, t + 2 * ms, t + 10 * ms))
        if gat:
            for k in range(3):
                spans.append(_row("gat.layer", f, t + (2 + 2 * k) * ms, t + (4 + 2 * k) * ms))
        spans.append(_row("backward", b, t + 10 * ms, t + 17 * ms))
        spans.append(_row("dense_update", b, t + 17 * ms, t + 20 * ms))
        t += 20 * ms
    spans.append(_row("train.readback", 0, t, t + ms, 1))
    spans[0] = _row("train.epoch", -1, 0, t + ms)
    e = len(spans)
    spans.append(_row("eval.evaluate", -1, t + ms, t + 9 * ms))
    spans.append(_row("eval.batch", e, t + ms, t + 9 * ms))
    if gat:
        spans.append(_row("gat.layer", e + 1, t + 2 * ms, t + 8 * ms))
    counters = {"train.batches": batches, "eval.batches": 1, "host_syncs": 1,
                "gather.launches": 5, "nbr_sum.launches": 0 if gat else 15,
                "adagrad.launches": 0, "sampler.launches": 5 * batches}
    if gat:
        counters["gat.slot_bytes"] = batches * 6_673_671_680
    return {"spanned": {"spans": spans, "cycles": 1, "counters": counters,
                        "batch_keys": [(0, i) for i in range(batches)]},
            "lean": {"spans": spans, "device": [(0, 5 * ms), (8 * ms, 30 * ms)]}}


def _context(program):
    """A traced run's whole context, made up, around ``program``."""
    window = {"seconds": 10.0, "items": 2 * 90941, "cycles": 2, "rate": 18188.2,
              "train_batches": 182, "failed_batches": 0, "eval_s": [0.5, 0.6],
              "train_s": [4.0, 4.1], "truncated_ids": 182 * 28_900, "peak_bytes": 20 << 30}
    kernels = {k: {"launches": 1, "booked": 1, "device_s": 1e-3, "paired": [(1e9, 0.0, 1e-3)]}
               for k in ("gather_rows", "gather_sum", "adagrad")}
    trace = {"window_s": 5.0, "busy_s": 4.0, "device_ops": 40_000, "train_ops": 36_400,
             "train_batches": 91, "kernels": kernels, "breakdown": {}}
    return {"window": window, "trace": trace, "flops": {"train_batch": 6e11, "evaluation": 1e13},
            "rates": (3.35e12, 67e12), "chips": 1, "memory_peak_bytes": 20 << 30,
            "program": program}


def test_the_gat_readers_read_their_span_and_counter():
    ctx = {"program": _program(True)}
    assert spec.reader("slot_gib_per_batch.gat")(ctx) == pytest.approx(
        6_673_671_680 / float(1 << 30))
    assert spec.reader("slot_gib_per_batch.gat")(ctx) == pytest.approx(6.2153, abs=1e-4)
    # three 2 ms layers a training batch; the evaluation's is not counted
    assert spec.reader("gat_ms_per_batch.gat")(ctx) == pytest.approx(6.0)
    for program in (_program(False), None):
        for name in NEW:
            assert spec.reader(name)({"program": program}) is None
    counters = _program(True)
    counters["spanned"]["counters"]["train.batches"] = 0
    assert all(spec.reader(name)({"program": counters}) is None for name in NEW)


@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark_spec()["workloads"]])
def test_every_reader_on_a_program_without_the_gat_spans(workload):
    """Where the program has only the older spans and counters (the parent
    of the GAT spans), every metric a cell reports is a number or None, and
    the GAT metrics None."""
    ctx = _context(_program(False))
    for m in spec.metrics_of(workload, "per_layer"):
        value = spec.reader(m["name"])(ctx)
        assert value is None or math.isfinite(float(value)), m["name"]
        if m["name"] in NEW:
            assert value is None
    if workload == CELL:
        full = _context(_program(True))
        assert all(spec.reader(name)(full) > 0 for name in NEW)


def _tiny(seed=5, fault=None, trace=False):
    torch.set_num_threads(2)
    return cycles.run_cell(CELL, seed, 0.2, trace, "cpu", time.perf_counter(), sizes=TINY,
                           fault=fault)


def test_the_small_cell_is_correct_and_counts_its_slot_blocks():
    ctx = _tiny(trace=True)
    assert ctx["correct"], ctx["lines"]
    assert set(ctx["numbers"]) == set(spec.limits(CELL))
    assert ctx["window"]["cycles"] >= 1 and ctx["window"]["rate"] > 0
    assert spec.reader("slot_gib_per_batch.gat")(ctx) == pytest.approx(
        TINY_SLOT_BYTES / float(1 << 30))
    assert spec.reader("gat_ms_per_batch.gat")(ctx) > 0
    assert ctx["flops"]["train_batch"] > 0 and ctx["flops"]["evaluation"] > 0


@pytest.mark.parametrize("fault", sorted(of_task("nc_gat")))
def test_a_planted_fault_is_not_correct(fault):
    ctx = _tiny(fault=of_task("nc_gat")[fault])
    assert not ctx["correct"], ctx["lines"]


def test_the_control_is_not_correct():
    dev = torch.device("cpu")
    torch.set_num_threads(2)
    tmp = tempfile.mkdtemp()
    try:
        p = cycles.prepare(CELL, 9, dev, tmp, TINY)
        p.rec = p.task.as_control(p.rec, p.config, p.data, p.weights, dev)
        numbers = cycles.check(p, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct, lines = compare.judge(numbers, spec.limits(CELL))
    assert not correct, lines


def test_the_update_gaps_leave_out_the_output_layers_a_l_alone():
    for sizes in (None, TINY):
        model = cycles.cell_config(CELL, sizes)["config"]["marius_config"]["model"]
        assert nc_gat._cancelled(model) == ["encoder.3.0.a_l"]


def test_the_model_flops_of_one_layer():
    # FEATURE 4 with a bias, then one GAT layer of 2 heads of 3 (concatenated)
    # from 4: 2 targets with 3 valid neighbour slots, 5 source rows
    model = {"encoder": {"layers": [[{"type": "FEATURE", "output_dim": 4, "bias": True}],
                                    _gat(4, 2, 3, False, "RELU")]}}
    hops = [{"rows": 2, "slots": 3}, {"rows": 5, "slots": 0}]
    projection, logit_vectors = 2 * 5 * 4 * 2 * 3, 2 * 2 * 3 * (5 + 2)
    per_slot = (3 + 2) * (5 * 2 + 2 * 2 * 3)
    per_target, feature_bias = 2 * (2 * 6), 5 * 4
    assert nc_gat.gat_flops(model, hops) == (projection + logit_vectors + per_slot + per_target
                                             + feature_bias)
