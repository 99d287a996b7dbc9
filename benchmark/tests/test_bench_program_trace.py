"""The readers of the program's own spans (``harness/program_trace.py``) on a
made-up ``ctx["program"]``, and both passes on the CPU at the small size."""

from __future__ import annotations

import sys
import time
import types

import bench_tiny
import pytest
import torch

from benchmark.harness import cycles, program_trace, spec


def _row(name, parent, start, end, syncs=0):
    return (name, parent, start, end, syncs)


def _made_up(batch_ms, sample_ms=(), syncs=(), device=(), lean=None):
    """Spans of one epoch of batches ``batch_ms`` long (ms), each with a
    ``sample`` child of ``sample_ms`` holding a ``gather`` child of 1 ms,
    then one evaluation batch with a ``sample`` of its own."""
    ms = 1_000_000
    spans, t = [_row("train.epoch", -1, 0, 0)], 0
    for i, b in enumerate(batch_ms):
        k = len(spans)
        spans.append(_row("train.batch", 0, t, t + int(b * ms), syncs[i] if syncs else 0))
        if sample_ms:
            spans.append(_row("sample", k, t, t + int(sample_ms[i] * ms)))
            spans.append(_row("gather", k + 1, t, t + ms))
        t += int(b * ms)
    spans.append(_row("train.readback", 0, t, t + ms, 1))
    spans[0] = _row("train.epoch", -1, 0, t + ms)
    ev = len(spans)
    spans.append(_row("eval.evaluate", -1, t + ms, t + 4 * ms))
    spans.append(_row("eval.batch", ev, t + ms, t + 4 * ms))
    spans.append(_row("sample", ev + 1, t + ms, t + 3 * ms))
    lean = {"spans": lean if lean is not None else spans, "device": list(device)}
    spanned = {"spans": spans, "cycles": 1,
               "counters": {"train.batches": len(batch_ms), "eval.batches": 1},
               "batch_keys": [(0, i) for i in range(len(batch_ms))]}
    return {"program": {"spanned": spanned, "lean": lean}}


def test_p95_is_the_nearest_rank():
    # 40 batches of 1..40 ms: rank ceil(0.95 * 40) = 38
    ctx = _made_up([float(i) for i in range(40, 0, -1)])
    assert program_trace.step_ms_p95(ctx) == pytest.approx(38.0)
    assert program_trace.step_ms_p95(_made_up([5.0])) == pytest.approx(5.0)
    assert program_trace.step_ms_p95(_made_up([])) is None


def test_sampler_time_is_self_time_inside_training_batches():
    # each sample holds a 1 ms gather: self time is sample_ms - 1; the
    # evaluation's sample is not a training batch's
    ctx = _made_up([10.0, 10.0, 10.0, 10.0], sample_ms=[3.0, 5.0, 2.0, 6.0])
    assert program_trace.sampler_ms_per_batch(ctx) == pytest.approx((2 + 4 + 1 + 5) / 4)
    spans = ctx["program"]["spanned"]["spans"]
    assert program_trace.self_ns(spans)[1] == 10_000_000 - 3_000_000
    per = program_trace.self_ms_per_batch(spans, 4)
    assert per["train.epoch/train.batch/sample"] == pytest.approx(3.0)
    assert per["train.epoch/train.batch/sample/gather"] == pytest.approx(1.0)
    assert per["train.epoch/train.batch"] == pytest.approx(10.0 - 4.0)


def test_syncs_are_counted_inside_the_epoch_over_its_batches():
    # 3 in the batches and 1 in the epoch's read-back, over 4 batches
    ctx = _made_up([1.0] * 4, syncs=[0, 2, 0, 1])
    assert program_trace.host_syncs_per_batch(ctx) == pytest.approx(4 / 4)
    spans = ctx["program"]["spanned"]["spans"]
    # a synchronisation outside any epoch is not the loop's
    spans.append(_row("outside", -1, 0, 1, 5))
    assert program_trace.host_syncs_per_batch(ctx) == pytest.approx(1.0)


def test_idle_is_the_union_clipped_to_the_window():
    ms = 1_000_000
    # the window: 0 .. 24 ms (two 10 ms batches, a 1 ms read-back, a 3 ms
    # evaluation); device work overlaps itself and spills past both ends
    device = [(-5 * ms, 2 * ms), (1 * ms, 4 * ms), (3 * ms, 6 * ms), (12 * ms, 15 * ms),
              (22 * ms, 30 * ms)]
    ctx = _made_up([10.0, 10.0], device=device)
    busy = 6 + 3 + 2   # 0..6, 12..15, 22..24
    assert program_trace.device_idle_lean(ctx) == pytest.approx(100.0 * (1 - busy / 24))
    spans = ctx["program"]["lean"]["spans"]
    idle = program_trace.idle_by_path(spans, device)
    assert sum(idle.values()) == (24 - busy) * ms
    assert idle == {"train.epoch/train.batch": (4 + 7) * ms,
                    "train.epoch/train.readback": 1 * ms,
                    "eval.evaluate/eval.batch/sample": 1 * ms}
    # no device intervals: nothing to read
    assert program_trace.device_idle_lean(_made_up([10.0])) is None


def test_the_breakdown_reads_the_counters_and_the_batch_keys():
    ctx = _made_up([3.0, 9.0, 1.0, 7.0], sample_ms=[2.0] * 4)
    ctx["program"]["spanned"]["counters"].update({"gather.launches": 12, "host_syncs": 1})
    b = program_trace.breakdown(ctx["program"], slowest=2)
    assert b["counters_per_cycle"] == {"eval.batches": 1, "gather.launches": 12,
                                       "host_syncs": 1, "train.batches": 4}
    assert b["slowest_batches"] == [[[0, 1], pytest.approx(9.0)], [[0, 3], pytest.approx(7.0)]]
    # the per-batch readings are over the train.batches counter
    ctx["program"]["spanned"]["counters"]["train.batches"] = 8
    assert program_trace.sampler_ms_per_batch(ctx) == pytest.approx(4 * 1.0 / 8)


def test_the_run_device_and_the_jax_check(monkeypatch):
    assert program_trace.run_device({"memory_peak_bytes": 0}).type == "cpu"
    assert program_trace.run_device({"memory_peak_bytes": 1 << 20}).type == "cuda"
    monkeypatch.setattr(program_trace, "measure", lambda ctx: {"made": "up"})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="loaded jax"):
        program_trace.measured({})
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "marius_tpu.train", types.ModuleType("marius_tpu.train"))
    with pytest.raises(RuntimeError, match="marius_tpu.train"):
        program_trace.measured({})
    monkeypatch.delitem(sys.modules, "marius_tpu.train")
    # the port's own name begins with the JAX package's: not refused
    assert program_trace.measured({}) == {"made": "up"}


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    monkeypatch.setattr(program_trace, "tracer", lambda: None)
    ctx = {}
    for name in ("step_ms_p95", "sampler_ms_per_batch", "host_syncs_per_batch",
                 "device_idle_lean"):
        assert program_trace.measured(ctx) is None
        assert spec.reader(f"{name}.nc")(ctx) is None
    assert ctx == {"program": None}


@pytest.mark.parametrize("workload", list(bench_tiny.SIZES))
def test_both_passes_on_the_cpu(workload, tmp_path):
    torch.set_num_threads(2)
    p = cycles.prepare(workload, 7, torch.device("cpu"), str(tmp_path), bench_tiny.SIZES[workload])
    nb = p.rt.trainer.num_batches
    out = program_trace.run(p.rt, torch.device("cpu"))
    spans = out["spanned"]["spans"]
    n = out["spanned"]["cycles"]
    assert n * nb >= program_trace.SPANNED_BATCHES > (n - 1) * nb
    batches = [i for i, r in enumerate(spans) if r[0] == "train.batch"]
    assert len(batches) == n * nb
    assert sum(1 for i, r in enumerate(spans)
               if r[0] == "sample" and program_trace.has_ancestor(spans, i, "train.batch")) == n * nb
    counts = out["spanned"]["counters"]
    assert counts["train.batches"] == n * nb and counts["eval.batches"] >= n
    assert {"gather.launches", "nbr_sum.launches", "adagrad.launches"} <= set(counts)
    assert sorted(out["spanned"]["batch_keys"])[:nb] == [
        (out["spanned"]["batch_keys"][0][0], i) for i in range(nb)]
    ctx = {"program": out}
    assert program_trace.step_ms_p95(ctx) > 0
    assert 0 < program_trace.sampler_ms_per_batch(ctx) < program_trace.step_ms_p95(ctx)
    assert program_trace.host_syncs_per_batch(ctx) == 0   # no card: nothing to count
    lean = out["lean"]
    assert lean["device"] == [] and program_trace.window(lean["spans"]) is not None
    assert sum(1 for r in lean["spans"] if r[0] == "train.batch") == nb
    # on the CPU every moment of the lean window is idle, nearly all of it
    # under a span (between the epoch and the evaluation, none is open)
    b = program_trace.breakdown(out)
    idle_ms = sum(b["idle_ms_by_path"].values())
    assert idle_ms == pytest.approx(b["lean_window_s"] * 1e3)
    assert b["idle_ms_by_path"].get("(no span)", 0) < 0.01 * idle_ms
    assert b["idle_share_under_batches"] > 0.5
    assert b["host_syncs_by_path"] == {}
    assert b["counters_per_cycle"]["train.batches"] == nb
    assert len(b["slowest_batches"]) == min(10, n * nb)
    assert sum(b["self_ms_per_batch"].values()) == pytest.approx(
        sum(e - s for n, _, s, e, _ in spans if n == "train.batch") * 1e-6 / (n * nb))


def test_the_readers_measure_a_run_once():
    ctx = bench_tiny.run_tiny("fb15k237_gs1.train", trace=True)
    assert ctx["correct"]
    t0 = time.perf_counter()
    values = {m["name"]: spec.reader(m["name"])(ctx)
              for m in spec.metrics_of("fb15k237_gs1.train", "per_layer")
              if m["name"].split(".")[0] in ("step_ms_p95", "sampler_ms_per_batch",
                                             "host_syncs_per_batch", "device_idle_lean")}
    assert time.perf_counter() - t0 < 120
    assert set(values) == {"step_ms_p95.lp", "sampler_ms_per_batch.lp",
                           "host_syncs_per_batch.lp", "device_idle_lean.lp"}
    assert values["step_ms_p95.lp"] > 0 and values["sampler_ms_per_batch.lp"] > 0
    assert values["host_syncs_per_batch.lp"] == 0
    assert values["device_idle_lean.lp"] is None   # no device on the CPU
    assert ctx["program"]["spanned"]["cycles"] >= 1
