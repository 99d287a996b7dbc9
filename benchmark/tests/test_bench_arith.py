"""The yardstick's arithmetic on hand-made inputs: kernel bytes and
operations, roofline shares, the device's busy union and idle gaps, a
made-up trace reduced to per-layer numbers, and the readers over it."""

from __future__ import annotations

import bench_tiny  # noqa: F401
import pytest

from benchmark.harness import arith, readers, spec, tracing

RATES = (1e12, 1e13)   # 1 TB/s, 10 TFLOP/s


def test_kernel_costs():
    # 3 distinct rows of d 4 in float32, 5 int64 ids, 5 rows written
    assert arith.gather_rows_cost(3, 5, 4, 4, 8) == (3 * 16 + 5 * 8 + 5 * 16, 0.0)
    # 2 distinct rows, 6 valid of 8 slots, 2 tasks, 3 sums of d 4
    nbytes, ops = arith.gather_sum_cost(2, 6, 8, 2, 3, 4, 4)
    assert nbytes == 2 * 16 + 8 * 4 + 2 * 16 + 3 * 16 and ops == 24.0
    # 7 valid rows of 10 ids, d 50 in float32, int64 ids
    assert arith.adagrad_cost(7, 10, 50, 4, 8) == (5 * 7 * 50 * 4 + 80, 7.0 * 7 * 50)


def test_roofline_share_and_bound():
    assert arith.bound_s(2e12, 0.0, RATES) == 2.0
    assert arith.bound_s(1e9, 1e14, RATES) == 10.0
    # two launches, least times 1 s and 2 s, device times 2 s and 6 s
    assert arith.roofline_share([(1e12, 0, 2.0), (0, 2e13, 6.0)], RATES) == pytest.approx(37.5)
    assert arith.roofline_share([], RATES) is None


def test_union_clip_and_gaps():
    busy = arith.union([(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)])
    assert busy == [(0, 3), (5, 9), (12, 13)]
    assert arith.clip(busy, 1, 12.5) == [(1, 3), (5, 9), (12, 12.5)]
    assert arith.gaps(busy, 0, 15) == [(3, 5), (9, 12), (13, 15)]
    assert arith.gaps([], 0, 1) == [(0, 1)]


def synthetic_trace():
    """A 100 ns window: an epoch span [0, 60) holding two batch steps, an
    evaluation [60, 100); five device operations, two of them the gather
    kernel and one the gather-sum, one starting before the window."""
    s = tracing.SPAN
    events = [(s + "traced_window", "span", 0, 100),
              (s + "train_epoch", "span", 0, 60),
              (s + "batch_step", "span", 0, 30), (s + "batch_step", "span", 30, 30),
              (s + "evaluate", "span", 60, 40),
              ("void gather_rows_kernel<float>", "device", 5, 10),
              ("elementwise", "device", 10, 10),
              ("void gather_rows_kernel<float>", "device", 40, 5),
              ("void gather_sum_kernel<float>", "device", 70, 10),
              ("before", "device", -10, 5)]
    costs = {"gather_rows": [(1000.0, 0.0), (500.0, 0.0)], "gather_sum": [None]}
    return events, costs


def test_summarise_a_synthetic_trace():
    events, costs = synthetic_trace()
    t = tracing.summarise(events, costs, train_batches=2)
    assert t["window_s"] == pytest.approx(100e-9)
    assert t["busy_s"] == pytest.approx(30e-9)          # [5, 20) + [40, 45) + [70, 80)
    assert t["train_ops"] == 3 and t["device_ops"] == 4
    g = t["kernels"]["gather_rows"]
    assert g["launches"] == 2 and [p[2] for p in g["paired"]] == pytest.approx([10e-9, 5e-9])
    assert t["kernels"]["gather_sum"]["paired"] == []   # its one launch was not booked
    assert t["breakdown"]["device_ops"][0][0] == "void gather_rows_kernel<float>"
    longest = t["breakdown"]["idle_gaps"][0]
    # the gap [45, 70) lies in the second batch step
    assert longest[0] == tracing.SPAN + "batch_step" and longest[1] == pytest.approx(25e-9)
    assert len(t["breakdown"]["idle_gaps"]) <= 10


def test_readers_over_a_synthetic_context():
    events, costs = synthetic_trace()
    t = tracing.summarise(events, costs, train_batches=2)
    t["cycles"] = 1
    ctx = {"trace": t, "rates": RATES, "chips": 1,
           "flops": {"train_batch": 1e3, "evaluation": 5e2},
           "window": {"eval_s": [0.5, 0.7], "train_batches": 4, "truncated_ids": 10,
                      "peak_bytes": 1 << 30, "seconds": 2e-7, "cycles": 2}}
    assert readers.device_idle(ctx) == pytest.approx(70.0)
    assert readers.device_ops_per_batch(ctx) == pytest.approx(1.5)
    assert readers.eval_s(ctx) == pytest.approx(0.6)
    assert readers.truncated_ids_per_batch(ctx) == 2.5
    assert readers.peak_device_gib(ctx) == 1.0
    # the untraced window's 4 batches and 2 evaluations, (4 x 1e3 + 2 x 5e2)
    # FLOPs over its 200 ns at 10 TFLOP/s, whatever the traced cycle took
    assert readers.mfu(ctx) == pytest.approx(100.0 * 5e3 / 2e-7 / 1e13)
    assert readers.mfu(dict(ctx, flops=None)) is None
    # least times 1 ns and 0.5 ns over 15 ns of device time
    assert readers.roofline(ctx, "gather_rows") == pytest.approx(10.0)
    assert readers.roofline(ctx, "gather_sum") is None
    assert readers.roofline({"trace": None}, "adagrad") is None
    assert spec.reader("gather_rows_roofline.nc")(ctx) == pytest.approx(10.0)
    assert spec.reader("gather_rows_roofline.lp")(ctx) == pytest.approx(10.0)
