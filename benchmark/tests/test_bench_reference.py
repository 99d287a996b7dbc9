"""The plain reference against the port on the CPU, at a size a test run
holds, through the whole runner; each fault a cell can have, planted
underneath the run, and the control (the reference one precision below,
TF32, in the program's place) must come out not correct."""

from __future__ import annotations

import math
import shutil
import tempfile

import bench_tiny
import pytest
import torch

from benchmark.harness import compare, cycles, spec
from benchmark.harness.faults import of_task

WORKLOADS = list(bench_tiny.SIZES)
#: every (workload, fault) that the workload's task can have
PLANTED = [(w, f) for w in WORKLOADS
           for f in sorted(of_task(cycles.cell_config(w)["config"]["task"]))]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_reference_agrees_with_the_port(workload):
    ctx = bench_tiny.run_tiny(workload)
    assert ctx["correct"], ctx["lines"]
    assert set(ctx["numbers"]) == set(spec.limits(workload))
    assert all(math.isfinite(v) for v in ctx["numbers"].values())
    assert ctx["window"]["cycles"] >= 1 and ctx["window"]["rate"] > 0


@pytest.mark.parametrize("workload,fault", PLANTED)
def test_a_planted_fault_is_not_correct(workload, fault):
    task = cycles.cell_config(workload)["config"]["task"]
    ctx = bench_tiny.run_tiny(workload, fault=of_task(task)[fault])
    assert not ctx["correct"], ctx["lines"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    dev = torch.device("cpu")
    torch.set_num_threads(2)
    tmp = tempfile.mkdtemp()
    try:
        p = cycles.prepare(workload, 9, dev, tmp, bench_tiny.SIZES[workload])
        p.rec = p.task.as_control(p.rec, p.config, p.data, p.weights, dev)
        numbers = cycles.check(p, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct, lines = compare.judge(numbers, spec.limits(workload))
    assert not correct, lines
