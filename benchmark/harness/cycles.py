"""The one runner: a Marius training job's cycles (an epoch, then the
validation evaluation), as ``marius_train`` runs them, on the program's own
runtime.

Set-up writes the cell's dataset from the seed under ``TMPDIR``, builds the
runtime with ``marius_init``, installs the initial weights the benchmark
drew from the seed, and runs one warm-up cycle, which compiles nothing but
touches every shape the window uses; its first steps and its evaluation are
recorded for the check (``tasks/<task>.py``). The window then runs whole
cycles until ``seconds`` have passed; the rate is over all of its time,
evaluations included. A traced run then runs one more cycle under the
profiler (``tracing.py``). Last, with the program's state freed,
the reference checks what was recorded.
"""

from __future__ import annotations

import copy
import gc
import importlib
import math
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from benchmark.harness import compare, program, spec

def merge(base: Dict, over: Dict) -> Dict:
    """``base`` with ``over``'s keys set, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def cell_config(workload_name: str, sizes: Optional[Dict] = None) -> Dict:
    """The configuration as the cell runs it: the configuration file with
    the traffic mix's changes, and ``sizes`` (a smaller copy for the CPU
    tests) over both."""
    w = spec.workload(workload_name)
    cfg = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    cfg = merge(cfg, {"marius_config": traffic.get("marius_config", {})})
    if sizes:
        cfg = merge(cfg, sizes)
    return {"workload": w, "config": cfg, "traffic": traffic}


class Prepared:
    """A cell after set-up: the program's runtime after its warm-up cycle,
    what the check recorded there, and what the check needs besides."""

    def __init__(self, cell, task, data, weights, rt, rec, split, undo=None):
        self.cell, self.task, self.data, self.weights = cell, task, data, weights
        self.rt, self.rec, self.split, self.undo = rt, rec, split, undo
        self.config = cell["config"]


def prepare(workload_name: str, seed: int, device, tmp: str, sizes: Optional[Dict] = None,
            fault: Optional[Callable] = None) -> Prepared:
    """Set-up: the dataset from the seed written under ``tmp``, the runtime,
    the seeded initial weights, and one recorded warm-up cycle.
    ``fault(rt)``, for the tests, breaks the program underneath once its
    runtime exists and returns the patches that undo it."""
    cell = cell_config(workload_name, sizes)
    cfg = cell["config"]
    task = importlib.import_module(f"benchmark.harness.tasks.{cfg['task']}")
    data_gen = importlib.import_module(f"benchmark.data.{cfg['dataset']['generator']}")
    dev = torch.device(device)
    marks = [("start", time.perf_counter())]
    data = data_gen.generate(cfg["dataset"], seed)
    marks.append(("data", time.perf_counter()))
    raw = copy.deepcopy(cfg["marius_config"])
    raw.setdefault("storage", {}).setdefault("dataset", {})["dataset_dir"] = f"{tmp}/dataset"
    raw.setdefault("training", {})["seed"] = int(seed) % (1 << 31)
    program.write_dataset(f"{tmp}/dataset", data)
    marks.append(("write", time.perf_counter()))
    rt = program.init_runtime(raw, f"{tmp}/model", dev)
    marks.append(("marius_init", time.perf_counter()))
    weights = program.make_weights(task.param_shapes(cfg, data), cfg["init"], seed, dev)
    program.install_weights(rt.trainer.state, weights)
    weights = {k: v.cpu() for k, v in weights.items()}
    undo = fault(rt) if fault is not None else None
    rec = task.Recorder(rt, seed)
    try:
        cycle(rt)
    finally:
        rec.stop()
    marks.append(("warm_up_cycle", time.perf_counter()))
    if not rec.complete():
        raise RuntimeError("the warm-up cycle did not reach the steps the check records")
    split = {name: t - prev for (_, prev), (name, t) in zip(marks, marks[1:])}
    return Prepared(cell, task, data, weights, rt, rec, split, undo)


def check(p: Prepared, dev, mode: str = "f32") -> Dict[str, float]:
    """The numbers that decide ``correct``, the reference computed in
    ``mode`` once the program's state is freed."""
    from benchmark.reference.common import Precision

    if p.undo is not None:
        p.undo.restore()
        p.undo = None
    p.rt = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with Precision(mode) as prec:
        return p.task.numbers(p.rec, p.config, p.data, p.weights, prec, dev)


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool, device,
             started: float, sizes: Optional[Dict] = None,
             fault: Optional[Callable] = None) -> Dict:
    """One run of a cell. ``started`` is the process's start on
    ``time.perf_counter``'s clock."""
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="marius-bench-")
    try:
        t_cell = time.perf_counter()
        p = prepare(workload_name, seed, dev, tmp, sizes, fault)
        setup_peak = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - started
        split = dict(process_start_to_cell=t_cell - started, **p.split)

        window = run_window(p.rt, seconds, p.task.RATE[2], dev)
        ctx = {"window": window, "memory_peak_bytes": max(setup_peak, window["peak_bytes"]),
               "cell": p.cell, "task": p.task, "data": p.data, "seed": seed,
               "setup_split": split}
        if trace:
            from benchmark.harness import tracing

            ctx["trace"] = tracing.traced_cycles(p.rt, p.task, dev)
            ctx["flops"] = p.task.flops(p.config, p.data, seed, dev)
        t0 = time.perf_counter()
        numbers = check(p, dev)
        ctx["check_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    limits = spec.limits(workload_name)
    correct, lines = compare.judge(numbers, limits)
    ctx.update(setup_s=setup_s, numbers=numbers, correct=correct, lines=lines,
               compared=compare.compared(numbers, limits))
    return ctx


def cycle(rt) -> Dict:
    """One epoch and, where the configuration has one, the validation
    evaluation (``epochs_per_eval`` is 1 in every cell)."""
    t0 = time.perf_counter()
    stats = rt.trainer.train_epoch()
    t1 = time.perf_counter()
    if rt.valid_evaluator is not None:
        rt.valid_evaluator.evaluate(rt.trainer.state)
    t2 = time.perf_counter()
    return {"stats": stats, "train_s": t1 - t0, "eval_s": t2 - t1}


def run_window(rt, seconds: float, items_key: str, dev) -> Dict:
    """Whole cycles until ``seconds`` have passed. Every cycle ends in the
    evaluation's read-back, so the clock covers the device's work."""
    cycles = []
    t0 = time.perf_counter()
    while True:
        cycles.append(cycle(rt))
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    items = sum(c["stats"][items_key] for c in cycles)
    failed = sum(rt.trainer.num_batches for c in cycles
                 if not math.isfinite(c["stats"]["loss"]))
    batches = len(cycles) * rt.trainer.num_batches
    return {"seconds": elapsed, "items": items, "cycles": len(cycles),
            "rate": items / elapsed, "train_batches": batches, "failed_batches": failed,
            "eval_s": [c["eval_s"] for c in cycles],
            "train_s": [c["train_s"] for c in cycles],
            "truncated_ids": sum(c["stats"].get("truncated_frontier_ids", 0) for c in cycles),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)}
