"""The traced run's cycles: spans from the benchmark's own files around the
program's layer entry points, the kernels' launches booked with what they
move, and the profiler's device timeline reduced to per-layer numbers.

The spans (``record_function``, names ``bench/<entry>``) go round the epoch,
the evaluation, the batch step, the neighbour sampler, the encoder, the
dense optimizer and the three kernel wrappers, installed for the traced
cycles only and taken out after. A kernel wrapper's booking keeps the
launch's shapes and a reference to its ids, and counts the distinct rows
after the profiler has stopped, so the window holds no extra device work
and no synchronisation.

``summarise`` works on plain (name, kind, start_ns, duration_ns) events, so
the CPU tests drive it with a made-up trace.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.harness import arith, program
from benchmark.harness.cycles import cycle

SPAN = "bench/"
KERNELS = {"gather_rows": "gather_rows_kernel", "gather_sum": "gather_sum_kernel",
           "adagrad": "adagrad_kernel"}
#: cycles (an epoch and its evaluation) under the profiler in a traced run
TRACED_CYCLES = 1
#: what the booked kernels' ids may hold on the card at once, beyond which
#: later launches are counted but left out of the roofline
BOOKED_BYTES_CAP = 6 << 30


class KernelBook:
    """The launches of the program's three kernels, in launch order."""

    def __init__(self):
        self.launches: Dict[str, List[Dict]] = collections.defaultdict(list)
        self.held = 0

    def _keep(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        size = t.numel() * t.element_size()
        if self.held + size > BOOKED_BYTES_CAP:
            return None
        self.held += size
        return t

    def gather_rows(self, table, ids):
        n, d = table.shape
        if table.is_cuda and ids.shape[0] and d:
            self.launches["gather_rows"].append(
                {"n": n, "d": d, "elem": table.element_size(), "k": ids.shape[0],
                 "id_elem": ids.element_size(), "ids": self._keep(ids)})

    def gather_sum(self, x, layout):
        if x.is_cuda and layout.num_out and x.shape[1]:
            self.launches["gather_sum"].append(
                {"n": x.shape[0], "d": x.shape[1], "elem": x.element_size(),
                 "slots": layout.ids.numel(), "tasks": layout.task_start.shape[0],
                 "out_rows": layout.num_out, "ids": self._keep(layout.ids)})

    def adagrad(self, values, ids):
        if values.is_cuda and ids.shape[0] and values.shape[1]:
            self.launches["adagrad"].append(
                {"n": values.shape[0], "d": values.shape[1], "elem": values.element_size(),
                 "k": ids.shape[0], "id_elem": ids.element_size(), "ids": self._keep(ids)})

    def costs(self) -> Dict[str, List[Optional[Tuple[float, float]]]]:
        """(bytes, operations) of each launch in order; None where its ids
        were not kept."""
        out = {}
        for name, calls in self.launches.items():
            rows = []
            for c in calls:
                ids = c["ids"]
                if ids is None:
                    rows.append(None)
                    continue
                if name == "gather_rows":
                    distinct = int(torch.unique(ids.clamp(0, c["n"] - 1)).numel())
                    rows.append(arith.gather_rows_cost(distinct, c["k"], c["d"], c["elem"],
                                                       c["id_elem"]))
                elif name == "gather_sum":
                    valid = ids[(ids >= 0) & (ids < c["n"])]
                    rows.append(arith.gather_sum_cost(int(torch.unique(valid).numel()),
                                                      int(valid.numel()), c["slots"],
                                                      c["tasks"], c["out_rows"], c["d"],
                                                      c["elem"]))
                else:
                    valid = int(((ids >= 0) & (ids < c["n"])).sum())
                    rows.append(arith.adagrad_cost(valid, c["k"], c["d"], c["elem"],
                                                   c["id_elem"]))
            out[name] = rows
        return out


def _spanned(name: str, fn, before=None):
    def wrapper(*args, **kwargs):
        if before is not None:
            before(*args)
        with torch.profiler.record_function(SPAN + name):
            return fn(*args, **kwargs)
    return wrapper


def install(rt, task, book: KernelBook) -> program.Patches:
    """Spans round the layer entry points and the kernel wrappers' booking."""
    from marius_tpu_torch.data.samplers import neighbor
    from marius_tpu_torch.nn import encoder, optimizers
    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum

    p = program.Patches()
    tr, ev = rt.trainer, rt.valid_evaluator
    p.set(tr, "train_epoch", _spanned("train_epoch", tr.train_epoch))
    step = task.step_name(tr)
    p.set(tr, step, _spanned("batch_step", getattr(tr, step)))
    if ev is not None:
        p.set(ev, "evaluate", _spanned("evaluate", ev.evaluate))
    for fn, name in ((neighbor.sample_neighbor_batch, "sample_neighbor_batch"),
                     (encoder.encoder_forward, "encoder_forward"),
                     (optimizers.apply_optimizer, "apply_optimizer")):
        p.everywhere(fn, _spanned(name, fn))
    p.everywhere(gather.gather_rows,
                 _spanned("gather_rows", gather.gather_rows, book.gather_rows))
    p.everywhere(nbr_sum.nbr_sum, _spanned("gather_sum", nbr_sum.nbr_sum, book.gather_sum))
    sparse = adagrad.sparse_adagrad_update_
    p.everywhere(sparse, _spanned("adagrad", sparse,
                                  lambda values, state, ids, *rest: book.adagrad(values, ids)))
    return p


def kineto_events(prof) -> List[Tuple[str, str, int, int]]:
    """(name, kind, start_ns, duration_ns): kind ``device`` for a kernel,
    copy or set on the card, ``span`` for the benchmark's host spans."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the spans' marks on the device timeline are not operations
            kind = getattr(e, "activity_type", None)
            if name.startswith(SPAN) or (
                    kind is not None and "annotation" in str(kind()).lower()):
                continue
            out.append((name, "device", e.start_ns(), e.duration_ns()))
        elif name.startswith(SPAN):
            out.append((name, "span", e.start_ns(), e.duration_ns()))
    return out


def traced_cycles(rt, task, dev, count: int = TRACED_CYCLES) -> Dict:
    """``count`` cycles under the profiler, summarised."""
    from torch.profiler import ProfilerActivity, profile

    book = KernelBook()
    patches = install(rt, task, book)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    try:
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(SPAN + "traced_window"):
                for _ in range(count):
                    cycle(rt)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
    finally:
        patches.restore()
    t0 = time.perf_counter()
    events = kineto_events(prof)
    out = summarise(events, book.costs(), count * rt.trainer.num_batches)
    out["parse_s"] = time.perf_counter() - t0
    out["cycles"] = count
    return out


def summarise(events: Sequence[Tuple[str, str, int, int]],
              costs: Dict[str, List[Optional[Tuple[float, float]]]],
              train_batches: int) -> Dict:
    """Per-layer readings of one traced window from its events (see
    ``kineto_events``) and the booked kernels' costs: the window, the busy
    union of the device's operations, operations per training batch, each
    kernel's launches with their device seconds, the longest operations and
    the longest idle gaps named by the innermost host span around them."""
    windows = [(s, s + d) for n, k, s, d in events if k == "span" and n == SPAN + "traced_window"]
    if not windows:
        raise ValueError("the trace holds no traced window span")
    lo, hi = windows[0]
    device = [(n, s, s + d) for n, k, s, d in events if k == "device" and s < hi and s + d > lo]
    busy = arith.union(arith.clip([(s, e) for _, s, e in device], lo, hi))
    busy_ns = sum(e - s for s, e in busy)
    spans = sorted(((s, s + d, n) for n, k, s, d in events
                    if k == "span" and n != SPAN + "traced_window"), key=lambda x: x[0])
    epochs = [(s, e) for s, e, n in spans if n == SPAN + "train_epoch"]
    train_ops = sum(1 for _, s, _ in device if any(a <= s < b for a, b in epochs))

    kernels = {}
    for short, marker in KERNELS.items():
        durations = [(e - s) * 1e-9 for n, s, e in sorted(device, key=lambda x: x[1])
                     if marker in n]
        booked = costs.get(short, [])
        paired = []
        if booked and len(booked) == len(durations):
            paired = [(c[0], c[1], t) for c, t in zip(booked, durations) if c is not None]
        kernels[short] = {"launches": len(durations), "booked": len(booked),
                          "device_s": sum(durations), "paired": paired}

    by_name = collections.Counter()
    for n, s, e in device:
        by_name[n] += (e - s) * 1e-9
    top_ops = [[n[:120], v] for n, v in by_name.most_common(10)]
    gap_list = sorted(arith.gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]

    def host_at(t):
        inside = [(e - s, n) for s, e, n in spans if s <= t < e]
        return min(inside)[1] if inside else SPAN + "traced_window"

    idle = [[host_at((s + e) / 2), (e - s) * 1e-9] for s, e in gap_list]
    return {"window_s": (hi - lo) * 1e-9, "busy_s": busy_ns * 1e-9,
            "device_ops": len(device), "train_ops": train_ops, "train_batches": train_batches,
            "kernels": kernels, "breakdown": {"device_ops": top_ops, "idle_gaps": idle}}
