"""The program's own spans and counters in a traced run
(``marius_tpu_torch.reporting.profiling``), and the per-layer metrics read
from them.

Two passes, each with the program's tracer on (``recording()``), which also
counts the host's synchronisations (``host_syncs``):

- **spanned cycles**: whole cycles (an epoch, then the validation
  evaluation) with no profiler, until at least ``SPANNED_BATCHES`` training
  batches have run, so that at least ten batch times lie beyond the p95;
- **one lean cycle** under ``torch.profiler`` with CUDA activity only. Its
  device intervals are laid on the program's spans, whose ``time.time_ns()``
  stamps are kineto's clock. The window runs from the first ``train.epoch``
  start to the last ``eval.evaluate`` end, and each idle stretch is put down
  to the innermost span open over it (``idle_by_path``).

A traced run reads its per-layer metrics once the check has freed the
program's runtime, so the first reader that asks (``measured(ctx)``) builds
one more from the run's seed and data as set-up builds it (the cell's
configuration, the seeded weights, one warm-up cycle) on the run's device,
runs the passes and keeps their raw spans in ``ctx["program"]``. As the
runner does after its own passes, it then refuses a process that loaded JAX,
Flax or the JAX package. A program without the tracer gives None there, and
each metric here is left out of the line.

A span is kept as (name, parent index, start_ns, end_ns, host_syncs); the
readers work on those tuples alone, so the CPU tests drive them with a
made-up ``ctx["program"]``. The spanned pass also keeps the program's
counters over its cycles (``counters()``: ``train.batches``, over which the
per-batch metrics are taken, ``eval.batches``, ``host_syncs`` and the
kernels' launches) and each ``train.batch`` span's (epoch, batch) key.

On a card, ``python3 -m benchmark.harness.program_trace --workload <name>
--seed <n>`` runs both passes after a cell's set-up and prints what the
metrics summarise (``breakdown``): host self time per training batch and the
lean cycle's idle time, each by span path, and the synchronisations by path.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import shutil
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.harness import arith, cycles, program
from benchmark.harness.cycles import cycle

#: training batches the spanned cycles run at least
SPANNED_BATCHES = 200
#: top-level modules a run must not load (``run.py``'s list)
FORBIDDEN = ("jax", "jaxlib", "flax", "marius_tpu")

Row = Tuple[str, int, int, int, int]


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from marius_tpu_torch.reporting import profiling
    except ImportError:
        return None
    return profiling if all(hasattr(profiling, f) for f in ("recording", "span", "counters")) \
        else None


def rows(log) -> List[Row]:
    return [(s.name, s.parent, s.start_ns, s.end_ns, (s.counts or {}).get("host_syncs", 0))
            for s in log.spans]


def run(rt, dev) -> Optional[Dict]:
    """Both passes on the program's runtime ``rt``."""
    prof = tracer()
    if prof is None:
        return None
    nb = rt.trainer.num_batches
    cycles = max(1, -(-SPANNED_BATCHES // nb))
    with prof.recording() as log:
        before = prof.counters()
        for _ in range(cycles):
            cycle(rt)
        after = prof.counters()
    spanned = {"spans": rows(log), "cycles": cycles,
               "counters": {k: v - before.get(k, 0) for k, v in after.items()},
               "batch_keys": [s.key for s in log.spans if s.name == "train.batch"]}
    del log
    return {"spanned": spanned, "lean": lean_cycle(rt, prof, dev)}


def lean_cycle(rt, prof, dev) -> Dict:
    """One cycle with the tracer on, under a profiler of the device's
    activity alone: its spans and the device's (start_ns, end_ns)."""
    if dev.type != "cuda":
        with prof.recording() as log:
            cycle(rt)
        return {"spans": rows(log), "device": []}
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import tracing

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        with prof.recording() as log:
            cycle(rt)
        torch.cuda.synchronize(dev)
    device = [(s, s + d) for _, kind, s, d in tracing.kineto_events(p) if kind == "device"]
    return {"spans": rows(log), "device": device}


def run_device(ctx: Dict) -> torch.device:
    """The device the run measured on: the runner reads the device's peak
    memory only on a card, where the program's weights make it above 0."""
    return torch.device("cuda" if ctx["memory_peak_bytes"] > 0 else "cpu")


def measure(ctx: Dict) -> Optional[Dict]:
    """The passes on a runtime built anew from ``ctx``'s cell, data and seed
    on the run's device: ``cycles.prepare``'s steps without regenerating the
    data, and without the check's recording, which would hold the warm-up's
    draws and states on the host for nothing."""
    if tracer() is None:
        return None
    dev = run_device(ctx)
    cfg, task, seed = ctx["cell"]["config"], ctx["task"], ctx["seed"]
    tmp = tempfile.mkdtemp(prefix="marius-bench-program-")
    rt = None
    try:
        raw = copy.deepcopy(cfg["marius_config"])
        raw.setdefault("storage", {}).setdefault("dataset", {})["dataset_dir"] = f"{tmp}/dataset"
        raw.setdefault("training", {})["seed"] = int(seed) % (1 << 31)
        program.write_dataset(f"{tmp}/dataset", ctx["data"])
        rt = program.init_runtime(raw, f"{tmp}/model", dev)
        program.install_weights(rt.trainer.state, program.make_weights(
            task.param_shapes(cfg, ctx["data"]), cfg["init"], seed, dev))
        cycle(rt)   # warm-up: every shape, the allocator's pools
        return run(rt, dev)
    finally:
        rt = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


def measured(ctx: Dict) -> Optional[Dict]:
    """``ctx["program"]``, measured by the first reader that asks."""
    if "program" not in ctx:
        ctx["program"] = measure(ctx)
        found = sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
        if found:
            raise RuntimeError(f"the program's spanned passes loaded {', '.join(found)}: "
                               "the benchmark runs the port alone")
    return ctx["program"]


# -- on the spans' tuples -------------------------------------------------------

def has_ancestor(spans: Sequence[Row], i: int, name: str) -> bool:
    """Whether span ``i`` is ``name`` or lies inside one."""
    while i >= 0:
        if spans[i][0] == name:
            return True
        i = spans[i][1]
    return False


def self_ns(spans: Sequence[Row]) -> List[int]:
    """Each span's duration less its children's."""
    out = [e - s for _, _, s, e, _ in spans]
    for _, parent, s, e, _ in spans:
        if parent >= 0:
            out[parent] -= e - s
    return out


def path(spans: Sequence[Row], i: int) -> str:
    names = []
    while i >= 0:
        names.append(spans[i][0])
        i = spans[i][1]
    return "/".join(reversed(names))


def innermost(spans: Sequence[Row]) -> List[Tuple[int, int, int]]:
    """(start_ns, end_ns, span index) stretches in which that span is the
    innermost one open; -1 where none is."""
    events = sorted([(s, 1, i) for i, (_, _, s, _, _) in enumerate(spans)]
                    + [(e, 0, i) for i, (_, _, _, e, _) in enumerate(spans)])
    out, stack, at = [], [], None
    for t, opens, i in events:
        if at is not None and t > at:
            out.append((at, t, stack[-1] if stack else -1))
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        at = t
    return out


def window(spans: Sequence[Row]) -> Optional[Tuple[int, int]]:
    """First ``train.epoch`` start to last ``eval.evaluate`` end."""
    starts = [s for n, _, s, _, _ in spans if n == "train.epoch"]
    ends = [e for n, _, _, e, _ in spans if n == "eval.evaluate"]
    if not starts or not ends or max(ends) <= min(starts):
        return None
    return min(starts), max(ends)


def idle_by_path(spans: Sequence[Row], device: Sequence[Tuple[int, int]]) -> Dict[str, int]:
    """Idle device nanoseconds of the lean window, by the path of the
    innermost span open over them."""
    win = window(spans)
    if win is None:
        return {}
    lo, hi = win
    busy = arith.union(arith.clip(device, lo, hi))
    out: Dict[str, int] = {}
    stretches, k = innermost(spans), 0
    # both lists are sorted and disjoint: one sweep
    for g0, g1 in arith.gaps(busy, lo, hi):
        while k < len(stretches) and stretches[k][1] <= g0:
            k += 1
        j = k
        while j < len(stretches) and stretches[j][0] < g1:
            s0, s1, i = stretches[j]
            a, b = max(g0, s0), min(g1, s1)
            if b > a:
                key = path(spans, i) if i >= 0 else "(no span)"
                out[key] = out.get(key, 0) + b - a
            j += 1
    return out


def self_ms_per_batch(spans: Sequence[Row], batches: int) -> Dict[str, float]:
    """Host self-time of each span path inside training batches, in ms per
    training batch."""
    if not batches:
        return {}
    selfs = self_ns(spans)
    out: Dict[str, float] = {}
    for i in range(len(spans)):
        if has_ancestor(spans, i, "train.batch"):
            key = path(spans, i)
            out[key] = out.get(key, 0.0) + selfs[i] * 1e-6 / batches
    return out


# -- the readers ----------------------------------------------------------------

def _spanned(ctx: Dict) -> Tuple[Sequence[Row], int]:
    """The spanned cycles' spans and their ``train.batches`` count."""
    p = measured(ctx)
    if not p:
        return [], 0
    return p["spanned"]["spans"], p["spanned"]["counters"].get("train.batches", 0)


def _batches(spans: Sequence[Row]) -> List[int]:
    return [e - s for n, _, s, e, _ in spans if n == "train.batch"]


def step_ms_p95(ctx: Dict) -> Optional[float]:
    """The p95 (nearest rank) of the spanned cycles' ``train.batch`` times."""
    spans, _ = _spanned(ctx)
    times = sorted(_batches(spans))
    if not times:
        return None
    return times[math.ceil(0.95 * len(times)) - 1] * 1e-6


def sampler_ms_per_batch(ctx: Dict) -> Optional[float]:
    """Self time of the ``sample`` spans inside training batches, over the
    training batches."""
    spans, batches = _spanned(ctx)
    if not batches:
        return None
    selfs = self_ns(spans)
    total = sum(selfs[i] for i, r in enumerate(spans)
                if r[0] == "sample" and has_ancestor(spans, i, "train.batch"))
    return total * 1e-6 / batches


def host_syncs_per_batch(ctx: Dict) -> Optional[float]:
    """Host synchronisations counted inside ``train.epoch``, over the
    training batches."""
    spans, batches = _spanned(ctx)
    if not batches:
        return None
    syncs = sum(r[4] for i, r in enumerate(spans) if r[4] and has_ancestor(spans, i, "train.epoch"))
    return syncs / batches


def device_idle_lean(ctx: Dict) -> Optional[float]:
    """Percent of the lean cycle's window in which no device operation ran."""
    p = measured(ctx)
    if not p or not p["lean"]["device"]:
        return None
    spans, device = p["lean"]["spans"], p["lean"]["device"]
    win = window(spans)
    if win is None:
        return None
    lo, hi = win
    busy = sum(e - s for s, e in arith.union(arith.clip(device, lo, hi)))
    return 100.0 * (1.0 - busy / (hi - lo))


def breakdown(out: Dict, slowest: int = 10) -> Dict:
    """Both passes by span path: host self ms per training batch, the lean
    cycle's idle ms and the share of it under a batch, and host_syncs; the
    counters per cycle, and the (epoch, batch) keys of the ``slowest``
    training batches."""
    spanned, lean = out["spanned"], out["lean"]
    spans, counts = spanned["spans"], spanned["counters"]
    idle = idle_by_path(lean["spans"], lean["device"])
    total = sum(idle.values())
    syncs: Dict[str, int] = {}
    for i, r in enumerate(spans):
        if r[4]:
            syncs[path(spans, i)] = syncs.get(path(spans, i), 0) + r[4]
    lo, hi = window(lean["spans"]) or (0, 0)
    under = sum(v for k, v in idle.items() if "train.batch" in k or "eval.batch" in k)
    keyed = sorted(zip(_batches(spans), spanned["batch_keys"]), key=lambda tk: -tk[0])
    return {"self_ms_per_batch": dict(sorted(
                self_ms_per_batch(spans, counts.get("train.batches", 0)).items(),
                key=lambda kv: -kv[1])),
            "lean_window_s": (hi - lo) * 1e-9,
            "idle_ms_by_path": {k: v * 1e-6 for k, v in sorted(idle.items(),
                                                              key=lambda kv: -kv[1])},
            "idle_share_under_batches": under / total if total else None,
            "host_syncs_by_path": syncs,
            "counters_per_cycle": {k: v / spanned["cycles"] for k, v in sorted(counts.items())},
            "slowest_batches": [[list(key), t * 1e-6] for t, key in keyed[:slowest]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The program's spans in one cell, by path.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="marius-bench-")
    try:
        p = cycles.prepare(args.workload, args.seed, dev, tmp)
        out = run(p.rt, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ctx = {"program": out}
    metrics = {f.__name__: f(ctx) for f in (step_ms_p95, sampler_ms_per_batch,
                                            host_syncs_per_batch, device_idle_lean)}
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(dev), "metrics": metrics,
                      **breakdown(out)}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
