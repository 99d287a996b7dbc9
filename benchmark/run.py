#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for (``BENCHMARK.json``). ``--trace 0`` measures the cell's end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` runs the same window,
then traced cycles, and reports the per-layer metrics. Either way the run
checks what the program computed against the plain reference and prints
each compared number beside its limit, as the last lines of standard error
and under ``compared`` in the result, the last line of standard output.

It exits non-zero, printing no result, without the cards the cell asks
for, or if JAX, Flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names a run must not load (compared whole: the port's
#: own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "marius_tpu")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def clean(x):
    """``x`` with every non-finite float as null, so the line stays JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [clean(v) for v in x]
    return x


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every kernel cache of the program at a fixed place inside the checkout
    cache = ROOT / "benchmark" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = str(ROOT)

    import torch

    from benchmark.harness import arith, spec

    bench = spec.benchmark_spec()
    work = spec.workload(args.workload, bench)
    chips = int(work["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if chips != 1:
        print(f"{args.workload} asks for {chips} cards; this harness runs one-card cells",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from benchmark.harness import cycles

    ctx = cycles.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                          STARTED)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4

    kind = torch.cuda.get_device_name(0)
    ctx.update(chips=chips, rates=arith.card_rates(kind))
    task, window = ctx["task"], ctx["window"]
    metrics = {}
    if args.trace:
        for m in spec.metrics_of(args.workload, "per_layer", bench):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        rate_name, rate_unit, _ = task.RATE
        metrics[rate_name] = {"value": window["rate"], "unit": rate_unit}
        metrics["setup_s"] = {"value": ctx["setup_s"], "unit": "s"}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(ctx["memory_peak_bytes"]),
              "power_limit": power_limit()}
    result = {"correct": bool(ctx["correct"]), "attempted": int(window["train_batches"]),
              "failed": int(window["failed_batches"]), "metrics": metrics, "device": device}
    if args.trace:
        t = ctx["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = t["breakdown"]
    result["compared"] = ctx["compared"]
    print("set-up split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in ctx["setup_split"].items())
          + f"; window {window['cycles']} cycles in {window['seconds']:.3f} s (epochs "
          + " ".join(f"{t:.3f}" for t in window["train_s"]) + "; evaluations "
          + " ".join(f"{t:.3f}" for t in window["eval_s"]) + f"); check {ctx['check_s']:.3f} s",
          file=sys.stderr)
    for line in ctx["lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(clean(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
