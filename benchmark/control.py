#!/usr/bin/env python3
"""Readings behind the limits of ``correct``, at a cell's own size.

    python3 benchmark/control.py --workload <name> --seeds <s1,s2,...>
        [--controls <k>] [--faults all|<name,name,...>]

For each seed, in one process: the cell's set-up (its warm-up cycle records
what the check compares), then the numbers of the program against the
reference (the lower readings), on the first ``--controls`` seeds (all by
default) of the control against the reference (the control: the reference
itself one precision below the configuration's, TF32 in place of float32,
in the program's place: the upper readings), and with ``--faults`` of the
program with each named fault of ``harness/faults.py`` planted.
One JSON line per seed and reading; the last line holds, per number, the
largest program reading and the smallest control and fault readings.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seeds, faults, controls: int, device="cuda", sizes=None):
    """The readings of ``workload`` on each seed: the program's, the
    control's on the first ``controls`` seeds, and each fault's named in
    ``faults`` (all the cell's faults for ``["all"]``)."""
    import torch

    from benchmark.harness import cycles
    from benchmark.harness.faults import of_task

    dev = torch.device(device)
    known = of_task(cycles.cell_config(workload, sizes)["config"]["task"])
    runs = [("program", None)] + [(name, known[name])
                                  for name in (sorted(known) if faults == ["all"] else faults)]
    out = []
    for k, seed in enumerate(seeds):
        for kind, fault in runs:
            tmp = tempfile.mkdtemp(prefix="marius-control-")
            try:
                p = cycles.prepare(workload, seed, dev, tmp, sizes, fault)
                rec, task = p.rec, p.task
                out.append({"seed": seed, "reading": kind, "numbers": cycles.check(p, dev)})
                if kind == "program" and k < controls:
                    p.rec = task.as_control(rec, p.config, p.data, p.weights, dev)
                    out.append({"seed": seed, "reading": "control",
                                "numbers": cycles.check(p, dev)})
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            for r in out[-2 if out[-1]["reading"] == "control" else -1:]:
                print(json.dumps(r), flush=True)
    return out


def summary(out):
    """Per number: the largest program reading, the smallest of each other."""
    s = {}
    for r in out:
        for name, v in r["numbers"].items():
            agg = max if r["reading"] == "program" else min
            key = (name, r["reading"])
            s[key] = agg(s.get(key, v), v)
    table = {}
    for (name, reading), v in s.items():
        table.setdefault(name, {})[reading] = v
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=None,
                    help="read the control on this many of the first seeds (default: all)")
    ap.add_argument("--faults", default="", help="'all', or comma-separated fault names")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",")]
    out = readings(args.workload, seeds, [f for f in args.faults.split(",") if f],
                   len(seeds) if args.controls is None else args.controls)
    print(json.dumps({"summary": summary(out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
