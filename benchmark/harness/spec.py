"""Finding a cell's files by the names in ``BENCHMARK.json``.

- ``BENCHMARK.json`` at the root of the checkout names each workload's
  configuration and traffic mix;
- ``benchmark/configs/<config>.json``: the configuration as it is run;
- ``benchmark/cells/<traffic>.json``: the traffic mix, data that the one
  runner (``harness/cycles.py``) reads;
- ``benchmark/limits/<workload>.json``: each number that decides
  ``correct``, with its limit and the readings it was set from;
- ``benchmark/metrics/<metric>.py``: each per-layer metric's reader, a
  ``read(ctx)`` that returns the value or None. A metric named
  ``<base>.<suffix>`` (``eval_s.lp``, ``eval_s.nc``) with no file of its
  own is read by ``benchmark/metrics/<base>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, spec: Dict = None) -> Dict:
    spec = spec or benchmark_spec()
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    return load_json(BENCH / "cells" / f"{name}.json")


def limits(workload_name: str) -> Dict[str, Dict]:
    return load_json(BENCH / "limits" / f"{workload_name}.json")["numbers"]


def metrics_of(workload_name: str, kind: str, spec: Dict = None) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this workload reports:
    those that list it, or list no workloads at all."""
    spec = spec or benchmark_spec()
    return [m for m in spec[kind] if workload_name in m.get("workloads", [workload_name])]


def reader(metric_name: str):
    """The ``read`` function of ``benchmark/metrics/<metric_name>.py``, or
    of ``benchmark/metrics/<base>.py`` for ``<base>.<suffix>``."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    base = BENCH / "metrics" / f"{metric_name.rsplit('.', 1)[0]}.py"
    if not path.exists() and "." in metric_name and base.exists():
        path = base
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
