"""Profiling and tracing hooks.

Port of ``marius_tpu/reporting/profiling.py`` on ``torch.profiler``. The
reference has only wall-clock Timers + per-epoch edges/s logs (SURVEY §5:
common/util.h:10, trainer.cpp:69-72). `trace()` records CPU and CUDA
activity and writes it as a gzipped Chrome trace, ``*.trace.json.gz`` under
the log directory (viewable in Perfetto or TensorBoard), so `op_breakdown()`
reads the same layout as the JAX package's: it sums the durations of the
trace's complete events by name. `EpochTimer` collects per-epoch throughput.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import time
from typing import Dict, List, Optional

import torch

from marius_tpu_torch.train.trainer import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block's CPU and CUDA activity into
    ``<log_dir>/<host>_<pid>.<ms>.pt.trace.json.gz``. ``device`` None means
    the GPU and raises without one; ``"cpu"`` records CPU activity only."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json.gz"
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, name))   # gzipped for a .gz path


def op_breakdown(log_dir: str, top: int = 20, category: Optional[str] = None) -> List[Dict]:
    """Aggregate op durations from the traces under log_dir; ``category``
    keeps only events of that trace category (torch names device kernels
    ``"kernel"``)."""
    events = []
    for f in glob.glob(f"{log_dir}/**/*.trace.json.gz", recursive=True):
        with gzip.open(f) as fh:
            events.extend(json.load(fh).get("traceEvents", []))
    agg = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e and category in (None, e.get("cat")):
            agg[e.get("name", "?")] += e["dur"]
    return [{"op": name, "total_us": dur} for name, dur in agg.most_common(top)]


class EpochTimer:
    """Per-epoch wall-clock + throughput collection (Timer, util.h:10 +
    trainer.cpp:69-72 edges/s logging)."""

    def __init__(self, item_name: str = "edges"):
        self.item_name = item_name
        self.epochs: List[Dict[str, float]] = []
        self._start: Optional[float] = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, num_items: int) -> Dict[str, float]:
        assert self._start is not None, "call start() first"
        dt = time.perf_counter() - self._start
        stats = {"epoch_time_s": dt,
                 f"{self.item_name}_per_sec": num_items / dt if dt > 0 else 0.0}
        self.epochs.append(stats)
        self._start = None
        return stats

    def summary(self) -> Dict[str, float]:
        if not self.epochs:
            return {}
        times = [e["epoch_time_s"] for e in self.epochs]
        rates = [e[f"{self.item_name}_per_sec"] for e in self.epochs]
        return {
            "num_epochs": len(self.epochs),
            "mean_epoch_time_s": sum(times) / len(times),
            "best_epoch_time_s": min(times),
            f"best_{self.item_name}_per_sec": max(rates),
        }
