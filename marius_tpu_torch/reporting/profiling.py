"""Profiling and tracing hooks: the program's spans and counters, and the
operator profiler.

Port of ``marius_tpu/reporting/profiling.py`` on ``torch.profiler``. The
reference has only wall-clock Timers + per-epoch edges/s logs (SURVEY §5:
common/util.h:10, trainer.cpp:69-72). `trace()` records CPU and CUDA
activity and writes it as a gzipped Chrome trace, ``*.trace.json.gz`` under
the log directory (viewable in Perfetto or TensorBoard), so `op_breakdown()`
reads the same layout as the JAX package's: it sums the durations of the
trace's complete events by name.

**The tracer.** The training and evaluation loops open spans at their layer
boundaries (``span(name)``) and count events (``count(name)``):

- ``train.epoch``, ``train.batch`` (keyed by (epoch, batch)),
  ``train.readback``; inside a batch step ``negatives``, ``unique``,
  ``sample``, ``gather``, ``forward``, ``backward``, ``sparse_update`` and
  ``dense_update``; out of core ``state.prep`` / ``state.swap``,
  ``state.graph`` and ``state.train`` per buffer state;
- ``eval.evaluate``, ``eval.batch`` and ``eval.readback``;
- the counters ``train.batches``, ``eval.batches`` and ``host_syncs``.

Off (the default), ``span`` tests one module flag and returns one shared
no-op object, and ``count`` returns: nothing is recorded, launched or
synchronised. ``recording()`` turns the tracer on and hands back the
:class:`Log`. Each span is stamped with ``time.time_ns()``, the clock of
``torch.profiler``'s (kineto's) event times, so spans and a profiler's
device intervals can be laid on one timeline. Inside ``trace()`` each span
also opens ``torch.profiler.record_function(name)``, so an operator's trace
carries the program's layer names. No profiler turns the tracer on by
itself.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch

#: the start of the warning that ``torch.cuda.set_sync_debug_mode("warn")``
#: raises for a synchronising operation
SYNC_WARNING = "called a synchronizing CUDA operation"

_on = False            # the one flag span() and count() test
_marks = False         # inside trace(): spans open record_function marks too
_log: Optional["Log"] = None
_last: Optional["Log"] = None
_local = threading.local()   # each thread's stack of open span indices


class Span:
    """One span of the log: its name, the index of its parent in the log
    (-1 at the top), its start and end in ``time.time_ns()`` nanoseconds,
    an optional key (a ``train.batch`` span's (epoch, batch)) and the
    counts recorded while it was the innermost open span."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "key", "counts", "_index", "_mark")

    def __init__(self, name: str, key=None):
        self.name, self.key = name, key
        self.parent, self.start_ns, self.end_ns = -1, 0, 0
        self.counts: Optional[Dict[str, int]] = None
        self._mark = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        stack = _stack()
        log = _log
        self._index = len(log.spans)
        self.parent = stack[-1] if stack else -1
        log.spans.append(self)
        stack.append(self._index)
        self.start_ns = time.time_ns()
        if _marks:
            self._mark = torch.profiler.record_function(self.name)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._mark is not None:
            self._mark.__exit__(*exc)
            self._mark = None
        self.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] == self._index:
            stack.pop()
        elif self._index in stack:
            # a span closed out of order (a generator closed late)
            stack.remove(self._index)
        return False


class _Off:
    """The shared no-op span of the tracer when it is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, key=None):
    """A context manager round one layer's work: a :class:`Span` while the
    tracer is on, else the shared no-op."""
    if not _on:
        return _OFF
    return Span(name, key)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (and to the innermost open span's
    count) while the tracer is on."""
    if _on:
        _log.add(name, n)


class Log:
    """What one recording holds: the spans in the order they opened, and
    the counters' totals."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = collections.Counter()

    def add(self, name: str, n: int = 1) -> None:
        self.counts[name] += n
        stack = _stack()
        if stack:
            s = self.spans[stack[-1]]
            if s.counts is None:
                s.counts = collections.Counter()
            s.counts[name] += n


def counters(mesh=None) -> Dict[str, int]:
    """One snapshot: the active (else the last) recording's counters, the
    kernels' launch counters and, given a mesh, its collectives."""
    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum, sampler

    log = _log if _log is not None else _last
    out = dict(log.counts) if log is not None else {}
    out.update({"gather.launches": gather.launches, "nbr_sum.launches": nbr_sum.launches,
                "adagrad.launches": adagrad.launches, "sampler.launches": sampler.launches})
    if mesh is not None:
        out["mesh.collectives"] = mesh.collectives
    return out


@contextlib.contextmanager
def recording(sync_debug: Optional[bool] = None):
    """Turn the tracer on for the block and hand back its :class:`Log`.
    Inside a recording it hands back the active log and changes nothing.

    With ``sync_debug`` (default: when CUDA is available) it also sets
    ``torch.cuda.set_sync_debug_mode("warn")`` and counts each
    synchronising-operation warning as ``host_syncs``, against the
    innermost open span; the warnings' text is swallowed and the mode found
    is restored on exit. What torch's build does not warn for is not
    counted: ``memcpy_and_sync`` (a read-back, a synchronous host-to-device
    copy) and stream synchronisations warn in the builds this port runs on.
    """
    global _on, _log, _last
    if _on:
        yield _log
        return
    if sync_debug is None:
        sync_debug = torch.cuda.is_available()
    log = Log()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                if _log is log:
                    log.add("host_syncs")
                return
            shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        mode = torch.cuda.get_sync_debug_mode() if sync_debug else None
        _log, _on = log, True
        try:
            if sync_debug:
                torch.cuda.set_sync_debug_mode("warn")
            yield log
        finally:
            if sync_debug:
                torch.cuda.set_sync_debug_mode(mode)
            _on, _log, _last = False, None, log
            _local.stack = []


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block's CPU and CUDA activity into
    ``<log_dir>/<host>_<pid>.<ms>.pt.trace.json.gz``, with the tracer on and
    each span marked in the trace; yields the tracer's :class:`Log`.
    ``device`` None means the GPU and raises without one; ``"cpu"`` records
    CPU activity only."""
    from marius_tpu_torch.train.trainer import resolve_device

    global _marks
    activities = [torch.profiler.ProfilerActivity.CPU]
    on_card = resolve_device(device).type == "cuda"
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json.gz"
    marks = _marks
    with torch.profiler.profile(activities=activities) as prof:
        with recording(sync_debug=on_card) as log:
            _marks = True
            try:
                yield log
            finally:
                _marks = marks
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
