"""The port's profiling hooks against the JAX package's, on the CPU.

``op_breakdown`` reads the same trace layout (``*.trace.json.gz`` anywhere
under the log directory) and gives the same list from one hand-written
trace; ``trace(device="cpu")`` writes a torch profiler trace that
``op_breakdown`` reads, and ``trace()`` needs a card.
"""

import gzip
import json

import pytest
import torch

from marius_tpu.reporting import profiling as jprof
from marius_tpu_torch.reporting import profiling as tprof
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _write_trace(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


@pytest.fixture
def traces(tmp_path):
    """Two trace files in JAX's layout: complete events ("X") of device
    kernels and host ops, and events op_breakdown must skip."""
    ev = []
    for i in range(30):
        ev.append({"ph": "X", "name": f"op{i % 7}", "cat": "kernel" if i % 2 else "cpu_op",
                   "dur": 1.5 * i + 0.25, "ts": i})
    ev += [{"ph": "B", "name": "op1", "ts": 0}, {"ph": "X", "name": "no_dur", "ts": 1},
           {"ph": "X", "dur": 3.0, "cat": "kernel"}, {"ph": "i", "name": "op2", "dur": 9.0}]
    _write_trace(tmp_path / "plugins" / "profile" / "run1" / "host.trace.json.gz", ev[:20])
    _write_trace(tmp_path / "host_2.pt.trace.json.gz", ev[20:])
    (tmp_path / "ignored.json").write_text(json.dumps({"traceEvents": ev}))
    return tmp_path


@pytest.mark.parametrize("top", [1, 3, 20])
def test_op_breakdown_matches_jax(traces, top):
    got = tprof.op_breakdown(str(traces), top=top)
    assert got == jprof.op_breakdown(str(traces), top=top)
    assert len(got) == min(top, 8)


def test_op_breakdown_by_category(traces):
    kernels = tprof.op_breakdown(str(traces), top=50, category="kernel")
    everything = {r["op"]: r["total_us"] for r in tprof.op_breakdown(str(traces), top=50)}
    assert {r["op"] for r in kernels} == {"op1", "op3", "op5", "op0", "op2", "op4", "op6", "?"}
    for r in kernels:
        assert 0 < r["total_us"] <= everything[r["op"]]
    assert sum(r["total_us"] for r in kernels) == sum(
        1.5 * i + 0.25 for i in range(1, 30, 2)) + 3.0


def test_trace_on_the_cpu_writes_a_trace_op_breakdown_reads(tmp_path, monkeypatch):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir), device="cpu"):
        a = torch.ones(64, 64)
        (a @ a).sum()
    files = list(log_dir.glob("*.pt.trace.json.gz"))
    assert len(files) == 1
    ops = {r["op"] for r in tprof.op_breakdown(str(log_dir), top=1000)}
    assert {"aten::mm", "aten::sum"} <= ops
    assert tprof.op_breakdown(str(log_dir), category="kernel") == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tprof.trace(str(tmp_path / "card")):
            pass
