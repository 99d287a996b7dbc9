"""One short run of each cell through the command line, on the card (the
tests marked ``cuda`` skip without one):

    python -m pytest benchmark/tests -m cuda -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import bench_tiny
import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list(bench_tiny.SIZES))
@pytest.mark.parametrize("trace", [0, 1])
def test_one_short_run_on_the_card(card, workload, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600, cwd=bench_tiny.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-2000:]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "compared"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
