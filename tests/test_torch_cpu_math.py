"""Elementwise math on the CPU at the start of a process, after the port's
import.

Torch's CPU sqrt, exp, log and the like call MKL's vector math, which sets
itself up on its first call in a process. When that first call came from
several OpenMP threads at once, one thread could return its whole chunk at
about 12 bits of precision (a float32 root off by 8.8e-4), and the CPU plain
versions that the parity tests hold against JAX carried it. Importing
``marius_tpu_torch`` sets the vector math up on one thread first. Each run
is a fresh process whose first vector-math call is a parallel one.
"""

import subprocess
import sys

import pytest

FIRST_CALL = """
import numpy as np
import torch
import marius_tpu_torch  # noqa: F401
torch.set_num_threads(8)
torch.ones(1 << 20).mul_(2)                  # the OpenMP pool is up and warm
x = np.random.default_rng(0).random(85_248) * 3 + 0.1
for dtype in (np.float32, np.float64):       # float32 first: it is the first call
    xs = x.astype(dtype)
    got = torch.sqrt(torch.from_numpy(xs)).numpy()
    want = np.sqrt(xs)                       # correctly rounded
    ulps = np.abs(got - want) / np.spacing(want)
    assert ulps.max() <= 1, (dtype.__name__, float(ulps.max()), int((ulps > 1).sum()))
"""


@pytest.mark.parametrize("run", range(6))
def test_first_parallel_sqrt_is_accurate(run):
    """Without the set-up, 16 of 50 such processes gave wrong float64 roots."""
    done = subprocess.run([sys.executable, "-c", FIRST_CALL], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
