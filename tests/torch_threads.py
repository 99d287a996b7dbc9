"""One intra-op thread for torch's CPU ops while a port test module runs.

The port's CPU paths are eager loops of small tensor operations, which gain
nothing from torch's OpenMP pool. When several test processes share the
machine's cores (``pytest -n``), every process's pool spins on cores the
others need: on an 8-core x86 host with 6 other busy processes, two epochs
of a small full-graph NC trainer took 70.5 s with 8 threads and 0.88 s
with one. A port test module
imports :func:`one_torch_thread`; it sets one thread for the module and
restores the previous count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
