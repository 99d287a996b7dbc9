"""Small copies of the cells for the CPU tests (the harness at a size a
test run holds: the same code paths, smaller graphs, batches and caps)."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

NC = {"dataset": {"num_nodes": 3000, "num_edges": 20000, "max_in_degree": 300,
                  "num_train": 600, "num_valid": 290, "num_test": 2110},
      "marius_config": {"model": {"encoder": {"hop_caps": [100, 1200, 2400, 3001]}},
                        "training": {"batch_size": 100}, "evaluation": {"batch_size": 100}}}
LP = {"dataset": {"num_nodes": 400, "num_relations": 5, "num_train": 4000, "num_valid": 200,
                  "num_test": 200},
      "marius_config": {"training": {"batch_size": 100,
                                     "negative_sampling": {"num_chunks": 2,
                                                           "negatives_per_positive": 50}},
                        "evaluation": {"batch_size": 100}}}
SIZES = {"arxiv_sage.sampled": NC, "fb15k237_gs1.train": LP}


def run_tiny(workload: str, seed: int = 5, fault=None, trace: bool = False):
    """One CPU run of the small copy of ``workload``, through the whole
    runner (set-up, a short window, the check)."""
    import torch

    from benchmark.harness import cycles

    torch.set_num_threads(2)
    return cycles.run_cell(workload, seed, 0.2, trace, "cpu", time.perf_counter(),
                           sizes=SIZES[workload], fault=fault)
