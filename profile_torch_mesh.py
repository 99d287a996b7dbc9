#!/usr/bin/env python3
"""The port's LP mesh across the cards of one machine.

    python3 profile_torch_mesh.py        # four cards: one NCCL rank per card

Builds the kernels, then runs chip_smoke.py's ``lp_mesh_ranks``: four rank
processes train ``fb15k_237.yaml`` (FB15K-237's shape, 2 epochs) through the
command line on a data 2 x node 2 mesh, then gs_1_layer on a learnable
1,000-node KG, then gs_1_layer under ALL sampling at FB15K-237's shape,
each rank holding 2 batches against its own one-card trainer; rank i drives card ``i % cards``, so with four cards the
backend rule picks NCCL and with one card gloo. It prints every card's name
and power limit, each rank's backend, device, seconds and edges/s per epoch,
collectives per batch and kernel launches, and one process's run of the same
YAML on card 0 beside them; it fails if the ranks disagree with each other
or with that run (chip_smoke.py's checks). Exits 1 without a card.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_mesh: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from marius_tpu_torch.ops.cuda import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"{torch.cuda.device_count()} cards; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    chip_smoke.lp_mesh_ranks(chip_smoke.card_name())
    print(f"lp_mesh_ranks: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
