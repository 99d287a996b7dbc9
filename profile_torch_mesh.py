#!/usr/bin/env python3
"""The port's meshes across the cards of one machine.

    python3 profile_torch_mesh.py          # both parts below
    python3 profile_torch_mesh.py lp       # the LP mesh only
    python3 profile_torch_mesh.py ring     # the SAGE ring only

Builds the kernels, then runs chip_smoke.py's phases with one rank per card
(rank i drives card ``i % cards``, so with four cards the backend rule picks
NCCL and with one card gloo):

- ``lp``: ``lp_mesh_ranks``: four rank processes train ``fb15k_237.yaml``
  (FB15K-237's shape, 2 epochs) through the command line on a data 2 x
  node 2 mesh, then gs_1_layer on a learnable 1,000-node KG, then gs_1_layer
  under ALL sampling at FB15K-237's shape, each rank holding 2 batches
  against its own one-card trainer; one process's run of the same YAML on
  card 0 beside them;
- ``ring``: ``nc_ring`` with ogbn_arxiv.yaml's FEATURE + 3 x GraphSAGE MEAN
  model forced onto the node-sharded ring at arxiv shape on a {data: 1,
  node: S} mesh (S the cards, at least 2): every hop goes card to card under
  NCCL. Each rank trains 3 batches and evaluates; one card's trainer runs
  the same batches on card 0: losses held, s per batch, hops, ring bytes, the
  share of each step the device waited for the hops, and peak bytes per
  card printed.

It prints every card's name and power limit and fails if the ranks disagree
with each other or with the one-card run (chip_smoke.py's checks). Exits 1
without a card.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_torch_mesh: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from marius_tpu_torch.ops.cuda import build

    parts = argv[1:] or ["lp", "ring"]
    if not set(parts) <= {"lp", "ring"}:
        print(f"profile_torch_mesh: unknown parts {parts} (lp, ring)", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cards = torch.cuda.device_count()
    print(f"{cards} cards; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    card = chip_smoke.card_name()
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    if "lp" in parts:
        t0 = time.perf_counter()
        chip_smoke.lp_mesh_ranks(card)
        print(f"lp_mesh_ranks: {time.perf_counter() - t0:.1f} s", flush=True)
    if "ring" in parts:
        t0 = time.perf_counter()
        data = chip_smoke.nc_data(0, chip_smoke.arxiv_edges(), chip_smoke.ARXIV_NODES,
                                  chip_smoke.ARXIV_FEATS, chip_smoke.ARXIV_CLASSES,
                                  chip_smoke.ARXIV_TRAIN)
        chip_smoke.nc_ring(card, data, models=("sage",), shape=(1, max(2, cards)))
        print(f"nc_ring (SAGE): {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
