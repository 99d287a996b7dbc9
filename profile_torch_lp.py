#!/usr/bin/env python3
"""Where the time of the port's flagship LP training step goes on one GPU.

    python3 profile_torch_lp.py

Builds the flagship trainer as chip_smoke.py does (FB15K-237-shaped DistMult,
d=50, batch 1000, 10 x 500 negatives) on the GPU, trains one warm-up epoch,
times one epoch's batches on the host clock, then runs the same batches again
under ``torch.profiler`` and sums the device time of every kernel, copy and
set. It prints the card, the host time per batch, the device time per batch,
the device's busy share (device time over host time without the profiler; one
stream, so kernels do not overlap), device operations per batch, the
kernels that take the most device time and the port's own kernels'
time and share. Then it times the row-gather kernel, its plain version and
``index_select`` against the bound at the flagship batch, the evaluation
batch, the out-of-core batch and K = 1 (``chip_smoke.gather_shapes``), after
printing the kernel's registers and spills. The last line is one JSON object
with the same numbers; device numbers the profiler did not report are null.
``profile_batches`` is shared with profile_torch_nc.py.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

import torch

from chip_smoke import (BATCH, CHUNKS, DIM, NEGATIVES, NUM_EDGES, NUM_NODES, NUM_RELS,
                        card_name, card_rates, gather_shapes, lp_model, print_gather_shapes,
                        synthetic_edges)

# the hand-written kernels (marius_tpu_torch/csrc) as the profiler names them
PORT_KERNELS = ("::gather_rows_kernel<", "::adagrad_kernel<", "::gather_sum_kernel<")


def run_batches(trainer, shuffled, masks) -> float:
    b = trainer.batch_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total = torch.zeros((), device=trainer.device)
    for i in range(trainer.num_batches):
        total += trainer._batch_step(shuffled[i * b:(i + 1) * b], masks[i * b:(i + 1) * b])
    float(total)
    return time.perf_counter() - t0


def profile_batches(run, nb: int, card: str, tag: str = "") -> dict:
    """Time ``run()`` (``nb`` batches ending in a sync; returns host seconds)
    on the host clock, then again under the profiler; print and return the
    breakdown."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host_s = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = run()

    by_name = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    device_us = sum(v[1] for v in by_name.values())
    ops = sum(v[0] for v in by_name.values())
    host_ms = host_s * 1e3 / nb
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])

    def row(name, v):
        return {"name": name[:90], "per_batch": v[0] / nb, "us_per_batch": v[1] / nb,
                "share_of_device": v[1] / device_us}

    result = {
        "tag": tag, "card": card, "batches": nb, "host_ms_per_batch": host_ms,
        "profiled_host_ms_per_batch": profiled_s * 1e3 / nb,
        "device_ms_per_batch": device_us / 1e3 / nb if ops else None,
        "busy_share": device_us / 1e3 / nb / host_ms if ops else None,
        "device_ops_per_batch": ops / nb if ops else None,
        "top": [row(k, v) for k, v in ranked[:15]],
        "port_kernels": [row(k, v) for k, v in ranked if any(p in k for p in PORT_KERNELS)],
    }
    print(f"{tag}host {host_ms:.4f} ms/batch ({nb} batches; {profiled_s * 1e3 / nb:.4f} under "
          f"the profiler)  [{card}]")
    if ops:
        print(f"{tag}device {result['device_ms_per_batch']:.4f} ms/batch, busy share "
              f"{result['busy_share']:.4f}, {result['device_ops_per_batch']:.1f} device "
              f"operations per batch  [{card}]")
        for t in result["top"] + [{"name": "-- the port's own kernels --"}] + result[
                "port_kernels"]:
            if "per_batch" not in t:
                print(t["name"])
                continue
            print(f"  {t['us_per_batch']:9.3f} us/batch  {t['per_batch']:6.1f}x  "
                  f"{t['share_of_device']:.4f}  {t['name']}")
    else:
        print(f"{tag}device time: not measured (the profiler reported no device events)")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_lp: no CUDA device", file=sys.stderr)
        return 1
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.ops.cuda import build, gather
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    card = card_name()
    print(card, flush=True)
    for line in build.build_all(["gather"])["gather"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  gather: {line.strip()}", flush=True)
    trainer = LinkPredictionTrainer(
        lp_model(NUM_RELS, DIM), NUM_NODES, NUM_RELS,
        synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES),
        NegativeSamplingConfig(num_chunks=CHUNKS, negatives_per_positive=NEGATIVES),
        batch_size=BATCH, seed=0)
    trainer.train_epoch()   # warm-up: kernel build, allocator, library handles
    perm = trainer._epoch_permutation(1)
    shuffled, masks = trainer.edges[perm], perm < trainer.num_edges
    result = profile_batches(lambda: run_batches(trainer, shuffled, masks),
                             trainer.num_batches, card)
    del trainer, shuffled, masks
    shapes = gather_shapes(gather, torch.device("cuda"), card_rates(torch.cuda.get_device_name(0)))
    print_gather_shapes(shapes, card)
    print(json.dumps({"lp": result, "gather_shapes": shapes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
