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
time and share. It does the same for the GNN LP step (``profile_gnn_lp``:
the same data and model with fb15k_237.yaml's encoder replaced by the
gs_1_layer fragment, EMBEDDING then GraphSAGE MEAN 50 -> 50 over UNIFORM 10
sampling, as chip_smoke.py's lp_gnn runs it) and for the out-of-core step:
one buffer state's batches of ``freebase86m_comet.yaml`` at a node count
cut to 4,000,000 (``profile_oocore_state``). Then it times the row-gather
kernel, its plain version and ``index_select`` against the bound at the
flagship batch, the evaluation batch, the out-of-core batch and K = 1
(``chip_smoke.gather_shapes``), after printing the kernel's registers and
spills. The last line is one JSON object with the same numbers (``lp``,
``lp_gnn``, ``oocore``, ``gather_shapes``); device numbers the profiler
did not report are null.
``profile_batches`` is shared with profile_torch_nc.py.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from chip_smoke import (BATCH, CHUNKS, DIM, NEGATIVES, NUM_EDGES, NUM_NODES, NUM_RELS,
                        card_name, card_rates, freebase_config, gather_shapes, lp_model,
                        print_gather_shapes, synthetic_edges, write_freebase_shaped)

# the hand-written kernels (marius_tpu_torch/csrc) as the profiler names them
PORT_KERNELS = ("::gather_rows_kernel<", "::adagrad_kernel<", "::gather_sum_kernel<")
# the out-of-core profile's cut of Freebase86m: nodes and uniform train edges
OOC_PROFILE_NODES, OOC_PROFILE_EDGES = 4_000_000, 8_000_000


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


def gnn_lp_trainer():
    """The flagship's data and model with gs_1_layer's encoder (chip_smoke.py
    lp_gnn's model) on the GPU."""
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    model = dataclasses.replace(lp_model(NUM_RELS, DIM), encoder=EncoderConfig((
        (LayerConfig("EMBEDDING", output_dim=DIM),),
        (LayerConfig("GNN", input_dim=DIM, output_dim=DIM, gnn_type="GRAPH_SAGE",
                     aggregator="MEAN"),))))
    edges = synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES)
    return LinkPredictionTrainer(
        model, NUM_NODES, NUM_RELS, edges,
        NegativeSamplingConfig(num_chunks=CHUNKS, negatives_per_positive=NEGATIVES),
        batch_size=BATCH, seed=0,
        graph=build_device_graph(edges, NUM_NODES, NUM_RELS, device="cuda"),
        nbr_configs=[NeighborSamplingConfig("UNIFORM", 10)])


def profile_gnn_lp(card: str) -> dict:
    """One epoch of the GNN LP step after a warm-up epoch, as the flagship's."""
    trainer = gnn_lp_trainer()
    trainer.train_epoch()
    perm = trainer._epoch_permutation(1)
    shuffled, masks = trainer.edges[perm], perm < trainer.num_edges
    return profile_batches(lambda: run_batches(trainer, shuffled, masks), trainer.num_batches,
                           card, tag="GNN ")


def profile_oocore_state(card: str) -> dict:
    """The out-of-core step: freebase86m_comet.yaml (ComplEx d=100, batch
    10,000, 10 x 500 negatives, degree_fraction 0.5, Adagrad) through
    ``marius_init``, its node count cut to OOC_PROFILE_NODES so that set-up
    is quick while the buffer stays on the unique-id branch (2,000,000 x 100
    resident rows, far above 8M elements). The first COMET state is loaded
    and its batches (``_train_state``, as ``train_epoch`` runs them, without
    swaps) are profiled as the flagship's are."""
    from marius_tpu_torch import native
    from marius_tpu_torch.manager import marius_init

    with tempfile.TemporaryDirectory() as tmp:
        write_freebase_shaped(f"{tmp}/dataset", OOC_PROFILE_NODES, OOC_PROFILE_EDGES, 1000)
        trainer = marius_init(freebase_config(tmp, OOC_PROFILE_NODES, save_model=False)).trainer
    states, assignment = trainer._plan_epoch()
    trainer.buffer.load(states[0])
    p = trainer.num_partitions
    local = native.gather_remap_buckets(
        trainer.edges_by_bucket, trainer.bucket_offsets,
        np.asarray([i * p + j for i, j in assignment[0]], np.int32),
        trainer.buffer.part_to_slot, trainer.buffer.psize)
    nb = -(-len(local) // trainer.batch_size)

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(trainer._train_state(local, 0, nb))
        return time.perf_counter() - t0

    run()   # warm-up
    return profile_batches(run, nb, card, tag="out-of-core ")


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
    gnn = profile_gnn_lp(card)
    oocore = profile_oocore_state(card)
    shapes = gather_shapes(gather, torch.device("cuda"), card_rates(torch.cuda.get_device_name(0)))
    print_gather_shapes(shapes, card)
    print(json.dumps({"lp": result, "lp_gnn": gnn, "oocore": oocore, "gather_shapes": shapes}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
