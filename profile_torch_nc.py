#!/usr/bin/env python3
"""Where the time of the port's NC training step goes on one GPU.

    python3 profile_torch_nc.py

Builds the arxiv-shaped workload as chip_smoke.py does (169,343 nodes,
1,166,243 power-law edges, 128 features, FEATURE + 3 x GraphSAGE MEAN d=128,
batch 1000) and, for the default linear-collapse trainer, the general
seed-restricted trainer (``fg_linear_collapse=False``) and the sampled
trainer of ``examples/configuration/ogbn_arxiv.yaml`` (UNIFORM 32 in and out
per hop, the YAML's hop caps) in turn, trains one warm-up epoch, then times
one ``train_epoch`` on the host clock and the next under ``torch.profiler``
(profile_torch_lp.profile_batches): host and device time per batch, the
device's busy share, device operations per batch, the kernels that take the
most device time and the port's kernels' shares.
It then times one whole neighbour sum at arxiv shape (d=128 f32, all 40
buckets) and its parts: the hub rows' buckets (rows wider than 256 slots)
alone, the other buckets alone, the other buckets with their ids folded
into 4,096 rows (a 0.5 MB slab that L2 holds whatever the order, so every
slot read is a hit: the kernel's own rate), and the whole sum at d=32 (one
column slab, rows contiguous in x). The last line is one JSON object with
both breakdowns and the gather-sum's parts.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch
import yaml

from chip_smoke import (ARXIV_CLASSES, ARXIV_FEATS, ARXIV_NODES, ARXIV_TRAIN, BATCH, NC_DIM,
                        arxiv_edges, card_name, nc_data, nc_model, time_ms)
from profile_torch_lp import profile_batches


def gather_sum_parts(adj, card: str) -> dict:
    """Median µs of the gather-sum kernel over the whole arxiv-shaped sum and
    its parts (see the module docstring), with the real slots' row-read
    bytes over each time."""
    from marius_tpu_torch.data.full_graph import nbr_sum_layout
    from marius_tpu_torch.ops.cuda import nbr_sum as ns

    dev = adj.inv_pos.device

    def part(buckets):   # a layout of some buckets alone, rows in bucket order
        rows = sum(int(b.shape[0]) for b in buckets)
        return ns.bucket_layout(buckets, torch.arange(rows, device=dev), rows)

    hubs = part([b for b in adj.nbrs if b.shape[1] > ns.MAX_CAP])
    rest = part([b for b in adj.nbrs if b.shape[1] <= ns.MAX_CAP])
    ids = rest.ids
    layouts = {"whole": nbr_sum_layout(adj), "hub rows alone": hubs, "other rows alone": rest,
               "other rows, ids in 4,096 rows": dataclasses.replace(
                   rest, ids=torch.where(ids < ARXIV_NODES, ids % 4096, ids))}
    x = torch.randn(ARXIV_NODES, NC_DIM, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    x32 = x[:, :32].contiguous()
    result = {"card": card}
    for name, (lay, xs) in {**{k: (v, x) for k, v in layouts.items()},
                            "whole, d=32": (layouts["whole"], x32)}.items():
        us = time_ms(lambda: ns.nbr_sum(xs, lay)) * 1e3
        real = int(((lay.ids >= 0) & (lay.ids < ARXIV_NODES)).sum())
        rate = real * xs.shape[1] * 4 / us / 1e6   # TB/s of one row read per real slot
        result[name] = {"us": us, "real_slots": real, "slot_read_tb_s": rate}
        print(f"gather-sum, {name}: {us:.2f} us, {real} real slots, slot reads at "
              f"{rate:.3f} TB/s  [{card}]", flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_nc: no CUDA device", file=sys.stderr)
        return 1
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_name()
    print(card, flush=True)
    edges, features, labels, train_nodes = nc_data(0, arxiv_edges(), ARXIV_NODES, ARXIV_FEATS,
                                                   ARXIV_CLASSES, ARXIV_TRAIN)
    adj = build_full_graph_adjacency(edges, ARXIV_NODES)
    graph = build_device_graph(edges, ARXIV_NODES)
    model = nc_model(ARXIV_FEATS, (NC_DIM, NC_DIM, ARXIV_CLASSES))
    with open(Path(__file__).resolve().parent / "examples" / "configuration"
              / "ogbn_arxiv.yaml") as f:
        enc = yaml.safe_load(f)["model"]["encoder"]
    sampled = {"nbr_configs": [NeighborSamplingConfig(c["type"], **c["options"])
                               for c in enc["train_neighbor_sampling"]],
               "hop_caps": enc["hop_caps"]}
    results = []
    for tag, kwargs in [("collapse", {"full_graph": adj}),
                        ("general", {"full_graph": adj, "fg_linear_collapse": False}),
                        ("sampled", sampled)]:
        trainer = NodeClassificationTrainer(model, graph, features, labels, train_nodes,
                                            batch_size=BATCH, seed=0, **kwargs)
        trainer.train_epoch()   # warm-up: kernel build, allocator, library handles
        # each run is one whole train_epoch, which ends in its one sync
        results.append(profile_batches(lambda: trainer.train_epoch()["epoch_time_s"],
                                       trainer.num_batches, card, tag=f"nc {tag}: "))
        del trainer
    parts = gather_sum_parts(adj.to("cuda"), card)
    print(json.dumps({"breakdowns": results, "gather_sum_parts": parts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
