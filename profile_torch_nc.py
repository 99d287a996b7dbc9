#!/usr/bin/env python3
"""Where the time of the port's full-graph NC training step goes on one GPU.

    python3 profile_torch_nc.py

Builds the arxiv-shaped workload as chip_smoke.py does (169,343 nodes,
1,166,243 power-law edges, 128 features, FEATURE + 3 x GraphSAGE MEAN d=128,
batch 1000) and, for the default linear-collapse trainer and the general
seed-restricted trainer (``fg_linear_collapse=False``) in turn, trains one
warm-up epoch, then times one ``train_epoch`` on the host clock and the next
under ``torch.profiler`` (profile_torch_lp.profile_batches): host and device
time per batch, the device's busy share, device operations per batch, the
kernels that take the most device time and the gather-sum kernel's share.
The last line is one JSON object with both breakdowns.
"""

from __future__ import annotations

import json
import sys

import torch

from chip_smoke import (ARXIV_CLASSES, ARXIV_FEATS, ARXIV_NODES, ARXIV_TRAIN, BATCH, NC_DIM,
                        arxiv_edges, card_name, nc_data, nc_model)
from profile_torch_lp import profile_batches


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_nc: no CUDA device", file=sys.stderr)
        return 1
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
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
    results = []
    for tag, kwargs in [("collapse", {}), ("general", {"fg_linear_collapse": False})]:
        trainer = NodeClassificationTrainer(model, graph, features, labels, train_nodes,
                                            batch_size=BATCH, seed=0, full_graph=adj, **kwargs)
        trainer.train_epoch()   # warm-up: kernel build, allocator, library handles
        # each run is one whole train_epoch, which ends in its one sync
        results.append(profile_batches(lambda: trainer.train_epoch()["epoch_time_s"],
                                       trainer.num_batches, card, tag=f"nc {tag}: "))
        del trainer
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
