#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (marius_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``marius_tpu_torch/csrc`` with nvcc (one
process per source, in parallel), holds each against its plain PyTorch
version on the card (main-path shapes and odd shapes, bit for bit), times each
(kernel, plain version, one-call PyTorch equivalent, bound; the row gather
also at the out-of-core batch, 30,000 distinct ids into a 17.2 GB partition
buffer, and at K = 1, the launch floor), then drives the
port's two main paths through their public entry points, each with the
launch counters set to 0 just before it and read just after:

1. link prediction: FB15K-237-shaped DistMult (14,541 nodes, 237 relations,
   272,115 synthetic train edges, d=50, batch 1000, 10 chunks x 500
   negatives, Adam lr 0.1, row-sparse Adagrad lr 0.1), one warm-up and two
   timed epochs, through the row gather and the row-sparse Adagrad;
2. full-graph node classification at ogbn-arxiv shape (169,343 nodes,
   1,166,243 power-law edges, 128 features, 40 classes, 90,941 train nodes,
   FEATURE + 3 x GraphSAGE MEAN d=128 with bias, CE SUM, Adam lr 0.01, batch
   1000): the default linear-collapse trainer (setup timed, one warm-up and
   two timed epochs), then the general seed-restricted trainer
   (fg_linear_collapse=False, one warm-up and two timed epochs, evaluation
   on the non-train nodes), through the bucketed neighbour gather-sum.

Small runs on the card are compared with the same runs on the CPU (plain
versions, which tests/test_torch_*.py hold against the JAX package).

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches, errors, times and bounds. Any failure raises and
the script exits non-zero; without a CUDA device it exits 1 and prints no
result. It imports nothing of JAX or marius_tpu.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# FB15K-237 shape (bench.py:21-25) and the flagship config (bench.py:42-51)
NUM_NODES, NUM_RELS, NUM_EDGES, DIM, BATCH = 14_541, 237, 272_115, 50, 1000
CHUNKS, NEGATIVES = 10, 500
GATHER_IDS = 2 * BATCH + 2 * CHUNKS * NEGATIVES   # ids per batch on the dense branch
ODD_DIMS = (1, 33, 50, 128, 257)
# the row gather's widths: 4-, 8- and 16-byte vectors, d = 100 (the out-of-core width)
GATHER_DIMS = (1, 2, 3, 5, 33, 50, 100, 128, 257)
# the out-of-core batch: Freebase86m's resident partition buffer, 8 of 16 partitions of
# 86,054,151 nodes at d = 100 (examples/configuration/freebase86m_comet.yaml), and that
# config's one batch on the dedup branch, 2 x 10,000 + 2 x 10 x 500 ids made distinct
FB86M_NODES, FB86M_PARTITIONS, FB86M_BUFFER, FB86M_DIM = 86_054_151, 16, 8, 100
OOC_ROWS = FB86M_BUFFER * -(-FB86M_NODES // FB86M_PARTITIONS)   # 43,027,080 rows, 17.2 GB
OOC_IDS = 2 * 10_000 + 2 * 10 * 500
# batches cycled while timing it: 16 x 24 MB between two uses of one, far above L2's 50 MB
OOC_BATCHES = 16
# ogbn-arxiv shape (bench_nc_full.py:29-37) and its model (examples/configuration/ogbn_arxiv.yaml)
ARXIV_NODES, ARXIV_EDGES, ARXIV_FEATS, ARXIV_CLASSES = 169_343, 1_166_243, 128, 40
ARXIV_TRAIN, ARXIV_HUB = 90_941, 13_161
NC_DIM, NC_GNN_STAGES, NC_LR = 128, 3, 0.01
# the neighbour sum's widths: d=1 (GCN counts), the model's 128, the collapse's 129/259/519
SUM_DIMS = (1, 33, 128, 129, 259, 519)
# the edges of the gather-sum kernel's 128-byte column slabs (32 f32 or 64 bf16 columns)
SLAB_EDGE_DIMS = (15, 16, 17, 31, 32, 63, 64, 65)
# single buckets: caps from one slot to the 13k-slot hub, with the hub split's edges
# (256 slots: one task; 257 and 512: two pieces)
SUM_SHAPES = ((1000, 1), (777, 3), (300, 40), (5, 256), (4, 257), (3, 512), (20, 700),
              (2, ARXIV_HUB))


def card_rates(name: str):
    """(bytes/s, float32 FLOP/s outside the tensor cores) from NVIDIA's data
    sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s; H100 PCIe 2.0 TB/s and 51."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    return 3.35e12, 67e12


def bound_ms(nbytes: float, ops: float, rates) -> tuple:
    t_bytes, t_ops = nbytes / rates[0], ops / rates[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50, samples: int = 7) -> float:
    """Median device time of one call, from CUDA events around ``reps`` calls.
    A sleep kernel queued first lets the launches pile up behind it, so the
    events measure the device and not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        torch.cuda._sleep(20_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def gather_max_err(gather, table, ids) -> float:
    """Max |kernel - plain version|; raises unless they agree bit for bit."""
    out, ref = gather.gather_rows(table, ids), gather.gather_rows_plain(table, ids)
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.equal(out, ref):
        raise AssertionError(f"gather_rows differs from plain (table {tuple(table.shape)} at "
                             f"{table.storage_offset()} elements into its storage, "
                             f"{ids.shape[0]} {ids.dtype} ids)")
    return float((out - ref).abs().max())


def time_gather(gather, table, batches, rates) -> dict:
    """Kernel, plain version, index_select (on clamped ids, which it needs) and
    bound at one shape; the timed calls cycle through ``batches`` of ids."""
    def cycled(fn, ids_list):
        it = itertools.cycle(ids_list)
        return lambda: fn(table, next(it))

    n, d = table.shape
    clamped = [ids.clamp(0, n - 1) for ids in batches]
    rows = [int(torch.unique(c).numel()) for c in clamped]
    k = batches[0].shape[0]
    # each distinct row read once, the ids read once, K rows written
    nbytes = float(np.mean(rows)) * d * 4 + k * batches[0].element_size() + k * d * 4
    b_ms, b_by = bound_ms(nbytes, 0.0, rates)
    return {
        "ms": time_ms(cycled(gather.gather_rows, batches)),
        "plain_ms": time_ms(cycled(gather.gather_rows_plain, batches)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(cycled(lambda t, i: torch.index_select(t, 0, i), clamped)),
        "k": k, "d": d, "distinct_rows": float(np.mean(rows)), "bound_bytes": nbytes,
    }


def gather_shapes(gather, dev, rates) -> dict:
    """The row gather timed, and checked bit for bit, at three shapes:
    the flagship batch (K = 12,000 int64 ids into the 14,541 x 50 table,
    L2-resident), the out-of-core batch (30,000 sorted distinct ids padded
    with N into the 43,027,080 x 100 partition buffer, cycling through 16
    batches so rows come from HBM) and the launch floor (K = 1, flagship
    table)."""
    from marius_tpu_torch.ops.unique import unique_padded

    g = torch.Generator(device=dev).manual_seed(4)
    table = torch.randn(NUM_NODES, DIM, device=dev, generator=g)
    ids = torch.randint(0, NUM_NODES, (GATHER_IDS,), device=dev, generator=g)
    err = max(gather_max_err(gather, table, ids), gather_max_err(gather, table, ids[:1]))
    shapes = {"flagship": time_gather(gather, table, [ids], rates),
              "k1_floor": time_gather(gather, table, [ids[:1]], rates)}
    del table, ids
    big = torch.empty((OOC_ROWS, FB86M_DIM), device=dev).normal_(generator=g)
    batches = [unique_padded(torch.randint(0, OOC_ROWS, (OOC_IDS,), device=dev, generator=g),
                             OOC_IDS, OOC_ROWS).ids for _ in range(OOC_BATCHES)]
    for idt in (torch.int64, torch.int32):
        err = max(err, gather_max_err(gather, big, batches[0].to(idt)))
    shapes["out_of_core"] = time_gather(gather, big, batches, rates)
    del big, batches
    torch.cuda.empty_cache()
    shapes["max_abs_err"] = err
    return shapes


def print_gather_shapes(shapes: dict, card: str) -> None:
    for name in [n for n in ("flagship", "out_of_core", "k1_floor") if n in shapes]:
        s = shapes[name]
        print(f"gather_rows, {name} (K={s['k']}, d={s['d']}, {s['distinct_rows']:.1f} distinct "
              f"rows, {s['bound_bytes'] / 1e6:.4f} MB): kernel {s['ms'] * 1e3:.2f} us  plain "
              f"{s['plain_ms'] * 1e3:.2f} us  index_select {s['library_ms'] * 1e3:.2f} us  bound "
              f"{s['bound_ms'] * 1e3:.2f} us ({s['bound_by']})  [{card}]", flush=True)


def check_gather(gather, dev, rates):
    """Bit for bit against the plain version at every vector width, at tables
    that are views 4 and 8 bytes into their storage, at K = 1, 33 and 4,099,
    with both id types and ids below 0 and at or above N; then timed at the
    flagship, out-of-core and K = 1 shapes."""
    g = torch.Generator(device=dev).manual_seed(1)
    n = 1009
    for d in GATHER_DIMS:
        base = torch.randn(n * d + 2, device=dev, generator=g)
        ids = torch.randint(-3, n + 3, (4099,), device=dev, generator=g)   # n: padding id
        for off in (0, 1, 2):
            table = base[off:off + n * d].view(n, d)
            for k in (1, 33, 4099):
                for idt in (torch.int64, torch.int32):
                    gather_max_err(gather, table, ids[:k].to(idt))
    shapes = gather_shapes(gather, dev, rates)
    flagship = shapes["flagship"]
    return {
        "name": "gather_rows", "route": "cuda", "source": "marius_tpu_torch/csrc/gather.cu",
        "replaces": "marius_tpu/ops/pallas/gather.py:61", "max_abs_err": shapes["max_abs_err"],
        "ms": flagship["ms"], "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"], "bound_by": flagship["bound_by"],
        "library_ms": flagship["library_ms"],
        "out_of_core": shapes["out_of_core"], "k1_floor": shapes["k1_floor"],
    }


def check_adagrad(adagrad, dev, rates):
    g = torch.Generator(device=dev).manual_seed(2)
    for d in ODD_DIMS:
        n = 1009
        vals = torch.randn(n, d, device=dev, generator=g)
        state = torch.rand(n, d, device=dev, generator=g)
        ids = torch.randperm(n + 50, device=dev, generator=g)[:777]   # ids >= n: padding
        grads = torch.randn(777, d, device=dev, generator=g)
        v1, s1, v2, s2 = vals.clone(), state.clone(), vals.clone(), state.clone()
        adagrad.sparse_adagrad_update_(v1, s1, ids, grads, 0.1)
        adagrad.sparse_adagrad_update_plain_(v2, s2, ids, grads, 0.1)
        torch.cuda.synchronize()
        if not (torch.equal(v1, v2) and torch.equal(s1, s2)):
            raise AssertionError(f"sparse_adagrad_update_ differs from plain at d={d}")
        untouched = torch.ones(n, dtype=torch.bool, device=dev)
        untouched[ids[ids < n]] = False
        if not (torch.equal(v1[untouched], vals[untouched])
                and torch.equal(s1[untouched], state[untouched])):
            raise AssertionError(f"sparse_adagrad_update_ wrote an untouched row at d={d}")
    # the trainer's dense-accumulate branch: every row, about half with G == 0
    vals = torch.randn(NUM_NODES, DIM, device=dev, generator=g)
    state = torch.rand(NUM_NODES, DIM, device=dev, generator=g)
    ids = torch.arange(NUM_NODES, device=dev)
    grads = torch.randn(NUM_NODES, DIM, device=dev, generator=g)
    zero_rows = torch.rand(NUM_NODES, device=dev, generator=g) < 0.5
    grads[zero_rows] = 0.0
    v1, s1, v2, s2 = vals.clone(), state.clone(), vals.clone(), state.clone()
    adagrad.sparse_adagrad_update_(v1, s1, ids, grads, 0.1)
    adagrad.sparse_adagrad_update_plain_(v2, s2, ids, grads, 0.1)
    torch.cuda.synchronize()
    err = max(float((v1 - v2).abs().max()), float((s1 - s2).abs().max()))
    if err != 0.0:
        raise AssertionError(f"sparse_adagrad_update_ differs from plain by {err}")
    if not (torch.equal(v1[zero_rows], vals[zero_rows])
            and torch.equal(s1[zero_rows], state[zero_rows])):
        raise AssertionError("a row with zero gradient changed")
    nbytes = NUM_NODES * 8 + NUM_NODES * DIM * 4 * 5
    b_ms, b_by = bound_ms(nbytes, NUM_NODES * DIM * 7, rates)
    # the one-call yardstick: torch's functional Adagrad on a row-sparse gradient
    # (same rule and eps; it divides before scaling by lr, so it is not bit-equal)
    from torch.optim.adagrad import adagrad as torch_adagrad

    sparse_grads = torch.sparse_coo_tensor(ids[None], grads, (NUM_NODES, DIM),
                                           is_coalesced=True, check_invariants=False)
    v3, s3, step = vals.clone(), state.clone(), torch.zeros((), device=dev)

    def library():
        torch_adagrad([v3], [sparse_grads], [s3], [step], has_sparse_grad=True, lr=0.1,
                      weight_decay=0.0, lr_decay=0.0, eps=1e-10, maximize=False)

    library()
    torch.testing.assert_close(v3, v1, rtol=1e-6, atol=1e-6)
    return {
        "name": "sparse_adagrad_update_", "route": "cuda",
        "source": "marius_tpu_torch/csrc/adagrad.cu",
        "replaces": "marius_tpu/ops/pallas/adagrad.py:89", "max_abs_err": err,
        "ms": time_ms(lambda: adagrad.sparse_adagrad_update_(v1, s1, ids, grads, 0.1)),
        "plain_ms": time_ms(lambda: adagrad.sparse_adagrad_update_plain_(v2, s2, ids, grads,
                                                                         0.1)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library),
    }


def lp_model(num_rels: int, dim: int):
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import LINK_PREDICTION, Model

    return Model(LINK_PREDICTION,
                 EncoderConfig(((LayerConfig(layer_type="EMBEDDING", output_dim=dim),),)),
                 EdgeDecoder("DISTMULT", num_rels, dim))


def synthetic_edges(seed: int, num_nodes: int, num_rels: int, num_edges: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, num_nodes, num_edges),
                     rng.integers(0, num_rels, num_edges),
                     rng.integers(0, num_nodes, num_edges)], axis=1).astype(np.int32)


def train_flagship(card: str):
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    trainer = LinkPredictionTrainer(
        lp_model(NUM_RELS, DIM), NUM_NODES, NUM_RELS,
        synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES),
        NegativeSamplingConfig(num_chunks=CHUNKS, negatives_per_positive=NEGATIVES),
        batch_size=BATCH, seed=0)   # device=None: the GPU
    if trainer.device.type != "cuda" or not trainer.dense_accum:
        raise AssertionError("the flagship must train on the GPU's dense-accumulate branch")
    gather.launches = adagrad.launches = 0
    results = [trainer.train_epoch() for _ in range(3)]
    launches = {"gather_rows": gather.launches, "sparse_adagrad_update_": adagrad.launches}
    losses = [r["loss"] for r in results]
    for i, r in enumerate(results):
        tag = "warm-up" if i == 0 else "timed"
        print(f"flagship epoch {i} ({tag}): loss {r['loss']:.6f}  {r['epoch_time_s']:.4f} s  "
              f"{r['edges_per_sec']:.1f} edges/s  [{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"flagship losses are not finite and decreasing: {losses}")
    table = trainer.state.table.values
    if table.shape != (NUM_NODES, DIM) or not bool(torch.isfinite(table).all()):
        raise AssertionError("flagship table is not finite or has the wrong shape")
    expected = 3 * trainer.num_batches
    for name, count in launches.items():
        if count != expected:
            raise AssertionError(f"{name} launched {count} times in 3 epochs, "
                                 f"expected {expected} (one per batch)")
    timed = results[1:]
    eps = sum(r["num_edges"] for r in timed) / sum(r["epoch_time_s"] for r in timed)
    print(f"flagship timed epochs: {eps:.1f} edges/s over {len(timed)} epochs  [{card}]",
          flush=True)
    return launches


def _batch_negatives(cfg, edges, num_nodes, inverse):
    """Deterministic negatives (a function of the batch), the same on any device."""
    from marius_tpu_torch.data.samplers.negative import NegativeSample

    nb = int(cfg.negatives_per_positive * cfg.degree_fraction)
    c, nu = cfg.num_chunks, cfg.negatives_per_positive - nb
    col = 0 if inverse else edges.shape[1] - 1
    base = edges[:, col].sum() + (3 if inverse else 0)
    ar = torch.arange(c * max(nu, nb), device=edges.device)
    uni = ((base + 7 * ar[:c * nu]) % num_nodes).reshape(c, nu)
    rows = ((base + 5 * ar[:c * nb]) % edges.shape[0]).reshape(c, nb)
    return NegativeSample(torch.cat([edges[:, col][rows], uni], dim=1), rows)


def compare_lp_with_cpu():
    """A small LP run on the card against the same run on the CPU (plain kernels)."""
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    n, r, d, e = 300, 5, 50, 2000
    edges = synthetic_edges(3, n, r, e)
    cfg = NegativeSamplingConfig(num_chunks=4, negatives_per_positive=40, degree_fraction=0.25)
    worst = 0.0
    for dense in (True, False):
        trainers = [LinkPredictionTrainer(lp_model(r, d), n, r, edges, cfg, batch_size=200,
                                          seed=1, device=dev) for dev in ("cpu", "cuda")]
        cpu, gpu = trainers
        for t in trainers:
            t.dense_accum = dense
            t._sample_negatives = (lambda edges_b, inverse, _c=t.neg_config:
                                   _batch_negatives(_c, edges_b, n, inverse))
        gpu._epoch_permutation = lambda s: cpu._epoch_permutation(s).to(gpu.device)
        for _ in range(2):
            lc, lg = cpu.train_epoch()["loss"], gpu.train_epoch()["loss"]
            if not math.isclose(lc, lg, rel_tol=1e-4):
                raise AssertionError(f"loss on the card {lg} != on the CPU {lc}")
        for a, b in [(cpu.state.table.values, gpu.state.table.values),
                     (cpu.state.table.state, gpu.state.table.state),
                     (cpu.state.params["decoder"]["relations"],
                      gpu.state.params["decoder"]["relations"])]:
            b = b.detach().cpu()
            worst = max(worst, float((a.detach() - b).abs().max()))
            torch.testing.assert_close(b, a.detach(), rtol=1e-4, atol=1e-5)
    print(f"small LP run, card against CPU (both update branches, 2 epochs): "
          f"max abs difference {worst:.3g} (tolerance rtol 1e-4, atol 1e-5)", flush=True)


# -- full-graph node classification -------------------------------------------

def arxiv_edges() -> np.ndarray:
    """Arxiv-shaped citation graph, a copy of bench_nc_full.py:make_graph
    (:40-66): power-law in-degrees matched to ogbn-arxiv's (max 13,161, mean
    ~6.9), uniform sources."""
    rng = np.random.default_rng(0)
    w = (np.arange(ARXIV_NODES) + 1.0) ** -0.78
    lo, hi = 0.5, 4.0
    for _ in range(40):  # bisect the scale so the clipped sum hits ARXIV_EDGES
        mid = (lo + hi) / 2
        s = np.minimum(np.round(w * (ARXIV_EDGES / w.sum()) * mid), ARXIV_HUB).sum()
        lo, hi = (mid, hi) if s < ARXIV_EDGES else (lo, mid)
    deg = np.minimum(np.round(w * (ARXIV_EDGES / w.sum()) * lo), ARXIV_HUB).astype(np.int64)
    short = ARXIV_EDGES - int(deg.sum())
    if short > 0:
        np.add.at(deg, rng.integers(0, ARXIV_NODES, short), 1)
    elif short < 0:
        deg[np.argsort(deg)[::-1][:-short]] -= 1
    if int(deg.sum()) != ARXIV_EDGES:
        raise AssertionError("the degree sequence does not sum to the edge count")
    dst = rng.permutation(ARXIV_NODES)[np.repeat(np.arange(ARXIV_NODES), deg)]
    src = rng.integers(0, ARXIV_NODES, ARXIV_EDGES)
    return np.stack([src, dst], 1).astype(np.int32)


def nc_data(seed: int, edges: np.ndarray, num_nodes: int, feat_dim: int, classes: int,
            num_train: int):
    """Features, labels (a random linear function of the features, so
    training can fit them) and train nodes, from ``seed``."""
    rng = np.random.default_rng(seed)
    features = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)
    labels = np.argmax(features @ rng.standard_normal((feat_dim, classes)), 1).astype(np.int32)
    train_nodes = rng.permutation(num_nodes)[:num_train].astype(np.int32)
    return edges, features, labels, train_nodes


def nc_model(feat_dim: int, dims):
    """FEATURE (bias) + GraphSAGE MEAN stages with bias and no activation,
    CE SUM, Adam lr 0.01 (examples/configuration/ogbn_arxiv.yaml)."""
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    stages = [(LayerConfig("FEATURE", output_dim=feat_dim, bias=True),)]
    for din, dout in zip((feat_dim,) + tuple(dims[:-1]), dims):
        stages.append((LayerConfig("GNN", input_dim=din, output_dim=dout,
                                   gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True),))
    return Model(NODE_CLASSIFICATION, EncoderConfig(tuple(stages)), None,
                 loss_type="CROSS_ENTROPY", loss_reduction="SUM",
                 dense_optimizer=OptimizerConfig("ADAM", learning_rate=NC_LR))


def sum_matrix(adj, layout):
    """The combined adjacency as an (N, N) f32 CSR matrix in original order,
    repeated neighbours as counts and padding dropped: torch.sparse.mm(A, x)
    is the neighbour sum in one library call (cuSPARSE)."""
    n, dev = adj.num_nodes, adj.device
    perm = torch.argsort(adj.inv_pos.long(), stable=True)   # sorted row -> id
    rows = torch.cat([perm[s:s + b.shape[0]].repeat_interleave(b.shape[1])
                      for s, b in zip(adj.bucket_starts, adj.nbrs)])
    cols = layout.ids.long()
    keep = cols < n
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  torch.ones(int(keep.sum()), device=dev), (n, n),
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def check_gather_sum(adj, rates):
    """The gather-sum kernel against its plain version on the arxiv
    adjacency's real buckets (every width the NC paths use, forward and
    backward, f32 and bf16), on single buckets of odd shapes up to a 13k-slot
    hub at those widths and at the slab edges, with x 16-byte aligned and
    not, and on one layout with empty and all-padding buckets; then one
    whole neighbour sum at d=128, timed."""
    from marius_tpu_torch.data.full_graph import make_nbr_sums, nbr_sum_layout
    from marius_tpu_torch.ops.cuda import nbr_sum as ns

    dev, n = adj.device, adj.num_nodes
    g = torch.Generator(device=dev).manual_seed(3)
    layout = nbr_sum_layout(adj)

    def same(a, b, what):
        torch.cuda.synchronize()
        if a.shape != b.shape or not torch.equal(a, b):
            err = float((a - b).abs().max()) if a.shape == b.shape else float("nan")
            raise AssertionError(f"gather-sum differs from plain ({what}): {err}")

    for d in SUM_DIMS:
        x = torch.randn(n, d, device=dev, generator=g)
        same(ns.nbr_sum(x, layout), ns.nbr_sum_plain(x, layout), f"arxiv buckets, d={d}")
    x = torch.randn(n, NC_DIM, device=dev, generator=g).requires_grad_(True)
    u = torch.randn(n, NC_DIM, device=dev, generator=g)
    make_nbr_sums(adj)(x).backward(u)
    same(x.grad, ns.nbr_sum_plain(u, layout), "arxiv buckets, backward")
    xb = x.detach().to(torch.bfloat16)
    same(ns.nbr_sum(xb, layout), ns.nbr_sum_plain(xb, layout), "arxiv buckets, bf16")
    pad = lambda rows, cap: torch.full((rows, cap), 5000, dtype=torch.int32, device=dev)
    for d in sorted(SUM_DIMS + SLAB_EDGE_DIMS):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(5000, d, device=dev, generator=g).to(dtype)
            # the same values one element past a 16-byte boundary: one-element loads
            x_off = torch.empty(5000 * d + 1, device=dev, dtype=dtype)[1:].view(5000, d)
            x_off.copy_(x)
            buckets = []
            for rows, cap in SUM_SHAPES:
                ids = torch.randint(0, 5001, (rows, cap), device=dev, generator=g,
                                    dtype=torch.int32)   # 5000 = padding id
                buckets.append(ids)
                ref = ns.gather_sum_plain(x, ids)
                for xs, where in ((x, "aligned"), (x_off, "offset")):
                    same(ns.gather_sum(xs, ids), ref,
                         f"one bucket ({rows}, {cap}), d={d}, {dtype}, {where}")
            mixed = [buckets[1], pad(0, 9), pad(7, 5), buckets[4], pad(6, 300), buckets[-1],
                     pad(0, 400)]
            rows = sum(b.shape[0] for b in mixed)
            mixed_layout = ns.bucket_layout(
                mixed, torch.randperm(rows, device=dev, generator=g), rows)
            same(ns.nbr_sum(x, mixed_layout), ns.nbr_sum_plain(x, mixed_layout),
                 f"empty and all-padding buckets, d={d}, {dtype}")

    x = torch.randn(n, NC_DIM, device=dev, generator=g)
    out = ns.nbr_sum(x, layout)
    err = float((out - ns.nbr_sum_plain(x, layout)).abs().max())
    if err != 0.0:
        raise AssertionError(f"gather-sum differs from plain by {err}")
    a = sum_matrix(adj, layout)

    def library():
        return torch.sparse.mm(a, x)

    # cuSPARSE sums in another order: 1e-3 absolute on sums of up to 13k unit normals
    torch.testing.assert_close(library(), out, rtol=1e-4, atol=1e-3)
    valid = layout.ids[(layout.ids >= 0) & (layout.ids < n)]
    rows_read = int(torch.unique(valid).numel())
    tasks, folds = layout.task_start.numel(), layout.fold_first.numel()
    nbytes = (rows_read * NC_DIM * 4 + layout.ids.numel() * 4 + tasks * 16 + folds * 12
              + n * NC_DIM * 4)
    b_ms, b_by = bound_ms(nbytes, (valid.numel() + layout.num_partials) * NC_DIM, rates)
    print(f"gather-sum at arxiv shape: {len(adj.nbrs)} buckets, {layout.ids.numel()} slots "
          f"({valid.numel()} real), {tasks} tasks, {folds} hub rows in "
          f"{layout.num_partials} pieces, {rows_read} distinct rows read; "
          f"sparse matrix {a._nnz()} nonzeros", flush=True)
    ms = time_ms(lambda: ns.nbr_sum(x, layout))
    # what the slot reads alone ask of the memory system: one d-wide row per real slot
    slot_rate = valid.numel() * NC_DIM * 4 / (ms * 1e-3)
    print(f"gather-sum slot reads: {valid.numel() * NC_DIM * 4 / 1e9:.4f} GB in {ms * 1e3:.2f} us"
          f" = {slot_rate / 1e12:.3f} TB/s", flush=True)
    return {
        "name": "gather_sum", "route": "cuda", "source": "marius_tpu_torch/csrc/nbr_sum.cu",
        "replaces": "marius_tpu/ops/pallas/nbr_sum.py:114", "max_abs_err": err,
        "ms": ms,
        "plain_ms": time_ms(lambda: ns.nbr_sum_plain(x, layout), reps=2, samples=3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library, reps=10, samples=5),
        "slot_read_bytes_per_s": slot_rate,
    }


def _report_epochs(tag: str, results, card: str) -> None:
    for i, r in enumerate(results):
        kind = "warm-up" if i == 0 else "timed"
        print(f"{tag} epoch {i} ({kind}): loss {r['loss']:.6f}  {r['epoch_time_s']:.4f} s  "
              f"{r['nodes_per_sec']:.1f} nodes/s  [{card}]", flush=True)
    losses = [r["loss"] for r in results]
    if not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{tag} losses are not finite and decreasing: {losses}")
    timed = results[1:]
    nps = sum(r["num_nodes"] for r in timed) / sum(r["epoch_time_s"] for r in timed)
    print(f"{tag} timed epochs: {nps:.1f} nodes/s over {len(timed)} epochs  [{card}]",
          flush=True)


def train_nc(card: str, adj, data) -> dict:
    """Arxiv-shaped full-graph NC through the port's entry points: the
    collapse trainer, then the general trainer and its evaluation. Each part
    runs with the gather-sum counter set to 0 just before it and read just
    after, and each reading is checked against what the code implies.
    Returns {part: gather-sum launches}."""
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer

    edges, features, labels, train_nodes = data
    graph = build_device_graph(edges, ARXIV_NODES)
    model = nc_model(ARXIV_FEATS, (NC_DIM, NC_DIM, ARXIV_CLASSES))
    epochs = 3   # one warm-up, two timed
    # every call on the arxiv adjacency folds hub pieces on-chip
    if max(b.shape[1] for b in adj.nbrs) <= ns.MAX_CAP:
        raise AssertionError("the arxiv-shaped adjacency must have hub rows")
    counts = {}

    def part(name, expected, fn):
        ns.launches = 0
        out = fn()
        counts[name] = ns.launches
        if counts[name] != expected:
            raise AssertionError(f"nc {name}: gather-sum launched {counts[name]} times, "
                                 f"expected {expected}")
        return out

    def build(**kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = NodeClassificationTrainer(model, graph, features, labels, train_nodes,
                                            batch_size=BATCH, seed=0, full_graph=adj, **kwargs)
        torch.cuda.synchronize()
        return trainer, time.perf_counter() - t0

    # the collapse: one neighbour sum per GNN stage at setup, none per batch
    collapse, setup_s = part("collapse setup", NC_GNN_STAGES, build)
    if collapse.device.type != "cuda" or collapse._fg_collapse is None:
        raise AssertionError("the arxiv model must train on the GPU through the collapse")
    phi = collapse._fg_collapse.phi
    print(f"nc collapse setup: {setup_s:.4f} s (phi {tuple(phi.shape)}, "
          f"{phi.numel() * 4 / 1e9:.3f} GB)  [{card}]", flush=True)
    col_res = part("collapse epochs", 0, lambda: collapse.train(epochs))
    _report_epochs("nc collapse", col_res, card)
    del collapse, phi

    # the general path: the first stage's constant input summed once at
    # setup; each batch runs the middle stages forward and backward (the
    # first is the constant, the last seed-restricted); evaluation runs
    # stages 2.. forward
    general, setup_s = part("general setup", 1, lambda: build(fg_linear_collapse=False))
    if general._fg_collapse is not None or not general._fg_seed_restrict:
        raise AssertionError("fg_linear_collapse=False must take the seed-restricted path")
    print(f"nc general setup: {setup_s:.4f} s  [{card}]", flush=True)
    gen_res = part("general epochs", epochs * general.num_batches * 2 * (NC_GNN_STAGES - 2),
                   lambda: general.train(epochs))
    _report_epochs("nc general", gen_res, card)
    # the collapse is exact up to float associativity: the same first epoch
    rel = abs(col_res[0]["loss"] - gen_res[0]["loss"]) / abs(gen_res[0]["loss"])
    print(f"nc first-epoch loss, collapse against general: relative difference {rel:.3g} "
          f"(tolerance 1e-3)", flush=True)
    if rel > 1e-3:
        raise AssertionError("the collapse and the general path disagree")

    eval_nodes = np.setdiff1d(np.arange(ARXIV_NODES), train_nodes)
    evaluator = NodeClassificationEvaluator(general, eval_nodes)
    res = part("evaluation", NC_GNN_STAGES - 1, lambda: evaluator.evaluate(general.state))
    if res["num_evaluated"] != len(eval_nodes) or not 1.0 / ARXIV_CLASSES < res["accuracy"] <= 1:
        raise AssertionError(f"evaluation is not above chance over the eval nodes: {res}")
    print(f"nc general evaluation: accuracy {res['accuracy']:.6f} over "
          f"{int(res['num_evaluated'])} non-train nodes (chance {1 / ARXIV_CLASSES})", flush=True)
    print("nc gather-sum launches per part: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()) + f"; {general.num_batches} batches per epoch",
        flush=True)
    return counts


def compare_nc_with_cpu():
    """A small NC run on the card against the same run on the CPU (plain
    gather-sum), on both paths."""
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    n, e, f = 300, 3000, 16
    rng = np.random.default_rng(5)
    w = (np.arange(n) + 1.0) ** -1.0    # Zipf destinations: hub rows wider than 256 slots
    edges = np.stack([rng.integers(0, n, e), rng.choice(n, e, p=w / w.sum())], 1)
    _, features, labels, train_nodes = nc_data(6, edges, n, f, 5, 200)
    adj = build_full_graph_adjacency(edges, n)
    if max(b.shape[1] for b in adj.nbrs) <= 256:
        raise AssertionError("the small graph must have hub rows")
    graph = build_device_graph(edges, n)
    model = nc_model(f, (16, 16, 5))
    worst = 0.0
    for collapse in (True, False):
        cpu, gpu = [NodeClassificationTrainer(model, graph, features, labels, train_nodes,
                                              batch_size=50, seed=1, full_graph=adj,
                                              fg_linear_collapse=collapse, device=dev)
                    for dev in ("cpu", "cuda")]
        gpu._epoch_permutation = lambda s, _c=cpu, _g=gpu: _c._epoch_permutation(s).to(_g.device)
        for _ in range(2):
            lc, lg = cpu.train_epoch()["loss"], gpu.train_epoch()["loss"]
            if not math.isclose(lc, lg, rel_tol=1e-4):
                raise AssertionError(f"NC loss on the card {lg} != on the CPU {lc}")
        for a, b in zip(tree_leaves([cpu.state.params, cpu.state.opt_state.slots]),
                        tree_leaves([gpu.state.params, gpu.state.opt_state.slots])):
            b = b.detach().cpu()
            worst = max(worst, float((a.detach() - b).abs().max()))
            torch.testing.assert_close(b, a.detach(), rtol=1e-4, atol=1e-5)
    print(f"small NC run, card against CPU (collapse and general, 2 epochs): "
          f"max abs difference {worst:.3g} (tolerance rtol 1e-4, atol 1e-5)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    import marius_tpu_torch
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.ops.cuda import adagrad, build, gather

    here = Path(__file__).resolve().parent
    if Path(marius_tpu_torch.__file__).resolve().parents[1] != here:
        raise RuntimeError(f"marius_tpu_torch was imported from {marius_tpu_torch.__file__}, "
                           f"not from this checkout ({here})")

    # f32 matmuls stay full f32: TF32 would shift ranks and the card-CPU comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_name()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    rates = card_rates(kind)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build (nvcc, {len(logs)} sources in parallel): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    nc = nc_data(0, arxiv_edges(), ARXIV_NODES, ARXIV_FEATS, ARXIV_CLASSES, ARXIV_TRAIN)
    adj = build_full_graph_adjacency(nc[0], ARXIV_NODES)
    print(f"arxiv-shaped graph and adjacency on the host: {time.perf_counter() - t0:.2f} s "
          f"({adj.total_slots} padded slots, {len(adj.nbrs)} buckets, widest "
          f"{max(b.shape[1] for b in adj.nbrs)})", flush=True)

    kernels = [check_gather(gather, torch.device("cuda"), rates),
               check_adagrad(adagrad, torch.device("cuda"), rates),
               check_gather_sum(adj.to("cuda"), rates)]
    for k in kernels:
        lib = "-" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.2f} us"
        print(f"{k['name']}: max_abs_err {k['max_abs_err']} (bit for bit against the plain "
              f"version)  kernel {k['ms'] * 1e3:.2f} us  plain {k['plain_ms'] * 1e3:.2f} us  "
              f"library {lib}  bound {k['bound_ms'] * 1e3:.2f} us ({k['bound_by']})  [{card}]",
              flush=True)
    print_gather_shapes(kernels[0], card)

    launches = train_flagship(card)
    compare_lp_with_cpu()
    nc_counts = train_nc(card, adj, nc)
    compare_nc_with_cpu()

    # the gather-sum row: its launches on the NC path, each part's beside them
    launches["gather_sum"] = sum(nc_counts.values())
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] == "gather_sum":
            k["launches_by_part"] = nc_counts
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
