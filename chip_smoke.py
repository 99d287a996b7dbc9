#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (marius_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``marius_tpu_torch/csrc`` with nvcc (one
process per source, in parallel), holds each against its plain PyTorch
version on the card (main-path shapes and odd shapes, bit for bit), times each
(kernel, plain version, one-call PyTorch equivalent, bound; the row gather
also at the out-of-core batch, 30,000 distinct ids into a 17.2 GB partition
buffer, and at K = 1, the launch floor), then drives the
port's main paths through their public entry points, each with the launch
counters set to 0 just before it and read just after:

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
   on the non-train nodes), through the bucketed neighbour gather-sum;
3. config-driven LP through the manager (``lp_manager``): a synthetic dataset of
   FB15K-237's shape and split sizes (14,541 nodes, 237 relations, 272,115 /
   17,535 / 20,466 uniform edges from seed 0) written with the port's
   ``storage/dataset.py``, ``examples/configuration/fb15k_237.yaml`` loaded
   by the port's ``load_config`` with only dataset_dir and model_dir
   redirected and num_epochs cut from 10 to 3, ``marius_train`` (a filtered
   valid evaluation after each epoch, the filtered test evaluation at the
   end, the model saved), then ``marius_eval`` on the same config, which must
   reload the checkpoint and reproduce the test metrics exactly. The row
   gather is counted apart for training (one per batch) and evaluation (two
   per batch: source and destination rows).

Then ``lp_accuracy``: DistMult, ComplEx and TransE trained on the card on the
realizable knowledge graphs of tests/test_accuracy_regression.py (copied
here), whose filtered test MRR and Hits@10 must land in the JAX package's
pinned bands.

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
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import yaml

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
# FB15K-237's published split sizes, and the one cut of fb15k_237.yaml (10 epochs)
FB_VALID, FB_TEST, LP_MANAGER_EPOCHS = 17_535, 20_466, 3
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
    """The row gather timed, and checked bit for bit, at four shapes:
    the flagship batch (K = 12,000 int64 ids into the 14,541 x 50 table,
    L2-resident), the evaluation batch (the source column of 1,000 edges, made
    contiguous, into the same table, as int64 as the evaluator holds it and as
    int32), the out-of-core batch (30,000 sorted distinct ids padded with N
    into the 43,027,080 x 100 partition buffer, cycling through 16 batches so
    rows come from HBM) and the launch floor (K = 1, flagship table)."""
    from marius_tpu_torch.ops.unique import unique_padded
    from marius_tpu_torch.train.trainer import pad_edges

    g = torch.Generator(device=dev).manual_seed(4)
    table = torch.randn(NUM_NODES, DIM, device=dev, generator=g)
    ids = torch.randint(0, NUM_NODES, (GATHER_IDS,), device=dev, generator=g)
    err = max(gather_max_err(gather, table, ids), gather_max_err(gather, table, ids[:1]))
    eval_edges = torch.as_tensor(pad_edges(synthetic_edges(5, NUM_NODES, NUM_RELS, BATCH),
                                           BATCH)[0], device=dev)
    eval_ids = [eval_edges[:, col].contiguous() for col in (0, -1)]
    for col in eval_ids:
        for idt in (torch.int64, torch.int32):
            err = max(err, gather_max_err(gather, table, col.to(idt)))
    shapes = {"flagship": time_gather(gather, table, [ids], rates),
              "eval_batch": time_gather(gather, table, eval_ids, rates),
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
    for name in [n for n in ("flagship", "eval_batch", "out_of_core", "k1_floor")
                 if n in shapes]:
        s = shapes[name]
        print(f"gather_rows, {name} (K={s['k']}, d={s['d']}, {s['distinct_rows']:.1f} distinct "
              f"rows, {s['bound_bytes'] / 1e6:.4f} MB): kernel {s['ms'] * 1e3:.2f} us  plain "
              f"{s['plain_ms'] * 1e3:.2f} us  index_select {s['library_ms'] * 1e3:.2f} us  bound "
              f"{s['bound_ms'] * 1e3:.2f} us ({s['bound_by']})  [{card}]", flush=True)


def check_gather(gather, dev, rates):
    """Bit for bit against the plain version at every vector width, at tables
    that are views 4 and 8 bytes into their storage, at K = 1, 33 and 4,099,
    with both id types and ids below 0 and at or above N; then checked and
    timed at the flagship, evaluation, out-of-core and K = 1 shapes."""
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
        "eval_batch": shapes["eval_batch"], "out_of_core": shapes["out_of_core"],
        "k1_floor": shapes["k1_floor"],
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


def lp_model(num_rels: int, dim: int, decoder: str = "DISTMULT"):
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import LINK_PREDICTION, Model

    return Model(LINK_PREDICTION,
                 EncoderConfig(((LayerConfig(layer_type="EMBEDDING", output_dim=dim),),)),
                 EdgeDecoder(decoder, num_rels, dim))


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


def compare_eval_with_cpu():
    """LP evaluation on the card against the CPU: ranks equal exactly. The
    table and relations are multiples of 1/4 in [-2, 2] at d = 32, so every
    score is exact in float32 in any order of addition and ties are common;
    300 nodes in chunks of 128 (the last partial), 250 edges (and 3
    repeated) in batches of 64 (the last partial), typed, inverse relations
    on; DistMult and ComplEx; filtered through the true-candidate list and
    through the per-chunk membership test, and sampled with the ALL local
    filter on negatives injected into both."""
    from marius_tpu_torch.convert import copy_train_state_
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.train import evaluator as evaluator_mod
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    n, r, d, e, b = 300, 5, 32, 1200, 64
    rng = np.random.default_rng(9)
    edges = synthetic_edges(9, n, r, e)
    hub = np.stack([np.full(80, 7), np.full(80, 1), rng.integers(0, n, 80)], 1)
    edges = np.concatenate([edges, hub.astype(np.int32)])   # a run of 80 true tails
    test = edges[rng.permutation(len(edges))[:250]]
    test = np.concatenate([test, test[:3]])
    neg = NegativeSamplingConfig(num_chunks=4, negatives_per_positive=16,
                                 degree_fraction=0.25, local_filter_mode="ALL")

    def inject(ev):
        ev._sample_negatives = lambda edges_b, idx, inverse, valid_rows: _batch_negatives(
            neg, edges_b, n, inverse)
        return ev

    checked = 0
    for decoder in ("DISTMULT", "COMPLEX"):
        # a model each: the decoder's relation tables live on its module
        models = [lp_model(r, d, decoder) for _ in range(2)]
        cpu, gpu = (LinkPredictionTrainer(m, n, r, edges, neg, batch_size=b, seed=1,
                                          device=dev).state
                    for m, dev in zip(models, ("cpu", "cuda")))
        with torch.no_grad():
            for t in [cpu.table.values] + list(cpu.params["decoder"].values()):
                t.copy_(torch.from_numpy(rng.integers(-8, 9, t.shape).astype(np.float32) / 4))
        copy_train_state_(gpu, cpu)
        for filtered, tail_limit in ((True, evaluator_mod.TAIL_CAP_LIMIT), (True, 0),
                                     (False, evaluator_mod.TAIL_CAP_LIMIT)):
            limit, evaluator_mod.TAIL_CAP_LIMIT = evaluator_mod.TAIL_CAP_LIMIT, tail_limit
            try:
                evs = [inject(evaluator_mod.LinkPredictionEvaluator(
                    m, n, r, test, all_edges=edges, batch_size=b, filtered=filtered,
                    neg_config=neg, node_chunk=128, device=dev))
                    for m, dev in zip(models, ("cpu", "cuda"))]
                (rc, sc), (rg, sg) = (ev.compute_all_ranks(s) for ev, s in zip(evs, (cpu, gpu)))
                res = [ev.evaluate(s) for ev, s in zip(evs, (cpu, gpu))]
            finally:
                evaluator_mod.TAIL_CAP_LIMIT = limit
            what = f"{decoder}, {'filtered' if filtered else 'sampled'}, tail limit {tail_limit}"
            if rc.shape != (2, len(test)) or not (np.array_equal(rc, rg)
                                                  and np.array_equal(sc, sg)):
                raise AssertionError(f"ranks or scores on the card differ from the CPU ({what})")
            if not (rc > 1).any():
                raise AssertionError(f"no rank above 1: the comparison is vacuous ({what})")
            for k in res[0]:
                if k != "eval_time_s" and not math.isclose(res[0][k], res[1][k], rel_tol=1e-6):
                    raise AssertionError(f"evaluate()[{k!r}] on the card {res[1][k]} != on the "
                                         f"CPU {res[0][k]} ({what})")
            checked += rc.size
    print(f"small LP evaluation, card against CPU (DistMult and ComplEx; filtered with both "
          f"correction paths, sampled with the ALL filter; 3 node chunks, partial last batch): "
          f"{checked} ranks equal exactly, evaluate() within rtol 1e-6", flush=True)


# -- config-driven LP through the manager ---------------------------------------

def write_fb15k_shaped(directory: str) -> None:
    """Uniform edges from seed 0 in FB15K-237's shape and split sizes, in the
    dataset layout (storage/dataset.py) that marius_tpu.tools.preprocess writes."""
    from marius_tpu_torch.storage.dataset import DatasetStats, save_split, save_stats

    edges = synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES + FB_VALID + FB_TEST)
    splits = {"train": edges[:NUM_EDGES], "valid": edges[NUM_EDGES:NUM_EDGES + FB_VALID],
              "test": edges[NUM_EDGES + FB_VALID:]}
    for name, part in splits.items():
        save_split(directory, name, part)
    save_stats(directory, DatasetStats(
        num_nodes=NUM_NODES, num_edges=len(edges), num_relations=NUM_RELS, num_edge_cols=3,
        num_train=NUM_EDGES, num_valid=FB_VALID, num_test=FB_TEST))


def lp_manager(card: str) -> dict:
    """fb15k_237.yaml through marius_train and marius_eval on the card.
    Returns {part: gather launches} and the Adagrad launches."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.train import evaluator as evaluator_mod

    config = Path(__file__).resolve().parent / "examples" / "configuration" / "fb15k_237.yaml"
    with open(config) as f:
        raw = yaml.safe_load(f)
    metric_keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    # each evaluation's gather launches, counted around evaluate()
    evals = []
    evaluate = evaluator_mod.LinkPredictionEvaluator.evaluate

    def counted(self, state, encoded=None):
        before = gather.launches
        res = evaluate(self, state, encoded)
        evals.append((self.num_batches, gather.launches - before))
        return res

    with tempfile.TemporaryDirectory() as tmp:
        write_fb15k_shaped(f"{tmp}/dataset")
        raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
        epochs_in_yaml = raw["training"]["num_epochs"]
        raw["training"]["num_epochs"] = LP_MANAGER_EPOCHS
        cfg = load_config(raw, model_dir=f"{tmp}/model")
        print(f"lp_manager: {config.relative_to(config.parents[2])} with dataset_dir and "
              f"model_dir redirected; one cut: num_epochs {epochs_in_yaml} -> "
              f"{LP_MANAGER_EPOCHS}", flush=True)
        evaluator_mod.LinkPredictionEvaluator.evaluate = counted
        try:
            gather.launches = adagrad.launches = 0
            out = marius_train(cfg)   # device=None: the GPU
            train_total, adagrad_launches = gather.launches, adagrad.launches
            train_evals = list(evals)
            gather.launches = 0
            again = marius_eval(cfg)
            reload_total = gather.launches
        finally:
            evaluator_mod.LinkPredictionEvaluator.evaluate = evaluate
        meta_written = Path(f"{tmp}/model/meta.yaml").exists()

    rt = out["runtime"]
    trainer, test_ev = rt.trainer, rt.test_evaluator
    if trainer.device.type != "cuda" or test_ev.device.type != "cuda":
        raise AssertionError("marius_train must run on the GPU")
    losses = [e["loss"] for e in out["epochs"]]
    for i, e in enumerate(out["epochs"]):
        print(f"lp_manager epoch {i}: loss {e['loss']:.6f}  {e['epoch_time_s']:.4f} s  "
              f"{e['edges_per_sec']:.1f} edges/s  [{card}]", flush=True)
    if len(losses) != LP_MANAGER_EPOCHS or not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"lp_manager losses are not finite and falling: {losses}")
    valid = out["evals"]
    if [v["epoch"] for v in valid] != list(range(1, LP_MANAGER_EPOCHS + 1)) or "test" not in out:
        raise AssertionError("a valid evaluation must run after each epoch and a test "
                             "evaluation at the end")
    for res in valid + [out["test"]]:
        print(f"lp_manager {res['split']} (epoch {res.get('epoch', LP_MANAGER_EPOCHS)}): "
              f"filtered MRR {res['mrr']:.6f}  Hits@1 {res['hits@1']:.6f}  "
              f"Hits@10 {res['hits@10']:.6f}  mean rank {res['mean_rank']:.2f}  over "
              f"{int(res['num_evaluated'])} ranks  {res['eval_time_s']:.4f} s  [{card}]",
              flush=True)
        if not 0.0 < res["mrr"] <= 1.0:
            raise AssertionError(f"MRR out of (0, 1]: {res}")
    if not meta_written:
        raise AssertionError("marius_train did not write meta.yaml")
    test, reloaded = out["test"], again["test"]
    if any(test[k] != reloaded[k] for k in metric_keys):
        raise AssertionError(f"marius_eval's test metrics {reloaded} differ from "
                             f"marius_train's {test}")
    s = test["eval_time_s"]
    print(f"lp_manager test evaluation: {s:.4f} s (marius_eval: {reloaded['eval_time_s']:.4f} s)"
          f" for {FB_TEST} edges in {test_ev.num_batches} batches of {test_ev.batch_size}, "
          f"both directions: {FB_TEST / s:.1f} edges/s, {test['num_evaluated'] / s:.1f} ranks/s; "
          f"node_chunk {test_ev.node_chunk}, tail_cap dst {test_ev.dst_tail_cap} "
          f"src {test_ev.src_tail_cap}  [{card}]", flush=True)
    print("lp_manager: marius_eval reloaded the checkpoint and reproduced the test metrics "
          "exactly", flush=True)

    train_batches = LP_MANAGER_EPOCHS * trainer.num_batches
    eval_launches = sum(n for _, n in train_evals)
    counts = {"lp_manager train": train_total - eval_launches,
              "lp_manager eval": eval_launches, "lp_manager marius_eval": reload_total}
    if counts["lp_manager train"] != train_batches or adagrad_launches != train_batches:
        raise AssertionError(f"lp_manager training launched the gather "
                             f"{counts['lp_manager train']} and Adagrad {adagrad_launches} "
                             f"times, expected {train_batches} (one per batch)")
    for batches, n in evals:
        if n != 2 * batches:
            raise AssertionError(f"an evaluation of {batches} batches launched the gather "
                                 f"{n} times, expected {2 * batches}")
    print("lp_manager gather launches: " + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f" ({len(train_evals)} evaluations in marius_train, 2 per batch)", flush=True)
    return {"gather_rows": counts, "sparse_adagrad_update_": adagrad_launches}


# -- pinned accuracy bands (tests/test_accuracy_regression.py:40-147) ------------

def make_realizable_kg(n=500, d=8, r=10, per=4, seed=0):
    """Edges = top-``per`` DistMult scores per (node, relation) under a
    random ground-truth factorization."""
    rng = np.random.default_rng(seed)
    E = rng.normal(0, 1, (n, d))
    R = rng.normal(0, 1, (r, d))
    edges = []
    for rel in range(r):
        scores = (E * R[rel]) @ E.T
        np.fill_diagonal(scores, -np.inf)
        top = np.argsort(-scores, axis=1)[:, :per]
        for u in range(n):
            for v in top[u]:
                edges.append((u, rel, v))
    edges = np.array(edges, np.int32)
    rng.shuffle(edges)
    return edges


def make_complex_kg(n=500, d2=8, r=10, per=4, seed=0):
    """Edges = top-``per`` ComplEx scores per (node, relation) under a random
    complex ground-truth factorization."""
    rng = np.random.default_rng(seed)
    e_re, e_im = rng.normal(0, 1, (n, d2)), rng.normal(0, 1, (n, d2))
    r_re, r_im = rng.normal(0, 1, (r, d2)), rng.normal(0, 1, (r, d2))
    edges = []
    for rel in range(r):
        s_re = e_re * r_re[rel] - e_im * r_im[rel]
        s_im = e_re * r_im[rel] + e_im * r_re[rel]
        scores = s_re @ e_re.T + s_im @ e_im.T
        np.fill_diagonal(scores, -np.inf)
        top = np.argsort(-scores, 1)[:, :per]
        for u in range(n):
            for v in top[u]:
                edges.append((u, rel, v))
    edges = np.array(edges, np.int32)
    rng.shuffle(edges)
    return edges


def make_transe_kg(n=500, d=16, r=10, per=4, seed=1):
    """Edges = the ``per`` nearest neighbours of e_u + t_rel under L2."""
    rng = np.random.default_rng(seed)
    e = rng.normal(0, 1, (n, d))
    t = rng.normal(0, 0.3, (r, d))
    edges = []
    for rel in range(r):
        dist = np.linalg.norm((e[:, None, :] + t[rel]) - e[None, :, :], axis=2)
        np.fill_diagonal(dist, np.inf)
        top = np.argsort(dist, 1)[:, :per]
        for u in range(n):
            for v in top[u]:
                edges.append((u, rel, v))
    edges = np.array(edges, np.int32)
    rng.shuffle(edges)
    return edges


def run_lp_band(edges, decoder_type, dim, epochs=60, n=500, r=10, seed=0, device=None):
    """_run_lp of tests/test_accuracy_regression.py:129-147, on the card
    (``device=None``)."""
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import LINK_PREDICTION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig
    from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    tr, va = int(0.9 * len(edges)), int(0.95 * len(edges))
    train, test = edges[:tr], edges[va:]
    model = Model(LINK_PREDICTION,
                  EncoderConfig(((LayerConfig(layer_type="EMBEDDING", output_dim=dim),),)),
                  EdgeDecoder(decoder_type, num_relations=r, embedding_dim=dim),
                  loss_type="SOFTMAX_CE", loss_reduction="SUM",
                  dense_optimizer=OptimizerConfig("ADAGRAD", learning_rate=0.1), sparse_lr=0.1)
    neg = NegativeSamplingConfig(num_chunks=4, negatives_per_positive=128)
    trainer = LinkPredictionTrainer(model, n, r, train, neg, batch_size=500, seed=seed,
                                    device=device)
    for _ in range(epochs):
        trainer.train_epoch()
    ev = LinkPredictionEvaluator(model, n, r, test, all_edges=edges, batch_size=500,
                                 filtered=True, device=device)
    return ev.evaluate(trainer.state)


# (decoder, generator, dim, MRR band, Hits@10 floor): test_accuracy_regression.py:70-166
ACCURACY_BANDS = (("DISTMULT", make_realizable_kg, 32, (0.34, 0.45), 0.60),
                  ("COMPLEX", make_complex_kg, 32, (0.23, 0.35), 0.45),
                  ("TRANSE", make_transe_kg, 16, (0.15, 0.27), 0.28))


def lp_accuracy(card: str) -> None:
    for decoder, make, dim, (lo, hi), hits_floor in ACCURACY_BANDS:
        t0 = time.perf_counter()
        res = run_lp_band(make(), decoder, dim)
        print(f"lp_accuracy {decoder}: filtered MRR {res['mrr']:.6f} (band [{lo}, {hi}])  "
              f"Hits@10 {res['hits@10']:.6f} (floor {hits_floor})  60 epochs + evaluation "
              f"{time.perf_counter() - t0:.2f} s  [{card}]", flush=True)
        if not (lo <= res["mrr"] <= hi and res["hits@10"] >= hits_floor):
            raise AssertionError(f"{decoder} misses its pinned band: {res}")


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

    flagship = train_flagship(card)
    compare_lp_with_cpu()
    compare_eval_with_cpu()
    nc_counts = train_nc(card, adj, nc)
    compare_nc_with_cpu()
    manager = lp_manager(card)
    lp_accuracy(card)

    # each row's launches: the sum over the paths it runs on, each part's beside it
    by_part = {
        "gather_rows": {"lp flagship": flagship["gather_rows"], **manager["gather_rows"]},
        "sparse_adagrad_update_": {"lp flagship": flagship["sparse_adagrad_update_"],
                                   "lp_manager train": manager["sparse_adagrad_update_"]},
        "gather_sum": nc_counts,
    }
    for k in kernels:
        k["launches"] = sum(by_part[k["name"]].values())
        k["launches_by_part"] = by_part[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
