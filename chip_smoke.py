#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (marius_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``marius_tpu_torch/csrc`` with nvcc, holds
each against its plain PyTorch version on the card (flagship shapes and odd
shapes), times each (kernel, plain version, one-call PyTorch equivalent), then
trains the flagship workload at full width through the port's public entry
point: FB15K-237-shaped DistMult (14,541 nodes, 237 relations, 272,115
synthetic train edges, d=50, batch 1000, 10 chunks x 500 negatives, Adam
lr 0.1, row-sparse Adagrad lr 0.1) for one warm-up and two timed epochs. The
launch counters show that the trainer went through both kernels. A small
training run on the card is compared with the same run on the CPU (plain
versions, which tests/test_torch_*.py hold against the JAX package).

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches, errors, times and bounds. Any failure raises and
the script exits non-zero; without a CUDA device it exits 1 and prints no
result. It imports nothing of JAX or marius_tpu.
"""

from __future__ import annotations

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


def card_rates(name: str):
    """(bytes/s, float32 FLOP/s outside the tensor cores) from NVIDIA's data
    sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s; H100 PCIe 2.0 TB/s and 51."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    return 3.35e12, 67e12


def bound_ms(nbytes: float, ops: float, rates) -> tuple:
    t_bytes, t_ops = nbytes / rates[0], ops / rates[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def check_gather(gather, dev, rates):
    g = torch.Generator(device=dev).manual_seed(1)
    err = 0.0
    for d in ODD_DIMS:
        n, k = 1009, 4099
        table = torch.randn(n, d, device=dev, generator=g)
        ids = torch.randint(0, n + 1, (k,), device=dev, generator=g)   # n = padding id
        for idt in (torch.int64, torch.int32):
            out = gather.gather_rows(table, ids.to(idt))
            ref = gather.gather_rows_plain(table, ids.to(idt))
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"gather_rows differs from plain at d={d} ({idt})")
    table = torch.randn(NUM_NODES, DIM, device=dev, generator=g)
    ids = torch.randint(0, NUM_NODES, (GATHER_IDS,), device=dev, generator=g)
    out = gather.gather_rows(table, ids)
    err = max(err, float((out - gather.gather_rows_plain(table, ids)).abs().max()))
    if err != 0.0:
        raise AssertionError(f"gather_rows differs from plain by {err}")
    rows = int(torch.unique(ids).numel())
    nbytes = rows * DIM * 4 + GATHER_IDS * 8 + GATHER_IDS * DIM * 4
    b_ms, b_by = bound_ms(nbytes, 0.0, rates)
    return {
        "name": "gather_rows", "route": "cuda", "source": "marius_tpu_torch/csrc/gather.cu",
        "replaces": "marius_tpu/ops/pallas/gather.py:61", "max_abs_err": err,
        "ms": time_ms(lambda: gather.gather_rows(table, ids)),
        "plain_ms": time_ms(lambda: gather.gather_rows_plain(table, ids)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.index_select(table, 0, ids)),
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


def compare_with_cpu():
    """A small run on the card against the same run on the CPU (plain kernels)."""
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
    print(f"small run, card against CPU (both update branches, 2 epochs): "
          f"max abs difference {worst:.3g} (tolerance rtol 1e-4, atol 1e-5)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    import marius_tpu_torch
    from marius_tpu_torch.ops.cuda import adagrad, build, gather

    here = Path(__file__).resolve().parent
    if Path(marius_tpu_torch.__file__).resolve().parents[1] != here:
        raise RuntimeError(f"marius_tpu_torch was imported from {marius_tpu_torch.__file__}, "
                           f"not from this checkout ({here})")

    # f32 scoring stays full f32: TF32 would shift ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
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

    kernels = [check_gather(gather, torch.device("cuda"), rates),
               check_adagrad(adagrad, torch.device("cuda"), rates)]
    for k in kernels:
        lib = "-" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.2f} us"
        print(f"{k['name']}: max_abs_err {k['max_abs_err']} (bit for bit against the plain "
              f"version)  kernel {k['ms'] * 1e3:.2f} us  plain {k['plain_ms'] * 1e3:.2f} us  "
              f"library {lib}  bound {k['bound_ms'] * 1e3:.2f} us ({k['bound_by']})  [{card}]",
              flush=True)

    launches = train_flagship(card)
    compare_with_cpu()

    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
