"""What the per-layer metrics read from a traced run's context. Each file
``benchmark/metrics/<metric>.py`` calls one of these; a reader that finds
nothing to read returns None, and the metric is left out of the line.

The context (``cycles.run_cell``) holds the untraced window's host-clock
readings and the program's counters (``window``), the traced cycles'
summary (``trace``, ``tracing.summarise``), the model FLOPs of a batch and
of an evaluation (``flops``) and the card's peaks (``rates``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from benchmark.harness import arith


def eval_s(ctx: Dict) -> Optional[float]:
    """Mean host seconds of one validation evaluation in the window."""
    times = ctx["window"]["eval_s"]
    return float(np.mean(times)) if times else None


def truncated_ids_per_batch(ctx: Dict) -> Optional[float]:
    """Frontier ids the hop caps dropped, over the window's training batches
    (the trainer's ``truncated_frontier_ids``, read once per epoch)."""
    w = ctx["window"]
    return w["truncated_ids"] / w["train_batches"] if w["train_batches"] else None


def peak_device_gib(ctx: Dict) -> Optional[float]:
    """The allocator's peak over the window, in GiB."""
    peak = ctx["window"]["peak_bytes"]
    return peak / float(1 << 30) if peak else None


def device_ops_per_batch(ctx: Dict) -> Optional[float]:
    """Device operations (kernels, copies, sets) begun inside the traced
    epochs, over their training batches."""
    t = ctx.get("trace")
    if not t or not t["train_batches"]:
        return None
    return t["train_ops"] / t["train_batches"]


def device_idle(ctx: Dict) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(ctx: Dict, kernel: str) -> Optional[float]:
    """Percent of its roofline that ``kernel`` reached over its traced
    launches: their least times at the card's peaks over their device time."""
    t = ctx.get("trace")
    if not t:
        return None
    paired = t["kernels"].get(kernel, {}).get("paired", [])
    return arith.roofline_share(paired, ctx["rates"]) if paired else None


def mfu(ctx: Dict) -> Optional[float]:
    """Percent of the cards' float32 peak that the untraced window's model
    FLOPs (its training batches, and one validation evaluation per cycle)
    reached over the window's host seconds."""
    w, f = ctx["window"], ctx.get("flops")
    if not f or w["seconds"] <= 0:
        return None
    total = w["train_batches"] * f["train_batch"] + w["cycles"] * f["evaluation"]
    return 100.0 * total / w["seconds"] / (ctx["rates"][1] * ctx["chips"])
