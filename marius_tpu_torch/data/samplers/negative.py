"""Corrupt-node negative sampling on the device.

Port of ``marius_tpu/data/samplers/negative.py`` (:27-158; reference
CorruptNodeNegativeSampler, data/samplers/negative.cpp:313-366): per chunk,
``num_uniform = num_negatives * (1 - degree_fraction)`` node ids drawn
uniformly from [0, num_nodes) plus ``num_batch`` ids taken from the batch's
own edge endpoints, degree-sampled ids first. Draws come from an explicit
``torch.Generator`` on the batch's device, where the JAX version takes a PRNG
key. ``LocalFilterMode ALL`` needs the edge-key sets of the evaluation slice
and raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NegativeSamplingConfig:
    """Mirrors NegativeSamplingConfig (marius_config.py:607)."""

    num_chunks: int = 10
    negatives_per_positive: int = 500
    degree_fraction: float = 0.0
    filtered: bool = False
    # DEG (default, negative.cpp:21 deg_negative_local_filter) masks the
    # degree-sampled negative slots that reproduce their own source edge;
    # NONE disables the local filter (options.h:84 LocalFilterMode)
    local_filter_mode: str = "DEG"


class NegativeSample(NamedTuple):
    ids: Tensor                           # (num_chunks, num_negatives) node ids
    deg_sample_indices: Optional[Tensor]  # (num_chunks, num_batch) batch-edge rows or None


def sample_negatives(
    generator: torch.Generator,
    config: NegativeSamplingConfig,
    edges: Tensor,        # (B, 2|3) batch edges (padded rows allowed)
    num_nodes: int,
    inverse: bool,        # True -> corrupt src (sample from src column), else dst
) -> NegativeSample:
    """Draw one direction's negatives for a batch, on ``edges.device`` (the
    generator must live there).

    The degree-based portion takes endpoint ids from uniformly-sampled batch
    edges (negative.cpp batch_sample :7-19) — sampling frequency proportional
    to in-batch degree.
    """
    c = config.num_chunks
    n = config.negatives_per_positive
    num_batch = int(n * config.degree_fraction)
    num_uni = n - num_batch
    dev = edges.device

    uni = torch.randint(0, num_nodes, (c, num_uni), generator=generator, device=dev)
    if num_batch == 0:
        return NegativeSample(uni, None)

    rows = torch.randint(0, edges.shape[0], (c, num_batch), generator=generator, device=dev)
    col = 0 if inverse else edges.shape[1] - 1
    deg = edges[:, col][rows].to(uni.dtype)
    # deg-sampled negatives come first, matching torch::cat({deg_sample, uniform})
    # in negative.cpp:344 so downstream local filters index the same slots.
    return NegativeSample(torch.cat([deg, uni], dim=1), rows)


def deg_local_filter_mask(deg_rows: Tensor, batch_size: int, num_negatives: int) -> Tensor:
    """(B, num_negatives) bool score filter, True = mask to -1e9.

    Parity with deg_negative_local_filter (data/samplers/negative.cpp:21-48):
    degree-sampled negative slot ``t`` of chunk ``c`` is an endpoint of batch
    edge ``r = deg_rows[c, t]``; when ``r`` itself falls in chunk ``c``,
    scoring edge ``r`` against slot ``t`` reproduces edge ``r`` — a guaranteed
    false negative. Slots are the FIRST ``deg_rows.shape[1]`` columns of the
    per-chunk negative list (the concat order in sample_negatives)."""
    c, nb = deg_rows.shape
    dev = deg_rows.device
    chunk_size = -(-batch_size // c)
    own = (deg_rows // chunk_size) == torch.arange(c, device=dev)[:, None]
    rows = torch.where(own, deg_rows, torch.full_like(deg_rows, batch_size))  # miss -> dropped row
    cols = torch.arange(nb, device=dev)[None, :].expand(c, nb)
    mask = torch.zeros((batch_size + 1, num_negatives), dtype=torch.bool, device=dev)
    mask[rows.reshape(-1), cols.reshape(-1)] = True
    return mask[:batch_size]


def local_filter_masks(cfg: NegativeSamplingConfig, edges: Tensor, edge_mask: Tensor,
                       dst_ns: NegativeSample, src_ns: Optional[NegativeSample]):
    """(dst_filter, src_filter) for unfiltered training per
    cfg.local_filter_mode (getNegatives, negative.cpp:328-366): DEG masks
    deg-sampled self-collisions; either may be None when nothing applies."""
    dst_f = local_filter_mask_dir(cfg, edges, edge_mask, dst_ns, False)
    src_f = (local_filter_mask_dir(cfg, edges, edge_mask, src_ns, True)
             if src_ns is not None else None)
    return dst_f, src_f


def local_filters_active(cfg: NegativeSamplingConfig) -> bool:
    """True when local_filter_masks will produce a non-None mask for this config."""
    mode = (cfg.local_filter_mode or "DEG").upper()
    if mode == "DEG":
        return int(cfg.negatives_per_positive * cfg.degree_fraction) > 0
    return mode == "ALL"


def local_filter_mask_dir(cfg: NegativeSamplingConfig, edges: Tensor, edge_mask: Tensor,
                          ns: NegativeSample, inverse: bool) -> Optional[Tensor]:
    """One direction's local filter (see local_filter_masks); None when the
    configured mode has nothing to mask."""
    mode = (cfg.local_filter_mode or "DEG").upper()
    if mode == "DEG":
        if ns.deg_sample_indices is None:
            return None
        return deg_local_filter_mask(ns.deg_sample_indices, edges.shape[0],
                                     cfg.negatives_per_positive)
    if mode == "ALL":
        raise NotImplementedError(
            "LocalFilterMode ALL needs ops/edge_keys.py, which comes with the "
            "evaluation slice")
    return None
