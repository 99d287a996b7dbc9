"""Layered neighbour sampling on the device, with static shapes.

Port of ``marius_tpu/data/samplers/neighbor.py`` (NeighborSamplingConfig
:43-51, estimate_hop_caps :54-61, estimate_hop_caps_empirical :64-141,
_sample_direction :144-182, sample_neighbor_batch :185-332,
_warn_all_truncation :335-366, resolve_all_caps_from_edges :369-391 and
resolve_all_caps :394-420; reference LayeredNeighborSampler,
neighbor.cpp:354-582). Every node gets exactly F slots and a mask: when
deg <= F each neighbour is taken once, otherwise F draws with replacement
(``rand % deg``). Each hop is deduplicated with the frontier-prefix layout
(a hop's node set is a prefix of the next), or, where a cap saturates at
num_nodes + 1, not at all (the hop set is every id). Tight caps drop the
highest new ids, masked and counted in ``NeighborBatch.overflow``, which
stays on the device.

The random numbers come through a seam, a :data:`Draws` callable: one call
per (hop, direction) gives the raw (n, F) int32 draws in [0, 2**31 - 1) and,
for DROPOUT, the (n, F) uniforms in [0, 1). :func:`generator_draws` takes
them from a ``torch.Generator``; a test can replay another generator's
numbers instead. The JAX package's ``take_1d`` is a TPU lane trick; plain
indexing takes its place.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from marius_tpu_torch.data.batch import LayerAdjacency, NeighborBatch
from marius_tpu_torch.data.graph import DeviceGraph
from marius_tpu_torch.ops.cuda import sampler as sampler_kernels
from marius_tpu_torch.ops.unique import (
    PREFIX_BITMAP_LIMIT,
    prefix_unique_padded,
    unique_padded_auto,
)
from marius_tpu_torch.reporting.profiling import span

Tensor = torch.Tensor

#: draws(depth, direction, n, fanout, dropout) -> ((n, fanout) int32 draws in
#: [0, 2**31 - 1), (n, fanout) float32 uniforms or None); direction 0 is
#: incoming, 1 outgoing; uniforms only where ``dropout``
Draws = Callable[[int, int, int, int, bool], Tuple[Tensor, Optional[Tensor]]]

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class NeighborSamplingConfig:
    """One entry per GNN layer, outermost hop first (NeighborSamplingConfig,
    marius_config.py; layer types options.h:80)."""

    sampling_type: str = "UNIFORM"   # ALL | UNIFORM | DROPOUT
    max_neighbors: int = 10          # fanout cap (datatypes.py:192)
    rate: float = 0.0                # dropout rate (DROPOUT)
    use_incoming: bool = True
    use_outgoing: bool = True


def generator_draws(generator: torch.Generator) -> Draws:
    """The sampler's numbers from ``generator``, on its device."""

    def draw(depth: int, direction: int, n: int, fanout: int, dropout: bool):
        dev = generator.device
        rand = torch.randint(0, _INT32_MAX, (n, fanout), generator=generator, device=dev,
                             dtype=torch.int32)
        uni = (torch.rand((n, fanout), generator=generator, device=dev)
               if dropout else None)
        return rand, uni

    return draw


def seeded_draws(seed: int, index: int, device) -> Draws:
    """Draws from a generator on ``device`` seeded from (seed, index): the
    same numbers for the same batch of an evaluation or an export, however
    often it runs (the JAX package folds the batch index into key(seed))."""
    s = int(np.random.SeedSequence((seed, index)).generate_state(1)[0])
    return generator_draws(torch.Generator(device=device).manual_seed(s))


def estimate_hop_caps(batch_size: int, configs: Sequence[NeighborSamplingConfig],
                      num_nodes: int) -> List[int]:
    """Worst-case unique node count per hop, innermost (seeds) to outermost."""
    caps = [batch_size]
    for cfg in reversed(list(configs)):
        fan = cfg.max_neighbors * (int(cfg.use_incoming) + int(cfg.use_outgoing))
        caps.append(min(caps[-1] * (1 + fan), num_nodes + 1))
    return caps


def estimate_hop_caps_empirical(
    edges, num_nodes: int, configs: Sequence[NeighborSamplingConfig],
    batch_size: int, seed: int = 0, trials: int = 6, margin: float = 1.35,
    seed_pool=None,
) -> List[int]:
    """Data-sized hop caps: simulate the hop expansion on the host over a few
    random seed batches and cap each hop at (max observed unique count) x
    ``margin`` (bucketed), clamped to the worst-case bound. A copy of the
    JAX function's numpy code, so the caps are the same numbers."""
    e = np.asarray(edges)
    worst = estimate_hop_caps(batch_size, configs, num_nodes)
    if not len(e):
        return worst
    rng = np.random.default_rng(seed)

    def csr(anchor, other):
        order = np.argsort(anchor, kind="stable")
        offs = np.searchsorted(anchor[order], np.arange(num_nodes + 1))
        return offs, other[order]

    out_offs, out_cols = csr(e[:, 0], e[:, -1])
    in_offs, in_cols = csr(e[:, -1], e[:, 0])

    # simulate from the seed distribution when known (train nodes cluster in
    # dense regions on real graphs; uniform seeds undershoot)
    pool = (np.asarray(seed_pool, np.int64) if seed_pool is not None
            else np.arange(num_nodes, dtype=np.int64))
    maxes = [batch_size] * (len(configs) + 1)
    for _ in range(trials):
        take = min(batch_size, len(pool))
        cur = np.unique(rng.choice(pool, take, replace=False))
        for depth, cfg in enumerate(reversed(list(configs))):
            fan = cfg.max_neighbors
            cand = [cur]
            dirs = []
            if cfg.use_incoming:
                dirs.append((in_offs, in_cols))
            if cfg.use_outgoing:
                dirs.append((out_offs, out_cols))
            for offs, cols in dirs:
                deg = offs[cur + 1] - offs[cur]
                take = np.minimum(deg, fan)
                rows = np.repeat(cur, take)
                base = np.repeat(offs[cur], take)
                rep_deg = np.repeat(deg, take)
                # as the device sampler: deg <= fanout takes each neighbour once
                slot = (np.arange(len(rows), dtype=np.int64)
                        - np.repeat(np.cumsum(take) - take, take))
                draw = rng.integers(0, 1 << 30, len(rows)) % np.maximum(rep_deg, 1)
                within = np.where(rep_deg <= fan, slot, draw)
                cand.append(cols[base + within])
            cur = np.unique(np.concatenate(cand))
            maxes[depth + 1] = max(maxes[depth + 1], len(cur))

    caps = [batch_size]
    for depth in range(1, len(configs) + 1):
        want = int(maxes[depth] * margin) + batch_size
        # bucket to ~1/8 granularity so nearby datasets share shapes
        step = 1 << max(want.bit_length() - 3, 6)
        want = -(-want // step) * step
        caps.append(min(want, worst[depth]))
    return caps


def _sample_direction(draws: Optional[Tuple[Tensor, Optional[Tensor]]], offsets: Tensor,
                      cols: Tensor, ids: Tensor, valid: Tensor, fanout: int,
                      sampling_type: str, rate: float, rels: Optional[Tensor] = None):
    """Sample up to ``fanout`` neighbours of each node in one direction.

    Returns (nbr_ids (n, F), mask (n, F), rel_ids (n, F) | None); ``draws``
    is this direction's (raw ints, uniforms), None for ALL.
    """
    n = ids.shape[0]
    safe = ids.long().clamp(max=offsets.shape[0] - 2)
    start = offsets[safe].long()
    deg = (offsets[safe + 1].long() - start)[:, None]
    slot = torch.arange(fanout, device=ids.device)[None, :]
    kind = sampling_type.upper()
    if kind == "ALL":
        # exact below the cap; the cap must cover the max degree for true ALL
        pos = slot
        mask = slot < deg
    else:
        rand = draws[0].long() % deg.clamp(min=1)
        # take each true neighbour exactly once when it fits the fanout
        pos = torch.where(deg <= fanout, slot, rand)
        mask = slot < deg.clamp(max=fanout)
    pos = torch.minimum(pos, (deg - 1).clamp(min=0))
    if kind == "DROPOUT":
        mask = mask & (draws[1] >= rate)
    mask = mask & valid[:, None]
    # a node without neighbours points one past its CSR run: JAX clamps the read
    gather_idx = (start[:, None] + pos).clamp(max=max(cols.shape[0] - 1, 0))
    nbrs = cols[gather_idx] if cols.shape[0] else torch.zeros((n, fanout), dtype=cols.dtype,
                                                                device=cols.device)
    rel_ids = None
    if rels is not None:
        rel_ids = rels[gather_idx] if rels.shape[0] else torch.zeros_like(nbrs)
    return nbrs, mask, rel_ids


def sample_neighbor_batch(
    draws: Draws,
    graph: DeviceGraph,
    seeds: Tensor,            # (B,) already deduplicated target nodes
    seed_mask: Tensor,        # (B,) bool
    configs: Sequence[NeighborSamplingConfig],  # one per GNN layer, outermost first
    hop_caps: Sequence[int],  # len == num_layers + 1, innermost (B) to outermost
) -> NeighborBatch:
    """Expand seeds outward hop by hop, dedup each hop, and emit the
    batch-local adjacency used by the encoder (the innermost config applies
    to the seed expansion). Three dedup branches, as in JAX: saturated
    (cap == num_nodes + 1: the hop set is every id, no dedup), frontier
    prefix (cap >= n), and sorted (cap < n, or graphs beyond the prefix
    bitmap limit: worst-case caps only, as a tight cap there truncates the
    sorted set).

    On CPU tensors this is :func:`sample_neighbor_batch_plain`; on CUDA
    tensors each hop runs as the kernels of ``csrc/sampler.cu``
    (``ops/cuda/sampler.py``), which give the same batch bit for bit for the
    same draws and make no host synchronisation."""
    with span("sample"):
        if seeds.device.type == "cpu":
            return sample_neighbor_batch_plain(draws, graph, seeds, seed_mask, configs, hop_caps)
        return _sample_neighbor_batch_kernels(draws, graph, seeds, seed_mask, configs, hop_caps)


def _check_caps(configs, hop_caps) -> None:
    if len(hop_caps) != len(configs) + 1:
        raise ValueError(f"{len(hop_caps)} hop caps for {len(configs)} layers")


def _sample_neighbor_batch_kernels(draws: Draws, graph: DeviceGraph, seeds: Tensor,
                                   seed_mask: Tensor, configs, hop_caps) -> NeighborBatch:
    """The CUDA path: one :func:`~marius_tpu_torch.ops.cuda.sampler.sample_hop`
    a hop, the draws taken in the plain version's order."""
    _check_caps(configs, hop_caps)
    fill = graph.num_nodes
    use_prefix = fill <= PREFIX_BITMAP_LIMIT
    ids_per_hop, masks_per_hop = [seeds], [seed_mask]
    layers: List[LayerAdjacency] = []
    overflow = torch.empty((), dtype=torch.int32, device=seeds.device)
    if not configs:
        overflow.zero_()
    cur_ids, cur_mask = seeds, seed_mask
    for depth, cfg in enumerate(reversed(list(configs))):
        n, fan = cur_ids.shape[0], cfg.max_neighbors
        kind = cfg.sampling_type.upper()
        used = (cfg.use_incoming, cfg.use_outgoing)
        d = [draws(depth, direction, n, fan, kind == "DROPOUT")
             if use and kind != "ALL" else None for direction, use in enumerate(used)]
        cap = int(hop_caps[depth + 1])
        mode = (sampler_kernels.SATURATED if cap == fill + 1 else
                sampler_kernels.PREFIX if use_prefix and cap >= n else sampler_kernels.SORTED)
        hop = sampler_kernels.sample_hop(graph, cur_ids, cur_mask, d[0], d[1], fan, kind,
                                         cfg.rate, *used, mode, cap, overflow, depth == 0)
        idx = hop.idx
        if mode == sampler_kernels.SORTED:
            # the plain sort or bitmap dedup over the hop kernel's candidates
            uniq = unique_padded_auto(hop.candidates, size=cap, fill_value=fill)
            inverse = uniq.inverse.to(torch.int32)
            nf, off, idx = n * fan, n, list(hop.idx)   # an unused direction keeps its zeros
            for direction in range(2):
                if used[direction]:
                    idx[direction] = inverse[off:off + nf].reshape(n, fan)
                    off += nf
            self_idx, next_ids = inverse[:n], uniq.ids
            next_mask = next_ids < fill
        else:
            self_idx, next_ids, next_mask = hop.self_idx, hop.next_ids, hop.next_mask
        rel = hop.rel
        layers.append(LayerAdjacency(
            self_idx=self_idx, in_nbr_idx=idx[0], in_mask=hop.mask[0], out_nbr_idx=idx[1],
            out_mask=hop.mask[1], node_mask=cur_mask,
            in_rel=rel[0] if rel is not None and used[0] else None,
            out_rel=rel[1] if rel is not None and used[1] else None))
        cur_ids, cur_mask = next_ids, next_mask
        ids_per_hop.append(cur_ids)
        masks_per_hop.append(cur_mask)
    return NeighborBatch(node_ids=tuple(reversed(ids_per_hop)),
                         node_masks=tuple(reversed(masks_per_hop)),
                         layers=tuple(reversed(layers)), overflow=overflow)


def sample_neighbor_batch_plain(
    draws: Draws,
    graph: DeviceGraph,
    seeds: Tensor,            # (B,) already deduplicated target nodes
    seed_mask: Tensor,        # (B,) bool
    configs: Sequence[NeighborSamplingConfig],  # one per GNN layer, outermost first
    hop_caps: Sequence[int],  # len == num_layers + 1, innermost (B) to outermost
) -> NeighborBatch:
    """Plain PyTorch version of :func:`sample_neighbor_batch`: the CPU path,
    and the yardstick the CUDA kernels are held to."""
    _check_caps(configs, hop_caps)
    fill = graph.num_nodes
    dev = seeds.device
    use_prefix = fill <= PREFIX_BITMAP_LIMIT
    ids_per_hop = [seeds]
    masks_per_hop = [seed_mask]
    layers: List[LayerAdjacency] = []
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    i32 = torch.int32

    cur_ids, cur_mask = seeds, seed_mask
    for depth, cfg in enumerate(reversed(list(configs))):
        n, fan = cur_ids.shape[0], cfg.max_neighbors
        kind = cfg.sampling_type.upper()
        parts = []
        in_nbrs = out_nbrs = in_mask = out_mask = in_rel = out_rel = None
        for direction, use in ((0, cfg.use_incoming), (1, cfg.use_outgoing)):
            if not use:
                continue
            d = None if kind == "ALL" else draws(depth, direction, n, fan, kind == "DROPOUT")
            if direction == 0:
                in_nbrs, in_mask, in_rel = _sample_direction(
                    d, graph.in_offsets, graph.in_cols, cur_ids, cur_mask, fan, kind,
                    cfg.rate, rels=graph.in_rels)
                parts.append(torch.where(in_mask, in_nbrs, fill).reshape(-1))
            else:
                out_nbrs, out_mask, out_rel = _sample_direction(
                    d, graph.out_offsets, graph.out_cols, cur_ids, cur_mask, fan, kind,
                    cfg.rate, rels=graph.out_rels)
                parts.append(torch.where(out_mask, out_nbrs, fill).reshape(-1))

        nbr_candidates = (torch.cat(parts) if parts
                          else torch.zeros((0,), dtype=i32, device=dev))
        cap = int(hop_caps[depth + 1])
        zero_idx = torch.zeros((n, fan), dtype=i32, device=dev)
        false_mask = torch.zeros((n, fan), dtype=torch.bool, device=dev)
        nf = n * fan

        if cap == fill + 1:
            # saturated hop: the cap covers every node id, so slot == id
            self_idx = torch.where(cur_mask, cur_ids, fill)
            in_idx = (torch.where(in_mask, in_nbrs, fill) if cfg.use_incoming else zero_idx)
            out_idx = (torch.where(out_mask, out_nbrs, fill) if cfg.use_outgoing
                       else zero_idx)
            next_ids = torch.arange(cap, dtype=i32, device=dev)
            next_mask = next_ids < fill
        elif use_prefix and cap >= n:
            uniq = prefix_unique_padded(cur_ids, cur_mask, nbr_candidates, size=cap,
                                        fill_value=fill)
            overflow = overflow + uniq.overflow
            self_idx = torch.arange(n, dtype=i32, device=dev)
            # overflowed new ids alias inside the kept range: mask any slot
            # whose mapped id differs from the candidate it came from
            ok = uniq.ids[uniq.inverse.long()] == nbr_candidates
            inverse = uniq.inverse
            off = 0
            in_idx, out_idx = zero_idx, zero_idx
            if cfg.use_incoming:
                in_idx = inverse[off:off + nf].reshape(n, fan)
                in_mask = in_mask & ok[off:off + nf].reshape(n, fan)
                off += nf
            if cfg.use_outgoing:
                out_idx = inverse[off:off + nf].reshape(n, fan)
                out_mask = out_mask & ok[off:off + nf].reshape(n, fan)
            next_ids, next_mask = uniq.ids, uniq.ids < fill
        else:
            candidates = torch.cat([torch.where(cur_mask, cur_ids, fill),
                                    nbr_candidates.to(cur_ids.dtype)])
            uniq = unique_padded_auto(candidates, size=cap, fill_value=fill)
            # the sorted set keeps jnp.unique's truncation: with more ids than
            # the cap, inverse entries point past the end (the layers clamp
            # them as JAX's gathers do)
            self_idx = uniq.inverse[:n]
            off = n
            in_idx, out_idx = zero_idx, zero_idx
            if cfg.use_incoming:
                in_idx = uniq.inverse[off:off + nf].reshape(n, fan)
                off += nf
            if cfg.use_outgoing:
                out_idx = uniq.inverse[off:off + nf].reshape(n, fan)
            next_ids, next_mask = uniq.ids, uniq.ids < fill
        if not cfg.use_incoming:
            in_mask = false_mask
        if not cfg.use_outgoing:
            out_mask = false_mask

        layers.append(LayerAdjacency(
            self_idx=self_idx.to(i32), in_nbr_idx=in_idx.to(i32), in_mask=in_mask,
            out_nbr_idx=out_idx.to(i32), out_mask=out_mask, node_mask=cur_mask,
            in_rel=in_rel, out_rel=out_rel))
        cur_ids, cur_mask = next_ids, next_mask
        ids_per_hop.append(cur_ids)
        masks_per_hop.append(cur_mask)

    # stored outermost-first, the encoder's compute order
    return NeighborBatch(node_ids=tuple(reversed(ids_per_hop)),
                         node_masks=tuple(reversed(masks_per_hop)),
                         layers=tuple(reversed(layers)), overflow=overflow)


def _warn_all_truncation(degs_in, degs_out, configs, cap_limit: int) -> None:
    """ALL semantics degrade to adjacency-prefix truncation (a hub's first
    ``cap`` CSR neighbours) where a degree exceeds ``cap_limit`` (the
    reference's ALL is unbounded, neighbor.cpp:9): log how many nodes and
    what share of neighbour mass."""
    log = logging.getLogger("marius_tpu_torch")
    for cfg in configs:
        if cfg.sampling_type.upper() != "ALL":
            continue
        degs = []
        if cfg.use_incoming and degs_in is not None:
            degs.append(np.asarray(degs_in))
        if cfg.use_outgoing and degs_out is not None:
            degs.append(np.asarray(degs_out))
        for d in degs:
            over = d > cap_limit
            n_over = int(np.count_nonzero(over))
            if n_over:
                total = float(d.sum()) or 1.0
                dropped = float((d[over] - cap_limit).sum())
                log.warning(
                    "ALL neighbor sampling capped at %d: %d nodes exceed the "
                    "cap (max degree %d); %.2f%% of neighbor mass will be "
                    "uniformly truncated each epoch. Raise all_cap_limit for "
                    "exact ALL semantics.",
                    cap_limit, n_over, int(d.max()), 100.0 * dropped / total)


def _size_all_caps(configs, max_in: int, max_out: int, cap_limit: int):
    out = []
    for cfg in configs:
        if cfg.sampling_type.upper() == "ALL":
            need = max(max_in if cfg.use_incoming else 0,
                       max_out if cfg.use_outgoing else 0, 1)
            out.append(dataclasses.replace(cfg, max_neighbors=min(need, cap_limit)))
        else:
            out.append(cfg)
    return tuple(out)


def resolve_all_caps_from_edges(configs: Sequence[NeighborSamplingConfig],
                                edges: np.ndarray, num_nodes: int,
                                cap_limit: int = 4096) -> Tuple[NeighborSamplingConfig, ...]:
    """resolve_all_caps without a built CSR: max degrees from bincount."""
    if not any(c.sampling_type.upper() == "ALL" for c in configs):
        return tuple(configs)
    e = np.asarray(edges)
    out_degs = np.bincount(e[:, 0], minlength=num_nodes) if len(e) else np.zeros(1, np.int64)
    in_degs = np.bincount(e[:, -1], minlength=num_nodes) if len(e) else np.zeros(1, np.int64)
    _warn_all_truncation(in_degs, out_degs, configs, cap_limit)
    return _size_all_caps(configs, int(in_degs.max()), int(out_degs.max()), cap_limit)


def resolve_all_caps(configs: Sequence[NeighborSamplingConfig], in_offsets, out_offsets,
                     cap_limit: int = 4096) -> Tuple[NeighborSamplingConfig, ...]:
    """Size ALL-sampling fanout caps to the graph's true max degree, which
    makes the capped ALL exact (neighbor.cpp:9); caps clamp at ``cap_limit``,
    beyond which hubs degrade to adjacency-prefix truncation. Offsets are
    the (num_nodes + 2,) CSR offsets, numpy or tensors."""
    in_offsets, out_offsets = (np.asarray(o.cpu() if isinstance(o, Tensor) else o)
                               for o in (in_offsets, out_offsets))
    in_degs = np.diff(in_offsets[:-1]) if len(in_offsets) > 2 else np.zeros(1, np.int64)
    out_degs = np.diff(out_offsets[:-1]) if len(out_offsets) > 2 else np.zeros(1, np.int64)
    if any(c.sampling_type.upper() == "ALL" for c in configs):
        _warn_all_truncation(in_degs, out_degs, configs, cap_limit)
    return _size_all_caps(configs, int(in_degs.max()), int(out_degs.max()), cap_limit)
