"""Link-prediction evaluation: filtered (all-node) or sampled ranking.

Port of ``LinkPredictionEvaluator`` from ``marius_tpu/train/evaluator.py``
(:61-663; reference evaluator.cpp:22-96, model.cpp evaluate_batch :335-359,
reporting.cpp computeRanks :55) for CORRUPT_NODE on one device. Where the JAX
version compiles one ``lax.scan``, this one runs an eager loop over batches
and node chunks. Each batch gathers its source and destination rows with the
row-gather kernel (``gather_rows``), scores them with the decoder, and ranks
each direction:

- filtered: against ALL nodes, streamed over node chunks so that one batch
  and direction holds one (B, C) score block and never a (B, N) matrix. The
  rank is the unfiltered >=-count minus the >=-count of the edge's TRUE
  candidates (a contiguous run of the sorted edge-key set found by two binary
  searches), read from the same score block so that they cancel exactly, the
  positive included; hub-heavy key sets (tail cap above ``TAIL_CAP_LIMIT``)
  test chunk membership instead;
- unfiltered: against sampled negatives (their rows through the gather
  kernel too), with the configured local filter.

The rank sums stay on the device as float32 scalars, added in the JAX scan's
order, and are read back once per evaluation. CORRUPT_REL ranking,
``compute_pos_scores`` (only_pos_forward), host-tiled evaluation
(``evaluate_from_host_table``) and GNN or FEATURE encoders (in
``encode_all_nodes``) raise ``NotImplementedError`` naming the slice that
brings them.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from marius_tpu_torch.data.samplers.negative import (
    NegativeSample,
    NegativeSamplingConfig,
    local_filter_mask_dir,
    sample_negatives,
)
from marius_tpu_torch.nn.decoders.edge import normalize_decoder_method
from marius_tpu_torch.nn.model import Model
from marius_tpu_torch.ops.edge_keys import (
    anchor_ranges,
    build_edge_key_set,
    isin_triples,
    max_anchor_tail,
)
from marius_tpu_torch.parallel.embedding_table import gather_rows
from marius_tpu_torch.reporting.metrics import compute_ranks, rank_statistics
from marius_tpu_torch.reporting.reporters import LinkPredictionReporter
from marius_tpu_torch.train.graph_encoder import encode_all_nodes
from marius_tpu_torch.train.trainer import TrainState, _later_slice, pad_edges, resolve_device

Tensor = torch.Tensor

HITS_KS = (1, 3, 5, 10, 50, 100)

# max per-edge true-candidate pad width for the rank correction; hub-heavy
# filter sets beyond it fall back to the per-chunk membership test
TAIL_CAP_LIMIT = 32_768

_STAT_NAMES = ["count", "rr_sum", "rank_sum"] + [f"hits{k}_sum" for k in HITS_KS]


def _pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, (x - 1)).bit_length()


class LinkPredictionEvaluator:
    """Filtered (all-node) or unfiltered (sampled) ranking evaluation."""

    def __init__(
        self,
        model: Model,
        num_nodes: int,
        num_relations: int,
        eval_edges: np.ndarray,
        all_edges: Optional[np.ndarray] = None,   # train+valid+test for filtering
        batch_size: int = 1000,
        filtered: bool = True,
        neg_config: Optional[NegativeSamplingConfig] = None,
        seed: int = 7,
        node_chunk: Optional[int] = None,   # streamed-scan chunk override
        device=None,
    ):
        self.model = model
        self.num_nodes = num_nodes
        self.num_relations = num_relations
        self.batch_size = batch_size
        self.filtered = filtered
        # EdgeDecoderMethod (options.h:64); ONLY_POS is inference-only
        self.decoder_method = (normalize_decoder_method(model.decoder.decoder_method)
                               if model.decoder is not None else "CORRUPT_NODE")
        if self.decoder_method == "CORRUPT_REL":
            raise _later_slice("CORRUPT_REL evaluation (rel_all_scores)", "a later LP slice")
        if self.decoder_method != "CORRUPT_NODE":
            raise ValueError(f"evaluation supports CORRUPT_NODE/CORRUPT_REL; "
                             f"{self.decoder_method} is inference-only "
                             f"(marius_predict --save_scores)")
        self.device = resolve_device(device)
        self.neg_config = neg_config or NegativeSamplingConfig()
        self.seed = seed
        if not filtered and batch_size % self.neg_config.num_chunks:
            raise ValueError(f"evaluation batch_size {batch_size} must be divisible by "
                             f"num_chunks {self.neg_config.num_chunks}")

        padded, self.num_edges, self.num_batches = pad_edges(eval_edges, batch_size)
        self.edges = torch.as_tensor(padded, device=self.device)
        self.has_rels = padded.shape[1] == 3
        inverse_on = model.decoder.use_inverse_relations and self.has_rels

        self.dst_keys = self.src_keys = None
        self._ranges = {}
        if filtered:
            if all_edges is None:
                raise ValueError("filtered evaluation needs the full edge set")
            # sortAllEdges analogue (graph_storage.cpp:745): filter against
            # train+valid+test in both directions
            self.dst_keys = build_edge_key_set(all_edges, True, self.device)
            self.src_keys = build_edge_key_set(all_edges, False, self.device)
            # pad width of per-edge true-candidate lists, a multiple of 64
            self.dst_tail_cap = -(-max_anchor_tail(all_edges, True) // 64) * 64
            self.src_tail_cap = -(-max_anchor_tail(all_edges, False) // 64) * 64
            # each eval edge's [lo, hi) run of true candidates depends on the
            # edges alone: found once here for every batch
            rel = self.edges[:, 1] if self.has_rels else None
            self._ranges[False] = anchor_ranges(self.dst_keys, self.edges[:, 0], rel)
            if inverse_on:
                self._ranges[True] = anchor_ranges(self.src_keys, self.edges[:, -1], rel)

        # all-node scoring streams over fixed node chunks so memory stays
        # (B, chunk) whatever the graph size; 32k chunks from 4M nodes up,
        # 8k below (bench_eval_scale.py), or ``node_chunk``
        if node_chunk is not None:
            self.node_chunk = min(_pow2_ceil(num_nodes), int(node_chunk))
        else:
            self.node_chunk = min(_pow2_ceil(num_nodes),
                                  32_768 if num_nodes >= 4_000_000 else 8_192)

    # -- the seam a test may replace --------------------------------------------

    def _sample_negatives(self, edges_b: Tensor, idx: int, inverse: bool,
                          valid_rows: int) -> NegativeSample:
        """Batch ``idx``'s negatives in one direction, from a generator seeded
        by (seed, idx, direction): every evaluation draws the same ones."""
        seed = int(np.random.SeedSequence((self.seed, idx, int(inverse))).generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return sample_negatives(gen, self.neg_config, edges_b, self.num_nodes,
                                inverse=inverse, valid_rows=valid_rows)

    # ----------------------------------------------------------------------------

    def _streamed_filtered_ranks(self, encoded: Tensor, adj_anchor: Tensor, pos: Tensor,
                                 anchors: Tensor, rels: Optional[Tensor], keys,
                                 tail_cap: int, ranges) -> Tensor:
        """Filtered rank vs ALL nodes = (unfiltered >=-count) minus the
        true-candidate >=-count, plus 1 (JAX :152-211). ``ranges`` is the
        batch's (lo, hi) run of each edge's true candidates in ``keys``."""
        decoder = self.model.decoder
        num_nodes, c = self.num_nodes, self.node_chunk
        use_tail = tail_cap <= TAIL_CAP_LIMIT
        if use_tail:
            lo, hi = ranges
            rows = lo[:, None] + torch.arange(tail_cap, dtype=lo.dtype, device=lo.device)[None, :]
            tvalid = rows < hi[:, None]
            n_keys = keys.other.shape[0]
            cand = keys.other[rows.clamp(max=n_keys - 1).long()]   # (B, tail_cap)
        counts = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
        for start in range(0, num_nodes, c):
            # the last chunk is cut at N: its missing columns would be masked
            embs = encoded[start:start + c]
            width = embs.shape[0]
            scores = decoder.neg_scores(adj_anchor, embs[None], num_chunks=1)
            ge = scores >= pos[:, None]
            if use_tail:
                # subtract the true candidates in THIS chunk, read from the
                # SAME score block: exact cancellation, the positive included
                rel_col = cand - start
                in_chunk = tvalid & (rel_col >= 0) & (rel_col < width)
                g = torch.gather(scores, 1, rel_col.clamp(0, width - 1).long())
                true_ge = in_chunk & (g >= pos[:, None])
            else:
                # hub-heavy filter set: per-chunk membership test
                ids = torch.arange(start, start + width, dtype=torch.int32, device=pos.device)
                true_ge = ge & isin_triples(keys, anchors[:, None],
                                            None if rels is None else rels[:, None],
                                            ids[None, :])
            counts += ge.sum(dim=1, dtype=torch.int32) - true_ge.sum(dim=1, dtype=torch.int32)
        return counts + 1

    @staticmethod
    def _relations(params, rel: Optional[Tensor], inverse: bool) -> Optional[Tensor]:
        """The decoder's relation rows for ``rel``, from ``params`` (the state
        being evaluated, which need not be the decoder module's own)."""
        if rel is None:
            return None
        return params["decoder"]["inverse_relations" if inverse else "relations"][rel]

    def _direction_ranks(self, encoded: Tensor, adj: Tensor, pos: Tensor, edges_b: Tensor,
                         idx: int, anchors: Tensor, rel: Optional[Tensor],
                         inverse: bool) -> Tensor:
        b = edges_b.shape[0]
        if self.filtered:
            keys, cap = ((self.src_keys, self.src_tail_cap) if inverse
                         else (self.dst_keys, self.dst_tail_cap))
            lo, hi = self._ranges[inverse]
            return self._streamed_filtered_ranks(
                encoded, adj, pos, anchors, rel, keys, cap,
                (lo[idx * b:(idx + 1) * b], hi[idx * b:(idx + 1) * b]))
        cfg = self.neg_config
        # the final batch is zero-padded: cap in-batch (degree-fraction)
        # sampling at the real row count or node 0 gets over-drawn
        valid_rows = min(max(self.num_edges - idx * b, 1), b)
        ns = self._sample_negatives(edges_b, idx, inverse, valid_rows)
        neg_e = gather_rows(encoded, ns.ids.reshape(-1).contiguous()).reshape(
            cfg.num_chunks, cfg.negatives_per_positive, -1)
        neg = self.model.decoder.neg_scores(adj, neg_e, cfg.num_chunks)
        # local (in-batch) false-negative filter, eval-config parity
        # (dataloader.cpp:39-40 passes the eval local_filter_mode)
        row_mask = torch.arange(b, device=edges_b.device) < valid_rows
        f = local_filter_mask_dir(cfg, edges_b, row_mask, ns, inverse)
        if f is not None:
            neg = neg.masked_fill(f, -1e9)
        return compute_ranks(pos, neg)

    def _batch_directions(self, encoded: Tensor, params, edges_b: Tensor, idx: int):
        """Per-direction (ranks, pos_scores) for one batch; shared by
        evaluate() and compute_all_ranks()."""
        decoder = self.model.decoder
        src = edges_b[:, 0].contiguous()
        dst = edges_b[:, -1].contiguous()
        rel = edges_b[:, 1] if self.has_rels else None
        src_e = gather_rows(encoded, src)
        dst_e = gather_rows(encoded, dst)

        # corrupt dst: anchor = src
        adj_src = decoder.apply_relation(src_e, self._relations(params, rel, False))
        pos = decoder.pos_scores(adj_src, dst_e)
        directions = [(self._direction_ranks(encoded, adj_src, pos, edges_b, idx, src, rel,
                                             False), pos)]
        if decoder.use_inverse_relations and rel is not None:
            adj_dst = decoder.apply_relation(dst_e, self._relations(params, rel, True))
            inv_pos = decoder.pos_scores(adj_dst, src_e)
            directions.append((self._direction_ranks(encoded, adj_dst, inv_pos, edges_b, idx,
                                                     dst, rel, True), inv_pos))
        return directions

    def _batches(self):
        b = self.batch_size
        for idx in range(self.num_batches):
            yield idx, self.edges[idx * b:(idx + 1) * b]

    def _encode(self, state: TrainState) -> Tensor:
        """All-node encoder outputs, shared by evaluate() and compute_all_ranks()."""
        table_values = state.table.values if state.table is not None else None
        return encode_all_nodes(self.model, state.params, table_values).contiguous()

    @torch.no_grad()
    def compute_all_ranks(self, state: TrainState, encoded: Optional[Tensor] = None):
        """Per-edge (rank, positive score) for every eval edge and corruption
        direction — the data behind marius_predict's ranks/scores export
        (LinkPredictionReporter::save, reporting.cpp:97-181).

        Returns (ranks int32, scores float32) numpy arrays of shape
        (num_directions, E).
        """
        if encoded is None:
            encoded = self._encode(state)
        ranks, scores = [], []
        for idx, edges_b in self._batches():
            outs = self._batch_directions(encoded, state.params, edges_b, idx)
            ranks.append(torch.stack([o[0] for o in outs]))
            scores.append(torch.stack([o[1] for o in outs]))
        ranks = torch.cat(ranks, dim=1).cpu().numpy()
        scores = torch.cat(scores, dim=1).cpu().numpy()
        return ranks[:, :self.num_edges], scores[:, :self.num_edges]

    def compute_pos_scores(self, state: TrainState, encoded: Optional[Tensor] = None):
        raise _later_slice("positive-only scoring (only_pos_forward)", "a later LP slice")

    def evaluate_from_host_table(self, host_values, params, edge_slice: int = 4096,
                                 node_tile: int = 262_144, features_host=None):
        raise _later_slice("host-tiled evaluation", "the out-of-core LP slice (A9)")

    @torch.no_grad()
    def _rank_sums(self, encoded: Tensor, params) -> Dict[str, float]:
        """The scan's float32 sums, batch by batch and direction by direction,
        read back once."""
        stats = {k: torch.zeros((), dtype=torch.float32, device=self.device)
                 for k in _STAT_NAMES}
        positions = torch.arange(self.batch_size, device=self.device)
        for idx, edges_b in self._batches():
            mask_b = positions + idx * self.batch_size < self.num_edges
            for ranks, _ in self._batch_directions(encoded, params, edges_b, idx):
                s = rank_statistics(ranks, mask_b, HITS_KS)
                stats = {k: stats[k] + s[k] for k in _STAT_NAMES}
        return dict(zip(_STAT_NAMES, torch.stack([stats[k] for k in _STAT_NAMES]).tolist()))

    def evaluate(self, state: TrainState, encoded: Optional[Tensor] = None) -> Dict[str, float]:
        t0 = time.perf_counter()
        if encoded is None:
            encoded = self._encode(state)
        stats = self._rank_sums(encoded, state.params)
        dt = time.perf_counter() - t0
        reporter = LinkPredictionReporter(HITS_KS)
        reporter.add_statistics(stats)
        results = reporter.results()
        results["eval_time_s"] = dt
        reporter.report()
        return results
