"""Link-prediction evaluation: filtered (all-node) or sampled ranking.

Port of ``LinkPredictionEvaluator`` from ``marius_tpu/train/evaluator.py``
(:61-663; reference evaluator.cpp:22-96, model.cpp evaluate_batch :335-359,
reporting.cpp computeRanks :55) on one device. Where the JAX
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
order, and are read back once per evaluation. A table that is not on the
evaluator's device (a partition-buffer trainer's host table) is moved there
whole for ``evaluate``; ``evaluate_from_host_table`` instead keeps it in host
RAM and streams it through the device in node tiles (JAX :413-576).

Every node's encoding comes from ``encode_all_nodes`` before the batches
are scored: one pass over the table for a shallow encoder; node tiles
through the neighbour sampler for a GNN encoder (``graph`` and
``nbr_configs``, the draws of a fixed per-tile seed, so every evaluation of
one state gives the same ranks); one full-graph pass with ``full_graph``
(exact ALL). FEATURE stages read ``features``, the (N + 1, F) block with a
zero sentinel row.

CORRUPT_REL ranks the true relation against ALL relations (``_rel_directions``,
JAX :222-251; the relation table is small, so the (B, R) block is scored
whole): filtered, every relation r' with (src, r', dst) a known triple is
masked with -1e9, in both directions against the forward key set, the
positive's own column included; unfiltered, only the positive's column.
Host-tiled evaluation streams node corruption and refuses CORRUPT_REL, as
JAX does. ``compute_pos_scores`` is ONLY_POS scoring (only_pos_forward).

With ``mesh``, the state is a mesh trainer's: its table is this rank's rows,
and every rank assembles the whole table with one all_gather over the node
axis before encoding (what XLA does when the JAX evaluator reads a
row-sharded global array), then evaluates it whole; host-streamed
evaluation assembles it on the host instead, one shard at a time.
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
from marius_tpu_torch.parallel.mesh import gather_table, gather_table_to_host
from marius_tpu_torch.reporting.metrics import compute_ranks, rank_statistics
from marius_tpu_torch.reporting.profiling import count, span
from marius_tpu_torch.reporting.reporters import LinkPredictionReporter
from marius_tpu_torch.storage import transfer
from marius_tpu_torch.train.graph_encoder import encode_all_nodes, encode_all_nodes_host
from marius_tpu_torch.train.trainer import TrainState, pad_edges, resolve_device

Tensor = torch.Tensor

HITS_KS = (1, 3, 5, 10, 50, 100)

# max per-edge true-candidate pad width for the rank correction; hub-heavy
# filter sets beyond it fall back to the per-chunk membership test
TAIL_CAP_LIMIT = 32_768

# host-tiled evaluation stages one (edge_slice, tail_cap) true-candidate
# block per edge slice on the device, reused by every node tile; beyond this
# many bytes (E x tail_cap x 5 in all) the per-chunk membership test runs
HOST_EVAL_CAND_BUDGET_BYTES = 2 << 30

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
        graph=None,                 # DeviceGraph, required for GNN encoders
        nbr_configs=(),             # eval-time NeighborSamplingConfigs
        features: Optional[Tensor] = None,   # (N + 1, F) with the sentinel row
        full_graph=None,            # FullGraphAdjacency: exact-ALL one-pass encoding
        fg_ops=None,                # its prepared ops (prepare_full_graph), else per call
        node_chunk: Optional[int] = None,   # streamed-scan chunk override
        mesh=None,                  # the mesh whose trainer's states it evaluates
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
        if self.decoder_method not in ("CORRUPT_NODE", "CORRUPT_REL"):
            raise ValueError(f"evaluation supports CORRUPT_NODE/CORRUPT_REL; "
                             f"{self.decoder_method} is inference-only "
                             f"(marius_predict --save_scores)")
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        self.mesh = mesh
        self.neg_config = neg_config or NegativeSamplingConfig()
        self.seed = seed
        self.graph = None if graph is None else graph.to(self.device)
        self.nbr_configs = tuple(nbr_configs)
        self.features = None if features is None else features.to(self.device)
        self.full_graph = None if full_graph is None else full_graph.to(self.device)
        self._fg_ops = fg_ops
        if not filtered and batch_size % self.neg_config.num_chunks:
            raise ValueError(f"evaluation batch_size {batch_size} must be divisible by "
                             f"num_chunks {self.neg_config.num_chunks}")

        padded, self.num_edges, self.num_batches = pad_edges(eval_edges, batch_size)
        self.edges = torch.as_tensor(padded, device=self.device)
        self.has_rels = padded.shape[1] == 3
        if self.decoder_method == "CORRUPT_REL" and not self.has_rels:
            raise ValueError("CORRUPT_REL needs a 3-column (typed) edge list")
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
            if self.decoder_method == "CORRUPT_NODE":
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

    def _rel_directions(self, encoded: Tensor, params, edges_b: Tensor):
        """CORRUPT_REL ranking (JAX :222-251): the true relation against
        every relation, per direction."""
        decoder = self.model.decoder
        src = edges_b[:, 0].contiguous()
        dst = edges_b[:, -1].contiguous()
        rel = edges_b[:, 1]
        src_e = gather_rows(encoded, src)
        dst_e = gather_rows(encoded, dst)
        cand = torch.arange(self.num_relations, dtype=rel.dtype, device=rel.device)
        if self.filtered:
            mask = isin_triples(self.dst_keys, src[:, None], cand[None, :], dst[:, None])
        else:
            mask = cand[None, :] == rel[:, None]
        directions = []
        for inverse in ((False, True) if decoder.use_inverse_relations else (False,)):
            a_e, o_e = (dst_e, src_e) if inverse else (src_e, dst_e)
            table = params["decoder"]["inverse_relations" if inverse else "relations"]
            scores = decoder.rel_all_scores(a_e, o_e, inverse=inverse, table=table)
            pos = torch.gather(scores, 1, rel[:, None].long())[:, 0]
            neg = scores.masked_fill(mask, -1e9)
            directions.append((compute_ranks(pos, neg), pos))
        return directions

    def _batch_directions(self, encoded: Tensor, params, edges_b: Tensor, idx: int):
        """Per-direction (ranks, pos_scores) for one batch; shared by
        evaluate() and compute_all_ranks()."""
        if self.decoder_method == "CORRUPT_REL":
            return self._rel_directions(encoded, params, edges_b)
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

    def table_values(self, state: TrainState, on_device: bool = True) -> Optional[Tensor]:
        """The whole table's values, assembled over the mesh's node axis for
        a mesh trainer's state (every rank calls it): on the evaluator's
        device (a table elsewhere, such as a partition-buffer trainer's host
        table, is moved there), or with ``on_device=False`` on the host,
        never whole on the device (host-streamed evaluation)."""
        if state.table is None:
            return None
        values = state.table.values
        if not on_device:
            if self.mesh is not None:
                return gather_table_to_host(values, self.mesh)[:self.num_nodes]
            return values.cpu()
        if self.mesh is not None:
            values = gather_table(values, self.mesh)[:self.num_nodes]
        return values.to(self.device)

    def _encode(self, state: TrainState) -> Tensor:
        """All-node encoder outputs, shared by evaluate() and compute_all_ranks()."""
        table_values = self.table_values(state)
        return encode_all_nodes(
            self.model, state.params, table_values, graph=self.graph,
            nbr_configs=self.nbr_configs, features=self.features,
            batch_size=self.batch_size, full_graph=self.full_graph,
            fg_ops=self._fg_ops).contiguous()

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

    @torch.no_grad()
    def compute_pos_scores(self, state: TrainState,
                           encoded: Optional[Tensor] = None) -> np.ndarray:
        """Positive-edge scores per direction, no corruption: ONLY_POS /
        INFER (only_pos_forward, decoder_methods.cpp:7-42; JAX :623-647),
        behind marius_predict's score export. Returns (num_directions, E)
        float scores."""
        if encoded is None:
            encoded = self._encode(state)
        decoder = self.model.decoder
        outs = []
        for _, edges_b in self._batches():
            src_e = gather_rows(encoded, edges_b[:, 0].contiguous())
            dst_e = gather_rows(encoded, edges_b[:, -1].contiguous())
            rel = edges_b[:, 1] if self.has_rels else None
            dirs = [decoder.pos_scores(decoder.apply_relation(
                src_e, self._relations(state.params, rel, False)), dst_e)]
            if decoder.use_inverse_relations and rel is not None:
                dirs.append(decoder.pos_scores(decoder.apply_relation(
                    dst_e, self._relations(state.params, rel, True)), src_e))
            outs.append(torch.stack(dirs))
        return torch.cat(outs, dim=1)[:, :self.num_edges].float().cpu().numpy()

    def _tile_counts(self, adj: Tensor, pos: Tensor, tile: Tensor, tile_start: int,
                     cand: Optional[Tensor], tvalid: Optional[Tensor], anchors: Tensor,
                     rels: Optional[Tensor], keys) -> Tensor:
        """Filtered >=-counts of one edge slice over one node tile (JAX
        tile_counts :366-403), in sub-chunks of 8,192 nodes so the score
        block stays (edge_slice, 8192); tile rows at or past num_nodes are
        masked. True candidates in each sub-chunk are read from the same
        score block (exact cancellation)."""
        decoder, num_nodes = self.model.decoder, self.num_nodes
        rows = tile.shape[0]
        sub = min(8192, rows)
        counts = torch.zeros(adj.shape[0], dtype=torch.int32, device=adj.device)
        for start_c in range(0, rows, sub):
            blk = tile[start_c:start_c + sub]
            scores = decoder.neg_scores(adj, blk[None], num_chunks=1)
            first = tile_start + start_c
            ids = first + torch.arange(sub, dtype=torch.int32, device=adj.device)
            ge = (scores >= pos[:, None]) & (ids < num_nodes)[None, :]
            if cand is not None:
                rel_col = cand - first
                in_chunk = tvalid & (rel_col >= 0) & (rel_col < sub)
                g = torch.gather(scores, 1, rel_col.clamp(0, sub - 1).long())
                true_ge = in_chunk & (g >= pos[:, None])
            else:
                true_ge = ge & isin_triples(keys, anchors[:, None],
                                            None if rels is None else rels[:, None],
                                            ids[None, :])
            counts += ge.sum(dim=1, dtype=torch.int32) - true_ge.sum(dim=1, dtype=torch.int32)
        return counts

    @torch.no_grad()
    def evaluate_from_host_table(self, host_values: Optional[np.ndarray], params,
                                 edge_slice: int = 4096,
                                 node_tile: int = 262_144,
                                 features_host: Optional[np.ndarray] = None,
                                 ) -> Dict[str, float]:
        """Filtered evaluation for a table that stays in host RAM (JAX
        :413-576): the table is encoded tile by tile through the device
        (``encode_all_nodes_host``), then streamed back through it in node
        tiles, scored against the eval edges in slices of ``edge_slice``.
        Device memory is O(edge_slice x d + node_tile x d) whatever
        num_nodes. Node tiles stream outermost, so the encoded table crosses
        the link once for both directions, and the next tile's copy is issued
        (on the copy stream, into the other of two tile buffers) before this
        tile's scoring waits on anything. With a GNN encoder each encoding
        tile is sampled on the device from the evaluator's graph, with the
        seeds of ``encode_all_nodes``; ``features_host`` ((N, F) or
        (N + 1, F)) defaults to the evaluator's features."""
        if not self.filtered:
            raise ValueError("host-tiled evaluation is for filtered evaluation")
        if self.decoder_method != "CORRUPT_NODE":
            raise ValueError("host-tiled evaluation streams node corruption; CORRUPT_REL "
                             "ranks relations and never needs host streaming")
        t0 = time.perf_counter()
        decoder, num_nodes, dev = self.model.decoder, self.num_nodes, self.device
        if features_host is None and self.features is not None:
            features_host = self.features.cpu().numpy()
        host = encode_all_nodes_host(self.model, params, host_values, dev, graph=self.graph,
                                     nbr_configs=self.nbr_configs, features_host=features_host,
                                     batch_size=self.batch_size)
        edges = self.edges[:self.num_edges]
        e = edges.shape[0]
        rels = edges[:, 1] if self.has_rels else None
        node_tile = min(node_tile, _pow2_ceil(num_nodes))
        edge_slice = min(edge_slice, _pow2_ceil(e))
        n_slices = -(-e // edge_slice)
        edges_np = edges.cpu().numpy()
        src_e = torch.from_numpy(host[edges_np[:, 0]]).to(dev)
        dst_e = torch.from_numpy(host[edges_np[:, -1]]).to(dev)

        directions = []
        for inverse in ((False, True) if decoder.use_inverse_relations and rels is not None
                        else (False,)):
            anchor_e, other_e = (dst_e, src_e) if inverse else (src_e, dst_e)
            adj = decoder.apply_relation(anchor_e, self._relations(params, rels, inverse))
            pos = decoder.pos_scores(adj, other_e)
            anchors = edges[:, -1] if inverse else edges[:, 0]
            keys, tail_cap = ((self.src_keys, self.src_tail_cap) if inverse
                              else (self.dst_keys, self.dst_tail_cap))
            directions.append((adj, pos, anchors, keys, tail_cap))

        dir_state = []
        for adj, pos, anchors, keys, tail_cap in directions:
            use_tail = (tail_cap <= TAIL_CAP_LIMIT and n_slices * edge_slice * tail_cap * 5
                        * len(directions) <= HOST_EVAL_CAND_BUDGET_BYTES)
            slices = []
            for s in range(n_slices):
                lo, hi = s * edge_slice, min((s + 1) * edge_slice, e)
                pad = edge_slice - (hi - lo)
                a = torch.nn.functional.pad(adj[lo:hi], (0, 0, 0, pad))
                p = torch.nn.functional.pad(pos[lo:hi], (0, pad), value=float("inf"))
                an = torch.nn.functional.pad(anchors[lo:hi], (0, pad))
                r = None if rels is None else torch.nn.functional.pad(rels[lo:hi], (0, pad))
                cand = tvalid = None
                if use_tail:
                    # each edge's true candidates: a contiguous run of the key set
                    k_lo, k_hi = anchor_ranges(keys, an, r)
                    rows = k_lo[:, None] + torch.arange(tail_cap, dtype=k_lo.dtype,
                                                        device=dev)[None, :]
                    tvalid = rows < k_hi[:, None]
                    n_keys = keys.other.shape[0]
                    cand = torch.where(tvalid, keys.other[rows.clamp(max=n_keys - 1).long()], -1)
                slices.append((lo, hi, a, p, an, r, cand, tvalid))
            dir_state.append((slices, keys, torch.zeros(e, dtype=torch.int64, device=dev)))

        d_out = host.shape[1]
        tiles = [torch.empty((node_tile, d_out), dtype=torch.float32, device=dev)
                 for _ in range(2)]
        freed = [None, None]   # per tile buffer: the compute stream's last use

        def fetch(i, start):
            return transfer.write_rows(tiles[i % 2], host[start:start + node_tile], 0,
                                       after=freed[i % 2], block_compute=False)

        starts = list(range(0, num_nodes, node_tile))
        ready = fetch(0, starts[0])
        for i, start in enumerate(starts):
            if ready is not None:
                torch.cuda.current_stream(dev).wait_event(ready)
            tile = tiles[i % 2]
            for slices, keys, counts in dir_state:
                for lo, hi, a, p, an, r, cand, tvalid in slices:
                    c = self._tile_counts(a, p, tile, start, cand, tvalid, an, r, keys)
                    counts[lo:hi] += c[:hi - lo]
            if dev.type == "cuda":
                freed[i % 2] = torch.cuda.Event()
                freed[i % 2].record(torch.cuda.current_stream(dev))
            if i + 1 < len(starts):
                ready = fetch(i + 1, starts[i + 1])

        stats = {k: 0.0 for k in _STAT_NAMES}
        for _, _, counts in dir_state:
            r = (counts + 1).cpu().numpy().astype(np.float64)
            stats["count"] += len(r)
            stats["rr_sum"] += float(np.sum(1.0 / r))
            stats["rank_sum"] += float(np.sum(r))
            for k in HITS_KS:
                stats[f"hits{k}_sum"] += float(np.sum(r <= k))
        reporter = LinkPredictionReporter(HITS_KS)
        reporter.add_statistics(stats)
        results = reporter.results()
        results["eval_time_s"] = time.perf_counter() - t0
        reporter.report()
        return results

    @torch.no_grad()
    def _rank_sums(self, encoded: Tensor, params) -> Dict[str, float]:
        """The scan's float32 sums, batch by batch and direction by direction,
        read back once."""
        stats = {k: torch.zeros((), dtype=torch.float32, device=self.device)
                 for k in _STAT_NAMES}
        positions = torch.arange(self.batch_size, device=self.device)
        for idx, edges_b in self._batches():
            with span("eval.batch"):
                mask_b = positions + idx * self.batch_size < self.num_edges
                for ranks, _ in self._batch_directions(encoded, params, edges_b, idx):
                    s = rank_statistics(ranks, mask_b, HITS_KS)
                    stats = {k: stats[k] + s[k] for k in _STAT_NAMES}
                count("eval.batches")
        with span("eval.readback"):
            return dict(zip(_STAT_NAMES,
                            torch.stack([stats[k] for k in _STAT_NAMES]).tolist()))

    def evaluate(self, state: TrainState, encoded: Optional[Tensor] = None) -> Dict[str, float]:
        t0 = time.perf_counter()
        with span("eval.evaluate"):
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
