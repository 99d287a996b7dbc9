"""Out-of-core link-prediction training over a partition buffer.

Port of ``PartitionBufferLPTrainer`` from ``marius_tpu/train/buffer_trainer.py``
(:76-719, shallow EMBEDDING encoders; reference graph_storage.cpp:335-735,
dataloader.cpp:120-183 and the buffer.cpp swaps). The embedding table lives
in host RAM, partitioned over the node dimension; a COMET (or BETA) schedule
of buffer states brings ``capacity`` partitions at a time onto the GPU; each
state trains on the edge buckets whose source AND destination partitions are
resident, with ids remapped to buffer-local rows on the host by the native
library. A prefetch thread gathers and shuffles the next state's edges while
the current one trains (``prefetching=False`` runs that work inline).

Each batch, on the device:

1. in-buffer negatives: ``degree_fraction`` of each chunk's negatives are
   endpoints of uniformly drawn batch edges (degree slots first), the rest
   uniform over the resident slots' valid rows (``_in_buffer_draws`` is the
   seam for the three random draws);
2. train-filter masks on GLOBAL ids (local ids mapped back through the
   resident slot -> partition table), else the DEG local filter;
3. the rows through the row-gather kernel: all ids per occurrence when the
   buffer is small (``dense_accum``: buffer_rows x d <= 8M), else the batch's
   unique ids;
4. the decoder, the loss and the gradients of the rows and dense parameters;
5. the table update: per-occurrence gradients summed into a buffer-sized
   accumulator and Adagrad over every row (``dense_accum``), else the
   row-sparse Adagrad kernel over the unique ids; updated rows are marked
   dirty for the sparse writeback; the dense optimizer.

The JAX state function runs every state for the epoch's padded batch count
(``max_batches``). The fully masked batches at a state's end change no table
row (their gradients are zero), so the port does not run them; it still
applies the dense optimizer once for each, with zero gradients, unless that
step is provably a no-op (SGD without momentum, Adagrad; no weight decay),
where only the step count advances. So the state after every epoch equals the
JAX trainer's.

FEATURE stages read a ``ReadOnlyPartitionCache`` of the features whose
slots mirror the embedding buffer's, so one buffer-local id indexes both
(ids at or past ``buffer_rows`` read zeros). A GNN encoder (JAX :366-410)
always dedups: the batch's unique local ids seed the neighbour sampler over
the state's resident subgraph (``_gnn_draws`` is the seam for its numbers,
drawn after the negatives), the rows gathered and updated are the outermost
hop's (padded with ``buffer_rows``, which the Adagrad kernel skips and the
dirty mask's extra row takes). The resident subgraph is a local CSR over
every resident bucket pair (JAX ``_state_graph`` :489-529), its edge arrays
padded to the epoch's power-of-two edge count (``local_csr``, which the
out-of-core NC trainer shares); the prefetch thread remaps the next state's
resident edges, from the slot layout that
``storage.partition_buffer.swap_layout`` gives that state before the swap,
and uploads them, and the card sorts them once the state is swapped in.

CORRUPT_REL (JAX :308-316, :399, :420, :447) scores relation negatives,
(C, N) ids uniform over [0, R) drawn after the node negatives
(``_rel_negatives``, the seam); the node-negative machinery still runs, as
in JAX, so the unique ids, the GNN sampler's seeds and the rows gathered
are those of CORRUPT_NODE, and the negatives' rows take zero gradients
(Adagrad leaves such a row's bits unchanged).

``dtype`` is the buffer's (host table, device slots, swaps): the JAX
package passes ``storage.embeddings.options.dtype`` here and nowhere else
in this trainer, so the dense parameters stay float32. A bfloat16 table's
host arrays are the uint16 bits of its rows, so every swap moves half the
bytes.

With ``mesh`` (a (data x node) ``parallel.mesh.Mesh``; JAX :146-167,
:264-276, where GSPMD keeps one device's semantics) the device buffer is
row-sharded over the node axis (``storage.partition_buffer``: each rank
admits its rows of a slot; an eviction all_gathers the whole slot, so every
rank's host table stays identical; sparse writeback is off, as in JAX).
Every rank runs the same host plan, prep and draws from the same seeds, so
each holds the whole batch; the batch step is
``collectives.make_sharded_buffer_update``: the batch's unique rows gathered
over the node axis, its data index's part scored, one all_reduce over the
data axis of the (U, d) row gradients, the dense gradients and the loss,
then the owner-local Adagrad kernel. The trajectory is one device's (the
unique-row rule, sums in another order). Evaluation and checkpoints read the
host table, whole on every rank (``gathered_state``).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from marius_tpu_torch import native
from marius_tpu_torch.data.ordering import (
    assign_edge_buckets,
    beta_ordering,
    comet_ordering,
    greedy_assign_edge_buckets,
)
from marius_tpu_torch.data.graph import DeviceGraph
from marius_tpu_torch.data.samplers.negative import (
    NegativeSamplingConfig,
    deg_local_filter_mask,
)
from marius_tpu_torch.data.samplers.neighbor import (
    Draws,
    estimate_hop_caps,
    generator_draws,
    sample_neighbor_batch,
)
from marius_tpu_torch.nn.decoders.edge import normalize_decoder_method
from marius_tpu_torch.nn.encoder import encoder_forward
from marius_tpu_torch.nn.layers import DropoutKey
from marius_tpu_torch.nn.model import (
    LINK_PREDICTION,
    Model,
    init_model_params,
    lp_batch_loss,
    lp_batch_loss_direct,
    lp_batch_loss_rel,
)
from marius_tpu_torch.nn.optimizers import (
    OptState,
    apply_optimizer,
    apply_zero_grad_steps,
    init_optimizer,
    tree_leaves,
    tree_map,
)
from marius_tpu_torch.ops.edge_keys import filter_mask_sampled
from marius_tpu_torch.ops.unique import unique_padded
from marius_tpu_torch.parallel.embedding_table import (
    EmbeddingTable,
    gather_rows,
    sparse_adagrad_update_dense_accum,
)
from marius_tpu_torch.reporting.profiling import count, recording, span
from marius_tpu_torch.storage.partition_buffer import (
    PartitionBuffer,
    ReadOnlyPartitionCache,
    _part_to_slot,
    initial_layout,
    mark_dirty,
    sparse_adagrad_update_buffer,
    swap_layout,
)
from marius_tpu_torch.storage import transfer
from marius_tpu_torch.tools.preprocess.partitioner import partition_edges
from marius_tpu_torch.train.trainer import TrainState, resolve_device

Tensor = torch.Tensor

# buffer_rows x d at or below which the table update runs over every buffer row
DENSE_ACCUM_ELEMENTS = 8_000_000


class _Immediate:
    """A future that runs its work at .result(): the prefetching=false
    stand-in for ThreadPoolExecutor.submit."""

    def __init__(self, fn, *args):
        self._fn, self._args = fn, args

    def result(self):
        return self._fn(*self._args)


def padded_batch_count(state_sizes: List[int], batch_size: int) -> int:
    """The JAX state function's batch count for an epoch: the largest
    state's, rounded up to a power of two up to 256, then to ~1/16 steps
    (buffer_trainer.py:557-562)."""
    max_batches = max(1, max(-(-s // batch_size) for s in state_sizes))
    if max_batches <= 256:
        return 1 << (max_batches - 1).bit_length()
    step = 1 << max(max_batches.bit_length() - 4, 8)
    return -(-max_batches // step) * step


def resident_local_edges(edges_by_bucket: np.ndarray, bucket_offsets: np.ndarray,
                         layout: np.ndarray, num_partitions: int, psize: int) -> np.ndarray:
    """The edges of every bucket pair of the partitions in the slot table
    ``layout``, in buffer-local ids (the native remap, on the host)."""
    part_to_slot = _part_to_slot(layout, num_partitions)
    resident = [int(p) for p in layout if p >= 0]
    bucket_ids = np.asarray([i * num_partitions + j for i in resident for j in resident],
                            np.int32)
    return native.gather_remap_buckets(edges_by_bucket, bucket_offsets, bucket_ids,
                                       part_to_slot, psize)


def local_csr(local: Tensor, n: int, max_edges: int, num_relations: int = 1) -> DeviceGraph:
    """The local CSR of one buffer state's resident subgraph from its edges
    in buffer-local ids (``local``, (E, 2|3), on the target device; JAX
    ``_state_graph``, buffer_trainer.py:489-529 and nc_buffer.py:273-305):
    sorted stably by source (out) and by destination (in) on the device,
    offsets of n + 2 entries, neighbour (and relation) arrays padded to
    ``max_edges`` with n (0), degrees counting both ends (a bincount; the
    padding row's 0)."""
    device = local.device
    src, dst = local[:, 0].long(), local[:, -1].long()
    rel = local[:, 1].long() if local.shape[1] == 3 else None
    i32 = torch.int32
    out = {}
    for name, anchor, other in (("out", src, dst), ("in", dst, src)):
        order = torch.argsort(anchor, stable=True)
        offs = torch.zeros(n + 2, dtype=torch.int64, device=device)
        offs[1:n + 1] = torch.cumsum(torch.bincount(anchor, minlength=n), 0)
        offs[n + 1] = offs[n]
        cols = torch.full((max_edges,), n, dtype=i32, device=device)
        cols[:len(order)] = other[order].to(i32)
        out[f"{name}_offsets"], out[f"{name}_cols"] = offs.to(i32), cols
        out[f"{name}_rels"] = None
        if rel is not None:
            rels = torch.zeros(max_edges, dtype=i32, device=device)
            rels[:len(order)] = rel[order].to(i32)
            out[f"{name}_rels"] = rels
    deg = torch.bincount(src, minlength=n + 1) + torch.bincount(dst, minlength=n + 1)
    deg[n:] = 0
    return DeviceGraph(**out, degrees=deg.to(i32), num_nodes=n, num_relations=num_relations)


def state_graph(edges_by_bucket: np.ndarray, bucket_offsets: np.ndarray, layout: np.ndarray,
                num_partitions: int, psize: int, max_edges: int, device) -> DeviceGraph:
    """:func:`local_csr` of the buffer state with slot table ``layout``: its
    resident edges remapped on the host, sorted on ``device``."""
    local = resident_local_edges(edges_by_bucket, bucket_offsets, layout, num_partitions, psize)
    return local_csr(torch.from_numpy(np.ascontiguousarray(local)).to(device),
                     len(layout) * psize, max_edges)


class PartitionBufferLPTrainer:
    """LP training with the embedding table in host RAM: shallow, FEATURE
    and GNN encoders."""

    def __init__(
        self,
        model: Model,
        num_nodes: int,
        num_relations: int,
        train_edges: np.ndarray,
        neg_config: NegativeSamplingConfig,
        batch_size: int = 1000,
        num_partitions: int = 16,
        buffer_capacity: int = 8,
        seed: int = 0,
        ordering: str = "COMET",          # COMET | BETA (EdgeBucketOrdering)
        fine_to_coarse_ratio: int = 2,
        num_cache_partitions: int = 0,
        randomly_assign_edge_buckets: bool = True,
        nbr_configs=(),                   # GNN encoders: sampling over the resident subgraph
        features: Optional[np.ndarray] = None,   # (N, F): FEATURE layers, partition-cached
        mesh=None,
        prefetching: bool = True,         # next-state host prep on a thread
        epochs_per_shuffle: int = 1,
        train_filter_keys=None,           # (dst, src) EdgeKeySets in GLOBAL ids
        sparse_writeback: bool = True,    # evictions move only updated rows
        profile_states: bool = False,     # per-state (prep, swap, compute) seconds
        dtype=torch.float32,              # the table's type (host arrays, slots, swaps)
        device=None,
    ):
        if model.learning_task != LINK_PREDICTION:
            raise ValueError(f"PartitionBufferLPTrainer needs a {LINK_PREDICTION} model")
        if model.decoder is None:
            raise ValueError("link prediction needs an edge decoder")
        if batch_size % neg_config.num_chunks:
            raise ValueError("batch_size must be divisible by num_chunks (static chunking)")
        self.decoder_method = normalize_decoder_method(model.decoder.decoder_method)
        if self.decoder_method not in ("CORRUPT_NODE", "CORRUPT_REL"):
            raise ValueError(f"training supports CORRUPT_NODE/CORRUPT_REL, "
                             f"got {self.decoder_method}")
        if self.decoder_method == "CORRUPT_REL" and train_edges.shape[1] != 3:
            raise ValueError("CORRUPT_REL needs a 3-column (typed) edge list")
        if not model.has_embeddings:
            raise ValueError("partition-buffer LP needs an embedding table")
        if model.encoder.num_gnn_stages and not nbr_configs:
            raise ValueError("a GNN encoder needs one neighbour config per GNN stage")
        if model.encoder.has_features and features is None:
            raise ValueError("FEATURE layers need a feature matrix")

        self.mesh = mesh
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        self.model = model
        self.num_nodes = num_nodes
        self.num_relations = num_relations
        self.neg_config = neg_config
        self.batch_size = batch_size
        self.num_partitions = num_partitions
        self.capacity = min(buffer_capacity, num_partitions)
        self.seed = seed
        self.epochs_per_shuffle = max(1, int(epochs_per_shuffle))
        self.ordering = ordering.upper()
        self.fine_to_coarse_ratio = fine_to_coarse_ratio
        self.num_cache_partitions = num_cache_partitions
        self.randomly_assign = randomly_assign_edge_buckets
        self.prefetching = prefetching
        self.train_filter_keys = (None if train_filter_keys is None else
                                  tuple(k.to(self.device) for k in train_filter_keys))
        self.profile_states = profile_states
        self.last_state_timings: List[Tuple[float, float, float]] = []
        # the prefetch thread's seconds building each state's local CSR and
        # issuing its copy to the device (pinning included)
        self.last_graph_seconds: List[float] = []

        table_seed = int(np.random.SeedSequence((seed, 0)).generate_state(1)[0])
        self.buffer = PartitionBuffer.create(table_seed, num_nodes,
                                             model.encoder.embedding_dim, num_partitions,
                                             self.capacity, device=self.device, dtype=dtype,
                                             mesh=mesh)
        self.sparse_writeback = bool(sparse_writeback) and mesh is None
        if self.sparse_writeback:
            self.buffer.enable_dirty_tracking()

        # initial parameters are drawn on the CPU, so they do not depend on the device
        model.decoder.to(self.device)
        params = init_model_params(torch.Generator().manual_seed(seed), model)
        self.params = tree_map(self._to_device_leaf, params)
        self.opt_state = init_optimizer(model.dense_optimizer, self.params)
        self.epoch = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._draws = generator_draws(self.generator)
        self._dropout = DropoutKey(self.generator)

        # bucket-grouped edges: one stable counting sort, then per-bucket slices
        edges = np.asarray(train_edges, np.int32)
        self.has_rels = edges.shape[1] == 3
        reordered, sizes = partition_edges(edges, num_nodes, num_partitions)
        self.edges_by_bucket = reordered
        self.bucket_offsets = np.concatenate([[0], np.cumsum(sizes)])
        self.num_edges = len(edges)

        c, n = neg_config.num_chunks, neg_config.negatives_per_positive
        self.unique_cap = 2 * batch_size + 2 * c * n
        self.nbr_configs = tuple(nbr_configs)
        self.dense_accum = (not self.nbr_configs and self.buffer.buffer_rows
                            * model.encoder.embedding_dim <= DENSE_ACCUM_ELEMENTS)
        self.hop_caps = (tuple(estimate_hop_caps(self.unique_cap, self.nbr_configs,
                                                 self.buffer.buffer_rows))
                         if self.nbr_configs else ())
        self._mesh_update = None
        if mesh is not None:
            from marius_tpu_torch.parallel.collectives import make_sharded_buffer_update

            self.dense_accum = False
            self._mesh_update = make_sharded_buffer_update(
                model, mesh, self.buffer.shard_size, self.buffer.buffer_rows, self.nbr_configs,
                self.hop_caps, self.unique_cap)
        self.feature_cache = None
        self._features_host = self._features_dev = None
        if features is not None and model.encoder.has_features:
            f = np.zeros((num_nodes + 1, features.shape[1]), np.float32)
            f[:num_nodes] = features
            self._features_host = f
            self.feature_cache = ReadOnlyPartitionCache.create(
                f, num_nodes, num_partitions, self.capacity, device=self.device)

    def _to_device_leaf(self, t: Tensor) -> Tensor:
        if t.device == self.device:
            return t
        return t.detach().to(self.device).requires_grad_(t.requires_grad)

    # -- seams a test may replace --------------------------------------------

    def _in_buffer_draws(self, step: int, inverse: bool):
        """One direction's random draws for epoch step ``step`` (a step of
        the JAX state function's scan, padded steps included): (slots (C, N)
        in [0, capacity), offsets (C, N) in [0, psize), batch rows (C, D) in
        [0, batch) or None), D = N x degree_fraction."""
        cfg, gen, dev = self.neg_config, self.generator, self.device
        c, nneg = cfg.num_chunks, cfg.negatives_per_positive
        num_deg = int(nneg * cfg.degree_fraction)
        slots = torch.randint(0, self.capacity, (c, nneg), generator=gen, device=dev)
        offs = torch.randint(0, self.buffer.psize, (c, nneg), generator=gen, device=dev)
        rows = (torch.randint(0, self.batch_size, (c, num_deg), generator=gen, device=dev)
                if num_deg else None)
        return slots, offs, rows

    def _rel_negatives(self, step: int) -> Tensor:
        """CORRUPT_REL's (C, N) relation ids for epoch step ``step``, uniform
        over [0, max(R, 1)), drawn after the node negatives (JAX :313-317)."""
        cfg = self.neg_config
        return torch.randint(0, max(self.num_relations, 1),
                             (cfg.num_chunks, cfg.negatives_per_positive),
                             generator=self.generator, device=self.device)

    def _gnn_draws(self, step: int) -> Draws:
        """The neighbour sampler's numbers for epoch step ``step``."""
        return self._draws

    # ------------------------------------------------------------------------

    def _plan_epoch(self):
        seed = self.seed + self.epoch
        n, c = self.num_partitions, self.capacity
        r = self.fine_to_coarse_ratio
        coarse_c = c // r - self.num_cache_partitions
        coarse_n = n // r - self.num_cache_partitions
        if self.ordering == "COMET" and n % r == 0 and c % r == 0 \
                and coarse_n >= 1 and (coarse_c >= 2 or coarse_c >= coarse_n):
            states = comet_ordering(n, c, r, self.num_cache_partitions, seed=seed)
        else:
            states = beta_ordering(n, c, seed=seed)
        if self.randomly_assign:
            assignment = assign_edge_buckets(states, n, seed=seed)
        else:
            assignment = greedy_assign_edge_buckets(states, n)
        return states, assignment

    def _in_buffer_negatives(self, edges_b: Tensor, mask_b: Tensor, step: int,
                             inverse: bool, slot_valid: Tensor):
        """The mixture of JAX's in_buffer_negs (:280-299): uniform rows of
        the resident slots (an offset modulo the slot's valid rows), the
        first D columns replaced by endpoints of drawn batch rows, a masked
        row keeping its uniform draw. Returns (local ids (C, N), rows or None)."""
        psize = self.buffer.psize
        slots, offs, rows = self._in_buffer_draws(step, inverse)
        valid = slot_valid[slots]
        uni = slots * psize + offs % valid.clamp(min=1)
        if rows is None:
            return uni, None
        d = rows.shape[1]
        col = 0 if inverse else edges_b.shape[1] - 1
        deg = torch.where(mask_b[rows], edges_b[:, col][rows], uni[:, :d])
        return torch.cat([deg, uni[:, d:]], dim=1), rows

    def _buffer_feats(self, ids: Tensor) -> Optional[Tensor]:
        """Feature rows of buffer-local ``ids`` from the slot-aligned cache;
        ids at or past buffer_rows read its zero row (JAX :348-359)."""
        cache = self.feature_cache
        return None if cache is None else gather_rows(cache.device_rows, ids)

    def _batch_step(self, edges_b: Tensor, mask_b: Tensor, step: int,
                    slot_valid: Tensor, slot_parts: Tensor,
                    graph: Optional[DeviceGraph]) -> Tensor:
        """One batch against the buffer (JAX batch_step :264-477); returns
        the detached loss."""
        model, cfg, buf = self.model, self.neg_config, self.buffer
        b = self.batch_size
        c, nneg = cfg.num_chunks, cfg.negatives_per_positive
        psize, buffer_rows = buf.psize, buf.buffer_rows
        num_deg = int(nneg * cfg.degree_fraction)

        dst_negs, dst_deg_rows = self._in_buffer_negatives(edges_b, mask_b, step, False,
                                                           slot_valid)
        src_negs, src_deg_rows = self._in_buffer_negatives(edges_b, mask_b, step, True,
                                                           slot_valid)
        src = torch.where(mask_b, edges_b[:, 0], buffer_rows)
        dst = torch.where(mask_b, edges_b[:, -1], buffer_rows)
        rel = edges_b[:, 1] if self.has_rels else None
        inv_rel_on = model.decoder.use_inverse_relations and self.has_rels
        corrupt_rel = self.decoder_method == "CORRUPT_REL"
        neg_rel_ids = self._rel_negatives(step) if corrupt_rel else None

        dst_filter = src_filter = None
        if self.train_filter_keys is not None:
            # the keys are GLOBAL: map buffer-local ids back through the slots
            def to_global(lids):
                slots = (lids // psize).clamp(max=self.capacity - 1)
                return slot_parts[slots] * psize + lids % psize

            dst_keys, src_keys = self.train_filter_keys
            dst_filter = filter_mask_sampled(dst_keys, to_global(src), rel, to_global(dst_negs))
            src_filter = filter_mask_sampled(src_keys, to_global(dst), rel, to_global(src_negs))
        elif num_deg and (cfg.local_filter_mode or "DEG").upper() == "DEG":
            # DEG local filter (negative.cpp:21-48)
            dst_filter = deg_local_filter_mask(dst_deg_rows, b, nneg)
            src_filter = deg_local_filter_mask(src_deg_rows, b, nneg)
        if not inv_rel_on:
            src_filter = None

        all_ids = torch.cat([src, dst, dst_negs.reshape(-1), src_negs.reshape(-1)])
        if self._mesh_update is not None:
            return self._mesh_batch_step(all_ids, {
                "src": src, "dst": dst, "mask": mask_b, "rel": rel, "neg_rels": neg_rel_ids,
                "dst_negs": None if corrupt_rel else dst_negs,
                "src_negs": None if corrupt_rel or not inv_rel_on else src_negs,
                "dst_filter": None if corrupt_rel else dst_filter,
                "src_filter": None if corrupt_rel else src_filter}, step, graph)
        if self.dense_accum:
            update_ids, pos = all_ids, None
        else:
            uniq = unique_padded(all_ids, size=self.unique_cap, fill_value=buffer_rows)
            update_ids, pos = uniq.ids, uniq.inverse
        nbr_batch = None
        if self.nbr_configs:
            # the unique local ids seed sampling over the resident subgraph;
            # rows are gathered, and updated, for the outermost hop
            nbr_batch = sample_neighbor_batch(self._gnn_draws(step), graph, update_ids,
                                              update_ids < buffer_rows, self.nbr_configs,
                                              self.hop_caps)
            update_ids = nbr_batch.node_ids[0]
        x0 = gather_rows(buf.device_values, update_ids)
        x0.requires_grad_(True)
        enc = encoder_forward(model.encoder, self.params["encoder"], x0,
                              self._buffer_feats(update_ids), nbr_batch,
                              degrees=None if graph is None else graph.degrees, train=True,
                              dropout_key=self._dropout)
        cn = c * nneg
        if corrupt_rel:
            src_e, dst_e = ((enc[:b], enc[b:2 * b]) if self.dense_accum
                            else (enc[pos[:b]], enc[pos[b:2 * b]]))
            loss, _ = lp_batch_loss_rel(model, src_e, dst_e, rel, neg_rel_ids, mask_b)
        elif self.dense_accum:
            d = enc.shape[-1]
            loss, _ = lp_batch_loss_direct(
                model, enc[:b], enc[b:2 * b], rel, enc[2 * b:2 * b + cn].reshape(c, nneg, d),
                enc[2 * b + cn:].reshape(c, nneg, d) if inv_rel_on else None,
                mask_b, dst_filter, src_filter)
        else:
            loss, _ = lp_batch_loss(
                model, enc, pos[:b], pos[b:2 * b], rel, pos[2 * b:2 * b + cn].reshape(c, nneg),
                pos[2 * b + cn:].reshape(c, nneg) if inv_rel_on else None,
                mask_b, dst_filter, src_filter)

        leaves = tree_leaves(self.params)
        gx, *gdense = torch.autograd.grad(loss, [x0] + leaves, allow_unused=True)
        if gx is None:
            gx = torch.zeros_like(x0)
        if self.dense_accum:
            sparse_adagrad_update_dense_accum(
                EmbeddingTable(values=buf.device_values, state=buf.device_state),
                all_ids, gx, model.sparse_lr)
        else:
            sparse_adagrad_update_buffer(buf.device_values, buf.device_state, update_ids, gx,
                                         model.sparse_lr)
        if buf.dirty is not None:
            mark_dirty(buf.dirty, update_ids)
        it = iter(gdense)
        _, self.opt_state = apply_optimizer(model.dense_optimizer, self.params,
                                            self.opt_state,
                                            tree_map(lambda _: next(it), self.params))
        return loss.detach()

    def _mesh_batch_step(self, all_ids: Tensor, batch: Dict[str, Optional[Tensor]],
                         step: int, graph: Optional[DeviceGraph]) -> Tensor:
        """The explicit sharded step on the whole batch; returns its loss."""
        buf, cache = self.buffer, self.feature_cache
        draws = self._gnn_draws(step) if self.nbr_configs else None
        self.opt_state, loss = self._mesh_update(
            buf.device_values, buf.device_state, self.params, self.opt_state, batch, all_ids,
            None if cache is None else cache.device_rows, graph, draws, self._dropout)
        return loss

    def _device_graph(self, upload: transfer.Upload, max_edges: int) -> DeviceGraph:
        """A state's local CSR (:func:`local_csr`) from its resident edges,
        which the prefetch thread remapped and uploaded."""
        return local_csr(upload.result()["edges"], self.buffer.buffer_rows, max_edges,
                         self.num_relations)

    def _train_state(self, local: np.ndarray, first_step: int, max_batches: int,
                     graph: Optional[DeviceGraph] = None) -> Tensor:
        """Train one buffer state's (shuffled, remapped) edges; returns the
        state's loss sum on the device."""
        b = self.batch_size
        n = len(local)
        nb = -(-n // b)
        padded = np.zeros((nb * b, local.shape[1]), np.int64)
        padded[:n] = local
        edges = torch.from_numpy(padded).to(self.device)
        masks = torch.arange(nb * b, device=self.device) < n
        slot_valid = torch.from_numpy(self.buffer.slot_valid_counts().astype(np.int64)).to(
            self.device)
        slot_parts = torch.from_numpy(self.buffer.resident.astype(np.int64)).to(self.device)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(nb):
            with span("train.batch", (self.epoch, first_step + i)):
                total += self._batch_step(edges[i * b:(i + 1) * b], masks[i * b:(i + 1) * b],
                                          first_step + i, slot_valid, slot_parts, graph)
                count("train.batches")
        self.opt_state = apply_zero_grad_steps(self.model.dense_optimizer, self.params,
                                               self.opt_state, max_batches - nb)
        return total

    def train_epoch(self, max_states: Optional[int] = None,
                    time_budget_s: Optional[float] = None,
                    final_flush: bool = True) -> Dict[str, float]:
        """Train one epoch over the buffer schedule. ``max_states`` /
        ``time_budget_s`` cut the schedule short after that many states or
        seconds (the states that ran are exact: evictions and the flush land
        every update). ``final_flush=False`` skips the end-of-epoch writeback
        of the resident set, whose updates the next ``load`` then drops.
        After a flush the buffer's device tensors are freed. With
        ``profile_states`` the epoch records its spans (without counting
        synchronisations, which would add to the times), and each state's
        ``state.prep``, ``state.swap`` and ``state.train`` durations (each
        ending in a synchronisation) become ``last_state_timings``."""
        with (recording(sync_debug=False) if self.profile_states
              else contextlib.nullcontext()), \
                span("train.epoch"):
            return self._train_epoch(max_states, time_budget_s, final_flush)

    def _train_epoch(self, max_states: Optional[int], time_budget_s: Optional[float],
                     final_flush: bool) -> Dict[str, float]:
        t0 = time.perf_counter()
        states, assignment = self._plan_epoch()
        P = self.num_partitions
        state_sizes = [sum(int(self.bucket_offsets[i * P + j + 1]
                               - self.bucket_offsets[i * P + j]) for i, j in buckets)
                       for buckets in assignment]
        max_batches = padded_batch_count(state_sizes, self.batch_size)
        # each state's slot layout, known before its swap
        layouts = [initial_layout(states[0], self.capacity)]
        for st in states[1:]:
            layouts.append(swap_layout(layouts[-1], st))
        max_graph_edges = 0
        if self.nbr_configs:
            # the resident subgraph's edge arrays, padded to one power of two
            # per epoch (JAX :563-573)
            max_graph_edges = 1 << (max(1, max(
                int(sum(self.bucket_offsets[i * P + j + 1] - self.bucket_offsets[i * P + j]
                        for i in st for j in st)) for st in states)) - 1).bit_length()
        self.buffer.load(states[0])
        cols = 3 if self.has_rels else 2
        shuffle_epoch = self.epoch // self.epochs_per_shuffle

        def prep(s_idx):
            """The state's edges in GLOBAL ids (the remap runs once the state
            is swapped in), shuffled, and with a GNN encoder its local CSR,
            already on its way to the device."""
            bucket_ids = np.asarray([i * P + j for i, j in assignment[s_idx]], np.int32)
            e = native.gather_remap_buckets(self.edges_by_bucket, self.bucket_offsets,
                                            bucket_ids, np.arange(P, dtype=np.int32),
                                            self.buffer.psize)
            e = native.shuffle_rows(e, seed=(self.seed * 977 + shuffle_epoch) * 1009 + s_idx)
            graph = None
            if self.nbr_configs:
                t0 = time.perf_counter()
                graph = transfer.upload_async(
                    {"edges": resident_local_edges(self.edges_by_bucket, self.bucket_offsets,
                                                   layouts[s_idx], P, self.buffer.psize)},
                    self.device)
                self.last_graph_seconds.append(time.perf_counter() - t0)
            return e, graph

        losses = []
        edges_trained = states_run = batches_run = 0
        collectives = 0 if self.mesh is None else self.mesh.collectives
        gathered = self.buffer.gathered_bytes
        self.last_state_timings = []
        self.last_graph_seconds = []
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            submit = pool.submit if self.prefetching else (lambda f, *a: _Immediate(f, *a))
            fut = submit(prep, 0)
            for s_idx, st in enumerate(states):
                with span("state.prep") as prep_span:
                    local, graph_upload = fut.result()
                    if s_idx + 1 < len(states):
                        fut = submit(prep, s_idx + 1)
                with span("state.swap") as swap_span:
                    self.buffer.swap_to_state(st)
                    if not np.array_equal(self.buffer.resident, layouts[s_idx]):
                        raise RuntimeError("the buffer's slots differ from the planned layout")
                    if self.feature_cache is not None:
                        # local ids must index both tiers alike
                        self.feature_cache.mirror_layout(self.buffer.resident)
                    graph = (None if graph_upload is None
                             else self._device_graph(graph_upload, max_graph_edges))
                    if self.profile_states:
                        sync()   # the admits' copies land in the swap bucket
                with span("state.train") as train_span:
                    for col in (0, cols - 1):
                        local[:, col] = native.global_to_local(
                            local[:, col], self.buffer.part_to_slot, self.buffer.psize,
                            self.buffer.buffer_rows)[0]
                    losses.append(self._train_state(local, states_run * max_batches,
                                                    max_batches, graph))
                    edges_trained += len(local)
                    batches_run += -(-len(local) // self.batch_size)
                    states_run += 1
                    if self.profile_states:
                        sync()
                if self.profile_states:
                    self.last_state_timings.append(tuple(
                        s.duration_ns * 1e-9 for s in (prep_span, swap_span, train_span)))
                if (max_states is not None and states_run >= max_states) or \
                        (time_budget_s is not None and time.perf_counter() - t0 > time_budget_s):
                    break

        with span("train.readback"):
            total_loss = float(torch.stack(losses).sum())   # the epoch's one read-back
        if final_flush:
            self.buffer.flush()
            self.buffer.release()
        else:
            self.buffer._drain_writebacks()
        self.epoch += 1
        dt = time.perf_counter() - t0
        out = {
            "loss": total_loss,
            "epoch_time_s": dt,
            "edges_per_sec": edges_trained / dt,
            "num_edges": self.num_edges,
            "edges_trained": edges_trained,
            "num_buffer_states": len(states),
            "states_run": states_run,
            "max_batches": max_batches,
            "max_graph_edges": max_graph_edges,
            "batches_run": batches_run,
            "masked_batches": states_run * max_batches - batches_run,
        }
        if self.mesh is not None:
            # the swaps' and the flush's all_gathers included
            out["collectives_per_batch"] = (self.mesh.collectives - collectives) / max(
                1, batches_run)
            out["gathered_bytes"] = self.buffer.gathered_bytes - gathered
        return out

    def train(self, num_epochs: int):
        return [self.train_epoch() for _ in range(num_epochs)]

    # -- the TrainState view for evaluators and checkpoints -------------------

    @property
    def state(self) -> TrainState:
        """Full-table view after a flush: the table's leaves are CPU tensors
        over the host arrays (no copy), so a checkpoint never routes the
        table through the device; an evaluator moves it to its device."""
        self.buffer.flush()
        n = self.num_nodes
        return TrainState(
            table=EmbeddingTable(
                values=transfer.as_tensor(self.buffer.host_values[:n], self.buffer.dtype),
                state=transfer.as_tensor(self.buffer.host_state[:n], self.buffer.dtype)),
            params=self.params, opt_state=self.opt_state, epoch=self.epoch)

    @state.setter
    def state(self, s: TrainState) -> None:
        """Copy ``s`` in: the table into the host arrays (the next epoch
        re-admits from them), the parameters into this trainer's own tensors."""
        n = self.num_nodes
        self.buffer.flush()
        self.buffer.release()
        with torch.no_grad():
            dt = self.buffer.dtype
            self.buffer.host_values[:n] = transfer.as_array(s.table.values.detach().cpu().to(dt))
            self.buffer.host_state[:n] = transfer.as_array(s.table.state.detach().cpu().to(dt))
            if len(tree_leaves(self.params)) != len(tree_leaves(s.params)):
                raise ValueError("the two states' parameter structures differ")
            tree_map(lambda d, v: d.copy_(v), self.params, s.params)
            tree_map(lambda d, v: d.copy_(v), self.opt_state.slots, s.opt_state.slots)
        self.opt_state = OptState(s.opt_state.step, self.opt_state.slots)
        self.epoch = int(s.epoch)

    def gathered_state(self) -> TrainState:
        """The state in the single-device layout: the host table is whole
        on every rank, mesh or not (every rank calls it: the flush's
        evictions are collective)."""
        return self.state

    def load_gathered_state(self, s: TrainState) -> None:
        self.state = s

    @property
    def features(self) -> Optional[Tensor]:
        """(N + 1, F) features with the zero sentinel row, on the device, for
        evaluation (training reads the partition cache); copied on first use."""
        if self._features_host is None:
            return None
        if self._features_dev is None:
            self._features_dev = torch.from_numpy(self._features_host).to(self.device)
        return self._features_dev
