"""Out-of-core node classification over partitioned node features.

Port of ``PartitionBufferNCTrainer`` from ``marius_tpu/train/nc_buffer.py``
(:50-495; reference getNodePartitionOrdering,
data/ordering.cpp:294-410, and the dataloader's nodeSample). The node
features stay in host RAM (or in a memory-mapped file), partitioned over the
node dimension; a DISPERSED or SEQUENTIAL ordering brings ``capacity``
partitions at a time into a device cache (``ReadOnlyPartitionCache``); each
buffer state trains the resident partitions' train nodes, sampling
neighbours only inside the resident subgraph (the reference's
approximation: MariusGNN's dispersed ordering trades neighbourhood coverage
for IO). An optional EMBEDDING table co-buffers with the features in a
writable ``PartitionBuffer`` (reference io.cpp:347-433): it owns the slot
layout, the feature cache mirrors it, so one buffer-local id indexes both.

Per state the host (the native library) gathers the resident edge buckets
and remaps them to buffer-local ids; the local CSR of both directions is
sorted on the device (``state_graph``). Each batch then samples its seeds'
neighbourhoods, gathers the outermost hop's feature (and table) rows with
the row-gather kernel (ids at or past ``buffer_rows`` read the cache's zero
row), runs the encoder (one gather-sum kernel call per GNN layer), takes the
CE loss over ``mask & seed_mask`` and updates the dense parameters, and the
co-buffer's rows with the row-sparse Adagrad kernel (padding ids, which are
``buffer_rows``, are skipped by the kernel).

The JAX package runs every state for the epoch's padded batch count (a power
of two over the states) inside one compiled scan; the padded batches carry
zero gradients and step the dense optimizer anyway (ROADMAP C6). The port
skips their work and gives the dense optimizer their zero-gradient steps
(``apply_zero_grad_steps``), so the state after each epoch equals JAX's.
Random numbers come through seams a test may replace: ``_batch_draws(epoch,
step)`` and ``_dropout_key(epoch, step)`` for training (JAX splits one key
per scan step from ``fold_in(key(seed + 17), epoch)``, padded steps
included, and folds 99 into it for dropout) and ``_eval_draws(count)`` for
evaluation (JAX keys each batch by ``fold_in(key(3), count)``, ``count``
the valid seeds scored so far in this state). The epoch's state plan and
seed shuffle are numpy, as in JAX, and equal it by construction. As in JAX,
``state`` holds no table: a checkpoint does not save the co-buffer
(ROADMAP C7). Evaluation starts from a fresh load of its first state
(ROADMAP C8).

With ``mesh`` (a (data x node) ``parallel.mesh.Mesh``, JAX :67-104,
:186-270) training is data parallel over the data axis; the ranks of a node
row are replicas. Every rank holds its own ``ReadOnlyPartitionCache`` of the
same resident partitions and swaps the same states (the plan and the seed
shuffle are numpy, equal on every rank). Each data index takes its
``batch_size / n_data`` share of every batch (JAX's ``P(None, data)``
seeds), samples it with its own numbers (``_batch_draws(epoch, step,
data_index)``; on the card a generator seeded from (seed, data index), as
JAX folds the index into the step's key) under hop caps sized for that
local batch, and scores it; MEAN losses are weighted by local over total
valid seeds (an all_reduce of the count). One all_reduce over the data axis
sums the dense gradients, the loss and the overflow count, and every rank
steps the dense optimizer alike. A batch runs on every rank when the whole
batch holds a valid seed, so an index whose share is all padding still
joins the batch's collectives with zero gradients. An EMBEDDING co-buffer
is refused on a mesh, as JAX refuses it. Evaluation runs the whole split on
every rank with no collective, under hop caps sized for the evaluation's
whole batch (JAX keeps the local ones there, ROADMAP C12), so a mesh-trained
model scores as one process's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from marius_tpu_torch.data.graph import DeviceGraph
from marius_tpu_torch.data.ordering import dispersed_node_ordering, sequential_node_ordering
from marius_tpu_torch.data.samplers.neighbor import (
    Draws,
    NeighborSamplingConfig,
    estimate_hop_caps,
    generator_draws,
    sample_neighbor_batch,
    seeded_draws,
)
from marius_tpu_torch.nn.encoder import encoder_forward
from marius_tpu_torch.nn.layers import DropoutKey
from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model, init_model_params, nc_batch_loss
from marius_tpu_torch.nn.optimizers import (
    OptState,
    apply_optimizer,
    apply_zero_grad_steps,
    init_optimizer,
    tree_leaves,
    tree_map,
)
from marius_tpu_torch.parallel.collectives import sum_over_data
from marius_tpu_torch.parallel.embedding_table import gather_rows
from marius_tpu_torch.parallel.mesh import DATA_AXIS
from marius_tpu_torch.reporting.metrics import categorical_accuracy_statistics
from marius_tpu_torch.reporting.profiling import count, recording, span
from marius_tpu_torch.reporting.reporters import NodeClassificationReporter
from marius_tpu_torch.storage.partition_buffer import (
    PartitionBuffer,
    ReadOnlyPartitionCache,
    sparse_adagrad_update_buffer,
)
from marius_tpu_torch.tools.preprocess.partitioner import partition_edges
from marius_tpu_torch.train.buffer_trainer import state_graph
from marius_tpu_torch.train.trainer import TrainState, resolve_device

Tensor = torch.Tensor


def _pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


class PartitionBufferNCTrainer:
    """GNN node classification with the node features (and an optional
    EMBEDDING table) out of device memory."""

    def __init__(
        self,
        model: Model,
        edges: np.ndarray,                  # (E, 2|3) int
        features: Optional[np.ndarray],     # (N, F) float32, in RAM or a memmap
        labels: np.ndarray,                 # (N,) int
        train_nodes: np.ndarray,
        nbr_configs: Sequence[NeighborSamplingConfig],
        num_nodes: int,
        batch_size: int = 1000,
        num_partitions: int = 16,
        buffer_capacity: int = 8,
        ordering: str = "DISPERSED",        # DISPERSED | SEQUENTIAL
        seed: int = 0,
        mesh=None,
        epochs_per_shuffle: int = 1,
        profile_states: bool = False,       # per-state (swap, graph, compute) seconds
        device=None,
    ):
        if model.learning_task != NODE_CLASSIFICATION:
            raise ValueError(f"PartitionBufferNCTrainer needs a {NODE_CLASSIFICATION} model")
        self.mesh = mesh
        self._n_data, self._data_index = 1, 0
        if mesh is not None:
            if model.has_embeddings:
                raise ValueError("embedding-table NC over the buffer is single-controller")
            self._n_data, self._data_index = mesh.shape[DATA_AXIS], mesh.axis_index(DATA_AXIS)
            if batch_size % self._n_data:
                raise ValueError(f"batch_size {batch_size} % data axis {self._n_data} != 0")
            if device is None:
                device = mesh.device
        if model.encoder.num_gnn_stages and len(nbr_configs) != model.encoder.num_gnn_stages:
            raise ValueError("a GNN encoder needs one neighbour config per GNN stage")
        self.device = resolve_device(device)
        self.model = model
        self.num_nodes = num_nodes
        self.batch_size = batch_size
        self.nbr_configs = tuple(nbr_configs)
        self.ordering = ordering.upper()
        self.seed = seed
        self.num_partitions = num_partitions
        self.epochs_per_shuffle = max(1, int(epochs_per_shuffle))
        self.profile_states = profile_states
        self.last_state_timings: List[tuple] = []
        self.last_eval_batches = 0   # batches the last evaluate_nodes scored
        capacity = min(buffer_capacity, num_partitions)

        self.cache = None
        if features is not None:
            self.cache = ReadOnlyPartitionCache.create(features, num_nodes, num_partitions,
                                                       capacity, device=self.device)
        self.emb_buffer = None
        if model.has_embeddings:
            table_seed = int(np.random.SeedSequence((seed, 3)).generate_state(1)[0])
            self.emb_buffer = PartitionBuffer.create(
                table_seed, num_nodes, model.encoder.embedding_dim, num_partitions, capacity,
                device=self.device)
        if self.cache is None and self.emb_buffer is None:
            raise ValueError("node classification needs features and/or an embedding table")
        # the writable buffer owns the slot layout; the feature cache mirrors it
        self._ref = self.emb_buffer if self.emb_buffer is not None else self.cache
        self.capacity = self._ref.capacity
        psize = self._ref.psize

        lab = np.zeros(num_partitions * psize, np.int32)
        lab[:num_nodes] = np.asarray(labels, np.int32)
        self.labels_host = lab

        # bucket-grouped edges (src_part, dst_part), as the LP buffer path
        e = np.ascontiguousarray(np.asarray(edges, np.int32)[:, [0, -1]])
        grouped, sizes = partition_edges(e, num_nodes, num_partitions)
        self.edges_by_bucket = grouped
        self.bucket_offsets = np.concatenate([[0], np.cumsum(sizes)])

        tn = np.asarray(train_nodes, np.int32)
        self.train_by_part = [tn[tn // psize == p] for p in range(num_partitions)]
        self.num_train = len(tn)
        # training caps for a data index's share of the batch; evaluation
        # scores whole batches
        self.hop_caps = tuple(estimate_hop_caps(batch_size // self._n_data, self.nbr_configs,
                                                self._ref.buffer_rows))
        self._eval_caps = tuple(estimate_hop_caps(batch_size, self.nbr_configs,
                                                  self._ref.buffer_rows))

        # initial parameters are drawn on the CPU, so they do not depend on the device
        params = init_model_params(torch.Generator().manual_seed(seed), model)
        self.params = tree_map(lambda t: t.detach().to(self.device).requires_grad_(True), params)
        self.opt_state = init_optimizer(model.dense_optimizer, self.params)
        self.epoch = 0
        if mesh is not None:
            # a data index's own numbers, as JAX folds the index into its key
            seed = int(np.random.SeedSequence((seed, self._data_index)).generate_state(1)[0])
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self._draws = generator_draws(generator)
        self._dropout = DropoutKey(generator)

    # -- seams a test may replace -----------------------------------------------

    def _batch_draws(self, epoch: int, step: int, data_index: int = 0) -> Draws:
        """The sampler's numbers for training step ``step`` of ``epoch``
        (steps count the padded batches of earlier states too), on a mesh
        for this rank's ``data_index``."""
        return self._draws

    def _dropout_key(self, epoch: int, step: int, data_index: int = 0):
        """The dropout key of the same step and data index (GAT's masks)."""
        return self._dropout

    def _eval_draws(self, count: int) -> Draws:
        """The sampler's numbers for the evaluation batch that follows
        ``count`` scored seeds of the current state."""
        return seeded_draws(3, count, self.device)

    # -- buffer states ------------------------------------------------------------

    def _swap_state(self, st) -> None:
        if self.emb_buffer is not None:
            if self.emb_buffer.resident is None:
                self.emb_buffer.load(st)
            else:
                self.emb_buffer.swap_to_state(st)
            if self.cache is not None:
                self.cache.mirror_layout(self.emb_buffer.resident)
        else:
            self.cache.swap_to_state(st)

    def flush(self) -> None:
        """Write the embedding co-buffer's resident partitions back to the
        host arrays (a checkpoint boundary)."""
        if self.emb_buffer is not None:
            self.emb_buffer.flush()

    def _reset_layout(self) -> None:
        """Forget the resident set (the co-buffer written back first), so
        the next state is admitted as a fresh load: slot i holds its i-th
        partition whatever ran before."""
        if self.emb_buffer is not None:
            self.emb_buffer.flush()
            self.emb_buffer.release()
        if self.cache is not None:
            self.cache.release()

    def _plan_epoch(self) -> List[np.ndarray]:
        if self.ordering == "SEQUENTIAL":
            return sequential_node_ordering(self.num_partitions, self.capacity)
        return dispersed_node_ordering(self.num_partitions, self.capacity,
                                       seed=self.seed + self.epoch)

    def _state_edges(self, st) -> int:
        P = self.num_partitions
        return int(sum(self.bucket_offsets[i * P + j + 1] - self.bucket_offsets[i * P + j]
                       for i in st for j in st))

    def _state_graph(self, max_edges: int) -> DeviceGraph:
        return state_graph(self.edges_by_bucket, self.bucket_offsets, self._ref.resident,
                           self.num_partitions, self._ref.psize, max_edges, self.device)

    def _local_seeds(self, seeds_g: np.ndarray):
        """(buffer-local ids, labels) of global seed ids, as int64 device
        tensors."""
        psize = self._ref.psize
        slot = self._ref.part_to_slot[seeds_g // psize]
        local = (slot * psize + seeds_g % psize).astype(np.int64)
        labels = self.labels_host[seeds_g].astype(np.int64)
        return (torch.from_numpy(local).to(self.device),
                torch.from_numpy(labels).to(self.device))

    def _outer_rows(self, outer: Tensor):
        """(feature rows, embedding rows) of the outer hop's buffer-local ids
        through the row-gather kernel; padding ids read zeros (the cache's
        zero row; the table's rows are zeroed as JAX does)."""
        feats = None if self.cache is None else gather_rows(self.cache.device_rows, outer)
        emb = None
        if self.emb_buffer is not None:
            emb = gather_rows(self.emb_buffer.device_values, outer)
            emb = torch.where((outer < self._ref.buffer_rows)[:, None], emb, 0.0)
        return feats, emb

    # -- training -------------------------------------------------------------------

    def _batch_step(self, graph: DeviceGraph, seeds: Tensor, mask: Tensor, labels: Tensor,
                    draws: Draws, dropout_key):
        """One batch (JAX batch_step :190-243); returns (detached loss,
        overflow) on the device. On a mesh ``seeds``, ``mask`` and ``labels``
        are the whole batch's: this rank scores its data index's share, and
        the loss and overflow returned are the whole batch's."""
        model, mesh = self.model, self.mesh
        if mesh is not None:
            bl = self.batch_size // self._n_data
            part = slice(self._data_index * bl, (self._data_index + 1) * bl)
            seeds, mask, labels = seeds[part], mask[part], labels[part]
        nb = sample_neighbor_batch(draws, graph, seeds, mask, self.nbr_configs, self.hop_caps)
        outer = nb.node_ids[0]
        feats, emb = self._outer_rows(outer)
        if emb is not None:
            emb.requires_grad_(True)
        loss_mask = mask & nb.seed_mask
        w = 1.0
        if mesh is not None and model.loss_reduction.upper() == "MEAN":
            # the local over the total valid seeds, so the summed MEAN is the batch's
            local = loss_mask.float().sum()
            w = local / mesh.all_reduce(local.clone(), DATA_AXIS).clamp_min(1.0)
        logits = encoder_forward(model.encoder, self.params["encoder"], emb, feats, nb,
                                 degrees=graph.degrees, train=True, dropout_key=dropout_key)
        loss = nc_batch_loss(model, logits, labels, loss_mask) * w
        leaves = tree_leaves(self.params)
        grads = torch.autograd.grad(loss, leaves + ([emb] if emb is not None else []),
                                    allow_unused=True)
        if emb is not None:
            g_emb = grads[-1] if grads[-1] is not None else torch.zeros_like(emb)
            # hop ids are unique per batch: the row-sparse rule applies directly
            sparse_adagrad_update_buffer(self.emb_buffer.device_values,
                                         self.emb_buffer.device_state, outer, g_emb,
                                         model.sparse_lr)
        dense = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads[:len(leaves)], leaves)]
        loss, overflow = loss.detach(), nb.overflow
        if mesh is not None:
            # one all_reduce: the loss, the overflow count and the dense gradients
            sums = [loss.reshape(1).clone(), overflow.float().reshape(1)]
            sum_over_data(sums + dense, mesh, DATA_AXIS)
            loss, overflow = sums[0][0], sums[1][0].long()
        it = iter(dense)
        _, self.opt_state = apply_optimizer(model.dense_optimizer, self.params, self.opt_state,
                                            tree_map(lambda _: next(it), self.params))
        return loss, overflow

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self) -> Dict[str, float]:
        """One epoch over the buffer's states. With ``profile_states`` the
        epoch records its spans (without counting synchronisations, which
        would add to the times), and each state's ``state.swap``,
        ``state.graph`` and ``state.train`` durations (each ending in a
        synchronisation) become ``last_state_timings``."""
        with (recording(sync_debug=False) if self.profile_states
              else contextlib.nullcontext()), \
                span("train.epoch"):
            return self._train_epoch()

    def _train_epoch(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        states = self._plan_epoch()
        rng = np.random.default_rng(self.seed * 131 + self.epoch // self.epochs_per_shuffle)
        b = self.batch_size
        max_seeds = max(sum(len(self.train_by_part[p]) for p in st) for st in states)
        max_batches = _pow2(-(-max(max_seeds, 1) // b))
        max_edges = _pow2(max(self._state_edges(st) for st in states) or 1)
        fill = self._ref.buffer_rows
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        state_losses = []
        batches_run = 0
        collectives = 0 if self.mesh is None else self.mesh.collectives
        self.last_state_timings = []
        for s_idx, st in enumerate(states):
            with span("state.swap") as swap_span:
                self._swap_state(st)
                if self.profile_states:
                    self._sync()
            with span("state.graph") as graph_span:
                graph = self._state_graph(max_edges)
                if self.profile_states:
                    self._sync()
            with span("state.train") as train_span:
                seeds_g = (np.concatenate([self.train_by_part[p] for p in st]) if len(st)
                           else np.zeros(0, np.int32))
                rng.shuffle(seeds_g)
                seeds, labels = self._local_seeds(seeds_g)
                n = len(seeds_g)
                # the batches that hold a valid seed, counted over the whole batch
                # (equal on every rank of a mesh)
                nb = -(-n // b)
                pad = nb * b - n
                seeds = torch.cat([seeds, seeds.new_full((pad,), fill)])
                labels = torch.cat([labels, labels.new_zeros(pad)])
                masks = torch.arange(nb * b, device=self.device) < n
                state_loss = torch.zeros((), dtype=torch.float32, device=self.device)
                for i in range(nb):
                    step = s_idx * max_batches + i
                    sl = slice(i * b, (i + 1) * b)
                    with span("train.batch", (self.epoch, step)):
                        loss, ov = self._batch_step(
                            graph, seeds[sl], masks[sl], labels[sl],
                            self._batch_draws(self.epoch, step, self._data_index),
                            self._dropout_key(self.epoch, step, self._data_index))
                        state_loss += loss
                        overflow += ov
                        count("train.batches")
                state_losses.append(state_loss)
                # the padded batches: zero gradients, the dense optimizer still steps
                self.opt_state = apply_zero_grad_steps(self.model.dense_optimizer, self.params,
                                                       self.opt_state, max_batches - nb)
                batches_run += nb
                del graph
                if self.profile_states:
                    self._sync()
            if self.profile_states:
                self.last_state_timings.append(tuple(
                    s.duration_ns * 1e-9 for s in (swap_span, graph_span, train_span)))
        # the epoch's one device-to-host read
        with span("train.readback"):
            *per_state, truncated = torch.stack(
                [l.double() for l in state_losses] + [overflow.double()]).tolist()
        self.epoch += 1
        dt = time.perf_counter() - t0
        out = {
            "loss": float(np.sum(np.asarray(per_state, np.float32))),
            "state_losses": per_state,
            "epoch_time_s": dt,
            "nodes_per_sec": self.num_train / dt,
            "num_nodes_trained": self.num_train,
            "num_buffer_states": len(states),
            "max_batches": max_batches,
            "max_graph_edges": max_edges,
            "batches_run": batches_run,
            "masked_batches": len(states) * max_batches - batches_run,
            "truncated_frontier_ids": int(truncated),
        }
        if self.mesh is not None:
            out["collectives_per_batch"] = (self.mesh.collectives - collectives) / max(
                batches_run, 1)
        return out

    def train(self, num_epochs: int):
        return [self.train_epoch() for _ in range(num_epochs)]

    # -- evaluation -------------------------------------------------------------------

    @torch.no_grad()
    def evaluate_nodes(self, eval_nodes: np.ndarray) -> Dict[str, float]:
        """Accuracy over a node split through the same buffer states, without
        updates (JAX :392-474): {"num_evaluated", "accuracy"}. The pass
        starts from a fresh load of its first state (JAX's starts from
        whatever slots the previous pass left, ROADMAP C8), so the accuracy
        depends on the model alone: ``marius_eval`` after a reload gives
        ``marius_train``'s. On a mesh every rank scores the whole split."""
        states = self._plan_epoch()
        psize = self._ref.psize
        en = np.asarray(eval_nodes, np.int32)
        eval_by_part = [en[en // psize == p] for p in range(self.num_partitions)]
        # JAX pads to 1 << (max - 1).bit_length() here (train_epoch's pow2 with "or 1")
        max_edges = 1 << (max(self._state_edges(st) for st in states) - 1).bit_length()
        b, fill = self.batch_size, self._ref.buffer_rows
        correct = torch.zeros((), dtype=torch.float32, device=self.device)
        count = torch.zeros((), dtype=torch.float32, device=self.device)
        self.last_eval_batches = 0
        self._reset_layout()
        for st in states:
            self._swap_state(st)
            graph = self._state_graph(max_edges)
            seeds_g = (np.concatenate([eval_by_part[p] for p in st]) if len(st)
                       else np.zeros(0, np.int32))
            seeds, labels = self._local_seeds(seeds_g)
            n = len(seeds_g)
            nb = -(-n // b)
            pad = nb * b - n
            seeds = torch.cat([seeds, seeds.new_full((pad,), fill)])
            labels = torch.cat([labels, labels.new_zeros(pad)])
            masks = torch.arange(nb * b, device=self.device) < n
            # JAX's fully padded batches add nothing; each scored batch's
            # draws are keyed by the seeds scored before it in this state
            self.last_eval_batches += nb
            for i in range(nb):
                sl = slice(i * b, (i + 1) * b)
                nbatch = sample_neighbor_batch(self._eval_draws(i * b), graph, seeds[sl],
                                               masks[sl], self.nbr_configs, self._eval_caps)
                feats, emb = self._outer_rows(nbatch.node_ids[0])
                logits = encoder_forward(self.model.encoder, self.params["encoder"], emb,
                                         feats, nbatch, degrees=graph.degrees, train=False)
                stats = categorical_accuracy_statistics(logits, labels[sl],
                                                        masks[sl] & nbatch.seed_mask)
                correct += stats["correct"]
                count += stats["count"]
            del graph
        c, k = torch.stack([correct, count]).tolist()
        reporter = NodeClassificationReporter()
        reporter.add_statistics({"correct": c, "count": k})
        reporter.report()
        return reporter.results()

    # -- the TrainState view for checkpoints ------------------------------------------

    @property
    def state(self) -> TrainState:
        """The dense parameters and optimizer state; no table: the co-buffer
        is not checkpointed, as in the JAX package (ROADMAP C7)."""
        return TrainState(table=None, params=self.params, opt_state=self.opt_state,
                          epoch=self.epoch)

    @state.setter
    def state(self, s: TrainState) -> None:
        """Copy ``s``'s parameters and optimizer state into this trainer's
        own tensors."""
        with torch.no_grad():
            if len(tree_leaves(self.params)) != len(tree_leaves(s.params)):
                raise ValueError("the two states' parameter structures differ")
            tree_map(lambda d, v: d.copy_(v), self.params, s.params)
            tree_map(lambda d, v: d.copy_(v), self.opt_state.slots, s.opt_state.slots)
        self.opt_state = OptState(s.opt_state.step, self.opt_state.slots)
        self.epoch = int(s.epoch)

    def gathered_state(self) -> TrainState:
        """The state in the single-device layout: every rank of a mesh holds
        it whole (replicated)."""
        return self.state

    def load_gathered_state(self, full: TrainState) -> None:
        self.state = full
