"""Node-classification training and evaluation on one device: sampled GNNs
and full-graph mode.

Port of ``marius_tpu/train/nc.py`` (NodeClassificationTrainer :48-725 and
NodeClassificationEvaluator :731-863 without the mesh branches; reference
marius.cpp NODE_CLASSIFICATION task, dataloader.cpp nodeSample :473-496,
model.cpp forward_nc :246-250).

**Sampled** (``full_graph=None``, the path of ``ogbn_arxiv.yaml``): each
batch of train nodes expands hop by hop through the neighbour sampler
(``data/samplers/neighbor.py``, static hop caps, frontier-prefix layout),
gathers the outermost hop's feature rows (and EMBEDDING rows) with the
row-gather kernel, runs the GNN stages (one gather-sum kernel call per
layer), takes the CE loss over the valid seeds and updates the dense
parameters, and an EMBEDDING table with the row-sparse Adagrad kernel. The
feature block and the labels carry a sentinel row N (zeros, label 0) for
padded ids. The sampler's numbers come from the trainer's generator through
``_batch_draws`` (the test seam: one call per batch); the evaluator's from a
generator seeded from (seed, batch). The overflow count of tight hop caps
stays on the device until the epoch's one read-back. GAT's dropout masks come
from the same generator through ``_dropout_key`` (the test seam: one call per
batch, after the draws, as JAX's ``fold_in(k_s, 99)``).

**Full graph** (``full_graph`` given: every hop samples ALL): every batch
computes the GNN over ALL nodes (``nn/full_graph_encoder.py``) and takes the
loss at the seed rows, which equals unbounded ALL sampling. Two forms, as
the JAX package chooses them: the linear collapse (default for
activation-free encoders; ``nn/linear_collapse.py``), and the general form
(``fg_linear_collapse=False``, an encoder with an activation or an
EMBEDDING stage), whose final
stage runs for the seed rows only over their flat neighbour lists
(``fg_seed_restrict``; an RGCN final stage also over the seeds' directional
relational lists). Each batch's list lengths are computed on the host from
the epoch's permutation, so the JAX package's slot budget and retrace
machinery has no counterpart. Each batch's dropout key comes from
``_dropout_key`` (JAX's ``split(state.key)``). An EMBEDDING table takes a
table-shaped gradient, applied by the row-sparse Adagrad kernel over every
id (the JAX package's dense Adagrad over the table, the same function).

Where the JAX version compiles the epoch into one ``lax.scan``, this one
runs an eager Python loop over batches. The epoch's permutation
(``_epoch_permutation``, a test seam) comes from a generator seeded from
(54321, epoch // epochs_per_shuffle).

``dtype`` (JAX :145-153, :227, :293-295) is the features', the parameters'
and the table's: bfloat16 features are stored in bfloat16 with the zero
sentinel row, and the sampled layer-0 sums and the full-graph sums feed the
gather-sum kernel's bfloat16 entry (f32 accumulation; the sums rounded to
bfloat16, as JAX's default paths return them, ROADMAP C9).

With ``mesh`` (a (data x node) ``parallel.mesh.Mesh``) training is data
parallel over the data axis; the ranks of a node row are replicas. Features,
labels, the graph, the parameters and an EMBEDDING table are replicated,
and every rank draws the same permutation:

- **sampled** (JAX ``_batch_step_local`` / ``_sharded_batch_step``,
  :466-557): each data index takes ``batch_size / n_data`` of the batch's
  seeds, samples them with its own numbers (``_batch_draws(data_index)``,
  a generator seeded from (seed, data index), as JAX folds the index into
  its key) under hop caps sized for that local batch, and encodes and
  scores them; MEAN losses are weighted by local over total valid seeds (an
  all_reduce of the count). An EMBEDDING table's row gradients combine
  into JAX's accumulator G through one of its two routes
  (``collectives.nc_table_grad``), and the Adagrad kernel updates the rows
  G touches. One all_reduce over the data axis sums the dense gradients,
  the loss and the overflow count;
- **the linear collapse** (JAX :108-115, :403-417): each data index scores
  its seeds through the collapsed form, one all_reduce sums the gradients
  and the loss; the trajectory is one device's.

- **the node-sharded ring** (JAX :116-135, :159-214, :366-461): a
  full-graph encoder the collapse does not take (GraphSAGE/GCN with a
  nonlinearity, GAT, RGCN, or any with ``fg_linear_collapse=False``) on a
  mesh whose one non-trivial axis (``node`` or ``data``) shards the node
  rows: rank i of the axis holds rows [i n_loc, (i + 1) n_loc) of the
  features and of every activation, and each layer's aggregation is an
  S-step ring of block rotations (``data/full_graph_sharded.py``,
  ``data/full_graph_rel.py``). Every rank takes the whole batch and scores
  the seeds it owns (``seed // n_loc == shard``); MEAN keeps the whole
  batch's count; one all_reduce over the axis sums the loss and the dense
  gradients. It needs features (an EMBEDDING table is refused) and trains
  the whole graph (``fg_seed_restrict=True`` is refused). Every rank draws
  the same dropout masks of the global shape and uses its own rows. The
  evaluator rides the same sharded forward and sums its counts over the
  axis.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from marius_tpu_torch.data.full_graph import (
    FullGraphAdjacency,
    device_csr,
    device_seed_flat_lists,
    host_csr_from_adjacency,
)
from marius_tpu_torch.data.graph import DeviceGraph
from marius_tpu_torch.data.samplers.neighbor import (
    Draws,
    NeighborSamplingConfig,
    estimate_hop_caps,
    generator_draws,
    sample_neighbor_batch,
    seeded_draws,
)
from marius_tpu_torch.nn.encoder import encoder_forward
from marius_tpu_torch.data.full_graph_rel import (
    device_rel_csr,
    device_seed_flat_lists_rel,
    host_out_csr,
)
from marius_tpu_torch.nn.full_graph_encoder import (
    encoder_has_rgcn,
    final_stage_has_rgcn,
    full_graph_encoder_forward,
    prepare_full_graph,
    prepare_sharded_full_graph,
    supports_seed_restrict,
)
from marius_tpu_torch.nn.layers import DropoutKey
from marius_tpu_torch.nn.linear_collapse import build_linear_collapse, linear_collapse_eligible
from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model, init_model_params, nc_batch_loss
from marius_tpu_torch.nn.optimizers import apply_optimizer, init_optimizer, tree_leaves, tree_map
from marius_tpu_torch.ops.cuda import adagrad as adagrad_kernel
from marius_tpu_torch.parallel.collectives import nc_table_grad, sum_over_data
from marius_tpu_torch.parallel.embedding_table import (
    EmbeddingTable,
    gather_rows,
    init_embedding_table,
    sparse_adagrad_update,
)
from marius_tpu_torch.parallel.mesh import DATA_AXIS
from marius_tpu_torch.reporting.metrics import categorical_accuracy_statistics
from marius_tpu_torch.reporting.profiling import count, span
from marius_tpu_torch.reporting.reporters import NodeClassificationReporter
from marius_tpu_torch.train.trainer import TrainState, resolve_device

Tensor = torch.Tensor

def _pad_ids(ids: np.ndarray, batch_size: int):
    ids = np.asarray(ids, np.int64)
    num = ids.shape[0]
    nb = -(-num // batch_size)
    padded = np.zeros(nb * batch_size, np.int64)
    padded[:num] = ids
    return padded, num, nb


class NodeClassificationTrainer:
    """GNN node classification on one device, sampled or full-graph."""

    def __init__(
        self,
        model: Model,
        graph: DeviceGraph,
        features: Optional[np.ndarray],     # (N, F) float32 or None
        labels: np.ndarray,                 # (N,) int
        train_nodes: np.ndarray,
        nbr_configs: Sequence[NeighborSamplingConfig] = (),
        batch_size: int = 1000,
        hop_caps: Optional[Sequence[int]] = None,
        seed: int = 0,
        dtype=torch.float32,
        mesh=None,
        full_graph: Optional[FullGraphAdjacency] = None,  # exact-ALL mode; nbr_configs unused
        fg_seed_restrict: Optional[bool] = None,   # None = auto (on where the final stage allows it)
        fg_linear_collapse: Optional[bool] = None,  # None = auto (linear encoders; an explicit
                                                    # fg_seed_restrict keeps the general path)
        epochs_per_shuffle: int = 1,   # re-permute seeds every N epochs
        device=None,
    ):
        if model.learning_task != NODE_CLASSIFICATION:
            raise ValueError(f"NodeClassificationTrainer needs a {NODE_CLASSIFICATION} model")
        self.mesh = mesh
        self._n_data = 1
        if mesh is not None and device is None:
            device = mesh.device
        if full_graph is not None:
            if features is None and not model.has_embeddings:
                raise ValueError("full-graph training needs node features or an EMBEDDING "
                                 "table")
        else:
            if not nbr_configs and model.encoder.num_gnn_stages:
                raise ValueError("sampled GNN training needs one neighbour config per GNN stage")

        self.device = resolve_device(device)
        self.model = model
        self.graph = graph.to(self.device)
        self.num_nodes = n = graph.num_nodes
        self.batch_size = batch_size
        self.nbr_configs = tuple(nbr_configs)
        self.epochs_per_shuffle = max(1, int(epochs_per_shuffle))
        # sentinel row N, so clamped padded ids read zero features and label 0;
        # in the compute dtype (bf16 gathers move half the bytes). On the host
        # until the mode is known: the ring moves only a rank's rows
        self.features = None
        if features is not None:
            f = np.zeros((n + 1, features.shape[1]), np.float32)
            f[:n] = features
            self.features = torch.as_tensor(f).to(dtype)
        lab = np.zeros(n + 1, np.int64)
        lab[:n] = np.asarray(labels, np.int64)
        self.labels = torch.as_tensor(lab, device=self.device)

        self.full_graph = None
        self._fg_collapse = self._fg_ops = None
        self._fg_seed_restrict = False
        self._ring_axis = None
        self.hop_caps = None
        if full_graph is not None:
            self._init_full_graph(full_graph, fg_seed_restrict, fg_linear_collapse)
        if self.features is not None and self._ring_axis is None:
            self.features = self.features.to(self.device)
        if mesh is not None and self._ring_axis is None:
            self._n_data = mesh.shape[DATA_AXIS]
            if batch_size % self._n_data:
                raise ValueError(f"batch_size {batch_size} % data axis {self._n_data} != 0")
        if full_graph is None:
            # a data index samples its own share of the batch
            self.hop_caps = tuple(hop_caps or estimate_hop_caps(batch_size // self._n_data,
                                                                self.nbr_configs, n))

        padded, self.num_train, self.num_batches = _pad_ids(train_nodes, batch_size)
        self.train_nodes = torch.as_tensor(padded, device=self.device)

        # initial values are drawn on the CPU, so they do not depend on the device
        init_gen = torch.Generator().manual_seed(seed)
        params = init_model_params(init_gen, model, dtype)
        params = tree_map(lambda t: t.detach().to(self.device).requires_grad_(True), params)
        table = None
        if model.has_embeddings:
            t = init_embedding_table(init_gen, n, model.encoder.embedding_dim)
            table = EmbeddingTable(values=t.values.to(self.device, dtype),
                                   state=t.state.to(self.device, dtype))
        # the full-graph table update runs the row-sparse Adagrad over every id
        self._all_ids = (torch.arange(n, device=self.device)
                         if table is not None and self.full_graph is not None else None)
        self.state = TrainState(table=table, params=params,
                                opt_state=init_optimizer(model.dense_optimizer, params), epoch=0)
        if mesh is not None and self._ring_axis is None:
            # a data index's own numbers, as JAX folds the index into its key
            # (the ring's ranks share one generator: its masks are global)
            seed = int(np.random.SeedSequence((seed, mesh.axis_index(DATA_AXIS)))
                       .generate_state(1)[0])
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self._draws = generator_draws(generator)
        self._dropout = DropoutKey(generator)

    def _init_full_graph(self, adj: FullGraphAdjacency, fg_seed_restrict, fg_linear_collapse):
        model = self.model
        want_collapse = ((fg_linear_collapse if fg_linear_collapse is not None
                          else fg_seed_restrict is None)
                         and linear_collapse_eligible(model.encoder, self.features is not None))
        if self.mesh is not None and not want_collapse:
            self._init_ring(adj, fg_seed_restrict)
            return
        if self.features is not None:
            self.features = self.features.to(self.device)
        feats = self._all_features()
        adj = adj.to(self.device)
        self.full_graph = adj
        if want_collapse:
            self._fg_collapse = build_linear_collapse(adj, model.encoder, feats)
        else:
            self.full_graph, self._fg_ops = prepare_full_graph(adj, model.encoder, feats)
        self._fg_seed_restrict = (
            False if self._fg_collapse is not None
            else (supports_seed_restrict(model.encoder) if fg_seed_restrict is None
                  else bool(fg_seed_restrict)))
        self._fg_rel_csr = None
        if self._fg_seed_restrict:
            if not supports_seed_restrict(model.encoder):
                raise ValueError("the encoder's final stage does not support seed_restrict")
            self._fg_csr = host_csr_from_adjacency(self.full_graph)
            self._fg_csr_dev = device_csr(self._fg_csr, self.device)
            if final_stage_has_rgcn(model.encoder):
                # the directional out-CSR with each slot's relation
                self._fg_rel_csr = host_out_csr(self.full_graph.rel)
                self._fg_rel_csr_dev = device_rel_csr(self._fg_rel_csr, self.device)

    def _init_ring(self, adj: FullGraphAdjacency, fg_seed_restrict) -> None:
        """The node-sharded ring (JAX :116-135, :159-214): this rank's rows of
        the features and degrees, the placed ring schedules and their ops.
        The whole adjacency stays on the host (export re-prepares one
        device's ops from it)."""
        from marius_tpu_torch.data.full_graph_rel import (
            build_sharded_rel_graph,
            edges_from_rel_graph,
        )
        from marius_tpu_torch.data.full_graph_sharded import (
            build_sharded_from_csr,
            place_on_mesh,
            shard_rows,
        )

        mesh, model, n = self.mesh, self.model, self.num_nodes
        axes = [name for name, size in mesh.shape.items() if size > 1]
        if len(axes) != 1:
            raise ValueError(f"sharded full-graph mode uses ONE mesh axis (got shape "
                             f"{dict(mesh.shape)})")
        if self.features is None or model.has_embeddings:
            raise ValueError("sharded full-graph mode needs feature inputs (sharded embedding "
                             "tables: use the sampled path)")
        if fg_seed_restrict:
            raise ValueError("seed_restrict is a single-device optimization")
        axis = self._ring_axis = axes[0]
        s, shard = mesh.shape[axis], mesh.axis_index(axis)
        adj = adj.to("cpu")
        self.full_graph = adj
        sg = place_on_mesh(build_sharded_from_csr(*host_csr_from_adjacency(adj), n, s), mesh,
                           axis)
        self._ring_rows = (shard, sg.n_loc)
        dev = self.device
        # the whole feature block stays on the host; this rank's rows go to its device
        self._fg_x = shard_rows(self.features[:-1], sg.n_loc, shard, dev)
        in_deg = shard_rows(adj.in_deg, sg.n_loc, shard, dev, torch.int32)
        out_deg = shard_rows(adj.out_deg, sg.n_loc, shard, dev, torch.int32)
        rel = None
        if encoder_has_rgcn(model.encoder):
            if adj.rel is None:
                raise ValueError("sharded RGCN needs the relational companion: build the "
                                 "adjacency with with_relations=True")
            rel = place_on_mesh(build_sharded_rel_graph(edges_from_rel_graph(adj.rel), n, s),
                                mesh, axis)
        self._fg_view, self._fg_ops = prepare_sharded_full_graph(
            sg, model.encoder, in_deg, out_deg, mesh, axis, features=self._fg_x,
            rel_sharded=rel)

    def _all_features(self) -> Optional[Tensor]:
        """The (N, F) feature block without its sentinel row, or None."""
        return None if self.features is None else self.features[:-1]

    # -- the seams a test may replace ------------------------------------------

    def _epoch_permutation(self, period: int) -> Tensor:
        seed = int(np.random.SeedSequence((54321, period)).generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randperm(self.num_batches * self.batch_size, generator=gen,
                              device=self.device)

    def _batch_draws(self, data_index: int = 0) -> Draws:
        """The sampler's numbers for the next training batch (on a mesh,
        for this rank's ``data_index``)."""
        return self._draws

    def _dropout_key(self):
        """The dropout key of the next training batch (GAT's masks)."""
        return self._dropout

    # -- sampled --------------------------------------------------------------

    def _encode_batch(self, table_values: Optional[Tensor], draws: Draws, seeds: Tensor,
                      seed_mask: Tensor, hop_caps):
        """(neighbour batch, outer feature rows, outer embedding rows): the
        sample, then the outermost hop's rows through the row-gather kernel
        (the hop sets are unique and padded with N: the features' sentinel
        row, a clamped read of the table)."""
        nb = sample_neighbor_batch(draws, self.graph, seeds, seed_mask, self.nbr_configs,
                                   hop_caps)
        outer = nb.node_ids[0]
        with span("gather"):
            feats = None if self.features is None else gather_rows(self.features, outer)
            emb = None if table_values is None else gather_rows(table_values, outer)
        return nb, feats, emb

    def _sampled_logits(self, params, nb, feats, emb, train: bool) -> Tensor:
        return encoder_forward(self.model.encoder, params["encoder"], emb, feats, nb,
                               degrees=self.graph.degrees, train=train,
                               dropout_key=self._dropout_key() if train else None)

    def _sampled_batch_step(self, seeds: Tensor, mask_b: Tensor):
        """One sampled batch (JAX _batch_step_local :466-544 without the mesh
        branch); returns (detached loss, overflow), both on the device."""
        model, state = self.model, self.state
        table = state.table
        nb, feats, emb = self._encode_batch(None if table is None else table.values,
                                            self._batch_draws(), seeds, mask_b, self.hop_caps)
        with span("forward"):
            labels_b = self.labels[seeds.clamp(max=self.num_nodes)]
            loss_mask = mask_b & nb.seed_mask
            if emb is not None:
                emb.requires_grad_(True)
            logits = self._sampled_logits(state.params, nb, feats, emb, True)
            loss = nc_batch_loss(model, logits, labels_b, loss_mask)
        leaves = tree_leaves(state.params)
        with span("backward"):
            grads = torch.autograd.grad(loss, leaves + ([emb] if emb is not None else []),
                                        allow_unused=True)
        if emb is not None:
            with span("sparse_update"):
                g_emb = grads[-1] if grads[-1] is not None else torch.zeros_like(emb)
                sparse_adagrad_update(table, nb.node_ids[0], g_emb, model.sparse_lr)
        with span("dense_update"):
            dense = iter(grads[:len(leaves)])
            _, state.opt_state = apply_optimizer(model.dense_optimizer, state.params,
                                                 state.opt_state,
                                                 tree_map(lambda _: next(dense), state.params))
        return loss.detach(), nb.overflow

    def _data_part(self, seeds: Tensor, mask_b: Tensor):
        """This data index's seeds of the batch and their mask."""
        bl = self.batch_size // self._n_data
        i = self.mesh.axis_index(DATA_AXIS)
        return seeds[i * bl:(i + 1) * bl], mask_b[i * bl:(i + 1) * bl]

    def _mesh_weight(self, local_mask: Tensor) -> Tensor:
        """MEAN's weight of a data index's loss, local over total valid
        seeds (one all_reduce of the count; JAX psums it)."""
        local = local_mask.float().sum()
        total = self.mesh.all_reduce(local.clone(), DATA_AXIS)
        return local / total.clamp_min(1.0)

    def _mesh_sampled_batch_step(self, seeds: Tensor, mask_b: Tensor):
        """One sampled batch, data parallel (JAX _batch_step_local with its
        data axis :466-544); returns the whole batch's (loss, overflow)."""
        model, state, mesh = self.model, self.state, self.mesh
        table = state.table
        seeds, mask = self._data_part(seeds, mask_b)
        nb, feats, emb = self._encode_batch(None if table is None else table.values,
                                            self._batch_draws(mesh.axis_index(DATA_AXIS)),
                                            seeds, mask, self.hop_caps)
        labels_b = self.labels[seeds.clamp(max=self.num_nodes)]
        loss_mask = mask & nb.seed_mask
        w = self._mesh_weight(loss_mask) if model.loss_reduction.upper() == "MEAN" else 1.0
        if emb is not None:
            emb.requires_grad_(True)
        logits = self._sampled_logits(state.params, nb, feats, emb, True)
        loss = nc_batch_loss(model, logits, labels_b, loss_mask) * w
        leaves = tree_leaves(state.params)
        grads = torch.autograd.grad(loss, leaves + ([emb] if emb is not None else []),
                                    allow_unused=True)
        if emb is not None:
            g_emb = grads[-1] if grads[-1] is not None else torch.zeros_like(emb)
            rows, G = nc_table_grad(self.num_nodes, nb.node_ids[0], g_emb, mesh)
            adagrad_kernel.sparse_adagrad_update_(table.values, table.state, rows, G,
                                                  model.sparse_lr)
        overflow = (torch.zeros((), device=self.device) if nb.overflow is None
                    else nb.overflow).float()
        loss, overflow = self._mesh_step_end(grads[:len(leaves)], loss, overflow)
        return loss, overflow.long()

    def _mesh_collapse_batch_step(self, seeds: Tensor, mask_b: Tensor) -> Tensor:
        """One batch of the linear collapse, data parallel (JAX :403-417);
        returns the whole batch's loss."""
        model, state = self.model, self.state
        seeds_l, mask = self._data_part(seeds, mask_b)
        seeds_c = seeds_l.clamp(max=self.num_nodes - 1)
        w = 1.0
        if model.loss_reduction.upper() == "MEAN":
            # every rank holds the whole batch's mask: no collective
            w = mask.float().sum() / mask_b.float().sum().clamp_min(1.0)
        logits = self._fg_collapse.logits(state.params["encoder"], seeds_c)
        loss = nc_batch_loss(model, logits, self.labels[seeds_c], mask) * w
        grads = torch.autograd.grad(loss, tree_leaves(state.params), allow_unused=True)
        return self._mesh_step_end(grads, loss)[0]

    def _mesh_step_end(self, grads, *scalars, axis: str = DATA_AXIS):
        """The mesh steps' epilogue: the dense gradients (None where unused)
        and ``scalars`` summed over ``axis`` (the data axis, or the ring's)
        in one all_reduce, then the dense optimizer. Returns the summed
        scalars."""
        state = self.state
        leaves = tree_leaves(state.params)
        dense = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
        sums = [t.detach().reshape(1).clone() for t in scalars]
        sum_over_data(sums + dense, self.mesh, axis)
        it = iter(dense)
        _, state.opt_state = apply_optimizer(self.model.dense_optimizer, state.params,
                                             state.opt_state,
                                             tree_map(lambda _: next(it), state.params))
        return [t[0] for t in sums]

    # -- full graph -------------------------------------------------------------

    def _ring_forward(self, params, train: bool) -> Tensor:
        """This rank's (n_loc, d_out) rows of the encoder's output."""
        return full_graph_encoder_forward(
            self.model.encoder, params["encoder"], None, self._fg_x, self._fg_view,
            ops=self._fg_ops, train=train, dropout_key=self._dropout_key() if train else None)

    def _ring_seeds(self, nodes: Tensor):
        """(local rows, owned) of global node ids: their rows in this rank's
        block and whether this rank owns them."""
        shard, n_loc = self._ring_rows
        nodes = nodes.clamp(max=self.num_nodes - 1)
        return nodes % n_loc, nodes // n_loc == shard

    def _ring_batch_step(self, seeds: Tensor, mask_b: Tensor) -> Tensor:
        """One batch on the node-sharded ring (JAX _batch_step_full_graph
        :388-461 under GSPMD, written out): the seeds this rank owns are
        scored, MEAN keeps the whole batch's count, and one all_reduce over
        the ring axis sums the loss and the dense gradients. Returns the
        whole batch's loss."""
        model, state = self.model, self.state
        rows, mine = self._ring_seeds(seeds)
        mine = mine & mask_b
        labels_b = self.labels[seeds.clamp(max=self.num_nodes - 1)]
        logits = self._ring_forward(state.params, True)[rows]
        w = 1.0
        if model.loss_reduction.upper() == "MEAN":
            # every rank holds the whole batch's mask: no collective
            w = mine.float().sum() / mask_b.float().sum().clamp_min(1.0)
        loss = nc_batch_loss(model, logits, labels_b, mine) * w
        grads = torch.autograd.grad(loss, tree_leaves(state.params), allow_unused=True)
        return self._mesh_step_end(grads, loss, axis=self._ring_axis)[0]

    def _batch_step(self, seeds: Tensor, mask_b: Tensor, num_slots) -> Tensor:
        """One full-graph batch (JAX _batch_step_full_graph :388-464); returns
        the detached loss. ``num_slots``: the batch's flat neighbour-list
        length and, with an RGCN final stage, its out-edge list length
        (seed-restricted mode). An EMBEDDING table's gradient is
        table-shaped: the JAX package applies Adagrad densely over it, which
        is the row-sparse Adagrad kernel over every id (rows with a zero
        gradient do not move)."""
        if self._ring_axis is not None:
            return self._ring_batch_step(seeds, mask_b)
        if self.mesh is not None:
            return self._mesh_collapse_batch_step(seeds, mask_b)
        model, state = self.model, self.state
        seeds_c = seeds.clamp(max=self.num_nodes - 1)
        labels_b = self.labels[seeds_c]
        enc = state.params["encoder"]
        emb = None
        if self._fg_collapse is not None:
            logits = self._fg_collapse.logits(enc, seeds_c)
        else:
            sr = None
            if self._fg_seed_restrict:
                slots, rel_slots = num_slots
                sr = (seeds_c,) + device_seed_flat_lists(self._fg_csr_dev, seeds, mask_b,
                                                         slots, self.num_nodes)
                if self._fg_rel_csr is not None:
                    sr += (device_seed_flat_lists_rel(self._fg_rel_csr_dev, seeds, mask_b,
                                                      rel_slots, self.num_nodes),)
            if state.table is not None:
                # a leaf over the table's storage: autograd sees the rows, the
                # update below writes them in place
                emb = state.table.values.detach().requires_grad_(True)
            out = full_graph_encoder_forward(model.encoder, enc, emb, self._all_features(),
                                             self.full_graph, ops=self._fg_ops, train=True,
                                             dropout_key=self._dropout_key(), seed_restrict=sr)
            logits = out if sr is not None else out[seeds_c]
        loss = nc_batch_loss(model, logits, labels_b, mask_b)
        leaves = tree_leaves(state.params)
        grads = torch.autograd.grad(loss, leaves + ([emb] if emb is not None else []),
                                    allow_unused=True)
        if emb is not None:
            g_emb = grads[-1] if grads[-1] is not None else torch.zeros_like(emb)
            sparse_adagrad_update(state.table, self._all_ids, g_emb, model.sparse_lr)
        dense = iter(grads[:len(leaves)])
        _, state.opt_state = apply_optimizer(model.dense_optimizer, state.params,
                                             state.opt_state,
                                             tree_map(lambda _: next(dense), state.params))
        return loss.detach()

    def _batch_slot_counts(self, shuffled: Tensor, masks: Tensor):
        """Each batch's (seed-list length, out-edge list length): its valid
        seeds' combined degrees and, with an RGCN final stage, out-degrees."""
        s = np.minimum(shuffled.cpu().numpy(), self.num_nodes - 1)
        m = masks.cpu().numpy()

        def lengths(offsets):
            return ((offsets[s + 1] - offsets[s]) * m).sum(axis=1).tolist()

        rel = (lengths(self._fg_rel_csr[0]) if self._fg_rel_csr is not None
               else [None] * len(s))
        return list(zip(lengths(self._fg_csr[0]), rel))

    # ---------------------------------------------------------------------------

    def train_epoch(self) -> Dict[str, float]:
        with span("train.epoch"):
            return self._train_epoch()

    def _train_epoch(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        nb, b = self.num_batches, self.batch_size
        perm = self._epoch_permutation(self.state.epoch // self.epochs_per_shuffle)
        perm = perm.to(self.device)
        shuffled = self.train_nodes[perm].reshape(nb, b)
        masks = (perm < self.num_train).reshape(nb, b)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        collectives = 0 if self.mesh is None else self.mesh.collectives
        ring = (0, 0.0) if self.mesh is None else (self.mesh.ring_bytes, self.mesh.ring_wait_s)
        if self.full_graph is None:
            step = (self._sampled_batch_step if self.mesh is None
                    else self._mesh_sampled_batch_step)
            for i in range(nb):
                with span("train.batch", (self.state.epoch, i)):
                    loss, ov = step(shuffled[i], masks[i])
                    total += loss
                    overflow += ov
                    count("train.batches")
        else:
            slots = (self._batch_slot_counts(shuffled, masks) if self._fg_seed_restrict
                     else [None] * nb)
            for i in range(nb):
                with span("train.batch", (self.state.epoch, i)):
                    total += self._batch_step(shuffled[i], masks[i], slots[i])
                    count("train.batches")
        self.state.epoch += 1
        # the epoch's one device-to-host read, both numbers at once
        with span("train.readback"):
            total_loss, truncated = torch.stack([total.double(), overflow.double()]).tolist()
        truncated = int(truncated)
        if truncated:
            logging.getLogger("marius_tpu_torch").warning(
                "hop caps truncated %d frontier ids this epoch (drops the highest-id NEW "
                "neighbors — id-correlated, not uniform, under sequential id remaps; raise "
                "hop_caps or the empirical margin for exact frontiers)", truncated)
        dt = time.perf_counter() - t0
        out = {"loss": total_loss, "epoch_time_s": dt,
               "nodes_per_sec": self.num_train / dt, "num_nodes": self.num_train,
               "truncated_frontier_ids": truncated}
        if self.mesh is not None:
            out["collectives_per_batch"] = (self.mesh.collectives - collectives) / nb
        if self._ring_axis is not None:
            out["ring_bytes_per_batch"] = (self.mesh.ring_bytes - ring[0]) / nb
            out["ring_wait_s"] = self.mesh.ring_wait_s - ring[1]
        return out

    def train(self, num_epochs: int):
        return [self.train_epoch() for _ in range(num_epochs)]

    def gathered_state(self) -> TrainState:
        """The state in the single-device layout: every rank of a mesh holds
        it whole (replicated)."""
        return self.state

    def load_gathered_state(self, full: TrainState) -> None:
        from marius_tpu_torch.convert import copy_train_state_

        copy_train_state_(self.state, full)


class NodeClassificationEvaluator:
    """Accuracy over a node split (evaluator.cpp NC path). Sampled trainers
    evaluate in batches of ``batch_size`` under worst-case hop caps for that
    batch size, the batch's sampler numbers seeded from (seed, batch);
    full-graph trainers score every node in one full-graph pass."""

    def __init__(self, trainer: NodeClassificationTrainer, eval_nodes: np.ndarray,
                 batch_size: Optional[int] = None, seed: int = 11):
        self.trainer = trainer
        self.batch_size = batch_size or trainer.batch_size
        self.seed = seed
        padded, self.num_eval, self.num_batches = _pad_ids(eval_nodes, self.batch_size)
        self.eval_nodes = torch.as_tensor(padded, device=trainer.device)
        # caps must cover THIS batch size, not the trainer's: an undersized
        # cap would truncate hop sets
        self.hop_caps = (None if trainer.full_graph is not None else tuple(estimate_hop_caps(
            self.batch_size, trainer.nbr_configs, trainer.num_nodes)))

    def _batch_draws(self, index: int) -> Draws:
        """The sampler's numbers for evaluation batch ``index`` (the seam a
        test may replace)."""
        return seeded_draws(self.seed, index, self.trainer.device)

    @torch.no_grad()
    def _logits(self, state: TrainState):
        """Yields (logits, seeds, mask) per batch; one batch of all nodes for
        a full-graph trainer."""
        tr = self.trainer
        nodes = self.eval_nodes[:self.num_eval]
        if tr._ring_axis is not None:
            # this rank's rows of the sharded forward: the nodes it owns
            with span("eval.batch"):
                rows, mine = tr._ring_seeds(nodes)
                yield tr._ring_forward(state.params, False)[rows], nodes, mine
                count("eval.batches")
            return
        if tr.full_graph is not None:
            with span("eval.batch"):
                rows = nodes.clamp(max=tr.num_nodes - 1)
                if tr._fg_collapse is not None:
                    logits = tr._fg_collapse.logits(state.params["encoder"], rows)
                else:
                    logits = full_graph_encoder_forward(
                        tr.model.encoder, state.params["encoder"],
                        None if state.table is None else state.table.values,
                        tr._all_features(), tr.full_graph, ops=tr._fg_ops)[rows]
                yield logits, nodes, None
                count("eval.batches")
            return
        table_values = state.table.values if state.table is not None else None
        b = self.batch_size
        valid = torch.arange(self.num_batches * b, device=tr.device) < self.num_eval
        for i in range(self.num_batches):
            # the span stays open while the caller scores the batch
            with span("eval.batch"):
                seeds, mask = self.eval_nodes[i * b:(i + 1) * b], valid[i * b:(i + 1) * b]
                nb, feats, emb = tr._encode_batch(table_values, self._batch_draws(i), seeds,
                                                  mask, self.hop_caps)
                with span("forward"):
                    logits = tr._sampled_logits(state.params, nb, feats, emb, False)
                yield logits, seeds, mask & nb.seed_mask
                count("eval.batches")

    def evaluate(self, state: TrainState) -> Dict[str, float]:
        """{"num_evaluated", "accuracy"}, the JAX evaluator's keys."""
        with span("eval.evaluate"):
            return self._evaluate(state)

    def _evaluate(self, state: TrainState) -> Dict[str, float]:
        tr = self.trainer
        correct = torch.zeros((), dtype=torch.float32, device=tr.device)
        total = torch.zeros((), dtype=torch.float32, device=tr.device)
        for logits, seeds, mask in self._logits(state):
            stats = categorical_accuracy_statistics(
                logits, tr.labels[seeds.clamp(max=tr.num_nodes)], mask)
            correct += stats["correct"]
            total += stats["count"]
        both = torch.stack([correct, total])
        if tr._ring_axis is not None:
            tr.mesh.all_reduce(both, tr._ring_axis)
        with span("eval.readback"):
            c, n = both.tolist()
        reporter = NodeClassificationReporter()
        reporter.add_statistics({"correct": c, "count": n})
        reporter.report()
        return reporter.results()

    def predict_labels(self, state: TrainState) -> np.ndarray:
        """Predicted class per eval node (marius_predict's NC labels export)."""
        tr = self.trainer
        if tr._ring_axis is not None:
            # each node's owner gives its class, the others 0: one sum over the axis
            (logits, _, mine), = self._logits(state)
            preds = torch.where(mine, torch.argmax(logits, dim=-1), 0)
            return tr.mesh.all_reduce(preds, tr._ring_axis).to(torch.int32).cpu().numpy()
        preds = [torch.argmax(logits, dim=-1) for logits, _, _ in self._logits(state)]
        return torch.cat(preds)[:self.num_eval].to(torch.int32).cpu().numpy()
