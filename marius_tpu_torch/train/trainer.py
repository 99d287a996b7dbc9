"""Link-prediction trainer: shallow, FEATURE and GNN encoders.

Port of ``marius_tpu/train/trainer.py`` (TrainState :55-62, pad_edges :80-87,
LinkPredictionTrainer :90-717) on one device or a mesh (below), CORRUPT_NODE
and CORRUPT_REL training. Where the JAX version
compiles the whole epoch into one ``lax.scan``, this one runs an eager Python
loop over batches. Each batch:

1. draws negatives (``_sample_negatives``, the test seam for sampling);
2. gathers the batch's embedding rows with the gather kernel; with a GNN
   encoder (``nbr_configs`` and ``graph``), the batch's sorted unique ids
   (padded with N) seed the neighbour sampler instead, whose numbers come
   from ``_batch_draws`` (the test seam: one call per batch, after the
   negatives, as the JAX key schedule splits ``k_nb`` after them), and the
   rows gathered, and later updated, are the outermost hop's (padded with
   N: the Adagrad kernel skips it). FEATURE stages read the (N + 1)-row
   feature block (a zero sentinel row N) at the same ids, also through the
   gather kernel. A pure-FEATURE encoder has no table;
3. scores and takes the loss, then the gradient with respect to the gathered
   rows and the dense parameters (the table itself is not an autograd leaf);
4. updates the table in place with the row-sparse Adagrad kernel, and the
   dense parameters with the dense optimizer.

Both table-update branches of the JAX trainer are kept behind the same switch
(``dense_accum``, :231): small tables (N·d ≤ 8M, the flagship's 727,050)
sum per-occurrence gradients into a table-sized buffer and update every row;
large ones dedup the batch's ids first. The epoch's permutation
(``_epoch_permutation``, the test seam for shuffling) comes from a generator
seeded from (12345, epoch // epochs_per_shuffle). The loss accumulates on the
device and is read back once per epoch.

With ``train_filter_keys`` (the (dst, src) edge-key sets of the train edges,
``training.negative_sampling.filtered``), every sampled negative that forms a
train edge is masked (JAX :378-391); without them the local filters apply.

``edges_backend`` HOST_MEMORY or FLAT_FILE keeps the edges in host RAM (a
numpy array, or an ``np.memmap`` over the binary edge file) and streams them
to the device in chunks of ~2M edges (JAX :141-177, :627-698) with the JAX
package's numpy shuffles: a full permutation of a RAM array, or a random
chunk order and a permutation inside each chunk of a memmap. The JAX chunk
function pads the last chunk with fully masked batches; the port runs only
real batches and gives the dense optimizer the masked ones' zero-gradient
steps (``apply_zero_grad_steps``), so both reach the same state.

CORRUPT_REL (``_batch_step_rel``, JAX :520-598) corrupts relations instead of
nodes: each chunk's positives are re-scored under that chunk's (N,) relation
ids, drawn uniformly from [0, R) (``_sample_rel_negatives``, the test seam);
only the batch's endpoints enter the gather (``unique_cap`` 2B), and with a
GNN encoder they alone seed the sampler.

``dtype`` (``storage.embeddings.options.dtype``) is the table's and the
model parameters' type, as in JAX: a bfloat16 table is drawn in float32 and
rounded, the encoder and the decoder's relation tables are bfloat16, the
dense optimizer keeps bfloat16 slots (``nn/optimizers.py``), and the row
gather and the Adagrad kernel take their bfloat16 entries. FEATURE inputs
stay float32, as in JAX.

With ``mesh`` (``parallel/mesh.py``), every rank of a (data x node) mesh
runs the explicit sharded step (``parallel/collectives.py``; JAX :180-313,
:393-430): the table and its Adagrad state are row-sharded over the node
axis (rounded up to a multiple of its size with zero rows that only ever
see zero gradients), the dense parameters replicated. Every rank draws the
whole batch's negatives and permutation from the same seeded generator,
computes the filters, and trains its data index's part, so the shallow mesh
trajectory is the single-device one. GNN stages sample with a generator
seeded from (seed, data index), as JAX folds the shard index into its keys.
The port has no compiler that infers collectives: whatever
``training.mesh.mode`` says (auto, gspmd or explicit), a mesh trainer runs
the explicit step, and its ``sharding_mode`` reads "explicit". That covers
the cases JAX leaves to GSPMD too, whose trajectory is one device's:
CORRUPT_REL (the endpoints gathered, the decoder's relations summed with
the dense gradients), a FEATURE-only encoder (no table: the ranks of a node
row are replicas) and a batch or chunk count the data axis does not divide
(the batch splits at chunk boundaries into unequal parts,
``collectives.data_part``). ``gathered_state`` assembles the
single-device layout (evaluation, checkpoints) and ``load_gathered_state``
shards one back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from marius_tpu_torch.data.samplers.negative import (
    NegativeSample,
    NegativeSamplingConfig,
    local_filter_masks,
    sample_negatives,
)
from marius_tpu_torch.nn.decoders.edge import normalize_decoder_method
from marius_tpu_torch.ops.edge_keys import filter_mask_sampled
from marius_tpu_torch.data.samplers.neighbor import (
    Draws,
    estimate_hop_caps,
    generator_draws,
    sample_neighbor_batch,
)
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
from marius_tpu_torch.ops.unique import unique_padded
from marius_tpu_torch.parallel.embedding_table import (
    EmbeddingTable,
    gather_rows,
    init_embedding_table,
    sparse_adagrad_update,
    sparse_adagrad_update_dense_accum,
)
from marius_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    NODE_AXIS,
    gather_table,
    local_rows,
    shard_train_state,
)
from marius_tpu_torch.reporting.profiling import count, span

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    table: Optional[EmbeddingTable]
    params: Any
    opt_state: OptState
    epoch: int


def pad_edges(edges: np.ndarray, batch_size: int) -> Tuple[np.ndarray, int, int]:
    """Pad an (E, k) edge array to num_batches*batch_size rows."""
    e = np.asarray(edges, np.int64)
    num = e.shape[0]
    nb = -(-num // batch_size)
    padded = np.zeros((nb * batch_size, e.shape[1]), np.int64)
    padded[:num] = e
    return padded, num, nb


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one, only an explicit CPU request runs.
    A CUDA device comes back with its index, as tensors report it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class LinkPredictionTrainer:
    """Shallow-encoder (embedding table) link-prediction training."""

    def __init__(
        self,
        model: Model,
        num_nodes: int,
        num_relations: int,
        train_edges: np.ndarray,
        neg_config: NegativeSamplingConfig,
        batch_size: int = 1000,
        seed: int = 0,
        train_filter_keys=None,
        graph=None,                 # DeviceGraph: required when the encoder has GNN stages
        nbr_configs=(),             # train-time NeighborSamplingConfigs, outermost first
        features: Optional[np.ndarray] = None,   # (N, F) for FEATURE layers
        hop_caps=None,              # per-hop unique-node caps (default: worst case)
        mesh=None,                  # parallel.mesh.Mesh: table rows over NODE_AXIS,
                                    # batches over DATA_AXIS
        edges_backend: str = "DEVICE_MEMORY",
        epochs_per_shuffle: int = 1,
        dtype=torch.float32,        # the table's and the parameters' type
        device=None,
    ):
        if model.learning_task != LINK_PREDICTION:
            raise ValueError(f"LinkPredictionTrainer needs a {LINK_PREDICTION} model")
        if batch_size % neg_config.num_chunks:
            raise ValueError("batch_size must be divisible by num_chunks (static chunking)")
        if model.decoder is None:
            raise ValueError("link prediction needs an edge decoder")
        self.decoder_method = normalize_decoder_method(model.decoder.decoder_method)
        if self.decoder_method not in ("CORRUPT_NODE", "CORRUPT_REL"):
            raise ValueError(f"training supports CORRUPT_NODE/CORRUPT_REL, "
                             f"got {self.decoder_method}")
        if self.decoder_method == "CORRUPT_REL" and train_edges.shape[1] != 3:
            raise ValueError("CORRUPT_REL needs a 3-column (typed) edge list")
        self.edges_backend = edges_backend.upper()
        if self.edges_backend not in ("DEVICE_MEMORY", "HOST_MEMORY", "FLAT_FILE"):
            raise ValueError(f"unknown edges backend {edges_backend}")
        self.mesh = mesh
        self.sharding_mode = None
        if mesh is not None:
            self.sharding_mode = "explicit"
            if device is None:
                device = mesh.device
        if model.encoder.num_gnn_stages and not nbr_configs:
            raise ValueError("a GNN encoder needs one neighbour config per GNN stage")
        if nbr_configs and graph is None:
            raise ValueError("a GNN encoder needs a DeviceGraph")
        if model.encoder.has_features and features is None:
            raise ValueError("FEATURE layers need a feature matrix")

        self.device = resolve_device(device)
        self.train_filter_keys = (None if train_filter_keys is None else
                                  tuple(k.to(self.device) for k in train_filter_keys))
        self.model = model
        self.num_nodes = num_nodes
        self.num_relations = num_relations
        self.neg_config = neg_config
        self.batch_size = batch_size
        self.seed = seed
        self.epochs_per_shuffle = max(1, int(epochs_per_shuffle))
        self.has_rels = train_edges.shape[1] == 3

        if self.edges_backend == "DEVICE_MEMORY":
            padded, self.num_edges, self.num_batches = pad_edges(train_edges, batch_size)
            self.edges = torch.as_tensor(padded, device=self.device)
            self.edges_host = None
        else:
            self.edges_host = train_edges   # np.ndarray or np.memmap: no copy
            self.edges = None
            self.num_edges = train_edges.shape[0]
            self.num_batches = -(-self.num_edges // batch_size)
            # ~2M edges per streamed chunk
            self.chunk_batches = min(self.num_batches, max(1, (1 << 21) // batch_size))
        self._host_epoch = 0   # host-streamed epochs run (JAX :178), for the shuffle

        # initial values are drawn on the CPU, so they do not depend on the device
        init_gen = torch.Generator().manual_seed(seed)
        model.decoder.to(self.device)
        params = init_model_params(init_gen, model, dtype)
        params = tree_map(self._to_device_leaf, params)
        table = None
        # a mesh rounds the table up to a multiple of the node axis with zero rows
        self.num_table_rows = (num_nodes if mesh is None else
                               -(-num_nodes // mesh.shape[NODE_AXIS]) * mesh.shape[NODE_AXIS])
        if model.has_embeddings:
            table = init_embedding_table(init_gen, num_nodes, model.encoder.embedding_dim)
            if mesh is None:
                table = EmbeddingTable(values=table.values.to(self.device, dtype),
                                       state=table.state.to(self.device, dtype))
        self.state = TrainState(table=table, params=params,
                                opt_state=init_optimizer(model.dense_optimizer, params),
                                epoch=0)
        if mesh is not None:
            # the table stays on the host; each rank's card receives its shard only
            self.state = shard_train_state(self.state, mesh, self.num_table_rows,
                                           self.device, dtype)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # neighbour draws and dropout masks: on a mesh, one generator per data index
        draw_gen = self.generator
        if mesh is not None:
            data_seed = np.random.SeedSequence((seed, mesh.axis_index(DATA_AXIS)))
            draw_gen = torch.Generator(device=self.device).manual_seed(
                int(data_seed.generate_state(1)[0]))
        self._draws = generator_draws(draw_gen)
        self._dropout = DropoutKey(draw_gen)
        self._overflow = torch.zeros((), dtype=torch.int64, device=self.device)

        c, n = neg_config.num_chunks, neg_config.negatives_per_positive
        # unique ids of a batch: its 2B endpoints and both negative blocks;
        # CORRUPT_REL corrupts relations, so only the endpoints enter
        self.unique_cap = (2 * batch_size if self.decoder_method == "CORRUPT_REL"
                           else 2 * batch_size + 2 * c * n)
        # Small tables skip dedup: per-occurrence grads sum into a table-shaped
        # accumulator and Adagrad runs over every row (see
        # sparse_adagrad_update_dense_accum); large tables keep the unique path
        # whose cost is independent of num_nodes. A GNN encoder always dedups:
        # the unique ids seed the sampler.
        self.dense_accum = (model.has_embeddings and not nbr_configs
                            and num_nodes * model.encoder.embedding_dim <= 8_000_000)

        self.graph = None if graph is None else graph.to(self.device)
        self.nbr_configs = tuple(nbr_configs)
        self.hop_caps = (tuple(hop_caps or estimate_hop_caps(self.unique_cap, self.nbr_configs,
                                                             num_nodes))
                         if self.nbr_configs else ())
        # the sentinel row N: padded and clamped ids read zero features
        self.features = None
        if features is not None:
            f = np.zeros((num_nodes + 1, features.shape[1]), np.float32)
            f[:num_nodes] = features
            self.features = torch.as_tensor(f, device=self.device)
        self._mesh_update = None
        self._mesh_gnn = False
        if mesh is not None:
            self._build_mesh_update(hop_caps)

    def _build_mesh_update(self, hop_caps) -> None:
        """The explicit step for this encoder (JAX :262-313): the deep-encoder
        one for GNN or FEATURE stages (and a table-less encoder), with caps
        for the largest data part."""
        from marius_tpu_torch.parallel.collectives import (
            largest_part,
            make_sharded_gnn_lp_update,
            make_sharded_lp_update,
        )

        mesh, model, cfg = self.mesh, self.model, self.neg_config
        if not (self.nbr_configs or self.features is not None):
            self._mesh_update = make_sharded_lp_update(model, mesh, self.num_table_rows)
            return
        b_loc, c_loc = largest_part(self.batch_size, cfg.num_chunks, mesh.shape[DATA_AXIS])
        cap_local = 2 * b_loc
        if self.decoder_method != "CORRUPT_REL":
            cap_local += 2 * c_loc * cfg.negatives_per_positive
        caps_local = (cap_local,)
        if self.nbr_configs:
            est = estimate_hop_caps(cap_local, self.nbr_configs, self.num_nodes)
            if hop_caps:
                # configured caps bound the hops above the seeds, which are
                # never truncated
                est = [est[0]] + [min(int(u), int(e)) for u, e in zip(hop_caps[1:], est[1:])]
            caps_local = tuple(est)
        self.mesh_hop_caps = caps_local
        self._mesh_update = make_sharded_gnn_lp_update(
            model, mesh, self.num_table_rows, self.nbr_configs, caps_local, cap_local,
            self.num_nodes, has_features=self.features is not None)
        self._mesh_gnn = True

    def gathered_state(self) -> TrainState:
        """The state in the single-device layout: on a mesh the table's rows
        [0, N), values and Adagrad state, assembled over the node axis (every
        rank calls it); otherwise the state itself."""
        st = self.state
        if self.mesh is None or st.table is None:
            return st
        n = self.num_nodes
        table = EmbeddingTable(values=gather_table(st.table.values, self.mesh)[:n],
                               state=gather_table(st.table.state, self.mesh)[:n])
        return dataclasses.replace(st, table=table)

    def load_gathered_state(self, full: TrainState) -> None:
        """Copy a state in the single-device layout into this trainer's own
        tensors (on a mesh, this rank's rows of the table)."""
        from marius_tpu_torch.convert import copy_train_state_

        if self.mesh is not None and full.table is not None:
            def mine(t):
                return local_rows(t, self.num_table_rows, self.mesh, t.device)

            full = dataclasses.replace(full, table=EmbeddingTable(
                values=mine(full.table.values), state=mine(full.table.state)))
        copy_train_state_(self.state, full)

    def _to_device_leaf(self, t: Tensor) -> Tensor:
        if t.device == self.device:
            return t
        return t.detach().to(self.device).requires_grad_(t.requires_grad)

    # -- seams a test may replace --------------------------------------------

    def _sample_negatives(self, edges_b: Tensor, inverse: bool) -> NegativeSample:
        return sample_negatives(self.generator, self.neg_config, edges_b,
                                self.num_nodes, inverse=inverse)

    def _sample_rel_negatives(self) -> Tensor:
        """The (C, N) corrupting relation ids of the next CORRUPT_REL batch,
        uniform over [0, max(R, 1)) (JAX :531-532)."""
        cfg = self.neg_config
        return torch.randint(0, max(self.num_relations, 1),
                             (cfg.num_chunks, cfg.negatives_per_positive),
                             generator=self.generator, device=self.device)

    def _batch_draws(self) -> Draws:
        """The neighbour sampler's numbers for the next training batch."""
        return self._draws

    def _epoch_permutation(self, shuffle_epoch: int) -> Tensor:
        seed = int(np.random.SeedSequence((12345, shuffle_epoch)).generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randperm(self.num_batches * self.batch_size, generator=gen,
                              device=self.device)

    # ------------------------------------------------------------------------

    def _batch_step(self, edges_b: Tensor, mask_b: Tensor) -> Tensor:
        """One CORRUPT_NODE batch (JAX _batch_step :336-518); returns the
        detached loss."""
        model = self.model
        cfg = self.neg_config
        num_nodes = self.num_nodes
        c, nneg = cfg.num_chunks, cfg.negatives_per_positive
        b = self.batch_size
        state = self.state
        if self.decoder_method == "CORRUPT_REL":
            return self._batch_step_rel(edges_b, mask_b)

        # Untyped graphs train only the dst-corruption direction
        # (decoder_methods.cpp:99-102).
        inv_rel_on = model.decoder.use_inverse_relations and self.has_rels
        with span("negatives"):
            dst_ns = self._sample_negatives(edges_b, inverse=False)
            src_ns = self._sample_negatives(edges_b, inverse=True) if inv_rel_on else None

            src = torch.where(mask_b, edges_b[:, 0], num_nodes)
            dst = torch.where(mask_b, edges_b[:, -1], num_nodes)
            rel = edges_b[:, 1] if self.has_rels else None
            if self.train_filter_keys is not None:
                dst_keys, src_keys = self.train_filter_keys
                dst_filter = filter_mask_sampled(dst_keys, src, rel, dst_ns.ids)
                src_filter = (filter_mask_sampled(src_keys, dst, rel, src_ns.ids)
                              if inv_rel_on else None)
            else:
                # local (in-batch) false-negative filters (negative.cpp:328-366)
                dst_filter, src_filter = local_filter_masks(cfg, edges_b, mask_b, dst_ns,
                                                            src_ns)
        if self._mesh_update is not None:
            return self._mesh_batch_step({
                "src": src, "dst": dst, "mask": mask_b, "dst_negs": dst_ns.ids, "rel": rel,
                "src_negs": src_ns.ids if inv_rel_on else None,
                "dst_filter": dst_filter, "src_filter": src_filter})

        with span("unique"):
            parts = [src, dst, dst_ns.ids.reshape(-1)]
            if inv_rel_on:
                parts.append(src_ns.ids.reshape(-1))
            all_ids = torch.cat(parts)
            if self.dense_accum:
                gather_ids, pos = all_ids, None
            else:
                uniq = unique_padded(all_ids, size=self.unique_cap, fill_value=num_nodes)
                gather_ids, pos = uniq.ids, uniq.inverse

        # With a GNN encoder the batch's unique ids seed the sampler and the
        # rows come from the outermost hop (dataloader.cpp:417-441)
        nbr_batch = None
        row_ids = gather_ids
        if self.nbr_configs:
            nbr_batch = sample_neighbor_batch(self._batch_draws(), self.graph, gather_ids,
                                              gather_ids < num_nodes, self.nbr_configs,
                                              self.hop_caps)
            row_ids = nbr_batch.node_ids[0]
            self._overflow += nbr_batch.overflow
        x0, feats = self._outer_rows(row_ids)
        with span("forward"):
            encoded = encoder_forward(model.encoder, state.params["encoder"], x0, feats,
                                      nbr_batch,
                                      degrees=None if self.graph is None else self.graph.degrees,
                                      train=True, dropout_key=self._dropout)
            if self.dense_accum:
                # batch layout is [src; dst; dst_negs; src_negs]: slice, not gather
                d = encoded.shape[-1]
                loss, _ = lp_batch_loss_direct(
                    model, encoded[:b], encoded[b:2 * b], rel,
                    encoded[2 * b:2 * b + c * nneg].reshape(c, nneg, d),
                    encoded[2 * b + c * nneg:].reshape(c, nneg, d) if inv_rel_on else None,
                    mask_b, dst_filter, src_filter)
            else:
                loss, _ = lp_batch_loss(
                    model, encoded, pos[:b], pos[b:2 * b], rel,
                    pos[2 * b:2 * b + c * nneg].reshape(c, nneg),
                    pos[2 * b + c * nneg:].reshape(c, nneg) if inv_rel_on else None,
                    mask_b, dst_filter, src_filter)

        self._apply_gradients(loss, x0, all_ids, row_ids)
        return loss.detach()

    def _outer_rows(self, row_ids: Tensor) -> Tuple[Optional[Tensor], Optional[Tensor]]:
        """(table rows, feature rows) at ``row_ids``, each None without its
        stage; the table rows are the gradient's leaf."""
        x0 = feats = None
        with span("gather"):
            if self.state.table is not None:
                x0 = gather_rows(self.state.table.values, row_ids)
                x0.requires_grad_(True)
            if self.features is not None:
                feats = gather_rows(self.features, row_ids)
        return x0, feats

    def _mesh_batch_step(self, batch: Dict[str, Optional[Tensor]]) -> Tensor:
        """The explicit sharded step on the whole batch (JAX :393-430); returns
        the whole batch's loss."""
        st = self.state
        table = st.table
        args = (None if table is None else table.values, None if table is None else table.state,
                st.params, st.opt_state, batch)
        if self._mesh_gnn:
            degrees = None if self.graph is None else self.graph.degrees
            st.opt_state, loss, overflow = self._mesh_update(
                *args, self.graph, self.features, degrees, self._batch_draws(), self._dropout)
            if overflow is not None:
                self._overflow += overflow
        else:
            st.opt_state, loss = self._mesh_update(*args)
        return loss

    def _batch_step_rel(self, edges_b: Tensor, mask_b: Tensor) -> Tensor:
        """One CORRUPT_REL batch (JAX _batch_step_rel :520-598): relation
        negatives, no node negatives; returns the detached loss."""
        model, num_nodes, b = self.model, self.num_nodes, self.batch_size
        state = self.state
        with span("negatives"):
            neg_rel_ids = self._sample_rel_negatives()
            src = torch.where(mask_b, edges_b[:, 0], num_nodes)
            dst = torch.where(mask_b, edges_b[:, -1], num_nodes)
            rel = edges_b[:, 1]
        if self._mesh_update is not None:
            return self._mesh_batch_step({"src": src, "dst": dst, "mask": mask_b, "rel": rel,
                                          "neg_rels": neg_rel_ids})
        with span("unique"):
            all_ids = torch.cat([src, dst])
            if self.dense_accum:
                gather_ids, pos = all_ids, None
            else:
                uniq = unique_padded(all_ids, size=self.unique_cap, fill_value=num_nodes)
                gather_ids, pos = uniq.ids, uniq.inverse
        nbr_batch = None
        row_ids = gather_ids
        if self.nbr_configs:
            nbr_batch = sample_neighbor_batch(self._batch_draws(), self.graph, gather_ids,
                                              gather_ids < num_nodes, self.nbr_configs,
                                              self.hop_caps)
            row_ids = nbr_batch.node_ids[0]
            self._overflow += nbr_batch.overflow
        x0, feats = self._outer_rows(row_ids)
        with span("forward"):
            encoded = encoder_forward(model.encoder, state.params["encoder"], x0, feats,
                                      nbr_batch,
                                      degrees=None if self.graph is None else self.graph.degrees,
                                      train=True, dropout_key=self._dropout)
            if self.dense_accum:
                src_e, dst_e = encoded[:b], encoded[b:]
            else:
                src_e, dst_e = encoded[pos[:b]], encoded[pos[b:]]
            loss, _ = lp_batch_loss_rel(model, src_e, dst_e, rel, neg_rel_ids, mask_b)
        self._apply_gradients(loss, x0, all_ids, row_ids)
        return loss.detach()

    def _apply_gradients(self, loss: Tensor, x0: Optional[Tensor], all_ids: Tensor,
                         row_ids: Tensor) -> None:
        """Backward, then the table's Adagrad (per occurrence of ``all_ids``
        under ``dense_accum``, else at the unique ``row_ids``) and the dense
        optimizer."""
        model, state = self.model, self.state
        leaves = tree_leaves(state.params)
        inputs = leaves + ([x0] if x0 is not None else [])
        with span("backward"):
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        if x0 is not None:
            with span("sparse_update"):
                gx = grads[-1] if grads[-1] is not None else torch.zeros_like(x0)
                if self.dense_accum:
                    sparse_adagrad_update_dense_accum(state.table, all_ids, gx, model.sparse_lr)
                else:
                    sparse_adagrad_update(state.table, row_ids, gx, model.sparse_lr)
        with span("dense_update"):
            it = iter(grads[:len(leaves)])
            _, state.opt_state = apply_optimizer(model.dense_optimizer, state.params,
                                                 state.opt_state,
                                                 tree_map(lambda _: next(it), state.params))

    def _host_chunks(self):
        """The epoch's chunks of host edges, shuffled as the JAX package
        shuffles them (storage.h:23 chunked shuffle semantics); int32 rows."""
        shuffle_epoch = self._host_epoch // self.epochs_per_shuffle
        rng = np.random.default_rng((self.seed * 9176 + shuffle_epoch) & 0x7FFFFFFF)
        ce = self.chunk_batches * self.batch_size
        nchunks = -(-self.num_edges // ce)
        if not isinstance(self.edges_host, np.memmap) and self.num_edges <= 400_000_000:
            shuffled = np.asarray(self.edges_host, np.int32)[rng.permutation(self.num_edges)]
            for ci in range(nchunks):
                yield shuffled[ci * ce:(ci + 1) * ce]
        else:
            for ci in rng.permutation(nchunks):
                rows = np.asarray(self.edges_host[ci * ce:(ci + 1) * ce], np.int32)
                yield rows[rng.permutation(len(rows))]

    def _train_edges(self, rows: np.ndarray, first_batch: int = 0) -> Tensor:
        """Train the batches of a chunk of host edges (the epoch's batches
        from ``first_batch`` on); returns their loss sum."""
        b = self.batch_size
        n = len(rows)
        nb = -(-n // b)
        padded = np.zeros((nb * b, rows.shape[1]), np.int64)
        padded[:n] = rows
        edges = torch.from_numpy(padded).to(self.device)
        masks = torch.arange(nb * b, device=self.device) < n
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(nb):
            with span("train.batch", (self.state.epoch, first_batch + i)):
                total += self._batch_step(edges[i * b:(i + 1) * b], masks[i * b:(i + 1) * b])
                count("train.batches")
        return total

    def train_epoch(self) -> Dict[str, float]:
        with span("train.epoch"):
            return self._train_epoch()

    def _train_epoch(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        nb, b = self.num_batches, self.batch_size
        collectives = 0 if self.mesh is None else self.mesh.collectives
        # frontier ids that tight hop caps dropped (none under the default caps)
        self._overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        if self.edges_backend == "DEVICE_MEMORY":
            perm = self._epoch_permutation(self.state.epoch // self.epochs_per_shuffle)
            shuffled = self.edges[perm]
            masks = perm < self.num_edges
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(nb):
                with span("train.batch", (self.state.epoch, i)):
                    total += self._batch_step(shuffled[i * b:(i + 1) * b],
                                              masks[i * b:(i + 1) * b])
                    count("train.batches")
        else:
            chunk_losses = []
            for rows in self._host_chunks():
                first = len(chunk_losses) * self.chunk_batches
                chunk_losses.append(self._train_edges(rows, first))
                # the JAX chunk function's fully masked batches in a short chunk
                self.state.opt_state = apply_zero_grad_steps(
                    self.model.dense_optimizer, self.state.params, self.state.opt_state,
                    self.chunk_batches - -(-len(rows) // b))
            total = torch.stack(chunk_losses).sum()
            self._host_epoch += 1
        self.state.epoch += 1
        # the epoch's one device-to-host read, both numbers at once
        with span("train.readback"):
            total_loss, truncated = torch.stack([total.double(),
                                                 self._overflow.double()]).tolist()
        dt = time.perf_counter() - t0
        out = {
            "loss": total_loss,
            "epoch_time_s": dt,
            "edges_per_sec": self.num_edges / dt,
            "num_edges": self.num_edges,
        }
        if self.nbr_configs:
            out["truncated_frontier_ids"] = int(truncated)
        if self.mesh is not None:
            out["collectives_per_batch"] = (self.mesh.collectives - collectives) / nb
        return out

    def train(self, num_epochs: int):
        return [self.train_epoch() for _ in range(num_epochs)]
