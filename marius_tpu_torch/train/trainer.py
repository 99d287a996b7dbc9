"""Link-prediction trainer for shallow (embedding-table) encoders.

Port of ``marius_tpu/train/trainer.py`` (TrainState :55-62, pad_edges :80-87,
LinkPredictionTrainer :90-717) for one device, edges in device memory
(``DEVICE_MEMORY``) and ``CORRUPT_NODE`` training. Where the JAX version
compiles the whole epoch into one ``lax.scan``, this one runs an eager Python
loop over batches. Each batch:

1. draws negatives (``_sample_negatives``, the test seam for sampling);
2. gathers the batch's embedding rows with the gather kernel;
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
HOST_MEMORY/FLAT_FILE edge streaming, CORRUPT_REL, meshes and GNN or FEATURE
encoders raise ``NotImplementedError`` naming the slice that brings them.
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
from marius_tpu_torch.nn.encoder import encoder_forward
from marius_tpu_torch.nn.model import (
    LINK_PREDICTION,
    Model,
    init_model_params,
    lp_batch_loss,
    lp_batch_loss_direct,
)
from marius_tpu_torch.nn.optimizers import (
    OptState,
    apply_optimizer,
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


def _later_slice(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with {where}")


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
        graph=None,
        nbr_configs=(),
        features: Optional[np.ndarray] = None,
        mesh=None,
        edges_backend: str = "DEVICE_MEMORY",
        epochs_per_shuffle: int = 1,
        device=None,
    ):
        if model.learning_task != LINK_PREDICTION:
            raise ValueError(f"LinkPredictionTrainer needs a {LINK_PREDICTION} model")
        if batch_size % neg_config.num_chunks:
            raise ValueError("batch_size must be divisible by num_chunks (static chunking)")
        if model.decoder is None:
            raise ValueError("link prediction needs an edge decoder")
        self.decoder_method = normalize_decoder_method(model.decoder.decoder_method)
        if self.decoder_method == "CORRUPT_REL":
            raise _later_slice("CORRUPT_REL training", "a later LP slice")
        if self.decoder_method != "CORRUPT_NODE":
            raise ValueError(f"training supports CORRUPT_NODE/CORRUPT_REL, "
                             f"got {self.decoder_method}")
        if edges_backend.upper() != "DEVICE_MEMORY":
            raise _later_slice(f"{edges_backend} edge streaming", "the out-of-core slice")
        if mesh is not None:
            raise _later_slice("mesh training", "the multi-GPU slice")
        if (graph is not None or nbr_configs or features is not None
                or model.encoder.num_gnn_stages or model.encoder.has_features
                or not model.has_embeddings):
            raise _later_slice("a GNN or FEATURE encoder", "the GNN slice")

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

        padded, self.num_edges, self.num_batches = pad_edges(train_edges, batch_size)
        self.edges = torch.as_tensor(padded, device=self.device)

        # initial values are drawn on the CPU, so they do not depend on the device
        init_gen = torch.Generator().manual_seed(seed)
        model.decoder.to(self.device)
        params = init_model_params(init_gen, model)
        params = tree_map(self._to_device_leaf, params)
        table = init_embedding_table(init_gen, num_nodes, model.encoder.embedding_dim)
        table = EmbeddingTable(values=table.values.to(self.device),
                               state=table.state.to(self.device))
        self.state = TrainState(table=table, params=params,
                                opt_state=init_optimizer(model.dense_optimizer, params),
                                epoch=0)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        c, n = neg_config.num_chunks, neg_config.negatives_per_positive
        self.unique_cap = 2 * batch_size + 2 * c * n
        # Small tables skip dedup: per-occurrence grads sum into a table-shaped
        # accumulator and Adagrad runs over every row (see
        # sparse_adagrad_update_dense_accum); large tables keep the unique path
        # whose cost is independent of num_nodes.
        self.dense_accum = num_nodes * model.encoder.embedding_dim <= 8_000_000

    def _to_device_leaf(self, t: Tensor) -> Tensor:
        if t.device == self.device:
            return t
        return t.detach().to(self.device).requires_grad_(t.requires_grad)

    # -- seams a test may replace --------------------------------------------

    def _sample_negatives(self, edges_b: Tensor, inverse: bool) -> NegativeSample:
        return sample_negatives(self.generator, self.neg_config, edges_b,
                                self.num_nodes, inverse=inverse)

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

        # Untyped graphs train only the dst-corruption direction
        # (decoder_methods.cpp:99-102).
        inv_rel_on = model.decoder.use_inverse_relations and self.has_rels
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
            dst_filter, src_filter = local_filter_masks(cfg, edges_b, mask_b, dst_ns, src_ns)

        parts = [src, dst, dst_ns.ids.reshape(-1)]
        if inv_rel_on:
            parts.append(src_ns.ids.reshape(-1))
        all_ids = torch.cat(parts)
        if self.dense_accum:
            gather_ids, pos = all_ids, None
        else:
            uniq = unique_padded(all_ids, size=self.unique_cap, fill_value=num_nodes)
            gather_ids, pos = uniq.ids, uniq.inverse

        x0 = gather_rows(state.table.values, gather_ids)
        x0.requires_grad_(True)
        encoded = encoder_forward(model.encoder, state.params["encoder"], x0, None)
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

        leaves = tree_leaves(state.params)
        gx, *gdense = torch.autograd.grad(loss, [x0] + leaves, allow_unused=True)
        if self.dense_accum:
            sparse_adagrad_update_dense_accum(state.table, all_ids, gx, model.sparse_lr)
        else:
            sparse_adagrad_update(state.table, gather_ids, gx, model.sparse_lr)
        it = iter(gdense)
        grads = tree_map(lambda _: next(it), state.params)
        _, state.opt_state = apply_optimizer(model.dense_optimizer, state.params,
                                             state.opt_state, grads)
        return loss.detach()

    def train_epoch(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        nb, b = self.num_batches, self.batch_size
        perm = self._epoch_permutation(self.state.epoch // self.epochs_per_shuffle)
        shuffled = self.edges[perm]
        masks = perm < self.num_edges
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(nb):
            total += self._batch_step(shuffled[i * b:(i + 1) * b], masks[i * b:(i + 1) * b])
        self.state.epoch += 1
        total_loss = float(total)  # the epoch's one device-to-host sync
        dt = time.perf_counter() - t0
        return {
            "loss": total_loss,
            "epoch_time_s": dt,
            "edges_per_sec": self.num_edges / dt,
            "num_edges": self.num_edges,
        }

    def train(self, num_epochs: int):
        return [self.train_epoch() for _ in range(num_epochs)]
