"""Node-classification training and evaluation, full-graph mode, one device.

Port of ``marius_tpu/train/nc.py`` (NodeClassificationTrainer :48-329,
:388-464, :559-725; NodeClassificationEvaluator's full-graph path
:731-837) for GraphSAGE and GCN encoders over one FEATURE stage. Every batch
computes the GNN over ALL nodes (``nn/full_graph_encoder.py``) and takes the
CE loss at the batch's seed rows, which equals unbounded ALL sampling. Two
forms, chosen as the JAX package chooses them:

- **Linear collapse** (default for activation-free encoders, such as the
  reference's ogbn-arxiv config): setup runs one neighbour sum per GNN
  stage into the constant ``phi`` (``nn/linear_collapse.py``); a batch is a
  row gather of ``phi`` and small matmuls.
- **General** (``fg_linear_collapse=False``, or any encoder with an
  activation): the first GNN stage's aggregation of the constant features
  is computed once at setup; each batch runs the remaining stages' neighbour
  sums (one kernel call per pass, forward and backward), and the final
  stage only for the seed rows over their flat neighbour lists
  (``fg_seed_restrict``, on by default where the final stage allows it).

Where the JAX version compiles the epoch into one ``lax.scan``, this one
runs an eager Python loop over batches. The seed lists are built per batch
at their exact length: the epoch's permutation is read back once and each
batch's slot count computed on the host, so the JAX package's slot budget
and retrace machinery (``_fg_perm_host``, ``_fg_epoch_need``,
``_fg_ensure_budget``), which exists for XLA's static shapes, has no
counterpart. The epoch's permutation (``_epoch_permutation``, the test seam)
comes from a generator seeded from (54321, epoch): a new shuffle every epoch.

Sampled NC (``full_graph=None``), meshes and the sharded ring, bf16 and
GAT/RGCN stages raise ``NotImplementedError`` naming the slice that brings
them.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from marius_tpu_torch.data.full_graph import (
    FullGraphAdjacency,
    device_csr,
    device_seed_flat_lists,
    host_csr_from_adjacency,
)
from marius_tpu_torch.data.graph import DeviceGraph
from marius_tpu_torch.nn.full_graph_encoder import (
    check_ported,
    full_graph_encoder_forward,
    prepare_full_graph,
    supports_seed_restrict,
)
from marius_tpu_torch.nn.linear_collapse import build_linear_collapse, linear_collapse_eligible
from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model, init_model_params, nc_batch_loss
from marius_tpu_torch.nn.optimizers import apply_optimizer, init_optimizer, tree_leaves, tree_map
from marius_tpu_torch.reporting.metrics import categorical_accuracy_statistics
from marius_tpu_torch.train.trainer import TrainState, _later_slice, resolve_device

Tensor = torch.Tensor


def _pad_ids(ids: np.ndarray, batch_size: int):
    ids = np.asarray(ids, np.int64)
    num = ids.shape[0]
    nb = -(-num // batch_size)
    padded = np.zeros(nb * batch_size, np.int64)
    padded[:num] = ids
    return padded, num, nb


class NodeClassificationTrainer:
    """Full-graph GNN node classification on one device."""

    def __init__(
        self,
        model: Model,
        graph: DeviceGraph,
        features: Optional[np.ndarray],     # (N, F) float32
        labels: np.ndarray,                 # (N,) int
        train_nodes: np.ndarray,
        batch_size: int = 1000,
        seed: int = 0,
        dtype=torch.float32,
        mesh=None,
        full_graph: Optional[FullGraphAdjacency] = None,
        fg_seed_restrict: Optional[bool] = None,   # None = auto (on where the final stage allows it)
        fg_linear_collapse: Optional[bool] = None,  # None = auto (linear encoders; an explicit
                                                    # fg_seed_restrict keeps the general path)
        device=None,
    ):
        if model.learning_task != NODE_CLASSIFICATION:
            raise ValueError(f"NodeClassificationTrainer needs a {NODE_CLASSIFICATION} model")
        if full_graph is None:
            raise _later_slice("sampled node classification (full_graph=None)",
                               "the sampled-GNN slice")
        if mesh is not None:
            raise _later_slice("mesh training (data-parallel or the sharded ring)",
                               "the multi-GPU slice")
        if dtype != torch.float32:
            raise _later_slice(f"{dtype} training", "a later full-graph slice")
        check_ported(model.encoder)
        if features is None:
            raise ValueError("full-graph training needs node features")

        self.device = resolve_device(device)
        self.model = model
        self.graph = graph
        self.num_nodes = graph.num_nodes
        self.batch_size = batch_size
        self.features = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
        self.labels = torch.as_tensor(np.asarray(labels, np.int64), device=self.device)
        self.full_graph = full_graph.to(self.device)

        self._fg_collapse = self._fg_ops = None
        want_collapse = ((fg_linear_collapse if fg_linear_collapse is not None
                          else fg_seed_restrict is None)
                         and linear_collapse_eligible(model.encoder, True))
        if want_collapse:
            self._fg_collapse = build_linear_collapse(self.full_graph, model.encoder,
                                                      self.features)
        else:
            self.full_graph, self._fg_ops = prepare_full_graph(
                self.full_graph, model.encoder, self.features)
        self._fg_seed_restrict = (
            False if self._fg_collapse is not None
            else (supports_seed_restrict(model.encoder) if fg_seed_restrict is None
                  else bool(fg_seed_restrict)))
        if self._fg_seed_restrict:
            if not supports_seed_restrict(model.encoder):
                raise ValueError("the encoder's final stage does not support seed_restrict")
            self._fg_csr = host_csr_from_adjacency(self.full_graph)
            self._fg_csr_dev = device_csr(self._fg_csr, self.device)

        padded, self.num_train, self.num_batches = _pad_ids(train_nodes, batch_size)
        self.train_nodes = torch.as_tensor(padded, device=self.device)

        # initial values are drawn on the CPU, so they do not depend on the device
        params = init_model_params(torch.Generator().manual_seed(seed), model)
        params = tree_map(lambda t: t.detach().to(self.device).requires_grad_(True), params)
        self.state = TrainState(table=None, params=params,
                                opt_state=init_optimizer(model.dense_optimizer, params),
                                epoch=0)

    # -- the seam a test may replace ------------------------------------------

    def _epoch_permutation(self, epoch: int) -> Tensor:
        seed = int(np.random.SeedSequence((54321, epoch)).generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randperm(self.num_batches * self.batch_size, generator=gen,
                              device=self.device)

    # ------------------------------------------------------------------------

    def _batch_step(self, seeds: Tensor, mask_b: Tensor, num_slots: Optional[int]) -> Tensor:
        """One batch (JAX _batch_step_full_graph :388-464); returns the
        detached loss. ``num_slots``: the batch's flat neighbour-list length
        (seed-restricted mode)."""
        model, state = self.model, self.state
        seeds_c = seeds.clamp(max=self.num_nodes - 1)
        labels_b = self.labels[seeds_c]
        enc = state.params["encoder"]
        if self._fg_collapse is not None:
            logits = self._fg_collapse.logits(enc, seeds_c)
        else:
            sr = None
            if self._fg_seed_restrict:
                sr = (seeds_c,) + device_seed_flat_lists(self._fg_csr_dev, seeds, mask_b,
                                                         num_slots, self.num_nodes)
            out = full_graph_encoder_forward(model.encoder, enc, None, self.features,
                                             self.full_graph, ops=self._fg_ops,
                                             seed_restrict=sr)
            logits = out if sr is not None else out[seeds_c]
        loss = nc_batch_loss(model, logits, labels_b, mask_b)
        grads = iter(torch.autograd.grad(loss, tree_leaves(state.params), allow_unused=True))
        _, state.opt_state = apply_optimizer(model.dense_optimizer, state.params,
                                             state.opt_state,
                                             tree_map(lambda _: next(grads), state.params))
        return loss.detach()

    def _batch_slot_counts(self, shuffled: Tensor, masks: Tensor):
        """Each batch's seed-list length: its valid seeds' combined degrees."""
        offsets = self._fg_csr[0]
        s = np.minimum(shuffled.cpu().numpy(), self.num_nodes - 1)
        return ((offsets[s + 1] - offsets[s]) * masks.cpu().numpy()).sum(axis=1).tolist()

    def train_epoch(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        nb, b = self.num_batches, self.batch_size
        perm = self._epoch_permutation(self.state.epoch).to(self.device)
        shuffled = self.train_nodes[perm].reshape(nb, b)
        masks = (perm < self.num_train).reshape(nb, b)
        slots = (self._batch_slot_counts(shuffled, masks) if self._fg_seed_restrict
                 else [None] * nb)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(nb):
            total += self._batch_step(shuffled[i], masks[i], slots[i])
        self.state.epoch += 1
        total_loss = float(total)  # the epoch's last device-to-host sync
        dt = time.perf_counter() - t0
        return {"loss": total_loss, "epoch_time_s": dt,
                "nodes_per_sec": self.num_train / dt, "num_nodes": self.num_train,
                "truncated_frontier_ids": 0}

    def train(self, num_epochs: int):
        return [self.train_epoch() for _ in range(num_epochs)]


class NodeClassificationEvaluator:
    """Accuracy over a node split with one full-graph pass (evaluator.cpp NC
    path). The JAX evaluator's padded batches only shape its compiled scan;
    here every evaluation node is scored at once."""

    def __init__(self, trainer: NodeClassificationTrainer, eval_nodes: np.ndarray):
        self.trainer = trainer
        self.eval_nodes = torch.as_tensor(np.asarray(eval_nodes, np.int64),
                                          device=trainer.device)
        self.num_eval = int(self.eval_nodes.shape[0])

    @torch.no_grad()
    def _full_graph_logits(self, params, nodes: Tensor) -> Tensor:
        """One full-graph pass; logits for the requested node ids."""
        tr = self.trainer
        rows = nodes.clamp(max=tr.num_nodes - 1)
        if tr._fg_collapse is not None:
            return tr._fg_collapse.logits(params["encoder"], rows)
        out = full_graph_encoder_forward(tr.model.encoder, params["encoder"], None,
                                         tr.features, tr.full_graph, ops=tr._fg_ops)
        return out[rows]

    def evaluate(self, state: TrainState) -> Dict[str, float]:
        """{"num_evaluated", "accuracy"}, the JAX evaluator's keys."""
        tr = self.trainer
        logits = self._full_graph_logits(state.params, self.eval_nodes)
        stats = categorical_accuracy_statistics(
            logits, tr.labels[self.eval_nodes.clamp(max=tr.num_nodes - 1)])
        count = float(stats["count"])
        return {"num_evaluated": count, "accuracy": float(stats["correct"]) / max(count, 1.0)}

    def predict_labels(self, state: TrainState) -> np.ndarray:
        """Predicted class per eval node (marius_predict's NC labels export)."""
        logits = self._full_graph_logits(state.params, self.eval_nodes)
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
