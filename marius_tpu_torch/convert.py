"""Carry a JAX training state into the port.

The JAX package's ``TrainState`` (``marius_tpu/train/trainer.py:55-62``),
turned into numpy by the caller (``jax.tree.map(np.asarray, state)``), becomes
the port's :class:`~marius_tpu_torch.train.trainer.TrainState`. Fields are
read by name from attributes or dict keys, so a nested dict works as well as
the mapped dataclass; this module never imports JAX. The PRNG key has no
counterpart (the port samples with ``torch.Generator``s) and is dropped.
Link-prediction and node-classification states alike: an NC state (or a
pure-FEATURE LP one) has ``table=None``, and GNN stages' parameters are
staged encoder params (``{"encoder": [[{...}], ...]}``) with their optimizer
slots, matched leaf by leaf. ``copy_buffer_trainer_from_jax_`` carries a JAX
``PartitionBufferLPTrainer``'s padded host table and Adagrad state, dense
parameters (a GNN's too) and optimizer state into the port's buffer
trainer; a feature cache is data, rebuilt from the features, not state.
bfloat16 leaves (``ml_dtypes`` arrays, which ``torch.from_numpy`` refuses)
come across as their bits (``storage.checkpoint.from_numpy``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from marius_tpu_torch.nn.optimizers import OptState, tree_leaves, tree_map
from marius_tpu_torch.parallel.embedding_table import EmbeddingTable
from marius_tpu_torch.storage.checkpoint import from_numpy
from marius_tpu_torch.storage.transfer import as_array
from marius_tpu_torch.train.trainer import TrainState


def _field(obj: Any, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(a, device, requires_grad=False) -> torch.Tensor:
    return from_numpy(a).to(device).requires_grad_(requires_grad)


def train_state_from_jax(np_state, device="cpu") -> TrainState:
    """The table (``values``, ``state``), the params (``encoder`` per-layer
    dicts, ``decoder`` relation tables; every leaf requires grad), the
    optimizer state (``step`` and ``slots``) and the epoch, on ``device``."""
    table = _field(np_state, "table")
    if table is not None:
        table = EmbeddingTable(values=_tensor(_field(table, "values"), device),
                               state=_tensor(_field(table, "state"), device))
    params = tree_map(lambda a: _tensor(a, device, True), _field(np_state, "params"))
    opt = _field(np_state, "opt_state")
    slots = tree_map(lambda a: _tensor(a, device), _field(opt, "slots"))
    return TrainState(table=table, params=params,
                      opt_state=OptState(step=int(_field(opt, "step")), slots=slots),
                      epoch=int(_field(np_state, "epoch")))


@torch.no_grad()
def copy_train_state_(dst: TrainState, src: TrainState) -> None:
    """Copy ``src`` into ``dst`` in place, keeping ``dst``'s tensors (a
    trainer's decoder parameters are its decoder module's own)."""
    if (dst.table is None) != (src.table is None):
        raise ValueError("one state has an embedding table and the other has none")
    if dst.table is not None:
        dst.table.values.copy_(src.table.values)
        dst.table.state.copy_(src.table.state)
    for d_tree, s_tree in ((dst.params, src.params), (dst.opt_state.slots, src.opt_state.slots)):
        if len(tree_leaves(d_tree)) != len(tree_leaves(s_tree)):
            raise ValueError("the two states' parameter structures differ")
        # matched by key and position: the JAX side's dicts come back with
        # sorted keys ("bias", "w1", "w2"), the port's in insertion order
        tree_map(lambda d, s: d.copy_(s), d_tree, s_tree)
    dst.opt_state = OptState(step=src.opt_state.step, slots=dst.opt_state.slots)
    dst.epoch = src.epoch


def copy_buffer_trainer_from_jax_(trainer, host_values: np.ndarray, host_state: np.ndarray,
                                  params, opt_state, epoch: int = 0) -> None:
    """Load a JAX ``PartitionBufferLPTrainer``'s ``buffer.host_values`` and
    ``buffer.host_state`` (the padded (num_partitions x psize, d) arrays),
    ``params``, ``opt_state`` and ``epoch``, all as numpy, into the port's
    ``PartitionBufferLPTrainer`` ``trainer``, in place. Its buffer is flushed
    and freed first (the ``state`` setter); the next epoch admits from the new
    host arrays."""
    buf, n = trainer.buffer, trainer.num_nodes
    if host_values.shape != buf.host_values.shape or host_state.shape != buf.host_state.shape:
        raise ValueError(f"host arrays {host_values.shape}, {host_state.shape} do not match "
                         f"the buffer's {buf.host_values.shape}")
    trainer.state = train_state_from_jax({
        "table": {"values": host_values[:n], "state": host_state[:n]},
        "params": params, "opt_state": opt_state, "epoch": epoch})
    # the last partition's padding rows
    buf.host_values[n:] = as_array(from_numpy(host_values[n:]).to(buf.dtype))
    buf.host_state[n:] = as_array(from_numpy(host_state[n:]).to(buf.dtype))
