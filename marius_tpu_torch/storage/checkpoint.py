"""Checkpoint save/load for the port's ``TrainState``.

Port of ``marius_tpu/storage/checkpoint.py`` (save_state, load_state and
create_checkpoint :59-153; reference storage/checkpointer.cpp:12-116). Each
leaf is a raw ``.npy`` in the checkpoint directory under the JAX package's
pytree-path name with "/" written as "__" (``table/values``, ``table/state``,
``params/decoder/relations``, ``params/encoder/0/0/bias``,
``opt_state/slots/exp_avg/...``, ``opt_state/step``, ``epoch``), and
meta.yaml lists them. So a checkpoint the JAX package wrote loads into the
port; its ``key`` leaf (the PRNG key) has no counterpart and is ignored.
``step`` and ``epoch`` are int32 arrays on disk and ints in the port.

bfloat16 leaves are written as the JAX package writes them: ``np.save`` of
an ``ml_dtypes`` bfloat16 array records the raw 2-byte elements (descr
``'<V2'``). The port writes the same bits with the same descr and reads any
2-byte void array as bfloat16 bits, so it needs no ``ml_dtypes`` and reads
and writes checkpoints the JAX package reads and writes. A leaf is cast to
the template's dtype on load.

A mesh trainer's checkpoint is written in the single-device layout (the
table's rows [0, N), from ``LinkPredictionTrainer.gathered_state``), so one
card reads it: with ``mesh``, rank 0 writes and the other ranks write
nothing and wait at a barrier until it has.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import yaml

from marius_tpu_torch.nn.optimizers import OptState
from marius_tpu_torch.parallel.embedding_table import EmbeddingTable
from marius_tpu_torch.train.trainer import TrainState

# leaf-path prefixes that hold optimizer rather than model state — dropped
# from interval checkpoints when training.checkpoint.save_state is false
# (checkpointer.cpp:30 skips the embeddings-state file the same way)
OPTIM_STATE_PREFIXES = ("opt_state", "table/state")


def _map_named(prefix: str, tree, fn: Callable[[str, Any], Any]):
    """``tree`` with each tensor leaf replaced by ``fn(path, leaf)``; the
    path joins dict keys and list positions with "/"."""
    if isinstance(tree, dict):
        return {k: _map_named(f"{prefix}/{k}", v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(f"{prefix}/{i}", v, fn) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def _map_state(state: TrainState, fn: Callable[[str, Any], Any]) -> TrainState:
    """``state`` rebuilt with ``fn(name, leaf)`` at every named leaf."""
    table = None
    if state.table is not None:
        table = EmbeddingTable(values=fn("table/values", state.table.values),
                               state=fn("table/state", state.table.state))
    return TrainState(
        table=table,
        params=_map_named("params", state.params, fn),
        opt_state=OptState(step=fn("opt_state/step", state.opt_state.step),
                           slots=_map_named("opt_state/slots", state.opt_state.slots, fn)),
        epoch=fn("epoch", state.epoch))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy; bfloat16 as its 2-byte elements (void
    ``'<V2'``, what ``np.save`` records for ``ml_dtypes.bfloat16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a) -> torch.Tensor:
    """A CPU tensor of a numpy array's values (a copy); 2-byte void arrays
    (``ml_dtypes.bfloat16``, or such an array read back by ``np.load``) are
    bfloat16 bits."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten_with_names(state: TrainState) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def put(name, leaf):
        if isinstance(leaf, torch.Tensor):
            out[name] = to_numpy(leaf)
        else:
            out[name] = np.asarray(leaf, np.int32)

    _map_state(state, put)
    return out


def save_state(directory: str, state: TrainState, metadata: Optional[Dict[str, Any]] = None,
               exclude_prefixes: Tuple[str, ...] = (), mesh=None) -> None:
    """Write a TrainState to ``directory`` atomically; with ``mesh``, only
    from rank 0, every rank returning once it is written."""
    if mesh is not None:
        try:
            if mesh.rank == 0:
                _write_state(directory, state, metadata, exclude_prefixes)
        finally:
            mesh.barrier()
        return
    _write_state(directory, state, metadata, exclude_prefixes)


def _write_state(directory: str, state: TrainState, metadata: Optional[Dict[str, Any]],
                 exclude_prefixes: Tuple[str, ...]) -> None:
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        leaves = _flatten_with_names(state)
        if exclude_prefixes:
            leaves = {n: a for n, a in leaves.items() if not n.startswith(exclude_prefixes)}
        for name, arr in leaves.items():
            np.save(os.path.join(tmp, name.replace("/", "__") + ".npy"), arr)
        meta = dict(metadata or {})
        meta["leaf_names"] = sorted(leaves.keys())
        with open(os.path.join(tmp, "meta.yaml"), "w") as f:
            yaml.safe_dump(meta, f)
        if not os.path.exists(directory):
            os.rename(tmp, directory)
        else:
            # overwrite in place: the dir may hold checkpoint_<n>/ subdirs and
            # logs that must survive a final save
            stale = set()
            old_meta = os.path.join(directory, "meta.yaml")
            if os.path.exists(old_meta):
                with open(old_meta) as f:
                    stale = {n.replace("/", "__") + ".npy"
                             for n in (yaml.safe_load(f) or {}).get("leaf_names", [])}
            for name in os.listdir(tmp):
                os.replace(os.path.join(tmp, name), os.path.join(directory, name))
                stale.discard(name)
            for name in stale:
                path = os.path.join(directory, name)
                if os.path.exists(path):
                    os.remove(path)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def load_state(directory: str, template: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """A new TrainState shaped like ``template`` (same devices, dtypes and
    requires_grad) holding the checkpoint's leaves. Optimizer leaves missing
    from a save_state=false checkpoint keep copies of the template's values
    and are listed in ``meta["missing_leaves"]``; a missing model leaf raises."""
    with open(os.path.join(directory, "meta.yaml")) as f:
        meta = yaml.safe_load(f)
    missing = []

    def restore(name, leaf):
        path = os.path.join(directory, name.replace("/", "__") + ".npy")
        if not os.path.exists(path):
            if not name.startswith(OPTIM_STATE_PREFIXES):
                # a missing MODEL leaf is a corrupt or mismatched checkpoint:
                # evaluating fresh-init params would silently report garbage
                raise FileNotFoundError(
                    f"checkpoint {directory} is missing model leaf '{name}' ({path}); "
                    "the checkpoint does not match the configured model")
            missing.append(name)
            arr = None
        else:
            arr = np.load(path)
        if not isinstance(leaf, torch.Tensor):
            return int(leaf if arr is None else arr)
        if arr is None:
            return leaf.detach().clone().requires_grad_(leaf.requires_grad)
        t = from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype).reshape(leaf.shape)
        return t.requires_grad_(leaf.requires_grad)

    state = _map_state(template, restore)
    if missing:
        meta = dict(meta)
        meta["missing_leaves"] = missing
    return state, meta


def create_checkpoint(model_dir: str, state: TrainState, epoch: int,
                      metadata: Optional[Dict[str, Any]] = None,
                      save_optim_state: bool = True, mesh=None) -> str:
    """Interval checkpoint: <model_dir>/checkpoint_<epoch>/ (checkpointer.cpp:18-37).

    With ``save_optim_state=False`` the optimizer/Adagrad leaves are omitted
    (CheckpointConfig.save_state gating, checkpointer.cpp:30): the snapshot
    is evaluable but resumes with fresh optimizer state."""
    meta = dict(metadata or {})
    meta["epochs_processed"] = int(epoch)
    target = os.path.join(model_dir, f"checkpoint_{epoch}")
    save_state(target, state, meta,
               exclude_prefixes=() if save_optim_state else OPTIM_STATE_PREFIXES, mesh=mesh)
    return target
