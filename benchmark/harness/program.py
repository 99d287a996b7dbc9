"""What the harness takes from the program under test (``marius_tpu_torch``)
and how: the dataset files it reads, the runtime ``marius_init`` builds, its
parameters by name, and patches on its seams and module functions that the
harness puts in and takes out again.

Nothing in ``benchmark/reference`` imports this module or the program.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Dict, List, Tuple

import torch

PROGRAM = "marius_tpu_torch"


def write_dataset(directory: str, data: Dict) -> None:
    """``data`` (a generator's arrays) in the dataset layout the program
    reads (``storage/dataset.py``)."""
    from marius_tpu_torch.storage.dataset import (
        DatasetStats,
        save_node_array,
        save_split,
        save_stats,
    )

    if data["task"] == "nc":
        save_split(directory, "train", data["edges"])
        save_node_array(directory, "features", data["features"])
        save_node_array(directory, "labels", data["labels"])
        for split in ("train", "valid", "test"):
            save_node_array(directory, f"{split}_nodes", data[f"{split}_nodes"])
        save_stats(directory, DatasetStats(
            num_nodes=data["num_nodes"], num_edges=len(data["edges"]), num_relations=1,
            num_edge_cols=2, num_train=len(data["train_nodes"]),
            num_valid=len(data["valid_nodes"]), num_test=len(data["test_nodes"]),
            num_classes=data["num_classes"], feature_dim=data["features"].shape[1]))
        return
    for split in ("train", "valid", "test"):
        save_split(directory, split, data[f"{split}_edges"])
    save_stats(directory, DatasetStats(
        num_nodes=data["num_nodes"],
        num_edges=sum(len(data[f"{s}_edges"]) for s in ("train", "valid", "test")),
        num_relations=data["num_relations"], num_edge_cols=3,
        num_train=len(data["train_edges"]), num_valid=len(data["valid_edges"]),
        num_test=len(data["test_edges"])))


def init_runtime(raw: Dict, model_dir: str, device):
    """The program's runtime for the configuration ``raw``, as
    ``marius_train`` builds it."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_init

    return marius_init(load_config(raw, model_dir=model_dir), train=True, device=device)


def leaf(tree, name: str) -> torch.Tensor:
    """The leaf of a parameter (or optimizer slot) tree at ``name``, a
    dotted path such as ``encoder.1.0.w1`` or ``decoder.relations``."""
    node = tree
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def leaf_names(tree, prefix: str = "") -> List[str]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix]
    out = []
    for k, v in items:
        out.extend(leaf_names(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def make_weights(shapes: Dict[str, Tuple[int, ...]], init: Dict[str, str], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Initial float32 weights from ``seed``, on ``device``, in one draw per
    leaf: a leaf whose name ends in a key of ``init`` takes that rule
    (``zeros``, ``ones``), every other one Glorot-uniform over its own two
    dimensions (``glorot_uniform``), or over (N, d) for ``table``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out = {}
    for name, shape in shapes.items():
        rule = next((r for k, r in init.items() if name.endswith(k)), "glorot_uniform")
        if rule == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif rule == "ones":
            out[name] = torch.ones(shape, device=device)
        elif rule == "glorot_uniform":
            limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
            out[name] = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * limit
        else:
            raise ValueError(f"unknown initial rule {rule!r} for {name}")
    return out


def install_weights(state, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the program's freshly built training state
    (``table`` into the embedding table's values); every dense leaf must be
    one of them, with the same shape."""
    names = sorted(leaf_names(state.params))
    dense = sorted(k for k in weights if k != "table")
    if names != dense:
        raise AssertionError(f"the program's parameters {names} are not the "
                             f"configuration's {dense}")
    with torch.no_grad():
        for name in dense:
            p = leaf(state.params, name)
            if tuple(p.shape) != tuple(weights[name].shape):
                raise AssertionError(f"{name}: the program holds {tuple(p.shape)}, the "
                                     f"configuration says {tuple(weights[name].shape)}")
            p.copy_(weights[name])
        if "table" in weights:
            state.table.values.copy_(weights["table"])


def to_host(tree) -> Dict[str, torch.Tensor]:
    """Every leaf of a tree, by name, copied to the host."""
    return {name: leaf(tree, name).detach().float().cpu().clone() for name in leaf_names(tree)}


class Patches:
    """Attributes set for a while and put back: ``set(obj, name, value)``
    remembers the old value (or that there was none) and ``restore()``
    undoes every set in reverse order."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object, bool]] = []

    def set(self, obj, name: str, value) -> None:
        had = name in vars(obj)
        self._undo.append((obj, name, getattr(obj, name, None), had))
        setattr(obj, name, value)

    def everywhere(self, original: Callable, replacement: Callable) -> int:
        """Replace ``original`` by ``replacement`` in every loaded module of
        the program that holds it (a ``from x import f`` copies the name);
        returns how many."""
        count = 0
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or not (mod_name == PROGRAM or mod_name.startswith(PROGRAM + ".")):
                continue
            for attr, value in list(vars(mod).items()):
                if value is original:
                    self.set(mod, attr, replacement)
                    count += 1
        return count

    def restore(self) -> None:
        while self._undo:
            obj, name, old, had = self._undo.pop()
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)

