"""Dense optimizers: SGD / Adagrad / Adam as plain functions on tensors.

Port of ``marius_tpu/nn/optimizers.py`` (OptimizerConfig,
GroupedOptimizerConfig, OptState, init_optimizer, apply_optimizer :20-229;
reference nn/optim.cpp). Parameters are a nested structure of dicts and lists
of tensors; the optimizer state maps one to one onto the JAX package's:
``OptState(step, slots)`` with ``slots = {"exp_avg": tree, "exp_avg_sq":
tree[, "max_exp_avg_sq": tree]}`` for Adam, ``{"sum": tree}`` for Adagrad,
``{"momentum": tree}`` or ``{}`` for SGD. A ``GroupedOptimizerConfig``
(per-layer and per-decoder optimizers, model.cpp:161-218) gives every leaf
the optimizer of its most specific path prefix, and its slot tree is shaped
like the parameters with a dict of that leaf's slots at each leaf, as in the
JAX package (so a JAX checkpoint of a grouped model loads leaf by leaf).
Where the JAX version returns new arrays, ``apply_optimizer`` updates the
parameters and slots in place (same formulas, same operation order) and
returns them. Step scalars are Python floats; JAX rounds them to float32.

Low-precision (bfloat16) parameters follow what JAX computes, not what its
docstring says ("step math runs in f32"). JAX's Python scalars are weakly
typed, so ``bf16 * 0.9`` stays bfloat16, the scalar rounded to bfloat16 first;
XLA rounds after every operation. The step-dependent scalars (Adam's
``lr / bc1`` and ``sqrt(bc2)``, Adagrad's decayed lr) are float32 arrays, so
the expressions they enter are promoted to float32 and the result is rounded
to the parameter's dtype once at the end. So, for a bfloat16 leaf: SGD and
weight decay run in bfloat16; Adagrad's sum and Adam's moments are bfloat16,
updated in bfloat16 with bfloat16 constants; the parameter's Adagrad and Adam
update is computed in float32 from those and rounded. ``_const`` gives a
Python scalar the leaf's dtype where JAX's weak typing does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer_type: str = "ADAGRAD"   # SGD | ADAGRAD | ADAM
    learning_rate: float = 0.1
    # Adagrad (datatypes.py:56-58 + optim.cpp:85-145)
    eps: float = 1e-10
    lr_decay: float = 0.0
    weight_decay: float = 0.0
    init_value: float = 0.0
    # Adam (datatypes.py:74-79)
    beta_1: float = 0.9
    beta_2: float = 0.999
    adam_eps: float = 1e-8
    amsgrad: bool = False
    # SGD
    momentum: float = 0.0


@dataclasses.dataclass(frozen=True)
class GroupedOptimizerConfig:
    """Per-layer/per-decoder optimizers (setup_optimizers, nn/model.cpp:
    161-218), keyed by path prefixes: ``("encoder", stage, layer)`` for a
    layer's params, ``("decoder",)`` for the decoder's. A leaf takes the
    longest matching prefix's optimizer, else ``default``."""

    default: OptimizerConfig
    overrides: Tuple[Tuple[Tuple, OptimizerConfig], ...] = ()

    def config_for(self, path: Tuple) -> OptimizerConfig:
        best, best_len = self.default, -1
        for prefix, cfg in self.overrides:
            k = len(prefix)
            if k > best_len and path[:k] == prefix:
                best, best_len = cfg, k
        return best


AnyOptimizerConfig = Union[OptimizerConfig, GroupedOptimizerConfig]


class OptState(NamedTuple):
    step: int    # optimizer steps taken
    slots: Any   # dict of per-param state trees (grouped: per-leaf slot dicts)


def tree_map(fn: Callable, tree, *rest):
    """Map over the tensor leaves of nested dicts/lists/tuples (same
    structure in ``tree`` and every tree of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, path: Tuple = ()):
    """``tree_map`` whose ``fn`` also gets each leaf's path: the dict keys and
    list positions from the root (the JAX package's ``_norm_path``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _slot_names(config: OptimizerConfig) -> Tuple[str, ...]:
    ot = config.optimizer_type.upper()
    if ot == "SGD":
        return ("momentum",) if config.momentum else ()
    if ot == "ADAGRAD":
        return ("sum",)
    if ot == "ADAM":
        return ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if config.amsgrad else ())
    raise ValueError(f"Unknown optimizer type: {config.optimizer_type}")


def _slot_fill(config: OptimizerConfig) -> float:
    return config.init_value if config.optimizer_type.upper() == "ADAGRAD" else 0.0


def _leaf_init(config: OptimizerConfig, p: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {name: torch.full_like(p, _slot_fill(config), requires_grad=False)
            for name in _slot_names(config)}


def init_optimizer(config: AnyOptimizerConfig, params) -> OptState:
    if isinstance(config, GroupedOptimizerConfig):
        return OptState(step=0, slots=tree_map_with_path(
            lambda path, p: _leaf_init(config.config_for(path), p), params))
    fill = _slot_fill(config)
    slots = {name: tree_map(lambda p: torch.full_like(p, fill, requires_grad=False), params)
             for name in _slot_names(config)}
    return OptState(step=0, slots=slots)


def _const(x: float, p: torch.Tensor):
    """A Python scalar as JAX's weak typing applies it to ``p``: as is for a
    float32 leaf, rounded to ``p``'s dtype for a low-precision one."""
    if p.dtype == torch.float32:
        return x
    return torch.tensor(x, dtype=p.dtype, device=p.device)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def _leaf_apply_(config: OptimizerConfig, p: torch.Tensor, g: torch.Tensor,
                 slots: Dict[str, torch.Tensor], step: int) -> None:
    """One leaf's optimizer step, in place on ``p`` and its ``slots``."""
    ot = config.optimizer_type.upper()
    if config.weight_decay:
        g = g + _const(config.weight_decay, p) * p
    if ot == "SGD":
        if config.momentum:
            m = slots["momentum"]
            m.copy_(_const(config.momentum, p) * m + g)
            p.copy_(p - _const(config.learning_rate, p) * m)
        else:
            p.copy_(p - _const(config.learning_rate, p) * g)
        return
    if ot == "ADAGRAD":
        # lr / (1 + num_steps * lr_decay); sum += g²; p -= lr * g / (sqrt(sum)+eps)
        lr = config.learning_rate / (1.0 + step * config.lr_decay)
        s = slots["sum"]
        s.copy_(s + g * g)
        # lr is a float32 array in JAX: the update is float32, rounded once
        p.copy_(_f32(p) - lr * _f32(g) / _f32(torch.sqrt(s) + _const(config.eps, p)))
        return
    if ot == "ADAM":
        b1, b2 = config.beta_1, config.beta_2
        if p.dtype == torch.float32:
            t = step + 1.0
            bc1 = 1.0 - b1 ** t
            bc2 = 1.0 - b2 ** t
            step_size = config.learning_rate / bc1
            sqrt_bc2 = bc2 ** 0.5
        else:
            # float32 scalars, each operation rounded, as JAX's arrays
            f = np.float32
            t = f(step) + f(1.0)
            bc1 = f(1.0) - f(b1) ** t
            bc2 = f(1.0) - f(b2) ** t
            step_size = float(f(config.learning_rate) / bc1)
            sqrt_bc2 = float(np.sqrt(bc2))
        m, v = slots["exp_avg"], slots["exp_avg_sq"]
        m.copy_(_const(b1, p) * m + _const(1.0 - b1, p) * g)
        v.copy_(_const(b2, p) * v + _const(1.0 - b2, p) * g * g)
        denom_src = v
        if config.amsgrad:
            vmax = slots["max_exp_avg_sq"]
            vmax.copy_(torch.maximum(vmax, v))
            denom_src = vmax
        # lr / bc1 and sqrt(bc2) are float32 arrays in JAX: the update is
        # float32, rounded once
        p.copy_(_f32(p) - step_size * _f32(m)
                / (_f32(torch.sqrt(denom_src)) / sqrt_bc2 + config.adam_eps))
        return
    raise ValueError(f"Unknown optimizer type: {config.optimizer_type}")


@torch.no_grad()
def apply_optimizer(config: AnyOptimizerConfig, params, state: OptState,
                    grads) -> Tuple[Any, OptState]:
    """One optimizer step in place; returns (params, new_state). A ``None``
    gradient leaf counts as zeros (autograd leaves unused params without one,
    where JAX returns zeros)."""
    grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g, grads, params)
    if isinstance(config, GroupedOptimizerConfig):
        tree_map_with_path(lambda path, p, g, s: _leaf_apply_(config.config_for(path), p, g, s,
                                                              state.step),
                           params, grads, state.slots)
        return params, OptState(state.step + 1, state.slots)
    names = _slot_names(config)
    tree_map(lambda p, g, *s: _leaf_apply_(config, p, g, dict(zip(names, s)), state.step),
             params, grads, *(state.slots[n] for n in names))
    return params, OptState(state.step + 1, state.slots)


def is_noop_at_zero_grad(config: AnyOptimizerConfig) -> bool:
    """True when a step with an all-zero gradient changes no parameter and
    no slot, only the step count: SGD without momentum and Adagrad, neither
    with weight decay (for a grouped config: every group's optimizer). Adam's
    moments decay on zero gradients."""
    if isinstance(config, GroupedOptimizerConfig):
        return all(is_noop_at_zero_grad(c)
                   for c in (config.default,) + tuple(c for _, c in config.overrides))
    if config.weight_decay:
        return False
    ot = config.optimizer_type.upper()
    return ot == "ADAGRAD" or (ot == "SGD" and not config.momentum)


@torch.no_grad()
def apply_zero_grad_steps(config: AnyOptimizerConfig, params, state: OptState,
                          count: int) -> OptState:
    """``count`` optimizer steps with all-zero gradients (the JAX trainers'
    fully masked padding batches), in place; the no-op ones only count. A
    grouped config steps the leaves whose own optimizer is not a no-op."""
    if count <= 0:
        return state
    if is_noop_at_zero_grad(config):
        return OptState(state.step + count, state.slots)
    if isinstance(config, GroupedOptimizerConfig):
        def leaf(path, p, s):
            cfg = config.config_for(path)
            if not is_noop_at_zero_grad(cfg):
                zero = torch.zeros_like(p)
                for k in range(count):
                    _leaf_apply_(cfg, p, zero, s, state.step + k)
        tree_map_with_path(leaf, params, state.slots)
        return OptState(state.step + count, state.slots)
    zeros = tree_map(torch.zeros_like, params)
    for _ in range(count):
        _, state = apply_optimizer(config, params, state, zeros)
    return state
