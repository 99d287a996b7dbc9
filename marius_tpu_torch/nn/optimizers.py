"""Dense optimizers: SGD / Adagrad / Adam as plain functions on tensors.

Port of ``marius_tpu/nn/optimizers.py`` (OptimizerConfig, OptState,
init_optimizer, apply_optimizer :20-229; reference nn/optim.cpp). Parameters
are a nested structure of dicts and lists of tensors; the optimizer state maps
one to one onto the JAX package's: ``OptState(step, slots)`` with
``slots = {"exp_avg": tree, "exp_avg_sq": tree[, "max_exp_avg_sq": tree]}``
for Adam, ``{"sum": tree}`` for Adagrad, ``{"momentum": tree}`` or ``{}`` for
SGD. Where the JAX version returns new arrays, ``apply_optimizer`` updates
the parameters and slots in place (same formulas, same operation order) and
returns them. Step scalars are Python floats; JAX rounds them to float32.
``GroupedOptimizerConfig`` (per-layer optimizers) is here as the config
loader's type; applying it waits for a later slice, and the manager refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

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
    layer's params, ``("decoder",)`` for the decoder's."""

    default: OptimizerConfig
    overrides: Tuple[Tuple[Tuple, OptimizerConfig], ...] = ()


class OptState(NamedTuple):
    step: int    # optimizer steps taken
    slots: Any   # dict of per-param state trees


def tree_map(fn: Callable, tree, *rest):
    """Map over the tensor leaves of nested dicts/lists/tuples (same
    structure in ``tree`` and every tree of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def init_optimizer(config: OptimizerConfig, params) -> OptState:
    ot = config.optimizer_type.upper()
    zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
    if ot == "SGD":
        slots = {"momentum": tree_map(zeros, params)} if config.momentum else {}
    elif ot == "ADAGRAD":
        slots = {"sum": tree_map(
            lambda p: torch.full_like(p, config.init_value, requires_grad=False), params)}
    elif ot == "ADAM":
        slots = {"exp_avg": tree_map(zeros, params),
                 "exp_avg_sq": tree_map(zeros, params)}
        if config.amsgrad:
            slots["max_exp_avg_sq"] = tree_map(zeros, params)
    else:
        raise ValueError(f"Unknown optimizer type: {config.optimizer_type}")
    return OptState(step=0, slots=slots)


@torch.no_grad()
def apply_optimizer(config: OptimizerConfig, params, state: OptState,
                    grads) -> Tuple[Any, OptState]:
    """One optimizer step in place; returns (params, new_state). A ``None``
    gradient leaf counts as zeros (autograd leaves unused params without one,
    where JAX returns zeros)."""
    ot = config.optimizer_type.upper()
    grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g, grads, params)
    if config.weight_decay:
        grads = tree_map(lambda g, p: g + config.weight_decay * p, grads, params)

    if ot == "SGD":
        if config.momentum:
            def sgd_m(p, g, m):
                m.copy_(config.momentum * m + g)
                p.copy_(p - config.learning_rate * m)
            tree_map(sgd_m, params, grads, state.slots["momentum"])
        else:
            tree_map(lambda p, g: p.copy_(p - config.learning_rate * g), params, grads)
        return params, OptState(state.step + 1, state.slots)

    if ot == "ADAGRAD":
        # lr / (1 + num_steps * lr_decay); sum += g²; p -= lr * g / (sqrt(sum)+eps)
        lr = config.learning_rate / (1.0 + state.step * config.lr_decay)

        def adagrad(p, g, s):
            s.copy_(s + g * g)
            p.copy_(p - lr * g / (torch.sqrt(s) + config.eps))
        tree_map(adagrad, params, grads, state.slots["sum"])
        return params, OptState(state.step + 1, state.slots)

    if ot == "ADAM":
        b1, b2 = config.beta_1, config.beta_2
        t = state.step + 1.0
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        step_size = config.learning_rate / bc1
        sqrt_bc2 = bc2 ** 0.5
        slots = state.slots

        def adam(p, g, m, v, vmax=None):
            m.copy_(b1 * m + (1.0 - b1) * g)
            v.copy_(b2 * v + (1.0 - b2) * g * g)
            denom_src = v
            if vmax is not None:
                vmax.copy_(torch.maximum(vmax, v))
                denom_src = vmax
            p.copy_(p - step_size * m / (torch.sqrt(denom_src) / sqrt_bc2 + config.adam_eps))

        if config.amsgrad:
            tree_map(adam, params, grads, slots["exp_avg"], slots["exp_avg_sq"],
                     slots["max_exp_avg_sq"])
        else:
            tree_map(adam, params, grads, slots["exp_avg"], slots["exp_avg_sq"])
        return params, OptState(state.step + 1, slots)

    raise ValueError(f"Unknown optimizer type: {config.optimizer_type}")
