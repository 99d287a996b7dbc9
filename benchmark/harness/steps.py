"""The check of the first training steps: the reference follows the program
step by step from the program's own state.

The program's state after each checked step (parameters, Adam's slots and,
where there is a table, its values and Adagrad state) is recorded. Step k of
the reference starts from the program's state after step k - 1 (the
benchmark's initial weights, zero slots, for step 1) and takes the same
batch. Three numbers:

- ``loss_gap``: the worst step's relative gap between the two losses;
- ``grad_gap``: the first gradient as the optimizer got it, worked out from
  the program's state after step 1 (Adam's first moment over 1 - beta_1;
  the square root of the table's Adagrad state), leaf by leaf against the
  reference's;
- ``change_gap``: the worst step's and leaf's gap between the norms of the
  two updates from the same state;
- ``direction_gap``: the worst step's and leaf's 1 - cos of the angle
  between the two updates from the same state (0 where they point the same
  way, 2 where one is the other reversed), which an update of the right
  size in the wrong direction cannot pass.

From the start, the two runs can part for a reason that is not a fault:
Adam's first update is lr * sign(g) in each element, so an element whose
gradient is zero to rounding can step the other way in the program, and the
later losses then differ by about 1e-5 (four cards, one seed in six). From
the program's state, that step shows only in the step's own update: not in
its norm, and in its direction by a few elements of many.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark.harness.compare import leaf_gap, relative_gap


def leaves(state: Dict) -> Dict[str, torch.Tensor]:
    """Every trained tensor of a state by name, the table as ``table``."""
    out = dict(state["params"])
    if "table" in state:
        out["table"] = state["table"]
    return out


def first_gradient_norms(state1: Dict, beta1: float) -> Dict[str, float]:
    """The first gradient's norm per leaf, from the state after step 1."""
    out = {k: float(m.norm()) / (1 - beta1) for k, m in state1["m"].items()}
    if "table_state" in state1:
        out["table"] = float(state1["table_state"].sum().sqrt())
    return out


def moved(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose update is compared: those whose gradient in the
    reference is at least a thousandth of the median leaf's (a gradient that
    is nought to rounding moves its leaf under Adam by round-off)."""
    med = float(np.median(list(ref_grad.values())))
    return [k for k, g in ref_grad.items() if g >= 1e-3 * med]


def to_device(state: Dict, device) -> Dict:
    return {k: ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict) else v.to(device))
            for k, v in state.items()}


def follow(step: Callable, initial: Dict, states: List[Dict], losses: List[float],
           batches: List, beta1: float, device):
    """(numbers, details): ``step(state, batch, t)`` is the reference's step,
    returning (loss, gradients by name, next state); ``states`` and
    ``losses`` are the program's after each step."""
    prev = initial
    loss_gaps, change_gaps, turns, grad_gap, details = [], [], [], float("nan"), []
    for t, batch in enumerate(batches):
        loss, grads, nxt = step(prev, batch, t)
        loss_gaps.append(relative_gap(losses[t], loss))
        ref_grad = {k: float(g.norm()) for k, g in grads.items()}
        if t == 0:
            grad_gap = leaf_gap(first_gradient_norms(states[0], beta1), ref_grad)
        mine = to_device(states[t], device)
        before, theirs, ours = leaves(prev), leaves(mine), leaves(nxt)
        keep = moved(ref_grad)
        ref_delta = {k: ours[k] - before[k] for k in keep}
        prog_delta = {k: theirs[k] - before[k] for k in keep}
        ref_update = {k: float(d.norm()) for k, d in ref_delta.items()}
        prog_update = {k: float(d.norm()) for k, d in prog_delta.items()}
        change_gaps.append(leaf_gap(prog_update, ref_update))
        turn = {k: turned(prog_delta[k], ref_delta[k]) for k in keep}
        turns.append(max(turn.values(), default=float("nan")))
        details.append({"loss": (losses[t], loss),
                        "update_norms": {k: (prog_update[k], ref_update[k]) for k in keep},
                        "turned": turn})
        prev = mine
    return ({"loss_gap": max(loss_gaps), "grad_gap": grad_gap,
             "change_gap": max(change_gaps), "direction_gap": max(turns)}, details)


def turned(program: torch.Tensor, reference: torch.Tensor) -> float:
    """1 - cos of the angle between two updates of one leaf (1 where the
    program's is zero)."""
    a, b = program.double().flatten(), reference.double().flatten()
    return 1.0 - float(a @ b) / max(float(a.norm() * b.norm()), 1e-300)
