"""Plain PyTorch reference of sampled GraphSAGE node classification
(MariusGNN's ogbn-arxiv model: a FEATURE stage with a bias, then GraphSAGE
MEAN layers with biases, softmax cross entropy summed over the seeds, Adam).

It follows a training step from the batch's seeds and the sampler's random
draws: the sampled hops under the configuration's hop caps
(``common.sample_hops``), the outer hop's feature rows, each layer, the
loss, the gradients and Adam's update; and an evaluation batch's logits.
Parameters are named by their place in the configuration:
``encoder.<stage>.<layer>.<w1|w2|bias>``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.reference.common import Precision, adam_step, sage_mean, sample_hops

Tensor = torch.Tensor


def layers(model: Dict) -> List[Tuple[str, Dict]]:
    """(name prefix, layer block) of every layer of the encoder, in order."""
    out = []
    for i, stage in enumerate(model["encoder"]["layers"]):
        if len(stage) != 1:
            raise ValueError("the reference takes one layer per stage")
        out.append((f"encoder.{i}.0", stage[0]))
    return out


def param_shapes(model: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every trained parameter's shape, from the configuration."""
    shapes = {}
    for prefix, layer in layers(model):
        kind = layer["type"].upper()
        if kind == "GNN":
            opts = layer.get("options", {})
            if opts.get("type", "").upper() != "GRAPH_SAGE" or \
                    opts.get("aggregator", "").upper() != "MEAN":
                raise ValueError(f"the reference takes GraphSAGE MEAN layers, not {opts}")
            shape = (int(layer["input_dim"]), int(layer["output_dim"]))
            shapes[f"{prefix}.w1"] = shapes[f"{prefix}.w2"] = shape
        elif kind != "FEATURE":
            raise ValueError(f"the reference takes FEATURE and GNN stages, not {kind}")
        if layer.get("bias", False):
            shapes[f"{prefix}.bias"] = (int(layer["output_dim"]),)
    return shapes


def fanouts(model: Dict) -> List[int]:
    """The UNIFORM fanout of each hop, from the seeds outward (the
    configuration lists them outermost first)."""
    cfgs = model["encoder"]["train_neighbor_sampling"]
    for c in cfgs:
        if c["type"].upper() != "UNIFORM":
            raise ValueError(f"the reference takes UNIFORM sampling, not {c['type']}")
    return [int(c["options"]["max_neighbors"]) for c in reversed(cfgs)]


def eval_caps(batch: int, model: Dict, num_nodes: int) -> List[int]:
    """Evaluation's hop caps: the worst case, so that nothing is dropped
    (each hop at most (1 + 2 F) times the one before, at most N + 1)."""
    caps = [batch]
    for f in fanouts(model):
        caps.append(min(caps[-1] * (1 + 2 * f), num_nodes + 1))
    return caps


def logits(prec: Precision, model: Dict, params: Dict[str, Tensor], data: Dict,
           seeds: Tensor, mask: Tensor, draws, caps: Sequence[int]) -> Tensor:
    """(B, classes) logits of one batch of seeds."""
    n = data["num_nodes"]
    hops = sample_hops(draws, data["graph"], seeds, mask, fanouts(model), caps, n)
    h = None
    stack = list(reversed(hops))
    for prefix, layer in layers(model):
        if layer["type"].upper() == "FEATURE":
            outer = hops[-1].next_ids
            off = int(layer.get("offset", 0))
            h = data["features"][outer.clamp(max=n), off:off + int(layer["output_dim"])]
            if f"{prefix}.bias" in params:
                h = h + params[f"{prefix}.bias"]
        else:
            h = sage_mean(prec, h, stack.pop(0), params[f"{prefix}.w1"], params[f"{prefix}.w2"],
                          params.get(f"{prefix}.bias"))
    return h


def loss(prec, model, params, data, seeds, mask, draws, caps) -> Tensor:
    """Cross entropy summed over the valid seeds."""
    out = logits(prec, model, params, data, seeds, mask, draws, caps)
    labels = data["labels"][seeds.long().clamp(max=data["num_nodes"])]
    per = -torch.log_softmax(out, dim=-1).gather(1, labels[:, None])[:, 0]
    return (per * mask.to(per.dtype)).sum()


def initial_state(params0: Dict[str, Tensor]) -> Dict:
    """The training state before the first step: the weights, Adam's slots at 0."""
    return {"params": dict(params0), "m": {k: torch.zeros_like(v) for k, v in params0.items()},
            "v": {k: torch.zeros_like(v) for k, v in params0.items()}}


def step(prec: Precision, model: Dict, state: Dict, data: Dict, shares: List[Dict],
         caps: Sequence[int], lr: float, t: int):
    """One training step (the ``t``-th, from 0) from ``state``. The batch is
    a list of shares (one per data-parallel worker; one on one device), each
    with ``seeds``, ``mask`` and ``draws``; its loss is the sum of theirs.
    Returns (loss, gradients by name, the state after Adam's update)."""
    names = list(state["params"])
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state["params"].items()}
    value = sum(loss(prec, model, params, data, share["seeds"], share["mask"], share["draws"],
                     caps) for share in shares)
    grads = torch.autograd.grad(value, [params[k] for k in names])
    m = [state["m"][k].clone() for k in names]
    v = [state["v"][k].clone() for k in names]
    adam_step([params[k] for k in names], grads, m, v, t, lr)
    return (float(value.detach()), {k: g.detach() for k, g in zip(names, grads)},
            {"params": {k: params[k].detach() for k in names}, "m": dict(zip(names, m)),
             "v": dict(zip(names, v))})


def train_steps(prec: Precision, model: Dict, params0: Dict[str, Tensor], data: Dict,
                batches: List[List[Dict]], caps: Sequence[int], lr: float):
    """Adam steps from ``params0`` over ``batches`` (each a list of shares).
    Returns (losses, the state after each step)."""
    state, losses, states = initial_state(params0), [], []
    for t, shares in enumerate(batches):
        value, _, state = step(prec, model, state, data, shares, caps, lr, t)
        losses.append(value)
        states.append(state)
    return losses, states
