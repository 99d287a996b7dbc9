"""Plain PyTorch reference of sampled GAT node classification: Velickovic et
al., "Graph Attention Networks", ICLR 2018 (arXiv:1710.10903), section 3.3's
inductive model, on Marius's node-classification path (a FEATURE stage with
a bias, GAT layers with biases, softmax cross entropy summed over the
seeds, Adam).

One GAT layer, for each target i and head h, over its slot set S_i (its
valid sampled in-neighbours, its valid sampled out-neighbours and i itself
where the target is a real node):

    e_ij  = LeakyReLU(a_l^h . W^h x_i + a_r^h . W^h x_j)    (slope from the configuration)
    alpha = softmax of e_i. over S_i
    out_i^h = sum over j in S_i of alpha_ij W^h x_j

then the heads concatenated or averaged, the bias added and the activation
applied; a target with no valid slot gives zeros before the bias. Every
source row is projected once (``W x_j``), and the weighted sums run over
blocks of targets so that the widest layer's slot block stays small.

Departures from the paper, each the configuration's (``changed``):

- ReLU in place of ELU between layers (Marius's activations are ReLU,
  sigmoid and none);
- no skip connection across the middle layer (Marius's GAT layer has none);
- 40-class softmax cross entropy over the seeds in place of the paper's
  121 independent sigmoids;
- sampled neighbourhoods (UNIFORM 32 in and 32 out per hop under hop caps)
  in place of full ones, with a node's out-neighbours in its set as well as
  its in-neighbours, as Marius's sampler gives both directions.

It follows a training step from the batch's seeds and the sampler's random
draws as ``sage_nc`` does (``common.sample_hops``), and computes in float32
with TF32 off (``common.Precision``). Parameters are named by their place in
the configuration: ``encoder.<stage>.<layer>.<w|a_l|a_r|bias>``, ``w`` of
shape (d_in, heads x head size).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.reference.common import Hop, Precision, adam_step, sample_hops
from benchmark.reference.sage_nc import eval_caps, fanouts, initial_state, layers

Tensor = torch.Tensor

__all__ = ["eval_caps", "fanouts", "initial_state", "layers", "param_shapes", "heads",
           "gat", "logits", "loss", "step", "train_steps"]

#: elements of one block of gathered projected rows (1 GiB of float32)
BLOCK_ELEMS = 1 << 28


def heads(layer: Dict) -> Tuple[int, int, bool]:
    """(heads, head size, averaged) of a GAT layer block."""
    opts = layer.get("options", {})
    h = int(opts.get("num_heads", 10))
    average = bool(opts.get("average_heads", True))
    out = int(layer["output_dim"])
    if not average and out % h:
        raise ValueError(f"{out} concatenated features do not split over {h} heads")
    return h, (out if average else out // h), average


def param_shapes(model: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every trained parameter's shape, from the configuration."""
    shapes = {}
    for prefix, layer in layers(model):
        kind = layer["type"].upper()
        if kind == "GNN":
            opts = layer.get("options", {})
            if opts.get("type", "").upper() != "GAT":
                raise ValueError(f"the reference takes GAT layers, not {opts}")
            h, k, _ = heads(layer)
            shapes[f"{prefix}.w"] = (int(layer["input_dim"]), h * k)
            shapes[f"{prefix}.a_l"] = shapes[f"{prefix}.a_r"] = (h, k)
        elif kind != "FEATURE":
            raise ValueError(f"the reference takes FEATURE and GNN stages, not {kind}")
        if layer.get("bias", False):
            shapes[f"{prefix}.bias"] = (int(layer["output_dim"]),)
    return shapes


def activation(name: str, x: Tensor) -> Tensor:
    name = name.upper()
    if name == "RELU":
        return torch.relu(x)
    if name == "SIGMOID":
        return torch.sigmoid(x)
    if name == "NONE":
        return x
    raise ValueError(f"unknown activation {name!r}")


def gat(prec: Precision, layer: Dict, x: Tensor, hop: Hop, target_mask: Tensor,
        params: Dict[str, Tensor], prefix: str) -> Tensor:
    """One GAT layer over one hop: ``x`` holds the rows of the hop's next
    node array, the targets are the hop's nodes (real where
    ``target_mask``)."""
    h, k, average = heads(layer)
    slope = float(layer.get("options", {}).get("negative_slope", 0.2))
    rows = x.shape[0]
    wx = prec.mm(x, params[f"{prefix}.w"]).view(rows, h, k)         # W^h x_j, every row
    src = (wx * params[f"{prefix}.a_r"]).sum(-1)                     # a_r^h . W^h x_j
    dst = (wx * params[f"{prefix}.a_l"]).sum(-1)                     # a_l^h . W^h x_i
    n = hop.self_pos.shape[0]
    width = hop.in_pos.shape[1] + hop.out_pos.shape[1] + 1
    block = max(1, BLOCK_ELEMS // (width * h * k))
    outs = []
    for s in range(0, n, block):
        part = slice(s, s + block)
        me = hop.self_pos[part].clamp(0, rows - 1)
        pos = torch.cat([hop.in_pos[part], hop.out_pos[part], me[:, None]], 1).clamp(0, rows - 1)
        valid = torch.cat([hop.in_mask[part], hop.out_mask[part], target_mask[part, None]], 1)
        e = torch.nn.functional.leaky_relu(dst[me][:, None, :] + src[pos], slope)   # (b, S, h)
        some = valid.any(1)
        e = torch.where(valid[..., None], e, float("-inf"))
        e = torch.where(some[:, None, None], e, 0.0)      # a row with no slot: zeros below
        alpha = torch.softmax(e, dim=1) * valid[..., None].to(e.dtype)
        outs.append(torch.einsum("bsh,bshk->bhk", alpha, wx[pos]))
    out = torch.cat(outs, 0)
    out = out.mean(1) if average else out.reshape(n, h * k)
    if f"{prefix}.bias" in params:
        out = out + params[f"{prefix}.bias"]
    return activation(layer.get("activation", "NONE"), out)


def logits(prec: Precision, model: Dict, params: Dict[str, Tensor], data: Dict,
           seeds: Tensor, mask: Tensor, draws, caps: Sequence[int]) -> Tensor:
    """(B, classes) logits of one batch of seeds."""
    n = data["num_nodes"]
    hops = sample_hops(draws, data["graph"], seeds, mask, fanouts(model), caps, n)
    # each hop's targets: the seeds under their mask, then the hop before's array
    targets = [mask] + [hop.next_ids < n for hop in hops[:-1]]
    x = None
    depth = len(hops)
    for prefix, layer in layers(model):
        if layer["type"].upper() == "FEATURE":
            outer = hops[-1].next_ids
            off = int(layer.get("offset", 0))
            x = data["features"][outer.clamp(max=n), off:off + int(layer["output_dim"])]
            if f"{prefix}.bias" in params:
                x = x + params[f"{prefix}.bias"]
        else:
            depth -= 1
            x = gat(prec, layer, x, hops[depth], targets[depth], params, prefix)
    return x


def loss(prec, model, params, data, seeds, mask, draws, caps) -> Tensor:
    """Cross entropy summed over the valid seeds."""
    out = logits(prec, model, params, data, seeds, mask, draws, caps)
    labels = data["labels"][seeds.long().clamp(max=data["num_nodes"])]
    per = -torch.log_softmax(out, dim=-1).gather(1, labels[:, None])[:, 0]
    return (per * mask.to(per.dtype)).sum()


def step(prec: Precision, model: Dict, state: Dict, data: Dict, shares: List[Dict],
         caps: Sequence[int], lr: float, t: int):
    """One training step (the ``t``-th, from 0) from ``state``; the batch is
    a list of shares with ``seeds``, ``mask`` and ``draws``, its loss the sum
    of theirs. Returns (loss, gradients by name, the state after Adam)."""
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
    """Adam steps from ``params0`` over ``batches``; (losses, each state)."""
    state, losses, states = initial_state(params0), [], []
    for t, shares in enumerate(batches):
        value, _, state = step(prec, model, state, data, shares, caps, lr, t)
        losses.append(value)
        states.append(state)
    return losses, states
