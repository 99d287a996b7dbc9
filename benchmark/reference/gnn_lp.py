"""Plain PyTorch reference of GraphSAGE link prediction (FB15K-237's DistMult
model with the reference's gs_1_layer encoder: an EMBEDDING table, one
GraphSAGE MEAN layer over sampled neighbours, DistMult scoring of both
corruption directions against shared negatives, softmax cross entropy summed
over the edges, row-wise Adagrad on the table and Adam on the rest).

A training step starts from the batch's edges, its negatives and the
sampler's draws: the batch's distinct node ids (sorted, padded with N to
2 B + 2 C n) seed the sampler, the outer hop's table rows feed the layer,
and the table's rows take Adagrad. Evaluation encodes every node in tiles of
the evaluation batch and ranks each held-out edge's true endpoint against
every node in both directions, the other true endpoints filtered out.
Parameters are named by their place in the configuration:
``encoder.<stage>.<layer>.<w1|w2>`` and ``decoder.<relations|inverse_relations>``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.common import (
    Precision,
    adagrad_rows,
    adam_step,
    sage_mean,
    sample_hops,
)

Tensor = torch.Tensor


def gnn_prefixes(model: Dict) -> List[str]:
    out = []
    for i, stage in enumerate(model["encoder"]["layers"]):
        if len(stage) != 1:
            raise ValueError("the reference takes one layer per stage")
        kind = stage[0]["type"].upper()
        if kind == "GNN":
            opts = stage[0].get("options", {})
            if opts.get("type", "").upper() != "GRAPH_SAGE" or \
                    opts.get("aggregator", "").upper() != "MEAN" or stage[0].get("bias"):
                raise ValueError(f"the reference takes GraphSAGE MEAN without bias, not {opts}")
            out.append(f"encoder.{i}.0")
        elif kind != "EMBEDDING" or i != 0:
            raise ValueError("the reference takes an EMBEDDING stage, then GNN stages")
    return out


def param_shapes(model: Dict, num_relations: int) -> Dict[str, Tuple[int, ...]]:
    """Every dense trained parameter's shape, from the configuration."""
    if model["decoder"]["type"].upper() != "DISTMULT":
        raise ValueError("the reference takes the DISTMULT decoder")
    shapes = {}
    for prefix, stage in zip(gnn_prefixes(model), model["encoder"]["layers"][1:]):
        shapes[f"{prefix}.w1"] = shapes[f"{prefix}.w2"] = (int(stage[0]["input_dim"]),
                                                           int(stage[0]["output_dim"]))
    d = int(model["decoder"]["options"]["input_dim"])
    shapes["decoder.relations"] = shapes["decoder.inverse_relations"] = (num_relations, d)
    return shapes


def fanouts(model: Dict) -> List[int]:
    cfgs = model["encoder"]["train_neighbor_sampling"]
    for c in cfgs:
        if c["type"].upper() != "UNIFORM":
            raise ValueError(f"the reference takes UNIFORM sampling, not {c['type']}")
    return [int(c["options"]["max_neighbors"]) for c in reversed(cfgs)]


def worst_caps(batch: int, model: Dict, num_nodes: int) -> List[int]:
    """Hop caps that drop nothing: each hop at most (1 + 2 F) times the one
    before, at most N + 1 (training's default and evaluation's rule)."""
    caps = [batch]
    for f in fanouts(model):
        caps.append(min(caps[-1] * (1 + 2 * f), num_nodes + 1))
    return caps


def encode(prec: Precision, model: Dict, params: Dict[str, Tensor], table: Tensor,
           data: Dict, seeds: Tensor, mask: Tensor, draws, caps: Sequence[int]) -> Tensor:
    """(len(seeds), d) encoder outputs; ``table`` is (N, d), a padding id
    reads a zero row."""
    n = data["num_nodes"]
    hops = sample_hops(draws, data["graph"], seeds, mask, fanouts(model), caps, n)
    x = torch.cat([table, table.new_zeros(1, table.shape[1])])
    h = x[hops[-1].next_ids.clamp(max=n)]
    for prefix, hop in zip(gnn_prefixes(model), reversed(hops)):
        h = sage_mean(prec, h, hop, params[f"{prefix}.w1"], params[f"{prefix}.w2"], None)
    return h


def _softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def batch_loss(prec: Precision, model: Dict, params: Dict[str, Tensor], table: Tensor,
               data: Dict, batch: Dict, caps: Sequence[int]) -> Tensor:
    """The loss of one batch: ``batch`` holds ``edges`` (B, 3), ``mask``,
    ``dst_negs`` and ``src_negs`` (C, n) and ``draws``."""
    n = data["num_nodes"]
    e, mask = batch["edges"].long(), batch["mask"]
    dneg, sneg = batch["dst_negs"].long(), batch["src_negs"].long()
    b, (c, k) = e.shape[0], dneg.shape
    src = torch.where(mask, e[:, 0], n)
    dst = torch.where(mask, e[:, 2], n)
    rel = e[:, 1]
    all_ids = torch.cat([src, dst, dneg.reshape(-1), sneg.reshape(-1)])
    uniq = torch.unique(all_ids)
    seeds = torch.full((caps[0],), n, dtype=torch.long, device=e.device)
    seeds[:uniq.shape[0]] = uniq
    pos = torch.searchsorted(seeds, all_ids)
    enc = encode(prec, model, params, table, data, seeds, seeds < n, batch["draws"], caps)
    s, o = enc[pos[:b]], enc[pos[b:2 * b]]
    dn = enc[pos[2 * b:2 * b + c * k]].reshape(c, k, -1)
    sn = enc[pos[2 * b + c * k:]].reshape(c, k, -1)
    total = 0.0
    for anchor, other, negs, rel_table in ((s, o, dn, params["decoder.relations"]),
                                           (o, s, sn, params["decoder.inverse_relations"])):
        adj = anchor * rel_table[rel]
        pos_score = (adj * other).sum(dim=-1)
        neg = prec.bmm(adj.reshape(c, b // c, -1), negs.transpose(1, 2)).reshape(b, k)
        per = _softplus(torch.logsumexp(neg, dim=1) - pos_score)
        total = total + (per * mask.to(per.dtype)).sum()
    return total


def initial_state(params0: Dict[str, Tensor], table0: Tensor) -> Dict:
    """The training state before the first step: the weights, Adam's slots
    and the table's Adagrad state at 0."""
    return {"params": dict(params0), "m": {k: torch.zeros_like(v) for k, v in params0.items()},
            "v": {k: torch.zeros_like(v) for k, v in params0.items()},
            "table": table0, "table_state": torch.zeros_like(table0)}


def step(prec: Precision, model: Dict, state: Dict, data: Dict, batch: Dict,
         caps: Sequence[int], lr: float, sparse_lr: float, t: int):
    """One training step (the ``t``-th, from 0) from ``state``: Adam on the
    dense parameters, row-wise Adagrad on the table. Returns (loss,
    gradients by name with the table's as ``table``, the state after)."""
    names = list(state["params"])
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state["params"].items()}
    table = state["table"].detach().clone().requires_grad_(True)
    value = batch_loss(prec, model, params, table, data, batch, caps)
    grads = torch.autograd.grad(value, [params[k] for k in names] + [table])
    m = [state["m"][k].clone() for k in names]
    v = [state["v"][k].clone() for k in names]
    table_state = state["table_state"].clone()
    adam_step([params[k] for k in names], grads[:-1], m, v, t, lr)
    adagrad_rows(table, table_state, grads[-1], sparse_lr)
    return (float(value.detach()), {k: g.detach() for k, g in zip(names + ["table"], grads)},
            {"params": {k: params[k].detach() for k in names}, "m": dict(zip(names, m)),
             "v": dict(zip(names, v)), "table": table.detach(), "table_state": table_state})


def train_steps(prec: Precision, model: Dict, params0: Dict[str, Tensor], table0: Tensor,
                data: Dict, batches: List[Dict], caps: Sequence[int], lr: float,
                sparse_lr: float):
    """Steps from ``params0`` and ``table0``. Returns (losses, the state
    after each step)."""
    state, losses, states = initial_state(params0, table0), [], []
    for t, b in enumerate(batches):
        value, _, state = step(prec, model, state, data, b, caps, lr, sparse_lr, t)
        losses.append(value)
        states.append(state)
    return losses, states


@torch.no_grad()
def filtered_ranks(prec: Precision, model: Dict, params: Dict[str, Tensor], table: Tensor,
                   data: Dict, edges: Tensor, batch: int, tile_draws: List):
    """(ranks, positive scores), each (2, E): every edge of ``edges`` ranked
    against every node, as the destination's corruption (row 0) and the
    source's (row 1), the true endpoints of every known edge filtered out;
    every node encoded in tiles of ``batch`` ids with ``tile_draws[i]`` for
    tile i."""
    n = data["num_nodes"]
    dev = table.device
    caps = worst_caps(batch, model, n)
    ids = torch.full((len(tile_draws) * batch,), n, dtype=torch.long, device=dev)
    ids[:n] = torch.arange(n, device=dev)
    enc = torch.cat([
        encode(prec, model, params, table, data, ids[i * batch:(i + 1) * batch],
               ids[i * batch:(i + 1) * batch] < n, d, caps)
        for i, d in enumerate(tile_draws)])[:n]
    keys_dst, keys_src = data["filter_keys"]
    r = data["num_relations"]
    e = edges.long()
    ranks, scores = [[], []], [[], []]
    for start in range(0, e.shape[0], batch):
        eb = e[start:start + batch]
        for d, (anchor, other, keys, rel_table) in enumerate((
                (eb[:, 0], eb[:, 2], keys_dst, params["decoder.relations"]),
                (eb[:, 2], eb[:, 0], keys_src, params["decoder.inverse_relations"]))):
            adj = enc[anchor] * rel_table[eb[:, 1]]
            block = prec.mm(adj, enc.t())
            pos = (adj * enc[other]).sum(dim=-1)
            ge = (block >= pos[:, None]).sum(dim=1)
            base = (anchor * r + eb[:, 1]) * n
            lo = torch.searchsorted(keys, base)
            hi = torch.searchsorted(keys, base + n)
            width = int((hi - lo).max())
            at = lo[:, None] + torch.arange(width, device=dev)[None, :]
            valid = at < hi[:, None]
            cand = (keys[at.clamp(max=keys.shape[0] - 1)] - base[:, None]).clamp(0, n - 1)
            true_ge = (valid & (block.gather(1, cand) >= pos[:, None])).sum(dim=1)
            ranks[d].append(ge - true_ge + 1)
            scores[d].append(pos)
    return (torch.stack([torch.cat(x) for x in ranks]),
            torch.stack([torch.cat(x) for x in scores]))


def mrr(ranks: Tensor) -> float:
    return float((1.0 / ranks.double()).mean())


def filter_keys(all_edges: np.ndarray, num_nodes: int, num_relations: int, device):
    """Sorted int64 keys (anchor * R + rel) * N + other of every known edge,
    for the destination-corrupting and the source-corrupting direction."""
    e = all_edges.astype(np.int64)
    dst_keys = np.unique((e[:, 0] * num_relations + e[:, 1]) * num_nodes + e[:, 2])
    src_keys = np.unique((e[:, 2] * num_relations + e[:, 1]) * num_nodes + e[:, 0])
    return (torch.as_tensor(dst_keys, device=device), torch.as_tensor(src_keys, device=device))
