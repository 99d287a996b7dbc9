"""GraphSAGE link prediction: what the runner records of the program's first
training steps and first evaluation, and the numbers that decide
``correct``.

Recorded, through the program's seams, in the set-up's warm-up cycle (the
window's own ``train_epoch`` and ``evaluate`` on the same objects):

- the first three batches' edges and masks (the epoch's feed), their
  negatives and the sampler's draws (random numbers both), the sampler's
  seed array, and each loss;
- the state after each of those steps: the parameters, Adam's slots, the
  table and its Adagrad state (``harness/steps.py`` follows them);
- the first evaluation's parameters and table, the draws of each tile of
  its all-node encoding, and the filtered MRR it reported.

The reference (``benchmark/reference/gnn_lp.py``) takes the same feed,
negatives, draws and initial weights, and works everything else out again:
the batch's distinct ids, the sampled hop, the layer, DistMult, the loss,
the gradients, Adam and Adagrad, each step from the program's state before
it, and the filtered ranks from the recorded parameters and table.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import program, steps
from benchmark.harness.compare import relative_gap
from benchmark.harness.tasks.nc_sampled import _by_depth, real_hops
from benchmark.reference import common, gnn_lp

RATE = ("train_edges_per_s", "edges/s", "num_edges")
CHECK_STEPS = 3


def step_name(trainer) -> str:
    """The trainer's batch step (one device: these cells run no LP mesh)."""
    if trainer.mesh is not None:
        raise ValueError("the link-prediction task checks one device")
    return "_batch_step"


def param_shapes(config: Dict, data: Dict) -> Dict:
    model = config["marius_config"]["model"]
    shapes = gnn_lp.param_shapes(model, data["num_relations"])
    shapes["table"] = (data["num_nodes"], int(model["encoder"]["layers"][0][0]["output_dim"]))
    return shapes


class Recorder:
    """Patches the program's seams for the warm-up cycle's first steps and
    first evaluation; ``stop()`` takes every patch out."""

    def __init__(self, rt, seed: int):
        from marius_tpu_torch.train import graph_encoder as ge_module
        from marius_tpu_torch.train import trainer as trainer_module

        tr, ev = rt.trainer, rt.valid_evaluator
        self.steps: List[Dict] = []
        self.tiles: Dict[int, List] = {}
        self.eval_params = self.eval_table = self.eval_mrr = self.eval_pos = None
        self.states: List[Dict] = []
        self._cur = None
        self._train = program.Patches()
        self._eval = program.Patches()
        step, draws, negatives = tr._batch_step, tr._draws, tr._sample_negatives
        sampler = trainer_module.sample_neighbor_batch

        def rec_draws(depth, direction, n, fanout, dropout):
            rand, uni = draws(depth, direction, n, fanout, dropout)
            if self._cur is not None:
                self._cur["draws"].append((depth, direction, rand.cpu()))
            return rand, uni

        def rec_negatives(edges_b, inverse):
            ns = negatives(edges_b, inverse)
            if self._cur is not None:
                self._cur["src_negs" if inverse else "dst_negs"] = ns.ids.cpu()
            return ns

        def rec_sampler(*args, **kwargs):
            nb = sampler(*args, **kwargs)
            if self._cur is not None:
                self._cur["sampler_seeds"] = nb.node_ids[-1].cpu()
            return nb

        def rec_step(edges_b, mask_b):
            if len(self.steps) >= CHECK_STEPS:   # the epoch holds on to this wrapper
                return step(edges_b, mask_b)
            self._cur = {"edges": edges_b.cpu(), "mask": mask_b.cpu(), "draws": []}
            out = step(edges_b, mask_b)
            self._cur["loss"] = float(out)
            self.steps.append(self._cur)
            self._cur = None
            slots, table = tr.state.opt_state.slots, tr.state.table
            self.states.append({"params": program.to_host(tr.state.params),
                                "m": program.to_host(slots["exp_avg"]),
                                "v": program.to_host(slots["exp_avg_sq"]),
                                "table": table.values.detach().float().cpu().clone(),
                                "table_state": table.state.detach().float().cpu().clone()})
            if len(self.steps) == CHECK_STEPS:
                self._train.restore()
            return out

        self._train.set(tr, "_batch_step", rec_step)
        self._train.set(tr, "_draws", rec_draws)
        self._train.set(tr, "_sample_negatives", rec_negatives)
        self._train.set(trainer_module, "sample_neighbor_batch", rec_sampler)

        seeded, evaluate, directions = ge_module.seeded_draws, ev.evaluate, ev._batch_directions
        answered = []

        def rec_seeded(seed, index, device):
            d = seeded(seed, index, device)
            calls = self.tiles.setdefault(index, [])

            def draw(depth, direction, n, fanout, dropout):
                rand, uni = d(depth, direction, n, fanout, dropout)
                calls.append((depth, direction, rand.cpu()))
                return rand, uni
            return draw

        def rec_directions(*args, **kwargs):
            out = directions(*args, **kwargs)
            answered.append([pos for _, pos in out])
            return out

        def rec_evaluate(state, *args, **kwargs):
            self.eval_params = program.to_host(state.params)
            self.eval_table = state.table.values.detach().float().cpu().clone()
            try:
                res = evaluate(state, *args, **kwargs)
            finally:
                self._eval.restore()
            self.eval_mrr = float(res["mrr"])
            # each direction's positive scores of the held-out edges, batch by batch
            self.eval_pos = torch.stack([torch.cat([b[d] for b in answered]).float().cpu()
                                         for d in range(2)])[:, :ev.num_edges]
            return res

        self._eval.set(ge_module, "seeded_draws", rec_seeded)
        self._eval.set(ev, "_batch_directions", rec_directions)
        self._eval.set(ev, "evaluate", rec_evaluate)

    def stop(self) -> None:
        self._train.restore()
        self._eval.restore()

    def complete(self) -> bool:
        return len(self.steps) == CHECK_STEPS and self.eval_mrr is not None


def reference_data(data: Dict, device) -> Dict:
    n, r = data["num_nodes"], data["num_relations"]
    e = data["train_edges"]
    every = np.concatenate([data["train_edges"], data["valid_edges"], data["test_edges"]])
    return {"num_nodes": n, "num_relations": r,
            "graph": (common.csr(e[:, 2], e[:, 0], n, device),
                      common.csr(e[:, 0], e[:, 2], n, device)),
            "filter_keys": gnn_lp.filter_keys(every, n, r, device)}


def _train_caps(config: Dict, num_nodes: int) -> List[int]:
    """Training's hop caps: worst-case for the batch's 2 B + 2 C n ids."""
    mc = config["marius_config"]
    neg = mc["training"]["negative_sampling"]
    ids = 2 * int(mc["training"]["batch_size"]) + \
        2 * int(neg["num_chunks"]) * int(neg["negatives_per_positive"])
    return gnn_lp.worst_caps(ids, mc["model"], num_nodes)


def _train_batches(rec: Recorder, depths: int, device) -> List[Dict]:
    return [{"edges": s["edges"].to(device), "mask": s["mask"].to(device),
             "dst_negs": s["dst_negs"].to(device), "src_negs": s["src_negs"].to(device),
             "draws": [tuple(x.to(device) for x in d) for d in _by_depth(s["draws"], depths)]}
            for s in rec.steps]


def _eval_tiles(rec: Recorder, depths: int, device) -> List:
    return [[tuple(x.to(device) for x in d) for d in _by_depth(rec.tiles[i], depths)]
            for i in sorted(rec.tiles)]


def as_control(rec: Recorder, config: Dict, data: Dict, weights: Dict, device):
    """The control: a copy of ``rec`` whose outputs (losses, the states after
    the steps, the filtered MRR and scores) come from the reference itself
    computed one precision below the configuration's (TF32), on the same
    feed, negatives, draws, weights and evaluation state."""
    mc = config["marius_config"]
    model = mc["model"]
    n = data["num_nodes"]
    ref = reference_data(data, device)
    caps = _train_caps(config, n)
    lr = float(model["dense_optimizer"]["options"]["learning_rate"])
    sparse_lr = float(model["sparse_optimizer"]["options"]["learning_rate"])
    dense0 = {k: w.to(device) for k, w in weights.items() if k != "table"}
    ctl = copy.copy(rec)
    with common.Precision("tf32") as prec:
        losses, states = gnn_lp.train_steps(
            prec, model, dense0, weights["table"].to(device), ref,
            _train_batches(rec, len(caps) - 1, device), caps, lr, sparse_lr)
        ctl.steps = [dict(s, loss=loss) for s, loss in zip(rec.steps, losses)]
        ctl.states = [steps.to_device(st, "cpu") for st in states]
        ranks, pos = gnn_lp.filtered_ranks(
            prec, model, {k: v.to(device) for k, v in rec.eval_params.items()},
            rec.eval_table.to(device), ref, torch.as_tensor(data["valid_edges"], device=device),
            int(mc["evaluation"]["batch_size"]), _eval_tiles(rec, len(caps) - 1, device))
        ctl.eval_mrr, ctl.eval_pos = gnn_lp.mrr(ranks), pos.cpu()
    return ctl


def numbers(rec: Recorder, config: Dict, data: Dict, weights: Dict, prec,
            device) -> Dict[str, float]:
    """The numbers that decide ``correct``: the program's first steps and
    its evaluation against the reference's."""
    mc = config["marius_config"]
    model, training = mc["model"], mc["training"]
    n = data["num_nodes"]
    ref = reference_data(data, device)
    neg = training["negative_sampling"]
    caps = _train_caps(config, n)
    depths = len(caps) - 1
    lr = float(model["dense_optimizer"]["options"]["learning_rate"])
    sparse_lr = float(model["sparse_optimizer"]["options"]["learning_rate"])
    beta1 = float(model["dense_optimizer"]["options"].get("beta_1", 0.9))

    out_of_range = 0
    block = (int(neg["num_chunks"]), int(neg["negatives_per_positive"]))
    for s in rec.steps:
        for k in ("dst_negs", "src_negs"):
            ids = s[k]
            shape_ok = tuple(ids.shape) == block
            out_of_range += int(((ids < 0) | (ids >= n)).sum()) + (0 if shape_ok else ids.numel())
    batches = _train_batches(rec, depths, device)

    mismatched = 0
    for bt, s in zip(batches, rec.steps):
        e, mask = bt["edges"].long(), bt["mask"]
        all_ids = torch.cat([torch.where(mask, e[:, 0], n), torch.where(mask, e[:, 2], n),
                             bt["dst_negs"].reshape(-1).long(), bt["src_negs"].reshape(-1).long()])
        uniq = torch.unique(all_ids)
        seeds = torch.full((caps[0],), n, dtype=torch.long, device=device)
        seeds[:uniq.shape[0]] = uniq
        theirs = s["sampler_seeds"].to(device).long()
        mismatched += (int((seeds != theirs).sum()) if seeds.shape == theirs.shape
                       else max(seeds.numel(), theirs.numel()))

    dense0 = {k: w.to(device) for k, w in weights.items() if k != "table"}

    def step(state, batch, t):
        return gnn_lp.step(prec, model, state, ref, batch, caps, lr, sparse_lr, t)

    checked, rec.details = steps.follow(
        step, gnn_lp.initial_state(dense0, weights["table"].to(device)), rec.states,
        [s["loss"] for s in rec.steps], batches, beta1, device)
    out = {"negatives_out_of_range": float(out_of_range), "seed_mismatch": float(mismatched),
           **checked}

    eval_params = {k: v.to(device) for k, v in rec.eval_params.items()}
    tiles = _eval_tiles(rec, depths, device)
    ranks, pos = gnn_lp.filtered_ranks(prec, model, eval_params, rec.eval_table.to(device), ref,
                                       torch.as_tensor(data["valid_edges"], device=device),
                                       int(mc["evaluation"]["batch_size"]), tiles)
    out["mrr_gap"] = relative_gap(rec.eval_mrr, gnn_lp.mrr(ranks))
    theirs = rec.eval_pos.to(device)
    out["eval_score_gap"] = (float((theirs - pos).abs().max()) / max(float(pos.abs().max()), 1e-30)
                             if theirs.shape == pos.shape else float("inf"))
    return out


def flops(config: Dict, data: Dict, seed: int, device, samples: int = 4) -> Dict[str, float]:
    """Model FLOPs of a training batch and of a whole validation evaluation,
    from the benchmark's own batches, negatives and draws.

    A batch: the GraphSAGE layer over its distinct ids (two (U x d) by
    (d x d) products, one addition per valid slot and column, the mean and
    the sum of the products), then per direction DistMult: the relation
    product, the positive's dot product, each edge against its chunk's
    negatives (2 n d) and the log-sum-exp over them; three times the forward
    for training. The evaluation: the layer over every node, and per held-out
    edge and direction a score against every node."""
    mc = config["marius_config"]
    model, training = mc["model"], mc["training"]
    n, d = data["num_nodes"], int(model["decoder"]["options"]["input_dim"])
    neg = training["negative_sampling"]
    c, k = int(neg["num_chunks"]), int(neg["negatives_per_positive"])
    b = int(training["batch_size"])
    graph = reference_data(data, device)["graph"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    rng = np.random.default_rng([int(seed), 37])
    fan = gnn_lp.fanouts(model)

    def layer(hops):
        rows, slots = hops[0]["rows"], hops[0]["slots"]
        return 4.0 * rows * d * d + slots * d + 2.0 * rows * d

    each = []
    for _ in range(samples):
        e = data["train_edges"][rng.choice(len(data["train_edges"]), size=b, replace=False)]
        ids = np.unique(np.concatenate([e[:, 0], e[:, 2], rng.integers(0, n, 2 * c * k)]))
        seeds = torch.as_tensor(ids, device=device)
        caps = gnn_lp.worst_caps(len(ids), model, n)
        decoder = 2 * (b * d + 2.0 * b * d + 2.0 * b * k * d + 3.0 * b * k)
        each.append(3.0 * (layer(real_hops(graph, seeds, fan, caps, n, gen)) + decoder))
    eb = int(mc["evaluation"]["batch_size"])
    encode = 0.0
    for start in range(0, n, eb):
        seeds = torch.arange(start, min(start + eb, n), device=device)
        encode += layer(real_hops(graph, seeds, fan, gnn_lp.worst_caps(eb, model, n), n, gen))
    scoring = len(data["valid_edges"]) * 2 * (2.0 * n * d + 3.0 * d)
    return {"train_batch": float(np.mean(each)), "evaluation": encode + scoring}
