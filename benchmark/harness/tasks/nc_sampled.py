"""Sampled GraphSAGE node classification: what the runner records of the
program's first training steps and first evaluation, the numbers that
decide ``correct``, and the model FLOPs of a batch.

Recorded, through the program's seams, in the set-up's warm-up cycle (the
window's own ``train_epoch`` and ``evaluate`` on the same objects):

- the first three training batches' seeds and masks (the epoch's feed), the
  sampler's random draws, the frontier arrays it built and each loss;
- the state after each of those steps: the parameters and Adam's slots
  (``harness/steps.py`` follows them);
- the first evaluation's parameters, every batch's draws and logits, and
  the number of nodes evaluated and the accuracy that it reported.

The reference (``benchmark/reference/sage_nc.py``) takes the same seeds,
draws and initial weights, and works everything else out again: the graph's
CSR, the frontiers under the hop caps, the layers, the loss, the gradients
and Adam, each step from the program's state before it, and every
evaluation batch from the validation nodes in order (the last one padded
and masked by its own count), its logits from the recorded parameters, and
the accuracy over all of them.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import program, steps
from benchmark.reference import common, sage_nc

Tensor = torch.Tensor

RATE = ("train_nodes_per_s", "nodes/s", "num_nodes")
CHECK_STEPS = 3


def param_shapes(config: Dict, data: Dict) -> Dict:
    return sage_nc.param_shapes(config["marius_config"]["model"])


def _by_depth(calls, depths: int) -> List:
    """[(incoming, outgoing) draws] per hop from a list of recorded
    (depth, direction, draws) calls."""
    out = [[None, None] for _ in range(depths)]
    for depth, direction, rand in calls:
        out[depth][direction] = rand
    return [tuple(x) for x in out]


class Recorder:
    """Patches the program's seams for the warm-up cycle's first steps and
    first evaluation; ``stop()`` takes every patch out."""

    def __init__(self, rt, seed: int):
        from marius_tpu_torch.train import nc as nc_module

        tr, ev = rt.trainer, rt.valid_evaluator
        self.steps: List[Dict] = []
        self.eval: List[Dict] = []
        self.eval_params = self.eval_result = None
        self.states: List[Dict] = []
        self._cur = None
        self._train = program.Patches()
        self._eval = program.Patches()
        name = step_name(tr)
        step, draws, sampler = getattr(tr, name), tr._draws, nc_module.sample_neighbor_batch

        def rec_draws(depth, direction, n, fanout, dropout):
            rand, uni = draws(depth, direction, n, fanout, dropout)
            if self._cur is not None:
                self._cur["draws"].append((depth, direction, rand.cpu()))
            return rand, uni

        def rec_sampler(*args, **kwargs):
            nb = sampler(*args, **kwargs)
            if self._cur is not None:
                self._cur["frontier"] = [ids.cpu() for ids in nb.node_ids]
            return nb

        def rec_step(seeds, mask_b):
            if len(self.steps) >= CHECK_STEPS:   # the epoch holds on to this wrapper
                return step(seeds, mask_b)
            self._cur = {"seeds": seeds.cpu(), "mask": mask_b.cpu(), "draws": []}
            out = step(seeds, mask_b)
            self._cur["loss"] = float(out[0])
            self.steps.append(self._cur)
            self._cur = None
            slots = tr.state.opt_state.slots
            self.states.append({"params": program.to_host(tr.state.params),
                                "m": program.to_host(slots["exp_avg"]),
                                "v": program.to_host(slots["exp_avg_sq"])})
            if len(self.steps) == CHECK_STEPS:
                self._train.restore()
            return out

        self._train.set(tr, name, rec_step)
        self._train.set(tr, "_draws", rec_draws)
        self._train.set(nc_module, "sample_neighbor_batch", rec_sampler)

        batch_draws, logits, evaluate = ev._batch_draws, ev._logits, ev.evaluate

        def rec_batch_draws(i):
            d = batch_draws(i)
            calls = []
            self.eval.append({"draws": calls})

            def draw(depth, direction, n, fanout, dropout):
                rand, uni = d(depth, direction, n, fanout, dropout)
                calls.append((depth, direction, rand.cpu()))
                return rand, uni
            return draw

        def rec_logits(state):
            for i, (lg, seeds, mask) in enumerate(logits(state)):
                self.eval[i]["logits"] = lg.detach().float().cpu().clone()
                yield lg, seeds, mask

        def rec_evaluate(state):
            self.eval_params = program.to_host(state.params)
            try:
                self.eval_result = {k: float(v) for k, v in evaluate(state).items()}
                return self.eval_result
            finally:
                self._eval.restore()

        self._eval.set(ev, "_batch_draws", rec_batch_draws)
        self._eval.set(ev, "_logits", rec_logits)
        self._eval.set(ev, "evaluate", rec_evaluate)

    def stop(self) -> None:
        self._train.restore()
        self._eval.restore()

    def complete(self) -> bool:
        return len(self.steps) == CHECK_STEPS and self.eval_result is not None


def step_name(trainer) -> str:
    """The trainer's batch step (one device: these cells run no NC mesh)."""
    if trainer.mesh is not None:
        raise ValueError("the node-classification task checks one device")
    return "_sampled_batch_step"


def eval_batches(data: Dict, batch: int, device):
    """The reference's own evaluation batches: the validation nodes in
    order, ``batch`` at a time, the last padded with N and masked by its
    count. Yields (seeds, mask)."""
    n = data["num_nodes"]
    valid = torch.as_tensor(data["valid_nodes"], device=device).long()
    for start in range(0, valid.shape[0], batch):
        part = valid[start:start + batch]
        seeds = torch.full((batch,), n, dtype=torch.long, device=device)
        seeds[:part.shape[0]] = part
        yield seeds, torch.arange(batch, device=device) < part.shape[0]


def reference_data(data: Dict, device) -> Dict:
    """The reference's own view of the dataset: both CSRs, the features and
    labels with a padding row N (zeros, label 0)."""
    n = data["num_nodes"]
    e = data["edges"]
    feats = np.zeros((n + 1, data["features"].shape[1]), np.float32)
    feats[:n] = data["features"]
    labels = np.zeros(n + 1, np.int64)
    labels[:n] = data["labels"]
    return {"num_nodes": n,
            "graph": (common.csr(e[:, 1], e[:, 0], n, device),
                      common.csr(e[:, 0], e[:, 1], n, device)),
            "features": torch.as_tensor(feats, device=device),
            "labels": torch.as_tensor(labels, device=device)}


def numbers(rec: Recorder, config: Dict, data: Dict, weights: Dict, prec,
            device) -> Dict[str, float]:
    """The numbers that decide ``correct``: the program's first steps and
    its evaluation against the reference's."""
    model = config["marius_config"]["model"]
    n = data["num_nodes"]
    ref = reference_data(data, device)
    caps = [int(c) for c in model["encoder"]["hop_caps"]]
    lr = float(model["dense_optimizer"]["options"]["learning_rate"])
    beta1 = float(model["dense_optimizer"]["options"].get("beta_1", 0.9))
    batches = _train_batches(rec, len(caps) - 1, device)

    mismatched = 0
    for b, recorded in zip(batches, rec.steps):
        hops = common.sample_hops(b["draws"], ref["graph"], b["seeds"], b["mask"],
                                  sage_nc.fanouts(model), caps, n)
        ours = [h.next_ids.cpu() for h in hops]
        theirs = list(reversed(recorded["frontier"]))[1:]
        for a, t in zip(ours, theirs):
            mismatched += (int((a != t.long()).sum()) if a.shape == t.shape
                           else max(a.numel(), t.numel()))
        mismatched += abs(len(ours) - len(theirs))

    params0 = {k: w.to(device) for k, w in weights.items()}

    def step(state, batch, t):
        return sage_nc.step(prec, model, state, ref, [batch], caps, lr, t)

    checked, rec.details = steps.follow(step, sage_nc.initial_state(params0), rec.states,
                                        [s["loss"] for s in rec.steps], batches, beta1, device)
    return {"frontier_mismatch": float(mismatched), **checked,
            **_evaluation(rec, config, data, ref, prec, device)}


def _evaluation(rec: Recorder, config: Dict, data: Dict, ref: Dict, prec,
                device) -> Dict[str, float]:
    """Every evaluation batch of the reference against the program's: the
    worst logit gap, the share of nodes whose correctness differs, and the
    gaps of the reported node count and accuracy to the reference's."""
    model = config["marius_config"]["model"]
    n = data["num_nodes"]
    batch = int(config["marius_config"]["evaluation"]["batch_size"])
    ecaps = sage_nc.eval_caps(batch, model, n)
    params = {k: v.to(device) for k, v in rec.eval_params.items()}
    num_eval = len(data["valid_nodes"])
    worst = scale = 0.0
    differ = right = batches = 0
    with torch.no_grad():
        for i, (seeds, mask) in enumerate(eval_batches(data, batch, device)):
            batches += 1
            e = rec.eval[i] if i < len(rec.eval) else {}
            if "logits" not in e:
                worst = float("inf")
                continue
            draws = [tuple(x.to(device) for x in d) for d in _by_depth(e["draws"], len(ecaps) - 1)]
            ours = sage_nc.logits(prec, model, params, ref, seeds, mask, draws, ecaps)
            theirs = e["logits"].to(device)
            if theirs.shape != ours.shape:
                worst = float("inf")
                continue
            worst = max(worst, float((ours - theirs)[mask].abs().max()))
            scale = max(scale, float(ours[mask].abs().max()))
            labels = ref["labels"][seeds.clamp(max=n)]
            ours_right = (ours.argmax(1) == labels) & mask
            differ += int((ours_right != ((theirs.argmax(1) == labels) & mask)).sum())
            right += int(ours_right.sum())
    if len(rec.eval) != batches:
        worst = float("inf")
    reported = rec.eval_result
    return {"eval_logit_gap": worst / max(scale, 1e-30),
            # the share of nodes whose correctness differs: a bound on the
            # gap between the two accuracies that no cancellation hides
            "eval_acc_gap": differ / num_eval,
            "eval_count_gap": abs(reported["num_evaluated"] - num_eval),
            "eval_accuracy_gap": abs(reported["accuracy"] - right / num_eval)}


def _train_batches(rec: Recorder, depths: int, device) -> List[Dict]:
    """Each recorded step's seeds, mask and draws on ``device``."""
    return [{"seeds": s["seeds"].to(device), "mask": s["mask"].to(device),
             "draws": [tuple(x.to(device) for x in d) for d in _by_depth(s["draws"], depths)]}
            for s in rec.steps]


def as_control(rec: Recorder, config: Dict, data: Dict, weights: Dict, device):
    """The control: a copy of ``rec`` whose outputs (losses, the states after
    the steps, every evaluation batch's logits, the count and accuracy it
    reports) come from the reference itself computed one precision below the
    configuration's (TF32), on the same seeds, draws, weights and evaluation
    parameters."""
    model = config["marius_config"]["model"]
    n = data["num_nodes"]
    ref = reference_data(data, device)
    caps = [int(c) for c in model["encoder"]["hop_caps"]]
    lr = float(model["dense_optimizer"]["options"]["learning_rate"])
    params0 = {k: w.to(device) for k, w in weights.items()}
    batch = int(config["marius_config"]["evaluation"]["batch_size"])
    ecaps = sage_nc.eval_caps(batch, model, n)
    eval_params = {k: v.to(device) for k, v in rec.eval_params.items()}
    ctl = copy.copy(rec)
    with common.Precision("tf32") as prec:
        losses, states = sage_nc.train_steps(
            prec, model, params0, ref,
            [[b] for b in _train_batches(rec, len(caps) - 1, device)], caps, lr)
        ctl.steps = [dict(s, loss=loss) for s, loss in zip(rec.steps, losses)]
        ctl.states = [steps.to_device(st, "cpu") for st in states]
        ctl.eval, right, count = [], 0, 0
        with torch.no_grad():
            for e, (seeds, mask) in zip(rec.eval, eval_batches(data, batch, device)):
                draws = [tuple(x.to(device) for x in d)
                         for d in _by_depth(e["draws"], len(ecaps) - 1)]
                lg = sage_nc.logits(prec, model, eval_params, ref, seeds, mask, draws, ecaps)
                ctl.eval.append(dict(e, logits=lg.cpu()))
                right += int(((lg.argmax(1) == ref["labels"][seeds.clamp(max=n)]) & mask).sum())
                count += int(mask.sum())
        ctl.eval_result = {"num_evaluated": float(count), "accuracy": right / max(count, 1)}
    return ctl


def real_hops(graph, seeds: Tensor, fanouts: List[int], caps: List[int], num_nodes: int,
              gen: torch.Generator) -> List[Dict]:
    """Per hop from the seeds outward: the rows a layer really computes there
    (the hop's distinct valid nodes) and its valid neighbour slots, sampled
    by the benchmark's own draws. Where a cap saturates (N + 1), the next
    hop is every node reached, not every node of the graph."""
    (in_off, in_cols), (out_off, out_cols) = graph
    cur = seeds.long()
    mask = torch.ones_like(cur, dtype=torch.bool)
    out = []
    for depth, f in enumerate(fanouts):
        n = cur.shape[0]
        nbrs = [common.sample_direction(
            torch.randint(0, 2 ** 31 - 1, (n, f), generator=gen, device=cur.device),
            off, cols, cur, mask, f) for off, cols in ((in_off, in_cols), (out_off, out_cols))]
        out.append({"rows": int(mask.sum()), "slots": int(sum(m.sum() for _, m in nbrs))})
        cap = int(caps[depth + 1])
        if cap == num_nodes + 1:
            reached = torch.cat([cur[mask]] + [ids[m] for ids, m in nbrs])
            cur = torch.unique(reached)
        else:
            cur = common.next_hop(cur, mask, nbrs, cap, num_nodes).next_ids
        mask = cur < num_nodes
    out.append({"rows": int(mask.sum()), "slots": 0})
    return out


def sage_flops(model: Dict, hops: List[Dict]) -> float:
    """Forward FLOPs of the encoder over ``hops``: per GraphSAGE layer two
    (rows x d_in) by (d_in x d_out) products, one addition per slot and
    column, the mean's division, the sum of the two products and the bias;
    the FEATURE stage's bias over the outer rows."""
    total = 0.0
    stages = [s[0] for s in model["encoder"]["layers"]]
    gnn = [s for s in stages if s["type"].upper() == "GNN"]
    for layer, hop in zip(gnn, reversed(hops[:-1])):
        n, s = hop["rows"], hop["slots"]
        din, dout = int(layer["input_dim"]), int(layer["output_dim"])
        total += 4.0 * n * din * dout + s * din + n * din + 2.0 * n * dout
    feature = stages[0]
    if feature.get("bias"):
        total += hops[-1]["rows"] * int(feature["output_dim"])
    return total


def flops(config: Dict, data: Dict, seed: int, device, samples: int = 4) -> Dict[str, float]:
    """Model FLOPs of a training batch (forward and backward, three times
    the forward) and of a whole validation evaluation (forward), each
    averaged over ``samples`` batches of the benchmark's own seeds and draws."""
    model = config["marius_config"]["model"]
    mc = config["marius_config"]
    n = data["num_nodes"]
    graph = reference_data(data, device)["graph"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    rng = np.random.default_rng([int(seed), 31])
    fan = sage_nc.fanouts(model)
    out = {}
    for part, nodes, batch, caps, factor in (
            ("train_batch", data["train_nodes"], int(mc["training"]["batch_size"]),
             [int(c) for c in model["encoder"]["hop_caps"]], 3.0),
            ("evaluation", data["valid_nodes"], int(mc["evaluation"]["batch_size"]),
             sage_nc.eval_caps(int(mc["evaluation"]["batch_size"]), model, n), 1.0)):
        each = []
        for _ in range(samples):
            seeds = torch.as_tensor(rng.choice(nodes, size=min(batch, len(nodes)), replace=False),
                                    device=device)
            each.append(sage_flops(model, real_hops(graph, seeds, fan, caps, n, gen)))
        per_batch = factor * float(np.mean(each))
        out[part] = per_batch if part == "train_batch" else per_batch * -(-len(nodes) // batch)
    return out
