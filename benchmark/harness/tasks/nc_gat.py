"""Sampled GAT node classification: the numbers that decide ``correct`` and
the model FLOPs of a batch, for a configuration whose GNN stages are GAT
layers (``benchmark/reference/gat_nc.py``).

What is recorded is ``nc_sampled``'s, through the same seams and the same
``Recorder``: the first three training batches' seeds, masks, draws,
frontiers, losses and states after each step, and the first evaluation's
parameters, every batch's draws and logits, and what it reported. The
reference takes the same seeds, draws and initial weights and works the
rest out again, as ``nc_sampled`` describes, with GAT's layers. Three
numbers are taken otherwise than there:

- ``grad_gap`` compares the two first gradients' norms in float64, since a
  float32 norm of a 1024 x 1024 leaf on the CPU is itself off by several
  1e-5;
- ``change_gap`` and ``direction_gap`` compare each step's two updates
  over the elements that float32 rounding does not decide: those where the
  reference's update moves from the same step taken in float64 by at most
  ``ROUNDING`` of the float64 update. Adam moves every element by about lr
  whatever its gradient, so where the gradient is rounding, rounding picks
  the step. That leaves out the odd element whose gradient is zero to
  rounding;
- the output layer's ``a_l`` is left out of those two numbers whole
  (``_cancelled``). A shift of a target's logits that is common to all of
  its slots leaves the softmax alone, so ``a_l`` has a gradient only
  through LeakyReLU's kink: each element is what is left of sums that
  cancel. In the output layer those elements run down to 1e-10, and the
  program, summing in another order, rounds them up to ten times their
  size; Adam's state carries that into updates that differ by up to 0.5% on
  a tenth of the leaf. The float32 reference rounds in its own order, so
  the rounding mask does not see those elements. The leaf's gradient is
  still compared in ``grad_gap``, and its effect in the evaluation.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import steps
from benchmark.harness.compare import leaf_gap
from benchmark.harness.tasks.nc_sampled import (  # noqa: F401  (the runner's seams)
    CHECK_STEPS,
    RATE,
    Recorder,
    _by_depth,
    _train_batches,
    eval_batches,
    real_hops,
    reference_data,
    step_name,
)
from benchmark.reference import common, gat_nc

#: the share of an element's float64 update by which float32 rounding may
#: move the reference's before the element is left out of the update gaps
ROUNDING = 1e-3


def param_shapes(config: Dict, data: Dict) -> Dict:
    return gat_nc.param_shapes(config["marius_config"]["model"])


def _cancelled(model: Dict) -> List[str]:
    """The leaves left out of ``change_gap`` and ``direction_gap``: the
    output layer's ``a_l`` (the module's notes)."""
    prefix = [p for p, layer in gat_nc.layers(model) if layer["type"].upper() == "GNN"][-1]
    return [f"{prefix}.a_l"]


def _setting(config: Dict, data: Dict) -> Dict:
    """What both the check and the control read of the configuration."""
    model = config["marius_config"]["model"]
    batch = int(config["marius_config"]["evaluation"]["batch_size"])
    return {"model": model, "n": data["num_nodes"],
            "caps": [int(c) for c in model["encoder"]["hop_caps"]],
            "lr": float(model["dense_optimizer"]["options"]["learning_rate"]),
            "beta1": float(model["dense_optimizer"]["options"].get("beta_1", 0.9)),
            "batch": batch, "ecaps": gat_nc.eval_caps(batch, model, data["num_nodes"])}


def numbers(rec: Recorder, config: Dict, data: Dict, weights: Dict, prec,
            device) -> Dict[str, float]:
    """The program's first steps and its evaluation against the reference's:
    the same names as ``nc_sampled``'s numbers."""
    s = _setting(config, data)
    model, n, caps = s["model"], s["n"], s["caps"]
    ref = reference_data(data, device)
    batches = _train_batches(rec, len(caps) - 1, device)

    mismatched = 0
    for b, recorded in zip(batches, rec.steps):
        hops = common.sample_hops(b["draws"], ref["graph"], b["seeds"], b["mask"],
                                  gat_nc.fanouts(model), caps, n)
        ours = [h.next_ids.cpu() for h in hops]
        theirs = list(reversed(recorded["frontier"]))[1:]
        for a, t in zip(ours, theirs):
            mismatched += (int((a != t.long()).sum()) if a.shape == t.shape
                           else max(a.numel(), t.numel()))
        mismatched += abs(len(ours) - len(theirs))

    params0 = {k: w.to(device) for k, w in weights.items()}
    wide = dict(ref, features=ref["features"].double())
    first, changes, turns = {}, [], []
    cancelled = _cancelled(model)

    def step(state, batch, t):
        out = gat_nc.step(prec, model, state, ref, [batch], caps, s["lr"], t)
        grads, after = out[1], out[2]["params"]
        if t == 0:
            first.update({k: float(g.double().norm()) for k, g in grads.items()})
        exact = _update_in_float64(prec, model, state, wide, batch, caps, s["lr"], t)
        program_d, reference_d = {}, {}
        moved = steps.moved({k: float(g.norm()) for k, g in grads.items()})
        for k in (k for k in moved if k not in cancelled):
            before = state["params"][k]
            firm = (after[k].double() - before.double() - exact[k]).abs() <= \
                ROUNDING * exact[k].abs()
            program_d[k] = (rec.states[t]["params"][k].to(device) - before)[firm]
            reference_d[k] = (after[k] - before)[firm]
        changes.append(leaf_gap({k: float(d.norm()) for k, d in program_d.items()},
                                {k: float(d.norm()) for k, d in reference_d.items()}))
        turns.append(max(steps.turned(program_d[k], reference_d[k]) for k in program_d))
        return out

    checked, rec.details = steps.follow(step, gat_nc.initial_state(params0), rec.states,
                                        [st["loss"] for st in rec.steps], batches, s["beta1"],
                                        device)
    # grad_gap again with every norm in float64: a float32 norm of a 1024 x
    # 1024 leaf on the CPU is off by about 4.5e-5 (steps.first_gradient_norms)
    program_first = {k: float(m.double().norm()) / (1 - s["beta1"])
                     for k, m in rec.states[0]["m"].items()}
    checked.update(grad_gap=leaf_gap(program_first, first), change_gap=max(changes),
                   direction_gap=max(turns))
    return {"frontier_mismatch": float(mismatched), **checked,
            **_evaluation(rec, s, data, ref, prec, device)}


def _update_in_float64(prec, model: Dict, state: Dict, wide: Dict, batch: Dict, caps,
                       lr: float, t: int) -> Dict[str, torch.Tensor]:
    """The reference's update of every leaf from ``state``, the step taken
    with every number in float64 (``wide``: the reference's data with float64
    features)."""
    start = {part: {k: v.double() for k, v in state[part].items()}
             for part in ("params", "m", "v")}
    after = gat_nc.step(prec, model, start, wide, [batch], caps, lr, t)[2]["params"]
    out = {k: after[k] - start["params"][k] for k in after}
    del after
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _eval_logits(prec, s: Dict, params: Dict, ref: Dict, e: Dict, seeds, mask, device):
    draws = [tuple(x.to(device) for x in d) for d in _by_depth(e["draws"], len(s["ecaps"]) - 1)]
    return gat_nc.logits(prec, s["model"], params, ref, seeds, mask, draws, s["ecaps"])


def _evaluation(rec: Recorder, s: Dict, data: Dict, ref: Dict, prec,
                device) -> Dict[str, float]:
    """Every evaluation batch of the reference against the program's (as
    ``nc_sampled``'s: the worst logit gap, the share of nodes whose
    correctness differs, and the reported count's and accuracy's gaps)."""
    n = s["n"]
    params = {k: v.to(device) for k, v in rec.eval_params.items()}
    num_eval = len(data["valid_nodes"])
    worst = scale = 0.0
    differ = right = batches = 0
    with torch.no_grad():
        for i, (seeds, mask) in enumerate(eval_batches(data, s["batch"], device)):
            batches += 1
            e = rec.eval[i] if i < len(rec.eval) else {}
            if "logits" not in e:
                worst = float("inf")
                continue
            ours = _eval_logits(prec, s, params, ref, e, seeds, mask, device)
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
            "eval_acc_gap": differ / num_eval,
            "eval_count_gap": abs(reported["num_evaluated"] - num_eval),
            "eval_accuracy_gap": abs(reported["accuracy"] - right / num_eval)}


def as_control(rec: Recorder, config: Dict, data: Dict, weights: Dict, device):
    """The control: a copy of ``rec`` whose outputs come from the reference
    itself in TF32, on the same seeds, draws, weights and evaluation
    parameters (``nc_sampled.as_control`` with GAT's layers)."""
    s = _setting(config, data)
    n = s["n"]
    ref = reference_data(data, device)
    params0 = {k: w.to(device) for k, w in weights.items()}
    eval_params = {k: v.to(device) for k, v in rec.eval_params.items()}
    ctl = copy.copy(rec)
    with common.Precision("tf32") as prec:
        losses, states = gat_nc.train_steps(
            prec, s["model"], params0, ref,
            [[b] for b in _train_batches(rec, len(s["caps"]) - 1, device)], s["caps"], s["lr"])
        ctl.steps = [dict(st, loss=value) for st, value in zip(rec.steps, losses)]
        ctl.states = [steps.to_device(st, "cpu") for st in states]
        ctl.eval, right, count = [], 0, 0
        with torch.no_grad():
            for e, (seeds, mask) in zip(rec.eval, eval_batches(data, s["batch"], device)):
                lg = _eval_logits(prec, s, eval_params, ref, e, seeds, mask, device)
                ctl.eval.append(dict(e, logits=lg.cpu()))
                right += int(((lg.argmax(1) == ref["labels"][seeds.clamp(max=n)]) & mask).sum())
                count += int(mask.sum())
        ctl.eval_result = {"num_evaluated": float(count), "accuracy": right / max(count, 1)}
    return ctl


# -- model FLOPs ------------------------------------------------------------------


def gat_flops(model: Dict, hops: List[Dict]) -> float:
    """Forward FLOPs of the encoder over ``hops`` (``nc_sampled.real_hops``:
    each hop's real rows and valid slots, from the seeds outward), the GAT
    equations over the rows each layer needs, whichever form the program
    takes. Per layer of h heads of size k from d_in: the projection of every
    source row, the next hop's (2 d_in h k each), the two logit vectors (2 h
    k per source row for a_r, per target for a_l); per valid slot (the
    neighbours' and each real target's own) the logit addition, the
    LeakyReLU, the softmax's exponential, sum and division (5 h) and the
    weighted sum (2 h k); per target the mean of averaged heads (h k), the
    bias and the activation; the FEATURE stage's bias over the outer rows."""
    total = 0.0
    stages = [s[0] for s in model["encoder"]["layers"]]
    gnn = [s for s in stages if s["type"].upper() == "GNN"]
    for layer, d in zip(gnn, reversed(range(len(hops) - 1))):
        h, k, average = gat_nc.heads(layer)
        din, dout = int(layer["input_dim"]), int(layer["output_dim"])
        tgt, src = hops[d]["rows"], hops[d + 1]["rows"]
        slots = hops[d]["slots"] + tgt
        total += 2.0 * src * din * h * k + 2.0 * h * k * (src + tgt)
        total += slots * (5.0 * h + 2.0 * h * k)
        total += tgt * ((h * k if average else 0) + 2.0 * dout)
    feature = stages[0]
    if feature.get("bias"):
        total += hops[-1]["rows"] * int(feature["output_dim"])
    return total


def flops(config: Dict, data: Dict, seed: int, device, samples: int = 4) -> Dict[str, float]:
    """Model FLOPs of a training batch (three times the forward) and of a
    whole validation evaluation (forward), each averaged over ``samples``
    batches of the benchmark's own seeds and draws."""
    s = _setting(config, data)
    mc = config["marius_config"]
    graph = reference_data(data, device)["graph"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    rng = np.random.default_rng([int(seed), 31])
    fan = gat_nc.fanouts(s["model"])
    out = {}
    for part, nodes, batch, caps, factor in (
            ("train_batch", data["train_nodes"], int(mc["training"]["batch_size"]), s["caps"],
             3.0),
            ("evaluation", data["valid_nodes"], s["batch"], s["ecaps"], 1.0)):
        each = []
        for _ in range(samples):
            seeds = torch.as_tensor(rng.choice(nodes, size=min(batch, len(nodes)), replace=False),
                                    device=device)
            each.append(gat_flops(s["model"], real_hops(graph, seeds, fan, caps, s["n"], gen)))
        per_batch = factor * float(np.mean(each))
        out[part] = per_batch if part == "train_batch" else per_batch * -(-len(nodes) // batch)
    return out
