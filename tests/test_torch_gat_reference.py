"""The port's sampled GAT node classification against the benchmark's plain
reference (``benchmark/reference/gat_nc.py``), on the CPU at a small size.

Seeded random weights (biases too) on a small arxiv-shaped graph
(``benchmark/data/arxiv_shaped.py``); one batch whose last seeds are
padding, so that some targets have no valid slot. The program's logits,
loss and every parameter's gradient are compared with the reference's on
the same seeds and sampler draws, then one Adam step of the program's own
batch step with the reference's. The models cover concatenated heads (4 x
8) and averaged heads (6 x classes) and both of the port's GAT forms:
aggregate then project where heads x head size > d_in, project then gather
otherwise.

A second test holds the ``gat.layer`` spans and the ``gat.slot_bytes``
counter to the arithmetic of the slot blocks.
"""

import copy

import pytest
import torch

from benchmark.data import arxiv_shaped
from benchmark.harness import program
from benchmark.harness.tasks.nc_sampled import reference_data
from benchmark.reference import common, gat_nc
from marius_tpu_torch.nn.model import nc_batch_loss
from marius_tpu_torch.nn.optimizers import tree_leaves
from marius_tpu_torch.reporting import profiling
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BATCH, REAL = 24, 17          # seeds a batch, and real ones in the padded batch
FANOUT = 4
LR = 0.005


def _gat(din, heads, size, average, activation):
    return [{"type": "GNN", "options": {"type": "GAT", "num_heads": heads,
                                        "average_heads": average, "negative_slope": 0.2},
             "input_dim": din, "output_dim": size if average else heads * size, "bias": True,
             "activation": activation}]


#: feature width and GAT layers of each case; the form each layer takes is
#: aggregate-first where heads x head size > d_in
MODELS = {
    # the cell's model in small: aggregate-first, then project-first twice
    "concat_concat_average": (16, [_gat(16, 4, 8, False, "RELU"), _gat(32, 4, 8, False, "RELU"),
                                   _gat(32, 6, 4, True, "NONE")]),
    "aggregate_first": (8, [_gat(8, 4, 8, False, "RELU"), _gat(32, 6, 8, True, "NONE")]),
    "project_first": (64, [_gat(64, 4, 8, False, "RELU"), _gat(32, 6, 4, True, "NONE")]),
}
CASES = [("concat_concat_average", True), ("aggregate_first", True), ("project_first", True),
         ("concat_concat_average", False)]


def _runtime(tmp_path, name):
    feature_dim, gat_layers = MODELS[name]
    classes = gat_layers[-1][0]["output_dim"]
    spec = {"num_nodes": 400, "num_edges": 2400, "max_in_degree": 40, "feature_dim": feature_dim,
            "num_classes": classes, "num_train": 200, "num_valid": 60, "num_test": 140}
    data = arxiv_shaped.generate(spec, 23)
    hops = len(gat_layers)
    caps = [BATCH]
    for _ in range(hops - 1):
        caps.append(min(caps[-1] * 3, spec["num_nodes"]))
    caps.append(spec["num_nodes"] + 1)
    model = {"learning_task": "NODE_CLASSIFICATION",
             "encoder": {"hop_caps": caps,
                         "train_neighbor_sampling": [
                             {"type": "UNIFORM", "options": {"max_neighbors": FANOUT}}] * hops,
                         "layers": [[{"type": "FEATURE", "output_dim": feature_dim,
                                      "bias": True}]] + gat_layers},
             "decoder": {"type": "NODE"},
             "loss": {"type": "CROSS_ENTROPY", "options": {"reduction": "SUM"}},
             "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": LR}}}
    raw = {"model": model,
           "storage": {"device_type": "cpu", "dataset": {"dataset_dir": str(tmp_path / "data")}},
           "training": {"batch_size": BATCH, "num_epochs": 1, "seed": 5},
           "evaluation": {"batch_size": BATCH}}
    program.write_dataset(str(tmp_path / "data"), data)
    rt = program.init_runtime(copy.deepcopy(raw), str(tmp_path / "model"), torch.device("cpu"))
    # every leaf Glorot-uniform, biases too, so that a zero row shows its bias
    weights = program.make_weights(gat_nc.param_shapes(model), {}, 31, torch.device("cpu"))
    program.install_weights(rt.trainer.state, weights)
    return rt, data, model, caps, weights


def _batch(data, padded):
    n = data["num_nodes"]
    seeds = torch.full((BATCH,), n, dtype=torch.long)
    real = REAL if padded else BATCH
    seeds[:real] = torch.as_tensor(data["train_nodes"][:real]).long()
    return seeds, torch.arange(BATCH) < real


def _recorded_draws(tr):
    """The trainer's draws, each kept by depth and direction, and a replay of them."""
    kept = {}
    live = tr._draws

    def record(depth, direction, n, fanout, dropout):
        rand, uni = live(depth, direction, n, fanout, dropout)
        kept[(depth, direction)] = rand
        return rand, uni

    def replay(depth, direction, n, fanout, dropout):
        return kept[(depth, direction)], None

    return record, replay, kept


def _forms(model, caps):
    """Each GAT layer's (targets, slots, width of the gathered rows)."""
    out = []
    layers = [s[0] for s in model["encoder"]["layers"][1:]]
    for i, layer in enumerate(layers):
        h, k, _ = gat_nc.heads(layer)
        din = int(layer["input_dim"])
        out.append((caps[len(layers) - 1 - i], 2 * FANOUT + 1,
                    din + h if h * k > din else h * k))
    return out


@pytest.mark.parametrize("name,padded", CASES)
def test_the_port_agrees_with_the_reference(tmp_path, name, padded):
    rt, data, model, caps, weights = _runtime(tmp_path, name)
    tr = rt.trainer
    seeds, mask = _batch(data, padded)
    record, replay, kept = _recorded_draws(tr)

    params = tr.state.params
    nb, feats, _ = tr._encode_batch(None, record, seeds, mask, tr.hop_caps)
    lg = tr._sampled_logits(params, nb, feats, None, True)
    labels = tr.labels[seeds.clamp(max=tr.num_nodes)]
    loss = nc_batch_loss(tr.model, lg, labels, mask & nb.seed_mask)
    names = program.leaf_names(params)
    grads = dict(zip(names, torch.autograd.grad(loss, tree_leaves(params))))
    # the padded seeds are targets with no valid slot
    empty = [~(a.in_mask.any(1) | a.out_mask.any(1) | a.node_mask) for a in nb.layers]
    assert int(empty[-1].sum()) == (BATCH - REAL if padded else 0)

    ref = reference_data(data, torch.device("cpu"))
    draws = [(kept[(d, 0)], kept[(d, 1)]) for d in range(len(caps) - 1)]
    with common.Precision("f32") as prec:
        ref_lg = gat_nc.logits(prec, model, weights, ref, seeds, mask, draws, caps)
        ref_loss, ref_grads, after = gat_nc.step(
            prec, model, gat_nc.initial_state(weights), ref,
            [{"seeds": seeds, "mask": mask, "draws": draws}], caps, LR, 0)

    torch.testing.assert_close(lg.detach(), ref_lg, rtol=1e-5, atol=1e-5)
    last_bias = weights[f"encoder.{len(model['encoder']['layers']) - 1}.0.bias"]
    if padded:
        # a seed with no valid slot gives zeros before the bias
        torch.testing.assert_close(lg.detach()[~mask], last_bias.expand(BATCH - REAL, -1))
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    assert set(grads) == set(ref_grads)
    for k, g in grads.items():
        scale = float(ref_grads[k].abs().max())
        assert scale > 0, k
        torch.testing.assert_close(g, ref_grads[k], rtol=1e-4, atol=1e-5 * scale, msg=k)

    # one Adam step of the program's own batch step on the same draws
    tr._batch_draws = lambda data_index=0: replay
    tr._sampled_batch_step(seeds, mask)
    slots = tr.state.opt_state.slots
    for k in names:
        g = ref_grads[k]
        torch.testing.assert_close(program.leaf(slots["exp_avg"], k), after["m"][k],
                                   rtol=1e-4, atol=1e-6 * float(g.abs().max()), msg=k)
        torch.testing.assert_close(program.leaf(slots["exp_avg_sq"], k), after["v"][k],
                                   rtol=2e-4, atol=1e-9 * float(g.abs().max()) ** 2, msg=k)
        # Adam's first step is lr * sign(g) but where g is zero to rounding
        firm = g.abs() > 1e-4 * float(g.abs().max())
        moved = program.leaf(tr.state.params, k).detach() - weights[k]
        ref_moved = after["params"][k] - weights[k]
        torch.testing.assert_close(moved[firm], ref_moved[firm], rtol=1e-4, atol=1e-7, msg=k)
        assert float((moved - ref_moved).abs().max()) <= 2 * LR + 1e-6, k


def test_gat_spans_and_slot_bytes(tmp_path):
    rt, data, model, caps, _ = _runtime(tmp_path, "concat_concat_average")
    tr, ev = rt.trainer, rt.valid_evaluator
    forms = _forms(model, caps)
    per_batch = sum(n * s * w * 4 for n, s, w in forms)

    with profiling.recording(sync_debug=False) as log:
        tr.train_epoch()
        trained = dict(log.counts)
        ev.evaluate(tr.state)
    names = [s.name for s in log.spans]
    batches = [i for i, s in enumerate(log.spans) if s.name == "train.batch"]
    assert len(batches) == tr.num_batches == trained["train.batches"]
    for b in batches:
        inside = [s for s in log.spans if s.name == "gat.layer" and s.parent >= 0
                  and _under(log, s, b)]
        # one span a layer, outermost first, each counting its own blocks
        assert [(s.counts or {}).get("gat.slot_bytes", 0) for s in inside] == \
            [n * s * w * 4 for n, s, w in forms]
    assert trained["gat.slot_bytes"] == tr.num_batches * per_batch
    # the evaluation opens its layers' spans and counts no slot bytes
    assert names.count("gat.layer") == len(forms) * (tr.num_batches + ev.num_batches)
    assert log.counts["gat.slot_bytes"] == trained["gat.slot_bytes"]

    # off, nothing is recorded or counted
    tr.train_epoch()
    assert profiling._last is log and log.counts["gat.slot_bytes"] == trained["gat.slot_bytes"]
    assert profiling.span("gat.layer") is profiling._OFF


def _under(log, span, index):
    i = span.parent
    while i >= 0 and i != index:
        i = log.spans[i].parent
    return i == index
