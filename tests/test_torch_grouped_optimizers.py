"""Per-layer optimizers (``GroupedOptimizerConfig``) in the port against the
JAX package's, on the CPU (mirrors tests/test_optimizers.py:113-250).

The same numpy parameters and gradients go through both packages'
``init_optimizer`` / ``apply_optimizer``: overrides identical to the default
reproduce the plain optimizer exactly, each group steps with its own
optimizer, a YAML's per-layer ``optimizer:`` block builds the same overrides
in both config loaders and the same trajectory, zero-gradient steps (the
buffer trainers' padded batches) move only the groups whose optimizer is not
a no-op, and a checkpoint the JAX package writes of a grouped state loads
into the port leaf by leaf. Tolerance rtol 1e-5 / atol 1e-7, tests/test_optimizers.py's
(float32; the port rounds the Adam step scalars from Python floats).
"""

import copy

import jax
import numpy as np
import pytest
import torch

import marius_tpu.nn.optimizers as jopt
import marius_tpu_torch.nn.optimizers as topt
from marius_tpu.storage import checkpoint as jckpt
from marius_tpu_torch.storage import checkpoint as tckpt
from marius_tpu_torch.train.trainer import TrainState
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-7


def _nested_params():
    rng = np.random.default_rng(0)
    return {
        "encoder": [
            [{"w": rng.standard_normal((3, 4)).astype(np.float32)}],
            [{"w": rng.standard_normal((4, 2)).astype(np.float32),
              "bias": rng.standard_normal((2,)).astype(np.float32)}],
        ],
        "decoder": {"relations": rng.standard_normal((2, 4)).astype(np.float32)},
    }


def _grads(step, scale=0.1):
    rng = np.random.default_rng(10 + step)
    return jax.tree_util.tree_map(
        lambda p: (scale * (step + 1) * rng.standard_normal(p.shape)).astype(np.float32),
        _nested_params())


def _torch_tree(tree):
    return topt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _configs(default, overrides):
    """The same grouped config in both packages, from (kwargs, [(prefix, kwargs)])."""
    return (jopt.GroupedOptimizerConfig(jopt.OptimizerConfig(**default),
                                        tuple((p, jopt.OptimizerConfig(**o))
                                              for p, o in overrides)),
            topt.GroupedOptimizerConfig(topt.OptimizerConfig(**default),
                                        tuple((p, topt.OptimizerConfig(**o))
                                              for p, o in overrides)))


def _run(j_cfg, t_cfg, steps=4):
    """Both trajectories from _nested_params over ``steps`` gradients."""
    jp, tp = _nested_params(), _torch_tree(_nested_params())
    js, ts = jopt.init_optimizer(j_cfg, jp), topt.init_optimizer(t_cfg, tp)
    for step in range(steps):
        g = _grads(step)
        jp, js = jopt.apply_optimizer(j_cfg, jp, js, g)
        tp, ts = topt.apply_optimizer(t_cfg, tp, ts, _torch_tree(g))
    return (jp, js), (tp, ts)


def _same_trees(t_tree, j_tree):
    pairs = []
    topt.tree_map(lambda t, j: pairs.append((t, j)), t_tree, j_tree)
    assert len(pairs) == len(jax.tree_util.tree_leaves(j_tree)) > 0
    for t, j in pairs:
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_grouped_uniform_matches_plain():
    """Overrides identical to the default: the grouped trajectory equals the
    plain one in the port, and the JAX package's grouped one."""
    base = dict(optimizer_type="ADAGRAD", learning_rate=0.05, lr_decay=0.01)
    j_cfg, t_cfg = _configs(base, [(("encoder", 1, 0), base)])
    (jp, js), (tp, ts) = _run(j_cfg, t_cfg)
    _same_trees(tp, jp)
    _same_trees(ts.slots, js.slots)
    assert ts.step == int(js.step) == 4
    # the port's plain optimizer over the same gradients
    plain = topt.OptimizerConfig(**base)
    pp = _torch_tree(_nested_params())
    ps = topt.init_optimizer(plain, pp)
    for step in range(4):
        pp, ps = topt.apply_optimizer(plain, pp, ps, _torch_tree(_grads(step)))
    for a, b in zip(topt.tree_leaves(pp), topt.tree_leaves(tp)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the grouped slot tree is shaped like the params, a slot dict per leaf
    assert set(ts.slots["encoder"][1][0]["bias"]) == {"sum"}


@pytest.mark.parametrize("amsgrad", [False, True])
def test_grouped_override_applies_per_group(amsgrad):
    """Adam by default, SGD with momentum on one layer and the decoder,
    Adagrad with weight decay on the other layer's bias path prefix: every
    leaf and slot equals JAX's, and the override moved its layer away from
    the default's trajectory."""
    default = dict(optimizer_type="ADAM", learning_rate=0.01, amsgrad=amsgrad)
    sgd = dict(optimizer_type="SGD", learning_rate=0.5, momentum=0.9)
    adagrad = dict(optimizer_type="ADAGRAD", learning_rate=0.1, weight_decay=0.01)
    j_cfg, t_cfg = _configs(default, [(("encoder", 0, 0), sgd), (("decoder",), sgd),
                                      (("encoder", 1, 0, "bias"), adagrad)])
    (jp, js), (tp, ts) = _run(j_cfg, t_cfg)
    _same_trees(tp, jp)
    _same_trees(ts.slots, js.slots)
    assert set(ts.slots["encoder"][0][0]["w"]) == {"momentum"}
    assert set(ts.slots["encoder"][1][0]["bias"]) == {"sum"}
    assert set(ts.slots["encoder"][1][0]["w"]) >= {"exp_avg", "exp_avg_sq"}
    jd, td = _configs(default, [])
    (jp_d, _), _ = _run(jd.default, td.default)
    assert not np.allclose(tp["encoder"][0][0]["w"].numpy(),
                           np.asarray(jp_d["encoder"][0][0]["w"]))


def test_grouped_zero_grad_steps_leaf_by_leaf():
    """The padded batches' zero-gradient steps: a grouped config of no-op
    optimizers only counts; one with an Adam group moves that group's leaves
    as JAX's zero-gradient steps do, and leaves the Adagrad group alone."""
    noop = dict(optimizer_type="ADAGRAD", learning_rate=0.1)
    _, t_noop = _configs(noop, [(("decoder",), dict(optimizer_type="SGD"))])
    assert topt.is_noop_at_zero_grad(t_noop)
    adam = dict(optimizer_type="ADAM", learning_rate=0.01)
    j_cfg, t_cfg = _configs(noop, [(("encoder", 1), adam)])
    assert not topt.is_noop_at_zero_grad(t_cfg)
    (jp, js), (tp, ts) = _run(j_cfg, t_cfg, steps=2)
    zeros = jax.tree_util.tree_map(np.zeros_like, _nested_params())
    for _ in range(3):
        jp, js = jopt.apply_optimizer(j_cfg, jp, js, zeros)
    before = topt.tree_map(torch.clone, tp)
    ts = topt.apply_zero_grad_steps(t_cfg, tp, ts, 3)
    assert ts.step == int(js.step) == 5
    _same_trees(tp, jp)
    _same_trees(ts.slots, js.slots)
    torch.testing.assert_close(tp["encoder"][0][0]["w"], before["encoder"][0][0]["w"],
                               rtol=0, atol=0)
    assert not torch.equal(tp["encoder"][1][0]["w"], before["encoder"][1][0]["w"])


def test_grouped_from_config_builds_the_same_trajectory():
    """A layer-level and a decoder-level ``optimizer:`` block build the same
    overrides in the port's config loader as in the JAX package's, and the
    built configs step the same trajectory."""
    from marius_tpu.config.schema import load_config as j_load_config
    from marius_tpu_torch.config import load_config as t_load_config
    from tests.test_manager import LP_BASE

    raw = copy.deepcopy(LP_BASE)
    raw["model"]["encoder"] = {"layers": [[{"type": "EMBEDDING", "output_dim": 4,
                                            "optimizer": {"type": "SGD", "options": {
                                                "learning_rate": 1e-4}}}]]}
    # Adam at lr 0.01 (LP_BASE's 0.1 steps past the tolerance on float32 noise)
    raw["model"]["dense_optimizer"]["options"]["learning_rate"] = 0.01
    raw["model"]["decoder"]["optimizer"] = {"type": "ADAGRAD",
                                            "options": {"learning_rate": 0.2}}
    raw["storage"]["dataset"] = {"dataset_dir": "", "num_nodes": 10, "num_relations": 2}
    j_cfg = j_load_config(copy.deepcopy(raw)).model.dense_optimizer
    t_cfg = t_load_config(copy.deepcopy(raw)).model.dense_optimizer
    assert isinstance(t_cfg, topt.GroupedOptimizerConfig)
    assert [p for p, _ in t_cfg.overrides] == [p for p, _ in j_cfg.overrides] == [
        ("encoder", 0, 0), ("decoder",)]
    for (_, t), (_, j) in zip(t_cfg.overrides, j_cfg.overrides):
        assert (t.optimizer_type, t.learning_rate) == (j.optimizer_type, j.learning_rate)
    assert t_cfg.default.optimizer_type == j_cfg.default.optimizer_type
    (jp, js), (tp, ts) = _run(j_cfg, t_cfg)
    _same_trees(tp, jp)
    _same_trees(ts.slots, js.slots)


def test_jax_grouped_checkpoint_loads_into_the_port(tmp_path):
    """A grouped state the JAX package checkpoints (slots shaped like the
    params, a slot dict per leaf) loads into the port's template of the
    same config, every leaf equal; the port writes the same leaf names."""
    import os

    import yaml

    j_cfg, t_cfg = _configs(dict(optimizer_type="ADAM", learning_rate=0.01),
                            [(("encoder", 0, 0), dict(optimizer_type="SGD", learning_rate=0.1,
                                                      momentum=0.5)),
                             (("decoder",), dict(optimizer_type="SGD", learning_rate=0.1))])
    (jp, js), _ = _run(j_cfg, t_cfg, steps=3)
    d = str(tmp_path / "jax_ckpt")
    jckpt.save_state(d, {"table": None, "params": jp, "opt_state": js, "epoch": 3})
    tp = topt.tree_map(lambda a: torch.zeros(np.shape(a)).requires_grad_(True),
                       _nested_params())
    template = TrainState(table=None, params=tp, opt_state=topt.init_optimizer(t_cfg, tp),
                          epoch=0)
    restored, _ = tckpt.load_state(d, template)
    assert restored.opt_state.step == 3 and restored.epoch == 3
    _same_trees(restored.params, jp)
    _same_trees(restored.opt_state.slots, js.slots)
    assert restored.opt_state.slots["decoder"]["relations"] == {}
    tckpt.save_state(str(tmp_path / "port_ckpt"), restored)
    with open(os.path.join(d, "meta.yaml")) as f:
        jnames = yaml.safe_load(f)["leaf_names"]
    assert sorted(os.listdir(tmp_path / "port_ckpt")) == sorted(
        [n.replace("/", "__") + ".npy" for n in jnames] + ["meta.yaml"])
