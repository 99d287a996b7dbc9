"""The port's checkpoints and config-driven LP manager, on the CPU.

Checkpoints round-trip bit for bit, drop optimizer leaves on request, refuse
a missing model leaf, and read a checkpoint the JAX package wrote. The LP
DEVICE_MEMORY scenarios of tests/test_manager.py run through the port's
manager with ``device="cpu"`` and are checked for structure: epochs,
evaluations, files and the resume epoch; variants that need an unported
path assert its NotImplementedError. Last, a model trained by the JAX
``marius_train`` is evaluated by both packages' ``marius_eval``: the
weights are trained, not quantized, so XLA's and torch's summation orders can
flip near-ties; ranks must agree on >= 99.9% of edges and MRR to rtol 1e-4.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from marius_tpu.config.schema import load_config as j_load_config
from marius_tpu.manager import marius_eval as j_marius_eval
from marius_tpu.manager import marius_train as j_marius_train
from marius_tpu.storage import checkpoint as jckpt
from marius_tpu.tools.preprocess import generate_random_dataset_lp
from marius_tpu_torch.config import load_config
from marius_tpu_torch.convert import train_state_from_jax
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
from marius_tpu_torch.manager import encode_and_export, marius_eval, marius_init, marius_train
from marius_tpu_torch.nn.optimizers import tree_leaves
from marius_tpu_torch.storage import checkpoint as ckpt
from marius_tpu_torch.train.trainer import LinkPredictionTrainer
from tests.test_manager import GS_ENCODER, LP_BASE
from tests.test_torch_lp_trainer import _np_state


def _lp_config(tmp_path, name, num_nodes=50, num_edges=500, **overrides):
    d = copy.deepcopy(LP_BASE)
    ds_dir = str(tmp_path / f"ds_{name}")
    generate_random_dataset_lp(ds_dir, num_nodes=num_nodes, num_edges=num_edges,
                               num_relations=5)
    d["storage"]["dataset"]["dataset_dir"] = ds_dir
    for path, val in overrides.items():
        node = d
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return d


def _train(raw, **kw):
    return marius_train(load_config(raw), device="cpu", **kw)


def _eval(raw):
    return marius_eval(load_config(raw), device="cpu")


# -- checkpoints -------------------------------------------------------------

def _leaves(state):
    out = ckpt._flatten_with_names(state)
    return {k: np.asarray(v) for k, v in out.items()}


def _small_trainer(bias=False):
    from tests.test_torch_lp_eval import _models

    _, tmodel = _models("COMPLEX", 16, 5)
    if bias:
        from marius_tpu_torch.nn.encoder import EncoderConfig
        from marius_tpu_torch.nn.layers import LayerConfig
        tmodel = tmodel.__class__(tmodel.learning_task, EncoderConfig(
            ((LayerConfig("EMBEDDING", output_dim=16, bias=True),),)), tmodel.decoder)
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 40, 300), rng.integers(0, 5, 300),
                      rng.integers(0, 40, 300)], 1).astype(np.int32)
    return LinkPredictionTrainer(tmodel, 40, 5, edges, NegativeSamplingConfig(4, 8),
                                 batch_size=64, device="cpu")


def test_checkpoint_round_trip_bit_for_bit(tmp_path):
    tr = _small_trainer(bias=True)
    tr.train_epoch()
    saved = {k: v.copy() for k, v in _leaves(tr.state).items()}
    assert "params/encoder/0/0/bias" in saved and saved["epoch"] == 1
    d = str(tmp_path / "ckpt")
    ckpt.save_state(d, tr.state, {"note": "test"})
    tr.train_epoch()   # the template now differs from the checkpoint
    restored, meta = ckpt.load_state(d, tr.state)
    assert meta["note"] == "test" and meta["leaf_names"] == sorted(saved)
    got = _leaves(restored)
    assert got.keys() == saved.keys()
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    assert restored.epoch == 1 and isinstance(restored.opt_state.step, int)
    assert all(t.requires_grad for t in tree_leaves(restored.params))
    assert restored.table.values is not tr.state.table.values
    # an overwrite removes leaves the new save does not have
    ckpt.save_state(d, _small_trainer().state)
    assert not os.path.exists(os.path.join(d, "params__encoder__0__0__bias.npy"))


def test_checkpoint_without_optim_state_and_missing_model_leaf(tmp_path):
    tr = _small_trainer()
    tr.train_epoch()
    path = ckpt.create_checkpoint(str(tmp_path), tr.state, epoch=1, save_optim_state=False)
    names = set(os.listdir(path))
    assert "table__values.npy" in names and "params__decoder__relations.npy" in names
    assert not any(n.startswith(("opt_state", "table__state")) for n in names)
    saved_values = tr.state.table.values.clone()
    tr.train_epoch()
    restored, meta = ckpt.load_state(path, tr.state)
    assert meta["epochs_processed"] == 1 and meta["missing_leaves"]
    assert all(n.startswith(ckpt.OPTIM_STATE_PREFIXES) for n in meta["missing_leaves"])
    assert torch.equal(restored.table.values, saved_values)
    assert torch.equal(restored.table.state, tr.state.table.state)   # the template's
    os.remove(os.path.join(path, "table__values.npy"))
    with pytest.raises(FileNotFoundError, match="missing model leaf 'table/values'"):
        ckpt.load_state(path, tr.state)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    from tests.test_torch_lp_eval import _models

    import marius_tpu.train.trainer as jtrainer_mod
    from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNeg

    jmodel, _ = _models("COMPLEX", 16, 5)
    port = _small_trainer()
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 40, 300), rng.integers(0, 5, 300),
                      rng.integers(0, 40, 300)], 1).astype(np.int32)
    jtr = jtrainer_mod.LinkPredictionTrainer(jmodel, 40, 5, edges, JNeg(4, 8), batch_size=64)
    jtr.train_epoch()
    d = str(tmp_path / "jax_ckpt")
    jckpt.save_state(d, jtr.state, {"epochs_processed": 1})
    restored, meta = ckpt.load_state(d, port.state)
    expected = _leaves(train_state_from_jax(_np_state(jtr.state)))
    got = _leaves(restored)
    assert got.keys() == expected.keys()
    for k in expected:
        np.testing.assert_array_equal(got[k], expected[k], err_msg=k)
    # the port writes the JAX package's leaf names, less the PRNG key
    ckpt.save_state(str(tmp_path / "port_ckpt"), restored)
    with open(os.path.join(d, "meta.yaml")) as f:
        jnames = yaml.safe_load(f)["leaf_names"]
    assert sorted(os.listdir(tmp_path / "port_ckpt")) == sorted(
        [n.replace("/", "__") + ".npy" for n in jnames if n != "key"] + ["meta.yaml"])


# -- the manager: tests/test_manager.py's LP DEVICE_MEMORY scenarios ----------

@pytest.mark.parametrize("variant", ["distmult", "distmult_unfiltered", "gs_1_layer"])
def test_lp_config_matrix(tmp_path, variant):
    overrides = {}
    if variant == "distmult_unfiltered":
        overrides["evaluation.negative_sampling"] = {
            "filtered": False, "num_chunks": 2, "negatives_per_positive": 8}
    if variant == "gs_1_layer":
        overrides["model.encoder"] = copy.deepcopy(GS_ENCODER)
    raw = _lp_config(tmp_path, variant, **overrides)
    if variant == "gs_1_layer":
        with pytest.raises(NotImplementedError, match="GNN"):
            _train(raw)
        return
    result = _train(raw)
    assert len(result["epochs"]) == 2 and len(result["evals"]) == 2
    assert result["epochs"][1]["loss"] < result["epochs"][0]["loss"] * 1.5
    assert 0.0 < result["test"]["mrr"] <= 1.0
    assert result["runtime"].test_evaluator.filtered == (variant == "distmult")


def test_lp_save_eval_and_export(tmp_path):
    raw = _lp_config(tmp_path, "save", **{"storage.save_model": True,
                                          "storage.model_dir": str(tmp_path / "model_0")})
    train_res = _train(raw)
    assert (tmp_path / "model_0" / "meta.yaml").exists()
    eval_res = _eval(raw)
    metrics = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    assert all(eval_res["test"][k] == train_res["test"][k] for k in metrics)
    assert eval_res["runtime"].epochs_processed == 2
    encoded = encode_and_export(eval_res["runtime"])
    assert encoded.shape == (50, 16)
    on_disk = np.fromfile(tmp_path / "model_0" / "encoded_nodes.bin", np.float32)
    np.testing.assert_array_equal(on_disk.reshape(50, 16), encoded)


def test_lp_eval_falls_back_to_the_latest_model_sibling(tmp_path):
    raw = _lp_config(tmp_path, "auto", **{"storage.save_model": True})
    ds = raw["storage"]["dataset"]["dataset_dir"]
    train_res = _train(raw)                   # auto-versioned: <dataset>/model_0
    assert os.path.exists(os.path.join(ds, "model_0", "meta.yaml"))
    cfg = load_config(raw)
    assert cfg.storage.model_dir == os.path.join(ds, "model_1")   # the next free one
    eval_res = marius_eval(cfg, device="cpu")
    assert eval_res["test"]["mrr"] == train_res["test"]["mrr"]


def test_lp_checkpoint_resume(tmp_path):
    raw = _lp_config(tmp_path, "resume", **{"storage.save_model": True,
                                            "storage.model_dir": str(tmp_path / "model_r"),
                                            "training.checkpoint": {"interval": 1}})
    _train(raw)
    assert (tmp_path / "model_r" / "checkpoint_1" / "meta.yaml").exists()
    raw2 = copy.deepcopy(raw)
    raw2["training"]["num_epochs"] = 3
    raw2["training"]["resume_from_checkpoint"] = str(tmp_path / "model_r" / "checkpoint_2")
    res = _train(raw2)
    assert len(res["epochs"]) == 1
    assert res["runtime"].epochs_processed == 3
    assert res["runtime"].trainer.state.epoch == 3
    # resume from a save_state=false checkpoint: optimizer state restarts fresh
    raw3 = copy.deepcopy(raw)
    raw3["storage"]["model_dir"] = str(tmp_path / "model_s")
    raw3["training"]["checkpoint"] = {"interval": 1, "save_state": False}
    _train(raw3)
    assert not (tmp_path / "model_s" / "checkpoint_1" / "table__state.npy").exists()
    raw3["training"]["num_epochs"] = 3
    raw3["training"]["resume_from_checkpoint"] = str(tmp_path / "model_s" / "checkpoint_2")
    assert len(_train(raw3)["epochs"]) == 1


def test_lp_save_best(tmp_path):
    raw = _lp_config(tmp_path, "best", **{"storage.save_model": True,
                                          "storage.model_dir": str(tmp_path / "model_b"),
                                          "training.num_epochs": 3,
                                          "training.epochs_per_eval": 1,
                                          "training.checkpoint": {"save_best": True}})
    res = _train(raw)
    with open(tmp_path / "model_b" / "meta.yaml") as f:
        meta = yaml.safe_load(f)
    assert meta["best_valid_metric"] == pytest.approx(max(e["mrr"] for e in res["evals"]),
                                                      abs=1e-6)
    assert _eval(raw)["test"]["mrr"] == pytest.approx(res["test"]["mrr"], abs=1e-7)


def test_save_best_not_overwritten_by_worse_resume(tmp_path):
    raw = _lp_config(tmp_path, "best2", **{"storage.save_model": True,
                                           "storage.model_dir": str(tmp_path / "model_bb"),
                                           "training.epochs_per_eval": 1,
                                           "training.checkpoint": {"save_best": True}})
    _train(raw)
    meta_path = tmp_path / "model_bb" / "meta.yaml"
    with open(meta_path) as f:
        meta = yaml.safe_load(f)
    meta["best_valid_metric"] = 2.0   # unbeatable (MRR <= 1)
    with open(meta_path, "w") as f:
        yaml.safe_dump(meta, f)
    table_before = (tmp_path / "model_bb" / "table__values.npy").read_bytes()
    _train(raw)
    with open(meta_path) as f:
        assert yaml.safe_load(f)["best_valid_metric"] == 2.0
    assert (tmp_path / "model_bb" / "table__values.npy").read_bytes() == table_before


def test_eval_checkpoint_dir_override(tmp_path):
    raw = _lp_config(tmp_path, "ckdir", **{"storage.save_model": True,
                                           "storage.model_dir": str(tmp_path / "model_c"),
                                           "training.checkpoint": {"interval": 1}})
    _train(raw)
    raw2 = copy.deepcopy(raw)
    raw2["evaluation"]["checkpoint_dir"] = str(tmp_path / "model_c" / "checkpoint_2")
    from_dir = _eval(raw)
    assert _eval(raw2)["test"]["mrr"] == from_dir["test"]["mrr"]
    raw3 = copy.deepcopy(raw)
    raw3["evaluation"]["checkpoint_dir"] = str(tmp_path / "model_c" / "checkpoint_1")
    assert _eval(raw3)["test"]["mrr"] != from_dir["test"]["mrr"]


def test_lp_async_pipeline_and_loss_scale(tmp_path):
    raw = _lp_config(tmp_path, "async", **{"training.pipeline": {"sync": False,
                                                                 "staleness_bound": 4}})
    result = _train(raw)
    assert len(result["epochs"]) == 2
    assert result["epochs"][1]["loss"] < result["epochs"][0]["loss"]
    assert 0.0 < result["test"]["mrr"] <= 1.0
    tr = result["runtime"].trainer
    assert tr.batch_size == 400 and tr.neg_config.num_chunks == 16
    assert tr.model.loss_scale == 1.0                 # SUM reduction
    raw["model"]["loss"]["options"]["reduction"] = "MEAN"
    assert marius_init(load_config(raw), device="cpu").trainer.model.loss_scale == 4.0
    del raw["training"]["pipeline"]
    assert marius_init(load_config(raw), device="cpu").trainer.model.loss_scale == 1.0


def test_evaluation_cadence_shuffle_and_train_filter(tmp_path):
    raw = _lp_config(tmp_path, "cadence", **{"training.num_epochs": 4,
                                             "evaluation.epochs_per_eval": 2,
                                             "training.epochs_per_shuffle": 3})
    raw["training"]["negative_sampling"]["filtered"] = True
    res = _train(raw)
    assert [e["epoch"] for e in res["evals"]] == [2, 4]
    tr = res["runtime"].trainer
    assert tr.epochs_per_shuffle == 3 and tr.train_filter_keys is not None
    assert all(np.isfinite(e["loss"]) for e in res["epochs"])


@pytest.mark.parametrize("what", ["partition_buffer", "host_streaming", "flat_file", "mesh",
                                  "nc", "bf16", "layer_optimizer"])
def test_unported_paths_raise(tmp_path, what):
    pb = {"type": "PARTITION_BUFFER", "options": {"num_partitions": 4, "buffer_capacity": 2}}
    overrides = {
        "partition_buffer": {"storage.embeddings": pb},
        "host_streaming": {"evaluation.host_streaming": True},
        "flat_file": {"storage.edges": {"type": "FLAT_FILE"}},
        "mesh": {"training.mesh": {"data": 2, "node": 1}},
        "nc": {"model.learning_task": "NODE_CLASSIFICATION", "model.decoder": None},
        "bf16": {"storage.embeddings": {"type": "DEVICE_MEMORY",
                                        "options": {"dtype": "bfloat16"}}},
        "layer_optimizer": {"model.decoder.optimizer": {"type": "ADAGRAD"}},
    }[what]
    raw = _lp_config(tmp_path, what, **overrides)
    with pytest.raises(NotImplementedError, match="comes with"):
        marius_init(load_config(raw), device="cpu")


# -- the JAX package's trained model through both marius_eval ----------------

def test_port_marius_eval_reproduces_jax(tmp_path):
    raw = _lp_config(tmp_path, "jax", num_nodes=200, num_edges=20_000,
                     **{"storage.save_model": True,
                        "storage.model_dir": str(tmp_path / "model_j"),
                        "training.batch_size": 1000,
                        "evaluation.batch_size": 500})
    j_marius_train(j_load_config(raw))
    jres = j_marius_eval(j_load_config(raw))
    tres = marius_eval(load_config(raw), device="cpu")
    jrt, trt = jres["runtime"], tres["runtime"]
    jranks, jscores = jrt.test_evaluator.compute_all_ranks(jrt.trainer.state)
    tranks, tscores = trt.test_evaluator.compute_all_ranks(trt.trainer.state)
    assert tranks.shape == jranks.shape and tranks.size >= 2000
    assert np.mean(tranks == jranks) >= 0.999
    np.testing.assert_allclose(tscores, jscores, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tres["test"]["mrr"], jres["test"]["mrr"], rtol=1e-4)
    assert tres["test"]["num_evaluated"] == jres["test"]["num_evaluated"]
    assert trt.epochs_processed == jrt.epochs_processed == 2
    np.testing.assert_array_equal(trt.trainer.state.table.values.numpy(),
                                  np.asarray(jax.device_get(jrt.trainer.state.table.values)))
