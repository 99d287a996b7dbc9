"""The port's checkpoints and config-driven LP and NC manager, on the CPU.

Checkpoints round-trip bit for bit, drop optimizer leaves on request, refuse
a missing model leaf, and read a checkpoint the JAX package wrote. The LP
DEVICE_MEMORY scenarios of tests/test_manager.py run through the port's
manager with ``device="cpu"`` and are checked for structure: epochs,
evaluations, files and the resume epoch; variants that need an unported
path assert its NotImplementedError. Last, a model trained by the JAX
``marius_train`` is evaluated by both packages' ``marius_eval``: the
weights are trained, not quantized, so XLA's and torch's summation orders can
flip near-ties; ranks must agree on >= 99.9% of edges and MRR to rtol 1e-4.

Node classification runs ``ogbn_arxiv.yaml``'s model (FEATURE + 3 x
GraphSAGE MEAN, UNIFORM 32 in and out per hop) on a 240-node dataset whose
in- and out-degrees are all at most 3, so the sampler takes every neighbour
once and draws nothing that matters: a model the JAX ``marius_train`` trains
and saves gives, through the port's ``marius_eval``, JAX's test accuracy
exactly. The port's own ``marius_train`` then reproduces its metrics through
``marius_eval``, keeps the best valid accuracy with ``save_best`` and
exports every node's encoding; ALL configs go to the full-graph trainer,
``hop_caps: auto``, the async mapping and an EMBEDDING stage are set up as
JAX sets them up.
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
from tests.test_torch_lp_eval import jax_search_clamped  # noqa: F401  (a fixture)
from tests.test_torch_lp_trainer import _np_state
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


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
    result = _train(raw)
    assert len(result["epochs"]) == 2 and len(result["evals"]) == 2
    assert result["epochs"][1]["loss"] < result["epochs"][0]["loss"] * 1.5
    assert 0.0 < result["test"]["mrr"] <= 1.0
    assert result["runtime"].test_evaluator.filtered == (variant != "distmult_unfiltered")
    tr, ev = result["runtime"].trainer, result["runtime"].test_evaluator
    if variant == "gs_1_layer":
        # the GNN path: sampled training and all-node encoding through the sampler
        assert tr.nbr_configs and tr.graph is not None and not tr.dense_accum
        assert ev.nbr_configs and ev.graph is not None and ev.full_graph is None


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


PB = {"type": "PARTITION_BUFFER", "options": {"num_partitions": 4, "buffer_capacity": 2}}
# paths this test refused before they were ported: each now runs (see also
# test_freebase_shaped_configs_match_jax and test_gnn_lp_configs)
PORTED = {
    "partition_buffer": {"storage.embeddings": PB},
    "host_streaming": {"evaluation.host_streaming": True},
    "flat_file": {"storage.edges": {"type": "FLAT_FILE"}},
    "buffer_gnn": {"storage.embeddings": PB, "model.encoder": copy.deepcopy(GS_ENCODER)},
    "buffer_feature": {"storage.embeddings": PB, "model.encoder": {"layers": [[
        {"type": "EMBEDDING", "output_dim": 8}, {"type": "FEATURE", "output_dim": 8}]]}},
    "bf16": {"storage.embeddings": {"type": "DEVICE_MEMORY", "options": {"dtype": "bfloat16"}}},
    "buffer_corrupt_rel": {"storage.embeddings": PB,
                           "model.decoder.options.edge_decoder_method": "CORRUPT_REL"},
}


def _add_features(raw, dim=8):
    """A feature file for the dataset of ``raw``, as the config's FEATURE stage needs."""
    from marius_tpu.storage.dataset import load_stats, save_node_array, save_stats

    ds = raw["storage"]["dataset"]["dataset_dir"]
    stats = load_stats(ds)
    rng = np.random.default_rng(0)
    save_node_array(ds, "features",
                    rng.standard_normal((stats.num_nodes, dim)).astype(np.float32))
    stats.feature_dim = dim
    save_stats(ds, stats)


@pytest.mark.parametrize("what", ["partition_buffer", "host_streaming", "flat_file", "mesh",
                                  "nc", "bf16", "layer_optimizer", "buffer_gnn",
                                  "buffer_feature", "buffer_corrupt_rel", "buffer_mesh"])
def test_unported_paths_raise(tmp_path, what):
    if what in PORTED:
        raw = _lp_config(tmp_path, what, **PORTED[what])
        if what == "buffer_feature":
            _add_features(raw)
        result = _train(raw)
        rt = result["runtime"]
        assert len(result["epochs"]) == 2 and 0.0 < result["test"]["mrr"] <= 1.0
        assert (type(rt.trainer).__name__ == "PartitionBufferLPTrainer") == (
            what.startswith(("partition_buffer", "buffer")))
        if what.startswith("buffer"):
            assert (rt.trainer.feature_cache is not None) == (what == "buffer_feature")
            assert bool(rt.trainer.nbr_configs) == (what == "buffer_gnn")
        assert (type(rt.test_evaluator).__name__ == "_HostStreamLPEval") == (
            what == "host_streaming")
        if what == "flat_file":
            assert isinstance(rt.trainer.edges_host, np.memmap)
        if what == "bf16":
            assert rt.trainer.state.table.values.dtype == torch.bfloat16
        if what == "buffer_corrupt_rel":
            assert rt.trainer.decoder_method == "CORRUPT_REL"
        return
    if what == "nc":
        # out-of-core NC is ported: PARTITION_BUFFER features route to
        # PartitionBufferNCTrainer with JAX's hop caps over the buffer rows
        from marius_tpu.manager import marius_init as j_marius_init

        raw = _nc_raw(tmp_path, "nc_buffer")
        raw["storage"]["features"] = {"type": "PARTITION_BUFFER"}
        raw["storage"]["embeddings"] = {"options": copy.deepcopy(PB["options"])}
        rt = marius_init(load_config(raw), device="cpu")
        jtr = j_marius_init(j_load_config(copy.deepcopy(raw))).trainer
        assert type(rt.trainer).__name__ == type(jtr).__name__ == "PartitionBufferNCTrainer"
        assert rt.trainer.hop_caps == tuple(jtr.hop_caps)
        assert (rt.trainer.num_partitions, rt.trainer.capacity) == (4, 2)
        assert isinstance(rt.trainer.cache.host, np.memmap) and rt.trainer.emb_buffer is None
        assert type(rt.test_evaluator).__name__ == "_BufferNCEval"
        return
    if what == "layer_optimizer":
        # a decoder-level optimizer block builds JAX's grouped config and trains
        from marius_tpu_torch.nn.optimizers import GroupedOptimizerConfig

        raw = _lp_config(tmp_path, what, **{"model.decoder.optimizer": {"type": "ADAGRAD"}})
        cfg = load_config(raw)
        jcfg = j_load_config(copy.deepcopy(raw))
        assert isinstance(cfg.model.dense_optimizer, GroupedOptimizerConfig)
        assert [p for p, _ in cfg.model.dense_optimizer.overrides] == \
            [p for p, _ in jcfg.model.dense_optimizer.overrides] == [("decoder",)]
        result = marius_train(cfg, device="cpu")
        st = result["runtime"].trainer.state
        assert set(st.opt_state.slots["decoder"]["relations"]) == {"sum"}
        assert len(result["epochs"]) == 2 and 0.0 < result["test"]["mrr"] <= 1.0
        return
    overrides = {
        "mesh": {"training.mesh": {"data": 2, "node": 1}},
        "buffer_mesh": {"storage.embeddings": PB, "training.mesh": {"data": 1, "node": 2}},
    }[what]
    raw = _lp_config(tmp_path, what, **overrides)
    # an LP mesh is ported, in memory (tests/test_torch_mesh.py) and over the
    # partition buffer (tests/test_torch_mesh_buffer.py): it needs the ranks
    # of a process group, which this process has not joined
    with pytest.raises(ValueError, match="process group"):
        marius_init(load_config(raw), device="cpu")


def test_host_streamed_evaluation_reads_the_host_table_in_place(tmp_path, monkeypatch):
    """evaluation.host_streaming over the partition buffer: the host table
    reaches the tiled evaluation as it lies, never moved to the device."""
    raw = _lp_config(tmp_path, "host_table", **{"storage.embeddings": PB,
                                                 "evaluation.host_streaming": True})
    rt = marius_init(load_config(raw), device="cpu")
    ev = rt.test_evaluator
    assert type(ev).__name__ == "_HostStreamLPEval"
    seen = []
    monkeypatch.setattr(ev.ev, "evaluate_from_host_table",
                        lambda host, params, features_host=None: seen.append(host) or {})
    # a device nothing can be read back from: a move there would fail below
    monkeypatch.setattr(ev.ev, "device", torch.device("meta"))
    ev.evaluate(rt.trainer.state)
    assert np.shares_memory(seen[0], rt.trainer.state.table.values.numpy())


# -- GNN and FEATURE encoders for link prediction -------------------------------

GNN_LP = {
    # JAX trains; exact-ALL evaluation (no draws) in both packages
    "jax_all_eval": {"model.encoder": dict(copy.deepcopy(GS_ENCODER),
                                           eval_neighbor_sampling=[{"type": "ALL"}])},
    # sampled evaluation, the model saved, reloaded and exported
    "sampled_export": {"model.encoder": copy.deepcopy(GS_ENCODER),
                       "storage.export_encoded_nodes": True},
    # tests/test_manager.py:303: a buffer-backed GNN model evaluated from the host table
    "buffer_host_streaming": {"model.encoder": copy.deepcopy(GS_ENCODER),
                              "storage.embeddings": PB, "evaluation.host_streaming": True},
    # a shallow EMBEDDING + FEATURE encoder and a GNN over features
    "features": {"model.encoder": {"layers": [
        [{"type": "EMBEDDING", "output_dim": 8}, {"type": "FEATURE", "output_dim": 8}],
        [{"type": "GNN", "input_dim": 16, "output_dim": 16,
          "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}]],
        "train_neighbor_sampling": [{"type": "UNIFORM", "options": {"max_neighbors": 4}}]}},
}


@pytest.mark.parametrize("variant", list(GNN_LP))
def test_gnn_lp_configs(jax_search_clamped, tmp_path, variant):  # noqa: F811
    """GNN and FEATURE LP configs through the port's marius_train and
    marius_eval: the test metrics reload exactly. A model the JAX manager
    trains with exact-ALL evaluation gives JAX's test metrics through the
    port's marius_eval (trained weights: near-ties may flip, so MRR to rtol
    1e-4 and >= 99.9% equal ranks; the JAX search clamped as in
    tests/test_torch_lp_eval.py, ROADMAP C1)."""
    size = {}
    if variant == "jax_all_eval":
        # >= 2,000 ranks, as in test_port_marius_eval_reproduces_jax
        size = dict(num_nodes=200, num_edges=20_000, **{"training.batch_size": 1000,
                                                         "evaluation.batch_size": 500})
    raw = _lp_config(tmp_path, variant, **size, **{"storage.save_model": True,
                                                   "storage.model_dir": str(tmp_path / "model"),
                                                   **GNN_LP[variant]})
    if variant == "features":
        _add_features(raw)
    if variant == "jax_all_eval":
        j_marius_train(j_load_config(raw))
        jres = j_marius_eval(j_load_config(raw))
        tres = marius_eval(load_config(raw), device="cpu")
        jrt, trt = jres["runtime"], tres["runtime"]
        assert trt.test_evaluator.full_graph is not None
        assert jrt.test_evaluator.full_graph is not None
        np.testing.assert_array_equal(trt.trainer.state.table.values.numpy(),
                                      np.asarray(jrt.trainer.state.table.values))
        np.testing.assert_allclose(tres["test"]["mrr"], jres["test"]["mrr"], rtol=1e-4)
        assert tres["test"]["num_evaluated"] == jres["test"]["num_evaluated"]
        jranks = jrt.test_evaluator.compute_all_ranks(jrt.trainer.state)[0]
        tranks = trt.test_evaluator.compute_all_ranks(trt.trainer.state)[0]
        assert tranks.shape == jranks.shape and tranks.size >= 2000
        assert np.mean(tranks == jranks) >= 0.999
        return
    res = _train(raw)
    rt = res["runtime"]
    assert len(res["epochs"]) == 2 and len(res["evals"]) == 2
    assert all(np.isfinite(e["loss"]) for e in res["epochs"])
    assert 0.0 < res["test"]["mrr"] <= 1.0
    again = _eval(raw)
    assert all(again["test"][k] == res["test"][k] for k in METRICS)
    if variant == "sampled_export":
        encoded = np.fromfile(tmp_path / "model" / "encoded_nodes.bin", np.float32)
        np.testing.assert_array_equal(
            encoded.reshape(50, 16),
            encode_and_export(again["runtime"], path=str(tmp_path / "again.bin")))
    if variant == "buffer_host_streaming":
        assert type(rt.trainer).__name__ == "PartitionBufferLPTrainer"
        assert type(rt.test_evaluator).__name__ == "_HostStreamLPEval"
        assert rt.test_evaluator.ev.graph is not None
    if variant == "features":
        assert rt.trainer.features.shape == (51, 8) and rt.test_evaluator.features is not None


# -- freebase86m_comet.yaml's shape through both managers ----------------------

FREEBASE_YAML = os.path.join(os.path.dirname(__file__), "..", "examples", "configuration",
                             "freebase86m_comet.yaml")
METRICS = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")


def _freebase_shaped(tmp_path, variant):
    """freebase86m_comet.yaml (ComplEx d=100, PARTITION_BUFFER 16 x 8, COMET,
    degree_fraction 0.5, Adagrad) on a 300-node dataset, cut to batch 100 of
    2 x 16 negatives, 2 epochs, filtered evaluation (sampled negatives could
    not match across the two packages' generators)."""
    with open(FREEBASE_YAML) as f:
        raw = yaml.safe_load(f)
    ds_dir = str(tmp_path / "ds")
    if not os.path.exists(ds_dir):
        generate_random_dataset_lp(ds_dir, num_nodes=300, num_edges=3000, num_relations=7)
    raw["storage"]["dataset"]["dataset_dir"] = ds_dir
    raw["storage"]["save_model"] = True
    raw["training"].update(batch_size=100, num_epochs=2)
    raw["training"]["negative_sampling"].update(num_chunks=2, negatives_per_positive=16)
    raw["evaluation"] = {"batch_size": 100, "negative_sampling": {"filtered": True}}
    if variant == "flat_file":      # edges memory-mapped, table on the device
        raw["storage"]["embeddings"] = {"type": "DEVICE_MEMORY"}
        raw["storage"]["edges"] = {"type": "FLAT_FILE"}
    if variant == "host_streaming":
        raw["evaluation"]["host_streaming"] = True
    return raw


@pytest.mark.parametrize("variant", ["partition_buffer", "flat_file", "host_streaming"])
def test_freebase_shaped_configs_match_jax(tmp_path, variant):
    """The JAX manager trains and saves; the port's marius_eval loads that
    model into the same route and gives the JAX marius_eval's test metrics
    (trained weights: near-ties may flip, so MRR to rtol 1e-4 and >= 99.9%
    equal ranks). Then the port's own marius_train runs the config, and its
    marius_eval reloads the model and reproduces the test metrics exactly."""
    raw = _freebase_shaped(tmp_path, variant)
    raw_j = copy.deepcopy(raw)
    raw_j["storage"]["model_dir"] = str(tmp_path / "model_jax")
    j_marius_train(j_load_config(raw_j))
    jres = j_marius_eval(j_load_config(raw_j))
    tres = marius_eval(load_config(raw_j), device="cpu")
    jrt, trt = jres["runtime"], tres["runtime"]
    expected = {"partition_buffer": "PartitionBufferLPTrainer",
                "flat_file": "LinkPredictionTrainer",
                "host_streaming": "PartitionBufferLPTrainer"}[variant]
    assert type(trt.trainer).__name__ == type(jrt.trainer).__name__ == expected
    np.testing.assert_array_equal(trt.trainer.state.table.values.numpy(),
                                  np.asarray(jrt.trainer.state.table.values))
    assert trt.epochs_processed == jrt.epochs_processed == 2
    np.testing.assert_allclose(tres["test"]["mrr"], jres["test"]["mrr"], rtol=1e-4)
    assert tres["test"]["num_evaluated"] == jres["test"]["num_evaluated"]
    if variant != "host_streaming":
        jranks = jrt.test_evaluator.compute_all_ranks(jrt.trainer.state)[0]
        tranks = trt.test_evaluator.compute_all_ranks(trt.trainer.state)[0]
        assert tranks.shape == jranks.shape and np.mean(tranks == jranks) >= 0.999

    raw_t = copy.deepcopy(raw)
    raw_t["storage"]["model_dir"] = str(tmp_path / "model_port")
    out = _train(raw_t)
    assert len(out["epochs"]) == 2 and len(out["evals"]) == 2
    assert all(np.isfinite(e["loss"]) for e in out["epochs"])
    assert out["epochs"][1]["loss"] < out["epochs"][0]["loss"]
    again = _eval(raw_t)
    assert all(again["test"][k] == out["test"][k] for k in METRICS)
    if variant != "flat_file":
        assert out["epochs"][0]["num_buffer_states"] == 10     # COMET 16 x 8 at seed 0


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


# -- node classification: ogbn_arxiv.yaml's model on a small dataset -----------

ARXIV_YAML = os.path.join(os.path.dirname(__file__), "..", "examples", "configuration",
                          "ogbn_arxiv.yaml")
NC_N, NC_F, NC_CLASSES = 240, 16, 5


def _nc_dataset(ds_dir):
    """Out-degree and in-degree 3 at every node (i -> i+1, i+7, i+31): with
    a fanout of 32 every neighbour is taken once, whatever the draws."""
    from marius_tpu_torch.storage.dataset import (
        DatasetStats,
        save_node_array,
        save_split,
        save_stats,
    )

    rng = np.random.default_rng(0)
    i = np.arange(NC_N)
    edges = np.concatenate([np.stack([i, (i + k) % NC_N], 1) for k in (1, 7, 31)])
    feats = rng.standard_normal((NC_N, NC_F)).astype(np.float32)
    labels = np.argmax(feats @ rng.standard_normal((NC_F, NC_CLASSES)), 1).astype(np.int32)
    perm = rng.permutation(NC_N).astype(np.int32)
    save_split(ds_dir, "train", edges)
    save_node_array(ds_dir, "features", feats)
    save_node_array(ds_dir, "labels", labels)
    for name, part in (("train_nodes", perm[:150]), ("valid_nodes", perm[150:190]),
                       ("test_nodes", perm[190:])):
        save_node_array(ds_dir, name, part)
    save_stats(ds_dir, DatasetStats(num_nodes=NC_N, num_edges=len(edges), num_relations=1,
                                    num_edge_cols=2, num_train=150, num_valid=40, num_test=50,
                                    num_classes=NC_CLASSES, feature_dim=NC_F))


def _nc_raw(tmp_path, name, **overrides):
    """ogbn_arxiv.yaml with the widths of the small dataset, its hop caps
    left to the worst case and a batch of 64."""
    with open(ARXIV_YAML) as f:
        raw = yaml.safe_load(f)
    ds_dir = str(tmp_path / f"ds_{name}")
    if not os.path.exists(os.path.join(ds_dir, "dataset.yaml")):
        _nc_dataset(ds_dir)
    enc = raw["model"]["encoder"]
    del enc["hop_caps"]
    enc["layers"][0][0]["output_dim"] = NC_F
    for stage in enc["layers"][1:]:
        stage[0]["input_dim"], stage[0]["output_dim"] = NC_F, NC_F
    enc["layers"][-1][0]["output_dim"] = NC_CLASSES
    raw["storage"] = {"dataset": {"dataset_dir": ds_dir}, "save_model": False}
    raw["training"].update(batch_size=64, num_epochs=3)
    raw["evaluation"]["batch_size"] = 50
    for path, val in overrides.items():
        node = raw
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return raw


def test_arxiv_shaped_jax_model_through_port_eval(tmp_path):
    raw = _nc_raw(tmp_path, "jax", **{"storage.save_model": True,
                                      "storage.model_dir": str(tmp_path / "model_j")})
    jres = j_marius_train(j_load_config(raw))
    tres = marius_eval(load_config(raw), device="cpu")
    assert tres["runtime"].epochs_processed == 3
    assert tres["test"]["num_evaluated"] == jres["test"]["num_evaluated"] == 50
    assert tres["test"]["accuracy"] == jres["test"]["accuracy"]
    assert tres["test"]["accuracy"] > 1.0 / NC_CLASSES


def test_arxiv_shaped_port_train_eval_save_best_and_export(tmp_path):
    raw = _nc_raw(tmp_path, "port", **{"storage.save_model": True,
                                       "storage.model_dir": str(tmp_path / "model_p"),
                                       "storage.export_encoded_nodes": True,
                                       "training.checkpoint": {"save_best": True}})
    res = _train(raw)
    rt = res["runtime"]
    assert type(rt.trainer).__name__ == "NodeClassificationTrainer"
    assert rt.trainer.full_graph is None and rt.trainer.hop_caps == (64, NC_N + 1, NC_N + 1,
                                                                      NC_N + 1)
    assert [e["truncated_frontier_ids"] for e in res["epochs"]] == [0, 0, 0]
    assert res["epochs"][-1]["loss"] < res["epochs"][0]["loss"]
    assert all("nodes_per_sec" in e for e in res["epochs"]) and len(res["evals"]) == 3
    with open(tmp_path / "model_p" / "meta.yaml") as f:
        meta = yaml.safe_load(f)
    assert meta["best_valid_metric"] == pytest.approx(max(e["accuracy"] for e in res["evals"]))
    again = _eval(raw)
    assert again["test"] == {k: res["test"][k] for k in ("accuracy", "num_evaluated")}
    encoded = np.fromfile(tmp_path / "model_p" / "encoded_nodes.bin", np.float32)
    np.testing.assert_array_equal(encoded.reshape(NC_N, NC_CLASSES),
                                  encode_and_export(again["runtime"], path=str(
                                      tmp_path / "again.bin")))


NC_VARIANTS = {
    "all_full_graph": {"model.encoder.train_neighbor_sampling": [{"type": "ALL"}] * 3},
    "all_sampled": {"model.encoder.train_neighbor_sampling": [{"type": "ALL"}] * 3,
                    "model.encoder.full_graph": "OFF"},
    "hop_caps_auto": {"model.encoder.hop_caps": "auto"},
    "async": {"training.pipeline": {"sync": False, "staleness_bound": 2}},
    "embeddings": {"model.encoder.layers": [
        [{"type": "FEATURE", "output_dim": NC_F}, {"type": "EMBEDDING", "output_dim": 8}],
        [{"type": "REDUCTION", "options": {"type": "CONCAT"}}],
        [{"type": "GNN", "input_dim": NC_F + 8, "output_dim": NC_CLASSES,
          "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}]],
        "model.encoder.train_neighbor_sampling": [{"type": "UNIFORM",
                                                   "options": {"max_neighbors": 4}}],
        "model.sparse_optimizer": {"type": "ADAGRAD", "options": {"learning_rate": 0.1}}},
}


@pytest.mark.parametrize("variant", list(NC_VARIANTS))
def test_nc_config_variants_set_up_as_jax(tmp_path, variant):
    from marius_tpu.manager import marius_init as j_marius_init

    raw = _nc_raw(tmp_path, variant, **NC_VARIANTS[variant])
    jtr = j_marius_init(j_load_config(copy.deepcopy(raw))).trainer
    res = _train(raw)
    ttr = res["runtime"].trainer
    assert (ttr.full_graph is None) == (jtr.full_graph is None) == (variant != "all_full_graph")
    assert ttr.batch_size == jtr.batch_size == (128 if variant == "async" else 64)
    if ttr.full_graph is None:
        assert ttr.hop_caps == tuple(jtr.hop_caps)
        assert [c.max_neighbors for c in ttr.nbr_configs] == \
            [c.max_neighbors for c in jtr.nbr_configs]
    assert (ttr.state.table is None) == (variant != "embeddings")
    assert len(res["epochs"]) == 3 and np.isfinite(res["epochs"][-1]["loss"])
    assert 0.0 <= res["test"]["accuracy"] <= 1.0 and res["test"]["num_evaluated"] == 50


def test_nc_refuses_unported(tmp_path):
    """Every NC mesh needs a process group; GAT and RGCN stages are ported
    (tests/test_torch_gat_rgcn_e2e.py trains them through the managers) and
    set up as the JAX package sets them up, and so are bf16 features and
    parameters (tests/test_torch_bf16.py)."""
    from marius_tpu.manager import marius_init as j_marius_init

    for gnn in ("GAT", "RGCN"):
        raw = _nc_raw(tmp_path, "gat")
        raw["model"]["encoder"]["layers"][1][0]["options"] = {"type": gnn}
        trainer = marius_init(load_config(raw), device="cpu").trainer
        jtr = j_marius_init(j_load_config(raw)).trainer
        assert trainer.model.encoder.stages[1][0].gnn_type == gnn
        assert trainer.hop_caps == tuple(jtr.hop_caps)
    # a data-parallel NC mesh is ported (tests/test_torch_mesh_nc.py), and so
    # is out-of-core NC on one (tests/test_torch_mesh_nc_buffer.py): both need
    # a process group
    with pytest.raises(ValueError, match="process group"):
        marius_init(load_config(_nc_raw(tmp_path, "gat", **{
            "training.mesh": {"data": 2, "node": 1}})), device="cpu")
    with pytest.raises(ValueError, match="process group"):
        marius_init(load_config(_nc_raw(tmp_path, "gat", **{
            "training.mesh": {"data": 2, "node": 1},
            "storage.features": {"type": "PARTITION_BUFFER"},
            "storage.embeddings": {"options": copy.deepcopy(PB["options"])}})), device="cpu")
    raw = _nc_raw(tmp_path, "gat", **{"storage.embeddings": {
        "type": "DEVICE_MEMORY", "options": {"dtype": "bfloat16"}}})
    trainer = marius_init(load_config(raw), device="cpu").trainer
    assert trainer.features.dtype == torch.bfloat16
