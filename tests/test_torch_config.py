"""The port's config loader and validation against marius_tpu's.

Every example YAML and every config dict of tests/test_manager.py and
tests/test_config_compat.py parses to an equal MariusConfig in both packages,
field by field (the Model and its EdgeDecoder, an nn.Module in the port, by
their config fields), with the same compat warnings; every error case of
tests/test_config_validation.py raises ConfigError with the same message.
"""

import copy
import dataclasses
import warnings
from pathlib import Path

import pytest
import torch
import yaml

from marius_tpu.config import schema as jschema
from marius_tpu.config.validate import ConfigError as JConfigError
from marius_tpu.config.validate import check_compat_keys as j_check_compat_keys
from marius_tpu_torch import config as tconfig
from marius_tpu_torch.config import schema as tschema
from marius_tpu_torch.config.validate import ConfigError as TConfigError
from marius_tpu_torch.config.validate import check_compat_keys as t_check_compat_keys
from tests.test_manager import GAT_ENCODER, GS_2_LAYER_ENCODER, GS_ENCODER, LP_BASE
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

EXAMPLES = sorted((Path(__file__).resolve().parents[1] / "examples" / "configuration")
                  .glob("*.yaml"))

NC_RAW = {
    "model": {
        "learning_task": "NODE_CLASSIFICATION",
        "encoder": {
            "layers": [
                [{"type": "FEATURE", "output_dim": 8}],
                [{"type": "GNN", "input_dim": 8, "output_dim": 4,
                  "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}],
            ],
            "train_neighbor_sampling": [{"type": "UNIFORM", "options": {"max_neighbors": 4}}],
        },
        "loss": {"type": "CROSS_ENTROPY", "options": {"reduction": "SUM"}},
        "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": 0.01}},
    },
    "storage": {"dataset": {"dataset_dir": ""}, "save_model": False},
    "training": {"batch_size": 30, "num_epochs": 2},
    "evaluation": {"batch_size": 30},
}


def _lp(**overrides):
    d = copy.deepcopy(LP_BASE)
    for path, val in overrides.items():
        node = d
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = copy.deepcopy(val)
    return d


def _nc(**overrides):
    d = copy.deepcopy(NC_RAW)
    for path, val in overrides.items():
        node = d
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = copy.deepcopy(val)
    return d


_RGCN = copy.deepcopy(GAT_ENCODER)
_RGCN["layers"][1][0]["options"] = {"type": "RGCN"}
_PB = {"type": "PARTITION_BUFFER", "options": {"num_partitions": 4, "buffer_capacity": 2}}
_LEARNABLE_NC = copy.deepcopy(NC_RAW["model"]["encoder"])
_LEARNABLE_NC["layers"] = [
    [{"type": "FEATURE", "output_dim": 8}, {"type": "EMBEDDING", "output_dim": 8}],
    [{"type": "REDUCTION", "options": {"type": "CONCAT"}}],
    [{"type": "GNN", "input_dim": 16, "output_dim": 4,
      "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}]]
_DIRECTIONS = {
    "use_incoming_nbrs": False, "use_outgoing_nbrs": True,
    "layers": GS_ENCODER["layers"],
    "train_neighbor_sampling": [{"type": "UNIFORM", "use_incoming_nbrs": True,
                                 "use_outgoing_nbrs": False, "options": {"max_neighbors": 4}}]}

DICTS = {
    "lp_base": _lp(),
    "lp_unfiltered": _lp(**{"evaluation.negative_sampling": {
        "filtered": False, "num_chunks": 2, "negatives_per_positive": 8}}),
    "lp_gs_1_layer": _lp(**{"model.encoder": GS_ENCODER}),
    "lp_gs_2_layer": _lp(**{"model.encoder": GS_2_LAYER_ENCODER}),
    "lp_gat": _lp(**{"model.encoder": GAT_ENCODER}),
    "lp_rgcn": _lp(**{"model.encoder": _RGCN}),
    "lp_save": _lp(**{"storage.save_model": True, "storage.model_dir": "/tmp/model_0"}),
    "lp_resume": _lp(**{"training.checkpoint": {"interval": 1},
                        "training.resume_from_checkpoint": "/tmp/model_r/checkpoint_2"}),
    "lp_save_best": _lp(**{"storage.save_model": True, "training.epochs_per_eval": 1,
                           "training.checkpoint": {"save_best": True}}),
    "lp_checkpoint_dir": _lp(**{"evaluation.checkpoint_dir": "/tmp/model_c/checkpoint_2"}),
    "lp_async": _lp(**{"training.pipeline": {"sync": False, "staleness_bound": 4}}),
    "lp_async_mean": _lp(**{"model.loss.options.reduction": "MEAN",
                            "training.pipeline": {"sync": False, "staleness_bound": 4}}),
    "lp_host_streaming": _lp(**{"model.encoder": GS_ENCODER, "evaluation.host_streaming": True,
                                "storage.embeddings": _PB}),
    "lp_buffer": _lp(**{"storage.embeddings": _PB, "training.epochs_per_shuffle": 3}),
    "lp_eval_epochs": _lp(**{"evaluation.epochs_per_eval": 2, "training.num_epochs": 4}),
    "lp_mesh": _lp(**{"training.mesh": {"data": 2, "node": 4, "mode": "explicit"}}),
    "lp_all_sampling": _lp(**{"model.encoder": dict(GS_ENCODER,
                                                    train_neighbor_sampling=[{"type": "ALL"}])}),
    "lp_directions": _lp(**{"model.encoder": _DIRECTIONS}),
    "lp_spellings": _lp(**{"model.random_seed": 99, "training.save_model": False,
                           "storage.prefetch": False,
                           "storage.dataset.node_feature_dim": 12}),
    "lp_compat": _lp(**{"training.pipeline": {"sync": False, "staleness_bound": 4,
                                              "batch_host_queue_size": 8, "compute_threads": 2},
                        "training.logs_per_epoch": 10, "storage.shuffle_input": True,
                        "storage.full_graph_evaluation": True}),
    "lp_layer_optimizers": _lp(**{
        "model.encoder.layers": [[{"type": "EMBEDDING", "output_dim": 16, "optimizer": {
            "type": "ADAM", "options": {"learning_rate": 0.1}}}]],
        "model.decoder.optimizer": {"type": "ADAM"}}),
    "lp_bf16": _lp(**{"storage.embeddings": {"type": "DEVICE_MEMORY",
                                             "options": {"dtype": "bfloat16"}}}),
    "nc": _nc(),
    "nc_async": _nc(**{"training.pipeline": {"sync": False, "staleness_bound": 2}}),
    "nc_learnable": _nc(**{"model.encoder": _LEARNABLE_NC,
                           "model.loss": {"type": "CROSS_ENTROPY"},
                           "model.sparse_optimizer": {"type": "ADAGRAD",
                                                      "options": {"learning_rate": 0.1}}}),
    "nc_feature_buffer": _nc(**{"storage.features": {"type": "PARTITION_BUFFER"},
                                "storage.embeddings": {"options": {"num_partitions": 4,
                                                                   "buffer_capacity": 2}},
                                "training.epochs_per_shuffle": 3}),
}


def _plain(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else (
        [_plain(v) for v in x] if isinstance(x, (tuple, list)) else x)


def _assert_same_config(j, t):
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name != "model":
            assert _plain(tv) == _plain(jv), f.name
            continue
        assert ([g.name for g in dataclasses.fields(tv)]
                == [g.name for g in dataclasses.fields(jv)])
        for g in dataclasses.fields(jv):
            ja, ta = getattr(jv, g.name), getattr(tv, g.name)
            if g.name == "decoder":
                assert (ta is None) == (ja is None)
                if ja is not None:
                    for name in ("decoder_type", "num_relations", "embedding_dim",
                                 "use_inverse_relations", "decoder_method"):
                        assert getattr(ta, name) == getattr(ja, name), name
            else:
                assert type(ta).__name__ == type(ja).__name__, g.name
                assert _plain(ta) == _plain(ja), g.name


def _load_both(raw, **kw):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = jschema.load_config(copy.deepcopy(raw), **kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = tschema.load_config(copy.deepcopy(raw), **kw)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    return j, t


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_example_yaml_parses_equal(path):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = jschema.load_config(str(path))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = tconfig.load_config(str(path))
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    _assert_same_config(j, t)
    with open(path) as f:
        _assert_same_config(*_load_both(yaml.safe_load(f), model_dir="/tmp/m"))


@pytest.mark.parametrize("name", list(DICTS))
def test_config_dict_parses_equal(name):
    j, t = _load_both(DICTS[name])
    _assert_same_config(j, t)
    assert t.training.mesh_mode == j.training.mesh_mode
    assert str(tschema.resolve_dtype(t.storage.embeddings_dtype)) == \
        f"torch.{jschema.resolve_dtype(j.storage.embeddings_dtype).__name__}"
    assert t_check_compat_keys(DICTS[name]) == j_check_compat_keys(DICTS[name])


def test_config_reads_dataset_stats(tmp_path):
    from marius_tpu.tools.preprocess import generate_random_dataset_lp

    ds = tmp_path / "ds"
    generate_random_dataset_lp(str(ds), num_nodes=50, num_edges=500, num_relations=5)
    raw = _lp(**{"storage.dataset.dataset_dir": str(ds)})
    j, t = _load_both(raw)
    _assert_same_config(j, t)
    assert t.storage.dataset.num_nodes == 50 and t.storage.dataset.num_relations == 5
    assert t.storage.model_dir == str(ds / "model_0")
    assert t.model.decoder.relations.shape == (5, 16)


def _case(**edits):
    def make():
        d = _lp(**{"storage.dataset.dataset_dir": ""})
        for path, val in edits.items():
            node = d
            keys = path.split(".")
            for k in keys[:-1]:
                node = node[k]
            node[keys[-1]] = copy.deepcopy(val)
        return d
    return make


ERROR_CASES = {
    "unknown_key": _case(**{"training.bach_size": 50}),
    "unknown_nested_key": _case(**{"model.decoder.options.inpt_dim": 8}),
    "unknown_section": _case(trainig={"batch_size": 10}),
    "bad_enum": _case(**{"model.decoder.type": "DISTMULTT"}),
    "bad_value": _case(**{"training.batch_size": 0}),
    "gnn_stage_sampling": _case(**{"model.encoder": dict(GS_ENCODER,
                                                         train_neighbor_sampling=[])}),
    "buffer_capacity": _case(**{"storage.embeddings": {
        "type": "PARTITION_BUFFER", "options": {"num_partitions": 2, "buffer_capacity": 8}}}),
    "host_streaming": _case(**{"evaluation.host_streaming": True,
                               "evaluation.negative_sampling": {"filtered": False}}),
    "edges_partition_buffer": _case(**{"storage.edges": {"type": "PARTITION_BUFFER"}}),
    "multiple_errors": _case(**{"training.bach_size": 50, "model.decoder.type": "WRONG"}),
    "eval_sampling_count": _case(**{"model.encoder": dict(
        GS_ENCODER, eval_neighbor_sampling=GS_ENCODER["train_neighbor_sampling"] * 2)}),
    "save_best_without_save_model": _case(**{"storage.save_model": False,
                                             "training.checkpoint": {"save_best": True}}),
}


@pytest.mark.parametrize("name", list(ERROR_CASES))
def test_config_error_matches_jax(name):
    raw = ERROR_CASES[name]()
    with pytest.raises(JConfigError) as je:
        jschema.load_config(copy.deepcopy(raw))
    with pytest.raises(TConfigError) as te:
        tschema.load_config(copy.deepcopy(raw))
    assert str(te.value) == str(je.value)


def test_validate_false_and_features_dtype():
    raw = ERROR_CASES["unknown_key"]()
    _assert_same_config(*_load_both(raw, validate=False))
    with pytest.raises(ValueError, match="DISTMULTT"):   # no decoder to build, no validation
        tschema.load_config(ERROR_CASES["bad_enum"](), validate=False)
    d = _lp(**{"storage.features": {"type": "DEVICE_MEMORY", "options": {"dtype": "bfloat16"}}})
    assert tschema.load_config(d).storage.embeddings_dtype == "bfloat16"
    assert tschema.resolve_dtype("bfloat16") == torch.bfloat16
    d["storage"]["embeddings"] = {"type": "DEVICE_MEMORY", "options": {"dtype": "float"}}
    assert tschema.load_config(d).storage.embeddings_dtype == "float"
    with pytest.raises(ValueError, match="hop_caps"):
        tschema.load_config(_lp(**{"model.encoder": dict(GS_ENCODER, hop_caps="most")}))
