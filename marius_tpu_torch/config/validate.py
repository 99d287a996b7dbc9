"""Config validation: unknown-key rejection + type/cross-field checks.

Port of ``marius_tpu/config/validate.py`` (:19-469): the same allowed-key
tree, compat notes, value checks and messages. Custom names registered in
``marius_tpu.nn.registry`` have no counterpart until the registry is ported,
so ``_registered`` is False. An unknown decoder type, which the port's loader
cannot build a decoder for, comes in as ``unknown_decoder`` and is reported
where the JAX check reports it.

Parity with the reference's validated config load (tools/configuration/
marius_config.py:836 type_safe_merge rejects keys that don't exist on the
dataclass; __post_init__ methods check value ranges and cross-field
constraints). Errors carry the full dotted YAML path and a did-you-mean
suggestion so misconfiguration fails at load, not as a deep jit/shape error.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, List, Optional

from marius_tpu_torch.nn.decoders.edge import normalize_decoder_method
from marius_tpu_torch.nn.optimizers import GroupedOptimizerConfig

__all__ = ["ConfigError", "check_unknown_keys", "check_config_values",
           "check_compat_keys", "validate"]


class ConfigError(ValueError):
    """Raised for unknown keys or invalid/inconsistent config values."""


# ---------------------------------------------------------------------------
# Allowed-key tree: key -> None (scalar) | sub-spec dict. A "[]" suffix on a
# key means the value is a list of mappings validated against the sub-spec
# ("[][]" = list of lists).
# ---------------------------------------------------------------------------

def _scalars(*names: str) -> Dict[str, Any]:
    return {n: None for n in names}


_INIT = {"type": None,
         "options": _scalars("constant", "scale_factor", "mean", "std")}

_OPTIMIZER = {
    "type": None,
    "options": _scalars("learning_rate", "eps", "lr_decay", "weight_decay",
                        "init_value", "beta_1", "beta_2", "amsgrad",
                        "momentum"),
}

_LAYER = {
    **_scalars("type", "input_dim", "output_dim", "offset", "bias",
               "activation"),
    "init": _INIT, "bias_init": _INIT, "optimizer": _OPTIMIZER,
    "options": _scalars("type", "aggregator", "num_heads", "average_heads",
                        "negative_slope", "input_dropout",
                        "attention_dropout"),
}

_NBR = {
    **_scalars("type", "use_incoming", "use_outgoing",
               "use_incoming_nbrs", "use_outgoing_nbrs",  # reference spelling
               "use_hashmap_sets"),
    "options": _scalars("max_neighbors", "rate"),
}

_NEG = _scalars("num_chunks", "negatives_per_positive", "degree_fraction",
                "filtered", "local_filter_mode")

# reference PipelineConfig (marius_config.py:672-686): sync/staleness_bound
# are honored; the thread/queue tuning knobs are compat-accepted (warned)
_PIPELINE = _scalars("sync", "staleness_bound", "gpu_sync_interval",
                     "gpu_model_average", "batch_host_queue_size",
                     "batch_device_queue_size", "gradients_device_queue_size",
                     "gradients_host_queue_size", "batch_loader_threads",
                     "batch_transfer_threads", "compute_threads",
                     "gradient_transfer_threads", "gradient_update_threads")

_STORAGE_TIER = {
    "type": None,
    "options": _scalars("dtype", "num_partitions", "buffer_capacity",
                        "edge_bucket_ordering", "node_partition_ordering",
                        "fine_to_coarse_ratio", "num_cache_partitions",
                        "randomly_assign_edge_buckets", "prefetching",
                        "sparse_writeback"),
}

SCHEMA: Dict[str, Any] = {
    "model": {
        **_scalars("learning_task", "random_seed"),
        "encoder": {
            **_scalars("hop_caps", "all_cap_limit", "full_graph",
                       "use_incoming_nbrs", "use_outgoing_nbrs",
                       "embedding_dim"),
            "layers[][]": _LAYER,
            "train_neighbor_sampling[]": _NBR,
            "eval_neighbor_sampling[]": _NBR,
        },
        "decoder": {**_scalars("type"),
                    "options": _scalars("input_dim", "inverse_edges",
                                        "edge_decoder_method",
                                        "use_relation_features"),
                    "optimizer": _OPTIMIZER},
        "loss": {"type": None, "options": _scalars("reduction", "margin")},
        "dense_optimizer": _OPTIMIZER,
        "sparse_optimizer": _OPTIMIZER,
    },
    "storage": {
        **_scalars("device_type", "device_ids", "model_dir", "save_model",
                   "export_encoded_nodes", "prefetching", "prefetch",
                   "shuffle_input", "full_graph_evaluation", "log_level",
                   "train_edges_pre_sorted"),
        "dataset": _scalars("dataset_dir", "num_edges", "num_nodes",
                            "num_relations", "num_train", "num_valid",
                            "num_test", "num_classes", "feature_dim",
                            "node_feature_dim", "rel_feature_dim",
                            "initialized"),
        "edges": _STORAGE_TIER,
        "nodes": _STORAGE_TIER,
        "embeddings": _STORAGE_TIER,
        "features": _STORAGE_TIER,
    },
    "training": {
        **_scalars("batch_size", "num_epochs", "epochs_per_shuffle",
                   "epochs_per_eval", "resume_training",
                   "resume_from_checkpoint", "seed", "save_model",
                   "logs_per_epoch"),
        "negative_sampling": _NEG,
        "pipeline": _PIPELINE,
        "checkpoint": _scalars("interval", "save_best", "save_state"),
        "mesh": _scalars("data", "node", "mode"),
    },
    "evaluation": {
        **_scalars("batch_size", "epochs_per_eval", "host_streaming",
                   "checkpoint_dir"),
        "negative_sampling": _NEG,
        "pipeline": _PIPELINE,
    },
}

# ---------------------------------------------------------------------------
# Reference-compat keys: valid in the reference's schema
# (tools/configuration/marius_config.py), accepted here so a reference user's
# YAML loads unchanged — but they have no effect in this runtime, so loading
# warns loudly. Keys that DO have an equivalent are silently mapped by
# load_config instead (random_seed -> training.seed, prefetch -> prefetching,
# node_feature_dim -> feature_dim, training.save_model -> storage.save_model,
# use_incoming_nbrs/use_outgoing_nbrs -> per-sampler defaults).
# ---------------------------------------------------------------------------

_PIPELINE_NOTE = ("host thread-pool tuning (PipelineConfig, marius_config.py:"
                  "672-686) does not apply: the epoch is one compiled XLA "
                  "program; 'sync' and 'staleness_bound' are the controls")

COMPAT_NOTES: Dict[str, str] = {
    "model.encoder.embedding_dim": "derived from the layer dims; ignored",
    "model.decoder.options.use_relation_features": (
        "relation features are not supported"),
    "model.encoder.*.use_hashmap_sets": (
        "CPU-sampler implementation detail (NeighborSamplingConfig); the "
        "device sampler has one dedup path"),
    "storage.device_ids": "device selection comes from training.mesh",
    "storage.nodes": (
        "node-id splits are always host-resident memory-maps; a nodes "
        "storage tier is not configurable"),
    "storage.shuffle_input": (
        "edges are shuffled on device every training.epochs_per_shuffle "
        "epochs; input-shuffle toggle is ignored"),
    "storage.full_graph_evaluation": (
        "evaluation always sees the full table (in HBM, or host-streamed "
        "with evaluation.host_streaming); the buffer-window eval mode does "
        "not exist"),
    "storage.train_edges_pre_sorted": "pre-sorted input is not required",
    "storage.dataset.rel_feature_dim": "relation features are not supported",
    "storage.dataset.initialized": "ignored bookkeeping flag",
    "training.logs_per_epoch": (
        "the epoch is one compiled scan; per-epoch stats are logged, "
        "intra-epoch log cadence is not tunable"),
    "training.pipeline.*": _PIPELINE_NOTE,
    "evaluation.pipeline.*": _PIPELINE_NOTE,
}


def _walk(raw, spec: Dict[str, Any], path: str, errors: List[str]) -> None:
    if raw is None:
        return
    if not isinstance(raw, dict):
        errors.append(f"{path or '<root>'}: expected a mapping, got "
                      f"{type(raw).__name__}")
        return
    allowed = {k.replace("[]", ""): (k.count("[]"), v) for k, v in spec.items()}
    for key, val in raw.items():
        here = f"{path}.{key}" if path else str(key)
        if key not in allowed:
            hint = difflib.get_close_matches(str(key), list(allowed), n=1)
            sugg = f" (did you mean '{hint[0]}'?)" if hint else ""
            errors.append(f"unknown config key '{here}'{sugg}")
            continue
        depth, sub = allowed[key]
        if sub is None:
            continue
        items = [val]
        for _ in range(depth):   # unwrap list-of(-list-of) entries
            nxt: List[Any] = []
            ok = True
            for it in items:
                if it is None:
                    continue
                if not isinstance(it, list):
                    errors.append(f"{here}: expected a list")
                    ok = False
                    break
                nxt.extend(it)
            if not ok:
                items = []
                break
            items = nxt
        for it in items:
            _walk(it, sub, here, errors)


def check_unknown_keys(raw: Dict[str, Any]) -> List[str]:
    errors: List[str] = []
    _walk(raw, SCHEMA, "", errors)
    return errors


def check_compat_keys(raw: Dict[str, Any]) -> List[str]:
    """Warnings for reference-schema keys that are accepted but inert here."""
    w: List[str] = []

    def note(path: str, key: str) -> None:
        w.append(f"config key '{path}' is accepted for reference "
                 f"compatibility but has no effect: {COMPAT_NOTES[key]}")

    m = raw.get("model") or {}
    enc = m.get("encoder") or {}
    if "embedding_dim" in enc:
        note("model.encoder.embedding_dim", "model.encoder.embedding_dim")
    if "use_relation_features" in ((m.get("decoder") or {}).get("options") or {}):
        note("model.decoder.options.use_relation_features",
             "model.decoder.options.use_relation_features")
    for field in ("train_neighbor_sampling", "eval_neighbor_sampling"):
        for i, entry in enumerate(enc.get(field) or []):
            if isinstance(entry, dict) and "use_hashmap_sets" in entry:
                note(f"model.encoder.{field}[{i}].use_hashmap_sets",
                     "model.encoder.*.use_hashmap_sets")
    s = raw.get("storage") or {}
    for key in ("device_ids", "nodes", "shuffle_input",
                "full_graph_evaluation", "train_edges_pre_sorted"):
        if key in s:
            note(f"storage.{key}", f"storage.{key}")
    ds = s.get("dataset") or {}
    for key in ("rel_feature_dim", "initialized"):
        if key in ds:
            note(f"storage.dataset.{key}", f"storage.dataset.{key}")

    t = raw.get("training") or {}
    if "logs_per_epoch" in t:
        note("training.logs_per_epoch", "training.logs_per_epoch")
    for section, sec_raw in (("training", t), ("evaluation",
                                               raw.get("evaluation") or {})):
        pipe = sec_raw.get("pipeline") or {}
        if isinstance(pipe, dict):
            for key in sorted(set(pipe) - {"sync", "staleness_bound"}):
                note(f"{section}.pipeline.{key}", f"{section}.pipeline.*")
    return w


# ---------------------------------------------------------------------------
# Value / cross-field checks
# ---------------------------------------------------------------------------

_ENUMS = {
    "learning_task": {"LINK_PREDICTION", "NODE_CLASSIFICATION"},
    "layer_type": {"EMBEDDING", "FEATURE", "GNN", "REDUCTION"},
    "gnn_type": {"GRAPH_SAGE", "GCN", "GAT", "RGCN"},
    "aggregator": {"GCN", "MEAN"},
    "activation": {"NONE", "RELU", "SIGMOID"},
    "decoder_type": {"DISTMULT", "COMPLEX", "TRANSE", "NODE"},
    # normalized EdgeDecoderMethod values (options.cpp:199-218; TRAIN/INFER
    # aliases normalize to CORRUPT_NODE/ONLY_POS at parse). POS_AND_NEG is
    # rejected with its own message (unsupported in the reference too,
    # model.cpp:266).
    "edge_decoder_method": {"CORRUPT_NODE", "CORRUPT_REL", "ONLY_POS"},
    "loss_type": {"SOFTMAX_CE", "RANKING", "CROSS_ENTROPY",
                  "BCE_AFTER_SIGMOID", "BCE_WITH_LOGITS", "MSE", "SOFTPLUS"},
    "loss_reduction": {"SUM", "MEAN"},
    "optimizer_type": {"SGD", "ADAGRAD", "ADAM"},
    "init_distribution": {"ZEROS", "ONES", "CONSTANT", "UNIFORM", "NORMAL",
                          "GLOROT_UNIFORM", "GLOROT_NORMAL"},
    "sampling_type": {"ALL", "UNIFORM", "DROPOUT"},
    "backend": {"DEVICE_MEMORY", "HOST_MEMORY", "PARTITION_BUFFER",
                "FLAT_FILE"},
    "edge_bucket_ordering": {"COMET", "BETA"},
    "node_partition_ordering": {"DISPERSED", "SEQUENTIAL"},
    "mesh_mode": {"auto", "gspmd", "explicit"},
    "local_filter_mode": {"DEG", "ALL", "NONE"},
    "embeddings_dtype": {"float", "float32", "double", "bfloat16", "bf16",
                         "float16"},
}


def _registered(kind: str, value: str) -> bool:
    """Custom names registered in a component registry are valid wherever
    the built-in names are; the port has no registry yet (it comes with
    nn/registry.py), so no custom name is registered."""
    return False


def _enum(errors: List[str], kind: str, value: str, path: str) -> None:
    if value not in _ENUMS[kind] and not _registered(kind, value):
        errors.append(f"{path}: '{value}' is not one of "
                      f"{sorted(_ENUMS[kind])} (or a registered custom name)")


def _positive(errors: List[str], value, path: str) -> None:
    if not isinstance(value, (int, float)) or value < 1:
        errors.append(f"{path}: must be >= 1, got {value!r}")


def check_config_values(cfg, unknown_decoder: Optional[str] = None) -> List[str]:
    """Cross-field checks on the parsed MariusConfig (marius_config.py
    __post_init__ analogue). ``unknown_decoder`` is the decoder type the
    loader could not build a decoder for."""
    e: List[str] = []
    _enum(e, "learning_task", cfg.learning_task, "model.learning_task")

    m = cfg.model
    n_gnn = 0
    has_emb_layer = m is not None and any(
        layer.layer_type.upper() == "EMBEDDING"
        for stage in m.encoder.stages for layer in stage)
    if m is not None:
        _enum(e, "loss_type", m.loss_type, "model.loss.type")
        _enum(e, "loss_reduction", m.loss_reduction,
              "model.loss.options.reduction")
        if isinstance(m.dense_optimizer, GroupedOptimizerConfig):
            _enum(e, "optimizer_type",
                  m.dense_optimizer.default.optimizer_type,
                  "model.dense_optimizer.type")
            for path, ocfg in m.dense_optimizer.overrides:
                _enum(e, "optimizer_type", ocfg.optimizer_type,
                      ".".join(str(k) for k in path) + ".optimizer.type")
        else:
            _enum(e, "optimizer_type", m.dense_optimizer.optimizer_type,
                  "model.dense_optimizer.type")
        if unknown_decoder is not None:
            _enum(e, "decoder_type", unknown_decoder, "model.decoder.type")
        if m.decoder is not None:
            _enum(e, "decoder_type", m.decoder.decoder_type,
                  "model.decoder.type")
            method = normalize_decoder_method(m.decoder.decoder_method)
            if method == "POS_AND_NEG":
                e.append("model.decoder.options.edge_decoder_method: "
                         "POS_AND_NEG is unsupported (the reference throws "
                         "at runtime too, model.cpp:266)")
            else:
                _enum(e, "edge_decoder_method", method,
                      "model.decoder.options.edge_decoder_method")
        for i, stage in enumerate(m.encoder.stages):
            for j, layer in enumerate(stage):
                p = f"model.encoder.layers[{i}][{j}]"
                _enum(e, "layer_type", layer.layer_type.upper(), f"{p}.type")
                _enum(e, "activation", layer.activation.upper(),
                      f"{p}.activation")
                _enum(e, "init_distribution", layer.init.distribution.upper(),
                      f"{p}.init.type")
                if layer.layer_type.upper() == "GNN":
                    _enum(e, "gnn_type", layer.gnn_type, f"{p}.options.type")
                    _enum(e, "aggregator", layer.aggregator,
                          f"{p}.options.aggregator")
            if any(l.layer_type.upper() == "GNN" for l in stage):
                n_gnn += 1
        for field, entries in (
                ("train_neighbor_sampling", cfg.train_neighbor_sampling),
                ("eval_neighbor_sampling", cfg.eval_neighbor_sampling)):
            if len(entries) != n_gnn:
                e.append(
                    f"model.encoder: {n_gnn} GNN stage(s) but "
                    f"{len(entries)} {field} "
                    f"entries — one entry per GNN stage is required")
        if cfg.hop_caps and len(cfg.hop_caps) != n_gnn + 1:
            e.append(f"model.encoder.hop_caps: expected {n_gnn + 1} entries "
                     f"(num GNN stages + 1), got {len(cfg.hop_caps)}")

    for nbr in list(cfg.train_neighbor_sampling) + list(cfg.eval_neighbor_sampling):
        _enum(e, "sampling_type", nbr.sampling_type.upper(),
              "model.encoder.*neighbor_sampling.type")
        _positive(e, nbr.max_neighbors,
                  "neighbor_sampling.options.max_neighbors")
        if not (0.0 <= nbr.rate < 1.0):
            e.append(f"neighbor_sampling.options.rate: must be in [0, 1), "
                     f"got {nbr.rate}")

    s = cfg.storage
    for name in ("edges_backend", "embeddings_backend", "features_backend"):
        _enum(e, "backend", getattr(s, name),
              f"storage.{name.split('_')[0]}.type")
    if s.edges_backend == "PARTITION_BUFFER":
        e.append("storage.edges.type: PARTITION_BUFFER applies to node tiers; "
                 "use DEVICE_MEMORY, HOST_MEMORY, or FLAT_FILE for edges")
    for name in ("embeddings_backend", "features_backend"):
        if getattr(s, name) == "FLAT_FILE":
            e.append(f"storage.{name.split('_')[0]}.type: FLAT_FILE is an "
                     "edge tier; node tiers use DEVICE_MEMORY, HOST_MEMORY, "
                     "or PARTITION_BUFFER")
    _enum(e, "edge_bucket_ordering", s.edge_bucket_ordering,
          "storage.embeddings.options.edge_bucket_ordering")
    _enum(e, "node_partition_ordering", s.node_partition_ordering,
          "storage.embeddings.options.node_partition_ordering")
    _enum(e, "embeddings_dtype", s.embeddings_dtype,
          "storage.embeddings.options.dtype")
    if "PARTITION_BUFFER" in (s.embeddings_backend, s.features_backend):
        if s.num_partitions < 2:
            e.append("storage.embeddings.options.num_partitions: partition "
                     "buffer needs >= 2 partitions")
        if s.buffer_capacity < 2:
            e.append("storage.embeddings.options.buffer_capacity: must be >= 2")
        if s.buffer_capacity > s.num_partitions:
            e.append(f"storage.embeddings.options.buffer_capacity "
                     f"({s.buffer_capacity}) exceeds num_partitions "
                     f"({s.num_partitions})")
        if s.num_cache_partitions >= s.buffer_capacity:
            e.append(f"storage.embeddings.options.num_cache_partitions "
                     f"({s.num_cache_partitions}) must be < buffer_capacity "
                     f"({s.buffer_capacity})")

    t = cfg.training
    _positive(e, t.batch_size, "training.batch_size")
    _positive(e, t.num_epochs, "training.num_epochs")
    _positive(e, t.epochs_per_shuffle, "training.epochs_per_shuffle")
    _positive(e, t.staleness_bound, "training.pipeline.staleness_bound")
    _positive(e, t.negative_sampling.num_chunks,
              "training.negative_sampling.num_chunks")
    _positive(e, t.negative_sampling.negatives_per_positive,
              "training.negative_sampling.negatives_per_positive")
    if not (0.0 <= t.negative_sampling.degree_fraction <= 1.0):
        e.append(f"training.negative_sampling.degree_fraction: must be in "
                 f"[0, 1], got {t.negative_sampling.degree_fraction}")
    _enum(e, "local_filter_mode",
          t.negative_sampling.local_filter_mode.upper(),
          "training.negative_sampling.local_filter_mode")
    if t.save_best and not cfg.storage.save_model:
        e.append("training.checkpoint.save_best requires storage.save_model: "
                 "true (save_best keeps the best-valid model in model_dir)")
    _enum(e, "mesh_mode", t.mesh_mode.lower(), "training.mesh.mode")
    if (t.mesh_mode == "explicit" and max(t.mesh_data, t.mesh_node) > 1
            and not has_emb_layer):
        e.append("training.mesh.mode: 'explicit' shards the embedding table "
                 "and requires an EMBEDDING layer; feature-only encoders "
                 "ride 'gspmd'")

    ev = cfg.evaluation
    _positive(e, ev.batch_size, "evaluation.batch_size")
    if ev.host_streaming and not ev.negative_sampling.filtered:
        e.append("evaluation.host_streaming requires "
                 "evaluation.negative_sampling.filtered: true (host-tiled "
                 "scoring is all-node filtered ranking)")
    return e


def validate(raw: Optional[Dict[str, Any]], cfg, unknown_decoder: Optional[str] = None) -> None:
    """Raise ConfigError listing every problem found (keys first); emit a
    warning per reference-compat key that is accepted but inert."""
    errors = check_unknown_keys(raw) if raw is not None else []
    errors += check_config_values(cfg, unknown_decoder)
    if errors:
        raise ConfigError(
            "Invalid configuration:\n  - " + "\n  - ".join(errors))
    if raw is not None:
        import warnings

        for msg in check_compat_keys(raw):
            warnings.warn(msg, UserWarning, stacklevel=3)
