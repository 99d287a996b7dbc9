"""YAML configuration schema and loader.

Port of ``marius_tpu/config/schema.py`` (:32-470): the same dataclasses,
defaults and YAML spellings, filled with the port's typed objects. It parses
every configuration the JAX loader parses (NC, PARTITION_BUFFER and mesh
configurations too); the manager refuses what is not ported yet.
``resolve_dtype`` returns torch dtypes. An unknown decoder type leaves
``model.decoder`` None and is reported by validation (the port's
``EdgeDecoder`` owns parameter tensors, so it cannot be built for an unknown
type); with ``validate=False`` it raises ``ValueError`` at load.

Parity with the reference's single-YAML config surface (tools/configuration/
marius_config.py, full schema in docs/config_interface/full_schema.rst): the
same section layout — model {encoder, decoder, loss, dense_optimizer,
sparse_optimizer}, storage {dataset, edges, embeddings, features}, training
{batch_size, negative_sampling, num_epochs, ...}, evaluation — parses into
plain dataclasses (no OmegaConf dependency) and converts into the framework's
typed objects (Model/EncoderConfig/NegativeSamplingConfig/...). The reference
embeds a Python interpreter in C++ just to parse YAML (config.cpp:502-527);
here config is ordinary Python.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import yaml

from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
from marius_tpu_torch.nn.decoders.edge import (
    EDGE_DECODER_TYPES,
    EdgeDecoder,
    normalize_decoder_method,
)
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.initialization import InitConfig
from marius_tpu_torch.nn.layers import LayerConfig
from marius_tpu_torch.nn.model import Model
from marius_tpu_torch.nn.optimizers import GroupedOptimizerConfig, OptimizerConfig


@dataclasses.dataclass
class DatasetConfig:
    dataset_dir: str = ""
    num_edges: int = -1
    num_nodes: int = -1
    num_relations: int = 1
    num_train: int = -1
    num_valid: int = -1
    num_test: int = -1
    num_classes: int = -1
    feature_dim: int = -1


@dataclasses.dataclass
class StorageConfig:
    device_type: str = "tpu"
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    edges_backend: str = "DEVICE_MEMORY"       # DEVICE_MEMORY | HOST_MEMORY | PARTITION_BUFFER
    embeddings_backend: str = "DEVICE_MEMORY"
    features_backend: str = "DEVICE_MEMORY"
    num_partitions: int = 1
    buffer_capacity: int = 8
    prefetching: bool = True
    edge_bucket_ordering: str = "COMET"     # COMET | BETA (options.h:72)
    node_partition_ordering: str = "DISPERSED"  # DISPERSED | SEQUENTIAL (:76)
    fine_to_coarse_ratio: int = 2
    num_cache_partitions: int = 0
    randomly_assign_edge_buckets: bool = True
    # dirty-row eviction writeback (exact; single-controller unsharded only)
    sparse_writeback: bool = True
    embeddings_dtype: str = "float"   # float | bfloat16 (StorageConfig dtype option)
    model_dir: str = ""
    save_model: bool = True
    export_encoded_nodes: bool = False   # StorageConfig (marius_config.py:525)
    log_level: str = "info"              # console log level (marius_config.py:527)


@dataclasses.dataclass
class TrainingConfig:
    batch_size: int = 1000
    negative_sampling: NegativeSamplingConfig = dataclasses.field(
        default_factory=NegativeSamplingConfig)
    num_epochs: int = 10
    epochs_per_shuffle: int = 1
    epochs_per_eval: int = 1
    sync: bool = True
    staleness_bound: int = 16       # async mode: batches sharing one table
                                    # snapshot (PipelineConfig, marius_config.py:675)
    checkpoint_interval: int = -1
    # keep the best-valid-metric model in model_dir instead of the last epoch
    # (CheckpointConfig.save_best, marius_config.py:650 — parsed but unused in
    # the reference; honored here)
    save_best: bool = False
    # include optimizer/Adagrad state in interval checkpoints
    # (CheckpointConfig.save_state gating, checkpointer.cpp:30)
    checkpoint_save_state: bool = True
    resume_training: bool = False
    resume_from_checkpoint: str = ""
    seed: int = 0
    # Multi-chip mesh (SURVEY §2.3 TPU north star; the reference's analogue
    # is multi-GPU data parallelism, model.cpp:136-159). data x node must
    # equal the number of devices used; -1 on either axis = fill with all
    # remaining devices. mesh_mode "gspmd" lets XLA infer collectives from
    # sharding annotations; "explicit" uses the hand-written shard_map step
    # (parallel/collectives.py, shallow encoders); "auto" (default) picks
    # explicit whenever the model supports it — GSPMD's inferred program
    # reshards the embedding gather/scatter across the node axis with ~20
    # collectives per batch vs explicit's 2 psums (measured 2-4x slower on
    # the 8-device mesh; see ROUND3_NOTES.md).
    mesh_data: int = 1
    mesh_node: int = 1
    mesh_mode: str = "auto"


@dataclasses.dataclass
class EvaluationConfig:
    batch_size: int = 1000
    negative_sampling: NegativeSamplingConfig = dataclasses.field(
        default_factory=lambda: NegativeSamplingConfig(filtered=True))
    epochs_per_eval: int = 1
    sync: bool = True
    # stream the raw table from host RAM through tiled device encoding and
    # scoring instead of materializing it in HBM (filtered LP eval only);
    # for tables larger than device memory (graph_storage.cpp:31-51 parity)
    host_streaming: bool = False
    # evaluate this checkpoint dir instead of storage.model_dir
    # (EvaluationConfig.checkpoint_dir, marius.cpp:81-84)
    checkpoint_dir: str = ""


def resolve_dtype(name: str):
    import torch
    return {"float": torch.float32, "float32": torch.float32, "double": torch.float32,
            "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float16": torch.float16}.get(name.lower(), torch.float32)


@dataclasses.dataclass
class MariusConfig:
    model: Model = None
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = dataclasses.field(default_factory=EvaluationConfig)
    train_neighbor_sampling: Tuple[NeighborSamplingConfig, ...] = ()
    eval_neighbor_sampling: Tuple[NeighborSamplingConfig, ...] = ()
    hop_caps: Tuple[int, ...] = ()   # optional static per-hop unique-node caps
    hop_caps_auto: bool = False      # `hop_caps: auto` — size caps empirically
                                     # from the graph (sampled fanouts only)
    all_cap_limit: int = 4096        # fanout ceiling for ALL sampling; hubs
                                     # above it truncate (loudly) to the cap
    full_graph: str = "AUTO"         # NC exact-ALL full-graph mode: AUTO
                                     # engages it when every hop is ALL, the
                                     # encoder is aggregation-style, and a
                                     # typical batch's k-hop frontier covers
                                     # most of the graph; ON forces, OFF never
    learning_task: str = "LINK_PREDICTION"


# ---------------------------------------------------------------------------
# YAML -> typed objects
# ---------------------------------------------------------------------------


def _init_config(d: Optional[Dict]) -> InitConfig:
    if not d:
        return InitConfig()
    opts = d.get("options") or {}
    return InitConfig(
        distribution=d.get("type", "GLOROT_UNIFORM"),
        constant=opts.get("constant", 0.0),
        scale_factor=opts.get("scale_factor", 0.001),
        mean=opts.get("mean", 0.0),
        std=opts.get("std", 1.0),
    )


def _layer_config(d: Dict, num_relations: int) -> LayerConfig:
    opts = d.get("options") or {}
    return LayerConfig(
        layer_type=d.get("type", "EMBEDDING").upper(),
        input_dim=int(d.get("input_dim", -1)),
        output_dim=int(d.get("output_dim", -1)),
        offset=int(d.get("offset", 0)),
        gnn_type=str(opts.get("type", "GRAPH_SAGE")).upper(),
        aggregator=str(opts.get("aggregator", "MEAN")).upper(),
        reduction=str(opts.get("type", "CONCAT")).upper()
        if d.get("type", "").upper() == "REDUCTION" else "CONCAT",
        bias=bool(d.get("bias", False)),
        activation=str(d.get("activation", "NONE")).upper(),
        init=_init_config(d.get("init")),
        bias_init=_init_config(d.get("bias_init") or {"type": "ZEROS"}),
        num_heads=int(opts.get("num_heads", 10)),
        average_heads=bool(opts.get("average_heads", True)),
        negative_slope=float(opts.get("negative_slope", 0.2)),
        input_dropout=float(opts.get("input_dropout", 0.0)),
        attention_dropout=float(opts.get("attention_dropout", 0.0)),
        num_relations=max(num_relations, 1),
    )


def _neighbor_sampling(entries: Optional[List[Dict]],
                       default_incoming: bool = True,
                       default_outgoing: bool = True,
                       ) -> Tuple[NeighborSamplingConfig, ...]:
    if not entries:
        return ()
    out = []
    for e in entries:
        opts = e.get("options") or {}
        out.append(NeighborSamplingConfig(
            sampling_type=str(e.get("type", "UNIFORM")).upper(),
            max_neighbors=int(opts.get("max_neighbors", 10)),
            rate=float(opts.get("rate", 0.0)),
            # use_incoming_nbrs/use_outgoing_nbrs are the reference's
            # per-sampler spellings (marius_config.py:272-276)
            use_incoming=bool(e.get("use_incoming",
                                    e.get("use_incoming_nbrs", default_incoming))),
            use_outgoing=bool(e.get("use_outgoing",
                                    e.get("use_outgoing_nbrs", default_outgoing))),
        ))
    return tuple(out)


def _optimizer(d: Optional[Dict], default_type: str = "ADAGRAD") -> OptimizerConfig:
    if not d:
        return OptimizerConfig(default_type)
    opts = d.get("options") or {}
    return OptimizerConfig(
        optimizer_type=str(d.get("type", default_type)).upper(),
        learning_rate=float(opts.get("learning_rate", 0.1)),
        eps=float(opts.get("eps", 1e-10)),
        lr_decay=float(opts.get("lr_decay", 0.0)),
        weight_decay=float(opts.get("weight_decay", 0.0)),
        init_value=float(opts.get("init_value", 0.0)),
        beta_1=float(opts.get("beta_1", 0.9)),
        beta_2=float(opts.get("beta_2", 0.999)),
        adam_eps=float(opts.get("eps", 1e-8)) if str(d.get("type", "")).upper() == "ADAM" else 1e-8,
        amsgrad=bool(opts.get("amsgrad", False)),
        momentum=float(opts.get("momentum", 0.0)),
    )


def _negative_sampling(d: Optional[Dict]) -> NegativeSamplingConfig:
    if not d:
        return NegativeSamplingConfig()
    return NegativeSamplingConfig(
        num_chunks=int(d.get("num_chunks", 10)),
        negatives_per_positive=int(d.get("negatives_per_positive", 500)),
        degree_fraction=float(d.get("degree_fraction", 0.0)),
        filtered=bool(d.get("filtered", False)),
        local_filter_mode=str(d.get("local_filter_mode", "DEG")).upper(),
    )


def _hop_caps_auto_flag(raw) -> bool:
    if not isinstance(raw, str):
        return False
    if raw.lower() != "auto":
        raise ValueError(
            f"model.encoder.hop_caps: unknown string {raw!r} — expected "
            f"'auto' or a list of per-hop integer caps")
    return True


def _next_model_dir(dataset_dir: str) -> str:
    """First free <dataset_dir>/model_0..model_10 so repeated runs don't
    silently overwrite earlier models; saturates at model_10
    (get_model_dir_path, marius_config.py:47-56)."""
    for i in range(11):
        cand = os.path.join(dataset_dir, f"model_{i}")
        if not os.path.exists(cand):
            return cand
    return cand


def load_config(path_or_dict, model_dir: Optional[str] = None,
                validate: bool = True) -> MariusConfig:
    """Parse a marius-style YAML file (or pre-parsed dict) into MariusConfig.

    With ``validate`` (default), unknown keys and invalid/inconsistent values
    raise ConfigError with the dotted path and a did-you-mean suggestion
    (marius_config.py:836 type_safe_merge + __post_init__ parity)."""
    if isinstance(path_or_dict, (str, os.PathLike)):
        with open(path_or_dict) as f:
            raw = yaml.safe_load(f)
        base_dir = os.path.dirname(os.path.abspath(path_or_dict))
    else:
        raw = dict(path_or_dict)
        base_dir = os.getcwd()

    m = raw.get("model") or {}
    s = raw.get("storage") or {}
    t = raw.get("training") or {}
    ev = raw.get("evaluation") or {}

    learning_task = str(m.get("learning_task", "LINK_PREDICTION")).upper()

    ds_raw = (s.get("dataset") or {})
    dataset = DatasetConfig(
        dataset_dir=ds_raw.get("dataset_dir", ""),
        num_edges=int(ds_raw.get("num_edges", -1)),
        num_nodes=int(ds_raw.get("num_nodes", -1)),
        num_relations=int(ds_raw.get("num_relations", 1)),
        num_train=int(ds_raw.get("num_train", -1)),
        num_valid=int(ds_raw.get("num_valid", -1)),
        num_test=int(ds_raw.get("num_test", -1)),
        num_classes=int(ds_raw.get("num_classes", -1)),
        feature_dim=int(ds_raw.get("feature_dim",
                                   ds_raw.get("node_feature_dim", -1))),
    )
    # dataset stats autoload from dataset.yaml (marius_config.py:899 load_config)
    if dataset.dataset_dir:
        ds_dir = dataset.dataset_dir
        if not os.path.isabs(ds_dir):
            ds_dir = os.path.join(base_dir, ds_dir)
        stats_path = os.path.join(ds_dir, "dataset.yaml")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                stats = yaml.safe_load(f) or {}
            for field in ("num_edges", "num_nodes", "num_relations", "num_train",
                          "num_valid", "num_test", "num_classes", "feature_dim"):
                if field in stats and getattr(dataset, field) in (-1, 1):
                    setattr(dataset, field, int(stats[field]))
        dataset.dataset_dir = ds_dir

    num_relations = max(dataset.num_relations, 1)

    enc_raw = m.get("encoder") or {}
    stage_list = enc_raw.get("layers") or []
    stages = tuple(tuple(_layer_config(l, num_relations) for l in stage)
                   for stage in stage_list)
    encoder = EncoderConfig(stages=stages)

    dec_raw = m.get("decoder") or {}
    dec_type = str(dec_raw.get("type", "DISTMULT")).upper()
    dec_opts = dec_raw.get("options") or {}
    decoder = None
    unknown_decoder = None
    if (learning_task == "LINK_PREDICTION" and validate
            and dec_type not in EDGE_DECODER_TYPES):
        unknown_decoder = dec_type
    elif learning_task == "LINK_PREDICTION":
        decoder = EdgeDecoder(
            decoder_type=dec_type,
            num_relations=num_relations,
            embedding_dim=int(dec_opts.get(
                "input_dim", encoder.output_dim if stages else -1)),
            use_inverse_relations=bool(dec_opts.get("inverse_edges", True)),
            # EdgeDecoderMethod (options.h:64, parsed options.cpp:199-218
            # incl. TRAIN/INFER aliases; config key datatypes.py:152)
            decoder_method=normalize_decoder_method(
                dec_opts.get("edge_decoder_method", "CORRUPT_NODE")),
        )

    loss_raw = m.get("loss") or {}
    loss_opts = loss_raw.get("options") or {}
    sparse_opt = _optimizer(m.get("sparse_optimizer"), "ADAGRAD")

    # per-layer / per-decoder optimizers (setup_optimizers,
    # nn/model.cpp:161-218): a layer's own `optimizer:` block overrides the
    # model-level dense optimizer for that layer's params
    dense_opt = _optimizer(m.get("dense_optimizer"), "ADAM")
    overrides = []
    for i, stage in enumerate(stage_list):
        for j, layer_raw in enumerate(stage or []):
            if isinstance(layer_raw, dict) and layer_raw.get("optimizer"):
                overrides.append((("encoder", i, j), _optimizer(
                    layer_raw["optimizer"], dense_opt.optimizer_type)))
    if dec_raw.get("optimizer"):
        overrides.append((("decoder",), _optimizer(
            dec_raw["optimizer"], dense_opt.optimizer_type)))
    if overrides:
        dense_opt = GroupedOptimizerConfig(default=dense_opt,
                                           overrides=tuple(overrides))

    model = Model(
        learning_task=learning_task,
        encoder=encoder,
        decoder=decoder,
        loss_type=str(loss_raw.get("type", "SOFTMAX_CE")).upper(),
        loss_reduction=str(loss_opts.get("reduction", "MEAN")).upper(),
        loss_margin=float(loss_opts.get("margin", 0.1)),
        dense_optimizer=dense_opt,
        sparse_lr=sparse_opt.learning_rate,
    )

    storage = StorageConfig(
        device_type=str(s.get("device_type", "tpu")),
        dataset=dataset,
        edges_backend=str((s.get("edges") or {}).get("type", "DEVICE_MEMORY")).upper(),
        embeddings_backend=str((s.get("embeddings") or {}).get("type", "DEVICE_MEMORY")).upper(),
        features_backend=str((s.get("features") or {}).get("type", "DEVICE_MEMORY")).upper(),
        num_partitions=int(((s.get("embeddings") or {}).get("options") or {}).get("num_partitions", 1)),
        buffer_capacity=int(((s.get("embeddings") or {}).get("options") or {}).get("buffer_capacity", 8)),
        edge_bucket_ordering=str(((s.get("embeddings") or {}).get("options") or {})
                                 .get("edge_bucket_ordering", "COMET")).upper(),
        node_partition_ordering=str(((s.get("embeddings") or {}).get("options") or {})
                                    .get("node_partition_ordering", "DISPERSED")).upper(),
        fine_to_coarse_ratio=int(((s.get("embeddings") or {}).get("options") or {})
                                 .get("fine_to_coarse_ratio", 2)),
        num_cache_partitions=int(((s.get("embeddings") or {}).get("options") or {})
                                 .get("num_cache_partitions", 0)),
        randomly_assign_edge_buckets=bool(((s.get("embeddings") or {}).get("options") or {})
                                          .get("randomly_assign_edge_buckets", True)),
        sparse_writeback=bool(((s.get("embeddings") or {}).get("options") or {})
                              .get("sparse_writeback", True)),
        # compute dtype: embeddings tier's dtype, falling back to the
        # features tier's for feature-only (NC) models
        embeddings_dtype=str(((s.get("embeddings") or {}).get("options") or {})
                             .get("dtype",
                                  ((s.get("features") or {}).get("options")
                                   or {}).get("dtype", "float"))).lower(),
        model_dir=model_dir or s.get("model_dir", "") or
        (_next_model_dir(dataset.dataset_dir) if dataset.dataset_dir else ""),
        # training.save_model and storage.prefetch are the reference's
        # spellings (marius_config.py:732, :522)
        save_model=bool(s.get("save_model", t.get("save_model", True))),
        export_encoded_nodes=bool(s.get("export_encoded_nodes", False)),
        prefetching=bool(s.get("prefetching", s.get("prefetch", True))),
        log_level=str(s.get("log_level", "info")).lower(),
    )

    training = TrainingConfig(
        batch_size=int(t.get("batch_size", 1000)),
        negative_sampling=_negative_sampling(t.get("negative_sampling")),
        num_epochs=int(t.get("num_epochs", 10)),
        epochs_per_shuffle=int(t.get("epochs_per_shuffle", 1)),
        # evaluation.epochs_per_eval is the reference's placement
        # (EvaluationConfig, marius_config.py:781); training-level wins
        epochs_per_eval=int(t.get("epochs_per_eval",
                                  ev.get("epochs_per_eval", 1))),
        sync=bool((t.get("pipeline") or {}).get("sync", True)),
        staleness_bound=int((t.get("pipeline") or {}).get("staleness_bound", 16)),
        checkpoint_interval=int((t.get("checkpoint") or {}).get("interval", -1)),
        save_best=bool((t.get("checkpoint") or {}).get("save_best", False)),
        checkpoint_save_state=bool((t.get("checkpoint") or {}).get("save_state", True)),
        resume_training=bool(t.get("resume_training", False)),
        resume_from_checkpoint=str(t.get("resume_from_checkpoint", "")),
        # model.random_seed is the reference's spelling (marius_config.py:346)
        seed=int(t.get("seed", m.get("random_seed", 0))),
        mesh_data=int((t.get("mesh") or {}).get("data", 1)),
        mesh_node=int((t.get("mesh") or {}).get("node", 1)),
        mesh_mode=str((t.get("mesh") or {}).get("mode", "gspmd")).lower(),
    )

    evaluation = EvaluationConfig(
        batch_size=int(ev.get("batch_size", 1000)),
        negative_sampling=_negative_sampling(
            ev.get("negative_sampling") or {"filtered": True}),
        epochs_per_eval=int(ev.get("epochs_per_eval", 1)),
        sync=bool((ev.get("pipeline") or {}).get("sync", True)),
        host_streaming=bool(ev.get("host_streaming", False)),
        checkpoint_dir=str(ev.get("checkpoint_dir", "")),
    )

    cfg = MariusConfig(
        model=model,
        storage=storage,
        training=training,
        evaluation=evaluation,
        # encoder-level direction toggles are the reference's spelling
        # (EncoderConfig.use_incoming_nbrs/use_outgoing_nbrs,
        # marius_config.py:259-260); per-sampler keys override them
        train_neighbor_sampling=_neighbor_sampling(
            enc_raw.get("train_neighbor_sampling"),
            default_incoming=bool(enc_raw.get("use_incoming_nbrs", True)),
            default_outgoing=bool(enc_raw.get("use_outgoing_nbrs", True))),
        eval_neighbor_sampling=_neighbor_sampling(
            enc_raw.get("eval_neighbor_sampling") or enc_raw.get("train_neighbor_sampling"),
            default_incoming=bool(enc_raw.get("use_incoming_nbrs", True)),
            default_outgoing=bool(enc_raw.get("use_outgoing_nbrs", True))),
        hop_caps=(() if isinstance(enc_raw.get("hop_caps"), str)
                  else tuple(int(x) for x in (enc_raw.get("hop_caps") or []))),
        hop_caps_auto=_hop_caps_auto_flag(enc_raw.get("hop_caps")),
        all_cap_limit=int(enc_raw.get("all_cap_limit", 4096)),
        full_graph=str(enc_raw.get("full_graph", "AUTO")).upper(),
        learning_task=learning_task,
    )
    if validate:
        from marius_tpu_torch.config.validate import validate as _validate
        _validate(raw, cfg, unknown_decoder=unknown_decoder)
    return cfg
