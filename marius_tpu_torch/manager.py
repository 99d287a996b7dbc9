"""Manager: config -> dataset -> trainer/evaluators -> epoch loop -> checkpoints.

Port of the link-prediction path of ``marius_tpu/manager.py`` (reference
src/cpp/src/marius.cpp): ``marius_init`` (:114-259, :429-476) builds the
trainer and the valid/test evaluators from one config, with DEVICE_MEMORY
embeddings and edges, and restores a checkpoint for resume or evaluation;
``marius_train`` (:479-554) runs the epoch loop with the eval cadence,
save_best, interval checkpoints and the final test evaluation and save;
``marius_eval`` (:557-567) evaluates a trained model; ``encode_and_export``
(:570-598) writes a shallow encoder's outputs.

Every entry point takes ``device``: None means the GPU (and raises without
one), ``"cpu"`` runs the plain versions of the kernels. What is not ported
yet raises ``NotImplementedError`` naming the slice that brings it: node
classification, PARTITION_BUFFER embeddings, HOST_MEMORY and
FLAT_FILE edges, meshes, neighbour sampling and FEATURE encoders,
host-streamed evaluation, per-layer optimizers and bf16 tables.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import yaml

from marius_tpu_torch.config.schema import MariusConfig, load_config, resolve_dtype
from marius_tpu_torch.convert import copy_train_state_
from marius_tpu_torch.nn.model import LINK_PREDICTION, NODE_CLASSIFICATION
from marius_tpu_torch.nn.optimizers import GroupedOptimizerConfig
from marius_tpu_torch.ops.edge_keys import build_edge_key_set
from marius_tpu_torch.reporting.logger import get_logger
from marius_tpu_torch.storage import checkpoint as ckpt
from marius_tpu_torch.storage.dataset import load_split, load_stats
from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
from marius_tpu_torch.train.graph_encoder import encode_all_nodes
from marius_tpu_torch.train.trainer import LinkPredictionTrainer, _later_slice, resolve_device


@dataclasses.dataclass
class MariusRuntime:
    """Everything marius_init builds (marius.cpp:38-103 returns the
    model/storage/dataloader tuple; here one object)."""

    config: MariusConfig
    trainer: Any
    valid_evaluator: Optional[Any]
    test_evaluator: Optional[Any]
    epochs_processed: int = 0

    @property
    def state(self):
        return self.trainer.state

    @state.setter
    def state(self, s):
        self.trainer.state = s


def _load_lp_data(cfg: MariusConfig):
    ds = cfg.storage.dataset
    stats = None
    if ds.dataset_dir and os.path.exists(os.path.join(ds.dataset_dir, "dataset.yaml")):
        stats = load_stats(ds.dataset_dir)
    train = load_split(ds.dataset_dir, "train", stats)
    valid = test = None
    try:
        valid = load_split(ds.dataset_dir, "valid", stats)
    except FileNotFoundError:
        pass
    try:
        test = load_split(ds.dataset_dir, "test", stats)
    except FileNotFoundError:
        pass
    return train, valid, test


def _refuse_unported(cfg: MariusConfig) -> None:
    """Raise for every part of ``cfg`` the port does not run yet."""
    s, t, model = cfg.storage, cfg.training, cfg.model
    if cfg.learning_task == NODE_CLASSIFICATION:
        raise _later_slice("the node-classification manager path", "the sampled NC slice (A10)")
    if cfg.learning_task != LINK_PREDICTION:
        raise ValueError(f"Unknown learning task: {cfg.learning_task}")
    if t.mesh_data not in (0, 1) or t.mesh_node not in (0, 1):
        raise _later_slice("mesh training", "the multi-GPU slice")
    if s.embeddings_backend == "PARTITION_BUFFER":
        raise _later_slice("PARTITION_BUFFER embeddings", "the out-of-core LP slice (A9)")
    if s.edges_backend != "DEVICE_MEMORY":
        raise _later_slice(f"{s.edges_backend} edges", "the out-of-core LP slice (A9)")
    if cfg.evaluation.host_streaming:
        raise _later_slice("evaluation.host_streaming", "the out-of-core LP slice (A9)")
    if (cfg.train_neighbor_sampling or model.encoder.num_gnn_stages
            or model.encoder.has_features):
        raise _later_slice("neighbour sampling and GNN or FEATURE encoders",
                           "the sampled-GNN LP slice")
    if isinstance(model.dense_optimizer, GroupedOptimizerConfig):
        raise _later_slice("per-layer and per-decoder optimizers (GroupedOptimizerConfig)",
                           "a later slice")
    if resolve_dtype(s.embeddings_dtype) != torch.float32:
        raise _later_slice(f"{s.embeddings_dtype} embeddings", "the bf16 slice")


def marius_init(cfg: MariusConfig, train: bool = True, device=None) -> MariusRuntime:
    _refuse_unported(cfg)
    dev = resolve_device(device)
    log = get_logger(cfg.storage.model_dir or None, console_level=cfg.storage.log_level)
    ds = cfg.storage.dataset
    model = cfg.model

    train_edges, valid_edges, test_edges = _load_lp_data(cfg)
    num_nodes, num_rels = ds.num_nodes, max(ds.num_relations, 1)
    log.info("Loaded dataset: %d nodes, %d relations, %d train edges",
             num_nodes, num_rels, len(train_edges))

    train_filter = None
    if cfg.training.negative_sampling.filtered:
        train_filter = (build_edge_key_set(train_edges, True, dev),
                        build_edge_key_set(train_edges, False, dev))

    # Async pipeline mapping (PipelineTrainer, trainer.cpp:35-74): K
    # staleness-bound batches read ONE table snapshot and their updates
    # merge — a K-times-larger step with K-times the negative chunks,
    # preserving each sub-batch's chunk structure.
    batch_size = cfg.training.batch_size
    neg = cfg.training.negative_sampling
    if not cfg.training.sync and cfg.training.staleness_bound > 1:
        k = cfg.training.staleness_bound
        batch_size *= k
        neg = dataclasses.replace(neg, num_chunks=neg.num_chunks * k)
        if model.loss_reduction.upper() == "MEAN":
            # the merged step applies the SUM of the K sub-batch
            # mean-gradients (K reference steps at one snapshot)
            model = dataclasses.replace(model, loss_scale=float(k))
        log.info("Async pipeline: staleness_bound=%d -> step of %d edges", k, batch_size)

    trainer = LinkPredictionTrainer(
        model, num_nodes, num_rels, train_edges, neg,
        batch_size=batch_size,
        seed=cfg.training.seed,
        train_filter_keys=train_filter,
        edges_backend=cfg.storage.edges_backend,
        epochs_per_shuffle=cfg.training.epochs_per_shuffle,
        device=dev,
    )

    all_edges = np.concatenate(
        [train_edges] + [e for e in (valid_edges, test_edges) if e is not None], axis=0)

    def make_eval(edges):
        if edges is None or len(edges) == 0:
            return None
        return LinkPredictionEvaluator(
            model, num_nodes, num_rels, edges,
            all_edges=all_edges,
            batch_size=cfg.evaluation.batch_size,
            filtered=cfg.evaluation.negative_sampling.filtered,
            neg_config=cfg.evaluation.negative_sampling,
            device=dev,
        )

    rt = MariusRuntime(cfg, trainer, make_eval(valid_edges), make_eval(test_edges))

    # resume (marius.cpp:59-76)
    t = cfg.training
    if train and (t.resume_training or t.resume_from_checkpoint):
        path = t.resume_from_checkpoint or cfg.storage.model_dir
        meta = _restore(rt, path)
        rt.epochs_processed = int(meta.get("epochs_processed", 0))
        log.info("Resumed from %s at epoch %d", path, rt.epochs_processed)
        if meta.get("missing_leaves"):
            log.warning("Checkpoint %s was saved with save_state=false: "
                        "optimizer state restarts fresh (%d leaves)", path,
                        len(meta["missing_leaves"]))
    elif not train:
        # evaluation.checkpoint_dir overrides model_dir (marius.cpp:81-84)
        model_dir = cfg.evaluation.checkpoint_dir or cfg.storage.model_dir
        if model_dir and not cfg.evaluation.checkpoint_dir \
                and not os.path.exists(os.path.join(model_dir, "meta.yaml")):
            # an auto-versioned model_dir (schema._next_model_dir) names the
            # next FREE model_<i>; evaluate the highest-index sibling holding
            # a trained model instead. Never applied to an explicit
            # checkpoint_dir: a typo there must fail loudly.
            base = os.path.dirname(model_dir)
            tail = os.path.basename(model_dir)
            if tail.startswith("model_") and tail[6:].isdigit():
                best = None
                for i in range(11):
                    cand = os.path.join(base, f"model_{i}")
                    if os.path.exists(os.path.join(cand, "meta.yaml")):
                        best = cand
                if best is not None:
                    log.info(
                        "storage.model_dir %s holds no trained model; "
                        "evaluating the latest sibling %s instead (set "
                        "evaluation.checkpoint_dir to pin an exact model)",
                        model_dir, best)
                    model_dir = best
        if model_dir and os.path.exists(os.path.join(model_dir, "meta.yaml")):
            meta = _restore(rt, model_dir)
            rt.epochs_processed = int(meta.get("epochs_processed", 0))
            log.info("Loaded trained model from %s", model_dir)
    return rt


def _restore(rt: MariusRuntime, path: str) -> Dict[str, Any]:
    """Load the checkpoint at ``path`` into the trainer's own tensors (the
    decoder's relation tables are its module's parameters)."""
    state, meta = ckpt.load_state(path, rt.trainer.state)
    copy_train_state_(rt.trainer.state, state)
    return meta


def marius_train(config, model_dir: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Full config-driven training (marius_train, marius.cpp:105-163)."""
    cfg = config if isinstance(config, MariusConfig) else load_config(config, model_dir)
    device = resolve_device(device)   # before the logger creates <model_dir>/logs
    log = get_logger(cfg.storage.model_dir or None)
    rt = marius_init(cfg, train=True, device=device)
    t = cfg.training

    epoch_stats: List[Dict[str, float]] = []
    eval_stats: List[Dict[str, float]] = []
    best_metric: Optional[float] = None   # training.checkpoint.save_best
    if t.save_best and cfg.storage.model_dir:
        # resume: a previously saved best must not be overwritten by a
        # worse first post-resume validation
        meta_path = os.path.join(cfg.storage.model_dir, "meta.yaml")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                prev_meta = yaml.safe_load(f) or {}
            if prev_meta.get("best_valid_metric") is not None:
                best_metric = float(prev_meta["best_valid_metric"])
                log.info("save_best: previous best valid metric %.5f in %s",
                         best_metric, cfg.storage.model_dir)
    for epoch in range(rt.epochs_processed, t.num_epochs):
        stats = rt.trainer.train_epoch()
        rt.epochs_processed = epoch + 1
        epoch_stats.append(stats)
        log.info("Epoch %d: loss=%.4f time=%.3fs edges_per_sec=%.0f", epoch + 1,
                 stats["loss"], stats["epoch_time_s"], stats["edges_per_sec"])

        if rt.valid_evaluator is not None and (epoch + 1) % max(t.epochs_per_eval, 1) == 0:
            res = rt.valid_evaluator.evaluate(rt.trainer.state)
            res["split"] = "valid"
            res["epoch"] = epoch + 1
            eval_stats.append(res)
            # save_best: keep the best-valid-MRR model in model_dir
            metric = res.get("mrr")
            if (t.save_best and cfg.storage.model_dir and metric is not None
                    and (best_metric is None or metric > best_metric)):
                best_metric = float(metric)
                ckpt.save_state(cfg.storage.model_dir, rt.trainer.state,
                                metadata={**_meta(rt), "best_valid_metric": best_metric})
                log.info("New best valid metric %.5f at epoch %d — saved",
                         best_metric, epoch + 1)

        if t.checkpoint_interval > 0 and (epoch + 1) % t.checkpoint_interval == 0 \
                and cfg.storage.model_dir:
            ckpt.create_checkpoint(cfg.storage.model_dir, rt.trainer.state, epoch + 1,
                                   metadata=_meta(rt),
                                   save_optim_state=t.checkpoint_save_state)
            log.info("Checkpoint at epoch %d", epoch + 1)

    # with save_best, final metrics come from the best saved model, not the
    # last epoch's
    if best_metric is not None:
        _restore(rt, cfg.storage.model_dir)
        log.info("save_best: restored best model (valid metric %.5f) for "
                 "final evaluation", best_metric)

    final: Dict[str, Any] = {"epochs": epoch_stats, "evals": eval_stats}
    if rt.test_evaluator is not None:
        res = rt.test_evaluator.evaluate(rt.trainer.state)
        res["split"] = "test"
        final["test"] = res

    if cfg.storage.save_model and cfg.storage.model_dir and best_metric is None:
        os.makedirs(cfg.storage.model_dir, exist_ok=True)
        ckpt.save_state(cfg.storage.model_dir, rt.trainer.state, metadata=_meta(rt))
        log.info("Saved model to %s", cfg.storage.model_dir)
    if cfg.storage.export_encoded_nodes:
        # encode_and_export (marius.cpp:159-162)
        encode_and_export(rt)
        log.info("Exported encoded nodes")
    final["runtime"] = rt
    return final


def marius_eval(config, model_dir: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Evaluate a trained model (marius_eval, marius.cpp:165-185)."""
    cfg = config if isinstance(config, MariusConfig) else load_config(config, model_dir)
    rt = marius_init(cfg, train=False, device=device)
    out: Dict[str, Any] = {}
    if rt.test_evaluator is not None:
        out["test"] = rt.test_evaluator.evaluate(rt.trainer.state)
    elif rt.valid_evaluator is not None:
        out["valid"] = rt.valid_evaluator.evaluate(rt.trainer.state)
    out["runtime"] = rt
    return out


def encode_and_export(rt: MariusRuntime, path: Optional[str] = None) -> np.ndarray:
    """Encoder outputs for every node to <model_dir>/encoded_nodes.bin
    (encode_and_export, marius.cpp:13-36)."""
    state = rt.trainer.state
    table_values = state.table.values if state.table is not None else None
    encoded = encode_all_nodes(rt.config.model, state.params, table_values)
    encoded = encoded.detach().cpu().numpy()
    out = path or (os.path.join(rt.config.storage.model_dir, "encoded_nodes.bin")
                   if rt.config.storage.model_dir else None)
    if out:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        encoded.astype(np.float32).tofile(out)
    return encoded


def _meta(rt: MariusRuntime) -> Dict[str, Any]:
    return {
        "epochs_processed": rt.epochs_processed,
        "learning_task": rt.config.learning_task,
        "timestamp": time.time(),
    }
