"""Manager: config -> dataset -> trainer/evaluators -> epoch loop -> checkpoints.

Port of ``marius_tpu/manager.py`` (reference src/cpp/src/marius.cpp):
``marius_init`` (:114-476) builds the trainer and the valid/test evaluators
from one config and restores a checkpoint for resume or evaluation.

- Link prediction (:129-258): embeddings in DEVICE_MEMORY train with
  ``LinkPredictionTrainer`` (edges in DEVICE_MEMORY, or streamed from host
  RAM or a memory-mapped FLAT_FILE), PARTITION_BUFFER embeddings with
  ``PartitionBufferLPTrainer``; ``evaluation.host_streaming`` evaluates from
  the host table in node tiles (``_HostStreamLPEval``). Encoders may have
  GNN stages (GraphSAGE, GCN, GAT, RGCN; neighbour sampling over the train
  graph, ALL fanouts sized to its degrees) and FEATURE stages (the dataset's
  features); evaluation encodes every node through the sampler, or in one
  exact full-graph pass when every eval hop samples ALL (with the relational
  companion for RGCN).
- Node classification (:261-425), features and embeddings in DEVICE_MEMORY:
  configs whose every hop samples ALL go to the full-graph trainer where a
  batch's frontier would cover a sizable share of the graph, the others to
  the sampled trainer, with ``hop_caps``, ``hop_caps: auto``
  (``estimate_hop_caps_empirical``) or worst-case caps. An RGCN encoder's
  full-graph adjacency carries the relational companion. PARTITION_BUFFER
  features or embeddings (:271-279, :326-329, :350-375) go to
  ``PartitionBufferNCTrainer``: no device graph, ALL fanouts sized from the
  host edges, the features file mapped read-only (the cache reads each
  partition from it as it is admitted), and evaluators that run its
  buffer states (``_BufferNCEval``).

``marius_train`` (:479-554) runs the epoch loop with the eval cadence,
save_best (MRR for LP, accuracy for NC), interval checkpoints and the final
test evaluation and save; ``marius_eval`` (:557-567) evaluates a trained
model; ``encode_and_export`` (:570-598) writes every node's encoder output.

Every entry point takes ``device``: None means the GPU (and raises without
one), ``"cpu"`` runs the plain versions of the kernels. Per-layer and
per-decoder ``optimizer:`` blocks build a ``GroupedOptimizerConfig``, which
every trainer applies. ``model.decoder.options.edge_decoder_method:
CORRUPT_REL`` trains and ranks relations in both LP trainers.
``storage.embeddings.options.dtype: bfloat16`` reaches the trainers the JAX
manager passes ``dtype`` to (:179, :199, :409): ``LinkPredictionTrainer``
(the table and the parameters), ``PartitionBufferLPTrainer`` (the buffer)
and ``NodeClassificationTrainer`` (features, parameters and table); the
out-of-core NC trainer takes no dtype, as in JAX, and trains in float32.

``training.mesh`` (``_build_mesh``, JAX :84-96) lays the ranks of the
process group (``parallel/multihost.py``; the commands join it from
``MARIUS_COORDINATOR``) out as a (data x node) mesh: in-memory link
prediction runs the explicit sharded step (every case, CORRUPT_REL,
FEATURE-only encoders and batches the data axis does not divide among
them), the partition buffer its node-sharded device buffer, and node
classification data parallelism (JAX :293-300: a mesh with more than one
non-trivial axis, or an EMBEDDING stage, never takes the full-graph route;
ALL fanouts with a LINEAR-collapsible encoder take the collapse; sampled
configs the sampled step; PARTITION_BUFFER configs the out-of-core trainer's
data-parallel step over a replicated feature cache). The evaluators see the
whole model, and rank 0
writes checkpoints in the single-device layout. A model is evaluated
(``marius_eval``, ``train=False``) on one device, whatever mesh trained it.
A full-graph encoder the collapse does not take (``full_graph: ON`` with a
nonlinear GraphSAGE/GCN, GAT or RGCN) trains on the node-sharded ring over
the mesh's one non-trivial axis; its export re-prepares one device's ops
(JAX :581-585).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import yaml

from marius_tpu_torch.config.schema import MariusConfig, load_config, resolve_dtype
from marius_tpu_torch.convert import copy_train_state_
from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
from marius_tpu_torch.data.graph import build_device_graph
from marius_tpu_torch.data.samplers.neighbor import (
    estimate_hop_caps_empirical,
    resolve_all_caps,
    resolve_all_caps_from_edges,
)
from marius_tpu_torch.nn.full_graph_encoder import (
    encoder_has_rgcn,
    prepare_full_graph,
    supports_full_graph,
)
from marius_tpu_torch.nn.model import LINK_PREDICTION, NODE_CLASSIFICATION
from marius_tpu_torch.ops.edge_keys import build_edge_key_set
from marius_tpu_torch.ops.unique import PREFIX_BITMAP_LIMIT
from marius_tpu_torch.parallel.mesh import make_mesh
from marius_tpu_torch.reporting.logger import get_logger
from marius_tpu_torch.storage import checkpoint as ckpt
from marius_tpu_torch.storage.dataset import (
    load_features,
    load_labels,
    load_node_split,
    load_split,
    load_stats,
)
from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer
from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
from marius_tpu_torch.train.graph_encoder import encode_all_nodes, encode_all_nodes_host
from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer
from marius_tpu_torch.train.nc_buffer import PartitionBufferNCTrainer
from marius_tpu_torch.train.trainer import LinkPredictionTrainer, resolve_device


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
    # FLAT_FILE edges: a memmap over the binary file, paged in as read
    train = load_split(ds.dataset_dir, "train", stats,
                       mmap=cfg.storage.edges_backend == "FLAT_FILE")
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


def _wants_mesh(cfg: MariusConfig) -> bool:
    t = cfg.training
    return t.mesh_data not in (0, 1) or t.mesh_node not in (0, 1)


def _build_mesh(cfg: MariusConfig, dev):
    """training.mesh -> a Mesh over the process group's ranks (None when
    single-device); 0 means the rest of the world size (JAX :84-96)."""
    t = cfg.training
    if not _wants_mesh(cfg):
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    node = t.mesh_node if t.mesh_node > 0 else max(1, world // max(t.mesh_data, 1))
    data = t.mesh_data if t.mesh_data > 0 else max(1, world // node)
    if not dist.is_initialized():
        raise ValueError(f"training.mesh {data} x {node} needs {data * node} ranks; this "
                         f"process has joined no process group (set MARIUS_COORDINATOR, "
                         f"MARIUS_NUM_PROCESSES and MARIUS_PROCESS_ID)")
    return make_mesh(num_data=data, num_node=node, device=dev)


def _dtype(cfg: MariusConfig) -> torch.dtype:
    """The compute dtype, ``storage.embeddings.options.dtype`` (JAX :58-60)."""
    return resolve_dtype(cfg.storage.embeddings_dtype)


class _HostStreamLPEval:
    """evaluation.host_streaming: the table (and the features) never enter
    device memory whole; they are encoded and scored in node tiles
    (``LinkPredictionEvaluator.evaluate_from_host_table``)."""

    def __init__(self, ev: LinkPredictionEvaluator, features_host: Optional[np.ndarray]):
        self.ev = ev
        self.features_host = features_host

    def __getattr__(self, name):
        return getattr(self.ev, name)

    def evaluate(self, state):
        # numpy has no bfloat16: a bf16 table is encoded from its float32
        # copy (the same values) and scored in float32
        values = self.ev.table_values(state, on_device=False)
        host = None if values is None else values.detach().float().numpy()
        return self.ev.evaluate_from_host_table(host, state.params,
                                                features_host=self.features_host)


class _BufferNCEval:
    """An evaluator over a node split that runs the out-of-core trainer's
    buffer states (``PartitionBufferNCTrainer.evaluate_nodes``)."""

    def __init__(self, trainer: PartitionBufferNCTrainer, nodes: np.ndarray):
        self.trainer = trainer
        self.nodes = nodes

    def evaluate(self, state):
        return self.trainer.evaluate_nodes(self.nodes)


def _async_nc_batch(cfg: MariusConfig, model, log):
    """(batch size, model) under the async pipeline mapping (PipelineTrainer,
    trainer.cpp:35-74): K staleness-bound seed batches read ONE parameter
    snapshot; with SUM CE that is a K-times-larger batch, with MEAN the loss
    is scaled by K."""
    batch_size = cfg.training.batch_size
    if not cfg.training.sync and cfg.training.staleness_bound > 1:
        k = cfg.training.staleness_bound
        batch_size *= k
        if model.loss_reduction.upper() == "MEAN":
            model = dataclasses.replace(model, loss_scale=float(k))
        log.info("Async pipeline: staleness_bound=%d -> step of %d seeds", k, batch_size)
    return batch_size, model


def _init_nc_buffer(cfg: MariusConfig, dev, log, mesh=None):
    """(trainer, valid evaluator, test evaluator) of a PARTITION_BUFFER
    node-classification config (JAX :271-279, :326-329, :350-375): the graph
    stays on the host; the features file is mapped, not read. Data parallel
    on ``mesh``, where an EMBEDDING co-buffer is refused by the trainer, as
    in JAX."""
    ds, s, model = cfg.storage.dataset, cfg.storage, cfg.model
    stats = load_stats(ds.dataset_dir)
    edges = load_split(ds.dataset_dir, "train", stats)
    features = (load_features(ds.dataset_dir, stats, mmap=True)
                if model.encoder.has_features else None)
    labels = load_labels(ds.dataset_dir)
    train_nodes = load_node_split(ds.dataset_dir, "train")
    train_nbr = resolve_all_caps_from_edges(cfg.train_neighbor_sampling, edges, ds.num_nodes,
                                            cap_limit=cfg.all_cap_limit)
    log.info("Loaded NC dataset: %d nodes, %d edges, %d train nodes (out of core)",
             ds.num_nodes, len(edges), len(train_nodes))
    batch_size, model = _async_nc_batch(cfg, model, log)
    trainer = PartitionBufferNCTrainer(
        model, edges, features, labels, train_nodes, train_nbr, num_nodes=ds.num_nodes,
        batch_size=batch_size, num_partitions=s.num_partitions,
        buffer_capacity=s.buffer_capacity, ordering=s.node_partition_ordering,
        seed=cfg.training.seed, mesh=mesh, epochs_per_shuffle=cfg.training.epochs_per_shuffle,
        device=dev)

    def make_eval(split):
        try:
            nodes = load_node_split(ds.dataset_dir, split)
        except FileNotFoundError:
            return None
        return _BufferNCEval(trainer, nodes) if len(nodes) else None

    return trainer, make_eval("valid"), make_eval("test")


def _init_nc(cfg: MariusConfig, dev, log, mesh=None):
    """(trainer, valid evaluator, test evaluator) of a node-classification
    config (JAX :261-425), data parallel on ``mesh``."""
    ds, s, model = cfg.storage.dataset, cfg.storage, cfg.model
    # out-of-core NC engages when either node tier is buffered: the features,
    # or the optional learnable embedding table (io.cpp:347-433)
    if s.features_backend == "PARTITION_BUFFER" or (
            model.has_embeddings and s.embeddings_backend == "PARTITION_BUFFER"):
        return _init_nc_buffer(cfg, dev, log, mesh)
    stats = load_stats(ds.dataset_dir)
    edges = load_split(ds.dataset_dir, "train", stats)
    features = load_features(ds.dataset_dir) if model.encoder.has_features else None
    labels = load_labels(ds.dataset_dir)
    train_nodes = load_node_split(ds.dataset_dir, "train")
    num_nodes = ds.num_nodes
    graph = build_device_graph(edges, num_nodes, max(ds.num_relations, 1), device=dev)
    train_nbr = cfg.train_neighbor_sampling
    # exact-ALL: when every hop samples ALL and a typical batch's k-hop
    # frontier covers a sizable share of the graph, every layer runs over the
    # full adjacency instead of per-batch frontiers (data/full_graph.py)
    full_graph = None
    fg_mode = cfg.full_graph.upper()
    # on a mesh the full-graph route needs feature inputs and one non-trivial
    # axis (JAX :293-300): the collapse, or the node-sharded ring
    fg_mesh_ok = mesh is None or (
        features is not None and not model.has_embeddings
        and sum(1 for v in mesh.shape.values() if v > 1) == 1)
    if (fg_mode != "OFF" and fg_mesh_ok and train_nbr
            and all(c.sampling_type.upper() == "ALL" for c in train_nbr)
            and supports_full_graph(model.encoder)):
        avg_deg = 2.0 * len(edges) / max(num_nodes, 1)
        frontier = cfg.training.batch_size * max(avg_deg, 1.0) ** len(train_nbr)
        if fg_mode == "ON" or frontier >= num_nodes / 4:
            full_graph = build_full_graph_adjacency(
                edges, num_nodes, with_relations=encoder_has_rgcn(model.encoder))
            log.info("Full-graph ALL mode: %d padded slots over %d degree buckets, exact ALL",
                     full_graph.total_slots, len(full_graph.nbrs))
    if full_graph is None:
        train_nbr = resolve_all_caps(train_nbr, graph.in_offsets, graph.out_offsets,
                                     cap_limit=cfg.all_cap_limit)
    log.info("Loaded NC dataset: %d nodes, %d edges, %d train nodes",
             num_nodes, len(edges), len(train_nodes))

    batch_size, model = _async_nc_batch(cfg, model, log)
    auto_caps = None
    if (cfg.hop_caps_auto and not cfg.hop_caps and train_nbr
            and not any(c.sampling_type.upper() == "ALL" for c in train_nbr)
            and num_nodes <= PREFIX_BITMAP_LIMIT):
        # `hop_caps: auto`: caps from the graph's observed frontier growth;
        # safe only where the prefix sampler turns overflow into counted
        # neighbour truncation
        auto_caps = estimate_hop_caps_empirical(edges, num_nodes, train_nbr, batch_size,
                                                seed=cfg.training.seed, seed_pool=train_nodes)
        log.info("empirical hop caps: %s", auto_caps)
    elif cfg.hop_caps_auto and num_nodes > PREFIX_BITMAP_LIMIT:
        log.warning("hop_caps: auto ignored at %d nodes (> prefix-bitmap limit %d): tight "
                    "caps would alias on the sorted dedup path; using worst-case caps",
                    num_nodes, PREFIX_BITMAP_LIMIT)
    trainer = NodeClassificationTrainer(
        model, graph, features, labels, train_nodes, train_nbr,
        batch_size=batch_size, hop_caps=cfg.hop_caps or auto_caps, seed=cfg.training.seed,
        dtype=_dtype(cfg), full_graph=full_graph, mesh=mesh,
        epochs_per_shuffle=cfg.training.epochs_per_shuffle, device=dev)

    def make_eval(split):
        try:
            nodes = load_node_split(ds.dataset_dir, split)
        except FileNotFoundError:
            return None
        if len(nodes) == 0:
            return None
        return NodeClassificationEvaluator(trainer, nodes, batch_size=cfg.evaluation.batch_size)

    return trainer, make_eval("valid"), make_eval("test")


def marius_init(cfg: MariusConfig, train: bool = True, device=None) -> MariusRuntime:
    if cfg.learning_task not in (LINK_PREDICTION, NODE_CLASSIFICATION):
        raise ValueError(f"Unknown learning task: {cfg.learning_task}")
    dev = resolve_device(device)
    log = get_logger(cfg.storage.model_dir or None, console_level=cfg.storage.log_level)
    mesh = _build_mesh(cfg, dev) if train else None
    if cfg.learning_task == NODE_CLASSIFICATION:
        rt = MariusRuntime(cfg, *_init_nc(cfg, dev, log, mesh))
    else:
        rt = _init_lp(cfg, dev, log, mesh)
    if mesh is not None:
        log.info("Mesh: %s over %d ranks, backend %s; this rank %d at %s on %s (%s, "
                 "training.mesh.mode %s)", mesh.shape, dist.get_world_size(), mesh.backend,
                 mesh.rank, mesh.coords, mesh.device, type(rt.trainer).__name__,
                 cfg.training.mesh_mode)
    _load_trained(rt, train, log)
    return rt


def _init_lp(cfg: MariusConfig, dev, log, mesh=None) -> MariusRuntime:
    ds = cfg.storage.dataset
    model = cfg.model

    train_edges, valid_edges, test_edges = _load_lp_data(cfg)
    num_nodes, num_rels = ds.num_nodes, max(ds.num_relations, 1)
    log.info("Loaded dataset: %d nodes, %d relations, %d train edges",
             num_nodes, num_rels, len(train_edges))

    # GNN stages sample the train graph; ALL fanouts are sized to its degrees
    graph = None
    train_nbr, eval_nbr = cfg.train_neighbor_sampling, cfg.eval_neighbor_sampling
    if train_nbr:
        graph = build_device_graph(train_edges, num_nodes, num_rels, device=dev)
        train_nbr = resolve_all_caps(train_nbr, graph.in_offsets, graph.out_offsets,
                                     cap_limit=cfg.all_cap_limit)
        eval_nbr = resolve_all_caps(eval_nbr, graph.in_offsets, graph.out_offsets,
                                    cap_limit=cfg.all_cap_limit)
    features = load_features(ds.dataset_dir) if model.encoder.has_features else None

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

    s = cfg.storage
    if s.embeddings_backend == "PARTITION_BUFFER":
        trainer = PartitionBufferLPTrainer(
            model, num_nodes, num_rels, train_edges, neg,
            batch_size=batch_size,
            num_partitions=s.num_partitions,
            buffer_capacity=s.buffer_capacity,
            seed=cfg.training.seed,
            ordering=s.edge_bucket_ordering,
            fine_to_coarse_ratio=s.fine_to_coarse_ratio,
            num_cache_partitions=s.num_cache_partitions,
            randomly_assign_edge_buckets=s.randomly_assign_edge_buckets,
            prefetching=s.prefetching,
            epochs_per_shuffle=cfg.training.epochs_per_shuffle,
            train_filter_keys=train_filter,
            sparse_writeback=s.sparse_writeback,
            nbr_configs=train_nbr,
            features=features,
            mesh=mesh,
            dtype=_dtype(cfg),
            device=dev,
        )
        # the buffer trainer's host table is whole on every rank
        eval_mesh = None
    else:
        trainer = LinkPredictionTrainer(
            model, num_nodes, num_rels, train_edges, neg,
            batch_size=batch_size,
            seed=cfg.training.seed,
            train_filter_keys=train_filter,
            graph=graph,
            nbr_configs=train_nbr,
            features=features,
            hop_caps=cfg.hop_caps or None,
            mesh=mesh,
            edges_backend=s.edges_backend,
            epochs_per_shuffle=cfg.training.epochs_per_shuffle,
            dtype=_dtype(cfg),
            device=dev,
        )
        eval_mesh = mesh

    all_edges = np.concatenate(
        [train_edges] + [e for e in (valid_edges, test_edges) if e is not None], axis=0)
    host_streaming = cfg.evaluation.host_streaming
    # host streaming keeps the features on the host too
    eval_features = None if host_streaming else trainer.features

    # exact ALL: when every eval hop samples ALL, all-node encoding is one
    # full-graph pass (no frontiers, no all_cap_limit truncation: the
    # reference's unbounded ALL, neighbor.cpp:9), prepared once for both
    # evaluators
    eval_full_graph = eval_fg_ops = None
    if (eval_nbr and graph is not None and not host_streaming
            and cfg.full_graph.upper() != "OFF"
            and all(n.sampling_type.upper() == "ALL" for n in eval_nbr)
            and supports_full_graph(model.encoder)):
        adj = build_full_graph_adjacency(
            train_edges, num_nodes, with_relations=encoder_has_rgcn(model.encoder)).to(dev)
        feats = None if eval_features is None else eval_features[:-1]
        eval_full_graph, eval_fg_ops = prepare_full_graph(adj, model.encoder, feats)
        log.info("Evaluation uses exact-ALL full-graph encoding")

    def make_eval(edges):
        if edges is None or len(edges) == 0:
            return None
        ev = LinkPredictionEvaluator(
            model, num_nodes, num_rels, edges,
            all_edges=all_edges,
            batch_size=cfg.evaluation.batch_size,
            filtered=cfg.evaluation.negative_sampling.filtered,
            neg_config=cfg.evaluation.negative_sampling,
            graph=graph,
            nbr_configs=eval_nbr,
            features=eval_features,
            full_graph=eval_full_graph,
            fg_ops=eval_fg_ops,
            mesh=eval_mesh,
            device=dev,
        )
        return _HostStreamLPEval(ev, features) if host_streaming else ev

    return MariusRuntime(cfg, trainer, make_eval(valid_edges), make_eval(test_edges))


def _load_trained(rt: MariusRuntime, train: bool, log) -> None:
    """Resume from a checkpoint, or load the model to evaluate."""
    cfg = rt.config
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


def _restore(rt: MariusRuntime, path: str) -> Dict[str, Any]:
    """Load the checkpoint at ``path`` into the trainer's own tensors (the
    decoder's relation tables are its module's parameters); a partition-buffer
    trainer takes it through its ``state`` setter (the LP one into its host
    table; the NC one's co-buffer is not in a checkpoint, ROADMAP C7); a mesh
    trainer shards it."""
    trainer = rt.trainer
    if _mesh_of(rt) is not None:
        state, meta = ckpt.load_state(path, trainer.gathered_state())
        trainer.load_gathered_state(state)
        return meta
    state, meta = ckpt.load_state(path, trainer.state)
    if isinstance(trainer, (PartitionBufferLPTrainer, PartitionBufferNCTrainer)):
        trainer.state = state
    else:
        copy_train_state_(trainer.state, state)
    return meta


def _mesh_of(rt: MariusRuntime):
    return getattr(rt.trainer, "mesh", None)


def _saved_state(rt: MariusRuntime):
    """The state a checkpoint holds: the single-device layout."""
    return rt.trainer.gathered_state() if _mesh_of(rt) is not None else rt.trainer.state


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
        rate_key = "edges_per_sec" if "edges_per_sec" in stats else "nodes_per_sec"
        log.info("Epoch %d: loss=%.4f time=%.3fs %s=%.0f", epoch + 1,
                 stats["loss"], stats["epoch_time_s"], rate_key, stats[rate_key])

        if rt.valid_evaluator is not None and (epoch + 1) % max(t.epochs_per_eval, 1) == 0:
            res = rt.valid_evaluator.evaluate(rt.trainer.state)
            res["split"] = "valid"
            res["epoch"] = epoch + 1
            eval_stats.append(res)
            # save_best: keep the best-valid model in model_dir (MRR for LP,
            # accuracy for NC; higher is better for both)
            metric = res.get("mrr", res.get("accuracy"))
            if (t.save_best and cfg.storage.model_dir and metric is not None
                    and (best_metric is None or metric > best_metric)):
                best_metric = float(metric)
                ckpt.save_state(cfg.storage.model_dir, _saved_state(rt),
                                metadata={**_meta(rt), "best_valid_metric": best_metric},
                                mesh=_mesh_of(rt))
                log.info("New best valid metric %.5f at epoch %d — saved",
                         best_metric, epoch + 1)

        if t.checkpoint_interval > 0 and (epoch + 1) % t.checkpoint_interval == 0 \
                and cfg.storage.model_dir:
            ckpt.create_checkpoint(cfg.storage.model_dir, _saved_state(rt), epoch + 1,
                                   metadata=_meta(rt),
                                   save_optim_state=t.checkpoint_save_state,
                                   mesh=_mesh_of(rt))
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
        ckpt.save_state(cfg.storage.model_dir, _saved_state(rt), metadata=_meta(rt),
                        mesh=_mesh_of(rt))
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
    tr = rt.trainer
    if isinstance(tr, PartitionBufferNCTrainer):
        raise ValueError("export_encoded_nodes needs the whole graph on the device; an "
                         "out-of-core NC model keeps it on the host (as in the JAX package)")
    state = _saved_state(rt)
    table_values = state.table.values if state.table is not None else None
    batch_size = rt.config.evaluation.batch_size
    if isinstance(tr, PartitionBufferLPTrainer):
        # the host table goes through the device in tiles; the buffer trainer
        # holds no global graph, so a GNN encoder raises as in the JAX package
        encoded = encode_all_nodes_host(rt.config.model, state.params,
                                        state.table.values.float().numpy(), tr.device,
                                        nbr_configs=tr.nbr_configs,
                                        features_host=tr._features_host, batch_size=batch_size)
    else:
        # a full-graph NC trainer keeps its ALL configs unresolved: export
        # rides the same exact-ALL pass, not the sampler; a ring trainer's
        # host adjacency and features re-prepare one device's ops
        full_graph, fg_ops = getattr(tr, "full_graph", None), getattr(tr, "_fg_ops", None)
        features = tr.features
        if getattr(tr, "_ring_axis", None) is not None:
            full_graph, fg_ops = full_graph.to(tr.device), None
            features = features.to(tr.device)
        encoded = encode_all_nodes(
            rt.config.model, state.params, table_values, graph=tr.graph,
            nbr_configs=tr.nbr_configs, features=features, batch_size=batch_size,
            full_graph=full_graph, fg_ops=fg_ops).detach().cpu().float().numpy()
    out = path or (os.path.join(rt.config.storage.model_dir, "encoded_nodes.bin")
                   if rt.config.storage.model_dir else None)
    mesh = _mesh_of(rt)
    if out and (mesh is None or mesh.rank == 0):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        encoded.astype(np.float32).tofile(out)
    return encoded


def _meta(rt: MariusRuntime) -> Dict[str, Any]:
    return {
        "epochs_processed": rt.epochs_processed,
        "learning_task": rt.config.learning_task,
        "timestamp": time.time(),
    }
