"""Batch inference on a trained model: metrics + scores/ranks/labels export.

Parity with marius_predict (tools/marius_predict.py:520 run_predict): rebuild
the model from the saved model_dir, evaluate a chosen split (or custom input
edges), report metrics, and optionally write ranks/scores (LP) or labels (NC)
CSVs to the output directory. Port of ``marius_tpu/tools/predict.py`` over
the port's ``marius_init``: ``device`` None runs on the GPU (and raises
without one), ``"cpu"`` runs the kernels' plain versions. A raw input file's
delimiter is sniffed from its first line, as pandas' ``sep=None`` does.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np

from marius_tpu_torch.config.schema import MariusConfig, load_config
from marius_tpu_torch.data.samplers.neighbor import resolve_all_caps
from marius_tpu_torch.manager import marius_init
from marius_tpu_torch.nn.decoders.edge import normalize_decoder_method
from marius_tpu_torch.storage.dataset import EDGE_FILES, _edge_cols, load_split, load_stats
from marius_tpu_torch.tools.preprocess.converter import read_delimited
from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator


def run_predict(
    config: Any,
    output_dir: str,
    split: str = "test",
    metrics: Optional[List[str]] = None,
    save_scores: bool = False,
    save_ranks: bool = False,
    save_labels: bool = False,
    input_file: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    cfg = config if isinstance(config, MariusConfig) else load_config(config)

    # ONLY_POS (alias INFER) is the inference decoder method (options.cpp:
    # 212-213, EdgeDecoderMethod::ONLY_POS dispatch model.cpp:263-264): score
    # the input edges, no corruption, no rank metrics. The runtime is built
    # with CORRUPT_NODE (training semantics are untouched by inference); the
    # scoring below switches on the configured method. The decoder is a
    # module: a shallow copy shares its relation parameters.
    only_pos = False
    if (cfg.learning_task == "LINK_PREDICTION" and cfg.model is not None
            and cfg.model.decoder is not None):
        only_pos = normalize_decoder_method(
            cfg.model.decoder.decoder_method) == "ONLY_POS"
        if only_pos:
            decoder = copy.copy(cfg.model.decoder)
            decoder.decoder_method = "CORRUPT_NODE"
            cfg.model = dataclasses.replace(cfg.model, decoder=decoder)
            save_scores = True

    rt = marius_init(cfg, train=False, device=device)
    os.makedirs(output_dir, exist_ok=True)

    if cfg.learning_task == "LINK_PREDICTION":
        if input_file is not None:
            edges = _load_input_edges(input_file, cfg.storage.dataset.dataset_dir)
            tr = rt.trainer
            # the raw config's ALL caps are unresolved; size them to the
            # graph like marius_init does, or hubs get silently truncated
            nbr = cfg.eval_neighbor_sampling
            if nbr and getattr(tr, "graph", None) is not None:
                nbr = resolve_all_caps(
                    nbr, tr.graph.in_offsets, tr.graph.out_offsets,
                    cap_limit=cfg.all_cap_limit)
            evaluator = LinkPredictionEvaluator(
                cfg.model, cfg.storage.dataset.num_nodes,
                max(cfg.storage.dataset.num_relations, 1), edges,
                all_edges=np.concatenate(
                    [load_split(cfg.storage.dataset.dataset_dir, s)
                     for s in ("train", "valid", "test")
                     if _split_exists(cfg.storage.dataset.dataset_dir, s)] + [edges]),
                batch_size=cfg.evaluation.batch_size,
                filtered=cfg.evaluation.negative_sampling.filtered,
                neg_config=cfg.evaluation.negative_sampling,
                graph=tr.graph, nbr_configs=nbr,
                features=tr.features, device=tr.device)
        else:
            evaluator = rt.test_evaluator if split == "test" else rt.valid_evaluator
            assert evaluator is not None, f"no {split} edges in the dataset"

        if only_pos:
            scores = evaluator.compute_pos_scores(rt.trainer.state)
            results = {"num_edges": float(scores.shape[1]),
                       "mean_score": float(scores.mean())}
            np.savetxt(os.path.join(output_dir, "scores.csv"),
                       scores.T, fmt="%.6f", delimiter=",")
        else:
            results = evaluator.evaluate(rt.trainer.state)
            if save_ranks or save_scores:
                ranks, scores = evaluator.compute_all_ranks(rt.trainer.state)
                if save_ranks:
                    np.savetxt(os.path.join(output_dir, "ranks.csv"),
                               ranks.T, fmt="%d", delimiter=",")
                if save_scores:
                    np.savetxt(os.path.join(output_dir, "scores.csv"),
                               scores.T, fmt="%.6f", delimiter=",")
    else:
        evaluator = rt.test_evaluator if split == "test" else rt.valid_evaluator
        assert evaluator is not None, f"no {split} nodes in the dataset"
        results = evaluator.evaluate(rt.trainer.state)
        if save_labels and hasattr(evaluator, "predict_labels"):
            preds = evaluator.predict_labels(rt.trainer.state)
            np.savetxt(os.path.join(output_dir, "labels.csv"),
                       preds, fmt="%d", delimiter=",")

    with open(os.path.join(output_dir, "metrics.txt"), "w") as f:
        for k, v in results.items():
            f.write(f"{k}: {v}\n")
    return results


def _load_input_edges(input_file: str, dataset_dir: str) -> np.ndarray:
    """Custom inference input: a binary pre-mapped edge file, or a raw
    delimited file whose node/relation ids are mapped through the dataset's
    mapping files (marius_predict's raw-input preprocessing path)."""
    stats = load_stats(dataset_dir)
    ncols = _edge_cols(stats)
    if input_file.endswith(".bin"):
        return np.fromfile(input_file, np.int32).reshape(-1, ncols)

    raw = next(read_delimited(input_file, None, 0, range(ncols)))
    node_map_path = os.path.join(dataset_dir, "nodes", "node_mapping.txt")
    if os.path.exists(node_map_path):
        nm = np.genfromtxt(node_map_path, delimiter=",", dtype=str)
        node_map = dict(zip(nm[:, 0], nm[:, 1].astype(np.int32)))
        map_node = np.vectorize(lambda v: node_map[v])
    else:
        map_node = lambda col: col.astype(np.int32)  # noqa: E731
    cols = [map_node(raw[:, 0])]
    if ncols == 3:
        rel_map_path = os.path.join(dataset_dir, "edges", "relation_mapping.txt")
        if os.path.exists(rel_map_path):
            rm = np.genfromtxt(rel_map_path, delimiter=",", dtype=str)
            rel_map = dict(zip(rm[:, 0], rm[:, 1].astype(np.int32)))
            cols.append(np.vectorize(lambda v: rel_map[v])(raw[:, 1]))
        else:
            cols.append(raw[:, 1].astype(np.int32))
    cols.append(map_node(raw[:, ncols - 1]))
    return np.stack(cols, axis=1).astype(np.int32)


def _split_exists(dataset_dir: str, split: str) -> bool:
    return os.path.exists(os.path.join(dataset_dir, EDGE_FILES[split]))
