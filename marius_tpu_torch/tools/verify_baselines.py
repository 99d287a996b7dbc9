"""One-command reproduction of the reference's published accuracy baselines.

The reference's headline accuracy numbers (README.md:69; docs/examples/config/
lp_fb15k237.rst:223,260 — FB15K-237 test MRR 0.2553 after 10 epochs; docs/
examples/config/nc_ogbn_arxiv.rst:266 — ogbn-arxiv test accuracy 68.08%) need
the real datasets, which require network egress. This harness is the
committed, runnable path for the moment egress exists::

    python -m marius_tpu_torch.tools.verify_baselines --dataset all
    # downloads FB15K-237 + ogbn-arxiv, preprocesses, trains
    # examples/configuration/{fb15k_237,ogbn_arxiv}.yaml, asserts
    # MRR >= 0.25 / accuracy >= 0.68

and a zero-egress dry-run that exercises the identical pipeline end-to-end
on learnable synthetic twins (structure-recovery datasets, not random noise)
with scale-appropriate thresholds::

    python -m marius_tpu_torch.tools.verify_baselines --dataset all --synthetic

**Local-files mode (zero egress with pre-downloaded data)**: point
``--raw-files DIR`` (or the ``MARIUS_RAW_DATA`` env var) at a directory of
pre-downloaded raw data and the real-dataset verification runs without ever
touching the network. Accepted layouts, per dataset::

    <DIR>/FB15K-237.2.zip                 # the archive, as downloaded
    <DIR>/fb15k_237/{train,valid,test}.txt  # or the extracted triple files
    <DIR>/arxiv.zip                       # ogbn-arxiv archive
    <DIR>/ogbn_arxiv/arxiv/{raw,split}/...  # or the extracted OGB layout
    <DIR>/ogbn_arxiv/{edge,node-feat,node-label,train,valid,test}.csv

Exit code 0 iff every selected verification passes its threshold.

Port of ``marius_tpu/tools/verify_baselines.py``: the twins are written with
the port's ``storage/dataset.py`` (the same files from the same seed), the
raw files go through the port's converters, and training runs on the port's
manager on the GPU (``device`` None, raising without one) or where
``device`` says. The example YAMLs are the repository's own, read, not
imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_EXAMPLES = os.path.normpath(os.path.join(
    _HERE, "..", "..", "examples", "configuration"))

# real-dataset pass bars (the reference's logged results minus run-to-run
# noise; lp_fb15k237.rst:260 logs 0.2553, nc_ogbn_arxiv.rst:266 logs 68.08%)
FB15K237_MRR_THRESHOLD = 0.25
ARXIV_ACC_THRESHOLD = 0.68
# synthetic-twin bars: structure-recovery datasets are easier than the real
# ones, so the bands are two-sided sanity checks of the training math, not
# difficulty-matched (tests/test_accuracy_regression.py pins tighter bands
# on the same construction)
SYN_LP_MRR_THRESHOLD = 0.30
SYN_NC_ACC_THRESHOLD = 0.85


def _realizable_kg(num_nodes: int, num_relations: int, per: int, seed: int,
                   gt_dim: int = 8) -> np.ndarray:
    """Learnable KG: edges are the top-``per`` DistMult scores per
    (node, relation) under a random ground-truth factorization — exactly
    representable, so MRR measures structure recovery, not chance (same
    construction as tests/test_accuracy_regression.py)."""
    rng = np.random.default_rng(seed)
    E = rng.normal(0, 1, (num_nodes, gt_dim))
    R = rng.normal(0, 1, (num_relations, gt_dim))
    edges = []
    for rel in range(num_relations):
        scores = (E * R[rel]) @ E.T
        np.fill_diagonal(scores, -np.inf)
        top = np.argpartition(-scores, per, axis=1)[:, :per]
        for u in range(num_nodes):
            for v in top[u]:
                edges.append((u, rel, v))
    edges = np.asarray(edges, np.int32)
    rng.shuffle(edges)
    return edges


def _write_lp_twin(dataset_dir: str, num_nodes: int = 800,
                   num_relations: int = 12, per: int = 4, seed: int = 0):
    from marius_tpu_torch.storage.dataset import DatasetStats, save_split, save_stats
    edges = _realizable_kg(num_nodes, num_relations, per, seed)
    n = len(edges)
    n_train, n_valid = int(0.9 * n), int(0.05 * n)
    os.makedirs(dataset_dir, exist_ok=True)
    save_split(dataset_dir, "train", edges[:n_train])
    save_split(dataset_dir, "valid", edges[n_train:n_train + n_valid])
    save_split(dataset_dir, "test", edges[n_train + n_valid:])
    save_stats(dataset_dir, DatasetStats(
        num_nodes=num_nodes, num_edges=n, num_relations=num_relations,
        num_edge_cols=3, num_train=n_train, num_valid=n_valid,
        num_test=n - n_train - n_valid))


def _write_nc_twin(dataset_dir: str, num_nodes: int = 3000,
                   num_classes: int = 12, feature_dim: int = 128,
                   seed: int = 0, intra: float = 0.9):
    """Community graph with label-correlated features (the learnable-NC
    construction from tests/test_nc_e2e.py, written in the dataset layout)."""
    from marius_tpu_torch.storage.dataset import (
        DatasetStats, save_node_array, save_split, save_stats)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    by_label = [np.flatnonzero(labels == c) for c in range(num_classes)]
    m = num_nodes * 8
    u = rng.integers(0, num_nodes, m)
    take_intra = rng.random(m) < intra
    v = rng.integers(0, num_nodes, m)
    for i in np.flatnonzero(take_intra):
        same = by_label[labels[u[i]]]
        v[i] = same[rng.integers(len(same))]
    edges = np.unique(np.stack([u, v], axis=1).astype(np.int32), axis=0)
    feats = rng.normal(0, 1.0, (num_nodes, feature_dim)).astype(np.float32)
    feats[np.arange(num_nodes), labels % feature_dim] += 1.0

    os.makedirs(dataset_dir, exist_ok=True)
    save_split(dataset_dir, "train", edges)
    save_node_array(dataset_dir, "features", feats)
    save_node_array(dataset_dir, "labels", labels)
    perm = rng.permutation(num_nodes).astype(np.int32)
    n_train, n_valid = int(0.6 * num_nodes), int(0.2 * num_nodes)
    save_node_array(dataset_dir, "train_nodes", perm[:n_train])
    save_node_array(dataset_dir, "valid_nodes", perm[n_train:n_train + n_valid])
    save_node_array(dataset_dir, "test_nodes", perm[n_train + n_valid:])
    save_stats(dataset_dir, DatasetStats(
        num_nodes=num_nodes, num_edges=len(edges), num_relations=1,
        num_edge_cols=2, num_train=n_train, num_valid=n_valid,
        num_test=num_nodes - n_train - n_valid, num_classes=num_classes,
        feature_dim=feature_dim))


def _stage_raw_files(raw_root: Optional[str], ds_dir: str,
                     dataset_name: str, dataset_url: str) -> bool:
    """Copy pre-downloaded raw data from ``raw_root`` into the dataset dir so
    the downloader's existence checks short-circuit (zero egress). Accepts
    either ``<raw_root>/<dataset_name>/`` (extracted raw files, copied
    recursively) or the dataset's archive at ``<raw_root>/<archive-name>``
    (``download_url`` returns a pre-placed archive without the network)."""
    if not raw_root:
        return False
    import shutil
    staged = False
    os.makedirs(ds_dir, exist_ok=True)
    src_dir = os.path.join(raw_root, dataset_name)
    if os.path.isdir(src_dir):
        shutil.copytree(src_dir, ds_dir, dirs_exist_ok=True)
        staged = True
    archive = os.path.join(raw_root, dataset_url.rsplit("/", 1)[-1])
    if os.path.isfile(archive):
        dst = os.path.join(ds_dir, os.path.basename(archive))
        if not os.path.exists(dst):
            shutil.copy2(archive, dst)
        staged = True
    return staged


def _load_example(name: str, dataset_dir: str, epochs: Optional[int]):
    import yaml
    from marius_tpu_torch.config.schema import load_config
    with open(os.path.join(_EXAMPLES, f"{name}.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["storage"]["dataset"]["dataset_dir"] = dataset_dir
    if epochs is not None:
        raw["training"]["num_epochs"] = int(epochs)
    return load_config(raw)


def verify_fb15k237(data_root: str, synthetic: bool,
                    epochs: Optional[int] = None,
                    raw_files: Optional[str] = None, device=None) -> Dict:
    """Train examples/configuration/fb15k_237.yaml and check test MRR."""
    from marius_tpu_torch.manager import marius_train
    ds = os.path.join(data_root, "fb15k_237_synthetic" if synthetic
                      else "fb15k_237")
    if synthetic:
        if not os.path.exists(os.path.join(ds, "dataset.yaml")):
            _write_lp_twin(ds)
        threshold = SYN_LP_MRR_THRESHOLD
    else:
        from marius_tpu_torch.tools.preprocess.datasets import FB15K237
        if not os.path.exists(os.path.join(ds, "dataset.yaml")):
            _stage_raw_files(raw_files, ds, "fb15k_237", FB15K237.dataset_url)
        d = FB15K237(ds)
        if not os.path.exists(os.path.join(ds, "dataset.yaml")):
            d.download()
            d.preprocess()
        threshold = FB15K237_MRR_THRESHOLD
    result = marius_train(_load_example("fb15k_237", ds, epochs), device=device)
    mrr = float(result["test"]["mrr"])
    return {"dataset": "fb15k_237", "synthetic": synthetic, "metric": "mrr",
            "value": round(mrr, 4), "threshold": threshold,
            "passed": mrr >= threshold,
            "reference": 0.2553 if not synthetic else None}


def verify_ogbn_arxiv(data_root: str, synthetic: bool,
                      epochs: Optional[int] = None,
                      raw_files: Optional[str] = None, device=None) -> Dict:
    """Train examples/configuration/ogbn_arxiv.yaml and check test accuracy."""
    from marius_tpu_torch.manager import marius_train
    ds = os.path.join(data_root, "ogbn_arxiv_synthetic" if synthetic
                      else "ogbn_arxiv")
    if synthetic:
        if not os.path.exists(os.path.join(ds, "dataset.yaml")):
            _write_nc_twin(ds)
        threshold = SYN_NC_ACC_THRESHOLD
    else:
        from marius_tpu_torch.tools.preprocess.datasets import OGBNArxiv
        if not os.path.exists(os.path.join(ds, "dataset.yaml")):
            _stage_raw_files(raw_files, ds, "ogbn_arxiv", OGBNArxiv.dataset_url)
        d = OGBNArxiv(ds)
        if not os.path.exists(os.path.join(ds, "dataset.yaml")):
            d.download()
            d.preprocess()
        threshold = ARXIV_ACC_THRESHOLD
    result = marius_train(_load_example("ogbn_arxiv", ds, epochs), device=device)
    acc = float(result["test"]["accuracy"])
    return {"dataset": "ogbn_arxiv", "synthetic": synthetic,
            "metric": "accuracy", "value": round(acc, 4),
            "threshold": threshold, "passed": acc >= threshold,
            "reference": 0.6808 if not synthetic else None}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", choices=["fb15k_237", "ogbn_arxiv", "all"],
                    default="all")
    ap.add_argument("--synthetic", action="store_true",
                    help="zero-egress dry-run on learnable synthetic twins")
    ap.add_argument("--data-root", default="datasets")
    ap.add_argument("--raw-files", default=os.environ.get("MARIUS_RAW_DATA"),
                    help="directory of pre-downloaded raw dataset files "
                         "(archives or extracted — see module docstring); "
                         "runs the real verification with zero egress. "
                         "Defaults to $MARIUS_RAW_DATA.")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override training.num_epochs (default: the example "
                         "config's 10)")
    args = ap.parse_args(argv)

    results = []
    if args.dataset in ("fb15k_237", "all"):
        results.append(verify_fb15k237(args.data_root, args.synthetic,
                                       args.epochs, raw_files=args.raw_files,
                                       device=device))
    if args.dataset in ("ogbn_arxiv", "all"):
        results.append(verify_ogbn_arxiv(args.data_root, args.synthetic,
                                         args.epochs, raw_files=args.raw_files,
                                         device=device))
    for r in results:
        print(json.dumps(r))
    ok = all(r["passed"] for r in results)
    print(f"verify_baselines: {'PASS' if ok else 'FAIL'} "
          f"({sum(r['passed'] for r in results)}/{len(results)})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
