"""An ogbn-arxiv-shaped node-classification dataset, made from a seed.

Frozen copies of the generators the port's chip checks used
(``chip_smoke.py`` ``arxiv_edges``, ``nc_data`` and ``write_arxiv_shaped``),
with every random draw taken from ``seed``:

- the graph: power-law in-degrees matched to ogbn-arxiv's (169,343 nodes,
  1,166,243 edges, the largest in-degree 13,161), destinations permuted and
  sources uniform. The degree sequence is the same for every seed, so every
  seed gives the same amount of work;
- 128 standard-normal features per node and 40 classes, each node's label a
  seeded linear function of its own features;
- ogbn-arxiv's split sizes (90,941 train, 29,799 valid, the other 48,603
  test), drawn from the seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def degree_sequence(num_nodes: int, num_edges: int, hub: int) -> np.ndarray:
    """In-degrees proportional to (rank + 1) ** -0.78, clipped at ``hub``,
    scaled so that they sum to ``num_edges`` (the scale is bisected)."""
    w = (np.arange(num_nodes) + 1.0) ** -0.78
    lo, hi = 0.5, 4.0
    for _ in range(40):
        mid = (lo + hi) / 2
        s = np.minimum(np.round(w * (num_edges / w.sum()) * mid), hub).sum()
        lo, hi = (mid, hi) if s < num_edges else (lo, mid)
    return np.minimum(np.round(w * (num_edges / w.sum()) * lo), hub).astype(np.int64)


def arxiv_edges(rng: np.random.Generator, num_nodes: int, num_edges: int,
                hub: int) -> np.ndarray:
    """(E, 2) int32 (src, dst) rows of the citation-shaped graph."""
    deg = degree_sequence(num_nodes, num_edges, hub)
    short = num_edges - int(deg.sum())
    if short > 0:
        # the same nodes for every seed, below the hub, so that every seed has
        # the same degree sequence and the largest in-degree stays ``hub``
        deg[np.flatnonzero(deg < hub)[:short]] += 1
    elif short < 0:
        deg[np.argsort(deg, kind="stable")[::-1][:-short]] -= 1
    if int(deg.sum()) != num_edges:
        raise AssertionError("the degree sequence does not sum to the edge count")
    dst = rng.permutation(num_nodes)[np.repeat(np.arange(num_nodes), deg)]
    src = rng.integers(0, num_nodes, num_edges)
    return np.stack([src, dst], 1).astype(np.int32)


def generate(spec: Dict, seed: int) -> Dict:
    """The dataset of ``spec`` (the configuration's ``dataset`` block) for
    ``seed``: edges, features, labels and the three node splits."""
    n, e = int(spec["num_nodes"]), int(spec["num_edges"])
    f, c = int(spec["feature_dim"]), int(spec["num_classes"])
    n_train, n_valid = int(spec["num_train"]), int(spec["num_valid"])
    rng = np.random.default_rng([int(seed), 17])
    edges = arxiv_edges(rng, n, e, int(spec["max_in_degree"]))
    features = rng.standard_normal((n, f), dtype=np.float32)
    labels = np.argmax(features @ rng.standard_normal((f, c)).astype(np.float32),
                       1).astype(np.int32)
    order = rng.permutation(n).astype(np.int32)
    return {"task": "nc", "num_nodes": n, "num_relations": 1, "num_classes": c,
            "edges": edges, "features": features, "labels": labels,
            "train_nodes": order[:n_train], "valid_nodes": order[n_train:n_train + n_valid],
            "test_nodes": order[n_train + n_valid:]}
