"""The frozen generators give the published counts, and the seed decides
the data."""

from __future__ import annotations

import bench_tiny  # noqa: F401
import numpy as np

from benchmark.data import arxiv_shaped, fb15k_shaped
from benchmark.harness import spec


def test_arxiv_shaped_counts():
    cfg = spec.config("ogbn_arxiv_sage")["dataset"]
    for seed in (0, 2 ** 31 + 11):
        d = arxiv_shaped.generate(cfg, seed)
        assert d["num_nodes"] == 169_343 and d["edges"].shape == (1_166_243, 2)
        assert np.bincount(d["edges"][:, 1], minlength=169_343).max() == 13_161
        assert d["features"].shape == (169_343, 128) and d["labels"].max() < 40
        sizes = [len(d[f"{s}_nodes"]) for s in ("train", "valid", "test")]
        assert sizes == [90_941, 29_799, 48_603]
        every = np.concatenate([d[f"{s}_nodes"] for s in ("train", "valid", "test")])
        assert len(np.unique(every)) == 169_343


def test_fb15k_shaped_counts():
    cfg = spec.config("fb15k237_gs1")["dataset"]
    d = fb15k_shaped.generate(cfg, 7)
    assert d["num_nodes"] == 14_541 and d["num_relations"] == 237
    assert [len(d[f"{s}_edges"]) for s in ("train", "valid", "test")] == [272_115, 17_535, 20_466]
    e = d["train_edges"]
    assert e[:, 0].max() < 14_541 and e[:, 1].max() < 237 and e[:, 2].max() < 14_541


def test_the_seed_decides_the_data():
    cfg = dict(spec.config("fb15k237_gs1")["dataset"], num_train=1000)
    a, b, c = (fb15k_shaped.generate(cfg, s) for s in (3, 3, 4))
    assert np.array_equal(a["train_edges"], b["train_edges"])
    assert not np.array_equal(a["train_edges"], c["train_edges"])
    small = dict(spec.config("ogbn_arxiv_sage")["dataset"], num_nodes=2000, num_edges=9000,
                 max_in_degree=100, num_train=500, num_valid=500)
    x, y = arxiv_shaped.generate(small, 1), arxiv_shaped.generate(small, 2)
    # every seed has the same degree sequence, so the same work
    assert np.array_equal(np.sort(np.bincount(x["edges"][:, 1], minlength=2000)),
                          np.sort(np.bincount(y["edges"][:, 1], minlength=2000)))
    assert not np.array_equal(x["edges"], y["edges"])
