"""The port's command-line tools against the JAX package's, on the CPU.

Config generation, prediction, export, db2graph, env info and the baseline
harness run in both packages on the same inputs. Files must be
byte-identical; a model the JAX ``marius_train`` trains on a converted raw
edge list, its table and relations quantized to a 1/64 grid so every score
is exact in float32, must give the same ranks through both ``marius_predict``s, the metrics to
rtol 1e-6 (float32 rank sums in another order, as in
tests/test_torch_lp_eval.py) and the scores to rtol 1e-5 / atol 1e-6, JAX's
key search clamped at the key count (ROADMAP C1). The port's commands
take ``device="cpu"`` here; without it they need a card.
"""

import json
import os
import sqlite3
import zipfile

import numpy as np
import pytest
import torch
import yaml

from marius_tpu.tools import cli as jcli
from marius_tpu_torch.tools import cli
from tests.test_torch_lp_eval import jax_search_clamped  # noqa: F401  (a fixture)
from tests.test_torch_tools_preprocess import assert_same_files, write_raw_triples
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

METRIC_KEYS = ("mrr", "mean_rank", "hits@1", "hits@3", "hits@5", "hits@10", "hits@50",
               "hits@100", "num_evaluated")


def assert_same_metrics(a, b):
    for k in METRIC_KEYS:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def _metrics(path):
    out = {}
    with open(path) as f:
        for line in f:
            k, v = line.split(": ")
            out[k] = float(v)
    return out


# -- a JAX-trained, quantized model on a converted raw edge list ---------------

def _lp_raw(ds, model_dir, decoder_method=None):
    raw = {
        "model": {
            "learning_task": "LINK_PREDICTION",
            "encoder": {"layers": [[{"type": "EMBEDDING", "output_dim": 8}]]},
            "decoder": {"type": "DISTMULT", "options": {"input_dim": 8}},
            "loss": {"type": "SOFTMAX_CE"},
            "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": 0.1}},
        },
        "storage": {"dataset": {"dataset_dir": ds}, "model_dir": model_dir,
                    "save_model": True},
        "training": {"batch_size": 40, "num_epochs": 2,
                     "negative_sampling": {"num_chunks": 2, "negatives_per_positive": 8}},
        "evaluation": {"batch_size": 40, "negative_sampling": {"filtered": True}},
    }
    if decoder_method:
        raw["model"]["decoder"]["options"]["edge_decoder_method"] = decoder_method
    return raw


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """(dir, config path, raw train file): 400 raw triples converted by the
    port, a JAX-trained DistMult model whose leaves are then quantized."""
    from marius_tpu_torch.tools.preprocess.converter import EdgeListConverter

    d = tmp_path_factory.mktemp("jax_model")
    raw = d / "raw.tsv"
    write_raw_triples(raw, n=400, nodes=40, rels=4, seed=1, prefix=("/m/0", "/rel/"))
    EdgeListConverter(output_dir=str(d / "ds"), train_edges=str(raw),
                      splits=(0.8, 0.1, 0.1)).convert()
    cfg = d / "config.yaml"
    cfg.write_text(yaml.safe_dump(_lp_raw(str(d / "ds"), str(d / "model"))))
    assert jcli.marius_train([str(cfg)]) == 0
    for name in os.listdir(d / "model"):
        if name.startswith(("table__values", "params__")):
            leaf = np.load(d / "model" / name)
            grid = np.round(np.clip(leaf, -2, 2) * 64) / 64
            np.save(d / "model" / name, grid.astype(leaf.dtype))
    return d, str(cfg), raw


@pytest.mark.parametrize("variant", ["test_split", "valid_split", "input_file", "only_pos"])
def test_predict_matches_jax(jax_search_clamped, jax_model, tmp_path, variant):  # noqa: F811
    """JAX's filtered ranks with its key search clamped (ROADMAP C1)."""
    from marius_tpu.tools.predict import run_predict as j_predict
    from marius_tpu_torch.tools.predict import run_predict as t_predict

    d, cfg, raw = jax_model
    kw = dict(save_ranks=True, save_scores=True)
    if variant == "valid_split":
        kw["split"] = "valid"
    if variant == "input_file":
        query = tmp_path / "query.txt"
        query.write_text("".join(raw.read_text().splitlines(True)[:25]))
        kw["input_file"] = str(query)
    if variant == "only_pos":
        cfg = str(tmp_path / "only_pos.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump(_lp_raw(str(d / "ds"), str(d / "model"), "ONLY_POS"), f)
    jres = j_predict(cfg, str(tmp_path / "j"), **kw)
    tres = t_predict(cfg, str(tmp_path / "t"), device="cpu", **kw)
    if variant == "only_pos":
        assert set(os.listdir(tmp_path / "t")) == {"scores.csv", "metrics.txt"}
        assert tres == pytest.approx(jres, rel=1e-5)
    else:
        assert ((tmp_path / "t" / "ranks.csv").read_bytes()
                == (tmp_path / "j" / "ranks.csv").read_bytes())
        assert_same_metrics(tres, jres)
        assert_same_metrics(_metrics(tmp_path / "t" / "metrics.txt"),
                            _metrics(tmp_path / "j" / "metrics.txt"))
        ranks = np.loadtxt(tmp_path / "t" / "ranks.csv", delimiter=",")
        assert np.mean(1.0 / ranks) == pytest.approx(tres["mrr"], abs=1e-6)
        assert ranks.shape == (25 if variant == "input_file" else 40, 2)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "scores.csv", delimiter=","),
                               np.loadtxt(tmp_path / "j" / "scores.csv", delimiter=","),
                               rtol=1e-5, atol=1e-6)


def test_predict_raw_input_goes_through_the_mapping_files(jax_model):
    from marius_tpu.tools.predict import _load_input_edges as j_load
    from marius_tpu_torch.storage.dataset import load_split
    from marius_tpu_torch.tools.predict import _load_input_edges as t_load

    d, _, raw = jax_model
    edges = t_load(str(raw), str(d / "ds"))
    np.testing.assert_array_equal(edges, j_load(str(raw), str(d / "ds")))
    train = load_split(str(d / "ds"), "train")
    assert edges.shape == (400, 3) and {tuple(e) for e in train} <= {tuple(e) for e in edges}


@pytest.mark.parametrize("fmt", ["csv", "bin", "parquet"])
def test_postprocess_writes_jax_files(jax_model, tmp_path, fmt):
    from marius_tpu.tools.postprocess import export_node_embeddings as j_export
    from marius_tpu_torch.tools.postprocess import export_node_embeddings as t_export

    if fmt == "parquet":
        pytest.importorskip("pandas")
        pytest.importorskip("pyarrow")
    d, _, _ = jax_model
    j_export(str(d / "model"), str(tmp_path / "j"), fmt=fmt, dataset_dir=str(d / "ds"))
    argv = ["--model_dir", str(d / "model"), "--output_dir", str(tmp_path / "t"),
            "--format", fmt, "--dataset_dir", str(d / "ds")]
    assert cli.main(["postprocess", *argv], device="cpu") == 0
    assert_same_files(tmp_path / "j", tmp_path / "t")
    if fmt == "bin":
        table = np.load(d / "model" / "table__values.npy")
        assert ((tmp_path / "t" / "embeddings.bin").read_bytes()
                == table.astype(np.float32).tobytes())


def test_postprocess_refuses_a_bf16_table_as_jax_does(tmp_path):
    """A bf16 checkpoint's table is a '<V2' array: JAX's exporter cannot
    format or cast it (ROADMAP C11), and the port's fails the same way."""
    from marius_tpu.tools.postprocess import export_node_embeddings as j_export
    from marius_tpu_torch.tools.postprocess import export_node_embeddings as t_export

    bits = (np.arange(12, dtype=np.float32).reshape(3, 4).view(np.uint32) >> 16).astype(np.uint16)
    np.save(tmp_path / "table__values.npy", bits.view("V2"))
    for fmt in ("csv", "bin"):
        for export in (j_export, t_export):
            with pytest.raises(ValueError):
                export(str(tmp_path), str(tmp_path / "out"), fmt=fmt)


# -- commands end to end through the port ----------------------------------------

def test_train_eval_predict_postprocess_commands(jax_model, tmp_path, capsys, monkeypatch):
    d, _, _ = jax_model
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(_lp_raw(str(d / "ds"), str(tmp_path / "model"))))
    assert cli.main(["train", str(cfg)], device="cpu") == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.marius_eval([str(cfg)], device="cpu") == 0
    evaluated = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: trained[k] for k in METRIC_KEYS} == {k: evaluated[k] for k in METRIC_KEYS}
    assert cli.marius_predict(["--config", str(cfg), "--output_dir", str(tmp_path / "p"),
                               "--save_ranks"], device="cpu") == 0
    predicted = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: predicted[k] for k in METRIC_KEYS} == {k: evaluated[k] for k in METRIC_KEYS}
    assert cli.marius_postprocess(["--model_dir", str(tmp_path / "model"), "--output_dir",
                                   str(tmp_path / "emb"), "--dataset_dir", str(d / "ds")],
                                  device="cpu") == 0
    lines = (tmp_path / "emb" / "embeddings.csv").read_text().splitlines()
    mapping = np.genfromtxt(d / "ds" / "nodes" / "node_mapping.txt", delimiter=",", dtype=str)
    assert {line.split(",")[0] for line in lines} >= set(mapping[:, 0])

    # the commands join a process group under MARIUS_COORDINATOR (two
    # processes: tests/test_torch_mesh.py): here one rank, then it leaves
    import torch.distributed as dist

    monkeypatch.setenv("MARIUS_COORDINATOR", f"file://{tmp_path / 'rendezvous'}")
    monkeypatch.setenv("MARIUS_NUM_PROCESSES", "1")
    monkeypatch.setenv("MARIUS_PROCESS_ID", "0")
    assert cli.main(["eval", str(cfg)], device="cpu") == 0
    in_group = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: in_group[k] for k in METRIC_KEYS} == {k: evaluated[k] for k in METRIC_KEYS}
    assert not dist.is_initialized()


# -- config generator ----------------------------------------------------------

@pytest.mark.parametrize("num_nodes", [10_000, 1_000_000, 86_054_151, 860_000_000])
@pytest.mark.parametrize("dim", [50, 100, 400])
@pytest.mark.parametrize("hbm", [8e9, 16e9, 85.0e9])
def test_partition_buffer_sizing_matches_jax(num_nodes, dim, hbm):
    from marius_tpu.tools.config_generator import size_partition_buffer as j_size
    from marius_tpu_torch.tools.config_generator import size_partition_buffer as t_size

    assert t_size(num_nodes, dim, hbm_bytes=hbm) == j_size(num_nodes, dim, hbm_bytes=hbm)


def _stats_dir(path, **kw):
    from marius_tpu_torch.storage.dataset import DatasetStats, save_stats

    os.makedirs(path)
    save_stats(str(path), DatasetStats(**kw))
    return str(path)


@pytest.mark.parametrize("task,model,num_partitions", [
    ("LINK_PREDICTION", "DISTMULT", None), ("LINK_PREDICTION", "COMPLEX", 4),
    ("LINK_PREDICTION", "GRAPH_SAGE", None), ("NODE_CLASSIFICATION", "GRAPH_SAGE", None),
    ("NODE_CLASSIFICATION", "DISTMULT", 2)])
def test_generate_config_matches_jax(tmp_path, task, model, num_partitions):
    """The same dicts for the same stats and memory, but the device type: the
    port's configs say cuda where the JAX package's say tpu."""
    from marius_tpu.tools.config_generator import generate_config as j_gen
    from marius_tpu_torch.tools.config_generator import generate_config as t_gen

    for name, nodes in (("small", 10_000), ("big", 90_000_000)):
        ds = _stats_dir(tmp_path / name, num_nodes=nodes, num_edges=300_000, num_relations=10,
                        num_train=300_000, feature_dim=64, num_classes=12)
        kw = dict(task=task, model=model, embedding_dim=100, hbm_bytes=16e9,
                  num_partitions=num_partitions)
        j, t = j_gen(ds, **kw), t_gen(ds, **kw)
        assert (j["storage"].pop("device_type"), t["storage"].pop("device_type")) == ("tpu", "cuda")
        assert t == j
    if task == "LINK_PREDICTION" and num_partitions is None:
        assert t["storage"]["embeddings"]["type"] == "PARTITION_BUFFER"


def test_config_generator_command_round_trips_and_needs_memory(tmp_path, monkeypatch):
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.tools.config_generator import generate_config
    from marius_tpu_torch.tools.preprocess import generate_random_dataset_lp

    ds = str(tmp_path / "ds")
    generate_random_dataset_lp(ds, num_nodes=40, num_edges=200, num_relations=4)
    out = str(tmp_path / "gen.yaml")
    assert cli.main(["config_generator", ds, "--output", out, "--model", "COMPLEX",
                     "--num_partitions", "1"], device="cpu") == 0
    cfg = load_config(out)
    assert cfg.model.decoder.decoder_type == "COMPLEX"
    assert cfg.storage.dataset.num_nodes == 40 and cfg.storage.device_type == "cuda"
    # sizing reads the card's memory: no card, no size
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cpu"):
        with pytest.raises(RuntimeError, match="hbm_bytes, or --num_partitions"):
            cli.main(["config_generator", ds], device=device)
    assert "embeddings" not in generate_config(ds, hbm_bytes=16e9)["storage"]
    nc = generate_config(ds, task="NODE_CLASSIFICATION", device="cpu")
    assert nc["model"]["learning_task"] == "NODE_CLASSIFICATION"


# -- db2graph, env info ----------------------------------------------------------

def _sqlite(tmp_path):
    db = str(tmp_path / "g.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE follows (a TEXT, rel TEXT, b TEXT)")
    conn.executemany("INSERT INTO follows VALUES (?,?,?)",
                     [("u1", "follows", "u2"), ("u2", "follows", "u3")])
    conn.execute("CREATE TABLE person (pid TEXT, city TEXT)")
    conn.executemany("INSERT INTO person VALUES (?,?)",
                     [("U1 ", "NYC"), ("u2", "0"), ("u3", "paris"), ("u3", "paris")])
    conn.commit()
    conn.close()
    return db


@pytest.mark.parametrize("spelling", ["free_form", "entity", "reference"])
def test_db2graph_writes_jax_files(tmp_path, spelling):
    db = _sqlite(tmp_path)
    if spelling == "free_form":
        cfg = {"db_type": "sqlite", "connection": {"database": db},
               "edge_queries": ["SELECT a, rel, b FROM follows", "SELECT pid, city FROM person"]}
    elif spelling == "entity":
        cfg = {"db_type": "sqlite", "connection": {"database": db},
               "entity_edge_queries": ["SELECT person.pid, person.city FROM person"],
               "entity_edge_relations": ["lives_in"]}
    else:
        qfile = tmp_path / "queries.txt"
        qfile.write_text("lives_in\nSELECT person.pid, person.city FROM person\n")
        cfg = {"db_server": "sqlite", "db_name": db, "db_user": None, "db_password": None,
               "db_host": None, "edges_queries": str(qfile)}
    cfg_path = tmp_path / "db.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    args = ["db2graph", "--config_path", str(cfg_path), "--output_directory"]
    assert jcli.main(args + [str(tmp_path / "j")]) == 0
    assert cli.main(args + [str(tmp_path / "t")], device="cpu") == 0
    assert_same_files(tmp_path / "j", tmp_path / "t")
    if spelling == "free_form":
        assert (tmp_path / "t" / "edges.txt").read_text().splitlines()[:2] == [
            "u1\tfollows\tu2", "u2\tfollows\tu3"]


@pytest.mark.parametrize("query", [
    "SELECT a.x, b.y FROM a JOIN b ON a.k = b.k", "SELECT a.x AS z, b.y FROM a",
    "UPDATE a.x, b.y FROM a", "SELECT a.x b.y FROM a", "SELECT ax, b.y FROM a",
    "SELECT a.x, b.y c.z FROM a", "SELECT a.x"])
def test_db2graph_query_validation_matches_jax(query):
    from marius_tpu.tools.db2graph import validate_entity_entity_query as j_validate
    from marius_tpu_torch.tools.db2graph import validate_entity_entity_query as t_validate

    def outcome(fn):
        try:
            return fn(query)
        except ValueError as e:
            return str(e)
    assert outcome(t_validate) == outcome(j_validate)


def test_env_info_has_jax_keys_for_torch(monkeypatch, capsys):
    from marius_tpu.tools.env_info import collect_env_info as j_info
    from marius_tpu_torch.tools.env_info import collect_env_info as t_info

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    j, t = j_info(), t_info()
    rename = {"jax": "torch", "marius_tpu": "marius_tpu_torch"}
    assert [rename.get(k, k) for k in j] == list(t)
    assert set(t["devices"]) == set(j["devices"]) == {"count", "platform", "kinds"}
    assert t["devices"] == {"count": 0, "platform": "cpu", "kinds": []}
    assert t["torch"]["version"] == torch.__version__
    assert cli.main(["env_info"]) == 0
    assert "marius_tpu_torch" in capsys.readouterr().out


# -- the baseline harness ------------------------------------------------------------

@pytest.mark.parametrize("twin", ["_write_lp_twin", "_write_nc_twin"])
def test_verify_baselines_twins_match_jax(tmp_path, twin):
    from marius_tpu.tools import verify_baselines as jvb
    from marius_tpu_torch.tools import verify_baselines as tvb

    getattr(jvb, twin)(str(tmp_path / "j"))
    getattr(tvb, twin)(str(tmp_path / "t"))
    assert_same_files(tmp_path / "j", tmp_path / "t")


def _fake_fb15k_raw(raw_dir, num_nodes=40, num_rels=6, num_edges=600, seed=0):
    rng = np.random.default_rng(seed)
    lines = [f"/m/{s:05d}\t/rel/{r}\t/m/{d:05d}\n" for s, r, d in zip(
        rng.integers(0, num_nodes, num_edges), rng.integers(0, num_rels, num_edges),
        rng.integers(0, num_nodes, num_edges))]
    os.makedirs(raw_dir, exist_ok=True)
    cuts = [int(0.9 * num_edges), int(0.95 * num_edges)]
    for name, chunk in zip(("train.txt", "valid.txt", "test.txt"),
                           (lines[:cuts[0]], lines[cuts[0]:cuts[1]], lines[cuts[1]:])):
        with open(os.path.join(raw_dir, name), "w") as f:
            f.writelines(chunk)


def _fake_ogbn_raw(sub):
    import gzip

    rng = np.random.default_rng(0)
    n, f, e = 60, 8, 400
    (sub / "raw").mkdir(parents=True)
    (sub / "split" / "time").mkdir(parents=True)
    with gzip.open(sub / "raw" / "edge.csv.gz", "wt") as fh:
        fh.writelines(f"{s},{d}\n" for s, d in rng.integers(0, n, (e, 2)))
    with gzip.open(sub / "raw" / "node-feat.csv.gz", "wt") as fh:
        fh.writelines(",".join(f"{x:.4f}" for x in row) + "\n" for row in rng.normal(0, 1, (n, f)))
    with gzip.open(sub / "raw" / "node-label.csv.gz", "wt") as fh:
        fh.write("\n".join(str(int(x)) for x in rng.integers(0, 40, n)) + "\n")
    perm = rng.permutation(n)
    for name, ids in (("train", perm[:40]), ("valid", perm[40:50]), ("test", perm[50:])):
        with gzip.open(sub / "split" / "time" / f"{name}.csv.gz", "wt") as fh:
            fh.write("\n".join(str(int(x)) for x in ids) + "\n")


def _block_network(monkeypatch, module):
    def no_net(url, output_dir, overwrite=False):
        from pathlib import Path
        p = Path(output_dir) / url.rsplit("/", 1)[-1]
        if p.exists() and not overwrite:
            return p
        raise AssertionError(f"network touched for {url}")
    monkeypatch.setattr(module, "download_url", no_net)


@pytest.mark.parametrize("layout", ["fb15k_237_extracted", "fb15k_237_archive", "ogbn_arxiv"])
def test_raw_files_give_jax_dataset_files(tmp_path, monkeypatch, layout):
    """--raw-files staging with the download blocked: the port's dataset
    classes write the JAX package's files (tests/test_verify_baselines.py:48-140)."""
    from marius_tpu.tools import verify_baselines as jvb
    from marius_tpu.tools.preprocess import datasets as jds
    from marius_tpu_torch.tools import verify_baselines as tvb
    from marius_tpu_torch.tools.preprocess import datasets as tds

    raw = tmp_path / "raw"
    if layout == "fb15k_237_extracted":
        _fake_fb15k_raw(str(raw / "fb15k_237"))
    elif layout == "fb15k_237_archive":
        stage = tmp_path / "stage"
        _fake_fb15k_raw(str(stage / "Release"))
        raw.mkdir()
        with zipfile.ZipFile(raw / "FB15K-237.2.zip", "w") as z:
            for name in ("train.txt", "valid.txt", "test.txt"):
                z.write(stage / "Release" / name, f"Release/{name}")
    else:
        _fake_ogbn_raw(raw / "ogbn_arxiv" / "arxiv")
    name = "ogbn_arxiv" if layout == "ogbn_arxiv" else "fb15k_237"
    for who, vb, ds_mod in (("j", jvb, jds), ("t", tvb, tds)):
        _block_network(monkeypatch, ds_mod)
        cls = ds_mod.OGBNArxiv if name == "ogbn_arxiv" else ds_mod.FB15K237
        out = tmp_path / who / name
        assert vb._stage_raw_files(str(raw), str(out), name, cls.dataset_url)
        d = cls(str(out))
        d.download()
        d.preprocess()
    assert_same_files(tmp_path / "j", tmp_path / "t")


def test_verify_baselines_command_reports(tmp_path, capsys, monkeypatch):
    from marius_tpu_torch.tools import verify_baselines as tvb
    from marius_tpu_torch.tools.preprocess import datasets as tds

    """The LP twin, 1 epoch (the NC twin's epoch, padded to ogbn_arxiv.yaml's
    hop caps, takes ~20 s on one CPU thread; tools_cli runs both on the card)."""
    rc = cli.main(["verify_baselines", "--synthetic", "--dataset", "fb15k_237", "--epochs", "1",
                   "--data-root", str(tmp_path)], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    reports = [json.loads(line) for line in lines[-2:-1]]
    assert [r["dataset"] for r in reports] == ["fb15k_237"]
    for r in reports:
        assert set(r) == {"dataset", "synthetic", "metric", "value", "threshold", "passed",
                          "reference"}
        assert r["synthetic"] is True and 0.0 < r["value"] <= 1.0
        assert r["passed"] == (r["value"] >= r["threshold"])
    passed = sum(r["passed"] for r in reports)
    assert lines[-1] == f"verify_baselines: {'PASS' if passed == 1 else 'FAIL'} ({passed}/1)"
    assert rc == (0 if passed == 1 else 1)

    # real mode reaches the downloader for a fresh directory
    def fake_download(self, overwrite=False):
        raise RuntimeError("no egress")
    monkeypatch.setattr(tds.FB15K237, "download", fake_download)
    with pytest.raises(RuntimeError, match="no egress"):
        tvb.verify_fb15k237(str(tmp_path / "real"), synthetic=False, device="cpu")


def test_predict_labels_match_jax(tmp_path):
    """NC: ogbn_arxiv.yaml's model on tests/test_torch_manager.py's 240-node
    graph (every degree <= 3, so no draw matters), trained by JAX; both
    ``marius_predict --save_labels`` write the same labels and accuracy."""
    from marius_tpu.tools.predict import run_predict as j_predict
    from marius_tpu_torch.tools.predict import run_predict as t_predict
    from tests.test_torch_manager import _nc_raw

    raw = _nc_raw(tmp_path, "nc", **{"storage.save_model": True, "training.num_epochs": 1,
                                     "storage.model_dir": str(tmp_path / "model")})
    cfg = tmp_path / "nc.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    assert jcli.marius_train([str(cfg)]) == 0
    jres = j_predict(str(cfg), str(tmp_path / "j"), save_labels=True)
    tres = t_predict(str(cfg), str(tmp_path / "t"), save_labels=True, device="cpu")
    assert tres["accuracy"] == jres["accuracy"] and tres["num_evaluated"] == jres["num_evaluated"]
    labels = (tmp_path / "t" / "labels.csv").read_bytes()
    assert labels == (tmp_path / "j" / "labels.csv").read_bytes()
    assert len(labels.splitlines()) == 50
