"""The port's ``examples/python_torch`` twins of ``examples/python`` run on
the CPU (mirrors tests/test_examples.py:29,59,74 and
tests/test_registry.py:140).

Each twin runs with ``device="cpu"`` at a test size (its module-level
``NUM_EPOCHS`` cut to 2) on fabricated data: ``custom_nc_graphsage`` on a
CORA-shaped raw dataset and ``custom_lp`` on an edge CSV, their downloads
stubbed; ``fb15k_237`` and ``ogbn_arxiv_nc`` on ``generate_random_dataset_*``
directories; ``fb15k_237_mesh`` under two gloo CPU ranks in processes of
their own, joined through torchrun's environment. The JAX twins draw their
own numbers, so each twin's metrics are held against the port's own trainer
and evaluator called directly on the same data, which give the same numbers
on the CPU; the mesh twin's against the one-process twin's. Every twin
defaults to the GPU, and no twin imports JAX or ``marius_tpu``.
"""

import ast
import importlib.util
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from marius_tpu_torch.data.graph import build_device_graph
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
from marius_tpu_torch.nn import registry
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig
from marius_tpu_torch.nn.model import LINK_PREDICTION, Model
from marius_tpu_torch.nn.optimizers import OptimizerConfig
from marius_tpu_torch.storage.dataset import (
    load_features,
    load_labels,
    load_node_split,
    load_split,
    load_stats,
)
from marius_tpu_torch.tools.preprocess.generate import (
    generate_random_dataset_lp,
    generate_random_dataset_nc,
)
from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer
from marius_tpu_torch.train.trainer import LinkPredictionTrainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "python_torch"
TWINS = ("custom_layer", "custom_lp", "custom_nc_graphsage", "fb15k_237", "fb15k_237_mesh",
         "ogbn_arxiv_nc")
EPOCHS = 2
JOIN_SECONDS = 240


def _load(name, argv):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    old = sys.argv
    sys.argv = [str(EXAMPLES / f"{name}.py"), *argv]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = old
    mod.NUM_EPOCHS = EPOCHS
    return mod


def _lp_direct(mod, ds):
    """The LP twins' model, trainer and filtered evaluation called directly."""
    stats = load_stats(ds)
    splits = [load_split(ds, s, stats) for s in ("train", "valid", "test")]
    rels = max(stats.num_relations, 1)
    model = Model(LINK_PREDICTION, EncoderConfig(((LayerConfig(
        "EMBEDDING", output_dim=mod.EMBEDDING_DIM),),)),
        EdgeDecoder("DISTMULT", rels, mod.EMBEDDING_DIM, use_inverse_relations=True),
        loss_type="SOFTMAX_CE", loss_reduction="SUM",
        dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.1), sparse_lr=0.1)
    trainer = LinkPredictionTrainer(model, stats.num_nodes, rels, splits[0],
                                    NegativeSamplingConfig(num_chunks=mod.NUM_CHUNKS,
                                                           negatives_per_positive=mod.NEGATIVES),
                                    batch_size=mod.BATCH_SIZE, device="cpu")
    ev = LinkPredictionEvaluator(model, stats.num_nodes, rels, splits[2],
                                 all_edges=np.concatenate(splits), batch_size=mod.BATCH_SIZE,
                                 filtered=True, device="cpu")
    losses = [trainer.train_epoch()["loss"] for _ in range(EPOCHS)]
    return losses, ev.evaluate(trainer.state)


def _nc_direct(model, ds, fanout, hops, batch_size):
    """An NC twin's model through the trainer and evaluator called directly."""
    stats = load_stats(ds)
    trainer = NodeClassificationTrainer(
        model, build_device_graph(load_split(ds, "train", stats), stats.num_nodes),
        load_features(ds, stats), load_labels(ds, stats), load_node_split(ds, "train"),
        [NeighborSamplingConfig("UNIFORM", max_neighbors=fanout)] * hops,
        batch_size=batch_size, device="cpu")
    losses = [trainer.train_epoch()["loss"] for _ in range(EPOCHS)]
    ev = NodeClassificationEvaluator(trainer, load_node_split(ds, "test"))
    return losses, ev.evaluate(trainer.state)


def _epoch_losses(out):
    return [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
            if line.startswith("epoch ")]


def _same(got, want):
    assert {k: v for k, v in got.items() if k != "eval_time_s"} == \
        {k: v for k, v in want.items() if k != "eval_time_s"}


def test_custom_nc_graphsage_twin(tmp_path, capsys, monkeypatch):
    mod = _load("custom_nc_graphsage", [str(tmp_path)])
    # a tiny CORA-shaped raw dataset instead of the download
    rng = np.random.default_rng(0)
    n, f = 80, 12
    raw_dir = tmp_path / "cora"
    raw_dir.mkdir(parents=True)
    ids = rng.choice(10_000, size=n, replace=False)
    with open(raw_dir / "cora.content", "w") as fh:
        for i in range(n):
            words = rng.integers(0, 2, size=f)
            cls = mod.CLASS_NAMES[rng.integers(len(mod.CLASS_NAMES))]
            fh.write(f"{ids[i]}\t" + "\t".join(map(str, words)) + f"\t{cls}\n")
    with open(raw_dir / "cora.cites", "w") as fh:
        for _ in range(300):
            a, b = rng.choice(ids, size=2, replace=False)
            fh.write(f"{a}\t{b}\n")

    def fake_download(self, overwrite=False):
        self.content_file, self.cites_file = raw_dir / "cora.content", raw_dir / "cora.cites"

    monkeypatch.setattr(mod.Cora, "download", fake_download)
    res = mod.main(device="cpu")
    out = capsys.readouterr().out
    assert "epoch 2" in out and "accuracy" in out
    stats = load_stats(str(tmp_path))
    assert (stats.num_nodes, stats.feature_dim, stats.num_classes) == (n, f, 7)
    model = Model("NODE_CLASSIFICATION", EncoderConfig((
        (LayerConfig("FEATURE", output_dim=f),),
        (LayerConfig("GNN", gnn_type="GRAPH_SAGE", bias=True, input_dim=f,
                     output_dim=mod.HIDDEN_DIM, activation="RELU"),),
        (LayerConfig("GNN", gnn_type="GRAPH_SAGE", bias=True, input_dim=mod.HIDDEN_DIM,
                     output_dim=7),))), None, loss_type="CROSS_ENTROPY",
        loss_reduction="SUM", dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.01))
    losses, want = _nc_direct(model, str(tmp_path), mod.FANOUT, 2, mod.BATCH_SIZE)
    _same(res, want)
    np.testing.assert_allclose(_epoch_losses(out), losses, rtol=0, atol=0.051)


def test_ogbn_arxiv_nc_twin(tmp_path, capsys):
    ds = str(tmp_path / "ds")
    generate_random_dataset_nc(ds, num_nodes=200, num_edges=800, num_classes=5, feature_dim=8)
    mod = _load("ogbn_arxiv_nc", [ds])
    res = mod.main(device="cpu")
    out = capsys.readouterr().out
    assert "epoch 2" in out and "accuracy" in out
    losses, want = _nc_direct(mod.init_model(8, 5), ds, mod.FANOUT, 3, mod.BATCH_SIZE)
    _same(res, want)
    np.testing.assert_allclose(_epoch_losses(out), losses, rtol=0, atol=0.051)


def test_fb15k_237_twin(tmp_path, capsys):
    ds = str(tmp_path / "ds")
    generate_random_dataset_lp(ds, num_nodes=60, num_edges=600, num_relations=4)
    mod = _load("fb15k_237", [ds, "--device", "cpu"])
    assert mod.ARGS.device == "cpu" and mod.DATASET_DIR == ds
    res = mod.main(device=mod.ARGS.device)
    out = capsys.readouterr().out
    assert "epoch 2" in out and "mrr" in out
    losses, want = _lp_direct(mod, ds)
    _same(res, want)
    np.testing.assert_allclose(_epoch_losses(out), losses, rtol=0, atol=0.051)


def test_custom_lp_twin(tmp_path, capsys, monkeypatch):
    out_dir = tmp_path / "custom_lp"
    mod = _load("custom_lp", [str(out_dir)])
    rng = np.random.default_rng(1)
    csv = tmp_path / "edge.csv"
    with open(csv, "w") as fh:
        for a, b in rng.integers(0, 70, (700, 2)):
            fh.write(f"{1000 + a},{1000 + b}\n")

    def fake_download(self, overwrite=False):
        self.input_train_edges_file = csv

    monkeypatch.setattr(mod.MyDataset, "download", fake_download)
    res = mod.main(device="cpu")
    out = capsys.readouterr().out
    assert "epoch 2" in out and "mrr" in out
    stats = load_stats(str(out_dir))
    assert stats.num_relations in (0, 1) and stats.num_nodes <= 70
    losses, want = _lp_direct(mod, str(out_dir))
    _same(res, want)
    np.testing.assert_allclose(_epoch_losses(out), losses, rtol=0, atol=0.051)


@pytest.fixture
def custom_names():
    names = {"_GNN_LAYERS": "MEAN_RESIDUAL", "_RELATION_OPS": "SCALED_HADAMARD",
             "_EDGE_DECODERS": "SCALED_DISTMULT", "_LOSSES": "SQUARED_SOFTMAX_CE"}
    yield names
    for table, name in names.items():
        getattr(registry, table).pop(name, None)


def test_custom_layer_twin_registers_and_trains(custom_names, capsys):
    mod = _load("custom_layer", [])
    # registered on import
    assert registry.gnn_layer("MEAN_RESIDUAL") == (mod.mean_residual_init,
                                                  mod.mean_residual_forward)
    assert registry.loss("SQUARED_SOFTMAX_CE") is mod.sq_softmax_ce
    assert registry.edge_decoder("SCALED_DISTMULT")[:2] == ("DOT", "SCALED_HADAMARD")
    assert registry.relation_op("SCALED_HADAMARD") is not None
    res = mod.main(device="cpu")
    out = capsys.readouterr().out
    assert "losses:" in out and "test MRR:" in out
    losses = [e["loss"] for e in res["epochs"]]
    assert len(losses) == EPOCHS and np.isfinite(losses).all()
    assert 0.0 < res["test"]["mrr"] <= 1.0
    # the custom GNN layer holds parameters the run trained
    layer = res["runtime"].trainer.state.params["encoder"][1][0]
    assert set(layer) == {"w"} and layer["w"].shape == (16, 16)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_fb15k_237_mesh_twin_on_two_ranks(tmp_path):
    """Two gloo CPU ranks under torchrun's environment: a {data: 1, node: 2}
    mesh; rank 0 alone prints; the test metrics match the one-process
    twin's on the same data."""
    ds = str(tmp_path / "ds")
    generate_random_dataset_lp(ds, num_nodes=60, num_edges=600, num_relations=4)
    code = ("import importlib.util, sys; sys.argv = sys.argv[1:]; "
            "spec = importlib.util.spec_from_file_location('twin', sys.argv[0]); "
            "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod); "
            f"mod.NUM_EPOCHS = {EPOCHS}; mod.main('cpu')")
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "2", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(EXAMPLES / "fb15k_237_mesh.py"),
                               ds], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              cwd=str(tmp_path), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_SECONDS)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-3000:] for o in outs)
    lead = [ln for ln in outs[0].splitlines() if not ln.startswith("[")]
    assert any(ln.startswith("mesh: {'data': 1, 'node': 2} over 2 ranks (gloo)")
               for ln in lead), outs[0][-3000:]
    assert not any(ln.startswith(("mesh:", "epoch ", "{")) for ln in outs[1].splitlines())
    metrics = [ln for ln in lead if ln.startswith("{")]
    got = ast.literal_eval(metrics[-1])
    mod = _load("fb15k_237", [ds])
    want = mod.main(device="cpu")
    assert set(got) == {k for k in want if k != "eval_time_s"} | (
        {"eval_time_s"} if "eval_time_s" in got else set())
    for k in ("mrr", "mean_rank", "hits@1", "hits@10"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=2e-4, err_msg=k)


def test_twins_default_to_the_gpu(tmp_path, monkeypatch, custom_names):
    """With no card and no ``device``, a twin raises as the entry points do."""
    ds = str(tmp_path / "ds")
    generate_random_dataset_lp(ds, num_nodes=60, num_edges=600, num_relations=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("fb15k_237", [ds]), ("custom_layer", [])):
        mod = _load(name, argv)
        assert mod.ARGS.device is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main()


def test_twins_import_neither_jax_nor_marius_tpu():
    """Every twin's import lines name only the port, torch, numpy and the
    standard library; loading all six in a fresh ``python -X importtime``
    process imports no module of JAX or the JAX package."""
    allowed = {"marius_tpu_torch", "torch", "numpy"} | set(sys.stdlib_module_names)
    for name in TWINS:
        tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
        roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)}
        assert roots <= allowed, (name, roots - allowed)
    code = ("import importlib.util, sys\n"
            f"for name in {TWINS!r}:\n"
            f"    spec = importlib.util.spec_from_file_location(name, {str(EXAMPLES)!r} + "
            "'/' + name + '.py')\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")
    proc = subprocess.run([sys.executable, "-X", "importtime", "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=JOIN_SECONDS,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = {line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
            if line.startswith("import time:")}
    assert "marius_tpu_torch" in seen and "torch" in seen
    bad = {m for m in seen if m.split(".")[0] in ("jax", "jaxlib", "marius_tpu")}
    assert not bad, sorted(bad)
