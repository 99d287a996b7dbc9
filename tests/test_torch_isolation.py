"""The port stands alone: marius_tpu_torch imports neither JAX nor marius_tpu,
and its entry points do not fall back to the CPU by themselves."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import marius_tpu_torch
names = [m.name for m in pkgutil.walk_packages(marius_tpu_torch.__path__, "marius_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "marius_tpu") or m.startswith(("jax.", "jaxlib.", "marius_tpu.")))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_marius_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 47, out   # every module of the slices so far was imported
    assert out[1:] == ["[]"], out


def test_trainer_without_device_needs_cuda(monkeypatch):
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import LINK_PREDICTION, Model
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(LINK_PREDICTION, EncoderConfig(((LayerConfig("EMBEDDING", output_dim=8),),)),
                  EdgeDecoder("DISTMULT", 2, 8))
    edges = np.array([[0, 0, 1], [1, 1, 2]], np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LinkPredictionTrainer(model, 3, 2, edges, NegativeSamplingConfig(1, 2), batch_size=2)
    trainer = LinkPredictionTrainer(model, 3, 2, edges, NegativeSamplingConfig(1, 2),
                                    batch_size=2, device="cpu")
    assert trainer.device.type == "cpu"
    assert np.isfinite(trainer.train_epoch()["loss"])


def test_nc_trainer_without_device_needs_cuda(monkeypatch):
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model
    from marius_tpu_torch.ops.cuda import nbr_sum
    from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(NODE_CLASSIFICATION, EncoderConfig((
        (LayerConfig("FEATURE", output_dim=4, bias=True),),
        (LayerConfig("GNN", input_dim=4, output_dim=3, activation="RELU"),),
        (LayerConfig("GNN", input_dim=3, output_dim=2),))), loss_type="CROSS_ENTROPY")
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [0, 2]], np.int32)
    rng = np.random.default_rng(0)
    args = (model, build_device_graph(edges, 5), rng.standard_normal((5, 4)).astype(np.float32),
            np.array([0, 1, 0, 1, 1]), np.array([0, 1, 2]))
    kw = dict(batch_size=2, full_graph=build_full_graph_adjacency(edges, 5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NodeClassificationTrainer(*args, **kw)
    before = nbr_sum.launches
    trainer = NodeClassificationTrainer(*args, device="cpu", **kw)
    assert trainer.device.type == "cpu" and trainer._fg_seed_restrict
    assert np.isfinite(trainer.train_epoch()["loss"])
    res = NodeClassificationEvaluator(trainer, np.array([3, 4])).evaluate(trainer.state)
    assert res["num_evaluated"] == 2.0 and 0.0 <= res["accuracy"] <= 1.0
    # the CPU path runs the plain version
    assert nbr_sum.launches == before


def test_manager_without_device_needs_cuda(monkeypatch, tmp_path):
    from marius_tpu.tools.preprocess import generate_random_dataset_lp
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train
    from tests.test_manager import LP_BASE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = {**LP_BASE, "storage": {"dataset": {"dataset_dir": str(tmp_path / "ds")},
                                  "model_dir": str(tmp_path / "model")}}
    generate_random_dataset_lp(str(tmp_path / "ds"), num_nodes=20, num_edges=200,
                               num_relations=3)
    for entry in (marius_train, marius_eval):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(load_config(raw))
    assert not (tmp_path / "model").exists()
