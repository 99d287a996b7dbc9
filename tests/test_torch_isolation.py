"""The port stands alone: marius_tpu_torch imports neither JAX nor marius_tpu,
and its entry point does not fall back to the CPU by itself."""

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
    assert int(out[0]) >= 15, out   # every module of the slice was imported
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
