"""GAT and RGCN encoders end to end through the port, on the CPU.

- The manager on the small NC dataset of tests/test_torch_manager.py
  (ogbn_arxiv.yaml's model with its GNN stages switched to GAT or RGCN;
  every in- and out-degree is at most 3, so the sampler takes every
  neighbour once and no draw matters): a model the JAX ``marius_train``
  trains and saves gives JAX's test accuracy through the port's
  ``marius_eval``, and the port's own ``marius_train`` reloads through
  ``marius_eval`` exactly. An exact-ALL RGCN config (tests/test_nc_e2e.py:413)
  trains through the full-graph trainer with the relational companion.
- The reference's gat_1_layer and rgcn_1_layer LP fragments
  (tests/test_manager.py:239-263) through the port's ``marius_train`` and
  ``marius_eval``; exact-ALL evaluation of an RGCN and a GAT encoder equals
  sampled ALL evaluation (tests/test_lp_gnn.py:195).
- The pinned GAT and RGCN accuracy bands of
  tests/test_accuracy_regression.py:169,200 (>= 0.95 and [0.72, 1.0]),
  trained and evaluated by the port.
"""

import copy

import numpy as np
import pytest

from marius_tpu.config.schema import load_config as j_load_config
from marius_tpu.manager import marius_train as j_marius_train
from marius_tpu.tools.preprocess import generate_random_dataset_nc
from marius_tpu_torch.config import load_config
from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
from marius_tpu_torch.data.graph import build_device_graph
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
from marius_tpu_torch.manager import marius_eval, marius_train
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig
from marius_tpu_torch.nn.model import LINK_PREDICTION, NODE_CLASSIFICATION, Model
from marius_tpu_torch.nn.optimizers import OptimizerConfig
from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer
from marius_tpu_torch.train.trainer import LinkPredictionTrainer
from tests.test_lp_e2e import NUM_NODES, NUM_RELS, generate_random_lp_dataset
from tests.test_manager import GAT_ENCODER
from tests.test_nc_e2e import NUM_NODES as COMMUNITY_NODES
from tests.test_nc_e2e import community_graph
from tests.test_torch_manager import METRICS, NC_CLASSES, _lp_config, _nc_raw
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GNN_OPTIONS = {"GAT": {"type": "GAT", "num_heads": 2}, "RGCN": {"type": "RGCN"}}


def _switched(raw, gnn):
    for stage in raw["model"]["encoder"]["layers"][1:]:
        stage[0]["options"] = dict(GNN_OPTIONS[gnn])
    return raw


@pytest.mark.parametrize("gnn", list(GNN_OPTIONS))
def test_nc_manager_runs_gat_and_rgcn(tmp_path, gnn):
    raw = _switched(_nc_raw(tmp_path, gnn, **{
        "storage.save_model": True, "storage.model_dir": str(tmp_path / "model_j")}), gnn)
    jres = j_marius_train(j_load_config(raw))
    tres = marius_eval(load_config(raw), device="cpu")
    assert tres["test"]["num_evaluated"] == jres["test"]["num_evaluated"] == 50
    assert tres["test"]["accuracy"] == jres["test"]["accuracy"]

    raw["storage"]["model_dir"] = str(tmp_path / "model_p")
    res = marius_train(load_config(raw), device="cpu")
    trainer = res["runtime"].trainer
    assert trainer.full_graph is None and len(res["epochs"]) == 3
    assert res["epochs"][-1]["loss"] < res["epochs"][0]["loss"]
    again = marius_eval(load_config(raw), device="cpu")
    assert again["test"] == {k: res["test"][k] for k in ("accuracy", "num_evaluated")}
    assert res["test"]["accuracy"] > 1.0 / NC_CLASSES


def test_nc_manager_rgcn_full_graph(tmp_path):
    """tests/test_nc_e2e.py:413: an ALL-everywhere RGCN config builds the
    adjacency with its relational companion and trains through the
    full-graph path (its seed-restricted final stage on the relational
    seed lists)."""
    ds_dir = str(tmp_path / "ds_nc_rgcn_fg")
    generate_random_dataset_nc(ds_dir, num_nodes=60, num_edges=600, num_classes=4,
                               feature_dim=8)
    raw = {
        "model": {
            "learning_task": "NODE_CLASSIFICATION",
            "encoder": {
                "layers": [[{"type": "FEATURE", "output_dim": 8}],
                           [{"type": "GNN", "input_dim": 8, "output_dim": 4,
                             "options": {"type": "RGCN"}}]],
                "train_neighbor_sampling": [{"type": "ALL"}],
                "full_graph": "ON",
            },
            "loss": {"type": "CROSS_ENTROPY", "options": {"reduction": "SUM"}},
            "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": 0.01}},
        },
        "storage": {"dataset": {"dataset_dir": ds_dir}, "save_model": True,
                    "model_dir": str(tmp_path / "model")},
        "training": {"batch_size": 30, "num_epochs": 2},
        "evaluation": {"batch_size": 30},
    }
    res = marius_train(load_config(raw), device="cpu")
    trainer = res["runtime"].trainer
    assert trainer.full_graph is not None and trainer.full_graph.rel is not None
    assert trainer._fg_seed_restrict and trainer._fg_rel_csr is not None
    assert len(res["epochs"]) == 2 and all(np.isfinite(e["loss"]) for e in res["epochs"])
    assert 0.0 <= res["test"]["accuracy"] <= 1.0
    again = marius_eval(load_config(raw), device="cpu")
    assert again["test"] == {k: res["test"][k] for k in ("accuracy", "num_evaluated")}


@pytest.mark.parametrize("gnn", list(GNN_OPTIONS))
@pytest.mark.parametrize("all_eval", [False, True], ids=["sampled-eval", "exact-all-eval"])
def test_lp_manager_runs_gat_and_rgcn(tmp_path, gnn, all_eval):
    """gat_1_layer and rgcn_1_layer through marius_train (2 epochs) and
    marius_eval, which reloads the test metrics exactly; with ALL evaluation
    the evaluators encode through the full graph (with the relational
    companion for RGCN)."""
    enc = copy.deepcopy(GAT_ENCODER)
    enc["layers"][1][0]["options"] = dict(GNN_OPTIONS[gnn])
    if all_eval:
        enc["eval_neighbor_sampling"] = [{"type": "ALL"}]
    raw = _lp_config(tmp_path, f"{gnn}_{all_eval}", **{
        "model.encoder": enc, "storage.save_model": True,
        "storage.model_dir": str(tmp_path / "model")})
    res = marius_train(load_config(raw), device="cpu")
    rt = res["runtime"]
    assert len(res["epochs"]) == 2 and all(np.isfinite(e["loss"]) for e in res["epochs"])
    assert 0.0 < res["test"]["mrr"] <= 1.0
    fg = rt.test_evaluator.full_graph
    assert (fg is not None) == all_eval
    if all_eval:
        assert (fg.rel is not None) == (gnn == "RGCN")
        assert (fg.inv_map is not None) == (gnn == "GAT")
    again = marius_eval(load_config(raw), device="cpu")
    assert all(again["test"][k] == res["test"][k] for k in METRICS)


@pytest.mark.parametrize("gnn", list(GNN_OPTIONS))
def test_full_graph_lp_eval_matches_sampled_all(gnn):
    """tests/test_lp_gnn.py:195 on the port (and its GAT twin): exact-ALL
    full-graph evaluation with an EMBEDDING input equals sampled ALL."""
    dim = 16
    layer = dict(gnn_type="RGCN", num_relations=NUM_RELS, bias=True) if gnn == "RGCN" else \
        dict(gnn_type="GAT", num_heads=2, bias=True)
    model = Model(LINK_PREDICTION, EncoderConfig((
        (LayerConfig("EMBEDDING", output_dim=dim),),
        (LayerConfig("GNN", input_dim=dim, output_dim=dim, **layer),))),
        EdgeDecoder("DISTMULT", NUM_RELS, dim), loss_type="SOFTMAX_CE", loss_reduction="SUM",
        dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.05), sparse_lr=0.1)
    train, valid, test = generate_random_lp_dataset()
    graph = build_device_graph(train, NUM_NODES, NUM_RELS)
    nbr_all = [NeighborSamplingConfig("ALL", max_neighbors=int(graph.degrees.max()))]
    trainer = LinkPredictionTrainer(model, NUM_NODES, NUM_RELS, train,
                                    NegativeSamplingConfig(5, 20), batch_size=100, seed=0,
                                    graph=graph, nbr_configs=nbr_all, device="cpu")
    trainer.train(2)
    kw = dict(all_edges=np.concatenate([train, valid, test]), batch_size=100, filtered=True,
              graph=graph, nbr_configs=nbr_all, device="cpu")
    sampled = LinkPredictionEvaluator(model, NUM_NODES, NUM_RELS, train[:100], **kw)
    fg = LinkPredictionEvaluator(model, NUM_NODES, NUM_RELS, train[:100],
                                 full_graph=build_full_graph_adjacency(
                                     train, NUM_NODES, with_relations=gnn == "RGCN"), **kw)
    a, b = sampled.evaluate(trainer.state), fg.evaluate(trainer.state)
    assert abs(a["mrr"] - b["mrr"]) < 1e-4, (a["mrr"], b["mrr"])
    assert abs(a["hits@10"] - b["hits@10"]) < 1e-6
    np.testing.assert_allclose(fg._encode(trainer.state).numpy(),
                               sampled._encode(trainer.state).numpy(), rtol=1e-5, atol=1e-5)


# -- the pinned accuracy bands -----------------------------------------------------

def _nc_accuracy(edges, n, feats, labels, stages, perm, rels=1):
    """Test accuracy after 30 epochs on perm[:300], UNIFORM 8 per hop, batch
    100, Adam lr 0.01 (the JAX tests' settings)."""
    model = Model(NODE_CLASSIFICATION, EncoderConfig(stages), None,
                  loss_type="CROSS_ENTROPY", loss_reduction="SUM",
                  dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.01))
    trainer = NodeClassificationTrainer(
        model, build_device_graph(edges, n, rels), feats, labels, perm[:300],
        [NeighborSamplingConfig("UNIFORM", max_neighbors=8)] * 2, batch_size=100, seed=0,
        device="cpu")
    trainer.train(30)
    return NodeClassificationEvaluator(trainer, perm[300:]).evaluate(trainer.state)["accuracy"]


def test_nc_gat_pinned_accuracy():
    """tests/test_accuracy_regression.py:169: 2-layer GAT on the community
    graph, test accuracy >= 0.95."""
    edges, feats, labels = community_graph()
    acc = _nc_accuracy(edges, COMMUNITY_NODES, feats, labels, (
        (LayerConfig("FEATURE", output_dim=8),),
        (LayerConfig("GNN", gnn_type="GAT", input_dim=8, output_dim=16, bias=True,
                     num_heads=2, activation="RELU"),),
        (LayerConfig("GNN", gnn_type="GAT", input_dim=16, output_dim=4, bias=True,
                     num_heads=2),)), np.random.default_rng(1).permutation(COMMUNITY_NODES))
    assert acc >= 0.95, f"GAT accuracy {acc:.4f} below pinned 0.95"


def test_nc_rgcn_pinned_accuracy():
    """tests/test_accuracy_regression.py:200: 2-layer RGCN where relation r
    connects class c to class (c + r) mod C and features are weak: test
    accuracy in [0.72, 1.0]."""
    rng = np.random.default_rng(2)
    n, c, r, f = 400, 4, 3, 8
    labels = rng.integers(0, c, n).astype(np.int32)
    edges = []
    for _ in range(n * 8):
        u = rng.integers(0, n)
        rel = rng.integers(0, r)
        cand = np.flatnonzero(labels == (labels[u] + rel) % c)
        edges.append((u, rel, cand[rng.integers(len(cand))]))
    edges = np.unique(np.array(edges, np.int32), axis=0)
    feats = rng.normal(0, 1.0, (n, f)).astype(np.float32)
    feats[np.arange(n), labels % f] += 0.5
    # the split comes from the same generator after the data, as in JAX's test
    acc = _nc_accuracy(edges, n, feats, labels, (
        (LayerConfig("FEATURE", output_dim=f),),
        (LayerConfig("GNN", gnn_type="RGCN", input_dim=f, output_dim=16, bias=True,
                     num_relations=r, activation="RELU"),),
        (LayerConfig("GNN", gnn_type="RGCN", input_dim=16, output_dim=c, bias=True,
                     num_relations=r),)), rng.permutation(n), rels=r)
    assert 0.72 <= acc <= 1.0, f"RGCN accuracy {acc:.4f} outside pinned band [0.72, 1.0]"
