"""The port's custom-component registry against marius_tpu's (parity: the
reference's Python trampolines, layer_wrap.cpp:10-22).

The same components are registered in both registries (a GNN layer, a stage
layer, a loss, a relation operator and an edge decoder built from it). The
port's dispatchers and config validator must take the names as they take
built-in ones, and compute what the JAX package computes on the same inputs:
the custom GNN layer inside the sampled encoder over JAX's neighbour batch,
the custom decoder's scores, the custom loss (rtol 1e-5 / atol 1e-6, float32
on both sides). A registered GNN layer also trains through the sampled NC
trainer.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marius_tpu.nn import registry as jreg
from marius_tpu_torch.config import load_config
from marius_tpu_torch.config.validate import ConfigError
from marius_tpu_torch.nn import registry as treg
from tests.test_registry import _config
from tests.test_torch_sampled_nc import _close, _jax_batch, to_torch_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
NAMES = {"gnn": "T_MEAN_RESIDUAL", "stage": "T_DENSE", "loss": "T_DOUBLE_CE",
         "rel": "T_SCALED_HADAMARD", "decoder": "T_SCALED_DISTMULT"}


def _register_jax():
    from marius_tpu.nn.initialization import initialize_tensor
    from marius_tpu.nn.losses import softmax_ce
    from marius_tpu.ops.segment import masked_mean

    def init(key, cfg, dtype):
        return {"w": initialize_tensor(key, cfg.init, (cfg.input_dim, cfg.output_dim), dtype)}

    def fwd(cfg, params, x, adj, **ctx):
        return (x[adj.self_idx] + masked_mean(x[adj.in_nbr_idx], adj.in_mask)) @ params["w"]

    def loss(pos, neg, *, reduction="MEAN", mask=None, neg_mask=None):
        return 2.0 * softmax_ce(pos, neg, reduction=reduction, mask=mask, neg_mask=neg_mask)

    jreg.register_gnn_layer(NAMES["gnn"], init, fwd)
    jreg.register_stage_layer(NAMES["stage"], init, lambda cfg, p, cur, emb, feat: cur @ p["w"])
    jreg.register_loss(NAMES["loss"], loss)
    jreg.register_relation_op(NAMES["rel"], lambda e, r: e * r * 0.5 if r is not None else e)
    jreg.register_edge_decoder(NAMES["decoder"], "DOT", NAMES["rel"], relation_init="ones")


def _register_torch():
    from marius_tpu_torch.nn.initialization import initialize_tensor
    from marius_tpu_torch.nn.losses import softmax_ce
    from marius_tpu_torch.ops.segment import masked_mean

    def init(generator, cfg, dtype):
        return {"w": initialize_tensor(generator, cfg.init, (cfg.input_dim, cfg.output_dim),
                                       dtype)}

    def fwd(cfg, params, x, adj, **ctx):
        nbr = masked_mean(x[adj.in_nbr_idx.long()], adj.in_mask)
        return (x[adj.self_idx.long()] + nbr) @ params["w"]

    def loss(pos, neg, *, reduction="MEAN", mask=None, neg_mask=None):
        return 2.0 * softmax_ce(pos, neg, reduction=reduction, mask=mask, neg_mask=neg_mask)

    treg.register_gnn_layer(NAMES["gnn"], init, fwd)
    treg.register_stage_layer(NAMES["stage"], init, lambda cfg, p, cur, emb, feat: cur @ p["w"])
    treg.register_loss(NAMES["loss"], loss)
    treg.register_relation_op(NAMES["rel"], lambda e, r: e * r * 0.5 if r is not None else e)
    treg.register_edge_decoder(NAMES["decoder"], "DOT", NAMES["rel"], relation_init="ones")


@pytest.fixture(autouse=True)
def _registered():
    _register_jax()
    _register_torch()
    yield
    for reg in (jreg, treg):
        for table, key in ((reg._GNN_LAYERS, "gnn"), (reg._STAGE_LAYERS, "stage"),
                           (reg._LOSSES, "loss"), (reg._RELATION_OPS, "rel"),
                           (reg._EDGE_DECODERS, "decoder")):
            table.pop(NAMES[key], None)


def test_names_are_checked_and_case_blind():
    with pytest.raises(ValueError, match="bad loss name"):
        treg.register_loss("no spaces", lambda *a, **k: 0.0)
    assert treg.gnn_layer(NAMES["gnn"].lower()) is treg.gnn_layer(NAMES["gnn"])
    assert treg.comparator("NOPE") is None and treg.edge_decoder("NOPE") is None


def test_custom_loss_scales_builtin():
    from marius_tpu.nn.losses import get_loss_function as j_loss
    from marius_tpu_torch.nn.losses import get_loss_function as t_loss

    pos, neg = np.array([1.0, 2.0], np.float32), np.array([[0.5, 0.1], [0.2, 0.3]], np.float32)
    base = t_loss("SOFTMAX_CE", reduction="SUM")(torch.from_numpy(pos), torch.from_numpy(neg))
    doubled = t_loss(NAMES["loss"], reduction="SUM")(torch.from_numpy(pos),
                                                     torch.from_numpy(neg))
    assert float(doubled) == pytest.approx(2 * float(base), rel=1e-6)
    _close(doubled, j_loss(NAMES["loss"], reduction="SUM")(jnp.asarray(pos), jnp.asarray(neg)),
           **TOL)


def test_custom_stage_and_gnn_layers_match_jax():
    """EMBEDDING -> registered GNN layer -> registered stage layer over JAX's
    sampled batch."""
    import marius_tpu.nn.encoder as jenc
    import marius_tpu_torch.nn.encoder as tenc
    from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
    from marius_tpu.nn.layers import LayerConfig as JLayer
    from marius_tpu_torch.nn.layers import LayerConfig as TLayer

    def cfg(enc, layer):
        return enc.EncoderConfig(((layer("EMBEDDING", output_dim=6),),
                                  (layer("GNN", input_dim=6, output_dim=5,
                                         gnn_type=NAMES["gnn"]),),
                                  (layer(NAMES["stage"], input_dim=5, output_dim=3),)))

    jcfg, tcfg = cfg(jenc, JLayer), cfg(tenc, TLayer)
    jp = jenc.init_encoder_params(jax.random.key(0), jcfg)
    tp = tenc.init_encoder_params(torch.Generator().manual_seed(0), tcfg)
    assert [[set(d) for d in s] for s in tp] == [[set(d) for d in s] for s in jp]
    tp = [[{k: torch.from_numpy(np.array(v)) for k, v in d.items()} for d in s] for s in jp]
    _, jb = _jax_batch([JNbr("UNIFORM", 4)])
    emb = np.random.default_rng(0).standard_normal((jb.node_ids[0].shape[0], 6))
    emb = emb.astype(np.float32)
    _close(tenc.encoder_forward(tcfg, tp, torch.from_numpy(emb), None, to_torch_batch(jb)),
           jenc.encoder_forward(jcfg, jp, jnp.asarray(emb), None, jb), **TOL)


def test_custom_edge_decoder_matches_jax():
    from marius_tpu.nn.decoders.edge import EdgeDecoder as JDecoder
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder as TDecoder

    rng = np.random.default_rng(1)
    src, dst = (rng.standard_normal((6, 8)).astype(np.float32) for _ in range(2))
    negs = rng.standard_normal((2, 5, 8)).astype(np.float32)
    rels = np.array([0, 1, 2, 0, 1, 2])
    jd, td = JDecoder(NAMES["decoder"], 3, 8), TDecoder(NAMES["decoder"], 3, 8)
    with torch.no_grad():
        td.relations.copy_(torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32)))
        td.inverse_relations.copy_(td.relations * 2)
    jp = {"relations": jnp.asarray(td.relations.detach().numpy()),
          "inverse_relations": jnp.asarray(td.inverse_relations.detach().numpy())}
    t_out = td.node_corrupt_forward(*(torch.from_numpy(a) for a in (src, dst, rels, negs, negs)))
    j_out = jd.node_corrupt_forward(jp, *(jnp.asarray(a) for a in (src, dst, rels, negs, negs)))
    for t, j in zip(t_out, j_out):
        _close(t, j, **TOL)
    td.init_params()
    assert bool((td.relations.detach() == 1.0).all())
    with pytest.raises(ValueError, match="Unknown edge decoder"):
        TDecoder("NOPE_DECODER", 3, 8)


def test_validation_accepts_registered_rejects_unknown(tmp_path):
    raw = _config(tmp_path, "val")
    cfg = load_config(copy.deepcopy(raw))   # registered names validate cleanly
    assert cfg.model.decoder.decoder_type == NAMES["decoder"]
    assert cfg.model.encoder.stages[1][0].gnn_type.upper() == NAMES["gnn"]
    for path, bad in ((("model", "encoder", "layers", 1, 0, "options", "type"), "NOPE_LAYER"),
                      (("model", "decoder", "type"), "NOPE_DECODER"),
                      (("model", "loss", "type"), "NOPE_LOSS")):
        broken = copy.deepcopy(raw)
        node = broken
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = bad
        with pytest.raises(ConfigError, match=bad):
            load_config(broken)


def test_registered_gnn_layer_trains_through_the_sampled_trainer():
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig
    from marius_tpu_torch.train.nc import NodeClassificationTrainer
    from tests.test_torch_sampled_nc import _graph_data, N, F, CLASSES
    from marius_tpu_torch.data.graph import build_device_graph

    edges, feats, labels, train = _graph_data()
    model = Model(NODE_CLASSIFICATION, EncoderConfig((
        (LayerConfig("FEATURE", output_dim=F),),
        (LayerConfig("GNN", input_dim=F, output_dim=CLASSES, gnn_type=NAMES["gnn"]),))),
        loss_type="CROSS_ENTROPY", loss_reduction="SUM",
        dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.05))
    tr = NodeClassificationTrainer(model, build_device_graph(edges, N), feats, labels, train,
                                   [NeighborSamplingConfig("UNIFORM", 5)], batch_size=50,
                                   device="cpu")
    losses = [r["loss"] for r in tr.train(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
