"""Modules of the port (LP and NC slices) against their marius_tpu counterparts.

Each test feeds the same seed-made numpy inputs to the JAX function and to
the port's, on the CPU. Tolerance: rtol=1e-5, atol=1e-6 for values and
gradients. Both sides compute in float32 but may sum and fuse in another
order, which 1e-5 relative covers at these sizes. Initialization draws from
different generators (threefry in JAX, Philox/MT in torch), so it is held to
bounds and moments only.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marius_tpu.data.samplers import negative as jneg
from marius_tpu.nn import encoder as jenc
from marius_tpu.nn import losses as jlosses
from marius_tpu.nn import model as jmodel
from marius_tpu.nn import optimizers as jopt
from marius_tpu.nn.decoders import edge as jedge
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.ops.unique import unique_padded as j_unique_padded
from marius_tpu_torch.data.samplers import negative as tneg
from marius_tpu_torch.nn import encoder as tenc
from marius_tpu_torch.nn import initialization as tinit
from marius_tpu_torch.nn import losses as tlosses
from marius_tpu_torch.nn import model as tmodel
from marius_tpu_torch.nn import optimizers as topt
from marius_tpu_torch.nn.decoders import edge as tedge
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.ops.unique import unique_padded as t_unique_padded
from marius_tpu_torch.parallel.embedding_table import init_embedding_table
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-6


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# -- decoders ---------------------------------------------------------------

@pytest.mark.parametrize("decoder_type", ["DISTMULT", "COMPLEX", "TRANSE"])
def test_node_corrupt_forward_values_and_grads(decoder_type):
    rng = np.random.default_rng(0)
    b, c, n, d, r = 12, 3, 5, 8, 4
    src, dst = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    dneg, sneg = (rng.standard_normal((c, n, d)).astype(np.float32) for _ in range(2))
    rels, inv_rels = (rng.standard_normal((r, d)).astype(np.float32) for _ in range(2))
    rel_ids = rng.integers(0, r, b)
    w = [rng.standard_normal(s).astype(np.float32) for s in [(b,), (b, n), (b,), (b, n)]]

    jdec = jedge.EdgeDecoder(decoder_type, r, d)

    def jloss(params, s, t, dn, sn):
        outs = jdec.node_corrupt_forward(params, s, t, jnp.asarray(rel_ids), dn, sn)
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w)), outs

    jparams = {"relations": jnp.asarray(rels), "inverse_relations": jnp.asarray(inv_rels)}
    (jl, jouts), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jparams, src, dst, dneg, sneg)

    tdec = tedge.EdgeDecoder(decoder_type, r, d)
    with torch.no_grad():
        tdec.relations.copy_(torch.from_numpy(rels))
        tdec.inverse_relations.copy_(torch.from_numpy(inv_rels))
    ins = [_t(a, True) for a in (src, dst, dneg, sneg)]
    touts = tdec.node_corrupt_forward(ins[0], ins[1], torch.from_numpy(rel_ids), ins[2], ins[3])
    tl = sum((o * torch.from_numpy(wi)).sum() for o, wi in zip(touts, w))
    tl.backward()

    for to, jo in zip(touts, jouts):
        _close(to, jo)
    _close(tdec.relations.grad, jgrads[0]["relations"])
    _close(tdec.inverse_relations.grad, jgrads[0]["inverse_relations"])
    for ti, jg in zip(ins, jgrads[1:]):
        _close(ti.grad, jg)


@pytest.mark.parametrize("decoder_type,first", [("DISTMULT", 1.0), ("COMPLEX", 1.0),
                                                ("TRANSE", 0.0)])
def test_decoder_init_params_match(decoder_type, first):
    jp = jedge.EdgeDecoder(decoder_type, 3, 6).init_params()
    tdec = tedge.EdgeDecoder(decoder_type, 3, 6)
    _close(tdec.relations, jp["relations"])
    _close(tdec.inverse_relations, jp["inverse_relations"])
    assert float(tdec.relations.detach()[0, 0]) == first
    with pytest.raises(ValueError):
        tedge.EdgeDecoder("NOPE", 3, 6)


# -- losses -----------------------------------------------------------------

LOSSES = ["SOFTMAX_CE", "RANKING", "CROSS_ENTROPY", "BCE_AFTER_SIGMOID",
          "BCE_WITH_LOGITS", "MSE", "SOFTPLUS"]


@pytest.mark.parametrize("reduction", ["SUM", "MEAN"])
@pytest.mark.parametrize("loss_type", LOSSES)
def test_losses_match(loss_type, reduction):
    rng = np.random.default_rng(1)
    b, n = 10, 7
    # wide scores: softplus must stay exact above 20
    pos = (rng.standard_normal(b) * 15).astype(np.float32)
    neg = (rng.standard_normal((b, n)) * 15).astype(np.float32)
    mask = rng.random(b) < 0.7
    neg_mask = rng.random((b, n)) < 0.8
    neg_mask[:, 0] = True
    jf = jlosses.get_loss_function(loss_type, reduction=reduction, margin=0.3)
    tf = tlosses.get_loss_function(loss_type, reduction=reduction, margin=0.3)

    def jl(p, q):
        return jf(p, q, mask=jnp.asarray(mask), neg_mask=jnp.asarray(neg_mask))

    jv, (jgp, jgn) = jax.value_and_grad(jl, argnums=(0, 1))(pos, neg)
    tp, tn = _t(pos, True), _t(neg, True)
    tv = tf(tp, tn, mask=torch.from_numpy(mask), neg_mask=torch.from_numpy(neg_mask))
    tv.backward()
    _close(tv, jv)
    _close(tp.grad, jgp)
    _close(tn.grad, jgn)
    # unmasked too
    _close(tf(_t(pos), _t(neg)), jf(pos, neg))


def test_loss_reduction_none_and_unknown():
    rng = np.random.default_rng(2)
    pos, neg = rng.standard_normal(4).astype(np.float32), rng.standard_normal((4, 3)).astype(np.float32)
    _close(tlosses.softmax_ce(_t(pos), _t(neg), reduction="NONE"),
           jlosses.softmax_ce(pos, neg, reduction="NONE"))
    with pytest.raises(ValueError):
        tlosses.get_loss_function("NOPE")


# -- optimizers -------------------------------------------------------------

OPTS = [
    dict(optimizer_type="SGD", learning_rate=0.1),
    dict(optimizer_type="SGD", learning_rate=0.1, momentum=0.9, weight_decay=0.01),
    dict(optimizer_type="ADAGRAD", learning_rate=0.1, lr_decay=0.01, init_value=0.1),
    dict(optimizer_type="ADAM", learning_rate=0.1),
    dict(optimizer_type="ADAM", learning_rate=0.01, amsgrad=True, weight_decay=0.1),
]


@pytest.mark.parametrize("cfg", OPTS, ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_optimizers_three_steps(cfg):
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = [{"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]} for _ in range(3)]
    jcfg, tcfg = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_optimizer(jcfg, jp)
    tp = topt.tree_map(lambda a: torch.tensor(a), params)
    ts = topt.init_optimizer(tcfg, tp)
    for g in grads:
        jp, js = jopt.apply_optimizer(jcfg, jp, js, jax.tree.map(jnp.asarray, g))
        tp, ts = topt.apply_optimizer(tcfg, tp, ts, topt.tree_map(torch.tensor, g))
    topt.tree_map(_close, tp, jp)
    assert ts.step == int(js.step) == 3
    topt.tree_map(_close, ts.slots, js.slots)


def test_optimizer_none_grad_is_zero():
    cfg = topt.OptimizerConfig("ADAM", learning_rate=0.1)
    p = {"w": torch.ones(3)}
    s = topt.init_optimizer(cfg, p)
    p, s = topt.apply_optimizer(cfg, p, s, {"w": torch.full((3,), 0.5)})
    after_one = p["w"].clone()
    p, s = topt.apply_optimizer(cfg, p, s, {"w": None})  # momentum still moves it, as in JAX
    jcfg = jopt.OptimizerConfig("ADAM", learning_rate=0.1)
    jp = {"w": jnp.ones(3)}
    js = jopt.init_optimizer(jcfg, jp)
    jp, js = jopt.apply_optimizer(jcfg, jp, js, {"w": jnp.full((3,), 0.5)})
    _close(after_one, jp["w"])
    jp, js = jopt.apply_optimizer(jcfg, jp, js, {"w": jnp.zeros(3)})
    _close(p["w"], jp["w"])


# -- initialization ---------------------------------------------------------

def test_init_bounds_and_moments():
    g = torch.Generator().manual_seed(0)
    n, d = 4000, 50
    table = init_embedding_table(g, n, d)
    limit = math.sqrt(6.0 / (n + d))
    v = table.values
    assert v.shape == (n, d) and v.dtype == torch.float32
    assert float(v.abs().max()) <= limit
    assert abs(float(v.mean())) < 0.01 * limit
    assert abs(float(v.std()) - limit / math.sqrt(3)) < 0.01 * limit
    assert float(table.state.abs().max()) == 0.0

    cfg = tinit.InitConfig("GLOROT_NORMAL")
    x = tinit.initialize_tensor(g, cfg, (300, 200))
    assert abs(float(x.std()) - math.sqrt(2.0 / 500)) < 0.02 * math.sqrt(2.0 / 500)
    u = tinit.initialize_tensor(g, tinit.InitConfig("UNIFORM", scale_factor=0.5), (1000,))
    assert float(u.abs().max()) <= 0.5
    x = tinit.initialize_tensor(g, tinit.InitConfig("NORMAL", mean=2.0, std=0.5), (20000,))
    assert abs(float(x.mean()) - 2.0) < 0.02 and abs(float(x.std()) - 0.5) < 0.02
    assert float(tinit.initialize_tensor(g, tinit.InitConfig("CONSTANT", constant=3.0),
                                         (2, 2)).min()) == 3.0
    assert tinit.compute_fans((7, 3)) == (7, 3) == jax_fans((7, 3))
    with pytest.raises(ValueError):
        tinit.initialize_tensor(g, tinit.InitConfig("NOPE"), (2,))


def jax_fans(shape):
    from marius_tpu.nn.initialization import compute_fans
    return compute_fans(shape)


# -- unique, negative sampling ----------------------------------------------

def test_unique_padded_matches_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 40, 60).astype(np.int32)
    ids[:3] = 40   # fill value itself appears, as padding ids do in the trainer
    j = j_unique_padded(jnp.asarray(ids), size=80, fill_value=40)
    t = t_unique_padded(torch.from_numpy(ids).long(), size=80, fill_value=40)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.inverse.numpy(), np.asarray(j.inverse))
    assert int(t.count) == int(j.count)


def test_deg_local_filter_mask_matches_jax():
    rng = np.random.default_rng(5)
    for b, c, nb, n in [(40, 4, 6, 20), (33, 3, 5, 9)]:
        rows = rng.integers(0, b, (c, nb)).astype(np.int32)
        j = jneg.deg_local_filter_mask(jnp.asarray(rows), b, n)
        t = tneg.deg_local_filter_mask(torch.from_numpy(rows).long(), b, n)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.any()


def test_sample_negatives_layout():
    cfg = tneg.NegativeSamplingConfig(num_chunks=4, negatives_per_positive=20,
                                      degree_fraction=0.25)
    edges = torch.stack([torch.arange(16), torch.zeros(16, dtype=torch.long),
                         torch.arange(16) + 100], 1)
    g = torch.Generator().manual_seed(0)
    for inverse, col in [(False, 2), (True, 0)]:
        ns = tneg.sample_negatives(g, cfg, edges, 500, inverse=inverse)
        assert ns.ids.shape == (4, 20) and ns.deg_sample_indices.shape == (4, 5)
        # degree-sampled ids first: the batch endpoints of the sampled rows
        assert torch.equal(ns.ids[:, :5], edges[:, col][ns.deg_sample_indices])
        assert int(ns.ids.min()) >= 0 and int(ns.ids.max()) < 500
    assert tneg.local_filters_active(cfg) == jneg.local_filters_active(
        jneg.NegativeSamplingConfig(4, 20, 0.25))
    # LocalFilterMode ALL: the in-batch true-edge mask equals the JAX package's
    mask = torch.arange(16) < 13
    for inverse in (False, True):
        t = tneg.local_filter_mask_dir(
            tneg.NegativeSamplingConfig(4, 20, 0.25, local_filter_mode="ALL"), edges,
            mask, ns, inverse)
        j = jneg.local_filter_mask_dir(
            jneg.NegativeSamplingConfig(4, 20, 0.25, local_filter_mode="ALL"),
            jnp.asarray(edges.numpy()), jnp.asarray(mask.numpy()),
            jneg.NegativeSample(jnp.asarray(ns.ids.numpy()),
                                jnp.asarray(ns.deg_sample_indices.numpy())), inverse)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# -- encoder and model ------------------------------------------------------

def test_encoder_forward_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((9, 12)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    jstages = ((JLayerConfig("EMBEDDING", output_dim=5, offset=2, bias=True, activation="RELU"),
                JLayerConfig("EMBEDDING", output_dim=7, offset=5, activation="SIGMOID")),)
    tstages = ((TLayerConfig("EMBEDDING", output_dim=5, offset=2, bias=True, activation="RELU"),
                TLayerConfig("EMBEDDING", output_dim=7, offset=5, activation="SIGMOID")),)
    jcfg, tcfg = jenc.EncoderConfig(jstages), tenc.EncoderConfig(tstages)
    assert tcfg.embedding_dim == jcfg.embedding_dim == 12
    jp = [[{"bias": jnp.asarray(bias)}, {}]]
    tp = [[{"bias": torch.from_numpy(bias)}, {}]]
    _close(tenc.encoder_forward(tcfg, tp, torch.from_numpy(x), None),
           jenc.encoder_forward(jcfg, jp, jnp.asarray(x), None))
    # an EMBEDDING and a FEATURE layer side by side
    f = rng.standard_normal((9, 6)).astype(np.float32)
    jcfg_f = jenc.EncoderConfig(((JLayerConfig("EMBEDDING", output_dim=4),
                                  JLayerConfig("FEATURE", output_dim=3, offset=1, bias=True)),))
    tcfg_f = tenc.EncoderConfig(((TLayerConfig("EMBEDDING", output_dim=4),
                                  TLayerConfig("FEATURE", output_dim=3, offset=1, bias=True)),))
    assert tcfg_f.has_features and jcfg_f.has_features
    _close(tenc.encoder_forward(tcfg_f, [[{}, {"bias": torch.from_numpy(bias[:3])}]],
                                torch.from_numpy(x), torch.from_numpy(f)),
           jenc.encoder_forward(jcfg_f, [[{}, {"bias": jnp.asarray(bias[:3])}]],
                                jnp.asarray(x), jnp.asarray(f)))
    g = torch.Generator().manual_seed(0)
    tinit_p = tenc.init_encoder_params(g, tcfg)
    assert set(tinit_p[0][0]) == {"bias"} and tinit_p[0][1] == {}
    # GraphSAGE/GCN stages have parameters (test_gnn_layer_params_match_jax),
    # GAT stages w, a_l and a_r (tests/test_torch_gat.py holds them against
    # JAX); the sampled GNN forward runs over a NeighborBatch
    # (tests/test_torch_sampled_nc.py) and refuses to run without one
    gat = tenc.init_encoder_params(g, tenc.EncoderConfig(((TLayerConfig("GNN", 4, 4, gnn_type="GAT",
                                                                        num_heads=2),),)))
    assert {k: tuple(v.shape) for k, v in gat[0][0].items()} == \
        {"w": (4, 8), "a_l": (2, 4), "a_r": (2, 4)}
    with pytest.raises(ValueError, match="NeighborBatch"):
        tenc.encoder_forward(tenc.EncoderConfig(((TLayerConfig("GNN", 4, 4),),)),
                             [[{}]], None, torch.zeros(3, 4))


def test_lp_batch_loss_matches_jax():
    rng = np.random.default_rng(7)
    u, b, c, n, d, r = 30, 12, 3, 5, 8, 4
    enc = rng.standard_normal((u, d)).astype(np.float32)
    inv_src, inv_dst = rng.integers(0, u, b), rng.integers(0, u, b)
    inv_dn, inv_sn = rng.integers(0, u, (c, n)), rng.integers(0, u, (c, n))
    rel = rng.integers(0, r, b)
    mask = rng.random(b) < 0.8
    dfilt, sfilt = rng.random((b, n)) < 0.2, rng.random((b, n)) < 0.2
    rels = rng.standard_normal((r, d)).astype(np.float32)

    jm = jmodel.Model(jmodel.LINK_PREDICTION,
                      jenc.EncoderConfig(((JLayerConfig("EMBEDDING", output_dim=d),),)),
                      jedge.EdgeDecoder("DISTMULT", r, d))
    jparams = {"decoder": {"relations": jnp.asarray(rels),
                           "inverse_relations": jnp.asarray(rels * 0.5)}}

    def jl(e):
        return jmodel.lp_batch_loss(jm, jparams, e, *map(jnp.asarray, (inv_src, inv_dst, rel,
                                                                        inv_dn, inv_sn, mask,
                                                                        dfilt, sfilt)))[0]

    jv, jg = jax.value_and_grad(jl)(jnp.asarray(enc))

    tdec = tedge.EdgeDecoder("DISTMULT", r, d)
    tm = tmodel.Model(tmodel.LINK_PREDICTION,
                      tenc.EncoderConfig(((TLayerConfig("EMBEDDING", output_dim=d),),)), tdec)
    tparams = tmodel.init_model_params(torch.Generator(), tm)
    with torch.no_grad():
        tparams["decoder"]["relations"].copy_(torch.from_numpy(rels))
        tparams["decoder"]["inverse_relations"].copy_(torch.from_numpy(rels * 0.5))
    te = _t(enc, True)
    tv, _ = tmodel.lp_batch_loss(tm, te, *map(torch.from_numpy, (inv_src, inv_dst, rel,
                                                                  inv_dn, inv_sn, mask,
                                                                  dfilt, sfilt)))
    tv.backward()
    _close(tv, jv)
    _close(te.grad, jg)


# -- node classification ----------------------------------------------------

@pytest.mark.parametrize("gnn_type,aggregator,names", [
    ("GRAPH_SAGE", "MEAN", {"w1", "w2", "bias"}), ("GRAPH_SAGE", "GCN", {"w1", "bias"}),
    ("GCN", "MEAN", {"w", "bias"})])
def test_gnn_layer_params_match_jax(gnn_type, aggregator, names):
    """Same names and shapes as the JAX package; Glorot-uniform bounds."""
    from marius_tpu.nn.layers.layers import init_layer_params as j_init
    from marius_tpu_torch.nn.layers import init_layer_params as t_init

    kw = dict(layer_type="GNN", input_dim=24, output_dim=40, gnn_type=gnn_type,
              aggregator=aggregator, bias=True)
    jp = j_init(jax.random.key(0), JLayerConfig(**kw))
    tp = t_init(torch.Generator().manual_seed(0), TLayerConfig(**kw))
    assert set(tp) == set(jp) == names
    limit = math.sqrt(6.0 / 64)
    for k, t in tp.items():
        assert tuple(t.shape) == tuple(jp[k].shape) and t.dtype == torch.float32
        if k == "bias":
            assert not t.any()
        else:
            assert float(t.abs().max()) <= limit and float(t.std()) > 0.5 * limit / math.sqrt(3)


@pytest.mark.parametrize("reduction", ["SUM", "MEAN"])
def test_nc_batch_loss_matches_jax(reduction):
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((20, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 20)
    mask = rng.random(20) < 0.7
    stages = ((JLayerConfig("FEATURE", output_dim=7),),)
    jm = jmodel.Model(jmodel.NODE_CLASSIFICATION, jenc.EncoderConfig(stages),
                      loss_type="CROSS_ENTROPY", loss_reduction=reduction)
    tm = tmodel.Model(tmodel.NODE_CLASSIFICATION,
                      tenc.EncoderConfig(((TLayerConfig("FEATURE", output_dim=7),),)),
                      loss_type="CROSS_ENTROPY", loss_reduction=reduction)
    jv, jg = jax.value_and_grad(lambda x: jmodel.nc_batch_loss(
        jm, x, jnp.asarray(labels), jnp.asarray(mask)))(jnp.asarray(logits))
    tx = _t(logits, True)
    tv = tmodel.nc_batch_loss(tm, tx, torch.from_numpy(labels), torch.from_numpy(mask))
    tv.backward()
    _close(tv, jv)
    _close(tx.grad, jg)
    _close(tlosses.classification_cross_entropy(tx.detach(), torch.from_numpy(labels),
                                                reduction="NONE"),
           jlosses.classification_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                reduction="NONE"))


def test_nc_model_params_have_no_decoder():
    cfg = tenc.EncoderConfig(((TLayerConfig("FEATURE", output_dim=4, bias=True),),
                              (TLayerConfig("GNN", 4, 3, bias=True),)))
    params = tmodel.init_model_params(torch.Generator(), tmodel.Model(
        tmodel.NODE_CLASSIFICATION, cfg))
    assert set(params) == {"encoder"}
    assert set(params["encoder"][1][0]) == {"w1", "w2", "bias"}
    assert all(p.requires_grad for s in params["encoder"] for layer in s for p in layer.values())


def test_categorical_accuracy_and_segment_sum_match_jax():
    from marius_tpu.ops.segment import segment_sum as j_segment_sum
    from marius_tpu.reporting.metrics import categorical_accuracy_statistics as j_acc
    from marius_tpu_torch.ops.segment import segment_sum as t_segment_sum
    from marius_tpu_torch.reporting.metrics import categorical_accuracy_statistics as t_acc

    rng = np.random.default_rng(10)
    logits = rng.standard_normal((50, 6)).astype(np.float32)
    logits[:5] = 0.0   # ties: both take the first maximum
    labels = rng.integers(0, 6, 50)
    mask = rng.random(50) < 0.6
    for m in (None, mask):
        j = j_acc(jnp.asarray(logits), jnp.asarray(labels), None if m is None else jnp.asarray(m))
        t = t_acc(torch.from_numpy(logits), torch.from_numpy(labels),
                  None if m is None else torch.from_numpy(m))
        assert float(t["correct"]) == float(j["correct"]) and float(t["count"]) == float(j["count"])
    data = rng.standard_normal((40, 3)).astype(np.float32)
    seg = rng.integers(0, 9, 40)
    _close(t_segment_sum(torch.from_numpy(data), torch.from_numpy(seg), 9),
           j_segment_sum(jnp.asarray(data), jnp.asarray(seg), 9))
