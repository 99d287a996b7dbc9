"""The port's RGCN layers, on the CPU, against marius_tpu's.

The same numpy inputs, made from a seed, go through the JAX function and
the port's: the sampled layer at R <= 64 (the port sums per relation first,
one gather-sum call, then one matmul; JAX runs a masked matmul per
relation) and at R > 64 (a matrix per slot on both sides), the relational
full graph (its arrays must equal JAX's exactly), its relational sum with
gradients, the full-graph encoder (all-N and seed-restricted, with the
constant first stage's cached slot gather and without), and the NC trainers
over 2 epochs. Tolerances as in tests/test_torch_gat.py: layers rtol 1e-5 /
atol 1e-6, full-graph sums rtol 1e-5 / atol 1e-5, trainers rtol 1e-4 / atol
1e-5. Last, ``convert.train_state_from_jax`` carries GAT and RGCN
parameters: one JAX init gives the same encodings in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marius_tpu.nn.layers.layers as jlayers
import marius_tpu_torch.nn.layers.layers as tlayers
from marius_tpu.data import full_graph as jfg
from marius_tpu.data import full_graph_rel as jrel
from marius_tpu.nn import full_graph_encoder as jfge
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.encoder import encoder_forward as j_encoder_forward
from marius_tpu.nn.encoder import init_encoder_params as j_init_encoder
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu_torch.convert import train_state_from_jax
from marius_tpu_torch.data import full_graph as tfg
from marius_tpu_torch.data import full_graph_rel as trel
from marius_tpu_torch.nn import full_graph_encoder as tfge
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.encoder import encoder_forward as t_encoder_forward
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.ops.segment import relational_nbr_sum
from tests.test_torch_gat import (
    FG_ATOL,
    FG_RTOL,
    NC_N,
    _close,
    _jparams_to_torch,
    check_trainers,
    np_state,
    random_adjacency,
    sampled_all_encoding,
    trainer_pair,
)
from tests.test_torch_sampled_nc import to_torch_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, E, F, R = 120, 900, 8, 4


# -- the sampled layer ----------------------------------------------------------

@pytest.mark.parametrize("rels", [5, 70], ids=["sum-first", "matrix-per-slot"])
def test_rgcn_layer_matches_jax(rels):
    rng = np.random.default_rng(0)
    jadj, tadj = random_adjacency(rng, 20, 40, 5, 6, rels=rels)
    kw = dict(layer_type="GNN", gnn_type="RGCN", input_dim=7, output_dim=5,
              num_relations=rels, bias=True, activation="RELU")
    jcfg, tcfg = JLayerConfig(**kw), TLayerConfig(**kw)
    jp = jlayers.init_layer_params(jax.random.key(0), jcfg)
    tp = _jparams_to_torch(jp)
    assert set(tlayers.init_layer_params(torch.Generator().manual_seed(0), tcfg)) == set(jp)
    x = rng.standard_normal((40, 7)).astype(np.float32)
    u = rng.standard_normal((20, 5)).astype(np.float32)

    def jf(x_, p_):
        out = jlayers.rgcn_layer(jcfg, p_, x_, jadj)
        return jnp.sum(out * u), out

    (_, jout), (jgx, jgp) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tlayers.rgcn_layer(tcfg, tp, tx, tadj)
    (tout * torch.from_numpy(u)).sum().backward()
    _close(tout, jout)
    _close(tx.grad, jgx)
    for k in jp:
        _close(tp[k].grad, jgp[k])


def test_relational_nbr_sum_against_a_loop():
    """Per target and relation, the sum of the valid slots of that relation;
    relations outside [0, R) and masked slots add nothing; the backward
    adds each slot's gradient row into its input row."""
    rng = np.random.default_rng(1)
    n, n_x, w, r = 12, 30, 7, 3
    idx = torch.from_numpy(rng.integers(0, n_x + 3, (n, w)))    # some past the end
    mask = torch.from_numpy(rng.random((n, w)) < 0.7)
    rel = torch.from_numpy(rng.integers(-1, r + 1, (n, w)))
    x = torch.randn(n_x, 4, dtype=torch.float32, requires_grad=True)
    out = relational_nbr_sum(x, idx, mask, rel, r)
    want = torch.zeros(n, r, 4)
    for i in range(n):
        for t in range(w):
            if mask[i, t] and 0 <= rel[i, t] < r:
                want[i, rel[i, t]] += x.detach()[min(int(idx[i, t]), n_x - 1)]
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    g = torch.randn(n, r, 4)
    (out * g).sum().backward()
    gx = torch.zeros(n_x, 4)
    for i in range(n):
        for t in range(w):
            if mask[i, t] and 0 <= rel[i, t] < r:
                gx[min(int(idx[i, t]), n_x - 1)] += g[i, rel[i, t]]
    torch.testing.assert_close(x.grad, gx, rtol=1e-6, atol=1e-6)


def test_sampled_rgcn_encoder_matches_jax():
    """A two-stage RGCN encoder over a sampled batch of a relational graph
    (the batch's out-slot relations), forward and gradients."""
    from marius_tpu.data.graph import build_device_graph
    from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig, sample_neighbor_batch
    jg = build_device_graph(_rel_edges(3), NC_N, 3)
    seeds = np.random.default_rng(1).permutation(NC_N)[:32].astype(np.int32)
    jb = sample_neighbor_batch(jax.random.key(3), jg, jnp.asarray(seeds),
                               jnp.asarray(np.arange(32) < 28),
                               [NeighborSamplingConfig("UNIFORM", 5)] * 2, [32, 200, NC_N + 1])
    assert jb.layers[0].out_rel is not None
    tb = to_torch_batch(jb)
    jcfg, tcfg = [enc(Layer, Enc, 3) for Layer, Enc in ((JLayerConfig, JEncoderConfig),
                                                        (TLayerConfig, TEncoderConfig))]
    jp = j_init_encoder(jax.random.key(2), jcfg)
    tp = [[_jparams_to_torch(d) for d in stage] for stage in jp]
    feats = np.random.default_rng(3).standard_normal((jb.node_ids[0].shape[0], F)).astype(
        np.float32)
    u = np.random.default_rng(4).standard_normal((jb.node_ids[-1].shape[0], 3)).astype(
        np.float32)

    def jf(p_):
        out = j_encoder_forward(jcfg, p_, None, jnp.asarray(feats), jb)
        return jnp.sum(out * u), out

    (_, jout), jgp = jax.value_and_grad(jf, has_aux=True)(jp)
    tout = t_encoder_forward(tcfg, tp, None, torch.from_numpy(feats), tb)
    (tout * torch.from_numpy(u)).sum().backward()
    _close(tout, jout)
    for ts, js in zip(tp, jgp):
        for k in js[0]:
            _close(ts[0][k].grad, js[0][k])


def enc(layer_cls, enc_cls, rels, bias0=True, d=F, classes=3):
    """FEATURE + RGCN (RELU) + RGCN, R relations; the FEATURE stage's bias
    switches the cached first-stage slot gather off."""
    return enc_cls(((layer_cls("FEATURE", output_dim=d, bias=bias0),),
                    (layer_cls("GNN", input_dim=d, output_dim=6, gnn_type="RGCN",
                               num_relations=rels, bias=True, activation="RELU"),),
                    (layer_cls("GNN", input_dim=6, output_dim=classes, gnn_type="RGCN",
                               num_relations=rels, bias=True),)))


# -- the relational full graph ----------------------------------------------------

def random_kg(seed=0, n=N, e=E, r=R, isolated=0):
    """tests/test_full_graph_rgcn.py's random graph; the last ``isolated``
    nodes have no out-edges."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n - isolated, e), rng.integers(0, r, e),
                     rng.integers(0, n, e)], 1).astype(np.int32)


def skewed_kg():
    """Relation 0 with 300 edges, 1..6 a handful (several relation buckets),
    nodes 20..39 without out-edges (tests/test_full_graph_rgcn.py:61)."""
    rng = np.random.default_rng(3)
    rels = np.concatenate([np.zeros(300, np.int64), rng.integers(1, 7, 18)])
    return np.stack([rng.integers(0, 20, len(rels)), rels,
                     rng.integers(0, 40, len(rels))], 1).astype(np.int32), 40, 7


KGS = {"uniform": (random_kg(), N, R), "skewed": skewed_kg()}


@pytest.mark.parametrize("kg", list(KGS))
def test_rel_full_graph_matches_jax_exactly(kg):
    edges, n, _ = KGS[kg]
    jg, tg = jrel.build_rel_full_graph(edges, n), trel.build_rel_full_graph(edges, n)
    assert tg.total_slots == jg.total_slots and tg.num_nodes == jg.num_nodes
    for name in ("rel_nbr", "rel_ids", "anchor_slots", "occ_slots"):
        assert len(getattr(tg, name)) == len(getattr(jg, name))
        for t, j in zip(getattr(tg, name), getattr(jg, name)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for name in ("anchor_inv_pos", "slot_src", "occ_inv_pos", "out_deg"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    for t, j in zip(trel.host_out_csr(tg), jrel.host_out_csr(jg)):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(trel.edges_from_rel_graph(tg), jrel.edges_from_rel_graph(jg))
    if kg == "skewed":
        assert len(tg.rel_nbr) > 1


@pytest.mark.parametrize("kg", list(KGS))
def test_rel_sum_matches_jax(kg):
    """The relational sum's forward (the anchor gather-sum), its gradient in x
    (the occurrence gather-sum) and in W (the relation rows), against JAX's
    custom-vjp version; nodes without out-edges come back exactly zero."""
    edges, n, r = KGS[kg]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    w = (0.3 * rng.standard_normal((r, 5, 4))).astype(np.float32)
    cot = rng.standard_normal((n, 4)).astype(np.float32)
    jsum = jrel.make_rel_sum(jrel.build_rel_full_graph(edges, n))
    jout, jvjp = jax.vjp(jsum, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = jvjp(jnp.asarray(cot))
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    tout = trel.RelSum(trel.build_rel_full_graph(edges, n))(tx, tw)
    (tout * torch.from_numpy(cot)).sum().backward()
    _close(tout, jout, FG_RTOL, FG_ATOL)
    _close(tx.grad, jgx, FG_RTOL, FG_ATOL)
    _close(tw.grad, jgw, FG_RTOL, FG_ATOL)
    no_out = np.bincount(edges[:, 0], minlength=n) == 0
    assert no_out.any() == (kg == "skewed")
    assert not tout.detach()[torch.from_numpy(no_out)].any()


def test_rel_seed_flat_lists_match_jax():
    edges = random_kg()
    tg, jg = trel.build_rel_full_graph(edges, N), jrel.build_rel_full_graph(edges, N)
    seeds = np.random.default_rng(2).integers(0, N, 20)
    mask = np.arange(20) < 17
    off = trel.host_out_csr(tg)[0]
    need = int(((off[seeds + 1] - off[seeds]) * mask).sum())
    t = trel.device_seed_flat_lists_rel(trel.device_rel_csr(trel.host_out_csr(tg), "cpu"),
                                        torch.from_numpy(seeds), torch.from_numpy(mask),
                                        need, N)
    j = jrel.device_seed_flat_lists_rel(jrel.device_rel_csr(jrel.host_out_csr(jg)),
                                        jnp.asarray(seeds, jnp.int32), jnp.asarray(mask),
                                        need, N)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _fg_case(bias0, seed_restrict):
    edges = random_kg(isolated=10)
    jadj = jfg.build_full_graph_adjacency(edges, N, with_relations=True)
    tadj = tfg.build_full_graph_adjacency(edges, N, with_relations=True)
    jcfg, tcfg = enc(JLayerConfig, JEncoderConfig, R, bias0), enc(TLayerConfig,
                                                                 TEncoderConfig, R, bias0)
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    jp = j_init_encoder(jax.random.key(4), jcfg)
    if bias0:
        jp[0][0]["bias"] = jnp.asarray((0.1 * rng.standard_normal(F)).astype(np.float32))
    tp = [[_jparams_to_torch(d) for d in stage] for stage in jp]
    tsr = jsr = None
    if seed_restrict:
        seeds = rng.integers(0, N, 25)
        mask = torch.ones(25, dtype=torch.bool)
        csr = tfg.host_csr_from_adjacency(tadj)
        rcsr = trel.host_out_csr(tadj.rel)
        need = int((csr[0][seeds + 1] - csr[0][seeds]).sum())
        need_r = int((rcsr[0][seeds + 1] - rcsr[0][seeds]).sum())
        lists = tfg.device_seed_flat_lists(tfg.device_csr(csr, "cpu"), torch.from_numpy(seeds),
                                           mask, need, N)
        rel = trel.device_seed_flat_lists_rel(trel.device_rel_csr(rcsr, "cpu"),
                                              torch.from_numpy(seeds), mask, need_r, N)
        tsr = (torch.from_numpy(seeds),) + lists + (rel,)
        jsr = tuple(jnp.asarray(a.numpy().astype(np.int32)) for a in tsr[:3]) + \
            (tuple(jnp.asarray(a.numpy().astype(np.int32)) for a in rel),)
    return edges, jadj, tadj, jcfg, tcfg, feats, jp, tp, tsr, jsr


@pytest.mark.parametrize("bias0", [False, True], ids=["cached-blocks", "live-bias"])
@pytest.mark.parametrize("seed_restrict", [False, True], ids=["all-n", "seed-restrict"])
def test_full_graph_rgcn_encoder_matches_jax(bias0, seed_restrict):
    _, jadj, tadj, jcfg, tcfg, feats, jp, tp, tsr, jsr = _fg_case(bias0, seed_restrict)
    jadj2, jops = jfge.prepare_full_graph(jadj, jcfg, jnp.asarray(feats))
    tadj2, tops = tfge.prepare_full_graph(tadj, tcfg, torch.from_numpy(feats))
    assert isinstance(tops["const_agg"].get((1, 0)), tfge.RgcnBlocks) == (not bias0)
    assert ((1, 0) in jops["const_agg"]) == (not bias0)
    w = np.random.default_rng(8).standard_normal(
        (25 if seed_restrict else N, 3)).astype(np.float32)

    def jloss(p):
        out = jfge.full_graph_encoder_forward(jcfg, p, None, jnp.asarray(feats), jadj2,
                                              ops=jops, train=True, seed_restrict=jsr)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tout = tfge.full_graph_encoder_forward(tcfg, tp, None, torch.from_numpy(feats), tadj2,
                                           ops=tops, train=True, seed_restrict=tsr)
    (tout * torch.from_numpy(w)).sum().backward()
    _close(tout, jout, FG_RTOL, FG_ATOL)
    for tstage, jstage in zip(tp, jgrad):
        for k, t in tstage[0].items():
            assert t.grad is not None or k == "bias"
            if t.grad is not None:
                _close(t.grad, jstage[0][k], FG_RTOL, FG_ATOL)


def test_full_graph_rgcn_equals_sampled_all_and_seed_restricted():
    """tests/test_full_graph_rgcn.py:86 and :270 on the port: the full-graph
    RGCN encoding equals the sampled encoder's under unbounded ALL, and the
    seed-restricted final stage equals the all-N one at the seeds."""
    edges, _, tadj, _, tcfg, feats, _, tp, tsr, _ = _fg_case(True, True)
    with torch.no_grad():
        tadj2, tops = tfge.prepare_full_graph(tadj, tcfg, torch.from_numpy(feats))
        full = tfge.full_graph_encoder_forward(tcfg, tp, None, torch.from_numpy(feats),
                                               tadj2, ops=tops)
        sampled, seeds = sampled_all_encoding(tcfg, tp, edges, feats, num_rels=R)
        _close(full[seeds], sampled, FG_RTOL, FG_ATOL)
        restricted = tfge.full_graph_encoder_forward(tcfg, tp, None, torch.from_numpy(feats),
                                                     tadj2, ops=tops, seed_restrict=tsr)
        _close(restricted, full[tsr[0]], FG_RTOL, FG_ATOL)


def test_prepare_full_graph_requires_the_relational_companion():
    tadj = tfg.build_full_graph_adjacency(random_kg(), N)
    with pytest.raises(ValueError, match="with_relations"):
        tfge.prepare_full_graph(tadj, enc(TLayerConfig, TEncoderConfig, R))


# -- the trainers -----------------------------------------------------------------

def _rel_edges(rels):
    """The NC test graph with a relation column drawn from a seed."""
    from tests.test_torch_gat import _nc_data
    edges = _nc_data()[0]
    r = np.random.default_rng(5).integers(0, rels, len(edges)).astype(np.int32)
    return np.stack([edges[:, 0], r, edges[:, 1]], 1)


def test_sampled_rgcn_nc_trainer_matches_jax():
    jtr, ttr = trainer_pair("RGCN", False, edges=_rel_edges(3), nbr=[("UNIFORM", 6)] * 2,
                            rels=3)
    check_trainers(jtr, ttr)


def test_full_graph_rgcn_nc_trainer_matches_jax():
    """Full-graph RGCN NC 2 epochs, the final stage seed-restricted over the
    relational seed lists; the all-N stages are held in
    test_full_graph_rgcn_encoder_matches_jax."""
    jtr, ttr = trainer_pair("RGCN", True, edges=_rel_edges(3), rels=3)
    assert ttr._fg_collapse is None and ttr.full_graph.rel is not None
    assert ttr._fg_seed_restrict and jtr._fg_seed_restrict
    assert ttr._fg_rel_csr is not None
    check_trainers(jtr, ttr)


# -- converted states ---------------------------------------------------------------

@pytest.mark.parametrize("gnn", ["GAT", "RGCN"])
def test_train_state_from_jax_carries_gat_and_rgcn_params(gnn):
    """A JAX NC trainer's initial state (GAT ``w``, ``a_l``, ``a_r``; RGCN
    ``relation_matrices``, ``self_matrix``) carried into the port gives the
    same encodings of one sampled batch."""
    from marius_tpu_torch.nn.optimizers import tree_leaves
    rels = 3 if gnn == "RGCN" else 0
    jtr, ttr = trainer_pair(gnn, False, edges=_rel_edges(3) if rels else None,
                            nbr=[("UNIFORM", 6)] * 2, rels=rels)
    state = train_state_from_jax(np_state(jtr.state))
    names = {k for stage in state.params["encoder"] for d in stage for k in d}
    assert names >= ({"w", "a_l", "a_r"} if gnn == "GAT" else
                     {"relation_matrices", "self_matrix"})
    assert len(tree_leaves(state.opt_state.slots)) == 2 * len(tree_leaves(state.params))
    from marius_tpu.data.samplers.neighbor import sample_neighbor_batch
    seeds = np.arange(32, dtype=np.int32)
    jb = sample_neighbor_batch(jax.random.key(3), jtr.graph, jnp.asarray(seeds),
                               jnp.ones(32, bool), jtr.nbr_configs, jtr.hop_caps)
    feats = np.random.default_rng(4).standard_normal(
        (jb.node_ids[0].shape[0], 8)).astype(np.float32)
    with torch.no_grad():
        tout = t_encoder_forward(ttr.model.encoder, state.params["encoder"], None,
                                 torch.from_numpy(feats), to_torch_batch(jb))
    jout = j_encoder_forward(jtr.model.encoder, jtr.state.params["encoder"], None,
                             jnp.asarray(feats), jb)
    _close(tout, jout)
    assert tout.shape == (32, 5) and ttr.num_nodes == NC_N
