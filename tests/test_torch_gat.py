"""The port's GAT layers, on the CPU, against marius_tpu's.

The same numpy inputs, made from a seed, go through the JAX function and
the port's. Layers and encoders (forward values and gradients) are held to
rtol 1e-5 / atol 1e-6 where their sums are short, and to the full-graph
tests' rtol 1e-5 / atol 1e-5 over the hub rows of a power-law graph (float32
sums in another order than XLA's); the integer structures (the inverse
occurrence map) must match exactly; the NC trainers over 2 epochs to rtol
1e-4 / atol 1e-5, as in the other trainer tests.

Dropout: the port's layers take their keep-masks from a ``DropoutKey``.
:class:`JaxKey` is one whose masks are JAX's own (``fold_in`` for
``fold``, ``bernoulli`` for ``keep``), so layers at nonzero input and
attention dropout agree with JAX exactly as without dropout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marius_tpu.nn.layers.layers as jlayers
import marius_tpu_torch.nn.layers.layers as tlayers
from marius_tpu.data import full_graph as jfg
from marius_tpu.data.batch import LayerAdjacency as JAdj
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn import full_graph_encoder as jfge
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOptimizerConfig
from marius_tpu.ops import segment as jseg
from marius_tpu.train import nc as jnc
from marius_tpu_torch.convert import copy_train_state_, train_state_from_jax
from marius_tpu_torch.data import full_graph as tfg
from marius_tpu_torch.data.batch import LayerAdjacency as TAdj
from marius_tpu_torch.data.graph import build_device_graph as t_graph
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.nn import full_graph_encoder as tfge
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOptimizerConfig
from marius_tpu_torch.ops import segment as tseg
from marius_tpu_torch.ops.cuda import gather as gather_kernel
from marius_tpu_torch.ops.cuda import nbr_sum as nbr_sum_kernel
from marius_tpu_torch.train import nc as tnc
from tests.test_torch_full_graph import power_law_edges
from tests.test_torch_neighbor_sampler import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6
FG_RTOL, FG_ATOL = 1e-5, 1e-5
RTOL, ATOL = 1e-4, 1e-5


class JaxKey:
    """A DropoutKey whose masks are the JAX package's: ``fold`` is
    ``fold_in`` and ``keep`` is ``bernoulli`` on the folded key."""

    def __init__(self, key):
        self.key = key

    def fold(self, data: int) -> "JaxKey":
        return JaxKey(jax.random.fold_in(self.key, data))

    def keep(self, shape, q, device):
        return torch.from_numpy(np.array(jax.random.bernoulli(self.key, q, tuple(shape))))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(t, j, rtol=LAYER_RTOL, atol=LAYER_ATOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


def _jparams_to_torch(jp):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}


# -- the sampled layer ----------------------------------------------------------

def random_adjacency(rng, n, n_prev, f_in, f_out, rels=0):
    """tests/test_gat_exact.py's random layer adjacency (masks independent of
    node_mask), optionally with out-slot relations; JAX's and the port's."""
    arrays = dict(
        self_idx=rng.integers(0, n_prev, n).astype(np.int32),
        in_nbr_idx=rng.integers(0, n_prev, (n, f_in)).astype(np.int32),
        in_mask=rng.random((n, f_in)) < 0.7,
        out_nbr_idx=rng.integers(0, n_prev, (n, f_out)).astype(np.int32),
        out_mask=rng.random((n, f_out)) < 0.7,
        node_mask=rng.random(n) < 0.9)
    if rels:
        arrays["out_rel"] = rng.integers(0, rels, (n, f_out)).astype(np.int32)
    return (JAdj(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TAdj(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


GAT_CASES = {
    "project-first": (12, 3, 6, False),     # h x k = 6  <= 12
    "aggregate-first": (8, 4, 16, True),    # h x k = 64 >  8
    "boundary": (16, 2, 16, False),         # h x k = 16 == 16
}


def _gat_configs(d_in, heads, d_out, avg, **kw):
    kw = dict(layer_type="GNN", gnn_type="GAT", input_dim=d_in, output_dim=d_out,
              num_heads=heads, average_heads=avg, bias=True, activation="RELU", **kw)
    return JLayerConfig(**kw), TLayerConfig(**kw)


def _layer_pair(jcfg, tcfg, jadj, tadj, x, u, key=None):
    """(JAX out, grads), (port out, grads) of sum(layer(x) * u)."""
    jp = jlayers.init_layer_params(jax.random.key(0), jcfg)
    tp = _jparams_to_torch(jp)
    train = key is not None

    def jf(x_, p_):
        out = jlayers.gat_layer(jcfg, p_, x_, jadj, train=train, dropout_key=key)
        return jnp.sum(out * u), out

    (_, jout), (jgx, jgp) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tlayers.gat_layer(tcfg, tp, tx, tadj, train=train,
                             dropout_key=None if key is None else JaxKey(key))
    (tout * torch.from_numpy(u)).sum().backward()
    _close(tout, jout)
    _close(tx.grad, jgx)
    for k in jp:
        _close(tp[k].grad, jgp[k])
    return jout


@pytest.mark.parametrize("case", list(GAT_CASES))
def test_gat_layer_matches_jax(case):
    """tests/test_gat_exact.py's three cases: both formulations and the
    boundary, forward and gradients."""
    d_in, heads, d_out, avg = GAT_CASES[case]
    rng = np.random.default_rng(0)
    jadj, tadj = random_adjacency(rng, 20, 40, 5, 4)
    x = rng.standard_normal((40, d_in)).astype(np.float32)
    u = rng.standard_normal((20, d_out)).astype(np.float32)
    jcfg, tcfg = _gat_configs(d_in, heads, d_out, avg)
    _layer_pair(jcfg, tcfg, jadj, tadj, x, u)


@pytest.mark.parametrize("case", ["project-first", "aggregate-first"])
def test_gat_layer_dropout_matches_jax(case):
    """Input dropout 0.3 and attention dropout 0.4 with JAX's masks injected:
    the same values and gradients; the masks drop something. Inputs are a
    quarter of unit normals, so outputs stay of order 1 (where atol 1e-6 is
    float32 rounding) after the dropouts' 1/0.7 and 1/0.6 scales."""
    d_in, heads, d_out, avg = GAT_CASES[case]
    rng = np.random.default_rng(1)
    jadj, tadj = random_adjacency(rng, 20, 40, 5, 4)
    x = (0.25 * rng.standard_normal((40, d_in))).astype(np.float32)
    u = rng.standard_normal((20, d_out)).astype(np.float32)
    jcfg, tcfg = _gat_configs(d_in, heads, d_out, avg, input_dropout=0.3,
                              attention_dropout=0.4)
    key = jax.random.key(9)
    dropped = _layer_pair(jcfg, tcfg, jadj, tadj, x, u, key)
    plain = jlayers.gat_layer(jcfg, jlayers.init_layer_params(jax.random.key(0), jcfg),
                              jnp.asarray(x), jadj)
    assert not np.allclose(np.asarray(dropped), np.asarray(plain))


def test_gat_layer_fully_masked_rows_are_zero():
    """A target with no valid slot (node_mask false, every neighbour masked)
    aggregates zeros: the output is the bias alone, as in JAX."""
    rng = np.random.default_rng(2)
    jadj, tadj = random_adjacency(rng, 6, 10, 3, 3)
    masked = np.zeros((6, 3), bool)
    tadj = dataclasses.replace(tadj, in_mask=torch.from_numpy(masked),
                               out_mask=torch.from_numpy(masked),
                               node_mask=torch.zeros(6, dtype=torch.bool))
    _, tcfg = _gat_configs(4, 2, 6, False)
    tcfg = dataclasses.replace(tcfg, activation="NONE")
    p = tlayers.init_layer_params(torch.Generator().manual_seed(0), tcfg)
    p["bias"] = torch.arange(6, dtype=torch.float32)
    out = tlayers.gat_layer(tcfg, p, torch.randn(10, 4), tadj)
    assert torch.equal(out, p["bias"].expand(6, 6))


def test_gat_init_params_match_jax():
    """Names, shapes and the fans override (gat_layer.cpp:33-38): GLOROT
    limits sqrt(6 / (d_in + head_dim)) for w and sqrt(6 / (head_dim + 1))
    for the attention vectors."""
    for avg, d_out in ((True, 16), (False, 12)):
        jcfg, tcfg = _gat_configs(8, 4, d_out, avg)
        jp = jlayers.init_layer_params(jax.random.key(0), jcfg)
        tp = tlayers.init_layer_params(torch.Generator().manual_seed(0), tcfg)
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        k = d_out if avg else d_out // 4
        assert tp["w"].abs().max() <= np.sqrt(6 / (8 + k))
        assert tp["a_l"].abs().max() <= np.sqrt(6 / (k + 1))


def test_segment_max_and_softmax_match_jax():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((40, 3)).astype(np.float32)
    seg = np.sort(rng.integers(0, 9, 40))          # segment 9 stays empty
    mask = rng.random((40, 1)) < 0.8
    _close(tseg.segment_max(torch.from_numpy(data), torch.from_numpy(seg), 10),
           jax.ops.segment_max(jnp.asarray(data), jnp.asarray(seg), num_segments=10))
    _close(tseg.segment_softmax(torch.from_numpy(data), torch.from_numpy(seg), 10,
                                torch.from_numpy(mask)),
           jseg.segment_softmax(jnp.asarray(data), jnp.asarray(seg), 10, jnp.asarray(mask)))


# -- the full graph ---------------------------------------------------------------

N, F = 220, 8


@pytest.fixture(scope="module")
def graph():
    edges = power_law_edges()
    jadj = jfg.build_inverse_map(jfg.build_full_graph_adjacency(edges, N))
    tadj = tfg.build_inverse_map(tfg.build_full_graph_adjacency(edges, N))
    return edges, jadj, tadj


def test_inverse_map_matches_jax_exactly(graph):
    _, jadj, tadj = graph
    assert max(b.shape[1] for b in tadj.inv_map) > nbr_sum_kernel.MAX_CAP   # hub rows
    for t, j in zip(tadj.inv_map, jadj.inv_map):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_gather_blocks_and_permuters_match_jax(graph):
    """The slot blocks (padding reads zeros), their inverse-map backward
    through the gather-sum (plain version here), and the row permutations
    with their gather-only backward."""
    _, jadj, tadj = graph
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, 5)).astype(np.float32)
    us = [rng.standard_normal(tuple(b.shape) + (5,)).astype(np.float32) for b in tadj.nbrs]
    jblocks, jvjp = jax.vjp(jfg.make_gather_blocks(jadj), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tblocks = tfg.make_gather_blocks(tadj)(tx)
    assert len(tblocks) == len(jblocks)
    for t, j in zip(tblocks, jblocks):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
    sum((t * torch.from_numpy(u)).sum() for t, u in zip(tblocks, us)).backward()
    _close(tx.grad, jvjp(tuple(jnp.asarray(u) for u in us))[0], FG_RTOL, FG_ATOL)

    u = rng.standard_normal((N, 5)).astype(np.float32)
    for jf, tf in zip(jfg.make_permuters(jadj), tfg.make_permuters(tadj)):
        jy, jv = jax.vjp(jf, jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_(True)
        ty = tf(tx)
        ty.backward(torch.from_numpy(u))
        np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jv(jnp.asarray(u))[0]))


FG_CASES = {"project-first": (4, 2, False), "aggregate-first": (16, 4, True)}


def fg_stages(layer_cls, case, activation="RELU", **gat):
    """FEATURE (bias) + GAT + GAT: the case's head layout, then 2 averaged heads."""
    d_hidden, heads, avg = FG_CASES[case]
    return ((layer_cls("FEATURE", output_dim=F, bias=True),),
            (layer_cls("GNN", input_dim=F, output_dim=d_hidden, gnn_type="GAT",
                       num_heads=heads, average_heads=avg, bias=True, activation=activation,
                       **gat),),
            (layer_cls("GNN", input_dim=d_hidden, output_dim=5, gnn_type="GAT", num_heads=2,
                       average_heads=True, bias=True, **gat),))


def _fg_params(jcfg, seed=5):
    from marius_tpu.nn.encoder import init_encoder_params
    jp = init_encoder_params(jax.random.key(seed), jcfg)
    jp[0][0]["bias"] = jnp.asarray(np.random.default_rng(seed).standard_normal(F)
                                   .astype(np.float32) * 0.1)
    tp = [[_jparams_to_torch(d) for d in stage] for stage in jp]
    return jp, tp


def seed_lists(tadj, seeds, budget=None):
    """(port seed_restrict, JAX seed_restrict) for ``seeds`` with ``budget``
    slots (default: exactly the batch's)."""
    csr = tfg.host_csr_from_adjacency(tadj)
    need = int((csr[0][seeds + 1] - csr[0][seeds]).sum())
    mask = torch.ones(len(seeds), dtype=torch.bool)
    nbr, seg = tfg.device_seed_flat_lists(tfg.device_csr(csr, "cpu"), torch.from_numpy(seeds),
                                          mask, budget or need, N)
    return ((torch.from_numpy(seeds), nbr, seg),
            (jnp.asarray(seeds, jnp.int32), jnp.asarray(nbr.numpy().astype(np.int32)),
             jnp.asarray(seg.numpy().astype(np.int32))))


@pytest.mark.parametrize("case,seed_restrict,drop", [
    ("project-first", False, False), ("project-first", True, True),
    ("aggregate-first", False, False), ("aggregate-first", True, True)],
    ids=["project-first-all-n", "project-first-seed-restrict-dropout",
         "aggregate-first-all-n", "aggregate-first-seed-restrict-dropout"])
def test_full_graph_gat_encoder_matches_jax(graph, case, seed_restrict, drop):
    """The full-graph GAT encoder (per-bucket softmax, inverse-map backward)
    and its seed-restricted final stage against JAX's (jitted), forward and
    gradients, in both forms; with dropout (the seed-restricted cases: the
    first GAT stage's per-bucket masks and the final stage's), JAX's masks
    injected, the seed lists given one slot budget on both sides so the
    masks have one shape."""
    _, jadj, tadj = graph
    gat = dict(input_dropout=0.2, attention_dropout=0.3) if drop else {}
    jcfg = JEncoderConfig(fg_stages(JLayerConfig, case, **gat))
    tcfg = TEncoderConfig(fg_stages(TLayerConfig, case, **gat))
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    jp, tp = _fg_params(jcfg)
    jadj2, jops = jfge.prepare_full_graph(jadj, jcfg, jnp.asarray(feats))
    tadj2, tops = tfge.prepare_full_graph(tadj, tcfg, torch.from_numpy(feats))
    assert tadj2.inv_map is not None and "gather_blocks" in tops and not jops.get("sorted")
    b = 30
    seeds = rng.integers(0, N, b)
    tsr, jsr = seed_lists(tadj, seeds, budget=1536) if seed_restrict else (None, None)
    w = rng.standard_normal((b if seed_restrict else N, 5)).astype(np.float32)
    key = jax.random.key(3) if drop else None

    def jloss(p):
        out = jfge.full_graph_encoder_forward(jcfg, p, None, jnp.asarray(feats), jadj2,
                                              ops=jops, train=True, dropout_key=key,
                                              seed_restrict=jsr)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tout = tfge.full_graph_encoder_forward(tcfg, tp, None, torch.from_numpy(feats), tadj2,
                                           ops=tops, train=True,
                                           dropout_key=None if key is None else JaxKey(key),
                                           seed_restrict=tsr)
    (tout * torch.from_numpy(w)).sum().backward()
    _close(tout, jout, FG_RTOL, FG_ATOL)
    for tstage, jstage in zip(tp, jgrad):
        for k, t in tstage[0].items():
            _close(t.grad, jstage[0][k], FG_RTOL, FG_ATOL)


def sampled_all_encoding(tcfg, tp, edges, feats, num_rels=1):
    """Every node's encoding through the port's sampled encoder under
    unbounded ALL (two hops, caps above the node count)."""
    from marius_tpu_torch.data.samplers.neighbor import generator_draws, sample_neighbor_batch
    from marius_tpu_torch.nn.encoder import encoder_forward
    n = feats.shape[0]
    g = t_graph(edges, n, num_rels)
    cfgs = [TNbr("ALL", max_neighbors=int(g.degrees.max()))] * 2
    nb = sample_neighbor_batch(generator_draws(torch.Generator().manual_seed(0)), g,
                               torch.arange(n), torch.ones(n, dtype=torch.bool), cfgs,
                               [n + 1] * 3)
    assert bool(nb.seed_mask.all())
    f = torch.cat([torch.from_numpy(feats), torch.zeros(1, feats.shape[1])])
    out = encoder_forward(tcfg, tp, None, f[nb.node_ids[0].clamp(max=n)], nb, degrees=g.degrees)
    return out, nb.seed_ids.long()


@pytest.mark.parametrize("case", list(FG_CASES))
def test_full_graph_gat_equals_sampled_all_and_seed_restricted(graph, case):
    """tests/test_nc_e2e.py:623 and :270 on the port: the full-graph GAT
    encoding equals the sampled encoder's under unbounded ALL, and the
    seed-restricted final stage equals the all-N one at the seeds."""
    edges, _, tadj = graph
    tcfg = TEncoderConfig(fg_stages(TLayerConfig, case))
    _, tp = _fg_params(JEncoderConfig(fg_stages(JLayerConfig, case)))
    feats = np.random.default_rng(8).standard_normal((N, F)).astype(np.float32)
    with torch.no_grad():
        tadj2, tops = tfge.prepare_full_graph(tadj, tcfg, torch.from_numpy(feats))
        full = tfge.full_graph_encoder_forward(tcfg, tp, None, torch.from_numpy(feats),
                                               tadj2, ops=tops)
        sampled, seeds = sampled_all_encoding(tcfg, tp, edges, feats)
        _close(full[seeds], sampled, FG_RTOL, FG_ATOL)
        pick = np.random.default_rng(9).integers(0, N, 25)
        tsr, _ = seed_lists(tadj, pick)
        restricted = tfge.full_graph_encoder_forward(tcfg, tp, None, torch.from_numpy(feats),
                                                     tadj2, ops=tops, seed_restrict=tsr)
        _close(restricted, full[torch.from_numpy(pick)], FG_RTOL, FG_ATOL)


# -- the trainers -----------------------------------------------------------------

NC_N, NC_E, NC_F, CLASSES, B = 260, 2000, 8, 5, 32


def _nc_data():
    from tests.test_torch_sampled_nc import _graph_data
    return _graph_data()


def nc_model(model_cls, enc_cls, layer_cls, opt_cls, gnn_type="GAT", **kw):
    """FEATURE (bias) + two GNN stages with bias (GAT: 4 heads concatenated,
    then 2 averaged; RGCN: R relations), CE SUM, Adam lr 0.01."""
    if gnn_type == "GAT":
        first = dict(gnn_type="GAT", num_heads=4, average_heads=False, **kw)
        last = dict(gnn_type="GAT", num_heads=2, average_heads=True, **kw)
    else:
        first = last = dict(gnn_type="RGCN", **kw)
    stages = ((layer_cls("FEATURE", output_dim=NC_F, bias=True),),
              (layer_cls("GNN", input_dim=NC_F, output_dim=12, bias=True, activation="RELU",
                         **first),),
              (layer_cls("GNN", input_dim=12, output_dim=CLASSES, bias=True, **last),))
    return model_cls("NODE_CLASSIFICATION", enc_cls(stages), None,
                     loss_type="CROSS_ENTROPY", loss_reduction="SUM",
                     dense_optimizer=opt_cls("ADAM", learning_rate=0.01))


class SampledKeyReplay:
    """The sampled trainer's seams: JAX's key schedule (``key, k_s =
    split(state.key)`` per batch) for the draws, ``fold_in(k_s, 99)`` for the
    dropout key."""

    def __init__(self, key):
        self.key = key
        self.k_s = None

    def __call__(self):
        self.key, self.k_s = jax.random.split(self.key)
        return jax_draws(self.k_s)

    def dropout(self):
        return JaxKey(jax.random.fold_in(self.k_s, 99))


class FullGraphKeyReplay:
    """The full-graph trainer's dropout seam: ``key, k_d = split(state.key)``."""

    def __init__(self, key):
        self.key = key

    def __call__(self):
        self.key, k_d = jax.random.split(self.key)
        return JaxKey(k_d)


def np_state(jstate):
    return jax.tree.map(np.asarray, dataclasses.replace(jstate, key=None))


def trainer_pair(gnn_type, full_graph, edges=None, nbr=None, rels=0, fg_kwargs=None, **kw):
    """A JAX and a port NC trainer on the same data, the port's state, epoch
    permutation, draws and dropout keys JAX's."""
    e, feats, labels, train = _nc_data()
    edges = e if edges is None else edges
    args = dict(num_relations=rels) if gnn_type == "RGCN" else {}
    args.update(kw)
    jm = nc_model(JModel, JEncoderConfig, JLayerConfig, JOptimizerConfig, gnn_type, **args)
    tm = nc_model(TModel, TEncoderConfig, TLayerConfig, TOptimizerConfig, gnn_type, **args)
    g_rels = max(rels, 1)
    common = dict(batch_size=B, seed=0, **(fg_kwargs or {}))
    if full_graph:
        jadj = jfg.build_full_graph_adjacency(edges, NC_N, with_relations=gnn_type == "RGCN")
        tadj = tfg.build_full_graph_adjacency(edges, NC_N, with_relations=gnn_type == "RGCN")
        jtr = jnc.NodeClassificationTrainer(jm, j_graph(edges, NC_N, g_rels), feats, labels,
                                            train, [JNbr("ALL", max_neighbors=1)] * 2,
                                            full_graph=jadj, **common)
        ttr = tnc.NodeClassificationTrainer(tm, t_graph(edges, NC_N, g_rels), feats, labels,
                                            train, full_graph=tadj, device="cpu", **common)
    else:
        jtr = jnc.NodeClassificationTrainer(jm, j_graph(edges, NC_N, g_rels), feats, labels,
                                            train, [JNbr(*c) for c in nbr], **common)
        ttr = tnc.NodeClassificationTrainer(tm, t_graph(edges, NC_N, g_rels), feats, labels,
                                            train, [TNbr(*c) for c in nbr], device="cpu",
                                            **common)
        assert ttr.hop_caps == jtr.hop_caps
    size = jtr.num_batches * B
    ttr._epoch_permutation = lambda p: torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(jax.random.key(54321), p), size))).long()
    key = jax.random.wrap_key_data(np.array(jax.random.key_data(jtr.state.key)))
    if full_graph:
        ttr._dropout_key = FullGraphKeyReplay(key)
    else:
        replay = SampledKeyReplay(key)
        ttr._batch_draws, ttr._dropout_key = replay, replay.dropout
    copy_train_state_(ttr.state, train_state_from_jax(np_state(jtr.state)))
    return jtr, ttr


def check_trainers(jtr, ttr, epochs=2):
    launches = (gather_kernel.launches, nbr_sum_kernel.launches)
    for _ in range(epochs):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        js, ts = np_state(jtr.state), ttr.state
        for tree_t, tree_j in ((ts.params, js.params), (ts.opt_state.slots, js.opt_state.slots)):
            for t, j in zip(_leaves(tree_t), _leaves(tree_j)):
                _close(t, j, RTOL, ATOL)
        assert ts.opt_state.step == int(js.opt_state.step)
    # the CPU runs the kernels' plain versions
    assert (gather_kernel.launches, nbr_sum_kernel.launches) == launches
    eval_nodes = np.setdiff1d(np.arange(NC_N), _nc_data()[3])
    jev = jnc.NodeClassificationEvaluator(jtr, eval_nodes, batch_size=40)
    tev = tnc.NodeClassificationEvaluator(ttr, eval_nodes, batch_size=40)
    tev._batch_draws = lambda i: jax_draws(jax.random.fold_in(jax.random.key(11), i))
    jacc, tacc = jev.evaluate(jtr.state), tev.evaluate(ttr.state)
    assert tacc["num_evaluated"] == jacc["num_evaluated"] == len(eval_nodes)
    assert tacc["accuracy"] == pytest.approx(jacc["accuracy"], abs=1e-12)


def _leaves(tree):
    """Leaves in key order (JAX's dicts come back with sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("drop", [False, True], ids=["no-dropout", "dropout"])
def test_sampled_gat_nc_trainer_matches_jax(drop):
    """Sampled GAT NC (UNIFORM 6 in and out, worst-case caps) 2 epochs, then
    evaluation; with dropout, JAX's masks through the ``_dropout_key`` seam."""
    kw = dict(input_dropout=0.1, attention_dropout=0.2) if drop else {}
    jtr, ttr = trainer_pair("GAT", False, nbr=[("UNIFORM", 6)] * 2, **kw)
    check_trainers(jtr, ttr)


def test_full_graph_gat_nc_trainer_matches_jax():
    """Full-graph GAT NC 2 epochs on the general path (GAT does not collapse),
    the final stage seed-restricted; the all-N stages are held in
    test_full_graph_gat_encoder_matches_jax."""
    jtr, ttr = trainer_pair("GAT", True)
    assert ttr._fg_collapse is None and jtr._fg_collapse is None
    assert ttr._fg_seed_restrict and jtr._fg_seed_restrict
    assert ttr.full_graph.inv_map is not None
    check_trainers(jtr, ttr)
