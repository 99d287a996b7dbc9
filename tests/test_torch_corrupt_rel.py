"""Relation corruption (CORRUPT_REL), positive-only scoring (ONLY_POS) and
the norm regularizer: the port against marius_tpu, on the CPU (mirrors
tests/test_decoder_methods.py and the corrupt_rel rows of
tests/test_config_matrix.py).

The decoder methods (``rel_corrupt_forward``, ``rel_all_scores``,
``only_pos_forward``) take the same numpy inputs in both packages, DistMult,
ComplEx and TransE, inverse relations on and off; outputs and gradients
agree to rtol 1e-5 / atol 1e-6 (TransE's eps-shifted L2 is exact to that,
not bitwise, ROADMAP C4). The trainers start from JAX's state and see JAX's
relation negatives, replayed from its per-batch key schedule (``key, k_dst,
k_src = split(state.key, 3)``, the relation ids ``randint(k_dst, (C, N), 0,
R)``, then ``k_nb`` and ``k_drop``; in the buffer ``split(key)`` after the
node negatives), and agree to rtol 1e-4 / atol 1e-5 over 2 epochs (shallow),
2 batches (GNN, ROADMAP C5) or one epoch of buffer states. Relation ranks
equal JAX's exactly on quantized tables (multiples of 1/4; TransE 1/64),
filtered and not; the filtered mask tests triple membership, which the
C1 lower-bound fault does not reach (an absent query is absent either way).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marius_tpu.train.evaluator as jevaluator
import marius_tpu.train.trainer as jtrainer_mod
from marius_tpu.config.schema import load_config as j_load_config
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNeg
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn import model as jmodel_mod
from marius_tpu.nn.decoders.edge import EdgeDecoder as JEdgeDecoder
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.nn.regularizer import norm_regularizer as j_norm_regularizer
from marius_tpu.train.buffer_trainer import PartitionBufferLPTrainer as JBufferTrainer
from marius_tpu_torch.config.schema import load_config
from marius_tpu_torch.config.validate import ConfigError
from marius_tpu_torch.convert import (
    copy_buffer_trainer_from_jax_,
    copy_train_state_,
    train_state_from_jax,
)
from marius_tpu_torch.data.graph import build_device_graph as t_graph
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig as TNeg
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.manager import marius_eval
from marius_tpu_torch.nn import model as tmodel_mod
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder as TEdgeDecoder
from marius_tpu_torch.nn.decoders.edge import normalize_decoder_method
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOpt
from marius_tpu_torch.nn.regularizer import norm_regularizer
from marius_tpu_torch.parallel.embedding_table import EmbeddingTable as TTable
from marius_tpu_torch.train import evaluator as tevaluator
from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer as TBufferTrainer
from marius_tpu_torch.train.trainer import LinkPredictionTrainer as TTrainer
from marius_tpu_torch.train.trainer import TrainState as TTrainState
from tests.test_torch_buffer_trainer import JaxDraws, run_and_compare
from tests.test_torch_lp_gnn import check_states
from tests.test_torch_lp_trainer import RTOL, _np_state
from tests.test_torch_manager import _lp_config, _train
from tests.test_torch_neighbor_sampler import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
DECODERS = [(d, inv) for d in ("DISTMULT", "COMPLEX", "TRANSE") for inv in (True, False)]
DEC_IDS = [f"{d}-{'inv' if i else 'noinv'}" for d, i in DECODERS]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(t, j, rtol=FWD_RTOL, atol=FWD_ATOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


# -- the decoder methods and the loss ------------------------------------------

def _decoder_inputs(decoder, inverse, seed=0, b=12, c=3, n=5, d=8, r=7):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = {"src": f(b, d), "dst": f(b, d), "relations": f(r, d)}
    if inverse:
        x["inverse_relations"] = f(r, d)
    ids = {"rel": rng.integers(0, r, b).astype(np.int32),
           "neg_rel": rng.integers(0, r, (c, n)).astype(np.int32)}
    jdec = JEdgeDecoder(decoder, r, d, use_inverse_relations=inverse)
    tdec = TEdgeDecoder(decoder, r, d, use_inverse_relations=inverse)
    with torch.no_grad():
        for k, p in tdec.named_parameters():
            p.copy_(torch.from_numpy(x[k]))
    return jdec, tdec, x, ids


def _weights(outs, seed=1):
    """Fixed random weights for a scalar of the outputs (their vjp seeds)."""
    rng = np.random.default_rng(seed)
    return [None if o is None else rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in outs]


@pytest.mark.parametrize("decoder,inverse", DECODERS, ids=DEC_IDS)
def test_rel_decoder_methods_match_jax(decoder, inverse):
    jdec, tdec, x, ids = _decoder_inputs(decoder, inverse)
    names = list(x)

    def j_outs(vals):
        params = {k: vals[k] for k in names if "relations" in k}
        rel, neg = jnp.asarray(ids["rel"]), jnp.asarray(ids["neg_rel"])
        out = list(jdec.rel_corrupt_forward(params, vals["src"], vals["dst"], rel, neg))
        out += [jdec.rel_all_scores(params, vals["src"], vals["dst"])]
        if inverse:
            out += [jdec.rel_all_scores(params, vals["dst"], vals["src"], inverse=True)]
        out += list(jdec.only_pos_forward(params, vals["src"], vals["dst"], rel))
        return out

    def t_outs(vals):
        rel, neg = torch.from_numpy(ids["rel"]).long(), torch.from_numpy(ids["neg_rel"]).long()
        out = list(tdec.rel_corrupt_forward(vals["src"], vals["dst"], rel, neg))
        out += [tdec.rel_all_scores(vals["src"], vals["dst"])]
        if inverse:
            out += [tdec.rel_all_scores(vals["dst"], vals["src"], inverse=True)]
        out += list(tdec.only_pos_forward(vals["src"], vals["dst"], rel))
        return out

    jvals = {k: jnp.asarray(v) for k, v in x.items()}
    jo = j_outs(jvals)
    tvals = {k: torch.from_numpy(v).requires_grad_(True) for k, v in x.items()
             if "relations" not in k}
    tvals.update(dict(tdec.named_parameters()))
    to = t_outs(tvals)
    assert [o is None for o in jo] == [o is None for o in to]
    assert (jo[2] is None) == (not inverse)
    for t, j in zip(to, jo):
        if j is not None:
            assert t.shape == j.shape
            _close(t, j)
    ws = _weights(jo)

    def j_scalar(vals):
        return sum(jnp.sum(o * w) for o, w in zip(j_outs(vals), ws) if o is not None)

    jg = jax.grad(j_scalar)(jvals)
    t_scalar = sum((o * torch.from_numpy(w)).sum() for o, w in zip(to, ws) if o is not None)
    tg = torch.autograd.grad(t_scalar, [tvals[k] for k in names])
    for k, g in zip(names, tg):
        _close(g, jg[k])


@pytest.mark.parametrize("decoder,inverse", [("DISTMULT", True), ("TRANSE", False)])
def test_lp_batch_loss_rel_matches_jax(decoder, inverse):
    jdec, tdec, x, ids = _decoder_inputs(decoder, inverse, seed=3)
    stages = lambda L: ((L("EMBEDDING", output_dim=8),),)  # noqa: E731
    jm = JModel("LINK_PREDICTION", JEncoderConfig(stages(JLayerConfig)), jdec)
    tm = TModel("LINK_PREDICTION", TEncoderConfig(stages(TLayerConfig)), tdec)
    mask = np.arange(12) < 10     # two padded edges

    def jloss(vals):
        params = {"decoder": {k: vals[k] for k in vals if "relations" in k}}
        return jmodel_mod.lp_batch_loss_rel(jm, params, vals["src"], vals["dst"],
                                            jnp.asarray(ids["rel"]), jnp.asarray(ids["neg_rel"]),
                                            jnp.asarray(mask))[0]

    jvals = {k: jnp.asarray(v) for k, v in x.items()}
    jl, jg = jax.value_and_grad(jloss)(jvals)
    src = torch.from_numpy(x["src"]).requires_grad_(True)
    dst = torch.from_numpy(x["dst"]).requires_grad_(True)
    tl, aux = tmodel_mod.lp_batch_loss_rel(tm, src, dst, torch.from_numpy(ids["rel"]).long(),
                                           torch.from_numpy(ids["neg_rel"]).long(),
                                           torch.from_numpy(mask))
    assert (aux["inv_neg"] is None) == (not inverse)
    _close(tl, jl)
    leaves = {"src": src, "dst": dst, **dict(tdec.named_parameters())}
    for k, g in zip(leaves, torch.autograd.grad(tl, list(leaves.values()))):
        _close(g, jg[k])


def test_norm_regularizer_matches_jax():
    x = np.random.default_rng(4).standard_normal((9, 6)).astype(np.float32)
    for p, coef in ((2, 1.0), (3, 0.5), (1, 2.0)):
        _close(norm_regularizer(torch.from_numpy(x), p, coef),
               j_norm_regularizer(jnp.asarray(x), p, coef))


# -- the in-memory trainer -------------------------------------------------------

N, R, D, B, C, NEG, E = 64, 5, 16, 32, 4, 8, 200


class RelKeyReplay:
    """JAX's per-batch CORRUPT_REL key schedule (trainer.py:355-357, :520-562):
    ``_sample_rel_negatives`` gives the relation ids; ``_batch_draws`` the
    sampler's numbers of the same batch."""

    def __init__(self, key, c, n, r, gnn):
        self.key, self.c, self.n, self.r, self.gnn = key, c, n, r, gnn
        self.k_nb = None

    def negatives(self):
        self.key, k_rel, _ = jax.random.split(self.key, 3)
        ids = jax.random.randint(k_rel, (self.c, self.n), 0, max(self.r, 1), dtype=jnp.int32)
        if self.gnn:
            self.k_nb, self.key = jax.random.split(self.key)
        _, self.key = jax.random.split(self.key)        # k_drop
        return torch.from_numpy(np.asarray(ids).astype(np.int64))

    def draws(self):
        return jax_draws(self.k_nb)


def _stages(L, gnn):
    emb = (L("EMBEDDING", output_dim=D),)
    if not gnn:
        return (emb,)
    return (emb, (L("GNN", input_dim=D, output_dim=D, gnn_type="GRAPH_SAGE", aggregator="MEAN",
                    bias=True),))


def rel_trainer_pair(decoder="DISTMULT", gnn=False, edges=None, n=N, lr=0.01, sparse_lr=0.1,
                     opt="ADAM", dtype=None):
    """A JAX and a port CORRUPT_REL trainer on the same edges; the port's
    state, permutation, relation negatives and draws are JAX's. Adam at lr
    0.01, as in tests/test_torch_buffer_trainer.py: each Adam step moves a
    relation by about lr whatever its gradient, and at 0.1 two epochs carry
    float32 noise to the tolerance (one element of 1,024 at 1.7 atol)."""
    rng = np.random.default_rng(11)
    if edges is None:
        edges = np.stack([rng.integers(0, n, E), rng.integers(0, R, E),
                          rng.integers(0, n, E)], 1).astype(np.int32)
    models = []
    for M, Enc, L, Dec, O in ((JModel, JEncoderConfig, JLayerConfig, JEdgeDecoder, JOpt),
                              (TModel, TEncoderConfig, TLayerConfig, TEdgeDecoder, TOpt)):
        models.append(M("LINK_PREDICTION", Enc(_stages(L, gnn)),
                        Dec(decoder, R, D, decoder_method="CORRUPT_REL"),
                        dense_optimizer=O(opt, learning_rate=lr), sparse_lr=sparse_lr))
    nbr = [("UNIFORM", 3)] if gnn else []
    jkw = {} if dtype is None else {"dtype": dtype[0]}
    tkw = {} if dtype is None else {"dtype": dtype[1]}
    jtr = jtrainer_mod.LinkPredictionTrainer(
        models[0], n, R, edges, JNeg(C, NEG), batch_size=B, seed=0,
        graph=j_graph(edges, n, R) if gnn else None, nbr_configs=[JNbr(*c) for c in nbr], **jkw)
    ttr = TTrainer(models[1], n, R, edges, TNeg(C, NEG), batch_size=B, seed=0,
                   graph=t_graph(edges, n, R) if gnn else None,
                   nbr_configs=[TNbr(*c) for c in nbr], device="cpu", **tkw)
    assert ttr.unique_cap == jtr.unique_cap == 2 * B
    assert ttr.hop_caps == tuple(jtr.hop_caps)
    # DistMult's relations start at ones: every relation negative then scores
    # as its positive, the table gradients cancel to float32 noise, and
    # Adagrad's first step lr * g / |g| turns that noise into +-lr (ROADMAP
    # C5). Both sides start from the same random relations instead.
    dec = {k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)).astype(v.dtype)
           for k, v in jtr.state.params["decoder"].items()}
    jtr.state = dataclasses.replace(jtr.state, params={**jtr.state.params, "decoder": dec})
    size = jtr.num_batches * B
    ttr._epoch_permutation = lambda e: torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(jax.random.key(12345), e), size))).long()
    replay = RelKeyReplay(jax.random.wrap_key_data(np.array(jax.random.key_data(jtr.state.key))),
                          C, NEG, R, gnn)
    ttr._sample_rel_negatives = replay.negatives
    ttr._batch_draws = replay.draws
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    return jtr, ttr


@pytest.mark.parametrize("decoder,dense_accum", [("DISTMULT", True), ("DISTMULT", False),
                                                 ("COMPLEX", True)],
                         ids=["distmult-dense", "distmult-unique", "complex-dense"])
def test_rel_trainer_matches_jax_over_two_epochs(decoder, dense_accum):
    jtr, ttr = rel_trainer_pair(decoder)
    jtr.dense_accum = ttr.dense_accum = dense_accum
    for _ in range(2):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        check_states(ttr.state, _np_state(jtr.state))


def test_rel_gnn_trainer_matches_jax():
    """The GNN branch of _batch_step_rel: the endpoints alone seed the
    sampler. Two batches (ROADMAP C5), GraphSAGE MEAN at the GNN LP tests'
    rates."""
    rng = np.random.default_rng(2)
    n = 300
    edges = np.stack([rng.integers(0, n, 2 * B), rng.integers(0, R, 2 * B),
                      rng.integers(0, n, 2 * B)], 1).astype(np.int32)
    jtr, ttr = rel_trainer_pair(gnn=True, edges=edges, n=n, opt="ADAGRAD", sparse_lr=0.02)
    assert not ttr.dense_accum and ttr.num_batches == 2
    jres, tres = jtr.train_epoch(), ttr.train_epoch()
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
    check_states(ttr.state, _np_state(jtr.state))


# -- the buffer trainer ------------------------------------------------------------

class RelJaxDraws(JaxDraws):
    """JAX's buffer key schedule with CORRUPT_REL's extra split after the
    node negatives (buffer_trainer.py:313-317)."""

    def _keys(self, epoch, step):
        if epoch != self.epoch:
            self.epoch, self.keys = epoch, []
            self.key = jax.random.fold_in(jax.random.key(self.seed + 7), epoch)
        while len(self.keys) <= step:
            self.key, k_dst, k_src = jax.random.split(self.key, 3)
            self.key, k_rel = jax.random.split(self.key)
            self.keys.append((k_dst, k_src, None, k_rel))
        return self.keys[step]

    def relations(self, epoch, step, r):
        ids = jax.random.randint(self._keys(epoch, step)[3], (self.c, self.n), 0, max(r, 1),
                                 dtype=jnp.int32)
        return torch.from_numpy(np.asarray(ids).astype(np.int64))


@pytest.mark.parametrize("deg", [0.0, 0.5])
def test_rel_buffer_trainer_matches_jax(deg):
    """One epoch of buffer states (BETA, 4 partitions, capacity 2): the node
    negatives' rows are gathered and take zero gradients; the flushed host
    table, Adagrad state and dense state equal JAX's at the tolerance."""
    n, r, d = 200, 6, 8
    rng = np.random.default_rng(9)
    edges = np.stack([rng.integers(0, n, 800), rng.integers(0, r, 800),
                      rng.integers(0, n, 800)], 1).astype(np.int32)
    models = [M("LINK_PREDICTION", Enc(((L("EMBEDDING", output_dim=d),),)),
                Dec("COMPLEX", r, d, decoder_method="CORRUPT_REL"),
                dense_optimizer=O("ADAGRAD", learning_rate=0.1))
              for M, Enc, L, Dec, O in ((JModel, JEncoderConfig, JLayerConfig, JEdgeDecoder, JOpt),
                                        (TModel, TEncoderConfig, TLayerConfig, TEdgeDecoder, TOpt))]
    kw = dict(batch_size=100, num_partitions=4, buffer_capacity=2, seed=0, ordering="BETA")
    jtr = JBufferTrainer(models[0], n, r, edges, JNeg(2, 16, deg), **kw)
    ttr = TBufferTrainer(models[1], n, r, edges, TNeg(2, 16, deg), device="cpu", **kw)
    jtr.buffer.host_values[:n] = rng.uniform(-0.1, 0.1, (n, d)).astype(np.float32)
    # distinct relations (ComplEx's all start equal: rel_trainer_pair says why not)
    jtr.params = {**jtr.params, "decoder": {
        k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        for k, v in jtr.params["decoder"].items()}}
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    copy_buffer_trainer_from_jax_(ttr, np.asarray(jtr.buffer.host_values),
                                  np.asarray(jtr.buffer.host_state), np_tree(jtr.params),
                                  np_tree(jtr.opt_state), jtr.epoch)
    draws = RelJaxDraws(jtr)
    ttr._in_buffer_draws = lambda step, inverse: draws(ttr.epoch, step, inverse)
    ttr._rel_negatives = lambda step: draws.relations(ttr.epoch, step, r)
    res = run_and_compare(jtr, ttr, epochs=1)
    assert res["states_run"] >= 2


# -- the evaluator -------------------------------------------------------------------

EN, ER, EB = 120, 6, 50   # EB: a multiple of the default 10 chunks (unfiltered)


def _rel_eval_setup(decoder, inverse, seed=6):
    rng = np.random.default_rng(seed)
    e = 900
    edges = np.stack([rng.integers(0, EN, e), rng.integers(0, ER, e),
                      rng.integers(0, EN, e)], 1)
    # pairs (src, dst) true under several relations: filtering masks them
    multi = np.stack([np.repeat(np.arange(20), 3), np.tile(np.arange(3), 20),
                      np.repeat(np.arange(20, 40), 3)], 1)
    edges = np.unique(np.concatenate([edges, multi]), axis=0).astype(np.int32)
    test = edges[rng.permutation(len(edges))[:150]]
    k = 64 if decoder == "TRANSE" else 4
    d = 16
    q = lambda *s: rng.integers(-2 * k, 2 * k + 1, s).astype(np.float32) / k  # noqa: E731
    table = q(EN, d)
    rels = {"relations": q(ER, d)}
    if inverse:
        rels["inverse_relations"] = q(ER, d)
    stages = lambda L: ((L("EMBEDDING", output_dim=d),),)  # noqa: E731
    jm = JModel("LINK_PREDICTION", JEncoderConfig(stages(JLayerConfig)),
                JEdgeDecoder(decoder, ER, d, use_inverse_relations=inverse,
                             decoder_method="CORRUPT_REL"))
    tm = TModel("LINK_PREDICTION", TEncoderConfig(stages(TLayerConfig)),
                TEdgeDecoder(decoder, ER, d, use_inverse_relations=inverse,
                             decoder_method="CORRUPT_REL"))
    params = {"encoder": [[{}]], "decoder": rels}
    jstate = jtrainer_mod.TrainState(
        jtrainer_mod.EmbeddingTable(jnp.asarray(table), jnp.zeros_like(jnp.asarray(table))),
        jax.tree.map(jnp.asarray, params), None, None, 0)
    tstate = TTrainState(
        TTable(
            torch.from_numpy(table), torch.zeros(EN, d)),
        {"encoder": [[{}]], "decoder": {k: torch.from_numpy(v) for k, v in rels.items()}},
        None, 0)
    return jm, tm, edges, test, jstate, tstate


@pytest.mark.parametrize("decoder,inverse", DECODERS, ids=DEC_IDS)
def test_rel_ranks_and_pos_scores_equal_jax(decoder, inverse):
    jm, tm, edges, test, js, ts = _rel_eval_setup(decoder, inverse)
    for filtered in (True, False):
        kw = dict(all_edges=edges, batch_size=EB, filtered=filtered)
        jev = jevaluator.LinkPredictionEvaluator(jm, EN, ER, test, **kw)
        tev = tevaluator.LinkPredictionEvaluator(tm, EN, ER, test, device="cpu", **kw)
        jranks, jscores = jev.compute_all_ranks(js)
        tranks, tscores = tev.compute_all_ranks(ts)
        assert tranks.shape == jranks.shape == (1 + inverse, len(test))
        np.testing.assert_array_equal(tranks, jranks)
        _close(tscores, jscores)
        assert (jranks > 1).any()
        jres, tres = jev.evaluate(js), tev.evaluate(ts)
        for k in ("mrr", "mean_rank", "hits@1", "hits@10"):
            assert tres[k] == pytest.approx(jres[k], rel=1e-6), k
    # ONLY_POS: the positive scores, per direction
    tpos = tev.compute_pos_scores(ts)
    np.testing.assert_allclose(tpos, jev.compute_pos_scores(js), rtol=FWD_RTOL, atol=FWD_ATOL)
    assert tpos.shape == (1 + inverse, len(test))


def test_rel_eval_rank_semantics():
    """tests/test_decoder_methods.py's hand-checkable filtered relation ranks."""
    n, r, d = 4, 3, 4
    edges = np.array([[0, 0, 1], [0, 2, 1]], np.int32)   # (0, 1) true under rels {0, 2}
    model = TModel("LINK_PREDICTION", TEncoderConfig(((TLayerConfig("EMBEDDING", output_dim=d),),)),
                   TEdgeDecoder("DISTMULT", r, d, use_inverse_relations=False,
                                decoder_method="CORRUPT_REL"))
    ev = tevaluator.LinkPredictionEvaluator(model, n, r, edges, all_edges=edges, batch_size=2,
                                            device="cpu")
    vals = torch.zeros(n, d)
    vals[0] = vals[1] = 1.0
    rels = torch.tensor([[3.0, 0, 0, 0], [5.0, 0, 0, 0], [1.0, 0, 0, 0]])
    state = TTrainState(TTable(
        vals, torch.zeros(n, d)), {"encoder": [[{}]], "decoder": {"relations": rels}}, None, 0)
    ranks, _ = ev.compute_all_ranks(state)
    # (0,0,1): only rel 1 is a candidate, 5 >= 3 -> 2; (0,2,1): 5 >= 1 -> 2
    np.testing.assert_array_equal(ranks[0], [2, 2])


# -- the manager (tests/test_decoder_methods.py, tests/test_config_matrix.py) ----------

def _rel_raw(tmp_path, name, **overrides):
    base = {"model.decoder": {"type": "DISTMULT", "options": {
        "input_dim": 16, "edge_decoder_method": "CORRUPT_REL"}}}
    base.update(overrides)
    return _lp_config(tmp_path, name, **base)


def test_decoder_method_config(tmp_path):
    assert normalize_decoder_method("train") == "CORRUPT_NODE"
    assert normalize_decoder_method("INFER") == "ONLY_POS"
    assert normalize_decoder_method("corrupt_rel") == "CORRUPT_REL"
    raw = _rel_raw(tmp_path, "parse")
    assert load_config(copy.deepcopy(raw)).model.decoder.decoder_method == \
        j_load_config(copy.deepcopy(raw)).model.decoder.decoder_method == "CORRUPT_REL"
    for method in ("POS_AND_NEG", "CORRUPT_ALL"):
        bad = _lp_config(tmp_path, method, **{"model.decoder": {
            "type": "DISTMULT", "options": {"input_dim": 16, "edge_decoder_method": method}}})
        with pytest.raises(ConfigError, match=method if method == "POS_AND_NEG"
                           else "edge_decoder_method"):
            load_config(bad)


# the corrupt_rel rows of tests/test_config_matrix.py (:100-102) and
# tests/test_decoder_methods.py's end-to-end cases
REL_CONFIGS = {
    "filtered": {},
    "unfiltered": {"evaluation.negative_sampling": {"filtered": False}},
    "buffer_beta": {"storage.embeddings": {"type": "PARTITION_BUFFER", "options": {
        "num_partitions": 4, "buffer_capacity": 2, "edge_bucket_ordering": "BETA"}}},
    "device_async_unfiltered": {
        "training.pipeline": {"sync": False, "staleness_bound": 4},
        "evaluation.negative_sampling": {"filtered": False, "num_chunks": 2,
                                         "negatives_per_positive": 8}},
    "gnn": {"model.encoder": {
        "layers": [[{"type": "EMBEDDING", "output_dim": 16}],
                   [{"type": "GNN", "input_dim": 16, "output_dim": 16,
                     "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}]],
        "train_neighbor_sampling": [{"type": "UNIFORM", "options": {"max_neighbors": 4}}]}},
}


@pytest.mark.parametrize("variant", list(REL_CONFIGS))
def test_corrupt_rel_trains_and_evaluates(tmp_path, variant):
    raw = _rel_raw(tmp_path, variant, **copy.deepcopy(REL_CONFIGS[variant]))
    raw["storage"]["save_model"] = True
    raw["storage"]["model_dir"] = str(tmp_path / f"model_{variant}")
    result = _train(raw)
    rt = result["runtime"]
    assert rt.trainer.decoder_method == "CORRUPT_REL"
    assert type(rt.trainer).__name__ == ("PartitionBufferLPTrainer" if variant == "buffer_beta"
                                         else "LinkPredictionTrainer")
    assert len(result["epochs"]) == 2 and all(np.isfinite(e["loss"]) for e in result["epochs"])
    assert 0.0 < result["test"]["mrr"] <= 1.0
    # relation ranks: at most R (5) candidates per direction
    assert result["test"]["mean_rank"] <= 5
    again = marius_eval(load_config(raw), device="cpu")
    assert again["test"]["mrr"] == pytest.approx(result["test"]["mrr"], abs=1e-12)


def test_corrupt_rel_learns_relations():
    """A relation that is a function of the source is near-memorized: the
    filtered relation MRR after 12 epochs is far above chance (1/R)."""
    rng = np.random.default_rng(0)
    n, r, e = 60, 6, 1200
    src = rng.integers(0, n, e)
    edges = np.stack([src, src % r, rng.integers(0, n, e)], 1).astype(np.int32)
    enc = TEncoderConfig(((TLayerConfig("EMBEDDING", output_dim=16),),))
    model = TModel("LINK_PREDICTION", enc,
                   TEdgeDecoder("DISTMULT", r, 16, decoder_method="CORRUPT_REL"))
    tr = TTrainer(model, n, r, edges, TNeg(2, 8), batch_size=100, device="cpu")
    losses = [s["loss"] for s in tr.train(12)]
    assert losses[-1] < losses[0]
    ev = tevaluator.LinkPredictionEvaluator(model, n, r, edges[:300], all_edges=edges,
                                            batch_size=100, device="cpu")
    assert ev.evaluate(tr.state)["mrr"] > 0.8


def test_only_pos_scores_through_the_evaluator(tmp_path):
    """ONLY_POS (INFER) models score positives: a trained model's scores,
    both directions, are the decoder applied to the checkpoint's rows."""
    raw = _lp_config(tmp_path, "onlypos")
    rt = _train(raw)["runtime"]
    st = rt.trainer.state
    test = rt.test_evaluator.edges[:rt.test_evaluator.num_edges]
    scores = rt.test_evaluator.compute_pos_scores(st)
    assert scores.shape == (2, len(test))
    rels = st.params["decoder"]
    src, dst = st.table.values[test[:, 0]], st.table.values[test[:, 2]]
    with torch.no_grad():
        fwd = (src * rels["relations"][test[:, 1]] * dst).sum(-1)
        inv = (dst * rels["inverse_relations"][test[:, 1]] * src).sum(-1)
    np.testing.assert_allclose(scores, torch.stack([fwd, inv]).numpy(), rtol=1e-6, atol=1e-7)
