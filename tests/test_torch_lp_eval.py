"""The port's LP evaluation pieces against marius_tpu's, on the CPU.

Metrics and the reporter, the edge-key sets and their searches, the ALL local
filter, filtered training with train keys, and the evaluator. Ranks must be
EQUAL to the JAX package's: the tables are quantized (multiples of 1/4 in
[-2, 2], d <= 32), so every product and partial sum is exact in float32 and
the summation order cannot move a score, while ties are common and test
``>=``. TransE's positive score adds eps = 1e-6 to each difference before
squaring, which no grid keeps exact: its tables are multiples of 1/64, where
the negatives stay exact and ties with the positive are rare, and its
positive scores agree to rtol 1e-6. A sampled negative that IS the
positive's node ties its exact distance, and the comparison then turns on
the last bit of the eps-shifted sum: TransE's unfiltered case uses the ALL
local filter, which masks that node (DEG is covered by DistMult and
ComplEx). The rank sums of ``evaluate()`` are
float32 sums in another order: rtol 1e-6. Filtered training runs 2 epochs at
the trainer tests' tolerance.

The JAX lower-bound search returns n + 1, not n, for a query above every key
(``marius_tpu/ops/edge_keys.py:97-112``), so the last (anchor, rel) run of a
key set gets one repeated row and its edges' filtered ranks can come out one
too small. The port returns n; the evaluator tests hold it against the JAX
search with that one value clamped (``jax_search_clamped``),
``test_anchor_ranges_of_the_last_run`` shows the difference, and
``test_filtered_ranks_against_the_unpatched_jax_search`` bounds it: against
the JAX evaluator as it is, ranks differ only on those edges, by one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marius_tpu.train.evaluator as jevaluator
import marius_tpu.train.trainer as jtrainer_mod
from marius_tpu.data.samplers import negative as jneg
from marius_tpu.nn.decoders.edge import EdgeDecoder as JEdgeDecoder
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.ops import edge_keys as jkeys
from marius_tpu.reporting import metrics as jmetrics
from marius_tpu.reporting.reporters import LinkPredictionReporter as JReporter
from marius_tpu_torch.convert import copy_train_state_, train_state_from_jax
from marius_tpu_torch.data.samplers import negative as tneg
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder as TEdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.ops import edge_keys as tkeys
from marius_tpu_torch.reporting import metrics as tmetrics
from marius_tpu_torch.reporting.reporters import LinkPredictionReporter as TReporter
from marius_tpu_torch.train import evaluator as tevaluator
from marius_tpu_torch.train.trainer import LinkPredictionTrainer as TTrainer
from marius_tpu_torch.train.trainer import TrainState as TTrainState
from tests.test_torch_lp_trainer import (
    ATOL,
    RTOL,
    _np_state,
    fake_negatives_jax,
    fake_negatives_torch,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HITS = (1, 3, 5, 10, 50, 100)


@pytest.fixture
def jax_search_clamped(monkeypatch):
    """The JAX reference with its lower bound clamped to the key count."""
    search = jkeys._lex_lower_bound
    monkeypatch.setattr(jkeys, "_lex_lower_bound", lambda keys, qa, qr, qo: jnp.minimum(
        search(keys, qa, qr, qo), keys.anchor.shape[0]))


# -- metrics and the reporter ------------------------------------------------

def test_ranks_statistics_and_reporter_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    b, n = 37, 23
    # small integers: many ties between negatives and the positive
    pos = rng.integers(-3, 4, b).astype(np.float32)
    neg = rng.integers(-3, 4, (b, n)).astype(np.float32)
    neg_mask = rng.random((b, n)) < 0.7
    jr = np.asarray(jmetrics.compute_ranks(jnp.asarray(pos), jnp.asarray(neg),
                                           jnp.asarray(neg_mask)))
    tr = tmetrics.compute_ranks(torch.from_numpy(pos), torch.from_numpy(neg),
                                torch.from_numpy(neg_mask))
    assert tr.dtype == torch.int32
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(
        tmetrics.compute_ranks(torch.from_numpy(pos), torch.from_numpy(neg)).numpy(),
        np.asarray(jmetrics.compute_ranks(jnp.asarray(pos), jnp.asarray(neg))))

    jrep, trep = JReporter(HITS), TReporter(HITS)
    for mask in (None, rng.random(b) < 0.8):
        js = jmetrics.rank_statistics(jnp.asarray(jr), None if mask is None else jnp.asarray(mask),
                                      HITS)
        ts = tmetrics.rank_statistics(tr, None if mask is None else torch.from_numpy(mask), HITS)
        assert list(ts) == list(js)
        for k in js:
            assert ts[k].dtype == torch.float32
            np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6)
        jrep.add_statistics(js)
        trep.add_statistics(ts)
    assert trep.results() == pytest.approx(jrep.results(), rel=1e-6)
    assert trep.results().keys() == jmetrics.finalize_rank_statistics(
        {k: float(v) for k, v in js.items()}).keys()
    assert trep.report() == jrep.report()

    for rep, name in ((jrep, "jax"), (trep, "port")):
        rep.add_ranks(jr, pos)
        rep.add_ranks(jr[:5], pos[:5])
        rep.save(str(tmp_path / name), scores=True)
    for f in ("ranks.csv", "scores.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    trep.clear()
    assert trep.results() == {}


# -- edge keys ---------------------------------------------------------------

def _graph(typed, n=40, r=3, e=300, seed=1):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, n, e), rng.integers(0, r, e), rng.integers(0, n, e)]
    edges = np.stack(cols if typed else [cols[0], cols[2]], 1).astype(np.int32)
    return np.concatenate([edges, edges[:50]])   # duplicate edges


def _keys_np(keys):
    return [np.asarray(k) for k in keys]


@pytest.mark.parametrize("typed", [True, False], ids=["typed", "untyped"])
@pytest.mark.parametrize("corrupt_dst", [True, False], ids=["dst", "src"])
def test_edge_keys_match_jax(typed, corrupt_dst):
    n, r = 40, 3
    edges = _graph(typed, n, r)
    jk = jkeys.build_edge_key_set(edges, corrupt_dst)
    tk = tkeys.build_edge_key_set(edges, corrupt_dst)
    for t, j in zip(tk, _keys_np(jk)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), j)
    assert tkeys.max_anchor_tail(edges, corrupt_dst) == jkeys.max_anchor_tail(edges, corrupt_dst)

    rng = np.random.default_rng(2)
    # queries: true edges, random triples, and anchors, relations and others
    # out of range (below every key and above every key)
    qa = np.concatenate([edges[:30, 0 if corrupt_dst else -1], rng.integers(-3, n + 3, 40),
                         [-5, n + 9, 0, n - 1]]).astype(np.int32)
    qr = np.concatenate([edges[:30, 1] if typed else np.zeros(30, np.int64),
                         rng.integers(-1, r + 2, 40), [0, 0, -2, r + 5]]).astype(np.int32)
    qo = np.concatenate([edges[:30, -1 if corrupt_dst else 0], rng.integers(-3, n + 3, 40),
                         [0, 0, 1, 2]]).astype(np.int32)
    rel_j = jnp.asarray(qr) if typed else None
    rel_t = torch.from_numpy(qr) if typed else None
    jin = np.asarray(jkeys.isin_triples(jk, jnp.asarray(qa), rel_j, jnp.asarray(qo)))
    tin = tkeys.isin_triples(tk, torch.from_numpy(qa), rel_t, torch.from_numpy(qo))
    np.testing.assert_array_equal(tin.numpy(), jin)
    assert jin[:30].all() and not jin.all()
    n_keys = tk.anchor.shape[0]
    for t, j in zip(tkeys.anchor_ranges(tk, torch.from_numpy(qa), rel_t),
                    jkeys.anchor_ranges(jk, jnp.asarray(qa), rel_j)):
        np.testing.assert_array_equal(t.numpy(), np.minimum(np.asarray(j), n_keys))
    lo, hi = tkeys.anchor_ranges(tk, torch.from_numpy(qa), rel_t)
    # anchors (and, typed, relations) out of range: empty runs
    empty = slice(-4, None) if typed else slice(-4, -2)
    assert (lo[empty] == hi[empty]).all()
    np.testing.assert_array_equal(
        tkeys.filter_mask_all_nodes(tk, torch.from_numpy(qa), rel_t, n + 4).numpy(),
        np.asarray(jkeys.filter_mask_all_nodes(jk, jnp.asarray(qa), rel_j, n + 4)))
    negs = rng.integers(-2, n + 2, (4, 13)).astype(np.int32)
    a, rr = qa[:72], (qr[:72] if typed else None)
    np.testing.assert_array_equal(
        tkeys.filter_mask_sampled(tk, torch.from_numpy(a),
                                  None if rr is None else torch.from_numpy(rr),
                                  torch.from_numpy(negs)).numpy(),
        np.asarray(jkeys.filter_mask_sampled(jk, jnp.asarray(a),
                                             None if rr is None else jnp.asarray(rr),
                                             jnp.asarray(negs))))


def test_anchor_ranges_of_the_last_run():
    edges = np.array([[0, 0, 1], [0, 1, 2], [3, 1, 0], [3, 1, 2], [3, 1, 2]], np.int32)
    tk = tkeys.build_edge_key_set(edges, True)
    jk = jkeys.build_edge_key_set(edges, True)
    q = (np.array([3, 0, 9], np.int32), np.array([1, 1, 0], np.int32))
    tlo, thi = tkeys.anchor_ranges(tk, *(torch.from_numpy(a) for a in q))
    jlo, jhi = jkeys.anchor_ranges(jk, *(jnp.asarray(a) for a in q))
    # keys: (0,0,1) (0,1,2) (3,1,0) (3,1,2); the last run is rows [2, 4)
    assert tlo.tolist() == [2, 1, 4] and thi.tolist() == [4, 2, 4]
    assert np.asarray(jlo).tolist() == [2, 1, 5] and np.asarray(jhi).tolist() == [5, 2, 5]


def test_lexsort_matches_numpy():
    rng = np.random.default_rng(3)
    keys = [rng.integers(0, 4, 200) for _ in range(3)]
    order = tkeys.lexsort([torch.from_numpy(k) for k in keys]).numpy()
    np.testing.assert_array_equal(np.stack(keys)[:, order], np.stack(keys)[:, np.lexsort(keys)])


@pytest.mark.parametrize("typed", [True, False], ids=["typed", "untyped"])
@pytest.mark.parametrize("inverse", [False, True], ids=["dst", "src"])
def test_local_all_filter_mask_matches_jax(typed, inverse):
    rng = np.random.default_rng(4)
    b, c, n_neg, n = 24, 4, 9, 12
    edges = _graph(typed, n, 3, b, seed=5)[:b]
    edge_mask = np.arange(b) < 19          # a padded tail
    negs = rng.integers(0, n, (c, n_neg)).astype(np.int32)
    j = jneg.local_all_filter_mask(jnp.asarray(edges), jnp.asarray(edge_mask),
                                   jnp.asarray(negs), inverse)
    t = tneg.local_all_filter_mask(torch.from_numpy(edges).long(), torch.from_numpy(edge_mask),
                                   torch.from_numpy(negs).long(), inverse)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.any()


# -- filtered training -------------------------------------------------------

N, R, D = 64, 4, 16


def _models(decoder_type="DISTMULT", d=D, r=R, inverse=True):
    stages = lambda L: (((L("EMBEDDING", output_dim=d),),))  # noqa: E731
    return (JModel("LINK_PREDICTION", JEncoderConfig(stages(JLayerConfig)),
                   JEdgeDecoder(decoder_type, r, d, use_inverse_relations=inverse)),
            TModel("LINK_PREDICTION", TEncoderConfig(stages(TLayerConfig)),
                   TEdgeDecoder(decoder_type, r, d, use_inverse_relations=inverse)))


@pytest.mark.parametrize("dense_accum", [True, False], ids=["dense", "unique"])
def test_filtered_training_matches_jax(monkeypatch, dense_accum):
    b, c, neg = 32, 4, 8
    edges = _graph(True, N, R, 200, seed=11)
    monkeypatch.setattr(jtrainer_mod, "sample_negatives", fake_negatives_jax)
    jmodel, tmodel = _models()
    jkeys_pair = (jkeys.build_edge_key_set(edges, True), jkeys.build_edge_key_set(edges, False))
    tkeys_pair = (tkeys.build_edge_key_set(edges, True), tkeys.build_edge_key_set(edges, False))
    jcfg = jneg.NegativeSamplingConfig(c, neg, 0.25, filtered=True)
    tcfg = tneg.NegativeSamplingConfig(c, neg, 0.25, filtered=True)
    jtr = jtrainer_mod.LinkPredictionTrainer(jmodel, N, R, edges, jcfg, batch_size=b, seed=0,
                                             train_filter_keys=jkeys_pair)
    ttr = TTrainer(tmodel, N, R, edges, tcfg, batch_size=b, seed=0, device="cpu",
                   train_filter_keys=tkeys_pair)
    monkeypatch.setattr(ttr, "_sample_negatives",
                        lambda edges_b, inverse: fake_negatives_torch(tcfg, edges_b, N, inverse))
    size = jtr.num_batches * b
    monkeypatch.setattr(ttr, "_epoch_permutation", lambda e: torch.from_numpy(np.array(
        jax.random.permutation(jax.random.fold_in(jax.random.key(12345), e), size))).long())
    jtr.dense_accum = ttr.dense_accum = dense_accum
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))

    # the filter masks something on these batches
    e0 = torch.from_numpy(edges[:b]).long()
    ns = fake_negatives_torch(tcfg, e0, N, False)
    assert tkeys.filter_mask_sampled(tkeys_pair[0], e0[:, 0], e0[:, 1], ns.ids).any()
    for _ in range(2):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        js = _np_state(jtr.state)
        for t, j in ((ttr.state.table.values, js.table.values),
                     (ttr.state.table.state, js.table.state),
                     (ttr.state.params["decoder"]["relations"], js.params["decoder"]["relations"])):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


# -- the evaluator -----------------------------------------------------------

EN, ER = 300, 5          # N = 300 with node_chunk 128: the last chunk is partial
EB = 64                  # 250 test edges: the last batch is partial


def _quantized_states(jmodel, rng, edges, d, r):
    """A JAX TrainState whose table and relation tables are multiples of 1/4
    (1/64 for TransE) in [-2, 2], and the same state in the port."""
    jtr = jtrainer_mod.LinkPredictionTrainer(jmodel, EN, r, edges,
                                             jneg.NegativeSamplingConfig(4, 8), batch_size=EB)
    s = jtr.state
    k = 64 if jmodel.decoder.decoder_type == "TRANSE" else 4
    q = lambda shape: jnp.asarray(  # noqa: E731
        rng.integers(-2 * k, 2 * k + 1, shape).astype(np.float32) / k)
    params = {**s.params, "decoder": {k: q(v.shape) for k, v in s.params["decoder"].items()}}
    js = dataclasses.replace(s, table=dataclasses.replace(s.table, values=q((EN, d))),
                             params=params)
    return js, train_state_from_jax(_np_state(js))


def _eval_data(typed, seed=6):
    rng = np.random.default_rng(seed)
    e = 1200
    cols = [rng.integers(0, EN, e), rng.integers(0, ER, e), rng.integers(0, EN, e)]
    # a hub: node 7 with many true tails under relation 1
    hub = np.stack([np.full(80, 7), np.full(80, 1), rng.integers(0, EN, 80)], 1)
    edges = np.concatenate([np.stack(cols, 1), hub])
    if not typed:
        edges = edges[:, [0, 2]]
    edges = edges.astype(np.int32)
    perm = rng.permutation(len(edges))
    test = edges[perm[:250]]
    return edges, np.concatenate([test, test[:3]]), rng   # duplicate test edges


def _evaluators(jmodel, tmodel, test, all_edges, filtered, neg=None):
    jev = jevaluator.LinkPredictionEvaluator(
        jmodel, EN, ER, test, all_edges=all_edges, batch_size=EB, filtered=filtered,
        neg_config=neg and neg[0], node_chunk=128)
    tev = tevaluator.LinkPredictionEvaluator(
        tmodel, EN, ER, test, all_edges=all_edges, batch_size=EB, filtered=filtered,
        neg_config=neg and neg[1], node_chunk=128, device="cpu")
    return jev, tev


CASES = [("DISTMULT", True, True), ("DISTMULT", True, False), ("DISTMULT", False, True),
         ("COMPLEX", True, True), ("COMPLEX", False, True),
         ("TRANSE", True, True), ("TRANSE", True, False), ("TRANSE", False, True)]


@pytest.mark.parametrize("decoder_type,typed,inverse", CASES,
                         ids=[f"{d}-{'typed' if t else 'untyped'}-{'inv' if i else 'noinv'}"
                              for d, t, i in CASES])
def test_filtered_ranks_equal_jax(monkeypatch, jax_search_clamped, decoder_type, typed,
                                  inverse):
    d = 32 if decoder_type != "TRANSE" else 16
    edges, test, rng = _eval_data(typed)
    jmodel, tmodel = _models(decoder_type, d, ER, inverse)
    js, ts = _quantized_states(jmodel, rng, edges, d, ER)
    jev, tev = _evaluators(jmodel, tmodel, test, edges, True)
    assert tev.node_chunk == jev.node_chunk == 128
    assert (tev.dst_tail_cap, tev.src_tail_cap) == (jev.dst_tail_cap, jev.src_tail_cap)
    jranks, jscores = jev.compute_all_ranks(js)
    tranks, tscores = tev.compute_all_ranks(ts)
    assert tranks.shape == jranks.shape == (1 + (typed and inverse), len(test))
    np.testing.assert_array_equal(tranks, jranks)
    _scores_match(decoder_type, tscores, jscores)
    assert (jranks > 1).any()
    # the per-chunk membership test instead of the true-candidate list
    monkeypatch.setattr(tevaluator, "TAIL_CAP_LIMIT", 0)
    np.testing.assert_array_equal(tev.compute_all_ranks(ts)[0], jranks)


def test_filtered_ranks_against_the_unpatched_jax_search():
    edges, test, rng = _eval_data(True)
    # the last (anchor, rel, other) key of each direction's key set is a test edge
    dst_last = edges[np.lexsort((edges[:, 2], edges[:, 1], edges[:, 0]))[-1]]
    src_last = edges[np.lexsort((edges[:, 0], edges[:, 1], edges[:, 2]))[-1]]
    test = np.concatenate([test, dst_last[None], src_last[None]])
    jmodel, tmodel = _models("DISTMULT", 32, ER, True)
    js, ts = _quantized_states(jmodel, rng, edges, 32, ER)
    jev, tev = _evaluators(jmodel, tmodel, test, edges, True)
    diff = tev.compute_all_ranks(ts)[0] - jev.compute_all_ranks(js)[0]
    last_run = np.stack([(test[:, 0] == dst_last[0]) & (test[:, 1] == dst_last[1]),
                         (test[:, 2] == src_last[2]) & (test[:, 1] == src_last[1])])
    assert (diff[~last_run] == 0).all()
    assert set(diff[last_run].tolist()) <= {0, 1}
    # the last key's edge: the reference counts its own candidate twice
    assert diff[0, -2] == diff[1, -1] == 1


def _scores_match(decoder_type, t, j):
    if decoder_type == "TRANSE":
        np.testing.assert_allclose(t, j, rtol=1e-6)
    else:
        np.testing.assert_array_equal(t, j)


def _neg_configs(mode, c=4, n=16, frac=0.25):
    return (jneg.NegativeSamplingConfig(c, n, frac, local_filter_mode=mode),
            tneg.NegativeSamplingConfig(c, n, frac, local_filter_mode=mode))


UNFILTERED = [("DISTMULT", "DEG", True), ("DISTMULT", "ALL", True), ("DISTMULT", "ALL", False),
              ("COMPLEX", "DEG", True), ("COMPLEX", "ALL", True),
              ("TRANSE", "ALL", True)]


@pytest.mark.parametrize("decoder_type,mode,typed", UNFILTERED,
                         ids=[f"{d}-{m}-{'typed' if t else 'untyped'}" for d, m, t in UNFILTERED])
def test_unfiltered_ranks_equal_jax(monkeypatch, decoder_type, mode, typed):
    d = 32 if decoder_type != "TRANSE" else 16
    edges, test, rng = _eval_data(typed)
    jmodel, tmodel = _models(decoder_type, d, ER)
    js, ts = _quantized_states(jmodel, rng, edges, d, ER)
    neg = _neg_configs(mode)
    monkeypatch.setattr(jevaluator, "sample_negatives", fake_negatives_jax)
    jev, tev = _evaluators(jmodel, tmodel, test, edges, False, neg)
    monkeypatch.setattr(tev, "_sample_negatives", lambda edges_b, idx, inverse, valid_rows:
                        fake_negatives_torch(neg[1], edges_b, EN, inverse))
    jranks, jscores = jev.compute_all_ranks(js)
    tranks, tscores = tev.compute_all_ranks(ts)
    np.testing.assert_array_equal(tranks, jranks)
    _scores_match(decoder_type, tscores, jscores)
    # the local filter masks some negatives
    unfiltered = dataclasses.replace(neg[1], local_filter_mode="NONE")
    tev.neg_config = unfiltered
    assert (tev.compute_all_ranks(ts)[0] != tranks).any()


@pytest.mark.parametrize("filtered", [True, False], ids=["filtered", "unfiltered"])
def test_evaluate_matches_jax(monkeypatch, jax_search_clamped, filtered):
    edges, test, rng = _eval_data(True)
    jmodel, tmodel = _models("COMPLEX", 32, ER)
    js, ts = _quantized_states(jmodel, rng, edges, 32, ER)
    neg = None if filtered else _neg_configs("ALL")
    if not filtered:
        monkeypatch.setattr(jevaluator, "sample_negatives", fake_negatives_jax)
    jev, tev = _evaluators(jmodel, tmodel, test, edges, filtered, neg)
    if not filtered:
        monkeypatch.setattr(tev, "_sample_negatives", lambda edges_b, idx, inverse, valid_rows:
                            fake_negatives_torch(neg[1], edges_b, EN, inverse))
    jres, tres = jev.evaluate(js), tev.evaluate(ts)
    assert jres.keys() == tres.keys()
    for k in jres:
        if k != "eval_time_s":
            np.testing.assert_allclose(tres[k], jres[k], rtol=1e-6, err_msg=k)
    assert tres["num_evaluated"] == 2 * len(test)


def test_evaluator_sampling_is_deterministic_and_clips_padding():
    edges, test, _ = _eval_data(True)
    _, tmodel = _models("DISTMULT", 32, ER)
    tev = tevaluator.LinkPredictionEvaluator(
        tmodel, EN, ER, test, batch_size=EB, filtered=False,
        neg_config=tneg.NegativeSamplingConfig(4, 16, 0.5), device="cpu")
    last = tev.num_batches - 1
    edges_b = tev.edges[last * EB:]
    valid = tev.num_edges - last * EB
    a, b = (tev._sample_negatives(edges_b, last, True, valid) for _ in range(2))
    assert torch.equal(a.ids, b.ids)
    assert int(a.deg_sample_indices.max()) < valid < EB
    other = tev._sample_negatives(edges_b, last, False, valid)
    assert not torch.equal(a.ids, other.ids)


def test_evaluator_rejects_later_slices(jax_search_clamped):
    edges, test, _ = _eval_data(True)
    _, tmodel = _models("DISTMULT", 32, ER)
    rel_model = dataclasses.replace(
        tmodel, decoder=TEdgeDecoder("DISTMULT", ER, 32, decoder_method="CORRUPT_REL"))
    # CORRUPT_REL ranking is ported (tests/test_torch_corrupt_rel.py); host-tiled
    # evaluation streams node corruption and refuses it, as JAX does
    rel_ev = tevaluator.LinkPredictionEvaluator(rel_model, EN, ER, test, all_edges=edges,
                                                device="cpu")
    assert rel_ev.decoder_method == "CORRUPT_REL"
    with pytest.raises(ValueError, match="CORRUPT_REL"):
        rel_ev.evaluate_from_host_table(None, None)
    # FEATURE encoders are ported: a pure-FEATURE model ranks as JAX's does
    # (quantized features and relations: exact scores)
    jmodel, _ = _models("DISTMULT", 32, ER)
    feature_model = dataclasses.replace(tmodel, encoder=TEncoderConfig(
        ((TLayerConfig("FEATURE", output_dim=32),),)))
    j_feature_model = dataclasses.replace(jmodel, encoder=JEncoderConfig(
        ((JLayerConfig("FEATURE", output_dim=32),),)))
    rng = np.random.default_rng(8)
    feats = np.concatenate([rng.integers(-8, 9, (EN, 32)).astype(np.float32) / 4,
                            np.zeros((1, 32), np.float32)])
    rels = {k: rng.integers(-8, 9, (ER, 32)).astype(np.float32) / 4
            for k in ("relations", "inverse_relations")}
    tev = tevaluator.LinkPredictionEvaluator(feature_model, EN, ER, test, all_edges=edges,
                                             batch_size=EB, features=torch.from_numpy(feats),
                                             device="cpu")
    jev = jevaluator.LinkPredictionEvaluator(j_feature_model, EN, ER, test, all_edges=edges,
                                             batch_size=EB, features=jnp.asarray(feats))
    tstate = TTrainState(None, {"encoder": [[{}]], "decoder": {
        k: torch.from_numpy(v) for k, v in rels.items()}}, None, 0)
    jstate = jtrainer_mod.TrainState(None, {"encoder": [[{}]], "decoder": {
        k: jnp.asarray(v) for k, v in rels.items()}}, None, None, 0)
    tranks, jranks = tev.compute_all_ranks(tstate)[0], jev.compute_all_ranks(jstate)[0]
    np.testing.assert_array_equal(tranks, jranks)
    assert (jranks > 1).any()
    tev_feat = tev
    tev = tevaluator.LinkPredictionEvaluator(tmodel, EN, ER, test, all_edges=edges,
                                             device="cpu")
    # host-tiled evaluation is ported; it ranks against all nodes only
    unfiltered = tevaluator.LinkPredictionEvaluator(tmodel, EN, ER, test, filtered=False,
                                                    batch_size=50, device="cpu")
    with pytest.raises(ValueError, match="filtered"):
        unfiltered.evaluate_from_host_table(None, None)
    # ONLY_POS scoring is ported: the pure-FEATURE model's positive scores are JAX's
    np.testing.assert_array_equal(tev_feat.compute_pos_scores(tstate),
                                  jev.compute_pos_scores(jstate))


@pytest.mark.slow
def test_distmult_pinned_band_on_the_cpu():
    """The port's DistMult reaches the JAX package's pinned band
    (tests/test_accuracy_regression.py:70-96: filtered MRR 0.34-0.45,
    Hits@10 >= 0.60) on its realizable KG, trained as _run_lp does."""
    from marius_tpu_torch.nn.optimizers import OptimizerConfig
    from tests.test_accuracy_regression import make_realizable_kg

    edges = make_realizable_kg()
    tr, va = int(0.9 * len(edges)), int(0.95 * len(edges))
    _, model = _models("DISTMULT", 32, 10)
    model = dataclasses.replace(model, loss_reduction="SUM",
                                dense_optimizer=OptimizerConfig("ADAGRAD", learning_rate=0.1))
    trainer = TTrainer(model, 500, 10, edges[:tr], tneg.NegativeSamplingConfig(4, 128),
                       batch_size=500, seed=0, device="cpu")
    for _ in range(60):
        trainer.train_epoch()
    res = tevaluator.LinkPredictionEvaluator(model, 500, 10, edges[va:], all_edges=edges,
                                             batch_size=500, device="cpu").evaluate(trainer.state)
    assert 0.34 <= res["mrr"] <= 0.45, res
    assert res["hits@10"] >= 0.60, res
