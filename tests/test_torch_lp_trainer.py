"""The port's LinkPredictionTrainer against marius_tpu's, over 2 epochs.

Both trainers start from the JAX initial state (carried across with
``train_state_from_jax``), see the same negatives (a deterministic function
of the batch, patched into JAX's ``sample_negatives`` and the port's
``_sample_negatives`` seam) and the same permutation (JAX's, computed eagerly
and passed through the port's ``_epoch_permutation`` seam). After each epoch
the losses, the table values and Adagrad state, the decoder parameters and
the Adam slots must agree to rtol=1e-4, atol=1e-5: both run float32, but sums
and gradient scatters run in another order, and two epochs of Adam at lr 0.1
carry those differences forward.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marius_tpu.train.trainer as jtrainer_mod
from marius_tpu.data.samplers.negative import NegativeSample as JNegativeSample
from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNegConfig
from marius_tpu.nn.decoders.edge import EdgeDecoder as JEdgeDecoder
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu_torch.convert import copy_train_state_, train_state_from_jax
from marius_tpu_torch.data.samplers.negative import NegativeSample as TNegativeSample
from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig as TNegConfig
from marius_tpu_torch.nn.decoders.edge import EdgeDecoder as TEdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import tree_leaves
from marius_tpu_torch.train.trainer import LinkPredictionTrainer as TTrainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
N, R, D, B, C, NEG, E = 64, 4, 16, 32, 4, 8, 200
DEG_FRACTION = 0.25


def _fake_layout(cfg):
    nb = int(cfg.negatives_per_positive * cfg.degree_fraction)
    return cfg.num_chunks, cfg.negatives_per_positive - nb, nb


def fake_negatives_jax(key, cfg, edges, num_nodes, inverse, valid_rows=None):
    """A deterministic function of the batch with sample_negatives' layout."""
    c, nu, nb = _fake_layout(cfg)
    col = 0 if inverse else edges.shape[1] - 1
    base = jnp.sum(edges[:, col]) + (3 if inverse else 0)
    uni = ((base + 7 * jnp.arange(c * nu, dtype=jnp.int32)) % num_nodes).reshape(c, nu)
    rows = ((base + 5 * jnp.arange(c * nb, dtype=jnp.int32)) % edges.shape[0]).reshape(c, nb)
    deg = edges[:, col][rows]
    return JNegativeSample(jnp.concatenate([deg, uni], axis=1).astype(jnp.int32), rows)


def fake_negatives_torch(cfg, edges, num_nodes, inverse):
    c, nu, nb = _fake_layout(cfg)
    col = 0 if inverse else edges.shape[1] - 1
    base = edges[:, col].sum() + (3 if inverse else 0)
    uni = ((base + 7 * torch.arange(c * nu)) % num_nodes).reshape(c, nu)
    rows = ((base + 5 * torch.arange(c * nb)) % edges.shape[0]).reshape(c, nb)
    deg = edges[:, col][rows]
    return TNegativeSample(torch.cat([deg, uni], dim=1), rows)


def _edges(has_rels):
    rng = np.random.default_rng(11)
    cols = [rng.integers(0, N, E), rng.integers(0, R, E), rng.integers(0, N, E)]
    if not has_rels:
        cols = [cols[0], cols[2]]
    return np.stack(cols, axis=1).astype(np.int32)


def _np_state(jstate):
    # the typed PRNG key has no numpy form and no counterpart in the port
    return jax.tree.map(np.asarray, dataclasses.replace(jstate, key=None))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dense_accum,has_rels", [(True, True), (False, True), (True, False)],
                         ids=["dense-typed", "unique-typed", "dense-untyped"])
def test_trainer_matches_jax_over_two_epochs(monkeypatch, dense_accum, has_rels):
    edges = _edges(has_rels)
    monkeypatch.setattr(jtrainer_mod, "sample_negatives", fake_negatives_jax)
    jmodel = JModel("LINK_PREDICTION",
                    JEncoderConfig(((JLayerConfig("EMBEDDING", output_dim=D),),)),
                    JEdgeDecoder("DISTMULT", R, D))
    jtr = jtrainer_mod.LinkPredictionTrainer(
        jmodel, N, R, edges, JNegConfig(C, NEG, DEG_FRACTION), batch_size=B, seed=0)

    tmodel = TModel("LINK_PREDICTION",
                    TEncoderConfig(((TLayerConfig("EMBEDDING", output_dim=D),),)),
                    TEdgeDecoder("DISTMULT", R, D))
    ttr = TTrainer(tmodel, N, R, edges, TNegConfig(C, NEG, DEG_FRACTION), batch_size=B,
                   seed=0, device="cpu")
    tcfg = ttr.neg_config
    monkeypatch.setattr(ttr, "_sample_negatives",
                        lambda edges_b, inverse: fake_negatives_torch(tcfg, edges_b, N, inverse))
    size = jtr.num_batches * B
    monkeypatch.setattr(ttr, "_epoch_permutation", lambda e: torch.from_numpy(np.array(
        jax.random.permutation(jax.random.fold_in(jax.random.key(12345), e), size))).long())

    assert jtr.dense_accum and ttr.dense_accum
    jtr.dense_accum = ttr.dense_accum = dense_accum
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    assert ttr.state.params["decoder"]["relations"] is tmodel.decoder.relations

    for _ in range(2):
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        js = _np_state(jtr.state)
        ts = ttr.state
        _close(ts.table.values, js.table.values)
        _close(ts.table.state, js.table.state)
        for name in ("relations", "inverse_relations"):
            _close(ts.params["decoder"][name], js.params["decoder"][name])
            for slot in ("exp_avg", "exp_avg_sq"):
                _close(ts.opt_state.slots[slot]["decoder"][name],
                       js.opt_state.slots[slot]["decoder"][name])
        assert ts.opt_state.step == int(js.opt_state.step)
        assert ts.epoch == int(js.epoch)


def test_train_state_from_jax_round_trip():
    jmodel = JModel("LINK_PREDICTION",
                    JEncoderConfig(((JLayerConfig("EMBEDDING", output_dim=D, bias=True),),)),
                    JEdgeDecoder("COMPLEX", R, D))
    jtr = jtrainer_mod.LinkPredictionTrainer(jmodel, N, R, _edges(True),
                                             JNegConfig(C, NEG), batch_size=B)
    js = _np_state(jtr.state)
    ts = train_state_from_jax(js)
    _close(ts.table.values, js.table.values)
    _close(ts.params["encoder"][0][0]["bias"], js.params["encoder"][0][0]["bias"])
    assert all(t.requires_grad for t in tree_leaves(ts.params))
    assert len(tree_leaves(ts.opt_state.slots)) == len(jax.tree.leaves(js.opt_state.slots))
    assert ts.opt_state.step == 0 and ts.epoch == 0


def test_trainer_rejects_later_slices(monkeypatch):
    model = TModel("LINK_PREDICTION",
                   TEncoderConfig(((TLayerConfig("EMBEDDING", output_dim=D),),)),
                   TEdgeDecoder("DISTMULT", R, D))
    edges, cfg = _edges(True), TNegConfig(C, NEG)
    # meshes are ported (tests/test_torch_mesh.py), the cases JAX trains only
    # through GSPMD among them: a batch the data axis does not divide,
    # relation corruption, a FEATURE-only encoder; each builds the explicit step
    def mesh(data):
        return types.SimpleNamespace(shape={"data": data, "node": 1}, axis_index=lambda a: 0,
                                     device=torch.device("cpu"), broadcast=lambda t, **_: t)

    rel = dataclasses.replace(model, decoder=TEdgeDecoder("DISTMULT", R, D,
                                                          decoder_method="CORRUPT_REL"))
    feature_only = dataclasses.replace(model, encoder=TEncoderConfig(
        ((TLayerConfig("FEATURE", output_dim=D),),)))
    for m, data in ((model, 3), (rel, 1), (feature_only, 1)):
        tr = TTrainer(m, N, R, edges, cfg, batch_size=B, device="cpu", mesh=mesh(data),
                      features=np.zeros((N, D), np.float32))
        assert tr.sharding_mode == "explicit" and tr._mesh_update is not None
        assert (tr.state.table is None) == (m is feature_only)
    # GNN encoders are ported (tests/test_torch_lp_gnn.py); they sample a graph
    with pytest.raises(ValueError, match="DeviceGraph"):
        TTrainer(model, N, R, edges, cfg, batch_size=B, device="cpu", nbr_configs=(object(),))
    # host-streamed edges are ported (tests/test_torch_edges_backend.py)
    assert TTrainer(model, N, R, edges, cfg, batch_size=B, device="cpu",
                    edges_backend="HOST_MEMORY").edges is None
    with pytest.raises(ValueError, match="unknown edges backend"):
        TTrainer(model, N, R, edges, cfg, batch_size=B, device="cpu", edges_backend="TAPE")
    # train filter keys are ported: one epoch with them gives the JAX trainer's loss
    from marius_tpu.ops.edge_keys import build_edge_key_set as j_keys
    from marius_tpu_torch.ops.edge_keys import build_edge_key_set as t_keys

    monkeypatch.setattr(jtrainer_mod, "sample_negatives", fake_negatives_jax)
    jmodel = JModel("LINK_PREDICTION",
                    JEncoderConfig(((JLayerConfig("EMBEDDING", output_dim=D),),)),
                    JEdgeDecoder("DISTMULT", R, D))
    jtr = jtrainer_mod.LinkPredictionTrainer(
        jmodel, N, R, edges, JNegConfig(C, NEG, DEG_FRACTION, filtered=True), batch_size=B,
        train_filter_keys=(j_keys(edges, True), j_keys(edges, False)))
    ttr = TTrainer(model, N, R, edges, TNegConfig(C, NEG, DEG_FRACTION, filtered=True),
                   batch_size=B, device="cpu",
                   train_filter_keys=(t_keys(edges, True), t_keys(edges, False)))
    tcfg = ttr.neg_config
    monkeypatch.setattr(ttr, "_sample_negatives",
                        lambda edges_b, inverse: fake_negatives_torch(tcfg, edges_b, N, inverse))
    size = jtr.num_batches * B
    monkeypatch.setattr(ttr, "_epoch_permutation", lambda e: torch.from_numpy(np.array(
        jax.random.permutation(jax.random.fold_in(jax.random.key(12345), e), size))).long())
    copy_train_state_(ttr.state, train_state_from_jax(_np_state(jtr.state)))
    np.testing.assert_allclose(ttr.train_epoch()["loss"], jtr.train_epoch()["loss"], rtol=RTOL)
    rel_model = dataclasses.replace(
        model, decoder=TEdgeDecoder("DISTMULT", R, D, decoder_method="CORRUPT_REL"))
    # CORRUPT_REL is ported (tests/test_torch_corrupt_rel.py): only endpoints are gathered
    assert TTrainer(rel_model, N, R, edges, cfg, batch_size=B, device="cpu").unique_cap == 2 * B
    with pytest.raises(ValueError, match="typed"):
        TTrainer(rel_model, N, R, edges[:, [0, 2]], cfg, batch_size=B, device="cpu")
