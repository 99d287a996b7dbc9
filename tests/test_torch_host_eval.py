"""Host-tiled evaluation (``evaluate_from_host_table``) and host-tiled
all-node encoding against marius_tpu's, on the CPU.

Tables and relation tables are multiples of 1/4 in [-2, 2] (as in
test_torch_lp_eval.py), so every score is exact in float32 in any order of
addition and the ranks, hence every metric, must be EQUAL to the JAX
package's; and equal to the port's own in-device ``evaluate()`` (whose rank
sums are float32, so to rtol 1e-6). Small node tiles and edge slices make
several tiles (the last partial) and several slices (the last padded); the
true-candidate lists and the per-chunk membership test both run.
"""

import numpy as np
import pytest
import torch

from marius_tpu.train import evaluator as jevaluator
from marius_tpu.train.graph_encoder import encode_all_nodes_host as j_encode_host
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.train import evaluator as tevaluator
from marius_tpu_torch.train.graph_encoder import encode_all_nodes_host as t_encode_host
from tests.test_torch_lp_eval import (  # noqa: F401  (fixture)
    ER,
    _eval_data,
    _evaluators,
    _models,
    _quantized_states,
    jax_search_clamped,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

METRICS = ("mrr", "mean_rank", "hits@1", "hits@3", "hits@10", "hits@50", "num_evaluated")
CASES = [("DISTMULT", True), ("COMPLEX", True), ("DISTMULT", False)]


@pytest.mark.parametrize("decoder_type,typed", CASES,
                         ids=[f"{d}-{'typed' if t else 'untyped'}" for d, t in CASES])
@pytest.mark.parametrize("tail", [True, False], ids=["candidates", "membership"])
def test_host_table_ranks_equal_jax(monkeypatch, jax_search_clamped, decoder_type, typed, tail):
    d = 32
    edges, test, rng = _eval_data(typed)
    jmodel, tmodel = _models(decoder_type, d, ER)
    js, ts = _quantized_states(jmodel, rng, edges, d, ER)
    jev, tev = _evaluators(jmodel, tmodel, test, edges, True)
    if not tail:
        for mod in (jevaluator, tevaluator):
            monkeypatch.setattr(mod, "TAIL_CAP_LIMIT", 0)
    host = np.asarray(js.table.values)
    jres = jev.evaluate_from_host_table(host, js.params, edge_slice=64, node_tile=128)
    tres = tev.evaluate_from_host_table(host, ts.params, edge_slice=64, node_tile=128)
    for k in METRICS:
        assert tres[k] == jres[k], k
    assert tres["num_evaluated"] == (2 if typed else 1) * len(test)
    # the port's in-device evaluation of the same state: the same ranks
    dev = tev.evaluate(ts)
    for k in METRICS:
        np.testing.assert_allclose(tres[k], dev[k], rtol=1e-6, err_msg=k)
    # the defaults: one tile and one slice
    one = tev.evaluate_from_host_table(host, ts.params)
    assert all(one[k] == tres[k] for k in METRICS)


def test_host_eval_candidate_budget_falls_back(monkeypatch):
    edges, test, rng = _eval_data(True)
    jmodel, tmodel = _models("DISTMULT", 32, ER)
    js, ts = _quantized_states(jmodel, rng, edges, 32, ER)
    _, tev = _evaluators(jmodel, tmodel, test, edges, True)
    host = np.asarray(js.table.values)
    ref = tev.evaluate_from_host_table(host, ts.params, edge_slice=64, node_tile=128)
    monkeypatch.setattr(tevaluator, "HOST_EVAL_CAND_BUDGET_BYTES", 0)
    low = tev.evaluate_from_host_table(host, ts.params, edge_slice=64, node_tile=128)
    assert all(low[k] == ref[k] for k in METRICS)
    unfiltered = tevaluator.LinkPredictionEvaluator(tmodel, 300, ER, test, filtered=False,
                                                    batch_size=50, device="cpu")
    with pytest.raises(ValueError, match="filtered"):
        unfiltered.evaluate_from_host_table(host, ts.params)


def test_encode_all_nodes_host_matches_jax():
    from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
    from marius_tpu.nn.layers import LayerConfig as JLayerConfig
    from marius_tpu.nn.model import Model as JModel
    from marius_tpu.nn.model import init_model_params
    from marius_tpu_torch.convert import train_state_from_jax

    import jax

    d, n = 8, 1003
    jmodel = JModel("LINK_PREDICTION", JEncoderConfig(
        ((JLayerConfig("EMBEDDING", output_dim=d, bias=True, activation="RELU"),),)), None)
    tmodel = TModel("LINK_PREDICTION", TEncoderConfig(
        ((TLayerConfig("EMBEDDING", output_dim=d, bias=True, activation="RELU"),),)), None)
    params = init_model_params(jax.random.key(0), jmodel)
    rng = np.random.default_rng(2)
    params["encoder"][0][0]["bias"] = rng.standard_normal(d).astype(np.float32)
    host = rng.standard_normal((n, d)).astype(np.float32)
    jout = j_encode_host(jmodel, params, host, batch_size=100)
    tparams = train_state_from_jax({"table": None, "params": jax.tree.map(np.asarray, params),
                                    "opt_state": {"step": 0, "slots": {}}, "epoch": 0}).params
    tout = t_encode_host(tmodel, tparams, host, torch.device("cpu"), batch_size=100)
    assert tout.shape == (n, d) and (tout == 0).any()
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-7)
