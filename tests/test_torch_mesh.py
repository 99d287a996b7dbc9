"""The port's mesh path against the JAX package's, on the CPU over gloo.

Four ranks of one gloo process group (``tests/torch_mesh_worker.py``,
spawned once for the module) run the port's side of every case; this
process runs the JAX package on the 8 virtual CPU devices of
``tests/conftest.py`` and holds the two together on the same numpy inputs:

- ``parallel/collectives.py`` on 2 and 4 node ranks against JAX's under
  ``shard_map`` (``tests/test_collectives.py``): the gathers to rtol 1e-5 /
  atol 1e-6, the owner-local Adagrad bit for bit (gradients on a 1/64 grid,
  so every sum is exact in any order);
- the explicit LP trainer at data 2 x node 2 against JAX's explicit trainer
  at the same mesh (``tests/test_sharding.py:64-120``), with the negatives
  and permutations injected through the seams and JAX's initial state: SUM
  with the local DEG filter, MEAN with train filter keys and a partly masked
  last batch, a GraphSAGE encoder under ALL sampling (deterministic,
  ``test_sharding.py:195``), and EMBEDDING + FEATURE with MEAN through the
  deep-encoder step without hops (``test_sharding.py:287``); and the cases
  JAX leaves to GSPMD (``sharding_mode="auto"``), which the port runs on its
  explicit step: CORRUPT_REL at 2 x 2 (JAX's relation negatives replayed), a
  FEATURE-only encoder with a GraphSAGE layer under ALL at 2 x 2 (every
  rank's parameters equal: the node axis holds replicas), and a batch of 30
  in 3 chunks at ``data: 4`` (parts of 10, 10, 10 and 0 edges, MEAN). Two
  batches per epoch: losses and every leaf agree to rtol 1e-4 / atol 1e-5
  after the first epoch, the losses to rtol 5e-3 after the second. Each mesh run also
  matches the port's single-device run (rtol 1e-4 / atol 1e-5 throughout),
  as do three more: a table the node axis does not divide (63 rows and a
  padding row), a bf16 table (ROADMAP C10: the loss to rtol 2^-4, each leaf
  within 2^-3 of its norm) and host-streamed edges (HOST_MEMORY);
- ``marius_train`` on ``fb15k_237.yaml``'s model with ``training.mesh:
  {data: 2, node: 2}`` over the four ranks, with interval checkpoints and
  ``save_best`` (rank 0 writes, every rank restores): the single-process
  run's test metrics, checkpoints in the single-device layout that
  ``marius_eval`` reloads in one process, 2 collectives per batch;
- ``python -c ... cli.main(["train", ...])`` in two processes under
  ``MARIUS_COORDINATOR`` (``tests/test_multihost.py:34``): rank 0 prints the
  single-process run's test metrics, rank 1 prints none.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import yaml
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import jax.numpy as jnp
import marius_tpu.train.trainer as jtrainer_mod
import torch_mesh_worker as worker
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNeg
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.data.samplers.neighbor import resolve_all_caps_from_edges as j_all_caps
from marius_tpu.nn.decoders.edge import EdgeDecoder as JEdgeDecoder
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.ops.edge_keys import build_edge_key_set as j_keys
from marius_tpu.parallel import collectives as jcol
from marius_tpu.parallel.embedding_table import (
    EmbeddingTable as JTable,
    sparse_adagrad_update_dense_accum as j_dense_accum,
)
from marius_tpu.parallel.mesh import make_mesh as j_make_mesh
from marius_tpu_torch.config import load_config
from marius_tpu_torch.manager import marius_eval, marius_train
from marius_tpu_torch.tools.preprocess.generate import generate_random_dataset_lp
from tests.test_torch_corrupt_rel import RelKeyReplay
from tests.test_torch_lp_trainer import _np_state, fake_negatives_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
GATHER_RTOL, GATHER_ATOL = 1e-5, 1e-6
EPOCH_LOSS_RTOL = 5e-3
WORLD, MESH = 4, (2, 2)
N, R, D, B, C, NEG = 64, 4, 16, 32, 4, 8
METRIC_KEYS = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
JOIN_SECONDS = 240

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _edges(seed, e, n=N):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, R, e),
                     rng.integers(0, n, e)], 1).astype(np.int32)


# name -> (edges seed, edges, nodes, reduction, DEG fraction, train filter keys, encoder)
TRAINER_CASES = {
    "sum_deg": (1, 2 * B, N, "SUM", 0.25, False, "embedding"),
    "mean_filtered": (2, B + 22, N, "MEAN", 0.0, True, "embedding"),   # last batch 22 of 32
    "gnn_all": (3, 2 * B, N, "SUM", 0.25, False, "gnn"),
    "feature_mean": (5, B + 22, N, "MEAN", 0.25, False, "feature"),   # the no-hop deep step
    # the cases JAX trains through GSPMD: relation corruption, a table-less
    # encoder, and 3 chunks of a batch of 30 over 4 data indices (10, 10, 10, 0)
    "corrupt_rel": (8, 2 * B, N, "SUM", 0.0, False, "embedding"),
    "feature_only": (9, 2 * B, N, "SUM", 0.25, False, "feature_only"),
    "uneven_data": (10, 50, N, "MEAN", 0.25, False, "embedding"),   # last batch 20 of 30
    # port against port: a table the node axis does not divide, bf16, host-streamed edges
    "padded_rows": (4, 2 * B, N - 1, "SUM", 0.25, False, "embedding"),
    "bf16_table": (6, B + 22, N, "SUM", 0.25, False, "embedding"),
    "host_edges": (7, 3 * B, N, "SUM", 0.25, False, "embedding"),
}
JAX_CASES = ("sum_deg", "mean_filtered", "gnn_all", "feature_mean", "corrupt_rel",
             "feature_only", "uneven_data")
GSPMD_CASES = ("corrupt_rel", "feature_only", "uneven_data")
PORT_OPTIONS = {"bf16_table": {"dtype": "bfloat16"}, "host_edges": {"edges_backend": "HOST_MEMORY"},
                # Adam at 0.01 with random relations: tests/test_torch_corrupt_rel.py says why
                "corrupt_rel": {"decoder_method": "CORRUPT_REL", "dense_opt": ("ADAM", 0.01)},
                "uneven_data": {"batch_size": 30, "chunks": 3, "mesh": (4, 1)}}
# bf16 sums in another order (ROADMAP C10): the loss to rtol 2^-4, each leaf
# within 2^-3 of its norm (an Adagrad first step lr * g / |g| turns a near-zero
# sum's sign into +-lr, as on the card against the CPU)
BF16_LOSS_RTOL, BF16_NORMWISE = 2 ** -4, 2 ** -3
F = 6


def _trainer_case(name):
    seed, e, n, reduction, deg, filtered, encoder = TRAINER_CASES[name]
    opts = PORT_OPTIONS.get(name, {})
    b = opts.get("batch_size", B)
    edges = _edges(seed, e, n)
    features = (np.random.default_rng(seed).standard_normal((n, F)).astype(np.float32)
                if encoder in ("feature", "feature_only") else None)
    nb = -(-e // b)
    perms = [np.asarray(jax.random.permutation(jax.random.fold_in(jax.random.key(12345), ep),
                                               nb * b)) for ep in range(2)]
    return {"kind": "trainer", "edges": edges, "num_nodes": n, "num_rels": R, "dim": D,
            "batch_size": B, "chunks": C, "negatives": NEG, "degree_fraction": deg,
            "filtered": filtered, "reduction": reduction,
            "gnn": encoder in ("gnn", "feature_only"), "feature_only": encoder == "feature_only",
            "features": features, "epochs": 2, "perms": perms, "mesh": MESH, **opts}


def _jax_trainer(case):
    """JAX's trainer at the same mesh, from its own initial state: the
    explicit step, or for the GSPMD cases whatever ``auto`` chooses."""
    stages = ((JLayerConfig("EMBEDDING", output_dim=D),),)
    kw, model_kw = {}, {}
    edges = case["edges"]
    d = D
    if case["features"] is not None:
        stages = ((JLayerConfig("EMBEDDING", output_dim=D - F),
                   JLayerConfig("FEATURE", output_dim=F)),)
        if case["feature_only"]:
            d = F
            stages = ((JLayerConfig("FEATURE", output_dim=F),),)
        kw["features"] = case["features"]
    if case["gnn"]:
        stages += ((JLayerConfig("GNN", input_dim=d, output_dim=d, gnn_type="GRAPH_SAGE",
                                 aggregator="MEAN", bias=True),),)
        kw.update(graph=j_graph(edges, N, R), nbr_configs=j_all_caps((JNbr("ALL"),), edges, N))
        model_kw = dict(dense_optimizer=JOpt("ADAGRAD", learning_rate=0.1), sparse_lr=0.02)
    if case.get("dense_opt"):
        model_kw["dense_optimizer"] = JOpt(*case["dense_opt"])
    if case["filtered"]:
        kw["train_filter_keys"] = (j_keys(edges, corrupt_dst=True),
                                   j_keys(edges, corrupt_dst=False))
    decoder = JEdgeDecoder("DISTMULT", R, d,
                           decoder_method=case.get("decoder_method", "CORRUPT_NODE"))
    model = JModel("LINK_PREDICTION", JEncoderConfig(stages), decoder,
                   loss_reduction=case["reduction"], **model_kw)
    data, node = case["mesh"]
    mesh = j_make_mesh(num_data=data, num_node=node, devices=jax.devices()[:data * node])
    neg = JNeg(case["chunks"], NEG, case["degree_fraction"], filtered=case["filtered"])
    jtr = jtrainer_mod.LinkPredictionTrainer(
        model, N, R, edges, neg, batch_size=case["batch_size"], seed=0, mesh=mesh,
        sharding_mode="auto" if case.get("gspmd") else "explicit", **kw)
    if case.get("decoder_method") == "CORRUPT_REL":
        # random relations: DistMult's ones score every relation negative as
        # its positive (tests/test_torch_corrupt_rel.py), and the relation
        # negatives of the four batches replayed from JAX's key schedule
        rng = np.random.default_rng(11)
        dec = {k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
               for k, v in jtr.state.params["decoder"].items()}
        jtr.state = dataclasses.replace(jtr.state, params={**jtr.state.params, "decoder": dec})
        replay = RelKeyReplay(jax.random.wrap_key_data(
            np.array(jax.random.key_data(jtr.state.key))), case["chunks"], NEG, R, False)
        case["rel_negs"] = [replay.negatives().numpy() for _ in range(4)]
    return jtr


def _plain_state(js):
    """JAX's numpy state as plain dicts: no JAX type is pickled to the ranks."""
    table = None if js.table is None else {"values": js.table.values, "state": js.table.state}
    return {"table": table,
            "params": js.params, "epoch": np.asarray(js.epoch),
            "opt_state": {"step": np.asarray(js.opt_state.step), "slots": js.opt_state.slots}}


def _collectives_case(node, seed):
    rng = np.random.default_rng(seed)
    grid = lambda a: (np.round(a * 64) / 64).astype(np.float32)  # noqa: E731
    return {"kind": "collectives", "node": node,
            "table": rng.standard_normal((64, 16)).astype(np.float32),
            "ids": rng.integers(0, 64, 40).astype(np.int64),
            "w": rng.standard_normal((40, 16)).astype(np.float32),
            "scatter_ids": rng.integers(0, 64, 30).astype(np.int64),
            "scatter_values": rng.standard_normal((30, 16)).astype(np.float32),
            "values": rng.standard_normal((64, 8)).astype(np.float32),
            "state": np.abs(grid(rng.standard_normal((64, 8)))),
            "adagrad_ids": rng.integers(0, 64, 50).astype(np.int64),
            "grads": grid(rng.standard_normal((50, 8))),
            "step": _step_case(rng)}


def _j_step_model():
    return JModel("LINK_PREDICTION", JEncoderConfig(((JLayerConfig("EMBEDDING", output_dim=D),),)),
                  JEdgeDecoder("DISTMULT", R, D))


def _step_case(rng, b=16, c=2, nneg=4):
    """make_sharded_lp_step's inputs (tests/test_collectives.py:112-165):
    JAX's initial parameters, a 64 x 16 table, one batch."""
    from marius_tpu.nn.model import init_model_params as j_init_params
    from marius_tpu.nn.optimizers import init_optimizer as j_init_opt

    model = _j_step_model()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.key(0), model))
    opt = j_init_opt(model.dense_optimizer, params)
    return {"dim": D, "num_rels": R,
            "state": {"table": {"values": (rng.standard_normal((64, D)) * 0.1).astype(np.float32),
                                "state": np.zeros((64, D), np.float32)},
                      "params": params, "epoch": np.zeros((), np.int32),
                      "opt_state": {"step": np.asarray(opt.step),
                                    "slots": jax.tree.map(np.asarray, opt.slots)}},
            "edges": np.stack([rng.integers(0, 64, b), rng.integers(0, R, b),
                               rng.integers(0, 64, b)], 1).astype(np.int64),
            "dst_negs": rng.integers(0, 64, (c, nneg)).astype(np.int64),
            "src_negs": rng.integers(0, 64, (c, nneg)).astype(np.int64),
            "mask": np.ones(b, bool)}


def _jax_collectives(case):
    """JAX's four functions under shard_map on ``node`` devices."""
    mesh = JMesh(np.asarray(jax.devices()[:case["node"]]), ("node",))
    row, rep = P("node", None), P()

    def sm(fn, ins, outs):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=ins, out_specs=outs,
                                     check_vma=False))

    ids = case["ids"].astype(np.int32)
    gather = sm(lambda t, i: jcol.sharded_gather(t, i, "node"), (row, rep), rep)
    out = {"gather": np.asarray(gather(case["table"], ids))}
    out["grad"] = np.asarray(jax.grad(lambda t: (gather(t, ids) * case["w"]).sum())(
        case["table"]))
    out["scatter_add"] = np.asarray(sm(lambda t, i, v: jcol.sharded_scatter_add(t, i, v, "node"),
                                       (row, rep, rep), row)(
        case["table"], case["scatter_ids"].astype(np.int32), case["scatter_values"]))
    upd = sm(lambda v, s, i, g: jcol.sharded_adagrad_update(v, s, i, g, 0.1, "node"),
             (row, row, rep, rep), (row, row))
    args = (case["values"], case["state"], case["adagrad_ids"].astype(np.int32), case["grads"])
    out["adagrad"] = tuple(np.asarray(a) for a in upd(*args))
    dense = j_dense_accum(JTable(values=args[0], state=args[1]), args[2], args[3], 0.1)
    out["dense_accum"] = (np.asarray(dense.values), np.asarray(dense.state))
    from marius_tpu.nn.optimizers import init_optimizer as j_init_opt

    st, model = case["step"], _j_step_model()
    step = jcol.make_sharded_lp_step(model, mesh, 64)
    values, state, params, _, loss = step(
        st["state"]["table"]["values"], st["state"]["table"]["state"], st["state"]["params"],
        j_init_opt(model.dense_optimizer, st["state"]["params"]),
        *(st[k].astype(np.int32) for k in ("edges", "dst_negs", "src_negs")), st["mask"])
    out["step"] = {"values": np.asarray(values), "state": np.asarray(state),
                   "loss": float(loss), "relations": np.asarray(params["decoder"]["relations"])}
    return out


def _manager_raw(ds, model_dir, mesh=None):
    """fb15k_237.yaml's model (DistMult d = 50, SUM softmax, Adam and Adagrad
    at 0.1) on a small dataset, a small batch."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "examples", "configuration", "fb15k_237.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["storage"] = {"device_type": "cpu", "dataset": {"dataset_dir": ds},
                      "model_dir": model_dir, "save_model": True}
    # every epoch an interval checkpoint, and the best valid model kept and restored
    raw["training"] = {"batch_size": 40, "num_epochs": 2,
                       "negative_sampling": {"num_chunks": 4, "negatives_per_positive": 8},
                       "checkpoint": {"interval": 1, "save_best": True}}
    if mesh is not None:
        raw["training"]["mesh"] = mesh
    raw["evaluation"] = {"batch_size": 40, "negative_sampling": {"filtered": True}}
    return raw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the four ranks on every case; meanwhile train JAX's side here."""
    tmp = tmp_path_factory.mktemp("mesh")
    ds = str(tmp / "ds")
    generate_random_dataset_lp(ds, num_nodes=60, num_edges=600, num_relations=4)
    cases = {name: _trainer_case(name) for name in TRAINER_CASES}
    jtrainers = {}
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jtrainer_mod, "sample_negatives", fake_negatives_jax)
        for name in JAX_CASES:
            cases[name]["gspmd"] = name in GSPMD_CASES
            jtrainers[name] = _jax_trainer(cases[name])
            cases[name]["jax_state"] = _plain_state(_np_state(jtrainers[name].state))
        cases["collectives_node2"] = _collectives_case(2, 5)
        cases["collectives_node4"] = _collectives_case(4, 6)
        cases["manager"] = {"kind": "manager", "raw": _manager_raw(
            ds, str(tmp / "model_mesh"), {"data": MESH[0], "node": MESH[1]})}

        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=worker.main,
                             args=(r, WORLD, str(tmp / "rendezvous"), cases, str(tmp)))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        try:
            jax_out = {}
            for name, jtr in jtrainers.items():
                jax_out[name] = []
                for _ in range(2):
                    loss = jtr.train_epoch()["loss"]
                    js = _np_state(jtr.state)
                    table = js.table
                    jax_out[name].append({
                        "loss": loss, "values": None if table is None else table.values,
                        "state": None if table is None else table.state,
                        "relations": js.params["decoder"]["relations"],
                        "encoder": jax.tree.leaves(js.params["encoder"]),
                        "mode": jtr.sharding_mode})
            for name in ("collectives_node2", "collectives_node4"):
                jax_out[name] = _jax_collectives(cases[name])
            single = {name: worker.run_trainer(cases[name]) for name in TRAINER_CASES}
            single["manager"] = marius_train(load_config(_manager_raw(
                ds, str(tmp / "model_single"))), device="cpu")
        finally:
            for p in procs:
                p.join(JOIN_SECONDS)
            for p in procs:
                if p.is_alive():
                    p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD, "a rank failed (its output is above)"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"cases": cases, "jax": jax_out, "ranks": ranks, "single": single, "ds": ds,
            "tmp": tmp}


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("node", [2, 4])
def test_collectives_match_jax(runs, node):
    name = f"collectives_node{node}"
    case, ref = runs["cases"][name], runs["jax"][name]
    by_rows = {}
    for res in (r[name] for r in runs["ranks"]):
        # a mesh the world size cannot fill is refused (JAX's make_mesh asserts)
        assert res["refused"] == (f"mesh {WORLD + 1} x 1 needs {WORLD + 1} ranks; the "
                                  f"process group has {WORLD}")
        _close(res["gather"], ref["gather"], GATHER_RTOL, GATHER_ATOL)
        lo, hi = res["rows"]
        _close(res["inner_grad"], ref["grad"][lo:hi], GATHER_RTOL, GATHER_ATOL)
        _close(res["scatter_add"], ref["scatter_add"][lo:hi], GATHER_RTOL, GATHER_ATOL)
        # the whole table on the host, one broadcast per node index
        assert res["to_host"].device.type == "cpu" and res["to_host_collectives"] == node
        np.testing.assert_array_equal(res["to_host"].numpy(), case["table"])
        for got, want in zip(res["adagrad"], ref["adagrad"]):
            np.testing.assert_array_equal(got, want[lo:hi])
        by_rows[lo] = res["adagrad"]
    # every row of the table is some rank's, and the sharded rule is the dense one's
    assert sorted(by_rows) == list(range(0, 64, 64 // node))
    for k in range(2):
        whole = np.concatenate([by_rows[lo][k] for lo in sorted(by_rows)])
        np.testing.assert_array_equal(whole, ref["dense_accum"][k])
    assert not np.array_equal(ref["adagrad"][0], case["values"])
    # make_sharded_lp_step: one step of the whole batch on every rank
    for res in (r[name] for r in runs["ranks"]):
        lo, hi = res["rows"]
        got, want = res["step"], ref["step"]
        _close(got["loss"], want["loss"])
        _close(got["values"], want["values"][lo:hi])
        _close(got["state"], want["state"][lo:hi])
        _close(got["relations"], want["relations"])


def _close_leaves(got, want, rtol=RTOL, atol=ATOL):
    """The table (when there is one), the relations and the encoder's leaves."""
    for key in ("values", "state", "relations"):
        assert (got[key] is None) == (want[key] is None), key
        if want[key] is not None:
            _close(got[key], want[key], rtol, atol)
    assert len(got["encoder"]) == len(want["encoder"])
    for g, w in zip(got["encoder"], want["encoder"]):
        _close(g, w, rtol, atol)


def _collectives(name):
    # a table-less encoder makes no gather: only the data axis's all_reduce
    return 1.0 if name == "feature_only" else 2.0


@pytest.mark.parametrize("name", JAX_CASES)
def test_explicit_trainer_matches_jax(runs, name):
    ref = runs["jax"][name]
    # JAX's auto leaves these cases to GSPMD; the port runs its explicit step
    assert ref[0]["mode"] == ("gspmd" if name in GSPMD_CASES else "explicit")
    for rank in runs["ranks"]:
        got = rank[name]
        # epoch 1 (two batches): losses and every leaf
        _close(got[0]["loss"], ref[0]["loss"])
        _close_leaves(got[0], ref[0])
        # the loss over both epochs
        _close([e["loss"] for e in got], [e["loss"] for e in ref], rtol=EPOCH_LOSS_RTOL)
        assert [e["collectives_per_batch"] for e in got] == [_collectives(name)] * 2
    if name == "feature_only":
        # the ranks of a node row are replicas: every rank's parameters equal
        for rank in runs["ranks"][1:]:
            for got, want in zip(rank[name], runs["ranks"][0][name]):
                for g, w in zip(got["encoder"] + [got["relations"]],
                                want["encoder"] + [want["relations"]]):
                    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(TRAINER_CASES))
def test_mesh_trainer_matches_single_device(runs, name):
    single = runs["single"][name]
    bf16 = name == "bf16_table"
    for rank in runs["ranks"]:
        for got, want in zip(rank[name], single):
            _close(got["loss"], want["loss"], *((BF16_LOSS_RTOL, 0.0) if bf16 else (RTOL, ATOL)))
            if bf16:
                for key in ("values", "state", "relations"):
                    assert (np.linalg.norm(got[key] - want[key])
                            <= BF16_NORMWISE * np.linalg.norm(want[key])), key
            else:
                _close_leaves(got, want)
        # float32 needs one all_reduce over data; bf16 two (bf16 G and grads, the f32 loss)
        want = 3.0 if name == "bf16_table" else _collectives(name)
        assert [e["collectives_per_batch"] for e in rank[name]] == [want, want]
    if name == "padded_rows":
        # the mesh table has 64 rows; its single-device layout the first 63
        assert runs["ranks"][0][name][-1]["values"].shape == (N - 1, D)


def test_data_parts_split_at_chunk_boundaries():
    """Unequal parts: whole chunks, the first C mod D indices one more; the
    parts tile the batch, and an index may get none."""
    from marius_tpu_torch.parallel.collectives import data_part, largest_part

    class Data:
        def __init__(self, n, i):
            self.shape, self.i = {"data": n}, i

        def axis_index(self, axis):
            return self.i

    for b, c, n in ((30, 3, 4), (1000, 10, 3), (32, 4, 2), (12, 12, 5)):
        parts = [data_part(b, c, Data(n, i), "data") for i in range(n)]
        assert [p[1].start for p in parts[1:]] == [p[1].stop for p in parts[:-1]]
        assert parts[0][1].start == 0 and parts[-1][1].stop == c
        assert all(r.stop - r.start == (k.stop - k.start) * (b // c) for r, k in parts)
        sizes = [k.stop - k.start for _, k in parts]
        assert max(sizes) - min(sizes) <= 1 and sorted(sizes, reverse=True) == sizes
        assert largest_part(b, c, n) == (max(sizes) * (b // c), max(sizes))
    assert [data_part(30, 3, Data(4, i), "data")[0] for i in range(4)] == [
        slice(0, 10), slice(10, 20), slice(20, 30), slice(30, 30)]


def test_padding_row_stays_zero():
    """The mesh table rounds up with zero rows that only see zero gradients."""
    from marius_tpu_torch.parallel.collectives import sharded_adagrad_update

    class OneRank:
        def axis_index(self, axis):
            return 0

    values, state = torch.zeros(4, 3), torch.zeros(4, 3)
    values[:3] = 1.0
    sharded_adagrad_update(values, state, torch.tensor([0, 3, 3]),
                           torch.tensor([[1.0] * 3, [0.0] * 3, [0.0] * 3]), 0.1, OneRank())
    assert torch.equal(values[3], torch.zeros(3)) and torch.equal(state[3], torch.zeros(3))
    assert not torch.equal(values[0], torch.ones(3))


def test_marius_train_on_a_mesh_matches_one_process(runs):
    single = runs["single"]["manager"]
    want = {k: single["test"][k] for k in METRIC_KEYS}
    losses = [e["loss"] for e in single["epochs"]]
    for rank in runs["ranks"]:
        got = rank["manager"]
        assert got["mesh"] == ({"data": 2, "node": 2}, "explicit", "gloo")
        assert {k: got["test"][k] for k in METRIC_KEYS} == want
        _close(got["losses"], losses)
        assert got["collectives_per_batch"] == [2.0, 2.0]
        # host-streamed evaluation's table: the same rows, assembled on the host
        assert got["host_table"].shape == (60, 50)
        assert torch.equal(got["host_table"], got["device_table"])
    # rank 0's checkpoint holds the single-device layout: one process reloads it
    raw = _manager_raw(runs["ds"], str(runs["tmp"] / "model_mesh"), {"data": 2, "node": 2})
    again = marius_eval(load_config(raw), device="cpu")
    assert {k: again["test"][k] for k in METRIC_KEYS} == want
    assert again["runtime"].trainer.mesh is None
    for ckpt in ("", "checkpoint_1", "checkpoint_2"):
        saved = np.load(runs["tmp"] / "model_mesh" / ckpt / "table__values.npy")
        assert saved.shape == (60, 50)


def test_cli_two_processes_under_coordinator(runs, tmp_path):
    """MARIUS_COORDINATOR makes the stock command join the process group:
    two processes train a node-sharded mesh; rank 0 prints the metrics."""
    raw = _manager_raw(runs["ds"], str(tmp_path / "model"), {"data": 1, "node": 2})
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["MARIUS_COORDINATOR"] = f"file://{tmp_path / 'rendezvous'}"
    env["MARIUS_NUM_PROCESSES"] = "2"
    code = ("import torch; torch.set_num_threads(1); "
            "from marius_tpu_torch.tools import cli; "
            f"cli.main(['train', {str(cfg)!r}], device='cpu')")
    procs = []
    for i in range(2):
        e = dict(env, MARIUS_PROCESS_ID=str(i))
        procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, env=e, cwd=str(tmp_path)))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_SECONDS)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    printed = [[json.loads(line) for line in out.splitlines() if line.startswith("{")]
               for out in outs]
    assert len(printed[0]) == 1 and printed[1] == []
    want = {k: runs["single"]["manager"]["test"][k] for k in METRIC_KEYS}
    assert {k: printed[0][0][k] for k in METRIC_KEYS} == want
