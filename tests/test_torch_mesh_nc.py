"""The port's data-parallel node classification against the JAX package's
mesh paths, on the CPU over gloo.

Two ranks of one gloo process group (``tests/torch_mesh_worker.py``,
spawned once for the module) form a ``{data: 2, node: 1}`` mesh; this
process runs the JAX package on 2 of the 8 virtual CPU devices of
``tests/conftest.py`` and holds the two together on the same numpy inputs,
from JAX's initial state with its permutations injected:

- sampled NC (JAX ``_sharded_batch_step``, nc.py:466-557), 2 batches of 32
  seeds, 16 per data index: ogbn_arxiv.yaml's FEATURE + GraphSAGE MEAN
  stages (SUM), and FEATURE beside EMBEDDING with a RELU and a GCN stage
  (MEAN: the weight's all_reduce). Each index samples with JAX's numbers of
  ``fold_in(k_s, index)``: this process feeds them to the port's sampler on
  the index's seeds and records them, and each rank replays its index's
  record through ``_batch_draws(data_index)``. Losses and every leaf to
  rtol 1e-4 / atol 1e-5; evaluation of the mesh-trained state equals one
  process's;
- both EMBEDDING gradient routes (``collectives.nc_table_grad``) give JAX's
  accumulator G (``tests/test_sharding.py:427-484``), overlapping rows
  across the indices included;
- the LINEAR collapse at ``data: 2`` against JAX's mesh collapse over 2
  epochs (``tests/test_sharding.py:487-544``), rtol 1e-4 / atol 1e-5;
- ``marius_train`` of ogbn_arxiv.yaml's model cut small on the mesh, sampled
  and (every hop ALL) through the collapse.

(The node-sharded ring, a full-graph encoder the collapse does not take, is
``tests/test_torch_mesh_ring.py``'s; out-of-core NC on a mesh is
``tests/test_torch_mesh_nc_buffer.py``'s.)
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import yaml
from jax.sharding import PartitionSpec as P

import torch_mesh_worker as worker
from marius_tpu.data.full_graph import build_full_graph_adjacency as j_adjacency
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JL
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.parallel.mesh import DATA_AXIS, make_mesh as j_make_mesh
from marius_tpu.train import nc as jnc
from marius_tpu_torch.data.graph import build_device_graph as t_graph
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.data.samplers.neighbor import estimate_hop_caps, sample_neighbor_batch
from marius_tpu_torch.tools.preprocess.generate import generate_random_dataset_nc
from tests.test_torch_neighbor_sampler import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
WORLD, MESH = 2, (2, 1)
B, CLASSES = 32, 5
JOIN_SECONDS = 240

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _sampled_data(seed=0, n=260, e=2000, f=8):
    """tests/test_torch_sampled_nc.py's graph: power-law in-degrees, hubs
    above the fanout; 64 train nodes (2 batches)."""
    rng = np.random.default_rng(seed)
    w = (np.arange(n) + 1.0) ** -0.9
    edges = np.stack([rng.integers(0, n, e), rng.choice(n, e, p=w / w.sum())],
                     1).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = np.argmax(feats @ rng.standard_normal((f, CLASSES)), 1).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    return edges, feats, labels, perm[:64], perm[64:124]


def _collapse_data():
    """tests/test_sharding.py:498-503's graph."""
    rng = np.random.default_rng(5)
    n, e, f = 160, 900, 8
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = ((feats[:, 0] > 0).astype(np.int32) + 2 * (feats[:, 1] > 0).astype(np.int32))
    nodes = np.arange(n, dtype=np.int32)
    return edges, feats, labels, nodes, nodes[:n // 2]


def _jax_model(case):
    f, c = case["features"].shape[1], case["classes"]
    sage = dict(gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True)
    if case["variant"] == "embedding":
        stages = [(JL("FEATURE", output_dim=f), JL("EMBEDDING", output_dim=4)),
                  (JL("GNN", input_dim=f + 4, output_dim=12, activation="RELU", **sage),),
                  (JL("GNN", input_dim=12, output_dim=c, gnn_type="GCN", bias=True),)]
    elif case["variant"] == "collapse":
        stages = [(JL("FEATURE", output_dim=f, bias=True),),
                  (JL("GNN", input_dim=f, output_dim=8, gnn_type="GRAPH_SAGE", bias=True),),
                  (JL("GNN", input_dim=8, output_dim=c, gnn_type="GRAPH_SAGE", bias=True),)]
    else:
        stages = [(JL("FEATURE", output_dim=f, bias=True),),
                  (JL("GNN", input_dim=f, output_dim=16, **sage),),
                  (JL("GNN", input_dim=16, output_dim=c, **sage),)]
    return JModel("NODE_CLASSIFICATION", JEncoderConfig(tuple(stages)), None,
                  loss_type="CROSS_ENTROPY", loss_reduction=case["reduction"],
                  dense_optimizer=JOpt("ADAM", learning_rate=0.01), sparse_lr=0.1)


def _np_state(js):
    """JAX's numpy state as plain dicts: no JAX type is pickled to the ranks."""
    js = jax.tree.map(np.asarray, dataclasses.replace(js, key=None))
    table = None if js.table is None else {"values": js.table.values, "state": js.table.state}
    return {"table": table, "params": js.params, "epoch": np.asarray(js.epoch),
            "opt_state": {"step": np.asarray(js.opt_state.step), "slots": js.opt_state.slots}}


def _case(variant, jmesh):
    """The case for the ranks and JAX's trainer on the same mesh."""
    collapse = variant == "collapse"
    edges, feats, labels, train, eval_nodes = _collapse_data() if collapse else _sampled_data()
    n = feats.shape[0]
    case = {"kind": "nc", "variant": variant, "edges": edges, "num_nodes": n,
            "features": feats, "labels": labels, "train": train, "eval_nodes": eval_nodes,
            "classes": 4 if collapse else CLASSES, "batch_size": 40 if collapse else B,
            "nbr": (("ALL", 1),) * 2 if collapse else (("UNIFORM", 6),) * 2,
            "reduction": "MEAN" if variant == "embedding" else "SUM",
            "epochs": 2 if collapse else 1, "mesh": MESH}
    jtr = jnc.NodeClassificationTrainer(
        _jax_model(case), j_graph(edges, n), feats, labels, train,
        [JNbr(*c) for c in case["nbr"]], batch_size=case["batch_size"], seed=0, mesh=jmesh,
        full_graph=j_adjacency(edges, n) if collapse else None)
    size = jtr.num_batches * case["batch_size"]
    case["perms"] = [np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.key(54321), ep), size)) for ep in range(2)]
    case["jax_state"] = _np_state(jtr.state)
    if not collapse:
        case["draws"] = _recorded_draws(case, jtr)
    return case, jtr


def _recorded_draws(case, jtr):
    """Per data index, per batch: JAX's sampler numbers for that index
    (``fold_in(k_s, index)``, k_s split off the state key per batch), as the
    port's sampler asks for them on the index's seeds."""
    n, b = case["num_nodes"], case["batch_size"]
    bl = b // MESH[0]
    graph = t_graph(case["edges"], n, device="cpu")
    nbr = [TNbr(*c) for c in case["nbr"]]
    caps = estimate_hop_caps(bl, nbr, n)
    assert tuple(caps) == tuple(jtr.hop_caps)
    nb = jtr.num_batches
    padded = np.zeros(nb * b, np.int64)
    padded[:len(case["train"])] = case["train"]
    perm = case["perms"][0]
    shuffled = padded[perm].reshape(nb, b)
    masks = (perm < len(case["train"])).reshape(nb, b)
    key = jax.random.wrap_key_data(np.array(jax.random.key_data(jtr.state.key)))
    out = [[] for _ in range(MESH[0])]
    for t in range(nb):
        key, k_s = jax.random.split(key)
        for i in range(MESH[0]):
            inner, table = jax_draws(jax.random.fold_in(k_s, i)), {}

            def draw(*args, inner=inner, table=table):
                got = inner(*args)
                table[args] = tuple(None if a is None else a.numpy().copy() for a in got)
                return got

            part = slice(i * bl, (i + 1) * bl)
            sample_neighbor_batch(draw, graph, torch.from_numpy(shuffled[t, part]),
                                  torch.from_numpy(masks[t, part]), nbr, caps)
            out[i].append(table)
    return out


def _manager_raw(ds, variant):
    """ogbn_arxiv.yaml (FEATURE + 3 GraphSAGE MEAN, Adam) cut to widths 8 /
    5 classes, fanout 4 or every hop ALL, batch 40, 2 epochs."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "examples", "configuration", "ogbn_arxiv.yaml")) as f:
        raw = yaml.safe_load(f)
    enc = raw["model"]["encoder"]
    del enc["hop_caps"]
    for hop in enc["train_neighbor_sampling"]:
        hop.update({"type": "ALL"} if variant == "collapse"
                   else {"options": {"max_neighbors": 4}})
    enc["layers"][0][0]["output_dim"] = 8
    for stage in enc["layers"][1:]:
        stage[0]["input_dim"], stage[0]["output_dim"] = 8, 8
    enc["layers"][-1][0]["output_dim"] = CLASSES
    raw["storage"] = {"device_type": "cpu", "dataset": {"dataset_dir": ds}, "save_model": False}
    raw["training"].update(batch_size=40, num_epochs=2, mesh={"data": 2, "node": 1})
    raw["evaluation"]["batch_size"] = 40
    return raw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the two ranks on every case; meanwhile train JAX's side here."""
    tmp = tmp_path_factory.mktemp("mesh_nc")
    ds = str(tmp / "ds")
    generate_random_dataset_nc(ds, num_nodes=200, num_edges=800, num_classes=CLASSES,
                               feature_dim=8)
    jmesh = j_make_mesh(num_data=MESH[0], num_node=MESH[1], devices=jax.devices()[:WORLD])
    cases, jtrainers = {}, {}
    for variant in ("arxiv", "embedding", "collapse"):
        cases[variant], jtrainers[variant] = _case(variant, jmesh)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 64, (2, 5)).astype(np.int64)
    ids[0, 0] = ids[1, 0]                          # a row both indices touch
    ids[1, 4] = 64                                 # a padding id
    cases["routes"] = {"kind": "nc_routes", "num_rows": 64, "ids": ids,
                       "grads": rng.standard_normal((2, 5, 8)).astype(np.float32)}
    for variant in ("sampled", "collapse"):
        cases[f"manager_{variant}"] = {"kind": "nc_manager", "raw": _manager_raw(ds, variant)}

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.main, args=(r, WORLD, str(tmp / "rendezvous"), cases,
                                                   str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jax_out = {}
        for variant, jtr in jtrainers.items():
            jax_out[variant] = []
            for _ in range(cases[variant]["epochs"]):
                loss = jtr.train_epoch()["loss"]
                js = _np_state(jtr.state)
                jax_out[variant].append({
                    "loss": loss, "encoder": jax.tree.leaves(js["params"]["encoder"]),
                    "table": None if js["table"] is None else
                    (js["table"]["values"], js["table"]["state"])})
        jax_out["routes"] = _jax_routes(cases["routes"], jmesh)
    finally:
        for p in procs:
            p.join(JOIN_SECONDS)
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD, "a rank failed (its output is above)"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"cases": cases, "jax": jax_out, "ranks": ranks}


def _jax_routes(case, jmesh):
    """JAX's two routes to G under shard_map (tests/test_sharding.py:442-456)."""
    import jax.numpy as jnp

    n, d = case["num_rows"], case["grads"].shape[-1]

    def gather(ids_l, g_l):
        ids_all = jax.lax.all_gather(ids_l[0], DATA_AXIS)
        g_all = jax.lax.all_gather(g_l[0], DATA_AXIS)
        return jnp.zeros((n, d), jnp.float32).at[ids_all.reshape(-1)].add(
            g_all.reshape(-1, d), mode="drop")[None]

    def psum(ids_l, g_l):
        G = jnp.zeros((n, d), jnp.float32).at[ids_l[0]].add(g_l[0], mode="drop")
        return jax.lax.psum(G, DATA_AXIS)[None]

    specs = dict(mesh=jmesh, in_specs=(P(DATA_AXIS), P(DATA_AXIS)), out_specs=P(DATA_AXIS))
    args = (case["ids"].astype(np.int32), case["grads"])
    return {"gather": np.asarray(jax.shard_map(gather, **specs)(*args))[0],
            "reduce": np.asarray(jax.shard_map(psum, **specs)(*args))[0]}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["arxiv", "embedding", "collapse"])
def test_data_parallel_nc_matches_jax(runs, variant):
    ref = runs["jax"][variant]
    # sampled: the loss's all_reduce (the overflow count and the gradients in
    # it); MEAN adds the count's, an EMBEDDING table its route's (the reduce
    # route at 260 rows); the collapse one all_reduce
    want = {"arxiv": 1.0, "embedding": 3.0, "collapse": 1.0}[variant]
    for rank in runs["ranks"]:
        got = rank[variant]
        for g, w in zip(got["epochs"], ref):
            _close(g["loss"], w["loss"])
            assert len(g["encoder"]) == len(w["encoder"])
            for a, b in zip(g["encoder"], w["encoder"]):
                _close(a, b)
            assert (g["table"] is None) == (w["table"] is None)
            if w["table"] is not None:
                _close(g["table"][0], w["table"][0])
                _close(g["table"][1], w["table"][1])
            assert g["collectives_per_batch"] == want
        # a mesh-trained model evaluates as one process's trainer with its state
        assert got["eval"] == got["eval_one"]
        assert got["eval"]["num_evaluated"] == len(runs["cases"][variant]["eval_nodes"])
    if variant != "collapse":
        # each index sized its hop caps for its 16 seeds
        assert runs["ranks"][0][variant]["hop_caps"][0] == B // 2


def test_embedding_gradient_routes_give_jax_g(runs):
    ref = runs["jax"]["routes"]
    np.testing.assert_allclose(ref["gather"], ref["reduce"], rtol=1e-6)
    for rank in runs["ranks"]:
        got = rank["routes"]
        for route in ("gather", "reduce"):
            np.testing.assert_allclose(got[route], ref[route], rtol=1e-6, atol=1e-6)
        # at 2 x 5 < 64 rows the automatic choice is JAX's: the gather route
        assert got["auto"]
    assert np.abs(ref["gather"][runs["cases"]["routes"]["ids"][1, 0]]).sum() > 0


@pytest.mark.parametrize("variant", ["sampled", "collapse"])
def test_marius_train_of_nc_on_a_mesh(runs, variant):
    name = f"manager_{variant}"
    ranks = [r[name] for r in runs["ranks"]]
    for got in ranks:
        assert got["mesh"] == {"data": 2, "node": 1}
        assert got["collapse"] == (variant == "collapse")
        assert got["test"] == ranks[0]["test"] and got["losses"] == ranks[0]["losses"]
        assert np.isfinite(got["losses"]).all() and 0.0 <= got["test"]["accuracy"] <= 1.0
