"""The port's node-sharded full-graph ring against the JAX package's, on the
CPU over gloo.

Four ranks of one gloo process group (``tests/torch_mesh_worker.py``,
spawned once for the module) run every case on a ``{data: 1, node: 4}``
and on a ``{data: 4, node: 1}`` mesh (the ring takes the one non-trivial
axis); this process runs JAX's ring on 4 of the 8 virtual CPU devices of
``tests/conftest.py`` and holds the two together on the same numpy inputs:

- the structures (``build_sharded_from_csr``, ``build_sharded_rel_graph``)
  equal JAX's array for array, exactly, on graphs with an isolated node,
  padding rows and ring steps without edges on some shard (no ranks);
- the SAGE/GCN ring's sum and vjp (``make_nbr_sum_sharded``), the RGCN
  ring's sum, dx and dW (``make_rel_sum_sharded``; each rank's dW is its
  part, summed over the axis here), GAT's max pass and its sum pass with the
  gradients in l, r and t against ``jax.vjp`` of JAX's ``ring_sum``, without
  dropout and with JAX's masks (``bernoulli(fold_in(key, shard * S + k))``)
  injected, and the whole sharded GAT layer with input, attention and
  self-attention dropout (global-shape masks, each rank its rows): rtol
  1e-4 / atol 1e-5;
- the ring trainers of ``tests/test_full_graph_sharded.py:105,184`` and
  ``tests/test_full_graph_rgcn.py:214`` at their sizes from JAX's initial
  state, 3 batches of one injected permutation: losses against JAX's ring
  trainer (rtol 2e-4, GAT 5e-4) and against the port's one-device trainer
  (``fg_seed_restrict=False``), every leaf after the first batch against
  JAX's (rtol 1e-4 / atol 1e-5), evaluation accuracy within 1e-6 and the
  predicted labels equal;
- ``marius_train`` then ``marius_eval`` of a GAT config with
  ``training.mesh: {data: 1, node: 4}`` and ``full_graph: ON``: rank 0's
  metrics equal one process's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mesh_worker as worker
from marius_tpu.data import full_graph_rel as jfr
from marius_tpu.data import full_graph_sharded as jfs
from marius_tpu.data.full_graph import build_full_graph_adjacency as j_adjacency
from marius_tpu.data.full_graph import host_csr_from_adjacency as j_host_csr
from marius_tpu.data.graph import build_device_graph as j_graph
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.full_graph_encoder import _sharded_gat as j_sharded_gat
from marius_tpu.nn.layers import LayerConfig as JL
from marius_tpu.nn.model import Model as JModel
from marius_tpu.parallel.mesh import NODE_AXIS as J_NODE, make_mesh as j_make_mesh
from marius_tpu.train import nc as jnc
from marius_tpu_torch.data import full_graph_rel as tfr
from marius_tpu_torch.data import full_graph_sharded as tfs
from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
from marius_tpu_torch.data.full_graph import host_csr_from_adjacency
from marius_tpu_torch.tools.preprocess.generate import generate_random_dataset_nc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
WORLD = 4
JOIN_SECONDS = 240
SLOPE, DROP = 0.2, 0.3

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _graph(n, e, r, seed, isolated=(), block=False):
    """(E, 3) [src, rel, dst] random edges; ``isolated`` nodes get none;
    ``block``: the last shard's nodes link only among themselves, so its
    rows have no edges in ring steps 1..3."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if block:
        n_loc = -(-n // WORLD)
        last = (src >= 3 * n_loc) | (dst >= 3 * n_loc)
        src[last] = 3 * n_loc + src[last] % (n - 3 * n_loc)
        dst[last] = 3 * n_loc + dst[last] % (n - 3 * n_loc)
    keep = ~(np.isin(src, isolated) | np.isin(dst, isolated))
    return np.stack([src, rng.integers(0, r, e), dst], 1)[keep].astype(np.int32)


GRAPHS = {"97x600": (97, 600, 2, dict(isolated=(5,))),
          "40x80": (40, 80, 2, dict(block=True)),
          "64x300r3": (64, 300, 3, dict(isolated=(0, 63)))}


def _edges(name):
    n, e, r, kw = GRAPHS[name]
    return _graph(n, e, r, seed=n + e, **kw), n


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sharded_full_graph_equals_jax(name):
    edges, n = _edges(name)
    ours = tfs.build_sharded_from_csr(
        *host_csr_from_adjacency(build_full_graph_adjacency(edges, n)), n, WORLD)
    ref = jfs.build_sharded_from_csr(*j_host_csr(j_adjacency(edges, n)), n, WORLD)
    assert (ours.num_nodes, ours.num_shards, ours.n_loc) == (ref.num_nodes, ref.num_shards,
                                                             ref.n_loc)
    assert len(ours.flat_nbr) == len(ref.flat_nbr) == WORLD
    for a, b in zip(ours.flat_nbr + ours.flat_seg, ref.flat_nbr + ref.flat_seg):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the same blocks from the edge list
    direct = tfs.build_sharded_full_graph(edges, n, WORLD)
    for a, b in zip(direct.flat_nbr, ours.flat_nbr):
        assert a.shape == b.shape
    segs = np.stack([s.numpy() for s in ours.flat_seg], 1)      # (S, steps, cap)
    if name == "40x80":
        # the last shard's rows have no edges in steps 1..3
        assert (segs[WORLD - 1, 1:] == ours.n_loc).all()
    if n % WORLD:
        assert ours.padded_nodes > n


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sharded_rel_graph_equals_jax(name):
    edges, n = _edges(name)
    ours = tfr.build_sharded_rel_graph(edges, n, WORLD)
    ref = jfr.build_sharded_rel_graph(edges, n, WORLD)
    assert (ours.num_nodes, ours.num_shards, ours.n_loc) == (ref.num_nodes, ref.num_shards,
                                                             ref.n_loc)
    ol, tree_o = jax.tree_util.tree_flatten(
        jax.tree.map(lambda t: t.numpy(), (dataclasses.asdict(ours.fwd),
                                           dataclasses.asdict(ours.bwd))))
    rl, tree_r = jax.tree_util.tree_flatten((dataclasses.asdict(ref.fwd),
                                             dataclasses.asdict(ref.bwd)))
    assert tree_o == tree_r and len(ol) == len(rl)
    for a, b in zip(ol, rl):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


# -- the ring ops ---------------------------------------------------------------


def _padded(rng, n, n_pad, d, scale=1.0):
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.standard_normal((n, d)) * scale
    return x


def _ops_case(jmesh):
    """The ops' inputs for the ranks and JAX's results on them."""
    edges, n = _edges("97x600")
    rel_edges, rel_n = _edges("64x300r3")
    rng = np.random.default_rng(1)
    sg = jfs.build_sharded_full_graph(edges, n, WORLD)
    n_pad = sg.padded_nodes
    h, hd, d = 3, 4, 16
    case = {"kind": "ring_ops", "edges": edges, "n": n, "rel_edges": rel_edges,
            "rel_n": rel_n, "slope": SLOPE, "drop": DROP,
            "x": _padded(rng, n, n_pad, d), "u": _padded(rng, n, n_pad, d)}
    srg = jfr.build_sharded_rel_graph(rel_edges, rel_n, WORLD)
    rel_pad = srg.num_shards * srg.n_loc
    case.update(rel_x=_padded(rng, rel_n, rel_pad, 8),
                rel_w=(rng.standard_normal((3, 8, 6)) * 0.3).astype(np.float32),
                rel_cot=_padded(rng, rel_n, rel_pad, 6))
    for k in ("l", "r"):
        case[k] = _padded(rng, n, n_pad, h)
    case["t"] = _padded(rng, n, n_pad, h * hd)
    case["g_denom"], case["g_numer"] = _padded(rng, n, n_pad, h), _padded(rng, n, n_pad, h * hd)

    def sh(a):
        return jfs.shard_rows(a, sg, jmesh, J_NODE)

    ring_max, ring_sum = jfs.make_gat_ring(sg, jmesh, J_NODE)
    l_vec, r_vec, t = sh(case["l"]), sh(case["r"]), sh(case["t"])
    m_nbr = jax.jit(lambda a, b: ring_max(a, b, SLOPE))(l_vec, r_vec)
    m = jnp.maximum(m_nbr, jax.nn.leaky_relu(l_vec + r_vec, SLOPE))
    case["m"] = np.asarray(m)
    key = jax.random.key(7)
    case["masks"] = {(shard * WORLD + k,): np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, shard * WORLD + k), 1.0 - DROP,
        (sg.flat_nbr[k].shape[1], h))) for shard in range(WORLD) for k in range(WORLD)}
    return case, lambda: _ops_results(case, jmesh, sg, srg, m_nbr, m, key)


def _ops_results(case, jmesh, sg, srg, m_nbr, m, key):
    """JAX's ops on the case's inputs, each forward and vjp under one jit."""
    def sh(a):
        return jfs.shard_rows(a, sg, jmesh, J_NODE)

    def fwd_vjp(f, args, cot):
        def both(args, cot):
            out, vjp = jax.vjp(f, *args)
            return out, vjp(cot)
        out, grads = jax.jit(both)(args, cot)
        return (tuple(out) if isinstance(out, (tuple, list)) else (out,)) + tuple(grads)

    ref = {"gat_max": (m_nbr,)}
    ref["sage"] = fwd_vjp(jfs.make_nbr_sum_sharded(sg, jmesh, J_NODE), (sh(case["x"]),),
                          sh(case["u"]))

    class _V:
        padded_nodes = srg.num_shards * srg.n_loc

    ref["rgcn"] = fwd_vjp(jfr.make_rel_sum_sharded(srg, jmesh, J_NODE),
                          (jfs.shard_rows(case["rel_x"], _V, jmesh, J_NODE),
                           jnp.asarray(case["rel_w"])),
                          jfs.shard_rows(case["rel_cot"], _V, jmesh, J_NODE))
    _, ring_sum = jfs.make_gat_ring(sg, jmesh, J_NODE)
    cot = (sh(case["g_denom"]), sh(case["g_numer"]))
    for name, drop_key in (("gat_sum", None), ("gat_sum_drop", key)):
        ref[name] = fwd_vjp(lambda a, b, c, k=drop_key: ring_sum(
            a, b, c, m, SLOPE, DROP if k is not None else 0.0, k),
            (sh(case["l"]), sh(case["r"]), sh(case["t"])), cot)
    return jax.tree.map(np.asarray, ref)


def _gat_layer_case(jmesh):
    """The sharded GAT layer under dropout: JAX's ``_sharded_gat`` with a key,
    and every mask it draws, by the port's fold path."""
    edges, n = _edges("97x600")
    rng = np.random.default_rng(2)
    sg = jfs.build_sharded_full_graph(edges, n, WORLD)
    n_pad, d_in, h, hd = sg.padded_nodes, 8, 2, 3
    layer = dict(layer_type="GNN", gnn_type="GAT", input_dim=d_in, output_dim=h * hd,
                 num_heads=h, average_heads=False, bias=True, activation="RELU",
                 input_dropout=0.2, attention_dropout=DROP)
    p = {"w": (rng.standard_normal((d_in, h * hd)) * 0.4).astype(np.float32),
         "a_l": (rng.standard_normal((h, hd)) * 0.4).astype(np.float32),
         "a_r": (rng.standard_normal((h, hd)) * 0.4).astype(np.float32),
         "bias": (rng.standard_normal(h * hd) * 0.1).astype(np.float32)}
    x = _padded(rng, n, n_pad, d_in)
    cot = _padded(rng, n, n_pad, h * hd)
    key = jax.random.key(11)

    def results():
        ring_max, ring_sum = jfs.make_gat_ring(sg, jmesh, J_NODE)
        ops = {"gat_ring_max": ring_max, "gat_ring_sum": ring_sum}

        def f(xx, pp):
            return j_sharded_gat(JL(**layer), pp, xx, ops, True, key)

        def both(xx, pp, cc):
            y, vjp = jax.vjp(f, xx, pp)
            return y, vjp(cc)

        y, (gx, gp) = jax.jit(both)(jfs.shard_rows(x, sg, jmesh, J_NODE),
                                    {k: jnp.asarray(v) for k, v in p.items()},
                                    jfs.shard_rows(cot, sg, jmesh, J_NODE))
        return {"y": np.asarray(y), "gx": np.asarray(gx),
                "gp": {k: np.asarray(v) for k, v in gp.items()}}

    masks = {(0,): jax.random.bernoulli(jax.random.fold_in(key, 0), 0.8, (n_pad, d_in)),
             (2,): jax.random.bernoulli(jax.random.fold_in(key, 2), 1 - DROP, (n_pad, h))}
    k1 = jax.random.fold_in(key, 1)
    for shard in range(WORLD):
        for k in range(WORLD):
            masks[(1, shard * WORLD + k)] = jax.random.bernoulli(
                jax.random.fold_in(k1, shard * WORLD + k), 1 - DROP,
                (sg.flat_nbr[k].shape[1], h))
    case = {"kind": "ring_gat_layer", "edges": edges, "n": n, "layer": layer, "params": p,
            "x": x, "cot": cot, "masks": {k: np.asarray(v) for k, v in masks.items()}}
    return case, results


# -- the trainers --------------------------------------------------------------


def _sage_case():
    """tests/test_full_graph_sharded.py:105's case: SAGE MEAN, then GCN, with biases."""
    rng = np.random.default_rng(11)
    n, e, f, c = 140, 900, 8, 4
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    train = rng.permutation(n).astype(np.int32)[:100]
    gnn = dict(layer_type="GNN", aggregator="MEAN", bias=True)
    stages = [[dict(layer_type="FEATURE", output_dim=f)],
              [dict(gnn, input_dim=f, output_dim=12, gnn_type="GRAPH_SAGE")],
              [dict(gnn, input_dim=12, output_dim=c, gnn_type="GCN")]]
    return dict(edges=edges, num_nodes=n, num_rels=1, features=feats, labels=labels,
                train=train, stages=stages, batch_size=25, tol=2e-4)


def _gat_case():
    """tests/test_full_graph_sharded.py:184's case: two GAT stages."""
    rng = np.random.default_rng(13)
    n, e, f, c = 120, 700, 8, 4
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    train = rng.permutation(n).astype(np.int32)[:80]
    stages = [[dict(layer_type="FEATURE", output_dim=f)],
              [dict(layer_type="GNN", gnn_type="GAT", input_dim=f, output_dim=12, num_heads=3,
                    average_heads=False, bias=True, activation="RELU")],
              [dict(layer_type="GNN", gnn_type="GAT", input_dim=12, output_dim=c, num_heads=2,
                    average_heads=True)]]
    return dict(edges=edges, num_nodes=n, num_rels=1, features=feats, labels=labels,
                train=train, stages=stages, batch_size=20, tol=5e-4)


def _rgcn_case():
    """tests/test_full_graph_rgcn.py:214's case: two RGCN stages over 5 relations."""
    rng = np.random.default_rng(17)
    n, e, f, c, r = 120, 700, 8, 4, 5
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, r, e),
                      rng.integers(0, n, e)], 1).astype(np.int32)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    train = rng.permutation(n).astype(np.int32)[:80]
    stages = [[dict(layer_type="FEATURE", output_dim=f)],
              [dict(layer_type="GNN", gnn_type="RGCN", input_dim=f, output_dim=12, bias=True,
                    activation="RELU", num_relations=r)],
              [dict(layer_type="GNN", gnn_type="RGCN", input_dim=12, output_dim=c,
                    num_relations=r)]]
    return dict(edges=edges, num_nodes=n, num_rels=r, features=feats, labels=labels,
                train=train, stages=stages, batch_size=20, tol=5e-4)


TRAINER_CASES = {"sage": _sage_case, "gat": _gat_case, "rgcn": _rgcn_case}


def _np_state(js):
    js = jax.tree.map(np.asarray, dataclasses.replace(js, key=None))
    return {"table": None, "params": js.params, "epoch": np.asarray(js.epoch),
            "opt_state": {"step": np.asarray(js.opt_state.step), "slots": js.opt_state.slots}}


def _trainer_case(name, jmesh):
    """The case for the ranks, and JAX's ring trainer over 3 batches of the
    epoch-0 permutation: losses, leaves after the first batch, accuracy and
    labels after the third."""
    case = TRAINER_CASES[name]()
    case.update(kind="ring_trainer", reduction="SUM", batches=3,
                eval_nodes=np.arange(40, dtype=np.int32))
    n, r, edges = case["num_nodes"], case["num_rels"], case["edges"]
    stages = tuple(tuple(JL(**spec) for spec in stage) for stage in case["stages"])
    model = JModel("NODE_CLASSIFICATION", JEncoderConfig(stages), None,
                   loss_type="CROSS_ENTROPY", loss_reduction="SUM")
    jtr = jnc.NodeClassificationTrainer(
        model, j_graph(edges, n, num_relations=r), case["features"], case["labels"],
        case["train"], [], batch_size=case["batch_size"], seed=0,
        full_graph=j_adjacency(edges, n, with_relations=r > 1), mesh=jmesh,
        fg_linear_collapse=False)
    assert jtr._fg_sharded
    case["jax_state"] = _np_state(jtr.state)
    nb, b = jtr.num_batches, case["batch_size"]
    case["perm"] = perm = np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.key(54321), 0), nb * b))
    padded = np.zeros(nb * b, np.int32)
    padded[:len(case["train"])] = case["train"]
    shuffled = padded[perm].reshape(nb, b)
    masks = (perm < len(case["train"])).reshape(nb, b)

    def results():
        step = jax.jit(jtr._batch_step)
        state, losses, leaves = jtr.state, [], None
        for i in range(case["batches"]):
            state, (loss, _) = step(state, jnp.asarray(shuffled[i]), jnp.asarray(masks[i]))
            losses.append(float(loss))
            if i == 0:
                leaves = [np.asarray(v) for stage in state.params["encoder"] for layer in stage
                          for _, v in sorted(layer.items())]
        ev = jnc.NodeClassificationEvaluator(jtr, case["eval_nodes"])
        return {"losses": losses, "leaves": leaves, "accuracy": ev.evaluate(state)["accuracy"],
                "labels": np.asarray(ev.predict_labels(state))}

    return case, results


def _manager_raw(ds, model_dir):
    """A GAT encoder over every node, on the {data: 1, node: 4} mesh."""
    return {
        "model": {
            "learning_task": "NODE_CLASSIFICATION",
            "encoder": {
                "layers": [
                    [{"type": "FEATURE", "output_dim": 8}],
                    [{"type": "GNN", "input_dim": 8, "output_dim": 8, "activation": "RELU",
                      "options": {"type": "GAT", "num_heads": 2, "average_heads": False}}],
                    [{"type": "GNN", "input_dim": 8, "output_dim": 4,
                      "options": {"type": "GAT", "num_heads": 2, "average_heads": True}}],
                ],
                "train_neighbor_sampling": [{"type": "ALL"}, {"type": "ALL"}],
                "full_graph": "ON",
            },
            "loss": {"type": "CROSS_ENTROPY", "options": {"reduction": "SUM"}},
            "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": 0.01}},
        },
        "storage": {"device_type": "cpu", "dataset": {"dataset_dir": ds},
                    "model_dir": model_dir, "save_model": True},
        "training": {"batch_size": 20, "num_epochs": 2, "mesh": {"data": 1, "node": 4}},
        "evaluation": {"batch_size": 20},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the four ranks on every case; meanwhile run JAX's side here."""
    tmp = tmp_path_factory.mktemp("mesh_ring")
    ds = str(tmp / "ds")
    generate_random_dataset_nc(ds, num_nodes=80, num_edges=500, num_classes=4, feature_dim=8)
    jmesh = j_make_mesh(num_data=1, num_node=WORLD, devices=jax.devices()[:WORLD])
    # the inputs first, so the ranks start at once; JAX's results meanwhile
    cases, pending = {}, {}
    cases["ops"], pending["ops"] = _ops_case(jmesh)
    cases["gat_layer"], pending["gat_layer"] = _gat_layer_case(jmesh)
    for name in TRAINER_CASES:
        cases[name], pending[name] = _trainer_case(name, jmesh)
    cases["manager"] = {"kind": "ring_manager", "raw": _manager_raw(ds, str(tmp / "model"))}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.main, args=(r, WORLD, str(tmp / "rendezvous"), cases,
                                                   str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jax_out = {name: results() for name, results in pending.items()}
        for p in procs:
            p.join(JOIN_SECONDS)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD, "a rank failed (its output is above)"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"cases": cases, "jax": jax_out, "ranks": ranks}


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _global(runs, case, shape, key):
    """Every rank's rows of ``key``'s outputs, in axis order (rank = axis index)."""
    parts = [r[case][shape][key] for r in runs["ranks"]]
    return [np.concatenate([p[j] for p in parts]) for j in range(len(parts[0]))]


MESHES = [(1, WORLD), (WORLD, 1)]


@pytest.mark.parametrize("shape", MESHES, ids=["node4", "data4"])
def test_sage_ring_and_its_vjp_match_jax(runs, shape):
    for got, want in zip(_global(runs, "ops", shape, "sage"), runs["jax"]["ops"]["sage"]):
        _close(got, want)


@pytest.mark.parametrize("shape", MESHES, ids=["node4", "data4"])
def test_rgcn_ring_forward_dx_and_dw_match_jax(runs, shape):
    want = runs["jax"]["ops"]["rgcn"]
    out, dx = _global(runs, "ops", shape, "rgcn")[:2]
    _close(out, want[0])
    _close(dx, want[1])
    for r in runs["ranks"]:
        _close(r["ops"][shape]["rgcn"][2], want[2])


@pytest.mark.parametrize("shape", MESHES, ids=["node4", "data4"])
@pytest.mark.parametrize("part", ["gat_max", "gat_sum", "gat_sum_drop"])
def test_gat_ring_passes_and_gradients_match_jax(runs, shape, part):
    want = runs["jax"]["ops"][part]
    got = _global(runs, "ops", shape, part)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    if part == "gat_sum_drop":
        # the masks drop slots: the numerator moves, the denominator does not
        plain = runs["jax"]["ops"]["gat_sum"]
        _close(want[0], plain[0])
        assert not np.allclose(want[1], plain[1])


@pytest.mark.parametrize("shape", MESHES, ids=["node4", "data4"])
def test_sharded_gat_layer_with_dropout_matches_jax(runs, shape):
    want = runs["jax"]["gat_layer"]
    y, gx = _global(runs, "gat_layer", shape, "rows")
    _close(y, want["y"])
    _close(gx, want["gx"])
    for r in runs["ranks"]:
        for k, v in r["gat_layer"][shape]["params"].items():
            _close(v, want["gp"][k])


def test_ring_hops_and_bytes(runs):
    """Every op posts S - 1 hops per pass; GAT's sum backward S - 1 for the
    inputs and S for their gradients: the counts are the ranks' own."""
    for shape in MESHES:
        counts = {r["ops"][shape]["collectives"] for r in runs["ranks"]}
        # SAGE 3 + 3; RGCN 3 + 3 and dW's all_reduce; max 3; sum twice 3 + 7
        assert counts == {6 + 7 + 3 + 2 * (3 + 7)}
        assert len({r["ops"][shape]["ring_bytes"] for r in runs["ranks"]}) == 1


@pytest.mark.parametrize("name", sorted(TRAINER_CASES))
def test_ring_trainer_matches_jax_and_one_device(runs, name):
    case, want = runs["cases"][name], runs["jax"][name]
    tol = case["tol"]
    for r in runs["ranks"]:
        got = r[name]
        one = got["one"]
        np.testing.assert_allclose(one["losses"], want["losses"], rtol=tol)
        for shape in MESHES:
            ring = got[shape]
            assert ring["axis"] == ("node" if shape[1] > 1 else "data")
            np.testing.assert_allclose(ring["losses"], want["losses"], rtol=tol)
            np.testing.assert_allclose(ring["losses"], one["losses"], rtol=tol)
            assert len(ring["leaves"]) == len(want["leaves"])
            for a, b in zip(ring["leaves"], want["leaves"]):
                _close(a, b)
            assert abs(ring["accuracy"] - want["accuracy"]) < 1e-6
            assert abs(ring["accuracy"] - one["accuracy"]) < 1e-6
            np.testing.assert_array_equal(ring["labels"], want["labels"])
            # the ring's ops; one all_reduce of the dense gradients per batch
            assert ("gat_ring" in ring["ops"]) == (name == "gat")
            assert ("rel_sum" in ring["ops"]) == (name == "rgcn")
            assert ring["collectives_per_batch"] > 1 and ring["ring_bytes_per_batch"] > 0
        np.testing.assert_allclose(got[MESHES[0]]["losses"], got[MESHES[1]]["losses"],
                                   rtol=1e-6)


def test_marius_train_of_a_gat_ring_on_a_mesh(runs):
    ranks = [r["manager"] for r in runs["ranks"]]
    for got in ranks:
        assert got["mesh"] == {"data": 1, "node": 4}
        assert got["ring_axis"] == "node" and got["gat"]
        assert got["test"] == ranks[0]["test"] and got["losses"] == ranks[0]["losses"]
        # marius_eval of rank 0's checkpoint on one device gives the same metrics
        assert got["eval"]["accuracy"] == pytest.approx(got["test"]["accuracy"], abs=1e-6)
    one = ranks[0]["one"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=5e-4)
    assert ranks[0]["test"]["accuracy"] == pytest.approx(one["test"]["accuracy"], abs=1e-6)
    assert ranks[0]["test"]["num_evaluated"] == one["test"]["num_evaluated"]
