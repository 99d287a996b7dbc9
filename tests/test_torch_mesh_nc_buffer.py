"""The port's out-of-core node classification on a data-parallel mesh
against the JAX package's, on the CPU over gloo.

Two ranks of one gloo process group (``tests/torch_mesh_worker.py``,
spawned once for the module) form a ``{data: 2, node: 1}`` mesh; this
process runs JAX's ``PartitionBufferNCTrainer`` on 2 of the 8 virtual CPU
devices of ``tests/conftest.py`` (``make_mesh(num_data=2, num_node=1)``)
and holds the two together on the same numpy graph, features, labels and
train nodes, the port starting from JAX's initial state:

- JAX's key schedule is replayed eagerly (``fold_in(key(seed + 17),
  epoch)``, one ``split`` per scan step, padded steps included, then
  ``fold_in(k_s, index)`` under ``shard_map``). A single-device port trainer
  in this process walks the same states and batches and records, per data
  index, the numbers the port's sampler asks for on that index's share of
  each batch under the local hop caps; each rank replays its index's record
  through ``_batch_draws(epoch, step, data_index)``. Evaluation's numbers
  (``fold_in(key(3), count)``) are recorded alike;
- cases: SEQUENTIAL with SUM, DISPERSED with MEAN (the count's all_reduce),
  a RELU + GCN stage, and a train-node count that leaves index 1's share of
  some state's last batch all padding in both epochs (that index samples an
  empty frontier and joins the batch's collectives with zero gradients);
- over 2 epochs every state's loss, every dense leaf, Adam's slots and its
  step count agree to rtol 1e-4 / atol 1e-5 (ROADMAP C5); evaluation of the
  mesh-trained state equals JAX's fresh-layout evaluation exactly (ROADMAP
  C8) under hop caps for the evaluation's whole batch (ROADMAP C12), and is
  equal on both ranks;
- both packages refuse an EMBEDDING co-buffer on a mesh and a batch the
  data axis does not divide, with the same words;
- ``marius_train`` of a PARTITION_BUFFER NC config with ``training.mesh:
  {data: 2}`` gives equal losses and test accuracy on both ranks, rank 0
  writes the model, and ``marius_eval`` reproduces the test accuracy.
"""


import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mesh_worker as worker
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JL
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.parallel.mesh import make_mesh as j_make_mesh
from marius_tpu.train.nc_buffer import PartitionBufferNCTrainer as JTrainer
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.data.samplers.neighbor import estimate_hop_caps, sample_neighbor_batch
from marius_tpu_torch.nn.optimizers import tree_leaves, tree_map
from marius_tpu_torch.tools.preprocess.generate import generate_random_dataset_nc
from tests.test_nc_buffer import _community_graph
from tests.test_torch_nc_buffer import KeySchedule, _fresh_layout
from tests.test_torch_neighbor_sampler import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
WORLD, MESH = 2, (2, 1)
N, CLASSES, FD, B, PARTS, CAP = 120, 4, 8, 20, 6, 3
JOIN_SECONDS = 300

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

# name -> (ordering, loss reduction, GCN last stage, train nodes)
CASES = {
    "sequential-sum": ("SEQUENTIAL", "SUM", False, 90),
    "dispersed-mean": ("DISPERSED", "MEAN", False, 90),
    "relu-gcn": ("DISPERSED", "SUM", True, 90),
    # 3 SEQUENTIAL states of 28-29 train seeds: each state's second batch holds
    # 8 or 9 valid seeds, all in index 0's share of 10
    "padded-index": ("SEQUENTIAL", "MEAN", False, 86),
}


def _jax_model(case, embedding=False):
    f, c = case["features"].shape[1], case["classes"]
    sage = dict(gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True)
    last = dict(gnn_type="GCN", bias=True) if case["gcn"] else sage
    first = (JL("FEATURE", output_dim=f),) + ((JL("EMBEDDING", output_dim=4),) if embedding
                                              else ())
    stages = (first, (JL("GNN", input_dim=f, output_dim=12, activation="RELU", **sage),),
              (JL("GNN", input_dim=12, output_dim=c, **last),))
    return JModel("NODE_CLASSIFICATION", JEncoderConfig(stages), None,
                  loss_type="CROSS_ENTROPY", loss_reduction=case["reduction"],
                  dense_optimizer=JOpt("ADAM", learning_rate=0.01))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_kw(case, jmesh):
    return dict(num_nodes=case["num_nodes"], batch_size=case["batch_size"],
                num_partitions=case["parts"], buffer_capacity=case["capacity"],
                ordering=case["ordering"], seed=0, mesh=jmesh)


def _jax_trainer(case, jmesh):
    """JAX's mesh trainer, recording each state function's loss."""
    jtr = JTrainer(_jax_model(case), case["edges"], case["features"], case["labels"],
                   case["train"], [JNbr(*c) for c in case["nbr"]], **_jax_kw(case, jmesh))
    jtr.state_losses = []
    build = jtr._build_state_fn

    def recording(num_batches):
        fn = build(num_batches)

        def run(*args):
            out = fn(*args)
            jtr.state_losses.append(float(out[-1]))
            return out
        return run

    jtr._build_state_fn = recording
    return jtr


def _recording(inner, table):
    def draw(*args):
        got = inner(*args)
        table[args] = tuple(None if a is None else a.numpy().copy() for a in got)
        return got
    return draw


def _record_draws(case):
    """Per data index, JAX's sampler numbers of every training step
    (``fold_in(k_s, index)``) as the port's sampler asks for them on that
    index's share of the batch under the local caps, keyed by (epoch,
    step); the evaluation's numbers in call order; and the steps whose
    index-1 share held no valid seed. A single-device port trainer walks the
    states and batches the ranks walk."""
    rec = worker.nc_buffer_trainer(case, None)
    nbr = [TNbr(*c) for c in case["nbr"]]
    bl = case["batch_size"] // MESH[0]
    caps = estimate_hop_caps(bl, nbr, rec._ref.buffer_rows)
    keys = KeySchedule(0)
    tables, empty = [{} for _ in range(MESH[0])], []
    rec._batch_draws = lambda epoch, step, data_index=0: (epoch, step)

    def step(graph, seeds, mask, labels, token, dropout_key):
        epoch, s = token
        for i in range(MESH[0]):
            part = slice(i * bl, (i + 1) * bl)
            tables[i][token] = {}
            sample_neighbor_batch(
                _recording(jax_draws(jax.random.fold_in(keys.k_s(epoch, s), i)),
                           tables[i][token]),
                graph, seeds[part], mask[part], nbr, caps)
        if not bool(mask[bl:].any()):
            empty.append(token)
        return torch.zeros(()), torch.zeros((), dtype=torch.int64)

    rec._batch_step = step
    for _ in range(case["epochs"]):
        rec.train_epoch()
    evals = []

    def eval_draws(count):
        evals.append({})
        return _recording(jax_draws(jax.random.fold_in(jax.random.key(3), count)), evals[-1])

    rec._eval_draws = eval_draws
    rec.evaluate_nodes(case["eval_nodes"])
    return tables, evals, empty


def _case(name, jmesh):
    ordering, reduction, gcn, n_train = CASES[name]
    rng = np.random.default_rng(0)
    edges, feats, labels = _community_graph(rng, N, CLASSES, FD)
    perm = rng.permutation(N).astype(np.int32)
    case = {"kind": "nc_buffer", "edges": edges, "num_nodes": N, "features": feats,
            "labels": labels, "train": perm[:n_train], "eval_nodes": perm[n_train:],
            "classes": CLASSES, "batch_size": B, "parts": PARTS, "capacity": CAP,
            "ordering": ordering, "reduction": reduction, "gcn": gcn,
            "nbr": (("UNIFORM", 3), ("UNIFORM", 4)), "epochs": 2, "mesh": MESH}
    jtr = _jax_trainer(case, jmesh)
    case["jax_state"] = {"table": None, "params": _np(jtr.params), "epoch": 0,
                         "opt_state": {"step": np.asarray(jtr.opt_state.step),
                                       "slots": _np(jtr.opt_state.slots)}}
    case["draws"], case["eval_draws"], case["empty_index1"] = _record_draws(case)
    return case, jtr


def _manager_raw(tmp):
    """A PARTITION_BUFFER NC config (tests/test_nc_buffer.py:55's shape) on
    ``training.mesh: {data: 2}``, the model saved."""
    ds = str(tmp / "ds")
    generate_random_dataset_nc(ds, num_nodes=80, num_edges=800, num_classes=4, feature_dim=8)
    sage = {"type": "GRAPH_SAGE", "aggregator": "MEAN"}
    return {
        "model": {
            "learning_task": "NODE_CLASSIFICATION",
            "encoder": {"layers": [
                [{"type": "FEATURE", "output_dim": 8}],
                [{"type": "GNN", "input_dim": 8, "output_dim": 8, "activation": "RELU",
                  "options": sage}],
                [{"type": "GNN", "input_dim": 8, "output_dim": 4, "options": sage}]],
                "train_neighbor_sampling": [
                    {"type": "UNIFORM", "options": {"max_neighbors": 4}}] * 2},
            "loss": {"type": "CROSS_ENTROPY", "options": {"reduction": "SUM"}},
            "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": 0.01}},
        },
        "storage": {"device_type": "cpu", "dataset": {"dataset_dir": ds},
                    "features": {"type": "PARTITION_BUFFER"},
                    "embeddings": {"options": {"num_partitions": 8, "buffer_capacity": 4,
                                               "node_partition_ordering": "DISPERSED"}},
                    "save_model": True, "model_dir": str(tmp / "model")},
        "training": {"batch_size": 20, "num_epochs": 2, "mesh": {"data": 2, "node": 1}},
        "evaluation": {"batch_size": 20},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the two ranks on every case; meanwhile train JAX's side here."""
    tmp = tmp_path_factory.mktemp("mesh_nc_buffer")
    jmesh = j_make_mesh(num_data=MESH[0], num_node=MESH[1], devices=jax.devices()[:WORLD])
    cases, jtrainers = {}, {}
    for name in CASES:
        cases[name], jtrainers[name] = _case(name, jmesh)
    cases["refusals"] = dict(cases["sequential-sum"], kind="nc_buffer_refusals")
    cases["manager"] = {"kind": "nc_buffer_manager", "raw": _manager_raw(tmp)}

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.main, args=(r, WORLD, str(tmp / "rendezvous"), cases,
                                                   str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jax_out = {}
        for name, jtr in jtrainers.items():
            epochs = []
            for _ in range(cases[name]["epochs"]):
                jtr.state_losses = []
                res = jtr.train_epoch()
                epochs.append({"loss": res["loss"], "state_losses": list(jtr.state_losses),
                               "params": _np(jtr.params),
                               "slots": _np(jtr.opt_state.slots),
                               "step": int(jtr.opt_state.step)})
            local_caps = tuple(jtr.hop_caps)
            # the evaluation from a fresh load (C8), under caps for its whole batch (C12)
            _fresh_layout(jtr)
            jtr.hop_caps = tuple(estimate_hop_caps(B, [TNbr(*c) for c in cases[name]["nbr"]],
                                                   jtr._ref.buffer_rows))
            jax_out[name] = {"epochs": epochs, "local_caps": local_caps,
                             "eval": jtr.evaluate_nodes(cases[name]["eval_nodes"])}
        refused = {}
        case = cases["sequential-sum"]
        for what, model, kw in (
                ("embedding", _jax_model(case, embedding=True), _jax_kw(case, jmesh)),
                ("batch", _jax_model(case), dict(_jax_kw(case, jmesh), batch_size=B + 1))):
            with pytest.raises(AssertionError) as err:
                JTrainer(model, case["edges"], case["features"], case["labels"], case["train"],
                         [JNbr(*c) for c in case["nbr"]], **kw)
            refused[what] = str(err.value)
        jax_out["refusals"] = refused
    finally:
        for p in procs:
            p.join(JOIN_SECONDS)
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD, "a rank failed (its output is above)"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"cases": cases, "jax": jax_out, "ranks": ranks, "tmp": tmp}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_nc_buffer_trainer_matches_jax(runs, name):
    ref, case = runs["jax"][name], runs["cases"][name]
    for rank in runs["ranks"]:
        got = rank[name]
        assert got["hop_caps"] == ref["local_caps"]
        for g, w in zip(got["epochs"], ref["epochs"], strict=True):
            _close(g["state_losses"], w["state_losses"])
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
            pairs = []
            tree_map(lambda a, b: pairs.append((a, b)), [g["params"], g["slots"]],
                     [w["params"], w["slots"]])
            # each leaf and its two Adam slots
            assert len(pairs) == 3 * len(tree_leaves(w["params"]))
            for a, b in pairs:
                _close(a, b)
            # Adam stepped on every padded batch too (ROADMAP C6)
            assert g["step"] == w["step"]
            # one all_reduce per batch; MEAN adds the count's
            assert g["collectives_per_batch"] == (2.0 if case["reduction"] == "MEAN" else 1.0)
        assert got["eval"] == runs["ranks"][0][name]["eval"]
        assert got["eval"]["num_evaluated"] == ref["eval"]["num_evaluated"] == len(
            case["eval_nodes"])
        assert got["eval"]["accuracy"] == ref["eval"]["accuracy"]


def test_padded_index_case_ran_an_empty_share(runs):
    """The hazard case's data: in both epochs some state's last batch left
    index 1's share all padding (and the losses above still agree)."""
    empty = runs["cases"]["padded-index"]["empty_index1"]
    assert {epoch for epoch, _ in empty} == {0, 1}


def test_mesh_refusals_match_jax(runs):
    want = runs["jax"]["refusals"]
    assert want["embedding"] == "embedding-table NC over the buffer is single-controller"
    assert want["batch"] == f"batch_size {B + 1} % data axis 2 != 0"
    for rank in runs["ranks"]:
        assert rank["refusals"] == want


def test_marius_train_of_nc_buffer_on_a_mesh(runs):
    ranks = [r["manager"] for r in runs["ranks"]]
    for got in ranks:
        assert got["trainer"] == "PartitionBufferNCTrainer"
        assert got["mesh"] == {"data": 2, "node": 1}
        # each index sized its caps for its 10 seeds
        assert got["hop_caps"][0] == 10
        assert got["losses"] == ranks[0]["losses"] and got["test"] == ranks[0]["test"]
        assert np.isfinite(got["losses"]).all() and got["collectives_per_batch"] == [1.0, 1.0]
        assert 0.0 <= got["test"]["accuracy"] <= 1.0 and got["test"]["num_evaluated"] > 0
        # marius_eval of rank 0's checkpoint, on one device, scores it exactly
        assert got["eval"] == {k: got["test"][k] for k in ("accuracy", "num_evaluated")}
    assert (runs["tmp"] / "model" / "meta.yaml").exists()
