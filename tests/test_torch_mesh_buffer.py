"""The port's partition buffer on a (data x node) mesh against the JAX
package's, on the CPU over gloo.

Four ranks of one gloo process group (``tests/torch_mesh_worker.py``,
spawned once for the module) train ``PartitionBufferLPTrainer`` on a 2 x 2
mesh; this process trains JAX's buffer trainer on the same mesh of the 8
virtual CPU devices of ``tests/conftest.py`` (GSPMD: one device's semantics,
the shape of ``tests/test_sharding.py:123-150``: 128 nodes, 4 partitions,
capacity 2, BETA) and the port's single-device trainer beside it. Every
trainer starts from the JAX trainer's weights. The single-device port
trainer takes JAX's draws (its key schedule replayed eagerly,
``tests/test_torch_buffer_trainer.py``) and records them; the ranks replay
the record, so all three see the same negatives and sampler numbers.

- shallow ComplEx corrupting nodes (DEG fraction 0.5), ComplEx corrupting
  relations, and EMBEDDING + GraphSAGE MEAN with UNIFORM fanout 2
  (gs_1_layer, the table at lr 0.02: ROADMAP C5): after 2 buffer states the
  loss, the flushed host table and Adagrad state and the dense parameters
  agree with JAX's to rtol 1e-4 / atol 1e-5, on every rank;
- every rank's host table is the same after the flush, its card held only
  its node index's half of the buffer, and each batch's collectives are 2
  (the gather over the node axis, one all_reduce over the data axis) plus
  the evictions' all_gathers;
- rank 0's checkpoint (the single-device layout) loads into one process;
- ``marius_train`` of ``freebase86m_comet.yaml``'s model cut small with
  ``training.mesh: {data: 2, node: 2}``: every rank reports the test
  metrics, and one process's ``marius_eval`` of the saved model gives them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import yaml

import torch_mesh_worker as worker
from marius_tpu.data.samplers.negative import NegativeSamplingConfig as JNeg
from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn.decoders.edge import EdgeDecoder as JEdgeDecoder
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.parallel.mesh import make_mesh as j_make_mesh
from marius_tpu.train.buffer_trainer import PartitionBufferLPTrainer as JTrainer
from marius_tpu_torch.config import load_config
from marius_tpu_torch.manager import marius_eval
from marius_tpu_torch.storage import checkpoint as ckpt
from marius_tpu_torch.tools.preprocess.generate import generate_random_dataset_lp
from tests.test_torch_buffer_trainer import JaxDraws
from tests.test_torch_corrupt_rel import RelJaxDraws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
WORLD, MESH = 4, (2, 2)
N, R, D, E, B = 128, 4, 16, 800, 64
METRIC_KEYS = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
JOIN_SECONDS = 240

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

# name -> (decoder, decoder method, DEG fraction, neighbour configs, table lr)
CASES = {
    "shallow": ("COMPLEX", "CORRUPT_NODE", 0.5, (), 0.1),
    "corrupt_rel": ("COMPLEX", "CORRUPT_REL", 0.0, (), 0.1),
    "gs_1_layer": ("DISTMULT", "CORRUPT_NODE", 0.0, (("UNIFORM", 2),), 0.02),
}


def _case(name, seed):
    decoder, method, deg, nbr, sparse_lr = CASES[name]
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, N, E), rng.integers(0, R, E),
                      rng.integers(0, N, E)], 1).astype(np.int32)
    return {"kind": "buffer", "edges": edges, "num_nodes": N, "num_rels": R, "dim": D,
            "batch_size": B, "chunks": 2, "negatives": 8, "degree_fraction": deg,
            "parts": 4, "capacity": 2, "nbr": nbr, "decoder": decoder,
            "decoder_method": method, "sparse_lr": sparse_lr, "states": 2, "mesh": MESH}


def _jax_trainer(case, mesh):
    stages = ((JLayerConfig("EMBEDDING", output_dim=D),),)
    if case["nbr"]:
        stages += ((JLayerConfig("GNN", input_dim=D, output_dim=D, gnn_type="GRAPH_SAGE",
                                 aggregator="MEAN", bias=True),),)
    model = JModel("LINK_PREDICTION", JEncoderConfig(stages),
                   JEdgeDecoder(case["decoder"], R, D, decoder_method=case["decoder_method"]),
                   dense_optimizer=JOpt("ADAGRAD", learning_rate=0.1),
                   sparse_lr=case["sparse_lr"])
    jtr = JTrainer(model, N, R, case["edges"],
                   JNeg(case["chunks"], case["negatives"], case["degree_fraction"]),
                   batch_size=B, num_partitions=case["parts"], buffer_capacity=case["capacity"],
                   seed=0, ordering="BETA", nbr_configs=[JNbr(*c) for c in case["nbr"]],
                   mesh=mesh)
    # rows of +-0.1 and distinct relations (tests/test_torch_buffer_trainer.py,
    # tests/test_torch_corrupt_rel.py say why)
    rng = np.random.default_rng(5)
    jtr.buffer.host_values[:N] = rng.uniform(-0.1, 0.1, (N, D)).astype(np.float32)
    jtr.params = {**jtr.params, "decoder": {
        k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        for k, v in jtr.params["decoder"].items()}}
    return jtr


def _weights(jtr):
    """JAX's weights as plain numpy: no JAX type is pickled to the ranks."""
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"host_values": np.asarray(jtr.buffer.host_values).copy(),
            "host_state": np.asarray(jtr.buffer.host_state).copy(),
            "params": tree(jtr.params),
            "opt_state": {"step": np.asarray(jtr.opt_state.step),
                          "slots": tree(jtr.opt_state.slots)}}


def _recorded_single_run(case, jtr):
    """The port's single-device trainer with JAX's draws, recording them."""
    ttr = worker.buffer_trainer({**case, "draws": None}, None)
    draws = RelJaxDraws(jtr) if case["decoder_method"] == "CORRUPT_REL" else JaxDraws(jtr)
    rec = {"neg": {}, "rel": {}, "gnn": {}}
    arr = lambda t: None if t is None else t.numpy().copy()  # noqa: E731

    def in_buffer(step, inverse):
        out = draws(ttr.epoch, step, inverse)
        rec["neg"][(step, inverse)] = tuple(arr(a) for a in out)
        return out

    def rel(step):
        out = draws.relations(ttr.epoch, step, R)
        rec["rel"][step] = arr(out)
        return out

    def gnn(step):
        inner, table = draws.sampler(ttr.epoch, step), rec["gnn"].setdefault(step, {})

        def draw(*args):
            out = inner(*args)
            table[args] = tuple(arr(a) for a in out)
            return out

        return draw

    ttr._in_buffer_draws, ttr._rel_negatives, ttr._gnn_draws = in_buffer, rel, gnn
    stats = ttr.train_epoch(max_states=case["states"])
    ttr.buffer.flush()
    return rec, {"loss": stats["loss"], "host_values": ttr.buffer.host_values.copy(),
                 "host_state": ttr.buffer.host_state.copy(), "states_run": stats["states_run"]}


def _manager_raw(ds, model_dir, mesh=None):
    """freebase86m_comet.yaml (ComplEx, PARTITION_BUFFER, COMET) cut to 4
    partitions of capacity 2, d 16, batch 60 of 2 x 8 negatives, 1 epoch."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "examples", "configuration", "freebase86m_comet.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["encoder"]["layers"][0][0]["output_dim"] = 16
    raw["model"]["decoder"]["options"]["input_dim"] = 16
    raw["storage"].update(device_type="cpu", model_dir=model_dir, save_model=True)
    raw["storage"]["dataset"]["dataset_dir"] = ds
    raw["storage"]["embeddings"]["options"].update(num_partitions=4, buffer_capacity=2)
    raw["training"].update(batch_size=60, num_epochs=1)
    raw["training"]["negative_sampling"].update(num_chunks=2, negatives_per_positive=8)
    if mesh is not None:
        raw["training"]["mesh"] = mesh
    raw["evaluation"] = {"batch_size": 60, "negative_sampling": {"filtered": True}}
    return raw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Record the single-device runs, spawn the four ranks on every case,
    and meanwhile train JAX's side here."""
    tmp = tmp_path_factory.mktemp("mesh_buffer")
    ds = str(tmp / "ds")
    generate_random_dataset_lp(ds, num_nodes=120, num_edges=1200, num_relations=4)
    jmesh = j_make_mesh(num_data=MESH[0], num_node=MESH[1], devices=jax.devices()[:WORLD])
    cases, jtrainers, single = {}, {}, {}
    for seed, name in enumerate(CASES):
        case = _case(name, seed + 20)
        jtr = jtrainers[name] = _jax_trainer(case, jmesh)
        case["weights"] = _weights(jtr)
        case["draws"], single[name] = _recorded_single_run(case, jtr)
        case["out"] = str(tmp / name)
        cases[name] = case
    cases["manager"] = {"kind": "buffer_manager", "raw": _manager_raw(
        ds, str(tmp / "model_mesh"), {"data": MESH[0], "node": MESH[1]})}

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.main, args=(r, WORLD, str(tmp / "rendezvous"), cases,
                                                   str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jax_out = {}
        for name, jtr in jtrainers.items():
            res = jtr.train_epoch(max_states=2)
            jtr.buffer.flush()
            jax_out[name] = {"loss": res["loss"], "states_run": res["states_run"],
                             "host_values": np.asarray(jtr.buffer.host_values),
                             "host_state": np.asarray(jtr.buffer.host_state),
                             "params": jax.tree.map(np.asarray, jtr.params)}
    finally:
        for p in procs:
            p.join(JOIN_SECONDS)
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD, "a rank failed (its output is above)"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"cases": cases, "jax": jax_out, "single": single, "ranks": ranks, "ds": ds,
            "tmp": tmp}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _close_tree(t, j):
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            _close_tree(t[k], j[k])
    elif isinstance(t, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _close_tree(a, b)
    else:
        _close(t, j)


@pytest.mark.parametrize("name", list(CASES))
def test_buffer_on_a_mesh_matches_jax(runs, name):
    ref, single = runs["jax"][name], runs["single"][name]
    assert ref["states_run"] == single["states_run"] == 2
    # the single-device port with the same draws (held against JAX by
    # tests/test_torch_buffer_trainer.py) is the recording's own check
    _close(single["loss"], ref["loss"])
    _close(single["host_values"], ref["host_values"])
    for rank in runs["ranks"]:
        got = rank[name]
        assert got["states_run"] == 2
        _close(got["loss"], ref["loss"])
        _close(got["host_values"], ref["host_values"])
        _close(got["host_state"], ref["host_state"])
        _close_tree(got["params"], ref["params"])


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_its_shard_and_the_same_host_table(runs, name):
    ranks = [r[name] for r in runs["ranks"]]
    for got in ranks:
        # half of the buffer's 2 x 32 rows on each node index, never the whole
        assert got["buffer_rows"] == 64 and got["shard"] == (32, D)
        np.testing.assert_array_equal(got["host_values"], ranks[0]["host_values"])
        np.testing.assert_array_equal(got["host_state"], ranks[0]["host_state"])
        # each eviction all_gathers a whole slot (2 x 32 rows of values and
        # state side by side from the two node indices: 2 x 32 x 2D floats)
        assert got["gathered_bytes"] > 0 and got["gathered_bytes"] % (2 * 32 * 2 * D * 4) == 0
        # 2 per batch, the swaps' and the flush's all_gathers spread over them
        assert 2.0 < got["collectives_per_batch"] < 4.0
    assert {r["collectives_per_batch"] for r in ranks} == {ranks[0]["collectives_per_batch"]}


def test_rank0_checkpoint_loads_in_one_process(runs):
    case = runs["cases"]["shallow"]
    trainer = worker.buffer_trainer(case, None)
    state, meta = ckpt.load_state(os.path.join(case["out"], "ckpt"), trainer.state)
    assert meta["epochs_processed"] == 1
    _close(state.table.values.numpy(), runs["jax"]["shallow"]["host_values"][:N])
    _close(state.table.state.numpy(), runs["jax"]["shallow"]["host_state"][:N])
    trainer.state = state
    np.testing.assert_array_equal(trainer.buffer.host_values,
                                  runs["ranks"][0]["shallow"]["host_values"])


def test_marius_train_of_the_buffer_on_a_mesh(runs):
    ranks = [r["manager"] for r in runs["ranks"]]
    for got in ranks:
        assert got["mesh"] == ({"data": 2, "node": 2}, "PartitionBufferLPTrainer")
        assert {k: got["test"][k] for k in METRIC_KEYS} == {
            k: ranks[0]["test"][k] for k in METRIC_KEYS}
        np.testing.assert_array_equal(got["host_values"], ranks[0]["host_values"])
        assert np.isfinite(got["losses"]).all()
    # rank 0 wrote the model in the single-device layout: one process
    # evaluates it as rank 0 did
    raw = _manager_raw(runs["ds"], str(runs["tmp"] / "model_mesh"), {"data": 2, "node": 2})
    again = marius_eval(load_config(raw), device="cpu")
    assert again["runtime"].trainer.mesh is None
    assert {k: again["test"][k] for k in METRIC_KEYS} == {
        k: ranks[0]["test"][k] for k in METRIC_KEYS}
