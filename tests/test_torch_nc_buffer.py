"""The port's PartitionBufferNCTrainer against marius_tpu's, on the CPU
(mirrors tests/test_nc_buffer.py:28-160).

Both trainers get the same numpy graph, features, labels and train nodes;
the port starts from the JAX trainer's dense parameters, optimizer state and
(with an EMBEDDING stage) its co-buffer's host table. The JAX draws cannot be
injected into its compiled state function, so the test replays its key
schedule eagerly (threefry gives the same values as under ``jit``): the
epoch's key is ``fold_in(key(seed + 17), epoch)`` and every scan step, the
padded ones included, splits one key off it, which the port receives through
``_batch_draws(epoch, step)`` (step = state x max_batches + batch); dropout
keys are ``fold_in(k_s, 99)`` (``_dropout_key``). Evaluation keys each batch
by ``fold_in(key(3), count)`` (``_eval_draws``). The state plans, the seed
shuffles and the bucket layout are numpy and native code, equal by
construction.

Per epoch the loss of every buffer state, and after it every dense leaf, the
optimizer's slots and step count (the padded batches' zero-gradient Adam
steps included) and the flushed co-buffer, must agree to rtol 1e-4 / atol
1e-5 (the other trainer tests' tolerance: float32 sums in another order, and
Adam carries the differences forward). Evaluation from a fresh load of the
buffer (``evaluate_nodes``) must give JAX's accuracy exactly, and each
state's local CSR must equal JAX's exactly.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from marius_tpu.data.samplers.neighbor import NeighborSamplingConfig as JNbr
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.nn.model import Model as JModel
from marius_tpu.nn.optimizers import GroupedOptimizerConfig as JGrouped
from marius_tpu.nn.optimizers import OptimizerConfig as JOpt
from marius_tpu.train.nc_buffer import PartitionBufferNCTrainer as JTrainer
from marius_tpu_torch.convert import train_state_from_jax
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig as TNbr
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.nn.model import Model as TModel
from marius_tpu_torch.nn.optimizers import GroupedOptimizerConfig as TGrouped
from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOpt
from marius_tpu_torch.nn.optimizers import tree_leaves, tree_map
from marius_tpu_torch.train.nc_buffer import PartitionBufferNCTrainer as TTrainer
from tests.test_nc_buffer import _community_graph
from tests.test_torch_gat import JaxKey
from tests.test_torch_neighbor_sampler import jax_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
N, CLASSES, FD, ED, B = 120, 4, 8, 6, 20


def _stages(L, tiers):
    """FEATURE and/or EMBEDDING, then 2 x GraphSAGE MEAN (RELU between)."""
    first = []
    if "features" in tiers:
        first.append(L("FEATURE", output_dim=FD))
    if "embedding" in tiers:
        first.append(L("EMBEDDING", output_dim=ED))
    stages = [tuple(first)]
    d = FD * ("features" in tiers) + ED * ("embedding" in tiers)
    if len(first) > 1:
        stages.append((L("REDUCTION", input_dim=d, output_dim=d, reduction="CONCAT"),))
    stages.append((L("GNN", input_dim=d, output_dim=12, gnn_type="GRAPH_SAGE",
                     aggregator="MEAN", bias=True, activation="RELU"),))
    stages.append((L("GNN", input_dim=12, output_dim=CLASSES, gnn_type="GRAPH_SAGE",
                     aggregator="MEAN", bias=True),))
    return tuple(stages)


def _optimizer(opt_cls, grouped_cls, opt):
    if opt == "grouped":   # Adam, with SGD + momentum on the first GNN layer
        return grouped_cls(opt_cls("ADAM", learning_rate=0.01),
                           ((("encoder", 1, 0), opt_cls("SGD", learning_rate=0.05,
                                                        momentum=0.9)),))
    return opt_cls(opt, learning_rate=0.01 if opt == "ADAM" else 0.1)


def _models(tiers, opt):
    return tuple(
        model_cls("NODE_CLASSIFICATION", enc_cls(_stages(layer_cls, tiers)), None,
                  loss_type="CROSS_ENTROPY", loss_reduction="SUM", sparse_lr=0.1,
                  dense_optimizer=_optimizer(opt_cls, grouped_cls, opt))
        for model_cls, enc_cls, layer_cls, opt_cls, grouped_cls in (
            (JModel, JEncoderConfig, JLayerConfig, JOpt, JGrouped),
            (TModel, TEncoderConfig, TLayerConfig, TOpt, TGrouped)))


class KeySchedule:
    """JAX's training keys by (epoch, step): ``split`` once per scan step
    from ``fold_in(key(seed + 17), epoch)``."""

    def __init__(self, seed: int):
        self.seed, self.epoch, self.keys = seed, None, []

    def k_s(self, epoch: int, step: int):
        if epoch != self.epoch:
            self.epoch, self.keys = epoch, []
            self.key = jax.random.fold_in(jax.random.key(self.seed + 17), epoch)
        while len(self.keys) <= step:
            self.key, k_s = jax.random.split(self.key)
            self.keys.append(k_s)
        return self.keys[step]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def pair(tiers=("features",), ordering="DISPERSED", opt="ADAM", seed=0, parts=6, cap=3):
    rng = np.random.default_rng(seed)
    edges, feats, labels = _community_graph(rng, N, CLASSES, FD)
    perm = rng.permutation(N).astype(np.int32)
    train_nodes, eval_nodes = perm[:90], perm[90:]
    feats = feats if "features" in tiers else None
    jmodel, tmodel = _models(tiers, opt)
    kw = dict(num_nodes=N, batch_size=B, num_partitions=parts, buffer_capacity=cap,
              ordering=ordering, seed=seed)
    nbr = [(JNbr, "UNIFORM", 3), (JNbr, "UNIFORM", 4)]
    jtr = JTrainer(jmodel, edges, feats, labels, train_nodes,
                   [c(t, f) for c, t, f in nbr], **kw)
    ttr = TTrainer(tmodel, edges, feats, labels, train_nodes,
                   [TNbr(t, f) for _, t, f in nbr], device="cpu", **kw)
    assert ttr.hop_caps == jtr.hop_caps and ttr.capacity == jtr.capacity
    ttr.state = train_state_from_jax({"table": None, "params": _np(jtr.params),
                                      "opt_state": _np(jtr.opt_state), "epoch": 0})
    if jtr.emb_buffer is not None:
        ttr.emb_buffer.host_values[:] = np.asarray(jtr.emb_buffer.host_values)
        ttr.emb_buffer.host_state[:] = np.asarray(jtr.emb_buffer.host_state)
    keys = KeySchedule(seed)
    ttr._batch_draws = lambda epoch, step, data_index=0: jax_draws(keys.k_s(epoch, step))
    ttr._dropout_key = lambda epoch, step, data_index=0: JaxKey(
        jax.random.fold_in(keys.k_s(epoch, step), 99))
    ttr._eval_draws = lambda count: jax_draws(jax.random.fold_in(jax.random.key(3), count))
    # JAX's per-state losses: the state function's last output
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
    return jtr, ttr, eval_nodes


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=RTOL, atol=ATOL)


def _same_dense(jtr, ttr):
    for t_tree, j_tree in ((ttr.params, _np(jtr.params)),
                           (ttr.opt_state.slots, _np(jtr.opt_state.slots))):
        pairs = []
        tree_map(lambda t, j: pairs.append((t, j)), t_tree, j_tree)
        assert pairs
        for t, j in pairs:
            _close(t, j)
    assert ttr.opt_state.step == int(jtr.opt_state.step) and ttr.epoch == jtr.epoch


def _train_and_check(jtr, ttr, epochs=2):
    for _ in range(epochs):
        jtr.state_losses = []
        jres, tres = jtr.train_epoch(), ttr.train_epoch()
        assert tres["num_buffer_states"] == jres["num_buffer_states"]
        _close(np.asarray(tres["state_losses"]), np.asarray(jtr.state_losses))
        np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
        _same_dense(jtr, ttr)
        if jtr.emb_buffer is not None:
            jtr.flush()
            ttr.flush()
            _close(ttr.emb_buffer.host_values, jtr.emb_buffer.host_values)
            _close(ttr.emb_buffer.host_state, jtr.emb_buffer.host_state)
    return tres


def _fresh_layout(jtr):
    """Start the JAX trainer's next pass from a fresh load, as the port's
    evaluation does."""
    if jtr.emb_buffer is not None:
        jtr.emb_buffer.flush()
        jtr.emb_buffer.resident = None
    if jtr.cache is not None:
        jtr.cache.resident = None


CASES = {
    "features-dispersed-adam": dict(),
    "features-sequential-adagrad": dict(ordering="SEQUENTIAL", opt="ADAGRAD"),
    "features-embedding-dispersed-adam": dict(tiers=("features", "embedding")),
    "features-embedding-sequential-grouped": dict(tiers=("features", "embedding"),
                                                  ordering="SEQUENTIAL", opt="grouped"),
    "embedding-dispersed-adagrad": dict(tiers=("embedding",), opt="ADAGRAD"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_nc_buffer_trainer_matches_jax(case):
    jtr, ttr, eval_nodes = pair(**CASES[case])
    assert (ttr.cache is None) == (jtr.cache is None)
    assert (ttr.emb_buffer is None) == (jtr.emb_buffer is None)
    before = None if ttr.emb_buffer is None else ttr.emb_buffer.host_values.copy()
    res = _train_and_check(jtr, ttr)
    # every state ran fewer batches than the padded count: Adam stepped on them
    assert res["masked_batches"] > 0 and res["batches_run"] >= -(-90 // B)
    assert ttr.opt_state.step == 2 * res["num_buffer_states"] * res["max_batches"]
    if before is not None:
        assert not np.array_equal(ttr.emb_buffer.host_values[:N], before[:N])
        assert ttr.emb_buffer.host_state[:N].max() > 0
    _fresh_layout(jtr)
    jacc, tacc = jtr.evaluate_nodes(eval_nodes), ttr.evaluate_nodes(eval_nodes)
    assert set(tacc) == set(jacc)
    assert tacc["num_evaluated"] == jacc["num_evaluated"] == len(eval_nodes)
    assert tacc["accuracy"] == jacc["accuracy"]


@pytest.mark.parametrize("tiers", [("features",), ("features", "embedding")])
def test_evaluation_differs_from_jax_only_through_the_layout(tiers):
    """ROADMAP C8: JAX's ``marius_train`` evaluates from the slots training
    left; the port's ``evaluate_nodes`` reloads its first state. Given the
    carried-over layout (the reload switched off) the port scores JAX's
    carried-over accuracy exactly, and from a fresh load JAX scores the
    port's: the layout is the only difference."""
    # 8 partitions, 4 slots: the carried-over slots hold the first state in another order
    jtr, ttr, eval_nodes = pair(tiers=tiers, parts=8, cap=4)
    _train_and_check(jtr, ttr, epochs=1)
    for t, j in ((ttr.cache, jtr.cache), (ttr.emb_buffer, jtr.emb_buffer)):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(t.resident, j.resident)
    reload, swap, first = ttr._reset_layout, ttr._swap_state, []

    def swap_and_record(st):
        swap(st)
        first.append(ttr._ref.resident.copy())

    ttr._swap_state = swap_and_record
    ttr._reset_layout = lambda: None
    carried = ttr.evaluate_nodes(eval_nodes)
    ttr._reset_layout = reload
    assert carried["accuracy"] == jtr.evaluate_nodes(eval_nodes)["accuracy"]
    n_states, first = len(first), first[:1]
    fresh = ttr.evaluate_nodes(eval_nodes)
    # the two passes score the same partitions in differently ordered slots
    assert len(first) == n_states + 1 and not np.array_equal(first[0], first[-n_states])
    assert sorted(first[0]) == sorted(first[-n_states])
    _fresh_layout(jtr)
    assert fresh["accuracy"] == jtr.evaluate_nodes(eval_nodes)["accuracy"]


def test_state_graph_matches_jax():
    """Each training state's local CSR (both directions, padded to the
    epoch's power of two) and degrees equal JAX's exactly."""
    jtr, ttr, _ = pair(parts=8, cap=4)
    max_edges = 1 << (max(ttr._state_edges(st) for st in ttr._plan_epoch()) - 1).bit_length()
    for st in ttr._plan_epoch():
        jtr._swap_state(st)
        ttr._swap_state(st)
        np.testing.assert_array_equal(ttr.cache.resident, jtr.cache.resident)
        jg, tg = jtr._state_graph(max_edges), ttr._state_graph(max_edges)
        assert tg.num_nodes == jg.num_nodes == ttr._ref.buffer_rows
        for f in ("out_offsets", "out_cols", "in_offsets", "in_cols", "degrees"):
            np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(
            ttr.cache.device_rows[:-1].numpy(), np.asarray(jtr.cache.device))


def test_padded_batches_step_the_dense_optimizer():
    """ROADMAP C6 kept: with Adam every epoch takes states x max_batches
    steps, the padded ones included; the padded batches launch nothing."""
    jtr, ttr, _ = pair()
    res = ttr.train_epoch()
    jtr.train_epoch()
    assert ttr.opt_state.step == int(jtr.opt_state.step) == res["num_buffer_states"] * \
        res["max_batches"] > res["batches_run"]


def test_co_buffer_is_not_checkpointed():
    """ROADMAP C6 kept: ``state`` carries the dense leaves only, in both
    packages; the co-buffer lives in the host arrays and a restored state
    leaves them as they are."""
    jtr, ttr, _ = pair(tiers=("features", "embedding"))
    ttr.train_epoch()
    jtr.train_epoch()
    assert ttr.state.table is None and jtr.state.table is None
    ttr.flush()
    table = ttr.emb_buffer.host_values.copy()
    other = pair(tiers=("features", "embedding"), seed=1)[1]
    other.state = ttr.state
    _same_dense(jtr, other)
    assert not np.array_equal(other.emb_buffer.host_values, table)


def test_nc_buffer_trainer_refuses():
    jmodel, tmodel = _models(("features",), "ADAM")
    emb_model = _models(("features", "embedding"), "ADAM")[1]
    rng = np.random.default_rng(0)
    edges, feats, labels = _community_graph(rng, N, CLASSES, FD)
    kw = dict(num_nodes=N, device="cpu")
    nbr = [TNbr("UNIFORM", 3)] * 2
    # an EMBEDDING co-buffer on a mesh, as JAX refuses it (nc_buffer.py:79-80;
    # tests/test_torch_mesh_nc_buffer.py holds both packages' refusals on a real mesh)
    with pytest.raises(ValueError, match="embedding-table NC over the buffer is single-controller"):
        TTrainer(emb_model, edges, feats, labels, np.arange(10), nbr, mesh=object(), **kw)
    with pytest.raises(ValueError, match="features and/or an embedding"):
        TTrainer(tmodel, edges, None, labels, np.arange(10), nbr, **kw)
    with pytest.raises(ValueError, match="neighbour config"):
        TTrainer(tmodel, edges, feats, labels, np.arange(10), nbr[:1], **kw)
    with pytest.raises(ValueError, match="NODE_CLASSIFICATION"):
        TTrainer(dataclasses.replace(tmodel, learning_task="LINK_PREDICTION"), edges, feats,
                 labels, np.arange(10), nbr, **kw)


def _manager_raw(tmp_path, tier):
    """tests/test_nc_buffer.py:55 (PARTITION_BUFFER features, the second GNN
    layer with its own optimizer block) and :147 (EMBEDDING + FEATURE with
    both tiers buffered), the model saved."""
    from marius_tpu.tools.preprocess import generate_random_dataset_nc

    ds = str(tmp_path / f"ds_{tier}")
    generate_random_dataset_nc(ds, num_nodes=80, num_edges=800, num_classes=4, feature_dim=8)
    gnn = {"type": "GNN", "input_dim": 8, "output_dim": 8, "activation": "RELU",
           "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}
    last = {"type": "GNN", "input_dim": 8, "output_dim": 4,
            "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}
    layers = [[{"type": "FEATURE", "output_dim": 8}], [gnn], [last]]
    storage = {"features": {"type": "PARTITION_BUFFER"},
               "embeddings": {"options": {"num_partitions": 8, "buffer_capacity": 4,
                                          "node_partition_ordering": "DISPERSED"}}}
    if tier == "features":
        last["optimizer"] = {"type": "SGD", "options": {"learning_rate": 0.05}}
    elif tier == "embedding_only":
        layers = [[{"type": "EMBEDDING", "output_dim": 8}], [gnn], [last]]
        storage = {"embeddings": {"type": "PARTITION_BUFFER", "options": {
            "num_partitions": 4, "buffer_capacity": 2}}}
    else:
        layers = [[{"type": "FEATURE", "output_dim": 8}, {"type": "EMBEDDING", "output_dim": 8}],
                  [{"type": "REDUCTION", "options": {"type": "CONCAT"}}],
                  [dict(gnn, input_dim=16)], [last]]
        pb = {"type": "PARTITION_BUFFER", "options": {"num_partitions": 4, "buffer_capacity": 2}}
        storage = {"features": copy.deepcopy(pb), "embeddings": pb}
    return {
        "model": {
            "learning_task": "NODE_CLASSIFICATION",
            "encoder": {"layers": layers, "train_neighbor_sampling": [
                {"type": "UNIFORM", "options": {"max_neighbors": 4}}] * 2},
            "loss": {"type": "CROSS_ENTROPY", "options": {"reduction": "SUM"}},
            "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": 0.01}},
            "sparse_optimizer": {"type": "ADAGRAD", "options": {"learning_rate": 0.1}},
        },
        "storage": dict(storage, dataset={"dataset_dir": ds}, save_model=True,
                        model_dir=str(tmp_path / f"model_{tier}")),
        "training": {"batch_size": 20, "num_epochs": 2},
        "evaluation": {"batch_size": 20},
    }


@pytest.mark.parametrize("tier", ["features", "embeddings", "embedding_only"])
def test_manager_trains_and_reloads(tmp_path, tier):
    """The configs of tests/test_nc_buffer.py:55 and :147, and an EMBEDDING
    table alone in a PARTITION_BUFFER, through the port's marius_train and
    marius_eval on the CPU: the trainer, its hop caps and tiers are JAX's; a features-only model's test accuracy comes back
    exactly from marius_eval (evaluation starts from a fresh buffer load);
    with the EMBEDDING co-buffer the reload scores with a fresh table (ROADMAP
    C7: the dense leaves reload, the co-buffer does not)."""
    from marius_tpu.config.schema import load_config as j_load_config
    from marius_tpu.manager import marius_init as j_marius_init
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train
    from marius_tpu_torch.nn.optimizers import GroupedOptimizerConfig

    raw = _manager_raw(tmp_path, tier)
    jtr = j_marius_init(j_load_config(copy.deepcopy(raw))).trainer
    res = marius_train(load_config(copy.deepcopy(raw)), device="cpu")
    tr = res["runtime"].trainer
    assert type(tr).__name__ == type(jtr).__name__ == "PartitionBufferNCTrainer"
    assert tr.hop_caps == tuple(jtr.hop_caps)
    assert (tr.num_partitions, tr.capacity) == (jtr.num_partitions, jtr.capacity)
    assert (tr.emb_buffer is not None) == (jtr.emb_buffer is not None) == (tier != "features")
    assert (tr.cache is not None) == (jtr.cache is not None) == (tier != "embedding_only")
    assert isinstance(tr.model.dense_optimizer, GroupedOptimizerConfig) == (tier == "features")
    assert len(res["epochs"]) == 2 and all(np.isfinite(e["loss"]) for e in res["epochs"])
    assert res["test"]["num_evaluated"] > 0 and 0.0 <= res["test"]["accuracy"] <= 1.0
    again = marius_eval(load_config(copy.deepcopy(raw)), device="cpu")
    rt = again["runtime"]
    assert rt.epochs_processed == 2 and rt.trainer.epoch == 2
    for a, b in zip(tree_leaves(tr.params), tree_leaves(rt.trainer.params)):
        assert torch.equal(a, b)
    assert rt.trainer.opt_state.step == tr.opt_state.step
    if tier == "features":
        assert again["test"] == {k: res["test"][k] for k in ("accuracy", "num_evaluated")}
    else:
        assert not np.array_equal(rt.trainer.emb_buffer.host_values, tr.emb_buffer.host_values)
