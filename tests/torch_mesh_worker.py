"""One rank of the gloo process group that ``tests/test_torch_mesh*.py``
spawn: it runs the port's side of every mesh case on the CPU and saves its
results for the test process, which holds them against the JAX package.

Imports torch and the port only (no JAX), so each rank starts in seconds.
``main`` joins the group through ``multihost.initialize`` with a
``file://`` rendezvous (no port to collide between test workers) and a
timeout, so a rank that never arrives fails the others instead of hanging.
"""

import dataclasses
import datetime

import torch

TIMEOUT = datetime.timedelta(seconds=90)


def fake_negatives_torch(cfg, edges, num_nodes, inverse):
    """The test's deterministic negatives: a function of the batch with
    sample_negatives' layout (tests/test_torch_lp_trainer.py)."""
    from marius_tpu_torch.data.samplers.negative import NegativeSample

    nb = int(cfg.negatives_per_positive * cfg.degree_fraction)
    c, nu = cfg.num_chunks, cfg.negatives_per_positive - nb
    col = 0 if inverse else edges.shape[1] - 1
    base = edges[:, col].sum() + (3 if inverse else 0)
    uni = ((base + 7 * torch.arange(c * nu)) % num_nodes).reshape(c, nu)
    rows = ((base + 5 * torch.arange(c * nb)) % edges.shape[0]).reshape(c, nb)
    deg = edges[:, col][rows]
    return NegativeSample(torch.cat([deg, uni], dim=1), rows)


def lp_model(case):
    """The case's port model: DistMult over EMBEDDING, EMBEDDING + FEATURE,
    EMBEDDING and a GraphSAGE MEAN layer (dense Adagrad at lr 0.1 and the
    table at 0.02: ROADMAP C5), or FEATURE and a GraphSAGE MEAN layer (no
    table); corrupting nodes or, with ``decoder_method``, relations."""
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    d, r = case["dim"], case["num_rels"]
    stages = ((LayerConfig("EMBEDDING", output_dim=d),),)
    kw = {}
    if case.get("features") is not None:
        f = case["features"].shape[1]
        stages = ((LayerConfig("EMBEDDING", output_dim=d - f),
                   LayerConfig("FEATURE", output_dim=f)),)
        if case.get("feature_only"):
            d = f
            stages = ((LayerConfig("FEATURE", output_dim=f),),)
    if case.get("gnn"):
        stages += ((LayerConfig("GNN", input_dim=d, output_dim=d, gnn_type="GRAPH_SAGE",
                                aggregator="MEAN", bias=True),),)
        kw = dict(dense_optimizer=OptimizerConfig("ADAGRAD", learning_rate=0.1), sparse_lr=0.02)
    if case.get("dense_opt"):
        kw["dense_optimizer"] = OptimizerConfig(*case["dense_opt"])
    decoder = EdgeDecoder("DISTMULT", r, d,
                          decoder_method=case.get("decoder_method", "CORRUPT_NODE"))
    model = Model("LINK_PREDICTION", EncoderConfig(stages), decoder, **kw)
    return dataclasses.replace(model, loss_reduction=case["reduction"])


def lp_trainer(case, mesh=None):
    """The case's trainer, its negatives (node or relation) and permutations
    injected, from the JAX initial state when the case carries one."""
    from marius_tpu_torch.convert import train_state_from_jax
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.data.samplers.neighbor import (
        NeighborSamplingConfig,
        resolve_all_caps_from_edges,
    )
    from marius_tpu_torch.ops.edge_keys import build_edge_key_set
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    edges, n, r = case["edges"], case["num_nodes"], case["num_rels"]
    neg = NegativeSamplingConfig(case["chunks"], case["negatives"], case["degree_fraction"],
                                 filtered=case["filtered"])
    kw = {}
    if case["filtered"]:
        kw["train_filter_keys"] = (build_edge_key_set(edges, True, "cpu"),
                                   build_edge_key_set(edges, False, "cpu"))
    if case.get("gnn"):
        kw["graph"] = build_device_graph(edges, n, r, device="cpu")
        kw["nbr_configs"] = resolve_all_caps_from_edges((NeighborSamplingConfig("ALL"),),
                                                        edges, n)
    trainer = LinkPredictionTrainer(lp_model(case), n, r, edges, neg,
                                    batch_size=case["batch_size"], device="cpu", mesh=mesh,
                                    features=case.get("features"),
                                    dtype=getattr(torch, case.get("dtype", "float32")),
                                    edges_backend=case.get("edges_backend", "DEVICE_MEMORY"),
                                    **kw)
    trainer._sample_negatives = lambda edges_b, inverse: fake_negatives_torch(
        neg, edges_b, n, inverse)
    if case.get("rel_negs") is not None:
        rel_negs = iter(case["rel_negs"])
        trainer._sample_rel_negatives = lambda: torch.from_numpy(next(rel_negs))
    perms = case["perms"]
    trainer._epoch_permutation = lambda e: torch.tensor(perms[e], dtype=torch.long)
    if case.get("jax_state") is not None:
        trainer.load_gathered_state(train_state_from_jax(case["jax_state"]))
    return trainer


def run_trainer(case, mesh=None):
    """Per epoch: the loss, the table (values, Adagrad state) in the
    single-device layout (None without one), the relations, the encoder's
    parameters and the collectives per batch."""
    trainer = lp_trainer(case, mesh)
    out = []
    for _ in range(case["epochs"]):
        stats = trainer.train_epoch()
        full = trainer.gathered_state()
        table = full.table

        def host(t):
            # copies: on one device these are the trainer's own tensors
            return None if t is None else t.detach().float().numpy().copy()

        out.append({"loss": stats["loss"], "values": host(table and table.values),
                    "state": host(table and table.state),
                    "relations": host(full.params["decoder"]["relations"]),
                    # JAX's leaf order: each layer's entries by name
                    "encoder": [host(layer[k]) for stage in full.params["encoder"]
                                for layer in stage for k in sorted(layer)],
                    "collectives_per_batch": stats.get("collectives_per_batch")})
    return out


def run_collectives(case):
    """The four functions of parallel/collectives.py on a mesh with
    ``case["node"]`` node ranks (the other ranks form the data axis)."""
    from marius_tpu_torch.parallel import collectives as col
    from marius_tpu_torch.parallel.mesh import NODE_AXIS, gather_table_to_host, make_mesh

    world = torch.distributed.get_world_size()
    try:
        make_mesh(world + 1, 1, device="cpu")
        refused = None
    except ValueError as err:   # before any group is made, so no rank waits
        refused = str(err)
    mesh = make_mesh(world // case["node"], case["node"], device="cpu")
    s = case["table"].shape[0] // case["node"]
    lo = mesh.axis_index(NODE_AXIS) * s

    def shard(a):
        return torch.from_numpy(a[lo:lo + s].copy())

    out = {"gather": col.sharded_gather(shard(case["table"]), torch.from_numpy(case["ids"]),
                                        mesh).numpy()}
    v = shard(case["table"]).requires_grad_(True)
    x = col.sharded_gather_inner_grad(v, torch.from_numpy(case["ids"]), mesh)
    (g,) = torch.autograd.grad((x * torch.from_numpy(case["w"])).sum(), [v])
    out["inner_grad"] = g.numpy()
    out["scatter_add"] = col.sharded_scatter_add(
        shard(case["table"]), torch.from_numpy(case["scatter_ids"]),
        torch.from_numpy(case["scatter_values"]), mesh).numpy()
    values, state = shard(case["values"]), shard(case["state"])
    col.sharded_adagrad_update(values, state, torch.from_numpy(case["adagrad_ids"]),
                               torch.from_numpy(case["grads"]), 0.1, mesh)
    out["adagrad"] = (values.numpy(), state.numpy())
    before = mesh.collectives
    out["to_host"] = gather_table_to_host(shard(case["table"]), mesh)
    out["to_host_collectives"] = mesh.collectives - before
    out["rows"] = (lo, lo + s)
    out["refused"] = refused
    out["step"] = run_lp_step(case["step"], mesh, shard)
    return out


def run_lp_step(case, mesh, shard):
    """One ``make_sharded_lp_step`` step (every rank trains the whole
    batch) from JAX's initial parameters: this rank's values and Adagrad
    state, the relations and the loss."""
    from marius_tpu_torch.convert import train_state_from_jax
    from marius_tpu_torch.nn.model import init_model_params
    from marius_tpu_torch.nn.optimizers import init_optimizer, tree_map
    from marius_tpu_torch.parallel.collectives import make_sharded_lp_step

    model = lp_model({"dim": case["dim"], "num_rels": case["num_rels"], "reduction": "SUM"})
    params = init_model_params(torch.Generator().manual_seed(0), model)
    with torch.no_grad():
        tree_map(lambda p, a: p.copy_(a), params, train_state_from_jax(case["state"]).params)
    values, state = shard(case["state"]["table"]["values"]), shard(case["state"]["table"]["state"])
    step = make_sharded_lp_step(model, mesh, case["state"]["table"]["values"].shape[0])
    _, loss = step(values, state, params, init_optimizer(model.dense_optimizer, params),
                   *(torch.from_numpy(case[k]) for k in ("edges", "dst_negs", "src_negs", "mask")))
    return {"values": values.numpy(), "state": state.numpy(), "loss": float(loss),
            "relations": params["decoder"]["relations"].detach().numpy().copy()}


def run_manager(case):
    """marius_train through the config, on this process group's mesh; then
    the test evaluator's whole table, assembled on the device and, as
    host-streamed evaluation reads it, on the host."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_train

    result = marius_train(load_config(case["raw"]), device="cpu")
    trainer = result["runtime"].trainer
    ev = result["runtime"].test_evaluator
    return {"host_table": ev.table_values(trainer.state, on_device=False),
            "device_table": ev.table_values(trainer.state),
            "losses": [e["loss"] for e in result["epochs"]],
            "collectives_per_batch": [e["collectives_per_batch"] for e in result["epochs"]],
            "test": {k: v for k, v in result["test"].items() if k != "eval_time_s"},
            "mesh": (trainer.mesh.shape, trainer.sharding_mode, trainer.mesh.backend)}


def run_buffer_manager(case):
    """marius_train of a PARTITION_BUFFER config on this process group's
    mesh: the test metrics, the epochs' losses and the trainer's mesh."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_train

    result = marius_train(load_config(case["raw"]), device="cpu")
    trainer = result["runtime"].trainer
    return {"test": {k: v for k, v in result["test"].items() if k != "eval_time_s"},
            "losses": [e["loss"] for e in result["epochs"]],
            "host_values": trainer.buffer.host_values.copy(),
            "mesh": (trainer.mesh.shape, type(trainer).__name__)}


def buffer_model(case):
    """The buffer case's port model: ComplEx or DistMult over EMBEDDING,
    corrupting nodes or relations, or EMBEDDING and a GraphSAGE MEAN layer
    (gs_1_layer); dense and table Adagrad."""
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    d = case["dim"]
    stages = ((LayerConfig("EMBEDDING", output_dim=d),),)
    if case["nbr"]:
        stages += ((LayerConfig("GNN", input_dim=d, output_dim=d, gnn_type="GRAPH_SAGE",
                                aggregator="MEAN", bias=True),),)
    return Model("LINK_PREDICTION", EncoderConfig(stages),
                 EdgeDecoder(case["decoder"], case["num_rels"], d,
                             decoder_method=case["decoder_method"]),
                 dense_optimizer=OptimizerConfig("ADAGRAD", learning_rate=0.1),
                 sparse_lr=case["sparse_lr"])


def replayed_draws(table):
    """A Draws function that gives back recorded sampler numbers."""
    def draw(depth, direction, n, fanout, dropout):
        return tuple(None if a is None else torch.from_numpy(a)
                     for a in table[(depth, direction, n, fanout, dropout)])

    return draw


def buffer_trainer(case, mesh=None):
    """The buffer case's trainer from the JAX trainer's weights, its draws
    (in-buffer negatives, relation negatives, sampler numbers) replayed from
    the single-device run's record."""
    from marius_tpu_torch.convert import copy_buffer_trainer_from_jax_
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
    from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer

    trainer = PartitionBufferLPTrainer(
        buffer_model(case), case["num_nodes"], case["num_rels"], case["edges"],
        NegativeSamplingConfig(case["chunks"], case["negatives"], case["degree_fraction"]),
        batch_size=case["batch_size"], num_partitions=case["parts"],
        buffer_capacity=case["capacity"], seed=0, ordering="BETA",
        nbr_configs=[NeighborSamplingConfig(*c) for c in case["nbr"]], mesh=mesh,
        device="cpu")
    w = case["weights"]
    copy_buffer_trainer_from_jax_(trainer, w["host_values"], w["host_state"], w["params"],
                                  w["opt_state"], 0)
    rec = case["draws"]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    trainer._in_buffer_draws = lambda step, inverse: tuple(
        t(a) for a in rec["neg"][(step, inverse)])
    trainer._rel_negatives = lambda step: t(rec["rel"][step])
    trainer._gnn_draws = lambda step: replayed_draws(rec["gnn"][step])
    return trainer


def run_buffer(case, mesh):
    """The buffer trainer's first ``states`` states on the mesh: the loss,
    the device shard's rows, the flushed host table, the dense state, the
    collectives and the all_gathered bytes; then a checkpoint from rank 0."""
    from marius_tpu_torch.storage import checkpoint as ckpt

    trainer = buffer_trainer(case, mesh)
    stats = trainer.train_epoch(max_states=case["states"], final_flush=False)
    shard = tuple(trainer.buffer.device_values.shape)
    state = trainer.gathered_state()
    out = {"loss": stats["loss"], "shard": shard, "buffer_rows": trainer.buffer.buffer_rows,
           "host_values": trainer.buffer.host_values.copy(),
           "host_state": trainer.buffer.host_state.copy(),
           "params": {k: [[{n: p.detach().numpy().copy() for n, p in layer.items()}
                           for layer in stage] for stage in v] if k == "encoder"
                      else {n: p.detach().numpy().copy() for n, p in v.items()}
                      for k, v in trainer.params.items()},
           "collectives_per_batch": stats["collectives_per_batch"],
           "gathered_bytes": stats["gathered_bytes"], "states_run": stats["states_run"],
           "batches_run": stats["batches_run"]}
    ckpt.save_state(f"{case['out']}/ckpt", state, metadata={"epochs_processed": 1}, mesh=mesh)
    return out


def nc_model(case):
    """The NC case's port model: ogbn_arxiv.yaml's FEATURE + GraphSAGE MEAN
    stages, FEATURE beside EMBEDDING with a RELU and a GCN stage, or the
    linear collapse's FEATURE + 2 GraphSAGE (tests/test_sharding.py:487)."""
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig as L
    from marius_tpu_torch.nn.model import Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    f, c = case["features"].shape[1], case["classes"]
    sage = dict(gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True)
    if case["variant"] == "embedding":
        stages = [(L("FEATURE", output_dim=f), L("EMBEDDING", output_dim=4)),
                  (L("GNN", input_dim=f + 4, output_dim=12, activation="RELU", **sage),),
                  (L("GNN", input_dim=12, output_dim=c, gnn_type="GCN", bias=True),)]
    elif case["variant"] == "collapse":
        stages = [(L("FEATURE", output_dim=f, bias=True),),
                  (L("GNN", input_dim=f, output_dim=8, gnn_type="GRAPH_SAGE", bias=True),),
                  (L("GNN", input_dim=8, output_dim=c, gnn_type="GRAPH_SAGE", bias=True),)]
    else:
        stages = [(L("FEATURE", output_dim=f, bias=True),),
                  (L("GNN", input_dim=f, output_dim=16, **sage),),
                  (L("GNN", input_dim=16, output_dim=c, **sage),)]
    return Model("NODE_CLASSIFICATION", EncoderConfig(tuple(stages)), None,
                 loss_type="CROSS_ENTROPY", loss_reduction=case["reduction"],
                 dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.01), sparse_lr=0.1)


def nc_trainer(case, mesh=None):
    """The NC case's trainer from JAX's initial state, its permutations and
    (sampled) this data index's recorded draws injected."""
    from marius_tpu_torch.convert import train_state_from_jax
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
    from marius_tpu_torch.parallel.mesh import DATA_AXIS
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    edges, n = case["edges"], case["num_nodes"]
    collapse = case["variant"] == "collapse"
    trainer = NodeClassificationTrainer(
        nc_model(case), build_device_graph(edges, n, device="cpu"), case["features"],
        case["labels"], case["train"], [NeighborSamplingConfig(*c) for c in case["nbr"]],
        batch_size=case["batch_size"], seed=0, mesh=mesh, device="cpu",
        full_graph=build_full_graph_adjacency(edges, n) if collapse else None)
    perms = case["perms"]
    trainer._epoch_permutation = lambda p: torch.from_numpy(perms[p]).long()
    trainer.load_gathered_state(train_state_from_jax(case["jax_state"]))
    if case.get("draws") is not None:
        mine = iter(case["draws"][0 if mesh is None else mesh.axis_index(DATA_AXIS)])
        trainer._batch_draws = lambda data_index=0: replayed_draws(next(mine))
    return trainer


def run_nc(case, mesh):
    """Per epoch: the loss, the encoder's parameters (JAX's leaf order), the
    table and the collectives per batch; the last epoch's evaluation."""
    from marius_tpu_torch.train.nc import NodeClassificationEvaluator

    trainer = nc_trainer(case, mesh)
    out = []
    for _ in range(case["epochs"]):
        stats = trainer.train_epoch()
        st = trainer.gathered_state()
        out.append({"loss": stats["loss"], "collectives_per_batch": stats["collectives_per_batch"],
                    "encoder": [layer[k].detach().numpy().copy()
                                for stage in st.params["encoder"] for layer in stage
                                for k in sorted(layer)],
                    "table": None if st.table is None else
                    (st.table.values.numpy().copy(), st.table.state.numpy().copy())})
    ev = NodeClassificationEvaluator(trainer, case["eval_nodes"], batch_size=40)
    # one process's trainer holding the mesh-trained state evaluates alike
    one = nc_trainer({**case, "draws": None}, None)
    one.load_gathered_state(trainer.gathered_state())
    ev_one = NodeClassificationEvaluator(one, case["eval_nodes"], batch_size=40)
    return {"epochs": out, "eval": ev.evaluate(trainer.state),
            "eval_one": ev_one.evaluate(one.state), "hop_caps": trainer.hop_caps}


def run_nc_routes(case):
    """``nc_table_grad``'s two routes on this data index's ids and row
    gradients, each densified to the (N, d) accumulator G."""
    from marius_tpu_torch.parallel.collectives import nc_table_grad
    from marius_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

    mesh = make_mesh(torch.distributed.get_world_size(), 1, device="cpu", timeout=TIMEOUT)
    i, n = mesh.axis_index(DATA_AXIS), case["num_rows"]
    out = {}
    for route in ("gather", "reduce"):
        rows, G = nc_table_grad(n, torch.from_numpy(case["ids"][i]),
                                torch.from_numpy(case["grads"][i]), mesh, route=route)
        dense = torch.zeros((n + 1, G.shape[1]))
        dense[rows] = G
        out[route] = dense[:n].numpy()
    out["auto"] = nc_table_grad(n, torch.from_numpy(case["ids"][i]),
                                torch.from_numpy(case["grads"][i]), mesh)[0].shape[0] < n
    return out


def run_nc_manager(case):
    """marius_train of an NC config on this process group's mesh."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_train

    result = marius_train(load_config(case["raw"]), device="cpu")
    trainer = result["runtime"].trainer
    return {"test": result["test"], "losses": [e["loss"] for e in result["epochs"]],
            "collapse": trainer._fg_collapse is not None, "mesh": trainer.mesh.shape}


def nc_buffer_model(case):
    """The out-of-core case's port model: FEATURE, GraphSAGE MEAN with a
    RELU, then GraphSAGE MEAN or (``gcn``) GCN; Adam."""
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig as L
    from marius_tpu_torch.nn.model import Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    f, c = case["features"].shape[1], case["classes"]
    sage = dict(gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True)
    last = (dict(gnn_type="GCN", bias=True) if case["gcn"] else sage)
    stages = ((L("FEATURE", output_dim=f),),
              (L("GNN", input_dim=f, output_dim=12, activation="RELU", **sage),),
              (L("GNN", input_dim=12, output_dim=c, **last),))
    return Model("NODE_CLASSIFICATION", EncoderConfig(stages), None,
                 loss_type="CROSS_ENTROPY", loss_reduction=case["reduction"],
                 dense_optimizer=OptimizerConfig("ADAM", learning_rate=0.01))


def nc_buffer_trainer(case, mesh, model=None, **changes):
    """The out-of-core case's trainer on ``mesh``, ``changes`` over its
    keyword arguments."""
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
    from marius_tpu_torch.train.nc_buffer import PartitionBufferNCTrainer

    kw = dict(num_nodes=case["num_nodes"], batch_size=case["batch_size"],
              num_partitions=case["parts"], buffer_capacity=case["capacity"],
              ordering=case["ordering"], seed=0, mesh=mesh, device="cpu")
    kw.update(changes)
    return PartitionBufferNCTrainer(model or nc_buffer_model(case), case["edges"],
                                    case["features"], case["labels"], case["train"],
                                    [NeighborSamplingConfig(*c) for c in case["nbr"]], **kw)


def run_nc_buffer(case, mesh):
    """The out-of-core trainer on the mesh from JAX's initial state, this
    data index's recorded draws replayed: per epoch the state losses, the
    dense leaves, Adam's slots and step; then the evaluation of the split."""
    from marius_tpu_torch.convert import train_state_from_jax
    from marius_tpu_torch.nn.optimizers import tree_map
    from marius_tpu_torch.parallel.mesh import DATA_AXIS

    trainer = nc_buffer_trainer(case, mesh)
    trainer.state = train_state_from_jax(case["jax_state"])
    mine = case["draws"][mesh.axis_index(DATA_AXIS)]
    trainer._batch_draws = lambda epoch, step, data_index=0: replayed_draws(mine[(epoch, step)])
    evals = iter(case["eval_draws"])
    trainer._eval_draws = lambda count: replayed_draws(next(evals))
    out = []
    for _ in range(case["epochs"]):
        stats = trainer.train_epoch()
        out.append({k: stats[k] for k in ("loss", "state_losses", "collectives_per_batch",
                                          "batches_run", "max_batches")}
                   | {"params": tree_map(lambda t: t.detach().numpy().copy(), trainer.params),
                      "slots": tree_map(lambda t: t.numpy().copy(), trainer.opt_state.slots),
                      "step": trainer.opt_state.step})
    return {"epochs": out, "eval": trainer.evaluate_nodes(case["eval_nodes"]),
            "hop_caps": trainer.hop_caps, "eval_caps": trainer._eval_caps}


def run_nc_buffer_refusals(case, mesh):
    """The messages of the trainer's two mesh refusals: an EMBEDDING
    co-buffer, and a batch the data axis does not divide."""
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig as L

    out = {}
    model = nc_buffer_model(case)
    emb = dataclasses.replace(model, encoder=EncoderConfig(
        ((L("FEATURE", output_dim=8), L("EMBEDDING", output_dim=4)),)
        + model.encoder.stages[1:]))
    for name, changes in (("embedding", {"model": emb}),
                          ("batch", {"batch_size": case["batch_size"] + 1})):
        try:
            nc_buffer_trainer(case, mesh, **changes)
        except ValueError as e:
            out[name] = str(e)
    return out


def run_nc_buffer_manager(case):
    """marius_train of a PARTITION_BUFFER NC config on this process group's
    mesh (rank 0 writes the model), then marius_eval of that checkpoint."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train

    result = marius_train(load_config(case["raw"]), device="cpu")
    trainer = result["runtime"].trainer
    out = {"test": result["test"], "losses": [e["loss"] for e in result["epochs"]],
           "collectives_per_batch": [e["collectives_per_batch"] for e in result["epochs"]],
           "mesh": trainer.mesh.shape, "trainer": type(trainer).__name__,
           "hop_caps": trainer.hop_caps}
    torch.distributed.barrier()
    out["eval"] = marius_eval(load_config(case["raw"]), device="cpu")["test"]
    return out


def ring_meshes(world):
    """The ring's meshes over ``world`` ranks, each with its ring axis:
    ``{data: 1, node: world}`` and ``{data: world, node: 1}``."""
    from marius_tpu_torch.parallel.mesh import DATA_AXIS, NODE_AXIS, make_mesh

    for shape in ((1, world), (world, 1)):
        yield shape, make_mesh(*shape, device="cpu", timeout=TIMEOUT), (
            NODE_AXIS if shape[1] > 1 else DATA_AXIS)


class ReplayKey:
    """A ``DropoutKey`` whose masks come from a dict keyed by the fold path
    (the test process computes JAX's ``bernoulli(fold_in(...))`` for each)."""

    def __init__(self, masks, path=()):
        self.masks, self.path = masks, path

    def fold(self, data):
        return ReplayKey(self.masks, self.path + (int(data),))

    def keep(self, shape, q, device):
        mask = torch.from_numpy(self.masks[self.path])
        assert tuple(mask.shape) == tuple(shape), (self.path, mask.shape, shape)
        return mask.to(device)


def run_ring_ops(case):
    """The three rings' ops on this rank's rows, on both meshes: the SAGE sum
    and its vjp, RGCN's sum with dx and dW (this rank's dW summed over the
    axis), GAT's max pass and its sum pass with the gradients in l, r and t,
    without and with dropout."""
    from marius_tpu_torch.data import full_graph_rel as fr
    from marius_tpu_torch.data import full_graph_sharded as fs

    out = {}

    def rows(a, n_loc, i):
        return fs.shard_rows(a, n_loc, i, "cpu")

    for shape, mesh, axis in ring_meshes(torch.distributed.get_world_size()):
        i, s = mesh.axis_index(axis), mesh.shape[axis]
        res = {}
        sg = fs.place_on_mesh(fs.build_sharded_full_graph(case["edges"], case["n"], s), mesh,
                              axis)
        x = rows(case["x"], sg.n_loc, i).requires_grad_(True)
        y = fs.make_nbr_sum_sharded(sg, mesh, axis)(x)
        g, = torch.autograd.grad(y, x, rows(case["u"], sg.n_loc, i))
        res["sage"] = (y.detach().numpy(), g.numpy())

        srg = fs.place_on_mesh(fr.build_sharded_rel_graph(case["rel_edges"], case["rel_n"], s),
                               mesh, axis)
        xr = rows(case["rel_x"], srg.n_loc, i).requires_grad_(True)
        w = torch.from_numpy(case["rel_w"]).requires_grad_(True)
        out_r = fr.make_rel_sum_sharded(srg, mesh, axis)(xr, w)
        dx, dw = torch.autograd.grad(out_r, (xr, w), rows(case["rel_cot"], srg.n_loc, i))
        mesh.all_reduce(dw, axis)
        res["rgcn"] = (out_r.detach().numpy(), dx.numpy(), dw.numpy())

        ring = fs.make_gat_ring(sg, mesh, axis)
        l_vec, r_vec, t = (rows(case[k], sg.n_loc, i).requires_grad_(True)
                           for k in ("l", "r", "t"))
        m = rows(case["m"], sg.n_loc, i)
        res["gat_max"] = (ring.max(l_vec, r_vec, case["slope"]).numpy(),)
        for name, key in (("gat_sum", None), ("gat_sum_drop", ReplayKey(case["masks"]))):
            denom, numer = ring.sum(l_vec, r_vec, t, m, case["slope"], case["drop"], key)
            grads = torch.autograd.grad((denom, numer), (l_vec, r_vec, t),
                                        (rows(case["g_denom"], sg.n_loc, i),
                                         rows(case["g_numer"], sg.n_loc, i)))
            res[name] = tuple(a.detach().numpy() for a in (denom, numer) + grads)
        res["collectives"], res["ring_bytes"] = mesh.collectives, mesh.ring_bytes
        out[shape] = res
    return out


def run_ring_gat_layer(case):
    """The sharded GAT layer in training with input, attention and
    self-attention dropout (JAX's masks replayed): this rank's output rows
    and input gradient, and the parameters' gradients summed over the axis."""
    from marius_tpu_torch.data import full_graph_sharded as fs
    from marius_tpu_torch.nn.full_graph_encoder import _sharded_gat
    from marius_tpu_torch.nn.layers import LayerConfig

    out = {}
    for shape, mesh, axis in ring_meshes(torch.distributed.get_world_size()):
        i, s = mesh.axis_index(axis), mesh.shape[axis]
        sg = fs.place_on_mesh(fs.build_sharded_full_graph(case["edges"], case["n"], s), mesh,
                              axis)
        ops = {"gat_ring": fs.make_gat_ring(sg, mesh, axis)}
        x = fs.shard_rows(case["x"], sg.n_loc, i, "cpu").requires_grad_(True)
        p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in case["params"].items()}
        y = _sharded_gat(LayerConfig(**case["layer"]), p, x, ops, True,
                         ReplayKey(case["masks"]))
        names = sorted(p)
        grads = torch.autograd.grad(y, [x] + [p[k] for k in names],
                                    fs.shard_rows(case["cot"], sg.n_loc, i, "cpu"))
        for g in grads[1:]:
            mesh.all_reduce(g, axis)
        out[shape] = {"rows": (y.detach().numpy(), grads[0].numpy()),
                      "params": {k: g.numpy() for k, g in zip(names, grads[1:])}}
    return out


def ring_model(case):
    """The case's port model from its stage specs (LayerConfig keywords)."""
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import Model

    stages = tuple(tuple(LayerConfig(**spec) for spec in stage) for stage in case["stages"])
    return Model("NODE_CLASSIFICATION", EncoderConfig(stages), None,
                 loss_type="CROSS_ENTROPY", loss_reduction=case["reduction"])


def ring_trainer(case, mesh=None):
    """The case's full-graph trainer from JAX's initial state (on ``mesh``:
    the ring; else one device's all-N trainer)."""
    from marius_tpu_torch.convert import train_state_from_jax
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    edges, n, r = case["edges"], case["num_nodes"], case["num_rels"]
    kw = {"fg_seed_restrict": False} if mesh is None else {"fg_linear_collapse": False}
    trainer = NodeClassificationTrainer(
        ring_model(case), build_device_graph(edges, n, r, device="cpu"), case["features"],
        case["labels"], case["train"], [], batch_size=case["batch_size"], seed=0, mesh=mesh,
        device="cpu", full_graph=build_full_graph_adjacency(edges, n, with_relations=r > 1),
        **kw)
    trainer.load_gathered_state(train_state_from_jax(case["jax_state"]))
    return trainer


def ring_batches(trainer, case):
    """Per batch of the case's permutation: the loss, and after the first
    the encoder's leaves (JAX's order)."""
    b, nb = case["batch_size"], trainer.num_batches
    perm = torch.from_numpy(case["perm"]).long()
    shuffled = trainer.train_nodes[perm].reshape(nb, b)
    masks = (perm < trainer.num_train).reshape(nb, b)
    losses, leaves = [], None
    for i in range(case["batches"]):
        losses.append(float(trainer._batch_step(shuffled[i], masks[i], None)))
        if i == 0:
            leaves = [layer[k].detach().numpy().copy()
                      for stage in trainer.state.params["encoder"] for layer in stage
                      for k in sorted(layer)]
    return losses, leaves


def run_ring_trainer(case):
    """The ring trainer on both meshes and one device's trainer: losses,
    leaves after the first batch, accuracy and predicted labels after the
    batches, the ring's collectives and bytes per batch."""
    from marius_tpu_torch.train.nc import NodeClassificationEvaluator

    out = {}
    for shape, mesh, axis in ring_meshes(torch.distributed.get_world_size()):
        trainer = ring_trainer(case, mesh)
        c0, b0 = mesh.collectives, mesh.ring_bytes
        losses, leaves = ring_batches(trainer, case)
        ev = NodeClassificationEvaluator(trainer, case["eval_nodes"])
        out[shape] = {"losses": losses, "leaves": leaves, "axis": trainer._ring_axis,
                      "ops": sorted(trainer._fg_ops),
                      "collectives_per_batch": (mesh.collectives - c0) / case["batches"],
                      "ring_bytes_per_batch": (mesh.ring_bytes - b0) / case["batches"],
                      "accuracy": ev.evaluate(trainer.state)["accuracy"],
                      "labels": ev.predict_labels(trainer.state)}
    one = ring_trainer(case)
    losses, leaves = ring_batches(one, case)
    ev = NodeClassificationEvaluator(one, case["eval_nodes"])
    out["one"] = {"losses": losses, "accuracy": ev.evaluate(one.state)["accuracy"],
                  "labels": ev.predict_labels(one.state)}
    return out


def run_ring_manager(case):
    """marius_train on this process group's {data: 1, node: 4} mesh, then
    marius_eval of the checkpoint rank 0 wrote; rank 0 also trains the
    config without the mesh in this one process."""
    import copy

    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train

    result = marius_train(load_config(case["raw"]), device="cpu")
    trainer = result["runtime"].trainer
    out = {"test": result["test"], "losses": [e["loss"] for e in result["epochs"]],
           "ring_axis": trainer._ring_axis, "gat": "gat_ring" in trainer._fg_ops,
           "mesh": trainer.mesh.shape}
    torch.distributed.barrier()
    out["eval"] = marius_eval(load_config(case["raw"]), device="cpu")["test"]
    if torch.distributed.get_rank() == 0:
        raw = copy.deepcopy(case["raw"])
        del raw["training"]["mesh"]
        raw["storage"]["model_dir"] += "_one"
        one = marius_train(load_config(raw), device="cpu")
        out["one"] = {"test": one["test"], "losses": [e["loss"] for e in one["epochs"]]}
    return out


def main(rank, world, init_file, cases, out_dir):
    from marius_tpu_torch.parallel import multihost
    from marius_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    multihost.initialize(f"file://{init_file}", world, rank, device="cpu", timeout=TIMEOUT)
    try:
        results = {}
        for name, case in cases.items():
            if case["kind"] == "collectives":
                results[name] = run_collectives(case)
            elif case["kind"] == "manager":
                results[name] = run_manager(case)
            elif case["kind"] == "buffer":
                mesh = make_mesh(case["mesh"][0], case["mesh"][1], device="cpu",
                                 timeout=TIMEOUT)
                results[name] = run_buffer(case, mesh)
            elif case["kind"] == "buffer_manager":
                results[name] = run_buffer_manager(case)
            elif case["kind"] == "nc":
                results[name] = run_nc(case, make_mesh(case["mesh"][0], case["mesh"][1],
                                                       device="cpu", timeout=TIMEOUT))
            elif case["kind"] == "nc_buffer":
                results[name] = run_nc_buffer(case, make_mesh(*case["mesh"], device="cpu",
                                                              timeout=TIMEOUT))
            elif case["kind"] == "nc_buffer_refusals":
                results[name] = run_nc_buffer_refusals(case, make_mesh(
                    *case["mesh"], device="cpu", timeout=TIMEOUT))
            elif case["kind"] == "nc_buffer_manager":
                results[name] = run_nc_buffer_manager(case)
            elif case["kind"] == "nc_routes":
                results[name] = run_nc_routes(case)
            elif case["kind"] == "nc_manager":
                results[name] = run_nc_manager(case)
            elif case["kind"] == "ring_ops":
                results[name] = run_ring_ops(case)
            elif case["kind"] == "ring_gat_layer":
                results[name] = run_ring_gat_layer(case)
            elif case["kind"] == "ring_trainer":
                results[name] = run_ring_trainer(case)
            elif case["kind"] == "ring_manager":
                results[name] = run_ring_manager(case)
            else:
                mesh = make_mesh(case["mesh"][0], case["mesh"][1], device="cpu",
                                 timeout=TIMEOUT)
                results[name] = run_trainer(case, mesh)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        multihost.shutdown()
