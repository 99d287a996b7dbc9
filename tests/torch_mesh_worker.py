"""One rank of the gloo process group that ``tests/test_torch_mesh.py``
spawns: it runs the port's side of every mesh case on the CPU and saves its
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
    """The case's port model: DistMult over EMBEDDING, EMBEDDING + FEATURE, or
    EMBEDDING and a GraphSAGE MEAN layer (dense Adagrad at lr 0.1 and the
    table at 0.02: ROADMAP C5)."""
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
    if case.get("gnn"):
        stages += ((LayerConfig("GNN", input_dim=d, output_dim=d, gnn_type="GRAPH_SAGE",
                                aggregator="MEAN", bias=True),),)
        kw = dict(dense_optimizer=OptimizerConfig("ADAGRAD", learning_rate=0.1), sparse_lr=0.02)
    model = Model("LINK_PREDICTION", EncoderConfig(stages), EdgeDecoder("DISTMULT", r, d), **kw)
    return dataclasses.replace(model, loss_reduction=case["reduction"])


def lp_trainer(case, mesh=None):
    """The case's trainer, its negatives and permutations injected, from the
    JAX initial state when the case carries one."""
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
    perms = case["perms"]
    trainer._epoch_permutation = lambda e: torch.tensor(perms[e], dtype=torch.long)
    if case.get("jax_state") is not None:
        trainer.load_gathered_state(train_state_from_jax(case["jax_state"]))
    return trainer


def run_trainer(case, mesh=None):
    """Per epoch: the loss, the table (values, Adagrad state) in the
    single-device layout, the relations, and the collectives per batch."""
    trainer = lp_trainer(case, mesh)
    out = []
    for _ in range(case["epochs"]):
        stats = trainer.train_epoch()
        full = trainer.gathered_state()
        # copies: on one device these are the trainer's own tensors
        out.append({"loss": stats["loss"], "values": full.table.values.float().numpy().copy(),
                    "state": full.table.state.float().numpy().copy(),
                    "relations": full.params["decoder"]["relations"].detach().float()
                    .numpy().copy(),
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
            else:
                mesh = make_mesh(case["mesh"][0], case["mesh"][1], device="cpu",
                                 timeout=TIMEOUT)
                results[name] = run_trainer(case, mesh)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        multihost.shutdown()
