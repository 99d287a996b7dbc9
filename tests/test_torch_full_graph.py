"""The port's full-graph pieces against marius_tpu's, on the CPU.

A power-law graph of 220 nodes (20 of them isolated) with hub rows wider
than 256 slots, features 8-16 wide, 3 GNN stages. Inputs are made from a
seed with numpy and fed to the JAX function and to the port's.

Tolerances:
- the adjacency, the host CSR and the seed lists are integer structures and
  must match exactly;
- the gather-sum adds each row's slots in order in float32; the Pallas
  kernel (interpret mode) sums groups of 8 first and XLA's reduce uses its
  own order, so sums are held to rtol 1e-5, atol 1e-5 (the Pallas test's own
  tolerance), with atol growing as cap / 64 for wider rows: a sum of cap
  terms is rounded cap times (the 700-slot hub rows: atol 1.1e-4 on sums of
  ~200);
- encoder outputs, gradients and the collapsed ``phi`` and logits: rtol
  1e-5, atol 1e-5 — float32 sums in another order than XLA's, through 3
  stages and matmuls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marius_tpu.data import full_graph as jfg
from marius_tpu.nn import full_graph_encoder as jfge
from marius_tpu.nn import linear_collapse as jlc
from marius_tpu.nn.encoder import EncoderConfig as JEncoderConfig
from marius_tpu.nn.layers import LayerConfig as JLayerConfig
from marius_tpu.ops.pallas.nbr_sum import gather_sum_pallas
from marius_tpu_torch.data import full_graph as tfg
from marius_tpu_torch.nn import full_graph_encoder as tfge
from marius_tpu_torch.nn import linear_collapse as tlc
from marius_tpu_torch.nn.encoder import EncoderConfig as TEncoderConfig
from marius_tpu_torch.nn.layers import LayerConfig as TLayerConfig
from marius_tpu_torch.ops.cuda import nbr_sum as tns
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-5
N, N_LINKED, E, F = 220, 200, 2000, 8


def power_law_edges(seed=0, n=N_LINKED, e=E):
    """Uniform sources, Zipf destinations: the first-ranked node gets ~350
    combined slots, so the adjacency has hub rows wider than 256."""
    rng = np.random.default_rng(seed)
    w = (np.arange(n) + 1.0) ** -1.0
    dst = rng.permutation(n)[rng.choice(n, e, p=w / w.sum())]
    return np.stack([rng.integers(0, n, e), dst], 1).astype(np.int32)


@pytest.fixture(scope="module")
def graph():
    edges = power_law_edges()
    return edges, jfg.build_full_graph_adjacency(edges, N), tfg.build_full_graph_adjacency(edges, N)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


# -- the adjacency ------------------------------------------------------------

def test_adjacency_matches_jax_exactly(graph):
    _, jadj, tadj = graph
    assert len(tadj.nbrs) == len(jadj.nbrs) and tadj.total_slots == jadj.total_slots
    assert max(b.shape[1] for b in tadj.nbrs) > tns.MAX_CAP   # hub rows
    assert tadj.nbrs[0].shape[1] == 1 and int(tadj.nbrs[0][0, 0]) == N   # isolated nodes
    for tb, jb in zip(tadj.nbrs, jadj.nbrs):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for name in ("inv_pos", "in_deg", "out_deg"):
        np.testing.assert_array_equal(getattr(tadj, name).numpy(), np.asarray(getattr(jadj, name)))
    assert tadj.bucket_starts == jadj.bucket_starts
    for t, j in zip(tfg.host_csr_from_adjacency(tadj), jfg.host_csr_from_adjacency(jadj)):
        np.testing.assert_array_equal(t, j)


def test_greedy_buckets_match_jax():
    rng = np.random.default_rng(1)
    deg = np.sort(np.minimum(rng.zipf(1.6, 5000), 20000))
    np.testing.assert_array_equal(tfg._greedy_buckets(deg), jfg._greedy_buckets(deg))


def test_adjacency_rejects_later_slices():
    """locality_reorder: the reverse Cuthill-McKee permutation, the buckets
    (slots in locality positions) and the host CSR (back in original ids)
    equal JAX's exactly, and the CSR equals the plain adjacency's; it
    refuses the relational companion and the inverse map, as JAX does.
    with_relations attaches the relational companion RGCN stages read (its
    arrays are held against JAX's in tests/test_torch_rgcn.py)."""
    edges = power_law_edges()
    jl = jfg.build_full_graph_adjacency(edges, N, locality_reorder=True)
    tl = tfg.build_full_graph_adjacency(edges, N, locality_reorder=True)
    np.testing.assert_array_equal(tl.loc_perm.numpy(), np.asarray(jl.loc_perm))
    assert sorted(tl.loc_perm.tolist()) == list(range(N))
    assert len(tl.nbrs) == len(jl.nbrs)
    for tb, jb in zip(tl.nbrs, jl.nbrs):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tl.inv_pos.numpy(), np.asarray(jl.inv_pos))
    plain = tfg.host_csr_from_adjacency(tfg.build_full_graph_adjacency(edges, N))
    for t, j, p in zip(tfg.host_csr_from_adjacency(tl), jfg.host_csr_from_adjacency(jl), plain):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, p)
    assert tl.to("cpu").loc_perm is not None
    with pytest.raises(ValueError, match="locality_reorder"):
        tfg.build_full_graph_adjacency(edges, N, with_relations=True, locality_reorder=True)
    with pytest.raises(ValueError, match="locality_reorder"):
        tfg.build_inverse_map(tl)
    adj = tfg.build_full_graph_adjacency(edges, N, with_relations=True)
    assert adj.rel is not None and adj.rel.num_nodes == N
    assert adj.rel.total_slots >= len(edges) and tfg.build_full_graph_adjacency(edges, N).rel is None


def test_locality_reorder_nc_run_matches_plain_and_jax():
    """tests/test_nc_e2e.py:297-336 in the port: the FEATURE + 2 x GraphSAGE
    MEAN (RELU) model trains 2 epochs full-graph over the locality adjacency
    and over the plain one, from JAX's initial state with JAX's
    permutations. Locality losses are within rtol 2e-5 of the plain
    adjacency's (float32 sums in another order) and within the trainer
    tests' rtol 1e-4 of JAX's locality run; the accuracies are equal."""
    from marius_tpu.data.graph import build_device_graph as j_graph
    from marius_tpu.train import nc as jnc
    from marius_tpu_torch.convert import copy_train_state_, train_state_from_jax
    from marius_tpu_torch.data.graph import build_device_graph as t_graph
    from marius_tpu_torch.nn.model import Model as TModel
    from marius_tpu_torch.nn.optimizers import OptimizerConfig as TOpt
    from marius_tpu_torch.train import nc as tnc
    from tests.test_nc_e2e import FEAT_DIM, NUM_CLASSES, NUM_NODES, _gs_model, community_graph
    from tests.test_torch_nc_trainer import _np_state

    edges, feats, labels = community_graph()
    perm = np.random.default_rng(1).permutation(NUM_NODES)
    train_nodes, test_nodes = perm[:300], perm[300:]
    dims = (FEAT_DIM, 16, NUM_CLASSES)
    tmodel = TModel("NODE_CLASSIFICATION", TEncoderConfig(
        ((TLayerConfig("FEATURE", output_dim=FEAT_DIM),),)
        + tuple((TLayerConfig("GNN", input_dim=dims[i], output_dim=dims[i + 1],
                              gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True,
                              activation="RELU" if i == 0 else "NONE"),) for i in range(2))),
        None, loss_type="CROSS_ENTROPY", loss_reduction="SUM",
        dense_optimizer=TOpt("ADAM", learning_rate=0.01))
    jtr = jnc.NodeClassificationTrainer(
        _gs_model(), j_graph(edges, NUM_NODES), feats, labels, train_nodes, [], batch_size=100,
        seed=0, full_graph=jfg.build_full_graph_adjacency(edges, NUM_NODES,
                                                          locality_reorder=True))
    size = jtr.num_batches * 100
    losses, accs = {}, {}
    for name, loc in (("plain", False), ("locality", True)):
        tr = tnc.NodeClassificationTrainer(
            tmodel, t_graph(edges, NUM_NODES), feats, labels, train_nodes, batch_size=100,
            seed=0, full_graph=tfg.build_full_graph_adjacency(edges, NUM_NODES,
                                                              locality_reorder=loc),
            device="cpu")
        assert (tr.full_graph.loc_perm is not None) == loc and tr._fg_seed_restrict
        tr._epoch_permutation = lambda e: torch.from_numpy(np.array(jax.random.permutation(
            jax.random.fold_in(jax.random.key(54321), e), size))).long()
        copy_train_state_(tr.state, train_state_from_jax(_np_state(jtr.state)))
        losses[name] = [s["loss"] for s in tr.train(2)]
        accs[name] = tnc.NodeClassificationEvaluator(tr, test_nodes).evaluate(tr.state)
    jlosses = [s["loss"] for s in jtr.train(2)]
    jacc = jnc.NodeClassificationEvaluator(jtr, test_nodes).evaluate(jtr.state)
    np.testing.assert_allclose(losses["locality"], losses["plain"], rtol=2e-5)
    np.testing.assert_allclose(losses["locality"], jlosses, rtol=1e-4)
    assert accs["locality"]["accuracy"] == accs["plain"]["accuracy"] == pytest.approx(
        jacc["accuracy"], abs=1e-12)


def test_seed_flat_lists_same_multiset_per_seed(graph):
    _, jadj, tadj = graph
    rng = np.random.default_rng(2)
    b = 24
    seeds = rng.integers(0, N, b)
    mask = rng.random(b) < 0.8
    csr = tfg.host_csr_from_adjacency(tadj)
    need = int(((csr[0][seeds + 1] - csr[0][seeds]) * mask).sum())
    jnbr, jseg = jfg.device_seed_flat_lists(jfg.device_csr(jfg.host_csr_from_adjacency(jadj)),
                                            jnp.asarray(seeds, jnp.int32), jnp.asarray(mask),
                                            need + 37, N)
    jnbr, jseg = np.asarray(jnbr), np.asarray(jseg)
    for budget in (need, need + 37):   # exact, as the trainer builds them, and padded
        tnbr, tseg = tfg.device_seed_flat_lists(tfg.device_csr(csr, "cpu"),
                                                torch.from_numpy(seeds), torch.from_numpy(mask),
                                                budget, N)
        tnbr, tseg = tnbr.numpy(), tseg.numpy()
        assert tnbr.shape == (budget,)
        for r in range(b):
            np.testing.assert_array_equal(np.sort(tnbr[tseg == r]), np.sort(jnbr[jseg == r]))
        assert (tnbr[tseg == b] == N).all() and (tseg == b).sum() == budget - need


# -- the gather-sum -----------------------------------------------------------

@pytest.mark.parametrize("n,cap", [(17, 3), (5, 1), (64, 40), (3, 700)])
def test_gather_sum_plain_matches_pallas_interpret(n, cap):
    rng = np.random.default_rng(3)
    rows, d = 60, 128                       # the Pallas kernel needs d % 128 == 0
    x = rng.standard_normal((rows, d)).astype(np.float32)
    ids = rng.integers(0, rows + 1, (n, cap)).astype(np.int32)   # rows = padding id
    x_pad = np.concatenate([x, np.zeros((1, d), np.float32)])
    ref = gather_sum_pallas(jnp.asarray(x_pad), jnp.asarray(ids), interpret=True)
    before = tns.launches
    out = tns.gather_sum(torch.from_numpy(x), torch.from_numpy(ids))
    assert tns.launches == before   # CPU tensors never launch
    assert out.dtype == torch.float32 and out.shape == (n, d)
    atol = ATOL * max(1.0, cap / 64)
    _close(out, ref, atol=atol)
    _close(out, x_pad[ids].astype(np.float64).sum(1), atol=atol)


def test_gather_sum_plain_bf16_accumulates_in_f32():
    rng = np.random.default_rng(4)
    rows, d = 60, 128
    xb = jnp.asarray((rng.standard_normal((rows, d)) * 0.01).astype(np.float32), jnp.bfloat16)
    ids = rng.integers(0, rows, (4, 50)).astype(np.int32)
    xb_pad = jnp.concatenate([xb, jnp.zeros((1, d), jnp.bfloat16)], 0)
    ref = gather_sum_pallas(xb_pad, jnp.asarray(ids), interpret=True)
    x32 = np.asarray(xb, np.float32)
    out = tns.gather_sum(torch.from_numpy(x32).to(torch.bfloat16), torch.from_numpy(ids))
    assert out.dtype == torch.float32
    # the same bf16 values summed in f32: only the order of the adds differs
    _close(out, ref, rtol=1e-5, atol=1e-6)
    _close(out, x32[ids].astype(np.float64).sum(1), rtol=1e-5, atol=1e-6)


def test_layout_splits_hub_rows_and_writes_each_row_once(graph):
    _, _, tadj = graph
    layout = tfg.nbr_sum_layout(tadj)
    assert int(layout.task_len.max()) == tns.MAX_CAP and layout.num_partials > 0
    dest = torch.cat([layout.task_dest[layout.task_dest >= 0], layout.fold_dest])
    assert torch.equal(torch.sort(dest).values, torch.arange(N, dtype=torch.int32))
    assert layout.ids.numel() == tadj.total_slots
    # the plain version against a float64 sum of each node's neighbours
    x = np.random.default_rng(5).standard_normal((N, 3)).astype(np.float32)
    ref = np.zeros((N, 3))
    edges = power_law_edges()
    np.add.at(ref, edges[:, 1], x[edges[:, 0]])
    np.add.at(ref, edges[:, 0], x[edges[:, 1]])
    _close(tns.nbr_sum_plain(torch.from_numpy(x), layout), ref)


def _mixed_buckets(tadj):
    """The test graph's buckets, then an empty bucket and two all-padding
    buckets (one of them split)."""
    pad = lambda rows, cap: torch.full((rows, cap), N, dtype=torch.int32)
    return list(tadj.nbrs) + [torch.zeros((0, 5), dtype=torch.int32), pad(3, 4), pad(2, 600)]


def test_layout_lists_pieces_first_and_covers_each_slot_once(graph):
    """What the kernel relies on: the split rows' pieces are the first tasks
    (piece task p is partial row p), each split row's pieces are consecutive
    256-slot runs of its slots in order, and the tasks cover every slot
    exactly once."""
    _, _, tadj = graph
    buckets = _mixed_buckets(tadj)
    rows = sum(b.shape[0] for b in buckets)
    layout = tns.bucket_layout(buckets, torch.from_numpy(
        np.random.default_rng(9).permutation(rows)), rows)
    p = layout.num_partials
    start, length = layout.task_start.numpy(), layout.task_len.numpy()
    dest = layout.task_dest.numpy()
    np.testing.assert_array_equal(dest[:p], -np.arange(p) - 1)
    assert (dest[p:] >= 0).all() and (length >= 1).all() and (length <= tns.MAX_CAP).all()
    count, first = layout.fold_count.numpy(), layout.fold_first.numpy()
    assert count.sum() == p and len(count) == 1 + 2   # the graph's hub, 2 all-padding rows
    np.testing.assert_array_equal(first, np.cumsum(count) - count)
    for f, c in zip(first, count):
        np.testing.assert_array_equal(start[f:f + c], start[f] + tns.MAX_CAP * np.arange(c))
        assert (length[f:f + c - 1] == tns.MAX_CAP).all()
    covered = np.zeros(layout.ids.numel(), np.int64)
    for s, n in zip(start, length):
        covered[s:s + n] += 1
    assert (covered == 1).all()
    out_rows = np.concatenate([dest[p:], layout.fold_dest.numpy()])
    np.testing.assert_array_equal(np.sort(out_rows), np.arange(rows))


def test_nbr_sum_plain_on_layout_matches_pallas_interpret(graph):
    """One layout over several buckets (the hub among them, an empty and two
    all-padding ones), rows written in a shuffled order, against the Pallas
    kernel run per bucket in interpret mode."""
    _, _, tadj = graph
    buckets = [b for b in tadj.nbrs if b.shape[1] in (1, 8, 117, 367)] + \
        _mixed_buckets(tadj)[-3:]
    assert len(buckets) == 7
    sizes = [b.shape[0] for b in buckets]
    out_rows = np.random.default_rng(10).permutation(sum(sizes))
    layout = tns.bucket_layout(buckets, torch.from_numpy(out_rows), sum(sizes))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, 128)).astype(np.float32)   # the Pallas kernel needs d % 128 == 0
    x_pad = jnp.asarray(np.concatenate([x, np.zeros((1, 128), np.float32)]))
    ref = np.zeros((sum(sizes), 128), np.float32)
    ref[out_rows] = np.concatenate([np.asarray(gather_sum_pallas(x_pad, jnp.asarray(b.numpy()),
                                                                 interpret=True))
                                    if b.shape[0] else np.zeros((0, 128), np.float32)
                                    for b in buckets])
    _close(tns.nbr_sum_plain(torch.from_numpy(x), layout), ref,
           atol=ATOL * max(b.shape[1] for b in buckets) / 64)


@pytest.mark.parametrize("sorted_space", [False, True, "locality"],
                         ids=["original", "sorted", "locality"])
def test_nbr_sum_matches_jax_forward_and_vjp(graph, sorted_space):
    """The sum and its vjp in original order; "locality" sums over the
    locality-reordered adjacency in both packages (the permutation gathers
    forward and backward)."""
    _, jadj, tadj = graph
    if sorted_space == "locality":
        edges = power_law_edges()
        jadj = jfg.build_full_graph_adjacency(edges, N, locality_reorder=True)
        tadj = tfg.build_full_graph_adjacency(edges, N, locality_reorder=True)
        sorted_space = False
    rng = np.random.default_rng(6)
    d = 16
    x = rng.standard_normal((N, d)).astype(np.float32)
    u = rng.standard_normal((N, d)).astype(np.float32)
    inv_pos = np.asarray(jadj.inv_pos)
    perm = np.argsort(inv_pos, kind="stable")
    jfn = jfg.make_nbr_sums(jadj, sorted_space=sorted_space)
    if sorted_space:   # JAX rows in degree-sorted order; map back to original order
        jy, jvjp = jax.vjp(jfn, jnp.asarray(x[perm]))
        jy, jg = np.asarray(jy)[inv_pos], np.asarray(jvjp(jnp.asarray(u[perm]))[0])[inv_pos]
    else:
        jy, jvjp = jax.vjp(jfn, jnp.asarray(x))
        jg = jvjp(jnp.asarray(u))[0]
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tfg.make_nbr_sums(tadj)(tx)
    ty.backward(torch.from_numpy(u))
    _close(ty, jy)
    _close(tx.grad, jg)


# -- the encoder and the collapse --------------------------------------------

def tlayers_init(cfg):
    """The last stage's parameters, from a seeded generator."""
    from marius_tpu_torch.nn.layers import init_layer_params
    return init_layer_params(torch.Generator().manual_seed(0), cfg.stages[-1][0])


GNN_KINDS = {"sage-mean": ("GRAPH_SAGE", "MEAN"), "sage-gcn": ("GRAPH_SAGE", "GCN"),
             "gcn": ("GCN", "MEAN")}
DIMS = (F, 16, 16, 5)


def _stages(layer_cls, kind, activation="NONE"):
    gnn_type, agg = GNN_KINDS[kind]
    stages = [(layer_cls("FEATURE", output_dim=F, bias=True),)]
    for din, dout in zip(DIMS[:-1], DIMS[1:]):
        stages.append((layer_cls("GNN", input_dim=din, output_dim=dout, gnn_type=gnn_type,
                                 aggregator=agg, bias=True, activation=activation),))
    return tuple(stages)


def _params(kind, rng):
    """The same random params as JAX and torch pytrees."""
    gnn_type, agg = GNN_KINDS[kind]
    stages = [{"bias": rng.standard_normal(F).astype(np.float32) * 0.1}]
    for din, dout in zip(DIMS[:-1], DIMS[1:]):
        names = ["w1", "w2"] if (gnn_type, agg) == ("GRAPH_SAGE", "MEAN") else \
            (["w1"] if gnn_type == "GRAPH_SAGE" else ["w"])
        p = {k: (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
             for k in names}
        p["bias"] = rng.standard_normal(dout).astype(np.float32) * 0.1
        stages.append(p)
    jp = [[{k: jnp.asarray(v) for k, v in p.items()}] for p in stages]
    tp = [[{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}] for p in stages]
    return jp, tp


@pytest.mark.parametrize("kind", list(GNN_KINDS))
@pytest.mark.parametrize("seed_restrict", [False, True], ids=["all-n", "seed-restrict"])
def test_full_graph_encoder_matches_jax(graph, kind, seed_restrict):
    _, jadj, tadj = graph
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    jp, tp = _params(kind, rng)
    jcfg = JEncoderConfig(_stages(JLayerConfig, kind, "RELU"))
    tcfg = TEncoderConfig(_stages(TLayerConfig, kind, "RELU"))
    jadj2, jops = jfge.prepare_full_graph(jadj, jcfg, jnp.asarray(feats))
    tadj2, tops = tfge.prepare_full_graph(tadj, tcfg, torch.from_numpy(feats))
    assert jops.get("sorted") and isinstance(tops["const_agg"][(1, 0)], tfge.AffineConst)

    b = 30
    seeds = rng.integers(0, N, b)
    mask = np.ones(b, bool)
    jsr = tsr = None
    if seed_restrict:
        csr = tfg.host_csr_from_adjacency(tadj)
        need = int((csr[0][seeds + 1] - csr[0][seeds]).sum())
        tnbr, tseg = tfg.device_seed_flat_lists(tfg.device_csr(csr, "cpu"),
                                                torch.from_numpy(seeds), torch.from_numpy(mask),
                                                need, N)
        tsr = (torch.from_numpy(seeds), tnbr, tseg)
        # JAX runs this model in its degree-sorted row space: seed lists hold sorted rows
        inv_ext = np.append(np.asarray(jadj.inv_pos), N).astype(np.int32)
        jsr = (jnp.asarray(seeds, jnp.int32), jnp.asarray(inv_ext[tnbr.numpy()]),
               jnp.asarray(tseg.numpy().astype(np.int32)))
    w = rng.standard_normal((b if seed_restrict else N, DIMS[-1])).astype(np.float32)

    def jloss(p):
        out = jfge.full_graph_encoder_forward(jcfg, p, None, jnp.asarray(feats), jadj2,
                                              ops=jops, train=True, seed_restrict=jsr)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    tout = tfge.full_graph_encoder_forward(tcfg, tp, None, torch.from_numpy(feats), tadj2,
                                           ops=tops, seed_restrict=tsr)
    (tout * torch.from_numpy(w)).sum().backward()
    _close(tout, jout)
    for tstage, jstage in zip(tp, jgrad):
        for k, t in tstage[0].items():
            _close(t.grad, jstage[0][k])


def test_full_graph_encoder_rejects_later_slices(graph):
    """GAT and RGCN stages run on the full-graph path now (held against JAX in
    tests/test_torch_gat.py and tests/test_torch_rgcn.py): GAT prepares the
    inverse map, RGCN needs the relational companion; a registered layer
    type still has no full-graph form."""
    edges, _, tadj = graph
    for gnn in ("GAT", "RGCN"):
        cfg = TEncoderConfig(((TLayerConfig("FEATURE", output_dim=F),),
                              (TLayerConfig("GNN", input_dim=F, output_dim=4, gnn_type=gnn),)))
        assert tfge.supports_full_graph(cfg) and tfge.supports_seed_restrict(cfg)
        adj = tfg.build_full_graph_adjacency(edges, N, with_relations=gnn == "RGCN")
        adj2, ops = tfge.prepare_full_graph(adj, cfg, torch.zeros(N, F))
        assert (adj2.inv_map is not None) == (gnn == "GAT") and ("rel_sum" in ops) == (gnn == "RGCN")
        params = [[{}], [{k: v.requires_grad_(True) for k, v in tlayers_init(cfg).items()}]]
        out = tfge.full_graph_encoder_forward(cfg, params, None, torch.zeros(N, F), adj2, ops=ops)
        assert out.shape == (N, 4)
    with pytest.raises(ValueError, match="with_relations"):
        tfge.prepare_full_graph(tadj, TEncoderConfig(((TLayerConfig("FEATURE", output_dim=F),), (
            TLayerConfig("GNN", input_dim=F, output_dim=4, gnn_type="RGCN"),))))
    custom = TEncoderConfig(((TLayerConfig("FEATURE", output_dim=F),),
                             (TLayerConfig("GNN", input_dim=F, output_dim=4, gnn_type="MINE"),)))
    assert not tfge.supports_full_graph(custom) and not tfge.supports_seed_restrict(custom)
    # a learnable EMBEDDING input is ported: an EMBEDDING stage over the
    # table runs the GNN stages as a FEATURE stage over the same block does,
    # and as JAX's full-graph encoder does
    rng = np.random.default_rng(7)
    jp, tp = _params("gcn", rng)
    block = rng.standard_normal((N, F)).astype(np.float32)
    emb_stages = lambda L: ((L("EMBEDDING", output_dim=F, bias=True),),) + \
        _stages(L, "gcn")[1:]  # noqa: E731
    tout = tfge.full_graph_encoder_forward(TEncoderConfig(emb_stages(TLayerConfig)), tp,
                                           torch.from_numpy(block), None, tadj)
    _close(tout, tfge.full_graph_encoder_forward(TEncoderConfig(_stages(TLayerConfig, "gcn")),
                                                 tp, None, torch.from_numpy(block), tadj))
    _, jadj, _ = graph
    _close(tout, jfge.full_graph_encoder_forward(JEncoderConfig(emb_stages(JLayerConfig)), jp,
                                                 jnp.asarray(block), None, jadj))


@pytest.mark.parametrize("kind", list(GNN_KINDS))
def test_linear_collapse_matches_jax(graph, kind):
    _, jadj, tadj = graph
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    jp, tp = _params(kind, rng)
    jcfg = JEncoderConfig(_stages(JLayerConfig, kind))
    tcfg = TEncoderConfig(_stages(TLayerConfig, kind))
    assert tlc.linear_collapse_eligible(tcfg, True) == jlc.linear_collapse_eligible(jcfg, True)
    assert not tlc.linear_collapse_eligible(TEncoderConfig(_stages(TLayerConfig, kind, "RELU")),
                                            True)
    jcol = jlc.build_linear_collapse(jadj, jcfg, jnp.asarray(feats))
    tcol = tlc.build_linear_collapse(tadj, tcfg, torch.from_numpy(feats))
    assert tcol.kinds == jcol.kinds and tcol.phi.shape == jcol.phi.shape
    _close(tcol.phi, jcol.phi)
    rows = rng.integers(0, N, 40)
    _close(tcol.logits(tp, torch.from_numpy(rows)), jcol.logits(jp, jnp.asarray(rows)))
    # the collapsed form equals the layerwise network it replaces
    _, tops = tfge.prepare_full_graph(tadj, tcfg, torch.from_numpy(feats))
    layerwise = tfge.full_graph_encoder_forward(tcfg, tp, None, torch.from_numpy(feats), tadj,
                                                ops=tops)
    _close(tcol.logits_all(tp), layerwise, rtol=1e-4, atol=1e-4)
