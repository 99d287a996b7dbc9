"""Full-graph encoder forward: every stage over ALL nodes at once.

Port of ``marius_tpu/nn/full_graph_encoder.py`` on one device
(supports_full_graph, encoder_has_rgcn, supports_seed_restrict and
final_stage_has_rgcn :57-108, prepare_full_graph :127-169, AffineConst
:45-54, _const_first_agg and _resolve_const :229-302, _full_graph_sage,
_full_graph_gcn and _full_graph_rgcn :305-339, _full_graph_gat :391-505,
_seed_sage, _seed_gcn, _seed_rgcn and _seed_gat :508-616,
full_graph_encoder_forward :619-745; the node-sharded ring's
_ShardedAdjView, supports_sharded_full_graph and
prepare_sharded_full_graph :173-220 and _sharded_gat :342-386). Each GNN
stage aggregates over the
whole adjacency, so a node's output equals the sampled path's under
unbounded ALL sampling:

- GraphSAGE and GCN through ``data/full_graph.py``'s neighbour sum (one
  gather-sum kernel call per pass, forward and backward);
- GAT (gat_layer.cpp:49-142: the node itself in the softmax) bucket by
  bucket over the gathered slot blocks (``make_gather_blocks``, whose
  backward is one gather-sum call over the inverse occurrence map), in the
  sampled layer's two exact forms;
- RGCN (rgcn_layer.cpp) through the relation-bucketed batched matmul of
  ``data/full_graph_rel.py`` (two gather-sum calls per pass), which needs
  the adjacency built with ``with_relations=True``.

The final stage can run for a batch's seeds only, over their flat
neighbour lists (``seed_restrict``). The JAX package's ``sorted_space`` mode
(a TPU trade that drops a permutation gather per pass) has no counterpart:
the kernel writes each degree-sorted row straight to its original-order row.
A learnable EMBEDDING input (the whole (N, d) table: GNN link prediction's
exact-ALL evaluation) and REDUCTION layers run as in the sampled encoder.
Dropout keys follow JAX's: ``fold(i x 101 + j)`` per GAT layer, then
``fold(0)`` for input dropout and ``fold(1000 + b)`` per bucket (all-N) or
``fold(1)`` / ``fold(2)`` for the slots and the seeds (seed-restricted).

**On a node-sharded mesh** (``prepare_sharded_full_graph``) the forward
runs on this rank's n_loc rows of every activation: the neighbour sum is
the ring of ``data/full_graph_sharded.py``, GAT its two-pass ring
(``_sharded_gat``: L, R and the values computed on local rows, only R and
the values rotating), RGCN the two-schedule ring of
``data/full_graph_rel.py``; the degree vectors are this rank's padded rows
(``_ShardedAdjView``). GAT's input and self-attention dropout masks have
the global (S x n_loc, .) shape, of which each rank takes its own rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from marius_tpu_torch.data.full_graph import (
    FullGraphAdjacency,
    build_inverse_map,
    make_gather_blocks,
    make_nbr_sums,
    make_permuters,
)
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.layers import (
    DropoutKey,
    LayerConfig,
    attention_dropout,
    dropout,
    embedding_layer,
    feature_layer,
    gat_head_dim,
    gat_heads_out,
    post_hook,
    reduction_layer,
)
from marius_tpu_torch.ops.segment import masked_softmax, segment_softmax, segment_sum

Tensor = torch.Tensor

# the GNN layer types the full-graph path runs; each of them can also be the
# seed-restricted final stage
SUPPORTED_GNN = {"GRAPH_SAGE", "GCN", "GAT", "RGCN"}
# _seed_rgcn forms a (batch, R, d_in) per-(seed, relation) sum; past this
# R x d_in the all-N final stage is the better trade
SEED_RGCN_MAX_R_DIN = 262_144


@dataclasses.dataclass(frozen=True)
class AffineConst:
    """A precomputed first-stage aggregation that still depends on the live
    stage-0 FEATURE bias: resolve as base + count*bias (_const_first_agg)."""

    base: Tensor
    count: Tensor


@dataclasses.dataclass(frozen=True)
class RgcnBlocks:
    """A first RGCN stage's slot gather of the constant input, cached once:
    only the relation transform and the anchor sum run live."""

    flat: Tensor


def _gnn_layers(config: EncoderConfig):
    return [l for s in config.stages for l in s if l.layer_type.upper() == "GNN"]


def _has_gnn(config: EncoderConfig, gnn_type: str) -> bool:
    return any(l.gnn_type.upper() == gnn_type for l in _gnn_layers(config))


class _ShardedAdjView:
    """The adjacency fields the forward reads on a node-sharded mesh: this
    rank's (n_loc,) in- and out-degree rows (padding rows 0)."""

    def __init__(self, in_deg: Tensor, out_deg: Tensor, num_nodes: int):
        self.in_deg, self.out_deg, self.num_nodes = in_deg, out_deg, num_nodes


def supports_sharded_full_graph(config: EncoderConfig) -> bool:
    """The ring covers GraphSAGE/GCN (the neighbour-sum ring), GAT (the
    two-pass attention ring) and RGCN (the two-schedule relational ring)."""
    return supports_full_graph(config)


def prepare_sharded_full_graph(sharded_graph, config: EncoderConfig, in_deg: Tensor,
                               out_deg: Tensor, mesh, axis: str,
                               features: Optional[Tensor] = None, rel_sharded=None):
    """(adj_view, ops) for ``full_graph_encoder_forward`` on this rank's rows
    of a node-sharded mesh: ``ops["nbr_sum"]`` is the ring over the placed
    ``sharded_graph``, GAT stages add ``ops["gat_ring"]``, RGCN stages
    ``ops["rel_sum"]`` over ``rel_sharded`` (a placed ShardedRelGraph).
    ``features`` (this rank's rows) enable the constant first-stage
    aggregation, run once through the ring."""
    from marius_tpu_torch.data.full_graph_sharded import make_gat_ring, make_nbr_sum_sharded

    if not supports_sharded_full_graph(config):
        raise ValueError("sharded full-graph mode supports GraphSAGE/GCN/GAT/RGCN stages only")
    adj = _ShardedAdjView(in_deg, out_deg, sharded_graph.num_nodes)
    ops = {"nbr_sum": make_nbr_sum_sharded(sharded_graph, mesh, axis)}
    if _has_gnn(config, "GAT"):
        ops["gat_ring"] = make_gat_ring(sharded_graph, mesh, axis)
    if encoder_has_rgcn(config):
        if rel_sharded is None:
            raise ValueError("sharded RGCN needs a ShardedRelGraph: build it with "
                             "build_sharded_rel_graph")
        from marius_tpu_torch.data.full_graph_rel import make_rel_sum_sharded
        ops["rel_sum"] = make_rel_sum_sharded(rel_sharded, mesh, axis)
    ops["const_agg"] = _const_first_agg(adj, config, features, ops["nbr_sum"], ops)
    return adj, ops


def supports_full_graph(config: EncoderConfig) -> bool:
    return all(l.gnn_type.upper() in SUPPORTED_GNN for l in _gnn_layers(config))


def encoder_has_rgcn(config: EncoderConfig) -> bool:
    """Callers build the adjacency with its relational companion
    (``build_full_graph_adjacency(with_relations=True)``) when this holds."""
    return _has_gnn(config, "RGCN")


def supports_seed_restrict(config: EncoderConfig) -> bool:
    """True when the FINAL stage is all seed-capable GNN layers, so training
    can compute it for the batch's seed rows only."""
    if not supports_full_graph(config) or len(config.stages) == 0:
        return False
    last = config.stages[-1]
    if len(last) == 0 or any(l.layer_type.upper() != "GNN" for l in last):
        return False
    return all(l.num_relations * l.input_dim <= SEED_RGCN_MAX_R_DIN
               for l in last if l.gnn_type.upper() == "RGCN")


def final_stage_has_rgcn(config: EncoderConfig) -> bool:
    """Callers also build the directional relational seed lists the
    seed-restricted RGCN stage reads when this holds."""
    return len(config.stages) > 0 and any(
        l.layer_type.upper() == "GNN" and l.gnn_type.upper() == "RGCN"
        for l in config.stages[-1])


def prepare_full_graph(adj: FullGraphAdjacency, config: EncoderConfig,
                       features: Optional[Tensor] = None):
    """(adj, ops) for this adjacency and model: ``ops["nbr_sum"]`` is the
    neighbour sum; with GAT stages the adjacency gains its inverse map and
    ``ops`` the slot gather, the row permutations and the per-bucket slot
    masks; with RGCN stages ``ops["rel_sum"]``. With feature inputs the first
    GNN stage's aggregation is precomputed once (``ops["const_agg"]``, see
    _const_first_agg)."""
    ops = {"nbr_sum": make_nbr_sums(adj)}
    if _has_gnn(config, "GAT"):
        adj = build_inverse_map(adj)
        ops["gather_blocks"] = make_gather_blocks(adj)
        ops["to_sorted"], ops["to_orig"] = make_permuters(adj)
        # each bucket row's slots, then the node itself
        ops["gat_masks"] = tuple(
            torch.cat([b != adj.num_nodes, torch.ones_like(b[:, :1], dtype=torch.bool)],
                      dim=1)[:, :, None] for b in adj.nbrs)
    if encoder_has_rgcn(config):
        if adj.rel is None:
            raise ValueError("RGCN full-graph mode needs the relational companion: build "
                             "the adjacency with with_relations=True")
        from marius_tpu_torch.data.full_graph_rel import RelSum
        ops["rel_sum"] = RelSum(adj.rel)
    ops["const_agg"] = _const_first_agg(adj, config, features, ops["nbr_sum"], ops)
    return adj, ops


@torch.no_grad()
def _const_first_agg(adj, config: EncoderConfig, features, nbr_sum, ops):
    """{(stage, layer): precomputed aggregation} for the first GNN stage.

    When the encoder input is a single FEATURE stage, features are constants
    and the first GNN stage's neighbour sum is computed once here: training
    then runs no layer-1 gathers. A FEATURE stage with a trained bias (and
    no nonlinearity) stays precomputable because aggregation is LINEAR in the
    bias: nbr_sum(x + b) = nbr_sum(x) + count·b, where count is each node's
    real (non-padding) slot tally; such entries are AffineConst(base, count),
    combined with the live bias by _resolve_const. A first RGCN stage without
    that bias caches its slot gather (RgcnBlocks)."""
    if features is None or len(config.stages) < 2:
        return {}
    s0 = config.stages[0]
    if len(s0) != 1 or s0[0].layer_type.upper() != "FEATURE":
        return {}
    bias0 = bool(s0[0].bias)
    if bias0 and s0[0].activation.upper() not in ("", "NONE"):
        return {}  # nonlinear activation after a trained bias: not constant
    current0 = feature_layer(dataclasses.replace(s0[0], bias=False), {}, features)
    num_nbrs = (adj.in_deg + adj.out_deg).to(features.dtype)
    inv_sqrt = 1.0 / torch.sqrt(num_nbrs + 1.0)
    const, rgcn_blocks = {}, None
    for j, layer in enumerate(config.stages[1]):
        if layer.layer_type.upper() != "GNN":
            continue
        g = layer.gnn_type.upper()
        if g == "GRAPH_SAGE":
            base = nbr_sum(current0)
            const[(1, j)] = AffineConst(base, num_nbrs) if bias0 else base
        elif g == "GCN":
            base = nbr_sum(current0 * inv_sqrt[:, None])
            if bias0:
                const[(1, j)] = AffineConst(base, nbr_sum(inv_sqrt[:, None])[:, 0])
            else:
                const[(1, j)] = base
        elif g == "RGCN" and not bias0 and hasattr(ops["rel_sum"], "gather_blocks"):
            # (the ring's relational sum has no cached slot gather)
            if rgcn_blocks is None:
                rgcn_blocks = RgcnBlocks(ops["rel_sum"].gather_blocks(current0))
            const[(1, j)] = rgcn_blocks
    return const


def _resolve_const(const, bias0, idx=None):
    """Materialize a const_agg entry; AffineConst entries fold in the live
    first-stage FEATURE bias. ``idx`` restricts the result to the given rows
    without forming the full-N combination."""
    if isinstance(const, AffineConst):
        if bias0 is None:
            raise ValueError("an affine const_agg entry needs the stage-0 bias")
        base, count = const.base, const.count
        if idx is not None:
            base, count = base[idx], count[idx]
        return base + count[:, None] * bias0
    return const if idx is None else const[idx]


def _full_graph_sage(layer: LayerConfig, p, x, nbr_total, num_nbrs):
    """graph_sage_layer over the full adjacency."""
    if layer.aggregator.upper() == "GCN":
        a = (nbr_total + x) / (num_nbrs + 1.0)[:, None]
        out = a @ p["w1"]
    elif layer.aggregator.upper() == "MEAN":
        a = nbr_total / torch.clamp(num_nbrs, min=1.0)[:, None]
        out = x @ p["w1"] + a @ p["w2"]
    else:
        raise ValueError(f"Unknown GraphSAGE aggregator: {layer.aggregator}")
    return post_hook(layer, p, out)


def _full_graph_gcn(layer: LayerConfig, p, x_scaled_sum, x, num_nbrs):
    """gcn_layer over the full adjacency; neighbours pre-scaled by
    1/sqrt(global_degree+1) before summation."""
    a = x_scaled_sum + x / torch.sqrt(num_nbrs + 1.0)[:, None]
    a = a / torch.sqrt(num_nbrs + 1.0)[:, None]
    return post_hook(layer, p, a @ p["w"])


def _full_graph_rgcn(layer: LayerConfig, p, x, ops, adj, const=None) -> Tensor:
    """rgcn_layer over ALL out-edges: the per-node sum of x[dst] @ W[rel]
    (``rel_sum``) over the real out-degree, plus the self transform.
    ``const``: the constant input's cached slot gather."""
    rel_sum = ops["rel_sum"]
    if const is not None:
        s = rel_sum.from_blocks(const.flat, p["relation_matrices"])
    else:
        s = rel_sum(x, p["relation_matrices"])
    deg = adj.out_deg.to(x.dtype).clamp(min=1.0)
    return post_hook(layer, p, s / deg[:, None] + x @ p["self_matrix"])


def _ring_keep(ring, key, shape, q: float, device) -> Tensor:
    """This rank's rows of a keep-mask of the global (S x n_loc, ...) shape."""
    full = key.keep((ring.num_shards * ring.n_loc,) + tuple(shape[1:]), q, device)
    return full[ring.shard * ring.n_loc:(ring.shard + 1) * ring.n_loc]


def _sharded_gat(layer: LayerConfig, p, x, ops, train: bool, key) -> Tensor:
    """GAT over the ring-sharded full graph (JAX ``_sharded_gat``): logits
    decompose as leaky(L_i + R_j), so L, R and the values are computed on
    this rank's rows and only R and the values rotate. The shift m is
    stopped: softmax's shift invariance keeps the gradient exact without the
    max pass's backward."""
    ring = ops["gat_ring"]
    h, hd = layer.num_heads, gat_head_dim(layer)
    if train and layer.input_dropout > 0 and key is not None:
        q = 1.0 - layer.input_dropout
        x = torch.where(_ring_keep(ring, key.fold(0), x.shape, q, x.device), x / q, 0.0)
    w = p["w"].reshape(x.shape[-1], h, hd)
    t3 = torch.einsum("nd,dhk->nhk", x, w)
    l_vec = torch.einsum("nhk,hk->nh", t3, p["a_l"])
    r_vec = torch.einsum("nhk,hk->nh", t3, p["a_r"])
    t = t3.reshape(x.shape[0], h * hd)
    slope = layer.negative_slope
    m_nbr = ring.max(l_vec.detach(), r_vec.detach(), slope)
    self_logit = torch.nn.functional.leaky_relu(l_vec + r_vec, slope)
    m = torch.maximum(m_nbr, self_logit).detach()
    att_drop = layer.attention_dropout if train and key is not None else 0.0
    denom_nbr, numer_nbr = ring.sum(l_vec, r_vec, t, m, slope, att_drop,
                                    key.fold(1) if att_drop > 0 else None)
    e_self = torch.exp(self_logit - m)
    denom = denom_nbr + e_self
    alpha_self = e_self / denom
    if att_drop > 0:
        q = 1.0 - att_drop
        alpha_self = torch.where(_ring_keep(ring, key.fold(2), alpha_self.shape, q,
                                            x.device), alpha_self / q, 0.0)
    out = numer_nbr.view(-1, h, hd) / denom[:, :, None] + alpha_self[:, :, None] * t3
    return post_hook(layer, p, gat_heads_out(layer, out))


def _full_graph_gat(layer: LayerConfig, p, x, adj, ops, train: bool, key) -> Tensor:
    """gat_layer over the full adjacency, bucket by bucket. Each node's
    combined neighbour slots live in ONE bucket row, so the softmax
    (neighbours + self: the sampled layer's slot set) is a per-bucket masked
    softmax; the neighbour rows' gradients come back through the slot
    gather's inverse-map backward."""
    h, k = layer.num_heads, gat_head_dim(layer)
    if train and key is not None and layer.input_dropout > 0:
        x = dropout(x, layer.input_dropout, key.fold(0))
    d_in = x.shape[-1]
    w = p["w"].reshape(d_in, h, k)
    slope = layer.negative_slope
    to_sorted, gather_blocks = ops["to_sorted"], ops["gather_blocks"]
    project_first = h * k <= d_in
    if project_first:
        t_flat = x @ p["w"]
        blocks = gather_blocks(t_flat)                  # per bucket (n_b, cap, h k)
        t_sorted = to_sorted(t_flat)
    else:
        # per-slot logits are gathered scalars: a_r . (x W) = x . (W a_r)
        wal = torch.einsum("dhk,hk->dh", w, p["a_l"])
        war = torch.einsum("dhk,hk->dh", w, p["a_r"])
        lr_all = x @ war
        blocks = gather_blocks(x)                       # raw (n_b, cap, d_in)
        lr_blocks = gather_blocks(lr_all)               # (n_b, cap, h)
        x_sorted, ll_sorted, lr_sorted = to_sorted(x), to_sorted(x @ wal), to_sorted(lr_all)

    outs, row0 = [], 0
    for b, blk in enumerate(blocks):
        n_b, cap = blk.shape[0], blk.shape[1]
        rows = slice(row0, row0 + n_b)
        row0 += n_b
        if project_first:
            t = blk.view(n_b, cap, h, k)
            t_self = t_sorted[rows].view(n_b, h, k)
            logit_l = torch.einsum("nhk,hk->nh", t_self, p["a_l"])
            logit_r = torch.einsum("nshk,hk->nsh", t, p["a_r"])
            self_r = torch.einsum("nhk,hk->nh", t_self, p["a_r"])
        else:
            logit_l, logit_r, self_r = ll_sorted[rows], lr_blocks[b], lr_sorted[rows]
        logits = torch.cat([logit_l[:, None, :] + logit_r, (logit_l + self_r)[:, None, :]],
                           dim=1)                      # (n_b, cap + 1, h)
        alpha = masked_softmax(torch.nn.functional.leaky_relu(logits, slope),
                               ops["gat_masks"][b].expand_as(logits), dim=1)
        alpha = attention_dropout(layer, alpha, None if key is None else key.fold(1000 + b),
                                  train)
        if project_first:
            out = torch.einsum("nsh,nshk->nhk", alpha[:, :cap], t) + \
                alpha[:, cap][:, :, None] * t_self
        else:
            agg = torch.einsum("nsh,nsd->nhd", alpha[:, :cap], blk) + \
                alpha[:, cap][:, :, None] * x_sorted[rows][:, None, :]
            out = torch.einsum("nhd,dhk->nhk", agg, w)
        outs.append(gat_heads_out(layer, out))
    y_sorted = outs[0] if len(outs) == 1 else torch.cat(outs)
    return post_hook(layer, p, ops["to_orig"](y_sorted))


def _seed_gather(x: Tensor, flat_nbr: Tensor) -> Tensor:
    """The (S, d) flat neighbour rows; padding slots (id N) read 0."""
    n = x.shape[0]
    valid = flat_nbr < n
    return torch.where(valid[:, None], x[flat_nbr.clamp(max=n - 1)], 0.0)


def _seed_sage(layer: LayerConfig, p, x, seeds, flat_nbr, flat_seg, num_nbrs, b: int,
               const_seed):
    """GraphSAGE final stage for the seed rows only: the neighbour sum is a
    segment_sum over the batch's flat CSR slots."""
    if const_seed is not None:
        agg = const_seed
    else:
        agg = segment_sum(_seed_gather(x, flat_nbr), flat_seg, b + 1)[:b]
    return _full_graph_sage(layer, p, x[seeds], agg, num_nbrs[seeds])


def _seed_gcn(layer: LayerConfig, p, x, seeds, flat_nbr, flat_seg, num_nbrs, b: int,
              const_seed):
    if const_seed is not None:
        agg = const_seed
    else:
        scaled = x / torch.sqrt(num_nbrs + 1.0)[:, None]
        agg = segment_sum(_seed_gather(scaled, flat_nbr), flat_seg, b + 1)[:b]
    return _full_graph_gcn(layer, p, agg, x[seeds], num_nbrs[seeds])


def _seed_rgcn(layer: LayerConfig, p, x, seeds, rel_flat, out_deg, b: int) -> Tensor:
    """RGCN final stage for the seed rows only: aggregation is linear, so
    each (seed, relation)'s slots are summed first (one segment_sum over the
    batch's flat out-edge slots) and transformed by one
    (b, R x d_in) x (R x d_in, d_out) matmul."""
    flat_nbr, flat_rel, flat_seg = rel_flat
    r = layer.num_relations
    key = flat_seg.clamp(max=b) * r + flat_rel          # padding -> [b r, b r + r)
    z = segment_sum(_seed_gather(x, flat_nbr), key, b * r + r)[:b * r]
    agg = torch.einsum("bri,rio->bo", z.view(b, r, -1), p["relation_matrices"])
    deg = out_deg[seeds].to(x.dtype).clamp(min=1.0)
    return post_hook(layer, p, agg / deg[:, None] + x[seeds] @ p["self_matrix"])


def _seed_gat(layer: LayerConfig, p, x, seeds, flat_nbr, flat_seg, b: int, num_nodes: int,
              train: bool, key) -> Tensor:
    """GAT final stage over the seeds' flat slots: the softmax over
    neighbours + self is one segment_softmax over the slots with each seed's
    own slot appended (the per-bucket masked softmax's math)."""
    h, k = layer.num_heads, gat_head_dim(layer)
    if train and key is not None and layer.input_dropout > 0:
        x = dropout(x, layer.input_dropout, key.fold(0))
    w = p["w"].reshape(x.shape[-1], h, k)
    t = torch.einsum("sd,dhk->shk", _seed_gather(x, flat_nbr), w)   # (S, h, k)
    t_self = torch.einsum("nd,dhk->nhk", x[seeds], w)               # (b, h, k)
    logit_l = torch.einsum("nhk,hk->nh", t_self, p["a_l"])
    self_r = torch.einsum("nhk,hk->nh", t_self, p["a_r"])
    logit_r = torch.einsum("shk,hk->sh", t, p["a_r"])
    logit_l_pad = torch.cat([logit_l, logit_l.new_zeros((1, h))])
    slope = layer.negative_slope
    slots = flat_nbr.shape[0]
    logits = torch.nn.functional.leaky_relu(
        torch.cat([logit_l_pad[flat_seg] + logit_r, logit_l + self_r]), slope)
    seg = torch.cat([flat_seg, torch.arange(b, device=flat_seg.device)])
    mask = torch.cat([flat_nbr != num_nodes,
                      torch.ones(b, dtype=torch.bool, device=flat_nbr.device)])[:, None]
    alpha = segment_softmax(logits, seg, b + 1, mask)
    alpha_slot, alpha_self = alpha[:slots], alpha[slots:]
    if train and key is not None:
        alpha_slot = attention_dropout(layer, alpha_slot, key.fold(1), train)
        alpha_self = attention_dropout(layer, alpha_self, key.fold(2), train)
    out = segment_sum(alpha_slot[:, :, None] * t, flat_seg, b + 1)[:b] + \
        alpha_self[:, :, None] * t_self                             # (b, h, k)
    return post_hook(layer, p, gat_heads_out(layer, out))


def full_graph_encoder_forward(
    config: EncoderConfig,
    params,
    embeddings: Optional[Tensor],   # (N, emb_dim) all-node block
    features: Optional[Tensor],     # (N, feat_dim) all-node block
    adj: FullGraphAdjacency,
    ops=None,                       # from prepare_full_graph
    train: bool = False,
    dropout_key: Optional[DropoutKey] = None,   # GAT's dropouts
    seed_restrict=None,             # (seeds (b,), flat_nbr (S,), flat_seg (S,)[, rel_flat])
) -> Tensor:
    """Representations for ALL nodes: (N, d_out). With ``seed_restrict``
    (requires supports_seed_restrict(config)), the FINAL stage is computed
    only for the given seed rows and (b, d_out) comes back; an RGCN final
    stage reads the optional 4th element, the seeds' directional relational
    lists (flat_nbr, flat_rel, flat_seg) of ``device_seed_flat_lists_rel``."""
    if ops is None:
        adj, ops = prepare_full_graph(adj, config)
    nbr_sum = ops["nbr_sum"]
    num_nbrs = (adj.in_deg + adj.out_deg).to(
        (embeddings if embeddings is not None else features).dtype)
    if seed_restrict is not None:
        seeds, flat_nbr, flat_seg = seed_restrict[:3]
        rel_flat = seed_restrict[3] if len(seed_restrict) > 3 else None
        nseeds = seeds.shape[0]

    outputs = []
    current: Optional[Tensor] = None
    for i, stage in enumerate(config.stages):
        seed_stage = seed_restrict is not None and i == len(config.stages) - 1
        stage_outputs = []
        for j, layer in enumerate(stage):
            lt = layer.layer_type.upper()
            p = params[i][j]
            if lt == "EMBEDDING":
                stage_outputs.append(embedding_layer(layer, p, embeddings))
                continue
            if lt == "FEATURE":
                stage_outputs.append(feature_layer(layer, p, features))
                continue
            if lt == "REDUCTION":
                stage_outputs.append(reduction_layer(layer, p, outputs))
                continue
            g = layer.gnn_type.upper()
            if lt != "GNN" or g not in SUPPORTED_GNN:
                raise ValueError(f"full-graph mode does not run {lt} {layer.gnn_type}; "
                                 "use the sampled path")
            const = ops.get("const_agg", {}).get((i, j))
            bias0 = params[0][0].get("bias") if const is not None else None
            key = None if dropout_key is None else dropout_key.fold(i * 101 + j)
            if seed_stage:
                if g == "GAT":
                    stage_outputs.append(_seed_gat(layer, p, current, seeds, flat_nbr,
                                                   flat_seg, nseeds, adj.num_nodes, train, key))
                elif g == "RGCN":
                    if rel_flat is None:
                        raise ValueError("a seed-restricted RGCN stage needs the relational "
                                         "seed lists (device_seed_flat_lists_rel)")
                    stage_outputs.append(_seed_rgcn(layer, p, current, seeds, rel_flat,
                                                    adj.out_deg, nseeds))
                else:
                    # a cached RGCN slot gather is all-N: nothing to restrict
                    c_seed = None if const is None else _resolve_const(const, bias0,
                                                                       idx=seeds)
                    seed_fn = _seed_sage if g == "GRAPH_SAGE" else _seed_gcn
                    stage_outputs.append(seed_fn(layer, p, current, seeds, flat_nbr,
                                                 flat_seg, num_nbrs, nseeds, c_seed))
            elif g == "GAT" and "gat_ring" in ops:
                stage_outputs.append(_sharded_gat(layer, p, current, ops, train, key))
            elif g == "GAT":
                stage_outputs.append(_full_graph_gat(layer, p, current, adj, ops, train, key))
            elif g == "RGCN":
                stage_outputs.append(_full_graph_rgcn(layer, p, current, ops, adj, const))
            elif g == "GRAPH_SAGE":
                agg = _resolve_const(const, bias0) if const is not None else nbr_sum(current)
                stage_outputs.append(_full_graph_sage(layer, p, current, agg, num_nbrs))
            else:  # GCN
                if const is None:
                    x_scaled_sum = nbr_sum(current / torch.sqrt(num_nbrs + 1.0)[:, None])
                else:
                    x_scaled_sum = _resolve_const(const, bias0)
                stage_outputs.append(_full_graph_gcn(layer, p, x_scaled_sum, current,
                                                     num_nbrs))
        outputs = stage_outputs
        current = (stage_outputs[0] if len(stage_outputs) == 1
                   else torch.cat(stage_outputs, dim=1))
    return current
