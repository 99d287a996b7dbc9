"""Encoder layers: embedding and feature column slices, the sampled
GraphSAGE, GCN, GAT and RGCN layers, reductions, bias + activation.

Port of ``marius_tpu/nn/layers/layers.py`` (LayerConfig :37-59,
apply_activation and post_hook :61-77, init_layer_params :85-132,
embedding_layer and feature_layer :140-149, _gather_neighbors :152-157,
graph_sage_layer :160-174, gcn_layer :177-198, gat_layer :201-278,
rgcn_layer :281-309, reduction_layer :312-319; reference embedding.cpp:17,
feature.cpp:15, graph_sage_layer.cpp:37-97, gcn_layer.cpp,
gat_layer.cpp:49-142, rgcn_layer.cpp, concat.cpp, linear.cpp,
layer.cpp:9-16). Weights are stored (d_in, d_out) and applied as x @ w.

The sampled layers aggregate over the padded-fanout ``LayerAdjacency``.
SAGE and GCN take one gather-sum kernel call (``ops/segment.py``
``sampled_nbr_sum``) where the JAX layers gather an (n, F, d) block and take
a masked sum; GCN's per-slot factor 1/sqrt(deg + 1) belongs to the outer
node a slot points at, so it scales x's rows before the sum. RGCN sums each
target's out-slots per relation first (``relational_nbr_sum``, one
gather-sum call) and applies every relation's matrix in one matmul over the
(n, R x d_in) sums, the linear map of JAX's masked loop of R per-slot
matmuls; past 64 relations it gathers a matrix per slot as JAX does. GAT
weighs each slot, so it gathers its (n, S + 1) slot block (self last)
through the row-gather kernel (``slot_gather``) in JAX's two exact forms.
Dropout masks come from a :class:`DropoutKey`. Layers registered in
``nn/registry.py`` are built and run as in JAX. The full-graph forms live in
``nn/full_graph_encoder.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from marius_tpu_torch.data.batch import LayerAdjacency
from marius_tpu_torch.nn.initialization import InitConfig, initialize_tensor
from marius_tpu_torch.ops.segment import (
    masked_mean,
    masked_softmax,
    relational_nbr_sum,
    sampled_nbr_sum,
    slot_gather,
    slot_ids,
)
from marius_tpu_torch.reporting.profiling import count, span

Tensor = torch.Tensor

#: RGCN layers with at most this many relations sum per relation first; more
#: gather a (d_in, d_out) matrix per slot (``layers.py:295``)
RGCN_SUM_FIRST_MAX_RELS = 64


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """One encoder layer (LayerConfig, configuration/config.h:16-170)."""

    layer_type: str                 # EMBEDDING | FEATURE | GNN | REDUCTION
    input_dim: int = -1
    output_dim: int = -1
    offset: int = 0                 # column offset for EMBEDDING/FEATURE slices
    gnn_type: str = "GRAPH_SAGE"    # GRAPH_SAGE | GCN | GAT | RGCN
    aggregator: str = "MEAN"        # GraphSAGE: GCN | MEAN
    reduction: str = "CONCAT"       # REDUCTION: CONCAT | LINEAR
    bias: bool = False
    activation: str = "NONE"        # RELU | SIGMOID | NONE
    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    bias_init: InitConfig = dataclasses.field(default_factory=lambda: InitConfig("ZEROS"))
    # GAT options (datatypes.py:128-136)
    num_heads: int = 10
    average_heads: bool = True
    negative_slope: float = 0.2
    input_dropout: float = 0.0
    attention_dropout: float = 0.0
    # RGCN
    num_relations: int = 1


class DropoutKey:
    """Where the layers' dropout keep-masks come from. The JAX package folds
    an integer into its key per stage, layer, bucket and mask
    (``fold_in``); :meth:`fold` mirrors that path, and :meth:`keep` draws
    one mask. This default ignores the path and draws every mask from one
    torch generator in call order; a test passes an object with the same two
    methods to feed the JAX package's own masks."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def fold(self, data: int) -> "DropoutKey":
        return self

    def keep(self, shape, q: float, device) -> Tensor:
        """A bool mask, true with probability ``q`` (``bernoulli(key, q)``)."""
        g = self.generator
        return (torch.rand(tuple(shape), generator=g, device=g.device) < q).to(device)


def dropout(x: Tensor, rate: float, key) -> Tensor:
    """Inverted dropout (``where(keep, x / (1 - rate), 0)``) with ``key``'s mask."""
    q = 1.0 - rate
    return torch.where(key.keep(x.shape, q, x.device), x / q, 0.0)


def apply_activation(name: str, x: Tensor) -> Tensor:
    """activation.cpp:7 — relu/sigmoid/none."""
    n = name.upper()
    if n == "RELU":
        return torch.relu(x)
    if n == "SIGMOID":
        return torch.sigmoid(x)
    if n == "NONE":
        return x
    raise ValueError(f"Unknown activation: {name}")


def post_hook(config: LayerConfig, params: Dict[str, Tensor], x: Tensor) -> Tensor:
    """bias + activation (layer.cpp:9-16)."""
    if config.bias:
        x = x + params["bias"]
    return apply_activation(config.activation, x)


def init_layer_params(generator: torch.Generator, config: LayerConfig,
                      dtype=torch.float32) -> Dict[str, Tensor]:
    """Per-layer parameters on the generator's device: ``w1`` (and ``w2`` for
    the MEAN aggregator) for GRAPH_SAGE, ``w`` for GCN and LINEAR reductions,
    ``w`` (d_in, heads x head_dim), ``a_l`` and ``a_r`` (heads, head_dim)
    for GAT, ``relation_matrices`` (R, d_in, d_out) and ``self_matrix`` for
    RGCN, a registered layer's own, and ``bias`` where the layer has one."""
    from marius_tpu_torch.nn import registry

    lt = config.layer_type.upper()
    params: Dict[str, Tensor] = {}
    shape = (config.input_dim, config.output_dim)
    if lt == "GNN":
        g = config.gnn_type.upper()
        if g == "GRAPH_SAGE":
            params["w1"] = initialize_tensor(generator, config.init, shape, dtype)
            if config.aggregator.upper() == "MEAN":
                params["w2"] = initialize_tensor(generator, config.init, shape, dtype)
        elif g == "GCN":
            params["w"] = initialize_tensor(generator, config.init, shape, dtype)
        elif g == "GAT":
            h = config.num_heads
            head_dim = config.output_dim if config.average_heads else config.output_dim // h
            # fans as the reference's explicit overrides (gat_layer.cpp:33-38)
            params["w"] = initialize_tensor(generator, config.init,
                                            (config.input_dim, h * head_dim), dtype,
                                            fans=(config.input_dim, head_dim))
            for k in ("a_l", "a_r"):
                params[k] = initialize_tensor(generator, config.init, (h, head_dim), dtype,
                                              fans=(head_dim, 1))
        elif g == "RGCN":
            params["relation_matrices"] = initialize_tensor(
                generator, config.init, (config.num_relations,) + shape, dtype)
            params["self_matrix"] = initialize_tensor(generator, config.init, shape, dtype)
        else:
            custom = registry.gnn_layer(g)
            if custom is None:
                raise ValueError(f"Unknown GNN layer type: {config.gnn_type}")
            params.update(custom[0](generator, config, dtype))
    elif lt == "REDUCTION" and config.reduction.upper() == "LINEAR":
        params["w"] = initialize_tensor(generator, config.init, shape, dtype)
    elif lt not in ("EMBEDDING", "FEATURE", "REDUCTION"):
        custom = registry.stage_layer(lt)
        if custom is None:
            raise ValueError(f"Unknown layer type: {config.layer_type}")
        params.update(custom[0](generator, config, dtype))
    if config.bias:
        params["bias"] = initialize_tensor(generator, config.bias_init,
                                           (config.output_dim,), dtype)
    return params


def embedding_layer(config: LayerConfig, params, embeddings: Tensor) -> Tensor:
    """Column slice of the node-embedding block (embedding.cpp:17)."""
    return post_hook(config, params,
                     embeddings[:, config.offset:config.offset + config.output_dim])


def feature_layer(config: LayerConfig, params, features: Tensor) -> Tensor:
    """Column slice of the node-feature block (feature.cpp:15)."""
    return post_hook(config, params,
                     features[:, config.offset:config.offset + config.output_dim])


def _gather_self(inputs: Tensor, adj: LayerAdjacency) -> Tensor:
    """Each target's own row in the outer node array (clamped as JAX's
    gathers clamp)."""
    return inputs[adj.self_idx.long().clamp(max=inputs.shape[0] - 1)]


def _num_nbrs(adj: LayerAdjacency, dtype) -> Tensor:
    return (adj.in_mask.sum(dim=1) + adj.out_mask.sum(dim=1)).to(dtype)


def graph_sage_layer(config: LayerConfig, params, inputs: Tensor,
                     adj: LayerAdjacency) -> Tensor:
    """GraphSAGE with GCN or MEAN aggregator (graph_sage_layer.cpp:37-97)."""
    agg = config.aggregator.upper()
    if agg not in ("GCN", "MEAN"):
        raise ValueError(f"Unknown GraphSAGE aggregator: {config.aggregator}")
    self_embs = _gather_self(inputs, adj)
    nbr_sum = sampled_nbr_sum(inputs, adj.in_nbr_idx, adj.in_mask, adj.out_nbr_idx,
                              adj.out_mask).to(inputs.dtype)
    num_nbrs = _num_nbrs(adj, inputs.dtype)[:, None]
    if agg == "GCN":
        out = ((nbr_sum + self_embs) / (num_nbrs + 1.0)) @ params["w1"]
    else:
        a = nbr_sum / num_nbrs.clamp(min=1.0)
        out = self_embs @ params["w1"] + a @ params["w2"]
    return post_hook(config, params, out)


def gcn_layer(config: LayerConfig, params, inputs: Tensor, adj: LayerAdjacency,
              outer_degrees: Optional[Tensor] = None) -> Tensor:
    """GCN with sqrt(global_degree + 1) normalization (gcn_layer.cpp forward).

    ``outer_degrees`` (n_x,) are the global degrees of the outer node array's
    nodes (the reference's node_properties_): a slot's factor is its outer
    node's, so the rows of ``inputs`` are scaled once and the slots summed.
    Without them the sampled counts of each direction are used, as in JAX.
    """
    self_embs = _gather_self(inputs, adj)
    num_nbrs = _num_nbrs(adj, inputs.dtype)
    if outer_degrees is not None:
        scaled = inputs / torch.sqrt(outer_degrees.to(inputs.dtype) + 1.0)[:, None]
        a = sampled_nbr_sum(scaled, adj.in_nbr_idx, adj.in_mask, adj.out_nbr_idx,
                            adj.out_mask).to(inputs.dtype)
    else:
        def direction(idx, mask):
            none = torch.zeros_like(adj.in_mask[:, :0])
            s = sampled_nbr_sum(inputs, idx, mask, idx[:, :0], none).to(inputs.dtype)
            return s / torch.sqrt(mask.sum(dim=1, keepdim=True).to(inputs.dtype) + 1.0)

        a = direction(adj.in_nbr_idx, adj.in_mask) + direction(adj.out_nbr_idx, adj.out_mask)
    a = a + self_embs / torch.sqrt(num_nbrs + 1.0)[:, None]
    a = a / torch.sqrt(num_nbrs + 1.0)[:, None]
    return post_hook(config, params, a @ params["w"])


def gat_head_dim(config: LayerConfig) -> int:
    return config.output_dim if config.average_heads else config.output_dim // config.num_heads


def gat_heads_out(config: LayerConfig, out: Tensor) -> Tensor:
    """(n, h, k) per-head outputs -> their mean or their concatenation."""
    return out.mean(dim=1) if config.average_heads else out.reshape(out.shape[0], -1)


def attention_dropout(config: LayerConfig, alpha: Tensor, key, train: bool) -> Tensor:
    if train and config.attention_dropout > 0 and key is not None:
        return dropout(alpha, config.attention_dropout, key)
    return alpha


def gat_layer(config: LayerConfig, params, inputs: Tensor, adj: LayerAdjacency,
              train: bool = False, dropout_key: Optional[DropoutKey] = None) -> Tensor:
    """Multi-head GAT; the target itself takes part in the softmax
    (gat_layer.cpp:49-142). Slots are the in-neighbours, the out-neighbours
    and the target, in that order; the target's slot is masked where
    ``node_mask`` is false, and a row with no valid slot gets zeros. Input
    dropout takes ``dropout_key.fold(0)``'s mask, attention dropout
    ``fold(1)``'s, as JAX's keys do.

    Where h x head_dim <= d_in every input row is projected once and the
    projected rows are gathered; otherwise the softmax runs on per-slot
    scalar logits gathered from x @ (w a_r) and the (n, h, d_in) weighted
    aggregate is projected: the same function (linearity), fewer flops.

    The layer runs inside a ``gat.layer`` span; a training forward counts
    the bytes of the slot blocks it gathers as ``gat.slot_bytes``."""
    with span("gat.layer"):
        return _gat_layer(config, params, inputs, adj, train, dropout_key)


def _gat_layer(config: LayerConfig, params, inputs: Tensor, adj: LayerAdjacency,
               train: bool, dropout_key: Optional[DropoutKey]) -> Tensor:
    h, k = config.num_heads, gat_head_dim(config)
    key = dropout_key if train else None
    if key is not None and config.input_dropout > 0:
        inputs = dropout(inputs, config.input_dropout, key.fold(0))
    n_x, d_in = inputs.shape
    w = params["w"].reshape(d_in, h, k)
    n = adj.self_idx.shape[0]
    self_idx = adj.self_idx.long().clamp(max=n_x - 1)[:, None]
    ids = torch.cat([slot_ids(n_x, adj.in_nbr_idx.long(), adj.in_mask),
                     slot_ids(n_x, adj.out_nbr_idx.long(), adj.out_mask), self_idx], dim=1)
    mask = torch.cat([adj.in_mask, adj.out_mask, adj.node_mask[:, None]], dim=1)[:, :, None]
    slope = config.negative_slope

    if h * k <= d_in:
        t = slot_gather(inputs @ params["w"], ids).view(n, -1, h, k)   # (n, S + 1, h, k)
        blocks = (t,)
        self_t = t[:, -1]
        logits = torch.einsum("nhk,hk->nh", self_t, params["a_l"])[:, None, :] + \
            torch.einsum("nshk,hk->nsh", t, params["a_r"])
        alpha = masked_softmax(torch.nn.functional.leaky_relu(logits, slope),
                               mask.expand_as(logits), dim=1)
        alpha = attention_dropout(config, alpha, None if key is None else key.fold(1), train)
        out = torch.einsum("nsh,nshk->nhk", alpha, t)
    else:
        # a_r . (x W) = x . (W a_r): per-slot logits are gathered scalars
        wal = torch.einsum("dhk,hk->dh", w, params["a_l"])
        war = torch.einsum("dhk,hk->dh", w, params["a_r"])
        slots = slot_gather(inputs, ids)                                 # (n, S + 1, d_in)
        logit_r = slot_gather(inputs @ war, ids)                         # (n, S + 1, h)
        blocks = (slots, logit_r)
        logits = (slots[:, -1] @ wal)[:, None, :] + logit_r
        alpha = masked_softmax(torch.nn.functional.leaky_relu(logits, slope),
                               mask.expand_as(logits), dim=1)
        alpha = attention_dropout(config, alpha, None if key is None else key.fold(1), train)
        agg = torch.einsum("nsh,nsd->nhd", alpha, slots)                 # (n, h, d_in)
        out = torch.einsum("nhd,dhk->nhk", agg, w)
    if train:
        count("gat.slot_bytes", sum(b.numel() * b.element_size() for b in blocks))
    return post_hook(config, params, gat_heads_out(config, out))


def rgcn_layer(config: LayerConfig, params, inputs: Tensor, adj: LayerAdjacency) -> Tensor:
    """RGCN over the out-neighbours (rgcn_layer.cpp): the mean over a
    target's valid out-slots of x[slot] @ W[rel], plus x[self] @ W_self.

    Up to RGCN_SUM_FIRST_MAX_RELS relations the slots are summed per
    relation first (one gather-sum call) and the (n, R x d_in) sums meet the
    stacked matrices in one matmul; past it each slot's matrix is gathered,
    as in JAX. Relation ids outside [0, R) add nothing in the first form and
    read the nearest matrix in the second, as JAX's two forms do."""
    self_embs = _gather_self(inputs, adj)
    rel = adj.out_rel if adj.out_rel is not None else torch.zeros_like(adj.out_nbr_idx)
    W = params["relation_matrices"]
    r = config.num_relations
    if r <= RGCN_SUM_FIRST_MAX_RELS:
        z = relational_nbr_sum(inputs, adj.out_nbr_idx.long(), adj.out_mask, rel, r)
        count = adj.out_mask.sum(dim=1, keepdim=True).to(inputs.dtype).clamp(min=1.0)
        a = torch.einsum("nri,rio->no", z.to(inputs.dtype), W) / count
    else:
        ids = slot_ids(inputs.shape[0], adj.out_nbr_idx.long(), adj.out_mask)
        out_embs = slot_gather(inputs, ids)                              # (n, F, d_in)
        mats = W[rel.long().clamp(0, W.shape[0] - 1)]                    # (n, F, d_in, d_out)
        a = masked_mean(torch.einsum("nfd,nfdo->nfo", out_embs, mats), adj.out_mask)
    return post_hook(config, params, a + self_embs @ params["self_matrix"])


def reduction_layer(config: LayerConfig, params, stage_outputs) -> Tensor:
    """CONCAT (concat.cpp) or LINEAR = concat -> matmul (linear.cpp)."""
    x = torch.cat(list(stage_outputs), dim=1)
    if config.reduction.upper() == "LINEAR":
        x = x @ params["w"]
    elif config.reduction.upper() != "CONCAT":
        raise ValueError(f"Unknown reduction: {config.reduction}")
    return post_hook(config, params, x)
