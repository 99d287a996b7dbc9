"""Full-graph encoder forward: every stage over ALL nodes at once.

Port of ``marius_tpu/nn/full_graph_encoder.py`` for GraphSAGE (GCN and MEAN
aggregators) and GCN stages on one device (supports_full_graph and
supports_seed_restrict :66-98, prepare_full_graph :127-169, AffineConst
:45-54, _const_first_agg and _resolve_const :229-302, _full_graph_sage and
_full_graph_gcn :305-323, _seed_sage and _seed_gcn :508-537,
full_graph_encoder_forward :619-745). Each GNN stage aggregates over the
whole adjacency (``data/full_graph.py``'s neighbour sum, one call of the
gather-sum kernel per pass), so a node's output equals the sampled path's
under unbounded ALL sampling.

The JAX package's ``sorted_space`` mode (a TPU trade that drops a
permutation gather per pass) has no counterpart: the kernel writes each
degree-sorted row straight to its original-order row. A learnable EMBEDDING
input (the whole (N, d) table: GNN link prediction's exact-ALL evaluation)
and REDUCTION layers run as in the sampled encoder. GAT and RGCN stages come
with a later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from marius_tpu_torch.data.full_graph import FullGraphAdjacency, make_nbr_sums
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.layers import (
    LayerConfig,
    embedding_layer,
    feature_layer,
    post_hook,
    reduction_layer,
)
from marius_tpu_torch.ops.segment import segment_sum

Tensor = torch.Tensor

# the GNN layer types this port runs on the full-graph path; each of them
# can also be the seed-restricted final stage
SUPPORTED_GNN = {"GRAPH_SAGE", "GCN"}


@dataclasses.dataclass(frozen=True)
class AffineConst:
    """A precomputed first-stage aggregation that still depends on the live
    stage-0 FEATURE bias: resolve as base + count*bias (_const_first_agg)."""

    base: Tensor
    count: Tensor


def _gnn_layers(config: EncoderConfig):
    return [l for s in config.stages for l in s if l.layer_type.upper() == "GNN"]


def supports_full_graph(config: EncoderConfig) -> bool:
    return all(l.gnn_type.upper() in SUPPORTED_GNN for l in _gnn_layers(config))


def supports_seed_restrict(config: EncoderConfig) -> bool:
    """True when the FINAL stage is all seed-capable GNN layers, so training
    can compute it for the batch's seed rows only."""
    if not supports_full_graph(config) or len(config.stages) == 0:
        return False
    last = config.stages[-1]
    return len(last) > 0 and all(l.layer_type.upper() == "GNN" for l in last)


def check_ported(config: EncoderConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run yet."""
    for s in config.stages:
        for l in s:
            lt = l.layer_type.upper()
            if lt == "GNN" and l.gnn_type.upper() not in SUPPORTED_GNN:
                raise NotImplementedError(
                    f"full-graph {l.gnn_type} stages are not ported; this slice runs "
                    "GRAPH_SAGE and GCN, and GAT and RGCN come with a later GNN slice")


def prepare_full_graph(adj: FullGraphAdjacency, config: EncoderConfig,
                       features: Optional[Tensor] = None):
    """(adj, ops) for this adjacency and model: ``ops["nbr_sum"]`` is the
    neighbour sum; with feature inputs the first GNN stage's aggregation is
    precomputed once (``ops["const_agg"]``, see _const_first_agg)."""
    check_ported(config)
    ops = {"nbr_sum": make_nbr_sums(adj)}
    ops["const_agg"] = _const_first_agg(adj, config, features, ops["nbr_sum"])
    return adj, ops


@torch.no_grad()
def _const_first_agg(adj, config: EncoderConfig, features, nbr_sum):
    """{(stage, layer): precomputed aggregation} for the first GNN stage.

    When the encoder input is a single FEATURE stage, features are constants
    and the first GNN stage's neighbour sum is computed once here: training
    then runs no layer-1 gathers. A FEATURE stage with a trained bias (and
    no nonlinearity) stays precomputable because aggregation is LINEAR in the
    bias: nbr_sum(x + b) = nbr_sum(x) + count·b, where count is each node's
    real (non-padding) slot tally; such entries are AffineConst(base, count),
    combined with the live bias by _resolve_const."""
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
    const = {}
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


def full_graph_encoder_forward(
    config: EncoderConfig,
    params,
    embeddings: Optional[Tensor],   # (N, emb_dim) all-node block
    features: Optional[Tensor],     # (N, feat_dim) all-node block
    adj: FullGraphAdjacency,
    ops=None,                       # from prepare_full_graph
    seed_restrict=None,             # (seeds (b,), flat_nbr (S,), flat_seg (S,))
) -> Tensor:
    """Representations for ALL nodes: (N, d_out). With ``seed_restrict``
    (requires supports_seed_restrict(config)), the FINAL stage is computed
    only for the given seed rows and (b, d_out) comes back."""
    if ops is None:
        adj, ops = prepare_full_graph(adj, config)
    nbr_sum = ops["nbr_sum"]
    num_nbrs = (adj.in_deg + adj.out_deg).to(
        (embeddings if embeddings is not None else features).dtype)
    if seed_restrict is not None:
        seeds, flat_nbr, flat_seg = seed_restrict[:3]
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
            if lt != "GNN" or g not in SUPPORTED_GNN:   # check_ported names what is missing
                raise ValueError(f"full-graph mode does not run {lt} {layer.gnn_type}")
            const = ops.get("const_agg", {}).get((i, j))
            bias0 = params[0][0].get("bias") if const is not None else None
            if seed_stage:
                c_seed = None if const is None else _resolve_const(const, bias0, idx=seeds)
                seed_fn = _seed_sage if g == "GRAPH_SAGE" else _seed_gcn
                stage_outputs.append(seed_fn(layer, p, current, seeds, flat_nbr, flat_seg,
                                             num_nbrs, nseeds, c_seed))
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
