"""Encoder layers: embedding and feature column slices, the sampled
GraphSAGE and GCN layers, reductions, bias + activation.

Port of ``marius_tpu/nn/layers/layers.py`` (LayerConfig :37-59,
apply_activation and post_hook :61-77, init_layer_params :85-132,
embedding_layer and feature_layer :140-149, _gather_neighbors :152-157,
graph_sage_layer :160-174, gcn_layer :177-198, reduction_layer :312-319;
reference embedding.cpp:17, feature.cpp:15, graph_sage_layer.cpp:37-97,
gcn_layer.cpp, concat.cpp, linear.cpp, layer.cpp:9-16). Weights are stored
(d_in, d_out) and applied as x @ w.

The sampled layers aggregate over the padded-fanout ``LayerAdjacency`` with
one gather-sum kernel call (``ops/segment.py`` ``sampled_nbr_sum``) where
the JAX layers gather an (n, F, d) block and take a masked sum. GCN's
per-slot factor 1/sqrt(deg + 1) belongs to the outer node a slot points at,
so it scales x's rows before the sum. Layers registered in
``nn/registry.py`` are built and run as in JAX. The full-graph forms of SAGE
and GCN live in ``nn/full_graph_encoder.py``; GAT and RGCN come with a
later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from marius_tpu_torch.data.batch import LayerAdjacency
from marius_tpu_torch.nn.initialization import InitConfig, initialize_tensor
from marius_tpu_torch.ops.segment import sampled_nbr_sum

Tensor = torch.Tensor


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


def _later_slice(layer_type: str) -> NotImplementedError:
    return NotImplementedError(
        f"{layer_type} layers are not ported yet; they come with a later GNN slice")


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
    a registered layer's own, and ``bias`` where the layer has one."""
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
        elif g in ("GAT", "RGCN"):
            raise _later_slice(f"GNN {g}")
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


def reduction_layer(config: LayerConfig, params, stage_outputs) -> Tensor:
    """CONCAT (concat.cpp) or LINEAR = concat -> matmul (linear.cpp)."""
    x = torch.cat(list(stage_outputs), dim=1)
    if config.reduction.upper() == "LINEAR":
        x = x @ params["w"]
    elif config.reduction.upper() != "CONCAT":
        raise ValueError(f"Unknown reduction: {config.reduction}")
    return post_hook(config, params, x)
