"""Encoder layers: embedding and feature column slices with bias + activation,
and the parameters of GraphSAGE and GCN layers.

Port of ``marius_tpu/nn/layers/layers.py`` (LayerConfig :37-59,
apply_activation and post_hook :61-77, init_layer_params :85-132 for
EMBEDDING, FEATURE and GNN GRAPH_SAGE / GCN, embedding_layer and
feature_layer :140-149; reference embedding.cpp:17, feature.cpp:15,
layer.cpp:9-16). Weights are stored (d_in, d_out) and applied as x @ w. The
full-graph forms of SAGE and GCN live in ``nn/full_graph_encoder.py``; GAT,
RGCN and REDUCTION layers, and the sampled (padded-fanout) forward, come
with later slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from marius_tpu_torch.nn.initialization import InitConfig, initialize_tensor

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
    the MEAN aggregator) for GRAPH_SAGE, ``w`` for GCN, ``bias`` where the
    layer has one."""
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
            raise ValueError(f"Unknown GNN layer type: {config.gnn_type}")
    elif lt not in ("EMBEDDING", "FEATURE"):
        raise _later_slice(lt)
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
