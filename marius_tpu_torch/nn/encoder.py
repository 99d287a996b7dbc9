"""GeneralEncoder configuration, parameters and the per-batch forward.

Port of ``marius_tpu/nn/encoder.py`` (EncoderConfig :35-63,
init_encoder_params :66-75, _apply_gnn :78-101, encoder_forward :104-160;
reference nn/encoders/encoder.cpp:195-258). Stages are lists of parallel
layers whose outputs concatenate; parameters are a nested list (stage,
layer) of dicts of tensors. ``encoder_forward`` runs EMBEDDING, FEATURE,
REDUCTION and registered stage layers, and GNN stages over a sampled
``NeighborBatch``, each moving representations one hop inward: GraphSAGE,
GCN, GAT, RGCN and registered layers. The full-graph GNN forward lives in
``nn/full_graph_encoder.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from marius_tpu_torch.data.batch import NeighborBatch
from marius_tpu_torch.nn.layers import (
    DropoutKey,
    LayerConfig,
    embedding_layer,
    feature_layer,
    gat_layer,
    gcn_layer,
    graph_sage_layer,
    init_layer_params,
    reduction_layer,
    rgcn_layer,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """stages[i] is a list of parallel LayerConfigs (encoder.cpp:29 ctor)."""

    stages: Tuple[Tuple[LayerConfig, ...], ...]

    @property
    def num_gnn_stages(self) -> int:
        return sum(1 for s in self.stages if any(l.layer_type.upper() == "GNN" for l in s))

    @property
    def has_embeddings(self) -> bool:
        return any(l.layer_type.upper() == "EMBEDDING" for s in self.stages for l in s)

    @property
    def has_features(self) -> bool:
        return any(l.layer_type.upper() == "FEATURE" for s in self.stages for l in s)

    @property
    def embedding_dim(self) -> int:
        """Total width of the raw node-embedding block consumed by EMBEDDING
        layers (Model::get_base_embedding_dim, model.cpp:220-240)."""
        dims = [l.offset + l.output_dim for s in self.stages for l in s
                if l.layer_type.upper() == "EMBEDDING"]
        return max(dims) if dims else 0

    @property
    def output_dim(self) -> int:
        return self.stages[-1][-1].output_dim


def init_encoder_params(generator: torch.Generator, config: EncoderConfig,
                        dtype=torch.float32) -> List[List[Dict[str, Tensor]]]:
    """Nested list-of-lists of per-layer param dicts."""
    return [[init_layer_params(generator, layer, dtype) for layer in stage]
            for stage in config.stages]


def _apply_gnn(layer: LayerConfig, p, x, adj, degrees, node_ids_outer, train, dropout_key):
    g = layer.gnn_type.upper()
    if g == "GRAPH_SAGE":
        return graph_sage_layer(layer, p, x, adj)
    if g == "GCN":
        outer = None
        if degrees is not None:
            outer = degrees[node_ids_outer.long().clamp(max=degrees.shape[0] - 1)]
        return gcn_layer(layer, p, x, adj, outer_degrees=outer)
    if g == "GAT":
        return gat_layer(layer, p, x, adj, train=train, dropout_key=dropout_key)
    if g == "RGCN":
        return rgcn_layer(layer, p, x, adj)
    from marius_tpu_torch.nn import registry
    custom = registry.gnn_layer(g)
    if custom is None:
        raise ValueError(f"Unknown GNN type: {layer.gnn_type}")
    return custom[1](layer, p, x, adj, degrees=degrees, node_ids_outer=node_ids_outer,
                     train=train, dropout_key=dropout_key)


def encoder_forward(
    config: EncoderConfig,
    params,
    embeddings: Optional[Tensor],     # (n_outer, emb_dim) rows of the OUTERMOST node set
    features: Optional[Tensor],       # (n_outer, feat_dim) likewise
    nbr_batch: Optional[NeighborBatch] = None,
    degrees: Optional[Tensor] = None,  # (num_nodes + 1,) global degrees for GCN
    train: bool = False,
    dropout_key: Optional[DropoutKey] = None,
) -> Tensor:
    """Run all stages; returns representations on the seed node set (on the
    batch's nodes when there is no GNN stage). GNN stage ``i`` gets
    ``dropout_key.fold(i)`` (GAT's dropouts, registered layers), as JAX's
    ``fold_in(dropout_key, i)``."""
    from marius_tpu_torch.nn import registry

    gnn_seen = 0
    outputs: List[Tensor] = []
    current: Optional[Tensor] = None
    for i, stage in enumerate(config.stages):
        stage_outputs = []
        for j, layer in enumerate(stage):
            lt = layer.layer_type.upper()
            p = params[i][j]
            if lt == "EMBEDDING":
                if embeddings is None:
                    raise ValueError("encoder has EMBEDDING layer but no embeddings")
                stage_outputs.append(embedding_layer(layer, p, embeddings))
            elif lt == "FEATURE":
                if features is None:
                    raise ValueError("encoder has FEATURE layer but no features")
                stage_outputs.append(feature_layer(layer, p, features))
            elif lt == "REDUCTION":
                stage_outputs.append(reduction_layer(layer, p, outputs))
            elif lt == "GNN":
                if nbr_batch is None:
                    raise ValueError("a GNN stage needs a NeighborBatch")
                stage_outputs.append(_apply_gnn(
                    layer, p, current, nbr_batch.layers[gnn_seen], degrees,
                    nbr_batch.node_ids[gnn_seen], train,
                    None if dropout_key is None else dropout_key.fold(i)))
            else:
                custom = registry.stage_layer(lt)
                if custom is None:
                    raise ValueError(f"Unknown layer type: {layer.layer_type}")
                stage_outputs.append(custom[1](layer, p, current, embeddings, features))
        if any(l.layer_type.upper() == "GNN" for l in stage):
            gnn_seen += 1
        outputs = stage_outputs
        # parallel outputs concatenate as the default reduction
        current = (stage_outputs[0] if len(stage_outputs) == 1
                   else torch.cat(stage_outputs, dim=1))
    return current
