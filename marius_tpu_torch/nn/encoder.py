"""GeneralEncoder configuration, parameters and the shallow forward.

Port of ``marius_tpu/nn/encoder.py`` (EncoderConfig :35-63,
init_encoder_params :66-75, encoder_forward :104-160; reference
nn/encoders/encoder.cpp:195-258). Stages are lists of parallel layers whose
outputs concatenate; parameters are a nested list (stage, layer) of dicts of
tensors, for EMBEDDING, FEATURE and GNN (GraphSAGE, GCN) stages alike. GNN
stages run over the full graph in ``nn/full_graph_encoder.py``; this
module's ``encoder_forward`` (the per-batch form) covers EMBEDDING/FEATURE
stages, and its sampled GNN and REDUCTION stages come with a later slice
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from marius_tpu_torch.nn.layers import (
    LayerConfig,
    embedding_layer,
    feature_layer,
    init_layer_params,
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


def encoder_forward(
    config: EncoderConfig,
    params,
    embeddings: Optional[Tensor],  # (n, emb_dim) gathered rows of the node table
    features: Optional[Tensor],    # (n, feat_dim) likewise
) -> Tensor:
    """Run all stages; returns the batch nodes' representations."""
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
            else:
                raise NotImplementedError(
                    f"sampled {lt} encoder stages are not ported yet; they come with the "
                    "sampled-GNN slice (full-graph GNN stages: nn/full_graph_encoder.py)")
        # parallel outputs concatenate as the default reduction
        current = (stage_outputs[0] if len(stage_outputs) == 1
                   else torch.cat(stage_outputs, dim=1))
    return current
