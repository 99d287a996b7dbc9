"""All-node inference: encode every node with the trained encoder.

Port of the shallow branch of ``marius_tpu/train/graph_encoder.py``
(``encode_all_nodes`` :31-48; reference pipeline/graph_encoder.cpp and
encode_and_export, marius.cpp:13-36): with no GNN stage the encoder runs once
over the whole table. Used by link-prediction evaluation against all-node
corruption and by embedding export. A GNN or FEATURE encoder raises
``NotImplementedError`` naming the slice that brings the sampled-GNN,
full-graph and host-tiled branches.
"""

from __future__ import annotations

from typing import Optional

import torch

from marius_tpu_torch.nn.encoder import encoder_forward
from marius_tpu_torch.nn.model import Model
from marius_tpu_torch.train.trainer import _later_slice


@torch.no_grad()
def encode_all_nodes(model: Model, params, table_values: Optional[torch.Tensor]) -> torch.Tensor:
    """Encoded representations (num_nodes, d_out) for every node."""
    if model.encoder.num_gnn_stages or model.encoder.has_features:
        raise _later_slice("all-node encoding through a GNN or FEATURE encoder", "the GNN slice")
    return encoder_forward(model.encoder, params["encoder"], table_values, None)
