"""All-node inference: encode every node with the trained encoder.

Port of the shallow branches of ``marius_tpu/train/graph_encoder.py``
(``encode_all_nodes`` :31-48 and ``encode_all_nodes_host`` :108-164;
reference pipeline/graph_encoder.cpp and encode_and_export, marius.cpp:13-36):
with no GNN stage the encoder runs once over the whole table, or, for a table
that stays in host RAM, tile by tile through the device. Used by
link-prediction evaluation against all-node corruption and by embedding
export. A GNN or FEATURE encoder raises ``NotImplementedError`` naming the
slice that brings the sampled-GNN, full-graph and feature branches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from marius_tpu_torch.nn.encoder import encoder_forward
from marius_tpu_torch.nn.model import Model
from marius_tpu_torch.train.trainer import _later_slice


def _refuse_deep(model: Model) -> None:
    if model.encoder.num_gnn_stages or model.encoder.has_features:
        raise _later_slice("all-node encoding through a GNN or FEATURE encoder", "the GNN slice")


@torch.no_grad()
def encode_all_nodes(model: Model, params, table_values: Optional[torch.Tensor]) -> torch.Tensor:
    """Encoded representations (num_nodes, d_out) for every node."""
    _refuse_deep(model)
    return encoder_forward(model.encoder, params["encoder"], table_values, None)


@torch.no_grad()
def encode_all_nodes_host(model: Model, params, host_values: np.ndarray, device,
                          batch_size: int = 1000) -> np.ndarray:
    """``encode_all_nodes`` for a table that stays in host RAM: tiles of
    ``batch_size`` rows (the last one padded with the last row, as the JAX
    version pads) go through the encoder on ``device`` and come back to a
    (num_nodes, d_out) host array."""
    _refuse_deep(model)
    host_values = np.asarray(host_values)
    num_nodes = len(host_values)
    out_host: Optional[np.ndarray] = None
    for lo in range(0, num_nodes, batch_size):
        hi = min(lo + batch_size, num_nodes)
        idx = np.minimum(np.arange(lo, lo + batch_size), num_nodes - 1)
        emb = torch.from_numpy(host_values[idx]).to(device)
        out = encoder_forward(model.encoder, params["encoder"], emb, None).cpu().numpy()
        if out_host is None:
            out_host = np.empty((num_nodes, out.shape[1]), out.dtype)
        out_host[lo:hi] = out[:hi - lo]
    return out_host
