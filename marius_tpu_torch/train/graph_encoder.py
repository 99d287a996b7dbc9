"""All-node inference: encode every node with the trained encoder.

Port of ``marius_tpu/train/graph_encoder.py`` (``encode_all_nodes`` :31-105
and the shallow branch of ``encode_all_nodes_host`` :108-164; reference
pipeline/graph_encoder.cpp and encode_and_export, marius.cpp:13-36). With no
GNN stage the encoder runs once over the whole table (or, for a table that
stays in host RAM, tile by tile through the device); with a full-graph
adjacency, in one full-graph pass; otherwise in batches of node ids through
the neighbour sampler under worst-case hop caps, each batch's numbers drawn
from a generator seeded from (seed, batch). Used by link-prediction
evaluation against all-node corruption and by embedding export. The host
form with a GNN or FEATURE encoder (the buffer trainer's) raises
``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from marius_tpu_torch.data.graph import DeviceGraph
from marius_tpu_torch.data.samplers.neighbor import (
    NeighborSamplingConfig,
    estimate_hop_caps,
    sample_neighbor_batch,
    seeded_draws,
)
from marius_tpu_torch.nn.encoder import encoder_forward
from marius_tpu_torch.nn.full_graph_encoder import full_graph_encoder_forward, prepare_full_graph
from marius_tpu_torch.nn.model import Model
from marius_tpu_torch.parallel.embedding_table import gather_rows
from marius_tpu_torch.train.trainer import _later_slice

Tensor = torch.Tensor


@torch.no_grad()
def encode_all_nodes(
    model: Model,
    params,
    table_values: Optional[Tensor],
    graph: Optional[DeviceGraph] = None,
    nbr_configs: Sequence[NeighborSamplingConfig] = (),
    features: Optional[Tensor] = None,     # (N + 1, F) with the sentinel row
    batch_size: int = 1000,
    hop_caps: Optional[Sequence[int]] = None,
    seed: int = 13,
    full_graph=None,    # FullGraphAdjacency: exact-ALL one-pass encoding
    fg_ops=None,        # prepared ops from prepare_full_graph (optional)
) -> Tensor:
    """Encoded representations (num_nodes, d_out) for every node."""
    feats = None if features is None else features[:-1]
    if not nbr_configs:
        return encoder_forward(model.encoder, params["encoder"], table_values, feats)
    if full_graph is not None:
        if fg_ops is None:
            full_graph, fg_ops = prepare_full_graph(full_graph, model.encoder, feats)
        return full_graph_encoder_forward(model.encoder, params["encoder"], table_values,
                                          feats, full_graph, ops=fg_ops)
    if graph is None:
        raise ValueError("sampled GNN encoding needs the graph")
    num_nodes, dev = graph.num_nodes, graph.degrees.device
    caps = tuple(hop_caps or estimate_hop_caps(batch_size, nbr_configs, num_nodes))
    nb = -(-num_nodes // batch_size)
    ids = torch.full((nb * batch_size,), num_nodes, dtype=torch.int64, device=dev)
    ids[:num_nodes] = torch.arange(num_nodes, device=dev)
    outs = []
    for i in range(nb):
        seeds = ids[i * batch_size:(i + 1) * batch_size]
        batch = sample_neighbor_batch(seeded_draws(seed, i, dev), graph, seeds,
                                      seeds < num_nodes, nbr_configs, caps)
        outer = batch.node_ids[0]
        emb = None if table_values is None else gather_rows(table_values, outer)
        f = None if features is None else gather_rows(features, outer)
        outs.append(encoder_forward(model.encoder, params["encoder"], emb, f, batch,
                                    degrees=graph.degrees))
    return torch.cat(outs)[:num_nodes]


@torch.no_grad()
def encode_all_nodes_host(model: Model, params, host_values: np.ndarray, device,
                          batch_size: int = 1000) -> np.ndarray:
    """``encode_all_nodes`` for a table that stays in host RAM: tiles of
    ``batch_size`` rows (the last one padded with the last row, as the JAX
    version pads) go through the encoder on ``device`` and come back to a
    (num_nodes, d_out) host array."""
    if model.encoder.num_gnn_stages or model.encoder.has_features:
        raise _later_slice("host-tiled encoding through a GNN or FEATURE encoder",
                           "the GNN LP slice")
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
