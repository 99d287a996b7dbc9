"""All-node inference: encode every node with the trained encoder.

Port of ``marius_tpu/train/graph_encoder.py`` (``encode_all_nodes`` :31-105
and ``encode_all_nodes_host`` :108-197; reference
pipeline/graph_encoder.cpp and encode_and_export, marius.cpp:13-36). With no
GNN stage the encoder runs once over the whole table (or, for a table that
stays in host RAM, tile by tile through the device); with a full-graph
adjacency, in one full-graph pass; otherwise in batches of node ids through
the neighbour sampler under worst-case hop caps, each batch's numbers drawn
from a generator seeded from (``ENCODE_SEED``, batch), never from a training
generator, so that evaluation reproduces itself. Used by link-prediction
evaluation against all-node corruption and by embedding export.
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
from marius_tpu_torch.reporting.profiling import count, span

Tensor = torch.Tensor

#: The fixed seed of all-node sampling (JAX's ``seed=13``); tile ``i`` draws
#: from ``seeded_draws(ENCODE_SEED, i)`` in both encoders below.
ENCODE_SEED = 13


@torch.no_grad()
def encode_all_nodes(
    model: Model,
    params,
    table_values: Optional[Tensor],
    graph: Optional[DeviceGraph] = None,
    nbr_configs: Sequence[NeighborSamplingConfig] = (),
    features: Optional[Tensor] = None,     # (N + 1, F) with the sentinel row
    batch_size: int = 1000,
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
    caps = tuple(estimate_hop_caps(batch_size, nbr_configs, num_nodes))
    nb = -(-num_nodes // batch_size)
    ids = torch.full((nb * batch_size,), num_nodes, dtype=torch.int64, device=dev)
    ids[:num_nodes] = torch.arange(num_nodes, device=dev)
    outs = []
    for i in range(nb):
        # one node tile: an evaluation batch
        with span("eval.batch"):
            seeds = ids[i * batch_size:(i + 1) * batch_size]
            batch = sample_neighbor_batch(seeded_draws(ENCODE_SEED, i, dev), graph, seeds,
                                          seeds < num_nodes, nbr_configs, caps)
            outer = batch.node_ids[0]
            with span("gather"):
                emb = None if table_values is None else gather_rows(table_values, outer)
                f = None if features is None else gather_rows(features, outer)
            with span("forward"):
                outs.append(encoder_forward(model.encoder, params["encoder"], emb, f, batch,
                                            degrees=graph.degrees))
            count("eval.batches")
    return torch.cat(outs)[:num_nodes]


@torch.no_grad()
def encode_all_nodes_host(
    model: Model,
    params,
    host_values: Optional[np.ndarray],   # (N, emb_dim) host table, or None
    device,
    graph: Optional[DeviceGraph] = None,
    nbr_configs: Sequence[NeighborSamplingConfig] = (),
    features_host: Optional[np.ndarray] = None,   # (N, F) or (N + 1, F) on the host
    batch_size: int = 1000,
) -> np.ndarray:
    """``encode_all_nodes`` for tables that stay in host RAM: the embedding
    and feature rows stay on the host, and only one tile's rows go through
    the encoder on ``device`` at a time; the (num_nodes, d_out) encodings
    come back to a host array. A shallow encoder streams tiles of
    ``batch_size`` rows (the last one padded with the last row, as the JAX
    version pads). A GNN encoder samples each tile of node ids on the device
    from ``graph`` with the seeds and caps of :func:`encode_all_nodes` (so
    equal batch sizes give identical encodings), and copies only that
    tile's outermost-hop rows from the host."""
    if host_values is not None:
        host_values = np.asarray(host_values)
    num_nodes = (graph.num_nodes if graph is not None
                 else len(host_values) if host_values is not None else len(features_host))
    feats_padded = None
    if features_host is not None:
        feats_padded = np.asarray(features_host, np.float32)
        if len(feats_padded) == num_nodes:      # add the sentinel row
            feats_padded = np.concatenate(
                [feats_padded, np.zeros((1, feats_padded.shape[1]), np.float32)])

    def rows(ids: np.ndarray):
        emb = (None if host_values is None
               else torch.from_numpy(host_values[np.minimum(ids, num_nodes - 1)]).to(device))
        f = (None if feats_padded is None
             else torch.from_numpy(feats_padded[np.minimum(ids, num_nodes)]).to(device))
        return emb, f

    if nbr_configs and graph is None:
        raise ValueError("GNN host encoding needs the graph")
    caps = tuple(estimate_hop_caps(batch_size, nbr_configs, num_nodes)) if nbr_configs else ()
    out_host: Optional[np.ndarray] = None
    for i, lo in enumerate(range(0, num_nodes, batch_size)):
        hi = min(lo + batch_size, num_nodes)
        if not nbr_configs:
            emb, f = rows(np.arange(lo, lo + batch_size))
            out = encoder_forward(model.encoder, params["encoder"], emb, f)
        else:
            seeds = torch.full((batch_size,), num_nodes, dtype=torch.int64, device=device)
            seeds[:hi - lo] = torch.arange(lo, hi, device=device)
            batch = sample_neighbor_batch(seeded_draws(ENCODE_SEED, i, device), graph, seeds,
                                          seeds < num_nodes, nbr_configs, caps)
            # the host-side gather of the outermost hop's rows: the only table access
            emb, f = rows(batch.node_ids[0].cpu().numpy())
            out = encoder_forward(model.encoder, params["encoder"], emb, f, batch,
                                  degrees=graph.degrees)
        out = out.cpu().numpy()
        if out_host is None:
            out_host = np.empty((num_nodes, out.shape[1]), out.dtype)
        out_host[lo:hi] = out[:hi - lo]
    return out_host
