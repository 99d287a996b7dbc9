"""Exact linear-GNN collapse for full-graph training.

Port of ``marius_tpu/nn/linear_collapse.py`` (:61-185). The reference's
node-classification config (ogbn_arxiv.yaml: FEATURE + 3x GraphSAGE MEAN,
bias, activation NONE) is a LINEAR network in its input, so its full-graph
forward factors exactly:

    H_k = C_k @ M_k(params)

where C_k is a CONSTANT (N, K_k) matrix built ONCE at setup (one
neighbour-sum pass per GNN stage) and M_k a small (K_k, d) matrix-valued
function of the live layer weights. One batch's logits become
``C_final[seeds] @ M_final(params)``: a (batch, K) row gather and small
matmuls, with no per-batch full-graph pass. Autograd through M_final gives
the layerwise network's gradients up to float associativity.

Per-stage recurrences (the layer semantics of nn/full_graph_encoder.py):

- FEATURE (+bias b0, activation NONE):  C = [F | 1],  M = [I ; b0^T]
- SAGE MEAN  (out = x w1 + (Ax / max(deg,1)) w2 + b):
      C' = [C | (A C) / max(deg,1) | 1],  M' = [M w1 ; M w2 ; b^T]
- SAGE GCN   (out = ((Ax + x) / (deg+1)) w1 + b):
      C' = [(A C + C) / (deg+1) | 1],     M' = [M w1 ; b^T]
- GCN        (out = ((A(x/s) + x/s) / s) w  + b, s = sqrt(deg+1)):
      C' = [(A (C/s) + C/s) / s | 1],     M' = [M w ; b^T]

A is the symmetric combined (in+out) neighbour-sum operator. K grows by K+1
per SAGE-MEAN stage and by 1 otherwise (129 -> 259 -> 519 -> 1039 at arxiv
shape, so the setup's three neighbour sums run at widths 129, 259 and 519).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from marius_tpu_torch.data.full_graph import FullGraphAdjacency, make_nbr_sums
from marius_tpu_torch.nn.encoder import EncoderConfig
from marius_tpu_torch.nn.layers import apply_activation

Tensor = torch.Tensor

MAX_K = 4096  # widest collapsed feature matrix we are willing to hold


def _gnn_kind(layer) -> Optional[str]:
    """'sage_mean' | 'sage_gcn' | 'gcn' for collapsible GNN layers."""
    g = layer.gnn_type.upper()
    if g == "GRAPH_SAGE":
        return "sage_gcn" if layer.aggregator.upper() == "GCN" else "sage_mean"
    if g == "GCN":
        return "gcn"
    return None


def linear_collapse_eligible(config: EncoderConfig, has_features: bool) -> bool:
    """True when the encoder is a single-FEATURE input followed by LINEAR
    (activation NONE) single-layer SAGE/GCN stages."""
    if not has_features or len(config.stages) < 2:
        return False
    s0 = config.stages[0]
    if len(s0) != 1 or s0[0].layer_type.upper() != "FEATURE":
        return False
    act0 = s0[0].activation.upper() not in ("", "NONE")
    if act0 and s0[0].bias:
        return False  # act(F + b0) is affine in b0 only without the act
    k = s0[0].output_dim + (1 if s0[0].bias else 0)
    for stage in config.stages[1:]:
        if len(stage) != 1 or stage[0].layer_type.upper() != "GNN":
            return False
        layer = stage[0]
        if layer.activation.upper() not in ("", "NONE"):
            return False
        kind = _gnn_kind(layer)
        if kind is None:
            return False
        k = (2 * k + 1) if kind == "sage_mean" else (k + 1)
        if k > MAX_K:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class LinearCollapse:
    """phi: (N, K) constant collapsed features; ``kinds`` is the recipe for
    rebuilding M_final from live params."""

    phi: Tensor
    num_nodes: int
    feat_dim: int
    bias0: bool
    kinds: Tuple[str, ...]

    def m_final(self, enc_params) -> Tensor:
        """(K, d_out) live matrix from encoder params — the same function of
        the same parameters as the layerwise network."""
        m = torch.eye(self.feat_dim, dtype=self.phi.dtype, device=self.phi.device)
        if self.bias0:
            m = torch.cat([m, enc_params[0][0]["bias"][None, :]], 0)
        for i, kind in enumerate(self.kinds):
            p = enc_params[i + 1][0]
            if kind == "sage_mean":
                rows = [m @ p["w1"], m @ p["w2"]]
            elif kind == "sage_gcn":
                rows = [m @ p["w1"]]
            else:  # gcn
                rows = [m @ p["w"]]
            b = p.get("bias")
            if b is None:
                b = torch.zeros((rows[0].shape[1],), dtype=self.phi.dtype,
                                device=self.phi.device)
            m = torch.cat(rows + [b[None, :]], 0)
        return m

    def logits(self, enc_params, rows: Tensor) -> Tensor:
        """(len(rows), d_out): gather K-wide collapsed rows, one small matmul."""
        return self.phi[rows] @ self.m_final(enc_params)

    def logits_all(self, enc_params) -> Tensor:
        return self.phi @ self.m_final(enc_params)


@torch.no_grad()
def build_linear_collapse(adj: FullGraphAdjacency, config: EncoderConfig,
                          features: Tensor, dtype=None) -> LinearCollapse:
    """One-time setup: propagate the constant feature matrix through the
    stage recurrences (one neighbour sum per GNN stage). ``features``: (N,
    >=feat_dim), on the adjacency's device."""
    if not linear_collapse_eligible(config, True):
        raise ValueError("the encoder is not a linear SAGE/GCN stack over one FEATURE stage")
    nbr_sum = make_nbr_sums(adj)
    dtype = dtype or features.dtype
    s0 = config.stages[0][0]
    n = adj.num_nodes
    kinds = tuple(_gnn_kind(stage[0]) for stage in config.stages[1:])
    f = features[:, s0.offset:s0.offset + s0.output_dim].to(dtype)
    if s0.activation.upper() not in ("", "NONE"):
        f = apply_activation(s0.activation, f)
    ones = torch.ones((n, 1), dtype=dtype, device=f.device)
    deg = (adj.in_deg + adj.out_deg).to(dtype)
    c = torch.cat([f, ones], 1) if s0.bias else f
    for kind in kinds:
        if kind == "sage_mean":
            d = nbr_sum(c) / torch.clamp(deg, min=1.0)[:, None]
            c = torch.cat([c, d, ones], 1)
        elif kind == "sage_gcn":
            a = (nbr_sum(c) + c) / (deg + 1.0)[:, None]
            c = torch.cat([a, ones], 1)
        else:  # gcn
            s = torch.sqrt(deg + 1.0)[:, None]
            scaled = c / s
            a = (nbr_sum(scaled) + scaled) / s
            c = torch.cat([a, ones], 1)
    return LinearCollapse(phi=c, num_nodes=n, feat_dim=int(s0.output_dim),
                          bias0=bool(s0.bias), kinds=kinds)
