"""Edge decoders for link prediction: DistMult / ComplEx / TransE.

Port of ``marius_tpu/nn/decoders/edge.py`` (relation operators and
comparators :33-126, ``EdgeDecoder.init_params`` :194-213 and
``node_corrupt_forward`` :235-261; reference nn/decoders/edge/*.cpp). The
decoder is an ``nn.Module`` whose relation tables are ``nn.Parameter``s
``relations`` and ``inverse_relations`` (the JAX version's params dict).

Chunked negative scoring is a batched matmul (``torch.bmm``) kept in full
float32: the port leaves ``torch.backends.cuda.matmul.allow_tf32`` False and
the float32 matmul precision at "highest", since TF32 would shift ranks.
``rel_corrupt_forward``, ``rel_all_scores``, ``only_pos_forward`` and the
custom-component registry wait for later slices; unknown names raise
``ValueError`` as in the JAX code.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Relation operators (relation_operators.cpp:7-46)
# ---------------------------------------------------------------------------


def hadamard(embs: Tensor, rels: Optional[Tensor]) -> Tensor:
    return embs if rels is None else embs * rels


def complex_hadamard(embs: Tensor, rels: Optional[Tensor]) -> Tensor:
    """Complex multiply with [re | im] packed halves (relation_operators.cpp:14-35)."""
    if rels is None:
        return embs
    real_len = embs.shape[-1] // 2
    re_e, im_e = embs[..., :real_len], embs[..., real_len:]
    re_r, im_r = rels[..., :real_len], rels[..., real_len:]
    return torch.cat([re_e * re_r - im_e * im_r, re_e * im_r + im_e * re_r], dim=-1)


def translation(embs: Tensor, rels: Optional[Tensor]) -> Tensor:
    return embs if rels is None else embs + rels


def no_op(embs: Tensor, rels: Optional[Tensor]) -> Tensor:
    return embs


# ---------------------------------------------------------------------------
# Comparators (comparators.cpp)
# ---------------------------------------------------------------------------


def dot_compare_pos(src: Tensor, dst: Tensor) -> Tensor:
    """(B, d) x (B, d) -> (B,) — DotCompare same-shape branch."""
    return (src * dst).sum(dim=-1)


def dot_compare_neg(src: Tensor, neg: Tensor, num_chunks: int) -> Tensor:
    """Chunked negative scoring: src (B, d) against neg (C, N, d) -> (B, N).

    Edges in chunk c score against that chunk's shared negatives, one batched
    matmul per chunk (comparators.cpp:63-77).
    """
    b, d = src.shape
    c, n, _ = neg.shape
    if c != num_chunks or b % num_chunks:
        raise ValueError(f"src {tuple(src.shape)} and neg {tuple(neg.shape)} "
                         f"do not split into {num_chunks} chunks")
    src_c = src.reshape(num_chunks, b // num_chunks, d)
    return torch.bmm(src_c, neg.transpose(1, 2)).reshape(b, n)


def l2_compare_pos(src: Tensor, dst: Tensor, eps: float = 1e-6) -> Tensor:
    """torch::pairwise_distance semantics: ||src - dst + eps||_2 (comparators.cpp:28)."""
    diff = src - dst + eps
    return torch.sqrt((diff * diff).sum(dim=-1))


def l2_compare_neg(src: Tensor, neg: Tensor, num_chunks: int, tol: float = 1e-8) -> Tensor:
    """Chunked pairwise L2 via x²+y²-2xy (comparators.cpp:30-40)."""
    b, d = src.shape
    c, n, _ = neg.shape
    src_c = src.reshape(num_chunks, b // num_chunks, d)
    x2 = (src_c * src_c).sum(dim=2)[:, :, None]
    y2 = (neg * neg).sum(dim=2)[:, None, :]
    xy = torch.bmm(src_c, neg.transpose(1, 2))
    return torch.sqrt((x2 + y2 - 2.0 * xy).clamp(min=tol)).reshape(b, n)


def cosine_compare_pos(src: Tensor, dst: Tensor) -> Tensor:
    """NOTE: reference CosineCompare (comparators.cpp:43-60) computes norms but
    returns the *unnormalized* dot product; we reproduce that behavior."""
    return (src * dst).sum(dim=-1)


def cosine_compare_neg(src: Tensor, neg: Tensor, num_chunks: int) -> Tensor:
    return dot_compare_neg(src, neg, num_chunks)


_COMPARATORS = {
    "DOT": (dot_compare_pos, dot_compare_neg),
    "L2": (l2_compare_pos, l2_compare_neg),
    "COSINE": (cosine_compare_pos, cosine_compare_neg),
}

_RELATION_OPS = {
    "HADAMARD": hadamard,
    "COMPLEX_HADAMARD": complex_hadamard,
    "TRANSLATION": translation,
    "NONE": no_op,
}

_DECODER_SPECS = {
    # decoder -> (comparator, relation_op, relation init style)
    "DISTMULT": ("DOT", "HADAMARD", "ones"),           # distmult.cpp
    "COMPLEX": ("DOT", "COMPLEX_HADAMARD", "re_ones"),  # complex.cpp
    "TRANSE": ("L2", "TRANSLATION", "zeros"),           # transe.cpp
}

#: the decoder types an ``EdgeDecoder`` can be built for
EDGE_DECODER_TYPES = tuple(_DECODER_SPECS)


def normalize_decoder_method(name: str) -> str:
    """EdgeDecoderMethod parse with the reference's aliases
    (getEdgeDecoderMethod, options.cpp:199-218: TRAIN -> CORRUPT_NODE,
    INFER -> ONLY_POS)."""
    up = str(name).upper()
    return {"TRAIN": "CORRUPT_NODE", "INFER": "ONLY_POS"}.get(up, up)


class EdgeDecoder(nn.Module):
    """A comparator ∘ relation-operator edge decoder (edge_decoder.cpp:7-21)."""

    def __init__(self, decoder_type: str, num_relations: int, embedding_dim: int,
                 use_inverse_relations: bool = True,
                 decoder_method: str = "CORRUPT_NODE",
                 dtype=torch.float32, device=None):
        super().__init__()
        dt = decoder_type.upper()
        if dt not in EDGE_DECODER_TYPES:
            raise ValueError(f"Unknown edge decoder: {decoder_type}")
        self.decoder_type = decoder_type
        self.num_relations = num_relations
        self.embedding_dim = embedding_dim
        self.use_inverse_relations = use_inverse_relations
        self.decoder_method = decoder_method
        comparator, rel_op, self._init_style = _DECODER_SPECS[dt]
        self._pos_fn, self._neg_fn = _COMPARATORS[comparator]
        self._rel_op = _RELATION_OPS[rel_op]
        shape = (num_relations, embedding_dim)
        self.relations = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
        if use_inverse_relations:
            self.inverse_relations = nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device))
        self.init_params()

    @torch.no_grad()
    def init_params(self) -> None:
        """Reset the relation tables (distmult/complex/transe.cpp reset)."""
        for p in self.parameters():
            if self._init_style == "ones":
                p.fill_(1.0)
            elif self._init_style == "zeros":
                p.zero_()
            else:  # re_ones: real half 1, imaginary half 0 (complex.cpp reset)
                p.zero_()
                p[:, :p.shape[1] // 2] = 1.0

    # -- scoring ------------------------------------------------------------

    def apply_relation(self, embs: Tensor, rels: Optional[Tensor]) -> Tensor:
        return self._rel_op(embs, rels)

    def select_relations(self, rel_ids: Optional[Tensor], inverse: bool = False):
        if rel_ids is None:
            return None
        table = self.inverse_relations if inverse else self.relations
        return table[rel_ids]

    def pos_scores(self, adjusted_src: Tensor, dst: Tensor) -> Tensor:
        return self._pos_fn(adjusted_src, dst)

    def neg_scores(self, adjusted_src: Tensor, neg_embs: Tensor, num_chunks: int) -> Tensor:
        return self._neg_fn(adjusted_src, neg_embs, num_chunks)

    def node_corrupt_forward(
        self,
        src: Tensor,                       # (B, d) source node embeddings
        dst: Tensor,                       # (B, d) destination node embeddings
        rel_ids: Optional[Tensor],         # (B,) or None for untyped graphs
        dst_neg_embs: Tensor,              # (C, N, d) negatives replacing dst
        src_neg_embs: Optional[Tensor],    # (C, N, d) negatives replacing src
    ):
        """Corrupt-node scoring for both directions (decoder_methods.cpp:57-117).

        Returns (pos, neg, inv_pos, inv_neg); inv_* are None unless
        use_inverse_relations and src_neg_embs are given.
        """
        num_chunks = dst_neg_embs.shape[0]
        adj_src = self.apply_relation(src, self.select_relations(rel_ids))
        pos = self.pos_scores(adj_src, dst)
        neg = self.neg_scores(adj_src, dst_neg_embs, num_chunks)

        inv_pos = inv_neg = None
        if self.use_inverse_relations and src_neg_embs is not None:
            adj_dst = self.apply_relation(dst, self.select_relations(rel_ids, inverse=True))
            inv_pos = self.pos_scores(adj_dst, src)
            inv_neg = self.neg_scores(adj_dst, src_neg_embs, num_chunks)
        return pos, neg, inv_pos, inv_neg
