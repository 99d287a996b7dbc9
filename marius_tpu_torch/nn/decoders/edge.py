"""Edge decoders for link prediction: DistMult / ComplEx / TransE.

Port of ``marius_tpu/nn/decoders/edge.py`` (relation operators and
comparators :33-126, ``EdgeDecoder.init_params`` :194-213 and
``node_corrupt_forward`` :235-261, ``rel_corrupt_forward`` :263-308,
``rel_all_scores`` :310-323, ``only_pos_forward`` :325-334; reference
nn/decoders/edge/*.cpp). The
decoder is an ``nn.Module`` whose relation tables are ``nn.Parameter``s
``relations`` and ``inverse_relations`` (the JAX version's params dict).

Chunked negative scoring is a batched matmul (``torch.bmm``) kept in full
float32: the port leaves ``torch.backends.cuda.matmul.allow_tf32`` False and
the float32 matmul precision at "highest", since TF32 would shift ranks.
Decoders, comparators and relation operators registered in
``nn/registry.py`` work as the built-in ones do (JAX :141-158, :183-193);
unknown names raise ``ValueError`` as in the JAX code.

bf16 tables: JAX's ``dot_general`` takes ``preferred_element_type=float32``,
so the chunked matmul of bf16 rows returns float32 scores, products summed in
float32. ``_bmm`` does the same by multiplying the float32 copies of the rows
(every product of two bf16 numbers is exact in float32); float32 inputs go
straight to ``torch.bmm``.
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
    return _bmm(src_c, neg.transpose(1, 2)).reshape(b, n)


def _bmm(a: Tensor, b: Tensor) -> Tensor:
    """``torch.bmm`` with float32 output and accumulation for any input
    float type (JAX's ``preferred_element_type=float32``)."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b)


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
    xy = _bmm(src_c, neg.transpose(1, 2))
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

def _lookup_comparator(name: str):
    if name in _COMPARATORS:
        return _COMPARATORS[name]
    from marius_tpu_torch.nn import registry
    custom = registry.comparator(name)
    if custom is None:
        raise ValueError(f"Unknown comparator: {name}")
    return custom


def _lookup_relation_op(name: str):
    if name in _RELATION_OPS:
        return _RELATION_OPS[name]
    from marius_tpu_torch.nn import registry
    custom = registry.relation_op(name)
    if custom is None:
        raise ValueError(f"Unknown relation operator: {name}")
    return custom


def decoder_spec(decoder_type: str):
    """(comparator, relation op, relation init) of a built-in or registered
    decoder type, or None."""
    dt = decoder_type.upper()
    if dt in _DECODER_SPECS:
        return _DECODER_SPECS[dt]
    from marius_tpu_torch.nn import registry
    return registry.edge_decoder(dt)


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
        spec = decoder_spec(decoder_type)
        if spec is None:
            raise ValueError(f"Unknown edge decoder: {decoder_type}")
        self.decoder_type = decoder_type
        self.num_relations = num_relations
        self.embedding_dim = embedding_dim
        self.use_inverse_relations = use_inverse_relations
        self.decoder_method = decoder_method
        comparator, rel_op, self._init_style = spec
        self._pos_fn, self._neg_fn = _lookup_comparator(comparator)
        self._rel_op = _lookup_relation_op(rel_op)
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
            if callable(self._init_style):   # a registered decoder's own init
                p.copy_(torch.as_tensor(self._init_style(tuple(p.shape), p.dtype)))
            elif self._init_style == "ones":
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

    def rel_corrupt_forward(
        self,
        src: Tensor,            # (B, d)
        dst: Tensor,            # (B, d)
        rel_ids: Tensor,        # (B,)
        neg_rel_ids: Tensor,    # (C, N) corrupting relation ids
    ):
        """Corrupt-relation scoring (decoder_methods.cpp:119-146): positives
        score (src, r, dst); chunk i's positives are re-scored under chunk
        i's sampled relations; with inverse relations the inverse direction
        re-scores (dst, r'^-1, src) under the inverse table
        (decoder_methods.cpp:137-142).

        Returns (pos (B,), neg (B, N), inv_pos, inv_neg), inv_* None without
        inverse relations, as node_corrupt_forward.
        """
        c, n = neg_rel_ids.shape
        b, d = src.shape
        pos = self.pos_scores(self.apply_relation(src, self.select_relations(rel_ids)), dst)

        def corrupt(anchor, other, inverse):
            # (C, N, d) relation rows; each (positive, sampled relation) pair
            # of a chunk is scored like a positive: (C, B/C, N, d) operands
            neg_rels = self.select_relations(neg_rel_ids.reshape(-1), inverse=inverse)
            a_c = anchor.reshape(c, b // c, 1, d)
            o_c = other.reshape(c, b // c, 1, d)
            adj = self.apply_relation(a_c, neg_rels.reshape(c, 1, n, d))
            return self.pos_scores(adj.reshape(-1, d),
                                   o_c.expand(adj.shape).reshape(-1, d)).reshape(b, n)

        neg = corrupt(src, dst, inverse=False)
        inv_pos = inv_neg = None
        if self.use_inverse_relations:
            inv_rels = self.select_relations(rel_ids, inverse=True)
            inv_pos = self.pos_scores(self.apply_relation(dst, inv_rels), src)
            inv_neg = corrupt(dst, src, inverse=True)
        return pos, neg, inv_pos, inv_neg

    def rel_all_scores(self, src: Tensor, dst: Tensor, inverse: bool = False,
                       table: Optional[Tensor] = None) -> Tensor:
        """Every relation's score for each (src, dst) pair: (B, R), the
        relation-ranking counterpart of all-node scoring. ``table`` defaults
        to the module's own (inverse) relation table."""
        b, d = src.shape
        if table is None:
            table = self.inverse_relations if inverse else self.relations
        r = table.shape[0]
        adj = self.apply_relation(src[:, None, :], table[None, :, :])   # (B, R, d)
        return self.pos_scores(adj.reshape(-1, d),
                               dst[:, None, :].expand(adj.shape).reshape(-1, d)).reshape(b, r)

    def only_pos_forward(self, src: Tensor, dst: Tensor, rel_ids: Optional[Tensor]):
        """Positive-edge scores only (decoder_methods.cpp:7-42): (pos, inv_pos),
        inv_pos None without inverse relations or relation ids."""
        pos = self.pos_scores(self.apply_relation(src, self.select_relations(rel_ids)), dst)
        inv_pos = None
        if self.use_inverse_relations and rel_ids is not None:
            inv_rels = self.select_relations(rel_ids, inverse=True)
            inv_pos = self.pos_scores(self.apply_relation(dst, inv_rels), src)
        return pos, inv_pos
