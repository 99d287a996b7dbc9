"""Model: encoder + decoder + loss + optimizers, and the per-batch LP and NC math.

Port of ``marius_tpu/nn/model.py`` (Model :32-59, init_model_params :62-67,
lp_batch_loss :70-98, lp_batch_loss_direct :101-134, lp_batch_loss_rel
:137-160, nc_batch_loss :163-167; reference nn/model.cpp forward_nc :246-250, forward_lp :252-288
and train_batch :290-333). ``Model`` is a description that owns its
``EdgeDecoder`` module, whose relation tables are the decoder parameters; the
encoder's parameters are plain tensors. The params structure is the JAX
package's: ``{"encoder": [[{...}]], "decoder": {"relations": ...,
"inverse_relations": ...}}``, where the decoder entries are the module's own
``nn.Parameter``s; a node-classification model has ``decoder=None`` and no
"decoder" entry. ``init_model_params(..., dtype)`` gives the encoder and
the decoder's tables that dtype, as JAX's does (bf16 models).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
from marius_tpu_torch.nn.encoder import EncoderConfig, init_encoder_params
from marius_tpu_torch.nn.losses import classification_cross_entropy, get_loss_function
from marius_tpu_torch.nn.optimizers import OptimizerConfig

Tensor = torch.Tensor

LINK_PREDICTION = "LINK_PREDICTION"
NODE_CLASSIFICATION = "NODE_CLASSIFICATION"


@dataclasses.dataclass(frozen=True)
class Model:
    learning_task: str
    encoder: EncoderConfig
    decoder: Optional[EdgeDecoder] = None       # None -> NoOp node decoder
    loss_type: str = "SOFTMAX_CE"
    loss_reduction: str = "SUM"
    loss_margin: float = 0.1
    loss_scale: float = 1.0
    dense_optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig("ADAM", learning_rate=0.1))
    sparse_lr: float = 0.1                       # embedding-table Adagrad lr

    def loss_fn(self):
        f = get_loss_function(self.loss_type, reduction=self.loss_reduction,
                              margin=self.loss_margin)
        if self.loss_scale == 1.0:
            return f
        scale = self.loss_scale
        return lambda *a, **kw: f(*a, **kw) * scale

    @property
    def has_embeddings(self) -> bool:
        return self.encoder.has_embeddings


def init_model_params(generator: torch.Generator, model: Model,
                      dtype=torch.float32) -> Dict[str, Any]:
    """Fresh encoder parameters (on the generator's device) and the decoder's
    relation tables, cast to ``dtype`` and reset to their initial values.
    Every leaf requires grad."""
    encoder = init_encoder_params(generator, model.encoder, dtype)
    for stage in encoder:
        for layer in stage:
            for p in layer.values():
                p.requires_grad_(True)
    params: Dict[str, Any] = {"encoder": encoder}
    if model.decoder is not None:
        model.decoder.to(dtype=dtype)
        model.decoder.init_params()
        params["decoder"] = dict(model.decoder.named_parameters())
    return params


def lp_batch_loss(
    model: Model,
    encoded: Tensor,                  # (U, d) representations of the batch's unique nodes
    inv_src: Tensor,                  # (B,) positions of edge sources in `encoded`
    inv_dst: Tensor,                  # (B,)
    rel_ids: Optional[Tensor],        # (B,) or None
    inv_dst_negs: Tensor,             # (C, N) positions of dst-corruption negatives
    inv_src_negs: Optional[Tensor],   # (C, N) or None
    edge_mask: Tensor,                # (B,) valid edges
    dst_neg_filter: Optional[Tensor] = None,  # (B, N) True = false negative
    src_neg_filter: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Corrupt-node LP loss for one batch (train_batch, model.cpp:290-333).

    Returns (loss, aux) where aux carries the raw scores.
    """
    c, n = inv_dst_negs.shape
    d = encoded.shape[-1]
    src = encoded[inv_src]
    dst = encoded[inv_dst]
    dst_negs = encoded[inv_dst_negs.reshape(-1)].reshape(c, n, d)
    src_negs = None
    if inv_src_negs is not None:
        src_negs = encoded[inv_src_negs.reshape(-1)].reshape(c, n, d)
    return lp_batch_loss_direct(model, src, dst, rel_ids, dst_negs, src_negs,
                                edge_mask, dst_neg_filter, src_neg_filter)


def lp_batch_loss_direct(
    model: Model,
    src: Tensor,                      # (B, d) source embeddings
    dst: Tensor,                      # (B, d)
    rel_ids: Optional[Tensor],
    dst_negs: Tensor,                 # (C, N, d) dst-corruption negative embeddings
    src_negs: Optional[Tensor],
    edge_mask: Tensor,
    dst_neg_filter: Optional[Tensor] = None,
    src_neg_filter: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """lp_batch_loss on pre-gathered embeddings (the trainer's [src; dst; negs]
    batch layout is sliced, not gathered)."""
    decoder = model.decoder
    if decoder is None:
        raise ValueError("link prediction needs an edge decoder")
    pos, neg, inv_pos, inv_neg = decoder.node_corrupt_forward(
        src, dst, rel_ids, dst_negs, src_negs)

    # score filters push known true edges to -1e9 (apply_score_filter)
    if dst_neg_filter is not None:
        neg = neg.masked_fill(dst_neg_filter, -1e9)
    if inv_neg is not None and src_neg_filter is not None:
        inv_neg = inv_neg.masked_fill(src_neg_filter, -1e9)

    loss_fn = model.loss_fn()
    loss = loss_fn(pos, neg, mask=edge_mask)
    if inv_neg is not None:
        loss = loss + loss_fn(inv_pos, inv_neg, mask=edge_mask)

    aux = {"pos": pos, "neg": neg, "inv_pos": inv_pos, "inv_neg": inv_neg}
    return loss, aux


def lp_batch_loss_rel(
    model: Model,
    src: Tensor,                      # (B, d) source embeddings
    dst: Tensor,                      # (B, d)
    rel_ids: Tensor,                  # (B,) true relation ids
    neg_rel_ids: Tensor,              # (C, N) corrupting relation ids
    edge_mask: Tensor,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """CORRUPT_REL LP loss (EdgeDecoderMethod::CORRUPT_REL, model.cpp:271-273,
    where the reference throws; here it trains): negatives re-score each
    chunk's positives under sampled relations, both directions when inverse
    relations are on (decoder_methods.cpp:119-146)."""
    decoder = model.decoder
    if decoder is None:
        raise ValueError("link prediction needs an edge decoder")
    pos, neg, inv_pos, inv_neg = decoder.rel_corrupt_forward(src, dst, rel_ids, neg_rel_ids)
    loss_fn = model.loss_fn()
    loss = loss_fn(pos, neg, mask=edge_mask)
    if inv_neg is not None:
        loss = loss + loss_fn(inv_pos, inv_neg, mask=edge_mask)
    aux = {"pos": pos, "neg": neg, "inv_pos": inv_pos, "inv_neg": inv_neg}
    return loss, aux


def nc_batch_loss(model: Model, logits: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    """Node-classification CE over seed logits (model.cpp:318-320)."""
    loss = classification_cross_entropy(logits, labels, reduction=model.loss_reduction,
                                        mask=mask)
    return loss * model.loss_scale if model.loss_scale != 1.0 else loss
