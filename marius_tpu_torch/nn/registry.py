"""User-extensible registries: custom GNN layers, stage layers, edge
decoders, comparators/relation operators, and losses.

Port of ``marius_tpu/nn/registry.py`` (reference python trampolines,
layer_wrap.cpp:10-22, decoder_wrap.cpp, loss_wrap.cpp). A component is a
pair of plain functions (init, forward) registered under a name; the name
then works everywhere the built-in names do, YAML configs included, because
the encoder, decoder and loss dispatchers and the config validator consult
these tables. The functions take and return ``torch`` tensors; an init
function takes a ``torch.Generator`` where the JAX one takes a key.

Example::

    from marius_tpu_torch.nn import registry

    def my_init(generator, cfg, dtype):
        return {"w": torch.randn(cfg.input_dim, cfg.output_dim, generator=generator,
                                 device=generator.device, dtype=dtype)}

    def my_forward(cfg, params, x, adj, **ctx):
        nbr = masked_mean(x[adj.in_nbr_idx.long()], adj.in_mask)
        return (x[adj.self_idx.long()] + nbr) @ params["w"]

    registry.register_gnn_layer("MY_SAGE", my_init, my_forward)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

# name -> (init_fn(generator, layer_config, dtype) -> params,
#          forward_fn(layer_config, params, x, adj, **ctx) -> Tensor)
# ctx kwargs: degrees, node_ids_outer, train, dropout_key (the stage's
# nn.layers.DropoutKey, or None)
_GNN_LAYERS: Dict[str, Tuple[Callable, Callable]] = {}

# name -> (init_fn(generator, layer_config, dtype) -> params,
#          forward_fn(layer_config, params, current, embeddings, features) -> Tensor)
_STAGE_LAYERS: Dict[str, Tuple[Callable, Callable]] = {}

# name -> loss_fn(pos_scores, neg_scores, *, reduction, mask=None, neg_mask=None) -> scalar
_LOSSES: Dict[str, Callable] = {}

# name -> (comparator_name, relation_op_name, relation_init)
# relation_init: "ones" | "zeros" | "re_ones" | callable(shape, dtype) -> Tensor
_EDGE_DECODERS: Dict[str, Tuple[str, str, object]] = {}

# name -> (pos_fn(adjusted_src, dst) -> (B,),
#          neg_fn(adjusted_src, neg_embs, num_chunks) -> (B, N))
_COMPARATORS: Dict[str, Tuple[Callable, Callable]] = {}

# name -> fn(embs, rels) -> Tensor
_RELATION_OPS: Dict[str, Callable] = {}


def _put(table: Dict, kind: str, name: str, value) -> None:
    key = name.upper()
    if not key or not key.replace("_", "").isalnum():
        raise ValueError(f"bad {kind} name: {name!r}")
    table[key] = value


def register_gnn_layer(name: str, init_fn: Callable, forward_fn: Callable) -> None:
    """Register a GNN layer usable as ``gnn_type: <name>`` in encoder stages."""
    _put(_GNN_LAYERS, "gnn layer", name, (init_fn, forward_fn))


def register_stage_layer(name: str, init_fn: Callable, forward_fn: Callable) -> None:
    """Register a non-GNN stage layer usable as ``type: <name>``."""
    _put(_STAGE_LAYERS, "stage layer", name, (init_fn, forward_fn))


def register_loss(name: str, loss_fn: Callable) -> None:
    """Register a score loss usable as ``model.loss.type: <name>``."""
    _put(_LOSSES, "loss", name, loss_fn)


def register_comparator(name: str, pos_fn: Callable, neg_fn: Callable) -> None:
    _put(_COMPARATORS, "comparator", name, (pos_fn, neg_fn))


def register_relation_op(name: str, fn: Callable) -> None:
    _put(_RELATION_OPS, "relation op", name, fn)


def register_edge_decoder(name: str, comparator: str, relation_op: str,
                          relation_init="ones") -> None:
    """Register an edge decoder as a comparator∘relation-op composition
    (DISTMULT = DOT∘HADAMARD etc., edge_decoder.cpp:7-21). ``comparator`` and
    ``relation_op`` may be built-in or registered names; ``relation_init`` a
    style string or a callable ``(shape, dtype) -> Tensor``."""
    _put(_EDGE_DECODERS, "edge decoder", name,
         (comparator.upper(), relation_op.upper(), relation_init))


def gnn_layer(name: str) -> Optional[Tuple[Callable, Callable]]:
    return _GNN_LAYERS.get(name.upper())


def stage_layer(name: str) -> Optional[Tuple[Callable, Callable]]:
    return _STAGE_LAYERS.get(name.upper())


def loss(name: str) -> Optional[Callable]:
    return _LOSSES.get(name.upper())


def comparator(name: str) -> Optional[Tuple[Callable, Callable]]:
    return _COMPARATORS.get(name.upper())


def relation_op(name: str) -> Optional[Callable]:
    return _RELATION_OPS.get(name.upper())


def edge_decoder(name: str) -> Optional[Tuple[str, str, object]]:
    return _EDGE_DECODERS.get(name.upper())
