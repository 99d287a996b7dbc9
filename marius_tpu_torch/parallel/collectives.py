"""Explicit collectives for a row-sharded embedding table, and the sharded
link-prediction step.

Port of ``marius_tpu/parallel/collectives.py``. The table is range-sharded
over the mesh's ``node`` axis: node index i owns rows ``[i * S, (i + 1) * S)``
(S = the shard's rows). Where the JAX package runs these functions inside
``shard_map`` and names the axis, here every rank runs them on its own
tensors and names the axis of its :class:`~marius_tpu_torch.parallel.mesh.Mesh`.

- ``sharded_gather``: every rank gathers the requested rows it owns with the
  row-gather kernel (``ops/cuda/gather.py``), zeroes the others, and one
  ``all_reduce(SUM)`` over the node axis assembles the whole (K, d) block.
- ``sharded_gather_inner_grad``: the same forward as an autograd function
  whose backward is the identity on the summed rows (JAX :57-68): each rank
  sums the occurrences it owns into a shard-shaped accumulator with one
  extra row that takes the others (``index_add_`` has no drop mode).
- ``sharded_scatter_add`` / ``sharded_adagrad_update``: updates applied by
  the owning rank only, with no communication. The Adagrad rule runs as the
  Adagrad kernel (``ops/cuda/adagrad.py``) over every row of the shard with
  the summed gradient G, which is JAX's elementwise rule on the shard
  (:96-100) bit for bit: rows with G = 0 stay as they are.

``make_sharded_lp_update`` and ``make_sharded_gnn_lp_update`` build the
explicit train step over a (data x node) mesh. Every rank holds the whole
batch; ``_lp_batch_specs`` takes its data index's contiguous positives and
contiguous negative chunks, as JAX's ``shard_map`` specs do (:103-123). A step
makes 2 collectives in float32: the gather's all_reduce over the node axis,
and one all_reduce over the data axis of G, the dense gradients and the
loss, flattened into one buffer per dtype (``_apply_sharded_updates``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from marius_tpu_torch.nn.optimizers import apply_optimizer, tree_leaves, tree_map
from marius_tpu_torch.ops.cuda import adagrad as adagrad_kernel
from marius_tpu_torch.ops.cuda import gather as gather_kernel
from marius_tpu_torch.parallel.mesh import DATA_AXIS, NODE_AXIS, Mesh, shard_rows

Tensor = torch.Tensor


def _owned(ids: Tensor, shard_size: int, me: int) -> Tuple[Tensor, Tensor]:
    """(local row of each id, whether this rank owns it)."""
    local = ids - me * shard_size
    return local, (local >= 0) & (local < shard_size)


def _gather_owned(table_shard: Tensor, local: Tensor, mine: Tensor, mesh: Mesh,
                  axis: str) -> Tensor:
    # the kernel reads row clamp(local, 0, S - 1): rows not owned read a
    # real row of the shard and are zeroed here
    rows = gather_kernel.gather_rows(table_shard.detach(), local)
    rows.masked_fill_(~mine[:, None], 0)
    return mesh.all_reduce(rows, axis)


def sharded_gather(table_shard: Tensor, ids: Tensor, mesh: Mesh,
                   axis: str = NODE_AXIS) -> Tensor:
    """Global rows ``ids`` (the same on every rank of ``axis``) from a
    row-sharded table: the whole (K, d) block on every rank of the axis.
    K * d elements cross the axis, whatever the table's size."""
    local, mine = _owned(ids, table_shard.shape[0], mesh.axis_index(axis))
    return _gather_owned(table_shard, local, mine, mesh, axis)


class _InnerGradGather(torch.autograd.Function):
    """Forward: ``sharded_gather``. Backward: the summed rows' gradient goes
    to the owned occurrences unchanged (d(sum_j rows_j)/d(rows_i) = I), summed
    into the shard's rows; the others fall into a padding row."""

    @staticmethod
    def forward(ctx, table_shard, ids, mesh, axis):
        shard_size = table_shard.shape[0]
        local, mine = _owned(ids, shard_size, mesh.axis_index(axis))
        ctx.save_for_backward(torch.where(mine, local, shard_size))
        ctx.shard_size = shard_size
        return _gather_owned(table_shard, local, mine, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        (safe,) = ctx.saved_tensors
        acc = torch.zeros((ctx.shard_size + 1, grad.shape[1]), dtype=grad.dtype,
                          device=grad.device)
        acc.index_add_(0, safe, grad)
        return acc[:ctx.shard_size], None, None, None


def sharded_gather_inner_grad(table_shard: Tensor, ids: Tensor, mesh: Mesh,
                              axis: str = NODE_AXIS) -> Tensor:
    """``sharded_gather`` whose gradient with respect to ``table_shard`` is
    the shard's own rows' summed gradient (pass a tensor that requires grad,
    e.g. ``values.detach().requires_grad_()``)."""
    return _InnerGradGather.apply(table_shard, ids, mesh, axis)


def _owned_sum(shard_size: int, ids: Tensor, values: Tensor, mesh: Mesh,
               axis: str) -> Tensor:
    """(S + 1, d): the owned occurrences of ``values`` summed per local row;
    row S takes the ids this rank does not own."""
    local, mine = _owned(ids, shard_size, mesh.axis_index(axis))
    acc = torch.zeros((shard_size + 1, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return acc.index_add_(0, torch.where(mine, local, shard_size), values)


def sharded_scatter_add(table_shard: Tensor, ids: Tensor, values: Tensor, mesh: Mesh,
                        axis: str = NODE_AXIS) -> Tensor:
    """The shard plus the (K, d) ``values`` (the same on every rank) at the
    ids it owns, duplicates summed; a new tensor. No communication."""
    return table_shard + _owned_sum(table_shard.shape[0], ids, values, mesh, axis)[:-1]


def sharded_adagrad_update(values_shard: Tensor, state_shard: Tensor, ids: Tensor,
                           grads: Tensor, lr: float, mesh: Mesh,
                           axis: str = NODE_AXIS) -> Tuple[Tensor, Tensor]:
    """Row-sparse Adagrad on a sharded table, in place: G = the owned
    per-occurrence grads summed per row (ids need not be unique), then the
    Adagrad kernel over every row of the shard. Returns the shard's tensors."""
    shard_size = values_shard.shape[0]
    G = _owned_sum(shard_size, ids, grads, mesh, axis)
    rows = torch.arange(shard_size, device=values_shard.device)
    adagrad_kernel.sparse_adagrad_update_(values_shard, state_shard, rows, G[:shard_size], lr)
    return values_shard, state_shard


def _lp_batch_specs(batch: Dict[str, Optional[Tensor]], mesh: Mesh,
                    data_axis: Optional[str]) -> Dict[str, Optional[Tensor]]:
    """This rank's part of the whole batch: rows ``[i * B/D, (i + 1) * B/D)``
    of the per-edge entries (src, dst, rel, mask, the filters) and chunks
    ``[i * C/D, (i + 1) * C/D)`` of the negatives, i the data index (JAX's
    ``P(data)`` / ``P(data, None)`` specs). Without a data axis, the whole batch."""
    if data_axis is None:
        return dict(batch)
    n, i = mesh.shape[data_axis], mesh.axis_index(data_axis)

    def part(t):
        if t is None:
            return None
        step = t.shape[0] // n
        return t[i * step:(i + 1) * step]

    return {k: part(v) for k, v in batch.items()}


def _mean_weight(mask: Tensor, mean: bool, total_mask: Tensor):
    """Exact MEAN reweighting: the global mean is the sum over data indices
    of the local mean times local_count / total_count (the loss's own
    denominators cancel). Every rank holds the whole batch's mask
    (``total_mask``), so the total needs no collective (JAX psums it)."""
    if not mean:
        return 1.0
    local_count = mask.float().sum()
    return local_count / total_mask.float().sum().clamp_min(1.0)


def _apply_sharded_updates(model, values: Tensor, state: Tensor, params, opt_state,
                           loss: Tensor, G: Tensor, gdense, mesh: Mesh,
                           data_axis: Optional[str]):
    """The explicit steps' epilogue: sum the data indices' G, dense
    gradients and loss (one all_reduce per dtype over the data axis, the NCCL
    all_reduce of the reference, model.cpp:136-159), then the owner-local
    Adagrad (the kernel over every row of the shard) and the dense optimizer.
    Returns (opt_state, loss)."""
    parts = [G, loss.reshape(1)] + tree_leaves(gdense)
    if data_axis is not None:
        by_dtype: Dict[torch.dtype, list] = {}
        for t in parts:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in group]), data_axis)
            for t, piece in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(piece.view_as(t))
    rows = torch.arange(values.shape[0], device=values.device)
    adagrad_kernel.sparse_adagrad_update_(values, state, rows, G, model.sparse_lr)
    _, opt_state = apply_optimizer(model.dense_optimizer, params, opt_state, gdense)
    return opt_state, loss


def _grads(loss: Tensor, v: Tensor, params):
    """(dL/dshard, dense gradients shaped like ``params``; zeros where unused)."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, [v] + leaves, allow_unused=True)
    filled = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, [v] + leaves)]
    it = iter(filled[1:])
    return filled[0], tree_map(lambda _: next(it), params)


def _batch_ids(local: Dict[str, Optional[Tensor]]) -> Tensor:
    """[src; dst; dst_negs; src_negs] of the rank's part of the batch."""
    parts = [local["src"], local["dst"], local["dst_negs"].reshape(-1)]
    if local.get("src_negs") is not None:
        parts.append(local["src_negs"].reshape(-1))
    return torch.cat(parts)


def _is_mean(model, mesh: Mesh, num_nodes_padded: int) -> bool:
    """Whether the loss is MEAN; raises on a reduction other than SUM/MEAN and
    on table rows the node axis does not divide."""
    shard_rows(num_nodes_padded, mesh)
    reduction = model.loss_reduction.upper()
    if reduction not in ("SUM", "MEAN"):
        raise ValueError(f"the explicit step reduces SUM or MEAN losses, got {reduction}")
    return reduction == "MEAN"


def make_sharded_lp_update(model, mesh: Mesh, num_nodes_padded: int,
                           node_axis: str = NODE_AXIS,
                           data_axis: Optional[str] = DATA_AXIS) -> Callable:
    """The explicit LP train update over a (data x node) mesh, shallow
    encoders (JAX :153-240).

    The table and its Adagrad state are row-sharded over ``node_axis``; the
    batch is split over ``data_axis``. Each rank gathers its part's rows with
    one all_reduce over the node axis, scores them, and takes the gradient
    with respect to its shard; G, the dense gradients and the loss are summed
    over the data axis, so rows touched by several data indices combine as
    on one device; MEAN stays exact through ``_mean_weight``. The dense
    optimizer and the Adagrad kernel run on every rank.

    Returns ``update(values, state, params, opt_state, batch) -> (opt_state,
    loss)``, which updates ``values``, ``state`` and ``params`` in place;
    ``batch`` is the WHOLE batch: src, dst, mask, dst_negs, rel, src_negs,
    dst_filter, src_filter (None where absent). ``loss`` is the whole batch's.
    """
    from marius_tpu_torch.nn.encoder import encoder_forward
    from marius_tpu_torch.nn.model import lp_batch_loss_direct

    mean = _is_mean(model, mesh, num_nodes_padded)

    def update(values, state, params, opt_state, batch):
        local = _lp_batch_specs(batch, mesh, data_axis)
        b = local["src"].shape[0]
        c, nneg = local["dst_negs"].shape
        inverse = local.get("src_negs") is not None
        w = _mean_weight(local["mask"], mean, batch["mask"])
        v = values.detach().requires_grad_(True)
        x = sharded_gather_inner_grad(v, _batch_ids(local), mesh, node_axis)
        # shallow stages only: no GNN, no dropout
        x = encoder_forward(model.encoder, params["encoder"], x, None, None, train=True)
        d = x.shape[-1]
        loss, _ = lp_batch_loss_direct(
            model, x[:b], x[b:2 * b], local.get("rel"),
            x[2 * b:2 * b + c * nneg].reshape(c, nneg, d),
            x[2 * b + c * nneg:].reshape(c, nneg, d) if inverse else None,
            local["mask"], local.get("dst_filter"), local.get("src_filter"))
        loss = loss * w
        G, gdense = _grads(loss, v, params)
        return _apply_sharded_updates(model, values, state, params, opt_state,
                                      loss.detach(), G, gdense, mesh, data_axis)

    return update


def make_sharded_gnn_lp_update(model, mesh: Mesh, num_nodes_padded: int, nbr_configs,
                               hop_caps_local, unique_cap_local: int, num_nodes: int,
                               node_axis: str = NODE_AXIS,
                               data_axis: Optional[str] = DATA_AXIS,
                               has_features: bool = False) -> Callable:
    """The explicit LP train update for GNN encoders (and EMBEDDING +
    FEATURE encoders without hops) over a (data x node) mesh (JAX :243-366).

    The graph, features and degrees are replicated (read only). Each rank:
    dedups its part's ids (``ops/unique.py``), expands them through the
    neighbour sampler with ``draws`` (the caller seeds them from the seed and
    the data index, as JAX folds the shard index into its keys: ALL sampling
    draws nothing and gives the single-device trajectory), gathers the outer
    hop with ``sharded_gather_inner_grad``, runs the encoder (its SAGE layers
    through the gather-sum kernel), scores, and ends as the shallow step.

    Returns ``update(values, state, params, opt_state, batch, graph,
    features, degrees, draws, dropout_key) -> (opt_state, loss, overflow)``.
    """
    from marius_tpu_torch.data.samplers.neighbor import sample_neighbor_batch
    from marius_tpu_torch.nn.encoder import encoder_forward
    from marius_tpu_torch.nn.model import lp_batch_loss
    from marius_tpu_torch.ops.unique import unique_padded

    if not model.has_embeddings:
        raise ValueError("the explicit GNN step shards the embedding table")
    mean = _is_mean(model, mesh, num_nodes_padded)
    nbr_configs = tuple(nbr_configs)
    hop_caps_local = tuple(int(h) for h in hop_caps_local)

    def update(values, state, params, opt_state, batch, graph, features, degrees,
               draws, dropout_key):
        local = _lp_batch_specs(batch, mesh, data_axis)
        b = local["src"].shape[0]
        c, nneg = local["dst_negs"].shape
        inverse = local.get("src_negs") is not None
        w = _mean_weight(local["mask"], mean, batch["mask"])

        uniq = unique_padded(_batch_ids(local), size=unique_cap_local, fill_value=num_nodes)
        pos = uniq.inverse
        nbr_batch = None
        outer = uniq.ids
        overflow = None
        if nbr_configs:
            nbr_batch = sample_neighbor_batch(draws, graph, uniq.ids, uniq.ids < num_nodes,
                                              nbr_configs, hop_caps_local)
            outer = nbr_batch.node_ids[0]
            overflow = nbr_batch.overflow
        # the (N + 1)-row feature block: the padding id reads its zero row
        feats = gather_kernel.gather_rows(features, outer) if has_features else None
        v = values.detach().requires_grad_(True)
        x0 = sharded_gather_inner_grad(v, outer, mesh, node_axis)
        encoded = encoder_forward(model.encoder, params["encoder"], x0, feats, nbr_batch,
                                  degrees=degrees, train=True, dropout_key=dropout_key)
        loss, _ = lp_batch_loss(
            model, encoded, pos[:b], pos[b:2 * b], local.get("rel"),
            pos[2 * b:2 * b + c * nneg].reshape(c, nneg),
            pos[2 * b + c * nneg:].reshape(c, nneg) if inverse else None,
            local["mask"], local.get("dst_filter"), local.get("src_filter"))
        loss = loss * w
        G, gdense = _grads(loss, v, params)
        opt_state, loss = _apply_sharded_updates(model, values, state, params, opt_state,
                                                 loss.detach(), G, gdense, mesh, data_axis)
        return opt_state, loss, overflow

    return update


def make_sharded_lp_step(model, mesh: Mesh, num_nodes_padded: int,
                         axis_name: str = NODE_AXIS) -> Callable:
    """Node-sharded-only LP step (JAX :369-395): ``step(values, state,
    params, opt_state, edges, dst_negs, src_negs, mask) -> (opt_state,
    loss)``; every rank trains the whole batch and nothing is summed over the
    data axis. Untyped (2-column) edges score only the dst direction, as the
    trainer does (decoder_methods.cpp:99-102)."""
    update = make_sharded_lp_update(model, mesh, num_nodes_padded, node_axis=axis_name,
                                    data_axis=None)

    def step(values, state, params, opt_state, edges, dst_negs, src_negs, mask):
        has_rels = edges.shape[1] == 3
        inverse = model.decoder.use_inverse_relations and has_rels
        batch = {"src": edges[:, 0], "dst": edges[:, -1], "mask": mask,
                 "dst_negs": dst_negs, "rel": edges[:, 1] if has_rels else None,
                 "src_negs": src_negs if inverse else None}
        return update(values, state, params, opt_state, batch)

    return step
