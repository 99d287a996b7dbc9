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
explicit train step over a (data x node) mesh, corrupting nodes or
relations, with or without a table. Every rank holds the whole batch;
``_lp_batch_specs`` takes its data index's part at chunk boundaries
(``data_part``: JAX's ``shard_map`` specs, :103-123, where the data axis
divides the chunks, else unequal parts). A step makes 2 collectives: the
gather's all_reduce over the node axis, and one all_reduce over the data
axis of G, the dense gradients and the loss, flattened into one buffer per
dtype (``sum_over_data``). A table-less encoder makes 1: node index 0's
gradients summed over the whole mesh.

``make_sharded_buffer_update`` is the partition buffer's step: the whole
batch's unique rows gathered over the node axis, the data part scored, a
(U, d) block of row gradients in the data axis's all_reduce, and the Adagrad
kernel on the rows this node index owns (``owner_rows``). ``nc_table_grad``
combines data-parallel node classification's EMBEDDING row gradients
through JAX's two routes (an all_gather of the ids and rows, or an
all_reduce of the scattered table).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from marius_tpu_torch.nn.optimizers import apply_optimizer, tree_leaves, tree_map
from marius_tpu_torch.ops.cuda import adagrad as adagrad_kernel
from marius_tpu_torch.ops.cuda import gather as gather_kernel
from marius_tpu_torch.parallel.mesh import DATA_AXIS, NODE_AXIS, WORLD_AXIS, Mesh, shard_rows

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


# the batch entries indexed by negative chunk; every other entry is per edge
CHUNK_KEYS = ("dst_negs", "src_negs", "neg_rels")


def data_part(batch_size: int, num_chunks: int, mesh: Optional[Mesh],
              data_axis: Optional[str]) -> Tuple[slice, slice]:
    """(positives, negative chunks) of this rank's data index: whole chunks,
    ``C // D`` each and one more for the first ``C % D`` indices, so any batch
    and chunk count splits (an index may get none). Without a data axis, the
    whole batch."""
    if data_axis is None:
        return slice(0, batch_size), slice(0, num_chunks)
    n, i = mesh.shape[data_axis], mesh.axis_index(data_axis)
    per, extra = divmod(num_chunks, n)
    lo = i * per + min(i, extra)
    hi = lo + per + (1 if i < extra else 0)
    step = batch_size // num_chunks
    return slice(lo * step, hi * step), slice(lo, hi)


def largest_part(batch_size: int, num_chunks: int, n_data: int) -> Tuple[int, int]:
    """(positives, chunks) of the largest data part (:func:`data_part`)."""
    chunks = -(-num_chunks // n_data)
    return chunks * (batch_size // num_chunks), chunks


def _lp_batch_specs(batch: Dict[str, Optional[Tensor]], mesh: Mesh,
                    data_axis: Optional[str]) -> Dict[str, Optional[Tensor]]:
    """This rank's part of the whole batch (:func:`data_part`): its rows of
    the per-edge entries (src, dst, rel, mask, the filters) and its chunks of
    the negatives (``CHUNK_KEYS``), JAX's ``P(data)`` / ``P(data, None)``
    specs where the data axis divides the chunks."""
    if data_axis is None:
        return dict(batch)
    chunks = next(batch[k] for k in CHUNK_KEYS if batch.get(k) is not None)
    rows, cols = data_part(batch["mask"].shape[0], chunks.shape[0], mesh, data_axis)
    return {k: None if v is None else v[cols if k in CHUNK_KEYS else rows]
            for k, v in batch.items()}


def _mean_weight(mask: Tensor, mean: bool, total_mask: Tensor):
    """Exact MEAN reweighting: the global mean is the sum over data indices
    of the local mean times local_count / total_count (the loss's own
    denominators cancel). Every rank holds the whole batch's mask
    (``total_mask``), so the total needs no collective (JAX psums it)."""
    if not mean:
        return 1.0
    local_count = mask.float().sum()
    return local_count / total_mask.float().sum().clamp_min(1.0)


def sum_over_data(parts, mesh: Mesh, data_axis: Optional[str]) -> None:
    """Sum every tensor of ``parts`` in place over ``data_axis`` (the data
    axis, or ``WORLD_AXIS``; None: no sum): one all_reduce per dtype of all
    of them flattened (the reference's NCCL all_reduce, model.cpp:136-159).
    None entries are skipped."""
    if data_axis is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in parts:
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in group]), data_axis)
        for t, piece in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(piece.view_as(t))


def owner_rows(ids: Tensor, shard_size: int, mesh: Mesh, limit: int,
               axis: str = NODE_AXIS) -> Tensor:
    """Each global id's row in this rank's shard, or ``shard_size`` (which the
    Adagrad kernel skips) where another node index owns it or it is a
    padding id (>= ``limit``)."""
    local, mine = _owned(ids, shard_size, mesh.axis_index(axis))
    return torch.where(mine & (ids < limit), local, shard_size)


def _apply_sharded_updates(model, values: Optional[Tensor], state: Optional[Tensor], params,
                           opt_state, loss: Tensor, G: Optional[Tensor], gdense, mesh: Mesh,
                           data_axis: Optional[str], rows: Optional[Tensor] = None):
    """The explicit steps' epilogue: sum the data indices' G, dense
    gradients and loss (:func:`sum_over_data`), then the owner-local Adagrad
    kernel at the shard's ``rows`` (every row when None; rows past the shard
    are skipped) and the dense optimizer. A table-less encoder has no G, and
    the ranks of a node row are replicas: node index 0's gradients and loss
    are summed over the whole mesh instead (the others add zeros), so every
    replica takes the same update bit for bit, whatever order its own sums
    ran in. Returns (opt_state, loss)."""
    parts = [G, loss.reshape(1)] + tree_leaves(gdense)
    if G is None and data_axis is not None and mesh.shape[NODE_AXIS] > 1:
        if mesh.axis_index(NODE_AXIS):
            for t in parts[1:]:
                t.zero_()
        data_axis = WORLD_AXIS
    sum_over_data(parts, mesh, data_axis)
    if G is not None:
        if rows is None:
            rows = torch.arange(values.shape[0], device=values.device)
        adagrad_kernel.sparse_adagrad_update_(values, state, rows, G, model.sparse_lr)
    _, opt_state = apply_optimizer(model.dense_optimizer, params, opt_state, gdense)
    return opt_state, loss


def _grads(loss: Tensor, v: Optional[Tensor], params):
    """(dL/dv, dense gradients shaped like ``params``; zeros where unused,
    and everywhere for a part with no edges, whose loss is a constant)."""
    leaves = tree_leaves(params)
    inputs = ([] if v is None else [v]) + leaves
    grads = ([None] * len(inputs) if not loss.requires_grad
             else torch.autograd.grad(loss, inputs, allow_unused=True))
    filled = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, inputs)]
    it = iter(filled[len(inputs) - len(leaves):])
    return (None if v is None else filled[0]), tree_map(lambda _: next(it), params)


def _batch_ids(local: Dict[str, Optional[Tensor]]) -> Tensor:
    """The ids of the rank's part that enter the gather: [src; dst; dst_negs;
    src_negs], or [src; dst] when relations are corrupted."""
    parts = [local["src"], local["dst"]]
    for k in ("dst_negs", "src_negs"):
        if local.get(k) is not None:
            parts.append(local[k].reshape(-1))
    return torch.cat(parts)


def _lp_part_loss(model, enc: Tensor, pos: Optional[Tensor],
                  local: Dict[str, Optional[Tensor]]) -> Tensor:
    """The loss of a part of a batch from its encoded rows: ``enc`` in the
    part's [src; dst; dst_negs; src_negs] layout, or indexed by ``pos`` in
    it. Relation corruption (``neg_rels``) scores the endpoints under each
    chunk's relations; a part with no edges gives a constant 0."""
    from marius_tpu_torch.nn.model import lp_batch_loss_direct, lp_batch_loss_rel

    b = local["src"].shape[0]
    if b == 0:
        return torch.zeros((), dtype=torch.float32, device=enc.device)

    def rows(lo, hi):
        return enc[lo:hi] if pos is None else enc[pos[lo:hi]]

    if local.get("neg_rels") is not None:
        loss, _ = lp_batch_loss_rel(model, rows(0, b), rows(b, 2 * b), local["rel"],
                                    local["neg_rels"], local["mask"])
        return loss
    c, nneg = local["dst_negs"].shape
    cn, d = c * nneg, enc.shape[-1]
    inverse = local.get("src_negs") is not None
    loss, _ = lp_batch_loss_direct(
        model, rows(0, b), rows(b, 2 * b), local.get("rel"),
        rows(2 * b, 2 * b + cn).reshape(c, nneg, d),
        rows(2 * b + cn, 2 * b + 2 * cn).reshape(c, nneg, d) if inverse else None,
        local["mask"], local.get("dst_filter"), local.get("src_filter"))
    return loss


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
    encoders (JAX :153-240), corrupting nodes or relations.

    The table and its Adagrad state are row-sharded over ``node_axis``; the
    batch is split over ``data_axis`` at chunk boundaries
    (:func:`data_part`). Each rank gathers its part's rows with one
    all_reduce over the node axis, scores them, and takes the gradient with
    respect to its shard; G, the dense gradients (the decoder's replicated
    relations among them) and the loss are summed over the data axis, so
    rows touched by several data indices combine as on one device; MEAN stays
    exact through ``_mean_weight``. The dense optimizer and the Adagrad
    kernel run on every rank.

    Returns ``update(values, state, params, opt_state, batch) -> (opt_state,
    loss)``, which updates ``values``, ``state`` and ``params`` in place;
    ``batch`` is the WHOLE batch: src, dst, mask, rel, and either dst_negs,
    src_negs, dst_filter, src_filter (node corruption) or neg_rels, the
    (C, N) corrupting relation ids (None where absent). ``loss`` is the
    whole batch's. With relation corruption only the endpoints are gathered.
    """
    from marius_tpu_torch.nn.encoder import encoder_forward

    mean = _is_mean(model, mesh, num_nodes_padded)

    def update(values, state, params, opt_state, batch):
        local = _lp_batch_specs(batch, mesh, data_axis)
        w = _mean_weight(local["mask"], mean, batch["mask"])
        v = values.detach().requires_grad_(True)
        x = sharded_gather_inner_grad(v, _batch_ids(local), mesh, node_axis)
        # shallow stages only: no GNN, no dropout
        x = encoder_forward(model.encoder, params["encoder"], x, None, None, train=True)
        loss = _lp_part_loss(model, x, None, local) * w
        G, gdense = _grads(loss, v, params)
        return _apply_sharded_updates(model, values, state, params, opt_state,
                                      loss.detach(), G, gdense, mesh, data_axis)

    return update


def make_sharded_gnn_lp_update(model, mesh: Mesh, num_nodes_padded: int, nbr_configs,
                               hop_caps_local, unique_cap_local: int, num_nodes: int,
                               node_axis: str = NODE_AXIS,
                               data_axis: Optional[str] = DATA_AXIS,
                               has_features: bool = False) -> Callable:
    """The explicit LP train update for GNN encoders, EMBEDDING + FEATURE
    encoders without hops and table-less (FEATURE-only) encoders over a
    (data x node) mesh (JAX :243-366), corrupting nodes or relations.

    The graph, features and degrees are replicated (read only). Each rank:
    dedups its part's ids (``ops/unique.py``), expands them through the
    neighbour sampler with ``draws`` (the caller seeds them from the seed and
    the data index, as JAX folds the shard index into its keys: ALL sampling
    draws nothing and gives the single-device trajectory), gathers the outer
    hop with ``sharded_gather_inner_grad`` and the features, runs the encoder
    (its SAGE layers through the gather-sum kernel), scores, and ends as the
    shallow step. A FEATURE-only encoder has no table (``values`` None): the
    ranks of a node row hold the same part and do the same work: replicas,
    kept bit equal by summing node index 0's gradients over the whole mesh
    (``_apply_sharded_updates``).

    Returns ``update(values, state, params, opt_state, batch, graph,
    features, degrees, draws, dropout_key) -> (opt_state, loss, overflow)``.
    """
    from marius_tpu_torch.data.samplers.neighbor import sample_neighbor_batch
    from marius_tpu_torch.nn.encoder import encoder_forward
    from marius_tpu_torch.ops.unique import unique_padded

    mean = _is_mean(model, mesh, num_nodes_padded)
    nbr_configs = tuple(nbr_configs)
    hop_caps_local = tuple(int(h) for h in hop_caps_local)

    def update(values, state, params, opt_state, batch, graph, features, degrees,
               draws, dropout_key):
        local = _lp_batch_specs(batch, mesh, data_axis)
        w = _mean_weight(local["mask"], mean, batch["mask"])

        uniq = unique_padded(_batch_ids(local), size=unique_cap_local, fill_value=num_nodes)
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
        v = x0 = None
        if values is not None:
            v = values.detach().requires_grad_(True)
            x0 = sharded_gather_inner_grad(v, outer, mesh, node_axis)
        encoded = encoder_forward(model.encoder, params["encoder"], x0, feats, nbr_batch,
                                  degrees=degrees, train=True, dropout_key=dropout_key)
        loss = _lp_part_loss(model, encoded, uniq.inverse, local) * w
        G, gdense = _grads(loss, v, params)
        opt_state, loss = _apply_sharded_updates(model, values, state, params, opt_state,
                                                 loss.detach(), G, gdense, mesh, data_axis)
        return opt_state, loss, overflow

    return update


def make_sharded_buffer_update(model, mesh: Mesh, shard_size: int, buffer_rows: int,
                               nbr_configs=(), hop_caps=(), unique_cap: int = 0,
                               node_axis: str = NODE_AXIS,
                               data_axis: Optional[str] = DATA_AXIS) -> Callable:
    """The explicit train update of the partition buffer over a (data x
    node) mesh (JAX buffer_trainer.py:146-167, 264-276, where GSPMD keeps one
    device's semantics).

    The device buffer is row-sharded over ``node_axis`` (``shard_size`` rows
    per node index, rows past ``buffer_rows`` padding). Every rank holds the
    whole batch, drawn from one seeded generator, and its buffer-local ids.
    Each rank dedups the whole batch's ids (the same U <= ``unique_cap`` ids
    in the same order everywhere), expands them through the neighbour
    sampler with the shared ``draws`` (GNN encoders), gathers those rows with
    one all_reduce over the node axis and encodes them; it scores only its
    data index's part (:func:`data_part`). The (U, d) row gradients, the
    dense gradients and the loss are summed over the data axis, then each
    rank runs the Adagrad kernel on the rows its node index owns (JAX's
    unique-row rule; the others are skipped through the kernel's id >= N
    rule). No collective carries more than U rows.

    Returns ``update(values, state, params, opt_state, batch, all_ids,
    features, graph, draws, dropout_key) -> (opt_state, loss)``: ``all_ids``
    is the whole batch's [src; dst; dst_negs; src_negs] (both negative
    blocks drawn, whichever the loss scores, as on one device), ``features``
    the slot-aligned feature rows or None.
    """
    from marius_tpu_torch.data.samplers.neighbor import sample_neighbor_batch
    from marius_tpu_torch.nn.encoder import encoder_forward
    from marius_tpu_torch.ops.unique import unique_padded

    mean = _is_mean(model, mesh, shard_size * mesh.shape[node_axis])
    nbr_configs = tuple(nbr_configs)

    def update(values, state, params, opt_state, batch, all_ids, features, graph, draws,
               dropout_key):
        local = _lp_batch_specs(batch, mesh, data_axis)
        w = _mean_weight(local["mask"], mean, batch["mask"])
        uniq = unique_padded(all_ids, size=unique_cap, fill_value=buffer_rows)
        ids, nbr_batch = uniq.ids, None
        if nbr_configs:
            nbr_batch = sample_neighbor_batch(draws, graph, ids, ids < buffer_rows,
                                              nbr_configs, hop_caps)
            ids = nbr_batch.node_ids[0]
        x0 = sharded_gather(values, ids, mesh, node_axis).requires_grad_(True)
        feats = None if features is None else gather_kernel.gather_rows(features, ids)
        enc = encoder_forward(model.encoder, params["encoder"], x0, feats, nbr_batch,
                              degrees=None if graph is None else graph.degrees, train=True,
                              dropout_key=dropout_key)
        pos = _part_positions(uniq.inverse, batch, mesh, data_axis)
        loss = _lp_part_loss(model, enc, pos, local) * w
        gx, gdense = _grads(loss, x0, params)
        rows = owner_rows(ids, shard_size, mesh, buffer_rows, node_axis)
        return _apply_sharded_updates(model, values, state, params, opt_state, loss.detach(),
                                      gx, gdense, mesh, data_axis, rows)

    return update


def _part_positions(inverse: Tensor, batch: Dict[str, Optional[Tensor]], mesh: Mesh,
                    data_axis: Optional[str]) -> Tensor:
    """The positions of this data index's part, in its own [src; dst;
    dst_negs; src_negs] layout (the blocks its loss scores), among the whole
    batch's unique ids; ``inverse`` is in the whole batch's [src; dst;
    dst_negs; src_negs] layout."""
    b = batch["mask"].shape[0]
    chunks = next(batch[k] for k in CHUNK_KEYS if batch.get(k) is not None)
    c, nneg = chunks.shape
    rows, cols = data_part(b, c, mesh, data_axis)
    parts = [inverse[:b][rows], inverse[b:2 * b][rows]]
    for k, start in (("dst_negs", 2 * b), ("src_negs", 2 * b + c * nneg)):
        if batch.get(k) is not None:
            block = inverse[start:start + c * nneg].reshape(c, nneg)
            parts.append(block[cols].reshape(-1))
    return torch.cat(parts)


def nc_table_grad(num_rows: int, outer_ids: Tensor, g_emb: Tensor, mesh: Mesh,
                  data_axis: str = DATA_AXIS, route: Optional[str] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Data-parallel node classification's EMBEDDING gradient (JAX
    nc.py:509-527): the (N, d) accumulator G of every data index's (K, d)
    outer-hop row gradients at ``outer_ids`` (padded with ids >= N), over a
    table every rank holds whole. Two routes, by traffic, as JAX chooses
    them: ``"gather"`` (n_data * K < N) all_gathers the ids and row
    gradients over the data axis and sums them on every rank; ``"reduce"``
    scatters this rank's into a table-shaped G and all_reduces it. Returns
    (rows, G[rows]) for the Adagrad kernel: the touched rows (sorted, a
    padding id N among them is skipped by the kernel) or every row. Rows
    with G = 0 would not move under the dense rule either."""
    n_data = mesh.shape[data_axis]
    if route is None:
        route = "gather" if n_data * outer_ids.shape[0] < num_rows else "reduce"
    safe = torch.where((outer_ids >= 0) & (outer_ids < num_rows), outer_ids, num_rows)
    G = torch.zeros((num_rows + 1, g_emb.shape[1]), dtype=g_emb.dtype, device=g_emb.device)
    if route == "gather":
        ids_all = mesh.all_gather_rows(safe, data_axis)
        G.index_add_(0, ids_all, mesh.all_gather_rows(g_emb, data_axis))
        rows = torch.unique(ids_all)
        return rows, G[rows]
    if route != "reduce":
        raise ValueError(f"unknown route {route}")
    G.index_add_(0, safe, g_emb)
    G = mesh.all_reduce(G[:num_rows].contiguous(), data_axis)
    return torch.arange(num_rows, device=G.device), G


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
