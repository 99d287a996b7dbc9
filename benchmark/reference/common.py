"""Plain PyTorch pieces the references share: the CSR of an edge list, the
neighbour sampler with its frontier layout, matrix products in the stated
precision, Adam and Adagrad.

Nothing here imports the program: every rule is written out from the
configuration's semantics (MariusGNN's layered uniform sampler, PyTorch's
Adam, row-wise Adagrad).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class Precision:
    """How the references multiply matrices. ``"f32"``: float32 with TF32
    off, the configurations' precision. ``"tf32"``: the control, the next
    precision below it; on a GPU the products run with TF32 on, on the CPU
    (which has no TF32) the operands are rounded to TF32's 10 mantissa bits
    first, which is what the tensor cores read."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.mode == "tf32"
        torch.backends.cudnn.allow_tf32 = self.mode == "tf32"
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.mode == "tf32" and a.device.type == "cpu":
            a, b = to_tf32(a), to_tf32(b)
        return a @ b

    def bmm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.mode == "tf32" and a.device.type == "cpu":
            a, b = to_tf32(a), to_tf32(b)
        return torch.bmm(a, b)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        bits = x.contiguous().view(torch.int32)
        # round to nearest on the 13 dropped mantissa bits
        rounded = (bits + 0x1000) & ~0x1FFF
        return rounded.view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def to_tf32(x: Tensor) -> Tensor:
    """float32 values rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits);
    the gradient passes straight through, as the tensor cores' do."""
    return _RoundTF32.apply(x)


# -- the graph ----------------------------------------------------------------


def csr(anchor: np.ndarray, other: np.ndarray, num_nodes: int, device) -> Tuple[Tensor, Tensor]:
    """(offsets (N + 2,), neighbours (E,)) of the edges grouped by ``anchor``
    in the edge list's own order (a stable sort); node N, the padding id,
    has no neighbours."""
    order = np.argsort(anchor, kind="stable")
    offsets = np.searchsorted(anchor[order], np.arange(num_nodes + 1))
    offsets = np.concatenate([offsets, offsets[-1:]]).astype(np.int64)
    return (torch.as_tensor(offsets, device=device),
            torch.as_tensor(other[order].astype(np.int64), device=device))


def sample_direction(draws: Optional[Tensor], offsets: Tensor, cols: Tensor, ids: Tensor,
                     valid: Tensor, fanout: int) -> Tuple[Tensor, Tensor]:
    """UNIFORM sampling of one direction: a node of degree <= fanout takes
    each neighbour once, a larger one takes neighbour ``draw % degree`` in
    each of its ``fanout`` slots (with replacement). Returns the (n, F)
    neighbour ids and the mask of the slots in use."""
    n_nodes = offsets.shape[0] - 2
    safe = ids.long().clamp(0, n_nodes)
    start = offsets[safe]
    deg = (offsets[safe + 1] - start)[:, None]
    slot = torch.arange(fanout, device=ids.device)[None, :]
    pos = torch.where(deg <= fanout, slot, draws.long() % deg.clamp(min=1))
    mask = (slot < deg.clamp(max=fanout)) & valid[:, None]
    at = (start[:, None] + torch.minimum(pos, (deg - 1).clamp(min=0)))
    at = at.clamp(0, max(cols.shape[0] - 1, 0))
    return cols[at], mask


class Hop:
    """One hop of a sampled batch: the targets (``ids`` with ``mask``) and,
    for each target, its sampled in- and out-neighbours as positions in the
    next hop's node array, and its own position there."""

    def __init__(self, self_pos, in_pos, in_mask, out_pos, out_mask, next_ids, overflow):
        self.self_pos, self.in_pos, self.in_mask = self_pos, in_pos, in_mask
        self.out_pos, self.out_mask = out_pos, out_mask
        self.next_ids, self.overflow = next_ids, overflow


def next_hop(cur_ids: Tensor, cur_mask: Tensor, nbrs: Sequence[Tuple[Tensor, Tensor]],
             cap: int, num_nodes: int) -> Hop:
    """The next hop's node array under the hop cap ``cap``, and the slots'
    positions in it.

    The configuration's frontier rule: where the cap is N + 1 the array is
    every id in order (position == id). Otherwise it starts with the
    current hop's array (invalid rows as N), then the new ids (sampled
    neighbours not in the current hop) in ascending order fill first the
    invalid rows, then the rows after it; new ids past the cap are dropped,
    and the slots that sampled them go unused."""
    dev = cur_ids.device
    n = cur_ids.shape[0]
    (in_ids, in_mask), (out_ids, out_mask) = nbrs
    if cap == num_nodes + 1:
        every = torch.arange(num_nodes + 1, device=dev)
        return Hop(torch.where(cur_mask, cur_ids.long(), num_nodes),
                   torch.where(in_mask, in_ids, num_nodes), in_mask,
                   torch.where(out_mask, out_ids, num_nodes), out_mask, every, 0)
    if cap < n:
        raise ValueError(f"hop cap {cap} is below the hop's {n} rows")
    cur_valid = cur_ids[cur_mask].long()
    cand = torch.cat([in_ids[in_mask], out_ids[out_mask]]).long()
    uniq = torch.unique(cand)
    new = uniq[~torch.isin(uniq, cur_valid)]
    holes = torch.nonzero(~cur_mask).flatten()
    k = torch.arange(new.shape[0], device=dev)
    if holes.numel():
        slot = torch.where(k < holes.numel(), holes[k.clamp(max=holes.numel() - 1)],
                           n + k - holes.numel())
    else:
        slot = n + k
    keep = slot < cap
    next_ids = torch.full((cap,), num_nodes, dtype=torch.long, device=dev)
    next_ids[:n] = torch.where(cur_mask, cur_ids.long(), num_nodes)
    next_ids[slot[keep]] = new[keep]
    where = torch.full((num_nodes + 1,), -1, dtype=torch.long, device=dev)
    where[cur_valid] = torch.nonzero(cur_mask).flatten()
    where[new[keep]] = slot[keep]
    in_pos, out_pos = where[in_ids.long()], where[out_ids.long()]
    in_mask = in_mask & (in_pos >= 0)
    out_mask = out_mask & (out_pos >= 0)
    return Hop(torch.arange(n, device=dev), in_pos.clamp(min=0), in_mask,
               out_pos.clamp(min=0), out_mask, next_ids, int((~keep).sum()))


def sample_hops(draws: List[Tuple[Tensor, Tensor]], graph, seeds: Tensor, seed_mask: Tensor,
                fanouts: Sequence[int], caps: Sequence[int], num_nodes: int) -> List[Hop]:
    """Every hop of a batch, from the seeds outward. ``draws[depth]`` holds
    that hop's (incoming, outgoing) draws; ``graph`` is ((in offsets, in
    sources), (out offsets, out destinations)); ``fanouts`` per hop from the
    seeds outward; ``caps`` the hop caps, seeds first."""
    (in_off, in_cols), (out_off, out_cols) = graph
    hops = []
    cur_ids, cur_mask = seeds.long(), seed_mask
    for depth, fanout in enumerate(fanouts):
        d_in, d_out = draws[depth]
        nbrs = (sample_direction(d_in, in_off, in_cols, cur_ids, cur_mask, fanout),
                sample_direction(d_out, out_off, out_cols, cur_ids, cur_mask, fanout))
        hop = next_hop(cur_ids, cur_mask, nbrs, int(caps[depth + 1]), num_nodes)
        hops.append(hop)
        cur_ids = hop.next_ids
        cur_mask = cur_ids < num_nodes
    return hops


def sage_mean(prec: Precision, h: Tensor, hop: Hop, w1: Tensor, w2: Tensor,
              bias: Optional[Tensor]) -> Tensor:
    """GraphSAGE with the MEAN aggregator over one hop: each target's own
    row times ``w1`` plus the mean of its sampled neighbours' rows times
    ``w2``, plus the bias; a target without neighbours adds nothing."""
    rows = h.shape[0]

    def nbr_sum(pos, mask):
        g = h[pos.clamp(0, rows - 1)]
        return (g * mask[..., None].to(h.dtype)).sum(dim=1)

    total = nbr_sum(hop.in_pos, hop.in_mask) + nbr_sum(hop.out_pos, hop.out_mask)
    count = (hop.in_mask.sum(dim=1) + hop.out_mask.sum(dim=1)).to(h.dtype)[:, None]
    out = prec.mm(h[hop.self_pos.clamp(0, rows - 1)], w1) + \
        prec.mm(total / count.clamp(min=1.0), w2)
    return out if bias is None else out + bias


# -- optimizers -----------------------------------------------------------------


def adam_step(params: List[Tensor], grads: List[Tensor], m: List[Tensor], v: List[Tensor],
              step: int, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step in place (PyTorch's rule, bias corrections included);
    ``step`` counts from 0."""
    t = step + 1
    with torch.no_grad():
        for p, g, mi, vi in zip(params, grads, m, v):
            mi.mul_(b1).add_((1 - b1) * g)
            vi.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lr / (1 - b1 ** t) * mi / (vi.sqrt() / (1 - b2 ** t) ** 0.5 + eps))


def adagrad_rows(values: Tensor, state: Tensor, grads: Tensor, lr: float, eps: float = 1e-10):
    """Row-wise Adagrad in place on every row: ``state += g * g``, then
    ``values -= lr * g / (sqrt(state) + eps)``; a zero gradient moves nothing."""
    with torch.no_grad():
        state.add_(grads * grads)
        values.sub_(lr * grads / (state.sqrt() + eps))
