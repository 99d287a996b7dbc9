"""Bucketed neighbour gather-sum: ``out[r] = sum_t x[ids[r, t]]``, f32
accumulation, ids outside [0, N) adding zero.

Port of the TPU kernel ``marius_tpu/ops/pallas/nbr_sum.py:gather_sum_pallas``
as a CUDA C++ kernel (``marius_tpu_torch/csrc/nbr_sum.cu``: 128-byte column
slabs run slab-major so that one slab of x stays in L2, four tasks per warp
with their slots added in order, hub rows split into 256-slot pieces that
are tasks like any other and that the group bringing a hub's last piece
folds in piece order; one launch; see the source for the design).

One call covers every degree bucket of an adjacency. A
:class:`GatherSumLayout` lists the work: the bucket-major flat ids, and per
task (a padded bucket row, or a ``MAX_CAP``-slot piece of a wider row) its
first slot, its length and the output row it writes, so the degree-sorted
rows land straight in their original-order rows. The per-bucket form
:func:`gather_sum` (what the TPU kernel computes) is the layout of one
bucket with output row ``r`` for row ``r``.

On CUDA tensors :func:`nbr_sum` always launches the kernel, and a build or
launch failure raises. On CPU tensors it runs :func:`nbr_sum_plain`, which
adds the same slots in the same order with the same split, so the two agree
bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch

from marius_tpu_torch.ops.cuda import build
from marius_tpu_torch.ops.cuda.gather import check_cuda_tensor

#: Widest task: longer rows split into pieces of this many slots
#: (``marius_tpu/ops/pallas/nbr_sum.py`` MAX_CAP).
MAX_CAP = 256

#: Launches of the gather-sum kernel (``gather_sum_kernel``) since the last
#: reset: one per call.
launches = 0

_ENTRY = {torch.float32: "marius_gather_sum_f32", torch.bfloat16: "marius_gather_sum_bf16"}

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GatherSumLayout:
    """The work of one gather-sum call, on one device.

    The pieces of split rows are the first ``num_partials`` tasks, and piece
    task ``p`` is partial row ``p``: split row ``h``'s pieces are the
    ``fold_count[h]`` consecutive tasks from ``fold_first[h]``, in slot
    order. The kernel reads a split row's pieces from there; the plain
    version reads only ``task_dest``."""

    ids: Tensor          # (S,) int32 bucket-major slot ids
    task_start: Tensor   # (T,) int64 first slot of each task
    task_len: Tensor     # (T,) int32 slots of each task (<= MAX_CAP where split)
    task_dest: Tensor    # (T,) int32 output row if >= 0, else partial row -dest - 1
    fold_first: Tensor   # (H,) int32 first partial row (= task) of each split row
    fold_count: Tensor   # (H,) int32 its pieces
    fold_dest: Tensor    # (H,) int32 its output row
    num_out: int         # output rows
    num_partials: int    # partial rows: the split rows' pieces


def bucket_layout(buckets: Sequence[Tensor], out_rows: Tensor, num_out: int) -> GatherSumLayout:
    """Layout of the (n_b, cap_b) ``buckets`` taken in order, whose rows
    write output rows ``out_rows`` (one per bucket row, a permutation of
    ``range(num_out)``). Built with tensor ops on the buckets' device."""
    dev = out_rows.device
    if int(out_rows.numel()) != num_out or sum(int(b.shape[0]) for b in buckets) != num_out:
        raise ValueError("the buckets' rows and out_rows must cover the output rows once each")
    i32, i64 = torch.int32, torch.int64
    starts, lens, dests = [], [], []                         # unsplit rows
    p_starts, p_lens, f_first, f_count, f_dest = [], [], [], [], []   # split rows
    slot0 = row0 = parts = 0
    for b in buckets:
        n, cap = int(b.shape[0]), int(b.shape[1])
        rows = out_rows[row0:row0 + n].to(i32)
        row_start = slot0 + torch.arange(n, dtype=i64, device=dev) * cap
        if cap <= MAX_CAP:
            starts.append(row_start)
            lens.append(torch.full((n,), cap, dtype=i32, device=dev))
            dests.append(rows)
        else:
            k = -(-cap // MAX_CAP)
            piece = torch.arange(k, dtype=i64, device=dev) * MAX_CAP
            p_starts.append((row_start[:, None] + piece).reshape(-1))
            p_lens.append((cap - piece).clamp(max=MAX_CAP).to(i32).repeat(n))
            f_first.append(parts + torch.arange(n, dtype=i32, device=dev) * k)
            f_count.append(torch.full((n,), k, dtype=i32, device=dev))
            f_dest.append(rows)
            parts += n * k
        slot0 += n * cap
        row0 += n

    def cat(parts_, dtype):
        return torch.cat(parts_) if parts_ else torch.zeros(0, dtype=dtype, device=dev)

    ids = cat([b.reshape(-1).to(device=dev, dtype=i32) for b in buckets], i32)
    # the pieces first: piece task p writes partial row p
    piece_dest = -torch.arange(parts, dtype=i32, device=dev) - 1
    return GatherSumLayout(ids=ids, task_start=cat(p_starts + starts, i64),
                           task_len=cat(p_lens + lens, i32),
                           task_dest=cat([piece_dest] + dests, i32),
                           fold_first=cat(f_first, i32), fold_count=cat(f_count, i32),
                           fold_dest=cat(f_dest, i32), num_out=int(num_out),
                           num_partials=int(parts))


def nbr_sum_plain(x: Tensor, layout: GatherSumLayout) -> Tensor:
    """Plain PyTorch version of the kernel: every task's slots added in
    order into an f32 accumulator (an invalid id adds +0.0, which leaves
    the sum's bits unchanged), then the pieces of each split row folded in
    order."""
    n, d = x.shape
    dev = x.device
    t = layout.task_start.shape[0]
    width = int(layout.task_len.max()) if t else 0
    slot = layout.task_start[:, None] + torch.arange(width, device=dev)
    in_task = torch.arange(width, device=dev) < layout.task_len[:, None].long()
    ids = layout.ids[slot.clamp(max=max(layout.ids.numel() - 1, 0))].long() if width else \
        torch.zeros((t, 0), dtype=torch.long, device=dev)
    valid = in_task & (ids >= 0) & (ids < n)
    safe = ids.clamp(0, max(n - 1, 0))
    acc = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(width):
        acc = acc + torch.where(valid[:, j, None], x[safe[:, j]].float(), 0.0)
    out = torch.empty((layout.num_out, d), dtype=torch.float32, device=dev)
    direct = layout.task_dest >= 0
    out[layout.task_dest[direct].long()] = acc[direct]
    if layout.num_partials:
        partial = torch.empty((layout.num_partials, d), dtype=torch.float32, device=dev)
        partial[(-layout.task_dest[~direct] - 1).long()] = acc[~direct]
        folded = torch.zeros((layout.fold_first.shape[0], d), dtype=torch.float32, device=dev)
        for k in range(int(layout.fold_count.max())):
            row = (layout.fold_first + k).long().clamp(max=layout.num_partials - 1)
            folded = folded + torch.where((k < layout.fold_count)[:, None], partial[row], 0.0)
        out[layout.fold_dest.long()] = folded
    return out


def _kernel(dtype: torch.dtype):
    fn = getattr(build.library("nbr_sum"), _ENTRY[dtype])
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, p, p, p, p, i64, i64, p, p, p, i64, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_layout(layout: GatherSumLayout, dev: torch.device) -> None:
    for name, dtype in [("ids", torch.int32), ("task_start", torch.int64),
                        ("task_len", torch.int32), ("task_dest", torch.int32),
                        ("fold_first", torch.int32), ("fold_count", torch.int32),
                        ("fold_dest", torch.int32)]:
        check_cuda_tensor(f"layout.{name}", getattr(layout, name), (dtype,), dev)
    t, h = layout.task_start.shape[0], layout.fold_first.shape[0]
    if layout.task_len.shape[0] != t or layout.task_dest.shape[0] != t or \
            layout.fold_count.shape[0] != h or layout.fold_dest.shape[0] != h or \
            not 0 <= layout.num_partials <= t:
        raise ValueError("layout arrays disagree in length")


def nbr_sum(x: Tensor, layout: GatherSumLayout) -> Tensor:
    """(layout.num_out, d) f32 sums of the (N, d) f32 or bf16 ``x`` over the
    layout's slots."""
    if x.device.type == "cpu":
        return nbr_sum_plain(x, layout)
    global launches
    check_cuda_tensor("x", x, tuple(_ENTRY))
    if x.dim() != 2:
        raise ValueError(f"expected a 2-D x, got {tuple(x.shape)}")
    _check_layout(layout, x.device)
    n, d = x.shape
    out = torch.empty((layout.num_out, d), dtype=torch.float32, device=x.device)
    if layout.num_out == 0 or d == 0:
        return out
    hubs = layout.fold_first.shape[0]
    # the hub pieces' sums, and per hub and 128-byte column slab the pieces summed so far
    slabs = -(-d // (128 // x.element_size()))
    partial = torch.empty((max(layout.num_partials, 1), d), dtype=torch.float32,
                          device=x.device)
    arrivals = torch.empty((max(hubs, 1), slabs), dtype=torch.int32, device=x.device)
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), n, d, layout.ids.data_ptr(), layout.task_start.data_ptr(),
                layout.task_len.data_ptr(), layout.task_dest.data_ptr(),
                layout.task_start.shape[0], layout.num_partials, layout.fold_first.data_ptr(),
                layout.fold_count.data_ptr(), layout.fold_dest.data_ptr(), hubs,
                out.data_ptr(), partial.data_ptr(), arrivals.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gather-sum kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def _single_bucket(ids: Tensor) -> GatherSumLayout:
    n = ids.shape[0]
    return bucket_layout([ids], torch.arange(n, device=ids.device), n)


def gather_sum(x: Tensor, ids: Tensor) -> Tensor:
    """``out[r] = sum_t x[ids[r, t]]`` for one (n, cap) bucket of ids; ids
    outside [0, N), such as the padding id N, add zero (the TPU kernel's
    ``x_pad`` convention without the sentinel row). Output (n, d) f32."""
    return nbr_sum(x, _single_bucket(ids))


def gather_sum_plain(x: Tensor, ids: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`gather_sum`."""
    return nbr_sum_plain(x, _single_bucket(ids))
