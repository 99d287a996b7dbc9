"""Embedding-row gather: ``out[k] = table[clamp(ids[k], 0, N - 1)]``.

Port of the TPU kernel ``marius_tpu/ops/pallas/gather.py:gather_rows_pallas``
as a CUDA C++ kernel (``marius_tpu_torch/csrc/gather.cu``): the output is cut
into 16-, 8-, 4- or 2-byte vectors, each thread loads 16 bytes of rows before
it stores any, and the grid is one wave of the card. Tables are float32 or
bfloat16 (the output takes the table's dtype); the copy moves bytes. The kernel is bound by the
bytes it moves; see the source for the design.
:func:`plan` makes the launch's choices on the host, from shapes, addresses
and the card's size alone: no device operation and no synchronisation.

On a CUDA tensor :func:`gather_rows` always launches the kernel, and a build
or launch failure raises. On a CPU tensor it runs :func:`gather_rows_plain`,
the plain PyTorch version that the tests and ``chip_smoke.py`` compare the
kernel with.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from marius_tpu_torch.ops.cuda import build

#: Kernel launches since the last reset; counts only real launches.
launches = 0

#: id dtypes the kernels take, by the suffix of their C entry points
ID_DTYPES = {torch.int64: "i64", torch.int32: "i32"}

#: table dtypes the gather takes, by the infix of its C entry points
TABLE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: threads per block and bytes each thread moves per tile (``kThreads`` and
#: ``kThreadBytes`` in csrc/gather.cu)
THREADS, THREAD_BYTES = 128, 16


class GatherPlan(NamedTuple):
    vec_bytes: int        # V: bytes per vector, 16, 8, 4 or 2
    unroll: int           # U: vectors per thread per tile
    vectors_per_row: int  # row bytes / V
    grid: int             # blocks; at most one wave, 0 when there is nothing to copy


def plan(d: int, table_ptr: int, out_ptr: int, k: int, sm_count: int,
         resident_blocks: int, elem_bytes: int = 4) -> GatherPlan:
    """The launch of a (K, d) gather of ``elem_bytes``-byte elements (4:
    f32, 2: bf16): V is the widest of 16, 8, 4 and 2 bytes that divides the
    row's bytes and both base addresses (a table may be a view at an
    offset); U = 16 / V vectors per thread; the grid covers the K x row
    bytes / V vectors in tiles of THREADS x U, but never with more blocks
    than the card holds at once (the kernel loops over the rest)."""
    row_bytes = elem_bytes * d
    vec = next(v for v in (16, 8, 4, 2)
               if row_bytes % v == 0 and table_ptr % v == 0 and out_ptr % v == 0)
    vpr = row_bytes // vec
    unroll = THREAD_BYTES // vec
    tiles = -(-k * vpr // (THREADS * unroll))
    return GatherPlan(vec, unroll, vpr, min(tiles, sm_count * resident_blocks))


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    (on ``device`` when given) — what the kernels' plain C interface needs."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {list(dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return table[ids.clamp(0, table.shape[0] - 1)]


def _kernel(dtype: torch.dtype, id_dtype: torch.dtype):
    fn = getattr(build.library("gather"),
                 f"marius_gather_rows_{TABLE_DTYPES[dtype]}_{ID_DTYPES[id_dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def device_config(device: torch.device) -> Tuple[int, int]:
    """(SM count, resident blocks per SM) of ``device``, read from the CUDA
    runtime at the first call and cached."""
    return build.device_config("gather", "marius_gather_rows_config", THREADS, device.index)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(K, d) rows of the (N, d) f32 or bf16 ``table`` at the (K,) int64 or
    int32 ``ids``; ids outside [0, N) read the nearest end row."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, ids)
    global launches
    check_cuda_tensor("table", table, tuple(TABLE_DTYPES))
    check_cuda_tensor("ids", ids, tuple(ID_DTYPES), table.device)
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"expected a 2-D table and 1-D ids, got {tuple(table.shape)} "
                         f"and {tuple(ids.shape)}")
    n, d = table.shape
    if n == 0:
        raise ValueError("cannot gather from an empty table")
    k = ids.shape[0]
    out = torch.empty((k, d), dtype=table.dtype, device=table.device)
    if k == 0 or d == 0:
        return out
    fn = _kernel(table.dtype, ids.dtype)
    p = plan(d, table.data_ptr(), out.data_ptr(), k, *device_config(table.device),
             elem_bytes=table.element_size())
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, k, d, p.vec_bytes,
                p.unroll, p.grid, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
