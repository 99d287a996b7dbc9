"""Embedding-row gather: ``out[k] = table[clamp(ids[k], 0, N - 1)]``.

Port of the TPU kernel ``marius_tpu/ops/pallas/gather.py:gather_rows_pallas``
as a CUDA C++ kernel (``marius_tpu_torch/csrc/gather.cu``: one warp per row,
coalesced columns, masked tail, any K and d). The kernel is bound by the
bytes it moves; see the source for the design.

On a CUDA tensor :func:`gather_rows` always launches the kernel, and a build
or launch failure raises. On a CPU tensor it runs :func:`gather_rows_plain`,
the plain PyTorch version that the tests and ``chip_smoke.py`` compare the
kernel with.
"""

from __future__ import annotations

import ctypes

import torch

from marius_tpu_torch.ops.cuda import build

#: Kernel launches since the last reset; counts only real launches.
launches = 0

#: id dtypes the kernels take, by the suffix of their C entry points
ID_DTYPES = {torch.int64: "i64", torch.int32: "i32"}


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


def _kernel(id_dtype: torch.dtype):
    fn = getattr(build.library("gather"), f"marius_gather_rows_f32_{ID_DTYPES[id_dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(K, d) rows of the (N, d) f32 ``table`` at the (K,) int64 or int32
    ``ids``; ids outside [0, N) read the nearest end row."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, ids)
    global launches
    check_cuda_tensor("table", table, (torch.float32,))
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
    fn = _kernel(ids.dtype)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, k, d, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
