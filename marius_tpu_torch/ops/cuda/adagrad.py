"""Row-sparse Adagrad on the embedding table, in place:
``state[id] += g*g; values[id] -= lr * g / (sqrt(state[id]) + 1e-10)`` for
each id in [0, N); ids outside that range (padding, id == N) are skipped.

Port of the TPU kernel ``marius_tpu/ops/pallas/adagrad.py:
sparse_adagrad_update_pallas`` as a CUDA C++ kernel
(``marius_tpu_torch/csrc/adagrad.cu``: one warp per id, coalesced columns,
masked tail, any K and d). Like the TPU kernel it requires the valid ids to be
UNIQUE: a repeated id would race on its row. Each operation is rounded on its
own, so the kernel matches :func:`sparse_adagrad_update_plain_` bit for bit,
and rows that no id names are never written.

Values, state and grads are all float32 or all bfloat16 (the TPU kernel
takes ``values.dtype`` for its rows and ``lr``). In bfloat16 every operation
is rounded to bfloat16 before the next, with lr and eps bfloat16 constants:
XLA compiles JAX's plain ``sparse_adagrad_update`` on bf16 rows to exactly
that sequence (Python scalars are weakly typed), so the plain version equals
JAX's on the CPU bit for bit and the kernel equals the plain version.

On CUDA tensors :func:`sparse_adagrad_update_` always launches the kernel,
and a build or launch failure raises. On CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from marius_tpu_torch.ops.cuda import build
from marius_tpu_torch.ops.cuda.gather import ID_DTYPES, check_cuda_tensor

ADAGRAD_EPS = 1e-10  # marius_tpu/parallel/embedding_table.py ADAGRAD_EPS

#: Kernel launches since the last reset; counts only real launches.
launches = 0


#: value dtypes the kernel takes, by the infix of its C entry points
VALUE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def sparse_adagrad_update_plain_(values: torch.Tensor, state: torch.Tensor,
                                 ids: torch.Tensor, grads: torch.Tensor,
                                 lr: float) -> None:
    """Plain PyTorch version of the kernel (same operations, same
    roundings: each tensor operation rounds to the values' dtype)."""
    keep = (ids >= 0) & (ids < values.shape[0])
    rows, g = ids[keep], grads[keep]
    new_s = state[rows] + g * g
    state[rows] = new_s
    if values.dtype == torch.float32:
        values[rows] = values[rows] - lr * g / (torch.sqrt(new_s) + ADAGRAD_EPS)
        return
    # low precision: the constants in the values' dtype, as JAX's weak types
    lr_t = torch.tensor(lr, dtype=values.dtype, device=values.device)
    eps_t = torch.tensor(ADAGRAD_EPS, dtype=values.dtype, device=values.device)
    values[rows] = values[rows] - (lr_t * g) / (torch.sqrt(new_s) + eps_t)


def _kernel(dtype: torch.dtype, id_dtype: torch.dtype):
    fn = getattr(build.library("adagrad"),
                 f"marius_sparse_adagrad_{VALUE_DTYPES[dtype]}_{ID_DTYPES[id_dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sparse_adagrad_update_(values: torch.Tensor, state: torch.Tensor,
                           ids: torch.Tensor, grads: torch.Tensor, lr: float) -> None:
    """Update the (N, d) f32 or bf16 ``values`` and ``state`` in place at
    the (K,) ``ids`` (int64 or int32, valid ones unique) with the (K, d)
    ``grads`` of the same dtype."""
    if values.device.type == "cpu":
        sparse_adagrad_update_plain_(values, state, ids, grads, lr)
        return
    global launches
    check_cuda_tensor("values", values, tuple(VALUE_DTYPES))
    dev = values.device
    check_cuda_tensor("state", state, (values.dtype,), dev)
    check_cuda_tensor("ids", ids, tuple(ID_DTYPES), dev)
    check_cuda_tensor("grads", grads, (values.dtype,), dev)
    if values.dim() != 2 or state.shape != values.shape:
        raise ValueError(f"values {tuple(values.shape)} and state {tuple(state.shape)} "
                         "must be the same 2-D shape")
    n, d = values.shape
    k = ids.shape[0]
    if ids.dim() != 1 or grads.shape != (k, d):
        raise ValueError(f"ids {tuple(ids.shape)} and grads {tuple(grads.shape)} "
                         f"do not match a (K,) and (K, {d}) pair")
    if k == 0 or d == 0:
        return
    fn = _kernel(values.dtype, ids.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(values.data_ptr(), state.data_ptr(), ids.data_ptr(), grads.data_ptr(),
                n, k, d, float(lr), stream)
    if rc != 0:
        raise RuntimeError(f"sparse_adagrad_update_ kernel launch failed: CUDA error {rc}")
    launches += 1
