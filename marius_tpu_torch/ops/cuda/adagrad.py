"""Row-sparse Adagrad on the embedding table, in place:
``state[id] += g*g; values[id] -= lr * g / (sqrt(state[id]) + 1e-10)`` for
each id in [0, N); ids outside that range (padding, id == N) are skipped.

Port of the TPU kernel ``marius_tpu/ops/pallas/adagrad.py:89``
``sparse_adagrad_update_pallas`` as a CUDA C++ kernel
(``marius_tpu_torch/csrc/adagrad.cu``), designed for Hopper: rows move as
16-, 8-, 4- or 2-byte vectors (the widest the row's bytes and the three base
addresses allow), each lane moves 8 bytes or more of each array per row, G
lanes serve a row so a warp serves 32 / G rows at once, each warp reads its
next tile's ids ahead, each lane issues all its loads of a row before any
arithmetic, and the grid is one wave of the card. The
kernel is bound by the bytes it moves: five elements per valid row element
(grads, state and values read, state and values written) and the ids, e.g.
60.2 MB and 18.0 us at 3.35 TB/s for 30,000 rows of d = 100 in float32.
:func:`plan` makes the launch's choices on the host, from shapes, addresses
and the card's size alone: no device operation and no synchronisation.

Like the TPU kernel it requires the valid ids to be UNIQUE: a repeated id
would race on its row. Each operation is rounded on its own, so the kernel
matches :func:`sparse_adagrad_update_plain_` bit for bit, and rows that no
id names are never read or written.

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
from typing import NamedTuple, Tuple

import torch

from marius_tpu_torch.ops.cuda import build
from marius_tpu_torch.ops.cuda.gather import ID_DTYPES, check_cuda_tensor

ADAGRAD_EPS = 1e-10  # marius_tpu/parallel/embedding_table.py ADAGRAD_EPS

#: Kernel launches since the last reset; counts only real launches.
launches = 0


#: value dtypes the kernel takes, by the infix of its C entry points
VALUE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: threads per block (``kThreads`` in csrc/adagrad.cu)
THREADS = 128


class AdagradPlan(NamedTuple):
    vec_bytes: int        # V: bytes per vector, 16, 8, 4 or 2 (whole elements)
    lanes: int            # G: lanes per row, a power of two <= 32
    unroll: int           # U: vectors each lane moves per row chunk of G x U, 8 bytes or more
    vectors_per_row: int  # row bytes / V
    grid: int             # blocks; at most one wave, 0 when there is nothing to update
    stream_stores: bool   # evict-first (st.global.cs) stores of state and values


def plan(d: int, values_ptr: int, state_ptr: int, grads_ptr: int, k: int, sm_count: int,
         resident_blocks: int, elem_bytes: int = 4, *, n_rows: int,
         l2_bytes: int) -> AdagradPlan:
    """The launch of an update of K rows of d ``elem_bytes``-byte elements
    (4: f32, 2: bf16) into (``n_rows``, d) values and state. V is the widest
    of 16, 8, 4 and 2 bytes, and no narrower than an element, that divides the
    row's bytes and the three base addresses (any of the tensors may be a view
    at an offset). Each lane moves U = max(1, 8 / V) vectors of each array per
    row chunk, and G lanes serve a row, G the smallest power of two with
    G x U vectors covering it, at most 32 (wider rows loop over chunks), so a
    warp serves 32 / G rows at once: d = 50 in f32 (25 vectors of 8 bytes) and
    d = 100 (25 of 16 or 8 bytes) take one row per warp, d = 50 in bf16 (25 of
    4 bytes) G = 16, U = 2, two rows per warp. The grid covers the K / (32 /
    G) warp tiles in blocks of THREADS / 32 warps, but never with more blocks
    than the card holds at once (the kernel loops over the rest). State and
    values are stored evict-first when the pair is larger than the card's
    ``l2_bytes`` of L2 (the out-of-core buffer, the full-graph table): no
    later step finds their rows in L2 anyway; a pair that fits keeps the
    default policy, so the next step's gather may hit it. Raises ValueError
    for an address that is not on an element boundary."""
    row_bytes = elem_bytes * d
    vec = next((v for v in (16, 8, 4, 2) if v >= elem_bytes and row_bytes % v == 0
                and values_ptr % v == 0 and state_ptr % v == 0 and grads_ptr % v == 0), None)
    if vec is None:
        raise ValueError(f"an address of values {values_ptr:#x}, state {state_ptr:#x} or grads "
                         f"{grads_ptr:#x} is not on a {elem_bytes}-byte element boundary")
    vpr = row_bytes // vec
    unroll = max(1, 8 // vec)
    lanes = min(32, 1 << (max(1, -(-vpr // unroll)) - 1).bit_length())
    rows_per_block = (32 // lanes) * (THREADS // 32)
    blocks = -(-k // rows_per_block)
    return AdagradPlan(vec, lanes, unroll, vpr, min(blocks, sm_count * resident_blocks),
                       2 * n_rows * row_bytes > l2_bytes)


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
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def device_config(device: torch.device) -> Tuple[int, int]:
    """(SM count, resident blocks per SM) of ``device``, read from the CUDA
    runtime at the first call and cached."""
    return build.device_config("adagrad", "marius_sparse_adagrad_config", THREADS, device.index)


def _check(values: torch.Tensor, state: torch.Tensor, ids: torch.Tensor,
           grads: torch.Tensor) -> None:
    check_cuda_tensor("values", values, tuple(VALUE_DTYPES))
    dev = values.device
    check_cuda_tensor("state", state, (values.dtype,), dev)
    check_cuda_tensor("ids", ids, tuple(ID_DTYPES), dev)
    check_cuda_tensor("grads", grads, (values.dtype,), dev)
    if values.dim() != 2 or state.shape != values.shape:
        raise ValueError(f"values {tuple(values.shape)} and state {tuple(state.shape)} "
                         "must be the same 2-D shape")
    k, d = ids.shape[0], values.shape[1]
    if ids.dim() != 1 or grads.shape != (k, d):
        raise ValueError(f"ids {tuple(ids.shape)} and grads {tuple(grads.shape)} "
                         f"do not match a (K,) and (K, {d}) pair")


def tensor_plan(values: torch.Tensor, state: torch.Tensor, ids: torch.Tensor,
                grads: torch.Tensor) -> AdagradPlan:
    """:func:`plan` for these CUDA tensors on their card."""
    _check(values, state, ids, grads)
    return plan(values.shape[1], values.data_ptr(), state.data_ptr(), grads.data_ptr(),
                ids.shape[0], *device_config(values.device), elem_bytes=values.element_size(),
                n_rows=values.shape[0],
                l2_bytes=torch.cuda.get_device_properties(values.device).L2_cache_size)


def launch(values: torch.Tensor, state: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor,
           lr: float, p: AdagradPlan) -> None:
    """Launch the kernel on CUDA tensors with the plan ``p`` (the wrapper's,
    or another one to time against it); the C entry point refuses a plan it
    does not compile or whose vectors the addresses do not allow."""
    global launches
    _check(values, state, ids, grads)
    n, d = values.shape
    k = ids.shape[0]
    if k == 0 or d == 0:
        return
    fn = _kernel(values.dtype, ids.dtype)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(values.data_ptr(), state.data_ptr(), ids.data_ptr(), grads.data_ptr(),
                n, k, d, float(lr), p.vec_bytes, p.lanes, p.unroll, p.grid,
                int(p.stream_stores), stream)
    if rc != 0:
        raise RuntimeError(f"sparse_adagrad_update_ kernel launch failed: CUDA error {rc}")
    launches += 1


def sparse_adagrad_update_(values: torch.Tensor, state: torch.Tensor,
                           ids: torch.Tensor, grads: torch.Tensor, lr: float) -> None:
    """Update the (N, d) f32 or bf16 ``values`` and ``state`` in place at
    the (K,) ``ids`` (int64 or int32, valid ones unique) with the (K, d)
    ``grads`` of the same dtype."""
    if values.device.type == "cpu":
        sparse_adagrad_update_plain_(values, state, ids, grads, lr)
        return
    launch(values, state, ids, grads, lr, tensor_plan(values, state, ids, grads))
