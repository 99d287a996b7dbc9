"""One hop of the neighbour sampler as CUDA C++ kernels (``csrc/sampler.cu``).

A hop samples up to F neighbours of each frontier node in each direction and
maps them into the next hop set. :func:`sample_hop` launches the hop kernel
(every slot's CSR position, neighbour, mask, relation and candidate, both
directions in one grid) and, for a frontier-prefix hop, the four kernels of
its dedup over the (num_nodes + 1)-wide id space (ranks per tile, the totals
and holes in one block, the new ids into their slots, the candidates'
positions and masks). A saturated hop (cap == num_nodes + 1) is the hop
kernel alone; the sorted branch takes its candidates from it and keeps the
plain sort or bitmap dedup. Nothing is read back: the overflow stays a
device counter, and the hop makes no host synchronisation.

The random numbers come in from the sampler's ``Draws`` seam, as for the
plain version (``sample_neighbor_batch_plain`` in
``marius_tpu_torch/data/samplers/neighbor.py``), which the kernels equal bit
for bit and which stays the CPU path. On CUDA tensors the sampler always
launches these kernels; a build or launch failure, or an input they do not
take, raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from marius_tpu_torch.ops.cuda import build

Tensor = torch.Tensor

#: Kernel launches since the last reset: 1 a saturated or sorted hop, 5 a
#: prefix hop (the memset before them is not counted).
launches = 0

#: frontier id dtypes the kernels take, by the suffix of their C entry points
ID_DTYPES = {torch.int64: "i64", torch.int32: "i32"}

KINDS = {"ALL": 0, "UNIFORM": 1, "DROPOUT": 2}
SATURATED, PREFIX, SORTED = 0, 1, 2


class HopOut(NamedTuple):
    """One hop's outputs; direction 0 is incoming, 1 outgoing. An unused
    direction has zero indices and a false mask."""

    idx: Tensor                  # (2, n, F) int32: positions in the next hop set
                                 # (saturated: the candidate ids; sorted: unused)
    mask: Tensor                 # (2, n, F) bool
    rel: Optional[Tensor]        # (2, n, F) int32 relation ids, or None
    self_idx: Optional[Tensor]   # (n,) int32 (saturated, prefix)
    next_ids: Optional[Tensor]   # (cap,) the next hop set (saturated: int32; prefix: the id dtype)
    next_mask: Optional[Tensor]  # (cap,) bool (saturated, prefix)
    candidates: Optional[Tensor]  # sorted: (n + used x n x F,) the frontier, then the candidates


def _check(name: str, t: Tensor, dtypes, device: torch.device,
           shape: Optional[Tuple[int, ...]] = None) -> None:
    """Raise unless ``t`` has one of ``dtypes``, ``shape`` (when given), is
    contiguous and lies on ``device``."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {list(dtypes)}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _kernel(id_dtype: torch.dtype):
    lib = build.library("sampler")
    fn = getattr(lib, f"marius_sample_hop_{ID_DTYPES[id_dtype]}")
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [p, p, i64, i64, i64, i64, i64, i32, ctypes.c_float, i32, i32,
                       p, p, p, p, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        size = lib.marius_sampler_scratch_ints
        size.argtypes = [i64, i64]
        size.restype = i64
    return fn, lib.marius_sampler_scratch_ints


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def sample_hop(graph, cur_ids: Tensor, cur_mask: Tensor, draws_in, draws_out, fanout: int,
               kind: str, rate: float, use_incoming: bool, use_outgoing: bool, mode: int,
               cap: int, overflow: Tensor, zero_overflow: bool) -> HopOut:
    """One hop over ``graph`` (a DeviceGraph) from the (n,) frontier
    ``cur_ids`` (int32 or int64, ids in [0, num_nodes]) and its bool
    ``cur_mask``; ``draws_in`` / ``draws_out`` are each direction's (raw
    int32 draws, float32 uniforms or None) from the Draws seam, None where
    the direction is unused or ``kind`` is ALL. ``mode`` is SATURATED,
    PREFIX (cap >= n) or SORTED. A prefix hop adds its overflow to the int32
    scalar ``overflow``; the first hop of a batch zeroes it first
    (``zero_overflow``)."""
    global launches
    if cur_ids.dim() != 1:
        raise ValueError(f"cur_ids must be 1-D, got shape {tuple(cur_ids.shape)}")
    dev, n, fill = cur_ids.device, int(cur_ids.shape[0]), int(graph.num_nodes)
    _check("cur_ids", cur_ids, tuple(ID_DTYPES), dev)
    _check("cur_mask", cur_mask, (torch.bool,), dev, (n,))
    _check("overflow", overflow, (torch.int32,), dev, ())
    kind_code = KINDS[kind]
    used = (bool(use_incoming), bool(use_outgoing))
    max_id = int(graph.in_offsets.shape[0]) - 2
    has_rels = graph.in_rels is not None and any(used)
    csr, num_cols, rand, uni = [], [], [], []
    for d, (offs, cols, rels, dr) in enumerate((
            (graph.in_offsets, graph.in_cols, graph.in_rels, draws_in),
            (graph.out_offsets, graph.out_cols, graph.out_rels, draws_out))):
        side = "in" if d == 0 else "out"
        _check(f"{side}_offsets", offs, (torch.int32,), dev, (max_id + 2,))
        _check(f"{side}_cols", cols, (torch.int32,), dev)
        if has_rels:
            _check(f"{side}_rels", rels, (torch.int32,), dev, tuple(cols.shape))
        r = u = None
        if used[d] and kind_code != KINDS["ALL"]:
            if dr is None:
                raise ValueError(f"{kind} sampling needs the {side} direction's draws")
            r, u = dr
            _check(f"{side} draws", r, (torch.int32,), dev, (n, fanout))
            if kind_code == KINDS["DROPOUT"]:
                if u is None:
                    raise ValueError("DROPOUT sampling needs the uniforms")
                _check(f"{side} uniforms", u, (torch.float32,), dev, (n, fanout))
            else:
                u = None
        csr += [offs.data_ptr(), cols.data_ptr(), _ptr(rels) if has_rels else None]
        num_cols.append(int(cols.shape[0]))
        rand.append(_ptr(r))
        uni.append(_ptr(u))
    if mode == PREFIX and cap < n:
        raise ValueError(f"prefix cap {cap} < current frontier {n}")
    if mode != SORTED and fill >= 2 ** 31 - 1:
        raise ValueError(f"{fill} nodes exceed the kernels' int32 positions")
    if dev.type != "cuda":
        raise ValueError(f"the sampler's kernels take CUDA tensors, got {dev}")

    i32 = torch.int32
    idx = torch.empty((2, n, fanout), dtype=i32, device=dev)
    mask = torch.empty((2, n, fanout), dtype=torch.bool, device=dev)
    rel = torch.empty((2, n, fanout), dtype=i32, device=dev) if has_rels else None
    self_idx = next_ids = next_mask = candidates = scratch = None
    fn, scratch_ints = _kernel(cur_ids.dtype)
    if mode == SORTED:
        candidates = torch.empty((n + sum(used) * n * fanout,), dtype=cur_ids.dtype, device=dev)
        out_ids = candidates
    else:
        self_idx = torch.empty((n,), dtype=i32, device=dev)
        next_ids = torch.empty((cap,), dtype=i32 if mode == SATURATED else cur_ids.dtype,
                               device=dev)
        next_mask = torch.empty((cap,), dtype=torch.bool, device=dev)
        out_ids = next_ids
        if mode == PREFIX:
            scratch = torch.empty((scratch_ints(n, fill),), dtype=i32, device=dev)

    arr = ctypes.c_void_p * 2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(cur_ids.data_ptr(), cur_mask.data_ptr(), n, fanout, fill, cap, max_id, kind_code,
                rate, mode, int(zero_overflow), (ctypes.c_void_p * 6)(*csr),
                (ctypes.c_int64 * 2)(*num_cols), arr(*rand), arr(*uni),
                (ctypes.c_int * 2)(*used), idx.data_ptr(), mask.data_ptr(), _ptr(rel),
                _ptr(self_idx), _ptr(next_mask), out_ids.data_ptr(), _ptr(scratch),
                overflow.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sampler hop kernels failed: CUDA error {rc}")
    launches += 5 if mode == PREFIX else 1
    return HopOut(idx, mask, rel, self_idx, next_ids, next_mask, candidates)
