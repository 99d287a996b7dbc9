"""ctypes bindings for the host-side runtime ``native/marius_native.cpp``.

The port's own loader for the repo's framework-free C++ source (the JAX
package's is ``marius_tpu/native/__init__.py``). The library is built with
``g++ -O3`` at the first call into ``_build/`` beside this file (git-ignored),
named by a hash of the source and the flags, so an edited source rebuilds and
an unchanged one is built once. A failed build, or a library that does not
load, raises: nothing here falls back to numpy silently.

Entry points (the out-of-core LP path's host work):

- :func:`gather_remap_buckets`: concatenate a buffer state's edge buckets and
  remap endpoints to buffer-local ids;
- :func:`shuffle_rows`: in-place Fisher-Yates over int32 rows (``std::
  mt19937_64``);
- :func:`global_to_local`: map global node ids to buffer-local ids;
- :func:`csr_offsets`: CSR offsets of a sorted anchor column;
- :func:`partition_rows`: stable counting sort of edges into row-major
  (src partition, dst partition) buckets.

Each has a plain numpy version computing the same result, which the tests
hold the library against (``*_plain`` here; for :func:`partition_rows`, the
partitioner's ``partition_order``); the trainers call the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "marius_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the built library lives: ``_build/`` here, named by a hash of
    the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes() + repr(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmarius_native_{h}.so"


def build() -> Path:
    """Compile the library if it is missing and return its path; raises if
    the source is missing or g++ fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"the native source {SOURCE} is missing")
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building {SOURCE.name} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def load() -> ctypes.CDLL:
    """The loaded library (built at the first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gather_remap_buckets.restype = ctypes.c_int64
        lib.gather_remap_buckets.argtypes = [i32p, ctypes.c_int, i64p, i32p, ctypes.c_int,
                                             i32p, ctypes.c_int32, i32p]
        lib.shuffle_rows_int32.restype = None
        lib.shuffle_rows_int32.argtypes = [i32p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64]
        lib.csr_offsets.restype = None
        lib.csr_offsets.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i64p]
        lib.global_to_local.restype = ctypes.c_int64
        lib.global_to_local.argtypes = [i32p, ctypes.c_int64, i32p, ctypes.c_int32,
                                        ctypes.c_int32]
        lib.partition_rows.restype = None
        lib.partition_rows.argtypes = [i32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int32,
                                       ctypes.c_int32, i32p, i64p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


# -- entry points --------------------------------------------------------------

def gather_remap_buckets(edges: np.ndarray, bucket_offsets: np.ndarray,
                         bucket_ids: np.ndarray, part_to_slot: np.ndarray,
                         psize: int) -> np.ndarray:
    """Concatenate the selected buckets' rows of bucket-grouped ``edges``
    (``bucket_offsets``: prefix sums of the bucket sizes) and remap the first
    and last columns: ``slot[g // psize] * psize + g % psize``."""
    edges = np.ascontiguousarray(edges, np.int32)
    bucket_offsets = np.ascontiguousarray(bucket_offsets, np.int64)
    bucket_ids = np.ascontiguousarray(bucket_ids, np.int32)
    part_to_slot = np.ascontiguousarray(part_to_slot, np.int32)
    cols = edges.shape[1]
    total = int(np.sum(bucket_offsets[bucket_ids + 1] - bucket_offsets[bucket_ids]))
    out = np.empty((total, cols), np.int32)
    n = load().gather_remap_buckets(
        _ptr(edges, ctypes.c_int32), cols, _ptr(bucket_offsets, ctypes.c_int64),
        _ptr(bucket_ids, ctypes.c_int32), len(bucket_ids),
        _ptr(part_to_slot, ctypes.c_int32), psize, _ptr(out, ctypes.c_int32))
    if n != total:
        raise RuntimeError(f"gather_remap_buckets wrote {n} rows, expected {total}")
    return out


def shuffle_rows(data: np.ndarray, seed: int) -> np.ndarray:
    """Shuffle the rows of an (n, cols) int32 array in place (a copy if it is
    not contiguous int32) and return it."""
    data = np.ascontiguousarray(data, np.int32)
    if data.size:
        load().shuffle_rows_int32(_ptr(data, ctypes.c_int32), data.shape[0], data.shape[1],
                                  seed)
    return data


def global_to_local(ids: np.ndarray, part_to_slot: np.ndarray, psize: int,
                    fill: int) -> Tuple[np.ndarray, int]:
    """(buffer-local ids, number of ids whose partition is not resident; those
    become ``fill``)."""
    ids = np.array(ids, np.int32, copy=True, order="C")
    part_to_slot = np.ascontiguousarray(part_to_slot, np.int32)
    misses = load().global_to_local(_ptr(ids, ctypes.c_int32), len(ids),
                                    _ptr(part_to_slot, ctypes.c_int32), psize, fill)
    return ids, int(misses)


def csr_offsets(sorted_anchor: np.ndarray, num_nodes: int) -> np.ndarray:
    """offsets[v] = first index with anchor >= v, for v in [0, num_nodes]."""
    sorted_anchor = np.ascontiguousarray(sorted_anchor, np.int32)
    out = np.empty(num_nodes + 1, np.int64)
    load().csr_offsets(_ptr(sorted_anchor, ctypes.c_int32), len(sorted_anchor), num_nodes,
                       _ptr(out, ctypes.c_int64))
    return out


def partition_rows(edges: np.ndarray, num_nodes: int,
                   num_partitions: int) -> Tuple[np.ndarray, np.ndarray]:
    """(edges reordered into row-major (src partition, dst partition)
    buckets, stably; the num_partitions**2 bucket sizes)."""
    edges = np.ascontiguousarray(edges, np.int32)
    psize = -(-num_nodes // num_partitions)
    out = np.empty_like(edges)
    sizes = np.zeros(num_partitions * num_partitions, np.int64)
    if len(edges):
        load().partition_rows(_ptr(edges, ctypes.c_int32), len(edges), edges.shape[1], psize,
                              num_partitions, _ptr(out, ctypes.c_int32),
                              _ptr(sizes, ctypes.c_int64))
    return out, sizes


# -- plain numpy versions (the tests hold the library against these) ----------

def gather_remap_buckets_plain(edges, bucket_offsets, bucket_ids, part_to_slot, psize):
    cols = edges.shape[1]
    parts = [edges[bucket_offsets[b]:bucket_offsets[b + 1]] for b in bucket_ids]
    out = (np.concatenate(parts, axis=0) if parts
           else np.zeros((0, cols), np.int32)).astype(np.int32)
    for c in (0, cols - 1):
        g = out[:, c]
        out[:, c] = part_to_slot[g // psize] * psize + g % psize
    return out


class _MT19937_64:
    """std::mt19937_64 (the C++ standard's parameters), one 64-bit draw per
    call, for :func:`shuffle_rows_plain`."""

    _N, _M, _MASK = 312, 156, (1 << 64) - 1
    _UPPER, _LOWER, _A = 0xFFFFFFFF80000000, 0x7FFFFFFF, 0xB5026F5AA96619E9

    def __init__(self, seed: int):
        mt = [seed & self._MASK]
        for i in range(1, self._N):
            prev = mt[-1]
            mt.append((6364136223846793005 * (prev ^ (prev >> 62)) + i) & self._MASK)
        self.mt, self.i = mt, self._N

    def __call__(self) -> int:
        if self.i >= self._N:
            mt, n, m = self.mt, self._N, self._M
            for k in range(n):
                x = (mt[k] & self._UPPER) | (mt[(k + 1) % n] & self._LOWER)
                mt[k] = mt[(k + m) % n] ^ (x >> 1) ^ (self._A if x & 1 else 0)
            self.i = 0
        x = self.mt[self.i]
        self.i += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        return x & self._MASK


def shuffle_rows_plain(data: np.ndarray, seed: int) -> np.ndarray:
    """The library's Fisher-Yates, draw for draw (slow: for small arrays)."""
    out = np.array(data, np.int32, copy=True)
    rng = _MT19937_64(seed)
    for i in range(len(out) - 1, 0, -1):
        j = rng() % (i + 1)
        if i != j:
            out[[i, j]] = out[[j, i]]
    return out


def global_to_local_plain(ids, part_to_slot, psize, fill):
    ids = np.asarray(ids, np.int32)
    slot = part_to_slot[ids // psize]
    out = np.where(slot < 0, fill, slot * psize + ids % psize).astype(np.int32)
    return out, int((slot < 0).sum())


def csr_offsets_plain(sorted_anchor, num_nodes):
    return np.searchsorted(sorted_anchor, np.arange(num_nodes + 1)).astype(np.int64)