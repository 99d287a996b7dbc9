"""Flat binary tensor files, the reference's on-disk format.

A copy of ``marius_tpu/storage/flat_file.py`` (reference FlatFile,
storage/storage.h:149, storage.cpp): tensors are raw row-major arrays with no
header; shape and dtype live in dataset.yaml. Edge files are int32 rows
[src, rel, dst] (or [src, dst]); embeddings and features are float32 rows.
Appending, ranged reads and chunked shuffles follow the Storage ABC
(storage.h:35-86) with numpy memmaps instead of pread loops.
"""

from __future__ import annotations

import os

import numpy as np

MAX_SHUFFLE_CHUNK = int(4e8)  # elements, storage.h:23 MAX_SHUFFLE_SIZE


class FlatFile:
    """File-backed 2D tensor with ranged access."""

    def __init__(self, path: str, dim: int, dtype=np.float32, create: bool = False):
        self.path = path
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        if create and not os.path.exists(path):
            open(path, "wb").close()

    @property
    def num_rows(self) -> int:
        return os.path.getsize(self.path) // (self.dim * self.dtype.itemsize)

    def append(self, data: np.ndarray) -> None:
        arr = np.ascontiguousarray(data, self.dtype)
        if arr.ndim != 2 or arr.shape[1] != self.dim:
            raise ValueError(f"expected rows of width {self.dim}, got {arr.shape}")
        with open(self.path, "ab") as f:
            arr.tofile(f)

    def read_range(self, offset: int, num: int) -> np.ndarray:
        itemsize = self.dim * self.dtype.itemsize
        with open(self.path, "rb") as f:
            f.seek(offset * itemsize)
            buf = np.fromfile(f, self.dtype, count=num * self.dim)
        return buf.reshape(num, self.dim)

    def write_range(self, offset: int, data: np.ndarray) -> None:
        arr = np.ascontiguousarray(data, self.dtype)
        itemsize = self.dim * self.dtype.itemsize
        with open(self.path, "r+b") as f:
            f.seek(offset * itemsize)
            arr.tofile(f)

    def read_all(self) -> np.ndarray:
        return self.read_range(0, self.num_rows)

    def index_read(self, ids: np.ndarray) -> np.ndarray:
        mm = np.memmap(self.path, self.dtype, "r").reshape(-1, self.dim)
        return np.array(mm[ids])

    def index_add(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Unique-index accumulate (Storage::indexAdd, buffer.cpp:460)."""
        mm = np.memmap(self.path, self.dtype, "r+").reshape(-1, self.dim)
        mm[ids] += values.astype(self.dtype)
        mm.flush()

    def shuffle(self, seed: int = 0) -> None:
        """In-place row shuffle, chunked for large files (storage.cpp shuffle)."""
        rng = np.random.default_rng(seed)
        n = self.num_rows
        rows_per_chunk = max(1, MAX_SHUFFLE_CHUNK // self.dim)
        if n <= rows_per_chunk:
            data = self.read_all()
            rng.shuffle(data)
            self.write_range(0, data)
            return
        order = rng.permutation(n)
        mm = np.memmap(self.path, self.dtype, "r+").reshape(-1, self.dim)
        mm[:] = mm[order]
        mm.flush()


def write_edges(path: str, edges: np.ndarray) -> None:
    """Replace the file's contents (truncating any longer previous file)."""
    arr = np.ascontiguousarray(edges, np.int32)
    with open(path, "wb") as f:
        arr.tofile(f)


def read_edges(path: str, num_cols: int = 3) -> np.ndarray:
    return np.fromfile(path, np.int32).reshape(-1, num_cols)
