"""Out-of-core edge-list preprocessing: convert edge files larger than RAM.

The reference covers the >RAM regime with SparkEdgeListConverter
(tools/preprocess/converters/spark_converter.py): read/remap/split/partition
as Spark jobs over twitter/friendster/freebase86m-scale inputs. This module
is the cluster-free equivalent: a streaming two-pass converter whose memory
footprint is O(num_nodes + chunk), never O(num_edges).

Pass structure (freebase86m: 338M edges = 4 GB on disk, 86M ids = 0.7 GB in
RAM — ids fit, edge lists do not):

1. **Discover** — stream chunks, accumulate the sorted unique raw-id set
   incrementally (node ids in RAM; this matches the Spark converter, whose
   remap dictionary is also materialized per executor and on the Spark master process).
2. **Remap + split + write** — stream chunks again, searchsorted-remap each
   chunk, assign rows to train/valid/test with a per-chunk deterministic RNG,
   and append to the three binary outputs.
3. **Partition (optional)** — counting sort over bucket pairs, out-of-core:
   one streaming pass counts bucket sizes, a second writes each remapped
   train edge at its bucket's running offset into a ``np.memmap`` of the
   final file. Bucket layout matches tools/preprocess/partitioner.py
   (src-major, dst-minor), so PartitionBuffer orderings consume it directly.

Only numpy; identical on-disk layout to EdgeListConverter (edges/*.bin,
node_mapping.txt, dataset.yaml). Port of
``marius_tpu/tools/preprocess/chunked_converter.py``: delimited chunks come
from the converter's ``csv``-based :func:`read_delimited`, the strings pandas
gives, so the same input writes the same files.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from marius_tpu_torch.storage.dataset import DatasetStats, save_stats
from marius_tpu_torch.tools.preprocess.converter import (
    DELIMITED_FORMATS,
    ConvertResult,
    read_delimited,
)
from marius_tpu_torch.tools.preprocess.partitioner import write_partition_offsets

PathLike = Union[str, os.PathLike]

DEFAULT_CHUNK_ROWS = 4_000_000


def _iter_chunks(path: PathLike, fmt: str, delim: str, header_length: int,
                 columns: Sequence[int], chunk_rows: int) -> Iterator[np.ndarray]:
    """Yield (chunk, len(columns)) arrays without loading the whole file."""
    path = os.fspath(path)
    fmt = fmt.lower()
    if fmt in DELIMITED_FORMATS:
        yield from read_delimited(path, delim, header_length, columns, chunk_rows)
        return
    if fmt == "bin":
        ncols = max(columns) + 1
        mm = np.memmap(path, np.int32, mode="r")
        mm = mm.reshape(-1, ncols)
        for start in range(0, len(mm), chunk_rows):
            yield np.asarray(mm[start:start + chunk_rows][:, list(columns)])
        return
    if fmt in ("numpy", "npy"):
        arr = np.load(path, mmap_mode="r")
        for start in range(0, len(arr), chunk_rows):
            yield np.asarray(arr[start:start + chunk_rows][:, list(columns)])
        return
    raise ValueError(f"Unknown input format for chunked conversion: {fmt}")


class _UniqueAccumulator:
    """Amortized-doubling unique-set accumulator.

    The naive per-chunk ``np.union1d(acc, u)`` re-sorts the FULL accumulated
    id set once per chunk — at freebase86m scale that is ~85 re-sorts of a
    90M-element array (hours at that scale). Here per-chunk
    uniques buffer until their total reaches the merged set's size, then ONE
    ``np.unique`` merge runs — O(log #chunks) full re-sorts total, the
    classic logarithmic-merging amortization. Works for any id dtype
    (strings included)."""

    def __init__(self):
        self.base: Optional[np.ndarray] = None
        self._pending: List[np.ndarray] = []
        self._pending_n = 0

    def add(self, vals: np.ndarray) -> None:
        u = np.unique(vals)
        self._pending.append(u)
        self._pending_n += len(u)
        if self.base is None or self._pending_n >= len(self.base):
            self._flush()

    def _flush(self) -> None:
        arrs = ([] if self.base is None else [self.base]) + self._pending
        self.base = (np.unique(np.concatenate(arrs)) if len(arrs) > 1
                     else arrs[0])
        self._pending, self._pending_n = [], 0

    def result(self) -> np.ndarray:
        if self._pending:
            self._flush()
        return self.base


class ChunkedEdgeListConverter:
    """Streaming converter for edge files that do not fit in RAM.

    Same output contract as EdgeListConverter; constructor mirrors its
    surface where meaningful. ``chunk_rows`` bounds resident edge rows.
    """

    def __init__(
        self,
        output_dir: str,
        train_edges: PathLike,
        valid_edges: Optional[PathLike] = None,
        test_edges: Optional[PathLike] = None,
        splits: Optional[Sequence[float]] = None,
        format: str = "csv",
        header_length: int = 0,
        delim: str = "\t",
        src_column: int = 0,
        dst_column: int = 2,
        edge_type_column: Optional[int] = 1,
        remap_ids: bool = True,
        num_nodes: Optional[int] = None,
        num_rels: Optional[int] = None,
        num_partitions: int = 1,
        partitioned_evaluation: bool = False,
        chunk_rows: int = DEFAULT_CHUNK_ROWS,
        seed: int = 0,
    ):
        self.output_dir = os.fspath(output_dir)
        self.inputs = [train_edges, valid_edges, test_edges]
        self.splits = splits
        self.format = format.lower()
        self.header_length = header_length
        self.delim = delim
        self.has_rels = edge_type_column is not None
        self.columns = ([src_column, edge_type_column, dst_column]
                        if self.has_rels else [src_column, dst_column])
        self.remap_ids = remap_ids
        self.num_nodes = num_nodes
        self.num_rels = num_rels
        self.num_partitions = num_partitions
        self.partitioned_evaluation = partitioned_evaluation
        self.chunk_rows = int(chunk_rows)
        self.seed = seed

    # ------------------------------------------------------------------
    def _chunks(self, src: PathLike) -> Iterator[np.ndarray]:
        return _iter_chunks(src, self.format, self.delim, self.header_length,
                            self.columns, self.chunk_rows)

    def _discover_ids(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        nodes, rels = _UniqueAccumulator(), _UniqueAccumulator()
        seen = False
        for src in self.inputs:
            if src is None:
                continue
            for chunk in self._chunks(src):
                seen = True
                nodes.add(chunk[:, [0, -1]].reshape(-1))
                if self.has_rels:
                    rels.add(chunk[:, 1])
        if not seen:
            raise ValueError("no input edges")
        return nodes.result(), rels.result() if self.has_rels else None

    # ------------------------------------------------------------------
    def convert(self) -> ConvertResult:
        rng = np.random.default_rng(self.seed)
        edges_dir = os.path.join(self.output_dir, "edges")
        nodes_dir = os.path.join(self.output_dir, "nodes")
        os.makedirs(edges_dir, exist_ok=True)
        os.makedirs(nodes_dir, exist_ok=True)

        node_mapping = rel_mapping = None
        uniq_nodes = uniq_rels = new_node_ids = new_rel_ids = None
        if self.remap_ids:
            uniq_nodes, uniq_rels = self._discover_ids()
            num_nodes = len(uniq_nodes)
            new_node_ids = rng.permutation(num_nodes).astype(np.int32)
            node_mapping = np.stack([uniq_nodes, new_node_ids], axis=1)
            if self.has_rels:
                num_rels = len(uniq_rels)
                new_rel_ids = rng.permutation(num_rels).astype(np.int32)
                rel_mapping = np.stack([uniq_rels, new_rel_ids], axis=1)
            else:
                num_rels = 1
        else:
            # bounds pass (cheap: streams int chunks, keeps two scalars)
            mx_node = mx_rel = -1
            for src in self.inputs:
                if src is None:
                    continue
                for chunk in self._chunks(src):
                    c = chunk.astype(np.int64)
                    mx_node = max(mx_node, int(c[:, 0].max()), int(c[:, -1].max()))
                    if self.has_rels:
                        mx_rel = max(mx_rel, int(c[:, 1].max()))
            num_nodes = self.num_nodes or mx_node + 1
            num_rels = self.num_rels or (mx_rel + 1 if self.has_rels else 1)

        def remap(chunk: np.ndarray) -> np.ndarray:
            if not self.remap_ids:
                return chunk.astype(np.int32)
            cols = [new_node_ids[np.searchsorted(uniq_nodes, chunk[:, 0])]]
            if self.has_rels:
                cols.append(new_rel_ids[np.searchsorted(uniq_rels, chunk[:, 1])])
            cols.append(new_node_ids[np.searchsorted(uniq_nodes, chunk[:, -1])])
            return np.stack(cols, axis=1).astype(np.int32)

        # ---- pass 2: remap + split + append -------------------------------
        names = ["train", "validation", "test"]
        paths = {n: os.path.join(edges_dir, f"{n}_edges.bin") for n in names}
        counts = {n: 0 for n in names}
        files = {n: open(paths[n], "wb") for n in names}
        try:
            if self.splits is not None and self.inputs[1] is None \
                    and self.inputs[2] is None:
                f_tr = float(self.splits[0])
                f_va = float(self.splits[1]) if len(self.splits) > 1 else 0.0
                for ci, chunk in enumerate(self._chunks(self.inputs[0])):
                    m = remap(chunk)
                    # deterministic per-chunk split draw — same expected
                    # fractions as the in-memory global permutation split
                    r = np.random.default_rng((self.seed, 1, ci)).random(len(m))
                    sel = {"train": r < f_tr,
                           "validation": (r >= f_tr) & (r < f_tr + f_va),
                           "test": r >= f_tr + f_va}
                    for n in names:
                        part = m[sel[n]]
                        part.tofile(files[n])
                        counts[n] += len(part)
            else:
                for n, src in zip(names, self.inputs):
                    if src is None:
                        continue
                    for chunk in self._chunks(src):
                        m = remap(chunk)
                        m.tofile(files[n])
                        counts[n] += len(m)
        finally:
            for f in files.values():
                f.close()

        # ---- pass 3 (optional): out-of-core bucket partition --------------
        if self.num_partitions > 1:
            for n in names:
                if counts[n] == 0 or (n != "train"
                                      and not self.partitioned_evaluation):
                    continue
                self._partition_file(paths[n], counts[n], num_nodes, edges_dir, n)

        if node_mapping is not None:
            with open(os.path.join(nodes_dir, "node_mapping.txt"), "w") as f:
                for start in range(0, len(node_mapping), self.chunk_rows):
                    np.savetxt(f, node_mapping[start:start + self.chunk_rows],
                               fmt="%s", delimiter=",")
        if rel_mapping is not None:
            np.savetxt(os.path.join(edges_dir, "relation_mapping.txt"),
                       rel_mapping, fmt="%s", delimiter=",")

        stats = DatasetStats(
            num_nodes=int(num_nodes),
            num_edges=sum(counts.values()),
            num_relations=int(num_rels),
            num_edge_cols=3 if self.has_rels else 2,
            num_train=counts["train"],
            num_valid=counts["validation"],
            num_test=counts["test"],
        )
        save_stats(self.output_dir, stats)
        return ConvertResult(stats, node_mapping, rel_mapping)

    # ------------------------------------------------------------------
    def _partition_file(self, path: str, num_edges: int, num_nodes: int,
                        edges_dir: str, split_name: str) -> None:
        """Counting-sort the remapped binary file by (src_bucket, dst_bucket)
        without loading it: count pass + memmap placement pass. Matches
        partitioner.partition_order's bucket layout."""
        P = self.num_partitions
        ncols = 3 if self.has_rels else 2
        part_size = -(-num_nodes // P)
        src_mm = np.memmap(path, np.int32, mode="r").reshape(num_edges, ncols)

        bucket_counts = np.zeros(P * P, np.int64)
        for start in range(0, num_edges, self.chunk_rows):
            c = src_mm[start:start + self.chunk_rows]
            b = (c[:, 0] // part_size).astype(np.int64) * P + c[:, -1] // part_size
            bucket_counts += np.bincount(b, minlength=P * P)

        tmp = path + ".part_tmp"
        out = np.memmap(tmp, np.int32, mode="w+", shape=(num_edges, ncols))
        offsets = np.concatenate([[0], np.cumsum(bucket_counts)[:-1]])
        cursor = offsets.copy()
        for start in range(0, num_edges, self.chunk_rows):
            c = np.asarray(src_mm[start:start + self.chunk_rows])
            b = (c[:, 0] // part_size).astype(np.int64) * P + c[:, -1] // part_size
            order = np.argsort(b, kind="stable")
            b_s, c_s = b[order], c[order]
            # contiguous runs per bucket -> one slice write per bucket present
            runs, run_starts = np.unique(b_s, return_index=True)
            run_ends = np.append(run_starts[1:], len(b_s))
            for bk, s0, s1 in zip(runs, run_starts, run_ends):
                n = s1 - s0
                out[cursor[bk]:cursor[bk] + n] = c_s[s0:s1]
                cursor[bk] += n
        out.flush()
        del out, src_mm
        os.replace(tmp, path)
        write_partition_offsets(
            os.path.join(edges_dir, f"{split_name}_partition_offsets.txt"),
            bucket_counts.astype(np.int64))
