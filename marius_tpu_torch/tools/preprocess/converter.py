"""Edge-list preprocessing: raw delimited, parquet or array input -> binary dataset.

Port of ``marius_tpu/tools/preprocess/converter.py`` (reference
TorchEdgeListConverter, tools/preprocess/converters/torch_converter.py:
428-845): read raw edges, optionally remap node and relation ids to randomly
assigned dense integers (writing node_mapping.txt / relation_mapping.txt),
split into train/valid/test, optionally reorder by partition buckets, and
write <dir>/edges/*.bin + dataset.yaml. The same numpy draws from the same
seed give the same files, byte for byte.

Delimited text is read with the standard library's ``csv`` module
(:func:`read_delimited`), giving the strings pandas' ``read_csv(...,
header=None, skiprows=header_length, dtype=str, keep_default_na=False)``
gives; only parquet input needs pandas.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import os
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from marius_tpu_torch.storage.dataset import DatasetStats, save_stats
from marius_tpu_torch.tools.preprocess.partitioner import (
    partition_order,
    write_partition_offsets,
)

PathOrArray = Union[str, os.PathLike, np.ndarray]
DELIMITED_FORMATS = ("csv", "tsv", "txt", "delimited")


@dataclasses.dataclass
class ConvertResult:
    stats: DatasetStats
    node_mapping: Optional[np.ndarray] = None      # (N, 2) raw -> new
    relation_mapping: Optional[np.ndarray] = None


def _delimited_rows(path, delim: Optional[str], header_length: int) -> Iterator[List[str]]:
    """Rows of fields, as pandas' parsers split them: the first
    ``header_length`` physical lines skipped, a UTF-8 byte-order mark
    dropped, '"' quoting with doubled quotes, blank and whitespace-only
    lines skipped, short rows padded with "" and a row longer than the first
    refused. ``delim=None`` takes the delimiter ``csv.Sniffer`` finds in the
    first line read, as pandas' python engine does for ``sep=None``."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        for _ in range(header_length):
            f.readline()
        lines = f
        if delim is None:
            first = f.readline()
            delim = csv.Sniffer().sniff(first).delimiter
            lines = itertools.chain([first], f)
        ncols = None
        for i, row in enumerate(csv.reader(lines, delimiter=delim, quotechar='"',
                                           doublequote=True)):
            if not row or (len(row) == 1 and not row[0].strip()):
                continue
            if ncols is None:
                ncols = len(row)
            elif len(row) > ncols:
                raise ValueError(f"{os.fspath(path)}: expected {ncols} fields in row "
                                 f"{header_length + i + 1}, saw {len(row)}")
            elif len(row) < ncols:
                row += [""] * (ncols - len(row))
            yield row


def read_delimited(path, delim: Optional[str], header_length: int, columns: Sequence[int],
                   chunk_rows: Optional[int] = None) -> Iterator[np.ndarray]:
    """The ``columns`` of a delimited text file as (rows, len(columns))
    object arrays of strings, ``chunk_rows`` rows at a time (all of them in
    one array when None). An empty file raises, as it does in pandas."""
    rows = _delimited_rows(path, delim, header_length)
    seen = False
    while True:
        chunk = list(itertools.islice(rows, chunk_rows))
        if not chunk:
            break
        seen = True
        yield np.array(chunk, dtype=object)[:, list(columns)]
    if not seen:
        raise ValueError(f"{os.fspath(path)}: no rows to parse")


def _read_raw(src: PathOrArray, fmt: str, delim: str, header_length: int,
              columns: Sequence[int]) -> np.ndarray:
    if isinstance(src, np.ndarray):
        return src[:, list(columns)]
    path = os.fspath(src)
    if fmt in DELIMITED_FORMATS:
        return next(read_delimited(path, delim, header_length, columns))
    if fmt == "parquet":
        import pandas as pd
        df = pd.read_parquet(path)
        return df.iloc[:, list(columns)].to_numpy()
    if fmt in ("numpy", "npy"):
        return np.load(path)[:, list(columns)]
    if fmt == "bin":
        flat = np.fromfile(path, np.int32)
        ncols = max(columns) + 1
        return flat.reshape(-1, ncols)[:, list(columns)]
    raise ValueError(f"Unknown input format: {fmt}")


def _id_normalizer(parts: List[np.ndarray]):
    """Pick one dtype for raw id arrays. Delimited reads yield strings while
    known_node_ids are usually ints; np.unique/searchsorted need a single
    comparable dtype. All-numeric ids become int64, anything else str."""
    def as_int(a):
        return np.asarray(a).astype(np.int64)
    try:
        for p in parts:
            as_int(p)
        return as_int
    except (ValueError, TypeError, OverflowError):
        return lambda a: np.asarray(a).astype("U")


def _remap(columns: List[np.ndarray], known_ids: Optional[List[np.ndarray]],
           rng: np.random.Generator):
    """Random dense-id remap (map_edge_lists, torch_converter.py:191): unique
    raw ids get a random permutation of [0, N)."""
    parts = [c for c in columns if c is not None]
    if known_ids:
        parts += [np.asarray(k) for k in known_ids]
    norm = _id_normalizer(parts)
    uniq = np.unique(np.concatenate([norm(p).reshape(-1) for p in parts]))
    new_ids = rng.permutation(len(uniq)).astype(np.int32)
    # searchsorted-based lookup: uniq is sorted
    def apply(col):
        return new_ids[np.searchsorted(uniq, norm(col))]
    return uniq, new_ids, apply, norm


class EdgeListConverter:
    """In-memory edge-list converter (TorchEdgeListConverter equivalent)."""

    def __init__(
        self,
        output_dir: str,
        train_edges: PathOrArray,
        valid_edges: Optional[PathOrArray] = None,
        test_edges: Optional[PathOrArray] = None,
        splits: Optional[Sequence[float]] = None,
        format: str = "csv",
        header_length: int = 0,
        delim: str = "\t",
        src_column: int = 0,
        dst_column: int = 2,
        edge_type_column: Optional[int] = 1,
        edge_weight_column: Optional[int] = None,
        remap_ids: bool = True,
        sequential_train_nodes: bool = False,
        sequential_deg_nodes: int = 0,   # top-k highest-degree nodes get
                                         # sequential ids (torch_converter.py:101)
        num_nodes: Optional[int] = None,
        num_rels: Optional[int] = None,
        num_partitions: int = 1,
        partitioned_evaluation: bool = False,
        known_node_ids: Optional[List[np.ndarray]] = None,
        seed: int = 0,
    ):
        self.output_dir = os.fspath(output_dir)
        self.inputs = [train_edges, valid_edges, test_edges]
        self.splits = splits
        self.format = format.lower()
        self.header_length = header_length
        self.delim = delim
        self.has_rels = edge_type_column is not None
        self.has_weights = edge_weight_column is not None
        self.columns = ([src_column, edge_type_column, dst_column]
                        if self.has_rels else [src_column, dst_column])
        self.weight_column = edge_weight_column
        self.remap_ids = remap_ids
        self.sequential_train_nodes = sequential_train_nodes
        self.sequential_deg_nodes = int(sequential_deg_nodes)
        self.num_nodes = num_nodes
        self.num_rels = num_rels
        self.num_partitions = num_partitions
        self.partitioned_evaluation = partitioned_evaluation
        self.known_node_ids = known_node_ids
        self.seed = seed

    # ------------------------------------------------------------------
    def convert(self) -> ConvertResult:
        rng = np.random.default_rng(self.seed)
        raw = [None if x is None else
               _read_raw(x, self.format, self.delim, self.header_length, self.columns)
               for x in self.inputs]
        weights = [None] * 3
        if self.has_weights:
            weights = [None if x is None else
                       _read_raw(x, self.format, self.delim, self.header_length,
                                 [self.weight_column]).reshape(-1).astype(np.float32)
                       for x in self.inputs]

        node_mapping = rel_mapping = None
        if self.remap_ids:
            src_cols = [r[:, 0] for r in raw if r is not None]
            dst_cols = [r[:, -1] for r in raw if r is not None]
            uniq_nodes, new_node_ids, node_map, node_norm = _remap(
                src_cols + dst_cols, self.known_node_ids, rng)
            num_nodes = len(uniq_nodes)
            if self.sequential_train_nodes or self.sequential_deg_nodes > 0:
                # sequential-prefix remap (torch_converter.py:265-330):
                # train nodes and/or the top-k highest-degree nodes get ids
                # [0, k) — locality for the partition-buffer tier (hot rows
                # cluster in the first partitions)
                seq_idx = None  # positions in uniq_nodes, in id-assignment order
                if self.sequential_train_nodes:
                    assert self.known_node_ids, \
                        "sequential_train_nodes needs known_node_ids[0] = train nodes"
                    train_ids = np.unique(node_norm(self.known_node_ids[0]))
                    seq_idx = np.flatnonzero(np.isin(uniq_nodes, train_ids))
                if self.sequential_deg_nodes > 0:
                    deg = np.zeros(len(uniq_nodes), np.int64)
                    for col in (raw[0][:, 0], raw[0][:, -1]):
                        idx = np.searchsorted(uniq_nodes, node_norm(col))
                        deg += np.bincount(idx, minlength=len(uniq_nodes))
                    top = np.argsort(-deg, kind="stable")[:self.sequential_deg_nodes]
                    if seq_idx is None:
                        seq_idx = top  # degree-descending id order
                    else:  # union of train + high-degree, shuffled
                        seq_idx = np.union1d(seq_idx, top)
                        rng.shuffle(seq_idx)
                k = len(seq_idx)
                in_seq = np.zeros(len(uniq_nodes), bool)
                in_seq[seq_idx] = True
                new_node_ids = np.empty(len(uniq_nodes), np.int32)
                new_node_ids[seq_idx] = np.arange(k, dtype=np.int32)
                new_node_ids[~in_seq] = (
                    k + rng.permutation(int((~in_seq).sum())).astype(np.int32))
                node_map = lambda col: new_node_ids[np.searchsorted(uniq_nodes, node_norm(col))]  # noqa: E731
            if self.has_rels:
                rel_cols = [r[:, 1] for r in raw if r is not None]
                uniq_rels, new_rel_ids, rel_map, _ = _remap(rel_cols, None, rng)
                num_rels = len(uniq_rels)
            out = []
            for r in raw:
                if r is None:
                    out.append(None)
                    continue
                cols = [node_map(r[:, 0])]
                if self.has_rels:
                    cols.append(rel_map(r[:, 1]))
                cols.append(node_map(r[:, -1]))
                out.append(np.stack(cols, axis=1).astype(np.int32))
            raw = out
            node_mapping = np.stack([uniq_nodes, new_node_ids], axis=1)
            if self.has_rels:
                rel_mapping = np.stack([uniq_rels, new_rel_ids], axis=1)
        else:
            raw = [None if r is None else r.astype(np.int32) for r in raw]
            num_nodes = self.num_nodes or int(
                max(max(r[:, 0].max(), r[:, -1].max()) for r in raw if r is not None)) + 1
            num_rels = (self.num_rels or
                        (int(max(r[:, 1].max() for r in raw if r is not None)) + 1
                         if self.has_rels else 1))
        if not self.has_rels:
            num_rels = 1

        train, valid, test = raw
        w_train, w_valid, w_test = weights
        if self.splits is not None and valid is None and test is None:
            perm = rng.permutation(len(train))
            n_tr = int(self.splits[0] * len(train))
            n_va = int(self.splits[1] * len(train)) if len(self.splits) > 1 else 0
            if w_train is not None:
                w_train, w_valid, w_test = (w_train[perm[:n_tr]],
                                            w_train[perm[n_tr:n_tr + n_va]],
                                            w_train[perm[n_tr + n_va:]])
            train, valid, test = (train[perm[:n_tr]], train[perm[n_tr:n_tr + n_va]],
                                  train[perm[n_tr + n_va:]])

        edges_dir = os.path.join(self.output_dir, "edges")
        nodes_dir = os.path.join(self.output_dir, "nodes")
        os.makedirs(edges_dir, exist_ok=True)
        os.makedirs(nodes_dir, exist_ok=True)

        names = {"train": (train, w_train), "validation": (valid, w_valid),
                 "test": (test, w_test)}
        for name, (edges, w) in names.items():
            if edges is None or len(edges) == 0:
                continue
            if self.num_partitions > 1 and (
                    name == "train" or self.partitioned_evaluation):
                order, sizes = partition_order(edges, num_nodes, self.num_partitions)
                edges = edges[order]
                if w is not None:
                    w = w[order]
                write_partition_offsets(
                    os.path.join(edges_dir, f"{name}_partition_offsets.txt"), sizes)
            np.ascontiguousarray(edges, np.int32).tofile(
                os.path.join(edges_dir, f"{name}_edges.bin"))
            if w is not None:
                np.ascontiguousarray(w, np.float32).tofile(
                    os.path.join(edges_dir, f"{name}_edges_weights.bin"))

        if node_mapping is not None:
            np.savetxt(os.path.join(nodes_dir, "node_mapping.txt"),
                       node_mapping, fmt="%s", delimiter=",")
        if rel_mapping is not None:
            np.savetxt(os.path.join(edges_dir, "relation_mapping.txt"),
                       rel_mapping, fmt="%s", delimiter=",")

        stats = DatasetStats(
            num_nodes=int(num_nodes),
            num_edges=sum(len(e) for e in (train, valid, test) if e is not None),
            num_relations=int(num_rels),
            num_edge_cols=3 if self.has_rels else 2,
            num_train=len(train) if train is not None else 0,
            num_valid=len(valid) if valid is not None else 0,
            num_test=len(test) if test is not None else 0,
        )
        save_stats(self.output_dir, stats)
        return ConvertResult(stats, node_mapping, rel_mapping)
