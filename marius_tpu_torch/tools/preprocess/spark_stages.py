"""Cluster-distributed preprocessing stages for SparkEdgeListConverter.

Twin of the reference's Spark pipeline (spark_converter.py remap_edges /
get_nodes_df / assign_ids, partitioners/spark_partitioner.py, writers/
spark_writer.py) — id discovery, remap, split, and edge-bucket partitioning
all run as Spark jobs; the local process only stream-converts the cluster-sorted
output to the binary layout (sequential IO, O(chunk) memory, no sorting).

Redesigns vs the reference (stated, not copied):
- id assignment uses ``rdd.zipWithIndex`` (fully distributed) instead of the
  reference's ``repartition(1)`` + ``row_number`` window (get_nodes_df /
  assign_ids funnel every distinct label through ONE partition);
- the bucket sort happens cluster-side via ``repartitionByRange`` +
  ``sortWithinPartitions`` on (src_bucket, dst_bucket); the reference's
  SparkWriter instead collects per-bucket slices on the Spark master;
- the local assembly functions below are pure (file lists in, binary
  out) so they are unit-tested without a Spark installation.

The module imports pyspark lazily: every cluster-side function takes already
-constructed DataFrames, and the pure assembly half has no Spark dependency
at all (it reads parquet with pyarrow, imported inside each function).
A copy of ``marius_tpu/tools/preprocess/spark_stages.py``.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

SRC, REL, DST = "src", "rel", "dst"
SRC_BUCKET, DST_BUCKET = "src_bucket", "dst_bucket"
NODE_LABEL, NODE_ID = "node_label", "node_id"
REL_LABEL, REL_ID = "rel_label", "rel_id"


# ---------------------------------------------------------------------------
# Cluster-side stages (pyspark DataFrames in/out; lazy imports)
# ---------------------------------------------------------------------------

def distinct_nodes_with_ids(edges_df, seed: int = 0):
    """Distinct node labels -> (node_label, node_id) DataFrame.

    Distributed: distinct + zipWithIndex; a seeded cluster-side shuffle
    randomizes the label->id order (the reference randomizes via
    orderBy(rand()), spark_converter.py get_nodes_df)."""
    from pyspark.sql.functions import col, rand

    labels = (edges_df.select(col(SRC).alias(NODE_LABEL))
              .union(edges_df.select(col(DST).alias(NODE_LABEL)))
              .distinct()
              .orderBy(rand(seed)))
    return _zip_with_index(labels, NODE_ID)


def distinct_rels_with_ids(edges_df, seed: int = 0):
    """Distinct relation labels -> (rel_label, rel_id) DataFrame."""
    from pyspark.sql.functions import col, rand

    labels = (edges_df.select(col(REL).alias(REL_LABEL))
              .distinct()
              .orderBy(rand(seed + 1)))
    return _zip_with_index(labels, REL_ID)


def _zip_with_index(df, id_col: str):
    """Append a dense 0..n-1 id column without a single-partition window."""
    spark = df.sparkSession
    fields = df.schema.fieldNames()
    rdd = df.rdd.zipWithIndex().map(lambda t: (*t[0], t[1]))
    return spark.createDataFrame(rdd, fields + [id_col])


def remap_edges_distributed(edges_df, nodes_df, rels_df=None):
    """Join-replace labels with dense ids (reference remap_edges,
    spark_converter.py:68-91). Output columns: src[, rel], dst (int)."""
    from pyspark.sql.functions import col

    out = (edges_df
           .join(nodes_df.withColumnRenamed(NODE_LABEL, SRC), on=SRC)
           .drop(SRC).withColumnRenamed(NODE_ID, SRC))
    if rels_df is not None:
        out = (out.join(rels_df.withColumnRenamed(REL_LABEL, REL), on=REL)
               .drop(REL).withColumnRenamed(REL_ID, REL))
    out = (out.join(nodes_df.withColumnRenamed(NODE_LABEL, DST), on=DST)
           .drop(DST).withColumnRenamed(NODE_ID, DST))
    cols = [SRC, REL, DST] if rels_df is not None else [SRC, DST]
    return out.select(*[col(c).cast("int").alias(c) for c in cols])


def random_split_df(df, splits: Sequence[float], seed: int = 0):
    """Cluster-side train/valid/test split (reference randomSplit,
    spark_converter.py:214-224). Returns (train, valid|None, test|None).

    Split semantics follow THIS repo's convention everywhere (split_edges,
    ChunkedEdgeListConverter): ``splits = (train_frac[, valid_frac])`` and
    the remainder past train+valid is test — so both SparkEdgeListConverter
    modes produce the same dataset layout from the same argument."""
    fr = [float(s) for s in splits or ()]
    if not fr:
        return df, None, None
    f_tr = fr[0]
    f_va = fr[1] if len(fr) > 1 else 0.0
    f_te = (fr[2] if len(fr) > 2 else max(0.0, 1.0 - f_tr - f_va))
    active = [(name, w) for name, w in
              (("train", f_tr), ("valid", f_va), ("test", f_te))
              if w > 1e-12]
    parts = dict(zip((n for n, _ in active),
                     df.randomSplit([w for _, w in active], seed=seed)))
    return parts.get("train"), parts.get("valid"), parts.get("test")


def with_bucket_columns(df, partition_size: int):
    """Append (src_bucket, dst_bucket) = id // partition_size (reference
    get_edge_buckets, spark_partitioner.py:16-20)."""
    from pyspark.sql.functions import floor

    return (df.withColumn(SRC_BUCKET, floor(df[SRC] / partition_size))
            .withColumn(DST_BUCKET, floor(df[DST] / partition_size)))


def write_bucket_sorted_parquet(df, path: str, num_files: int):
    """Cluster-side global sort by (src_bucket, dst_bucket) into range-
    partitioned parquet part files: part file k holds bucket keys <= part
    file k+1's, rows sorted within each file — so streaming the parts in
    name order yields the exact bucket-contiguous layout the training
    storage expects. The shuffle/sort cost lands on the cluster, not on
    this process."""
    (df.repartitionByRange(max(1, num_files), SRC_BUCKET, DST_BUCKET)
       .sortWithinPartitions(SRC_BUCKET, DST_BUCKET)
       .write.mode("overwrite").parquet(path))


def write_plain_parquet(df, path: str, num_files: int):
    (df.repartition(max(1, num_files))
       .write.mode("overwrite").parquet(path))


# ---------------------------------------------------------------------------
# Local assembly (pure: no pyspark; unit-tested with pyarrow-written
# parquet)
# ---------------------------------------------------------------------------

def parquet_parts_in_order(directory: str) -> List[str]:
    """Spark part files in lexicographic (= range-partition) order."""
    return sorted(glob.glob(os.path.join(directory, "part-*.parquet"))
                  or glob.glob(os.path.join(directory, "part-*")))


def stream_parts_to_binary(part_files: Sequence[str], out_path: str,
                           columns: Sequence[str]) -> int:
    """Append each parquet part's rows to ``out_path`` as int32 binary.
    Returns the row count. One part in memory at a time."""
    import pyarrow.parquet as pq

    n = 0
    with open(out_path, "wb") as f:
        for p in part_files:
            t = pq.read_table(p, columns=list(columns))
            arr = np.stack([t.column(c).to_numpy(zero_copy_only=False)
                            for c in columns], axis=1).astype(np.int32)
            arr.tofile(f)
            n += len(arr)
    return n


def stream_parts_to_bucketed_binary(
        part_files: Sequence[str], out_path: str, columns: Sequence[str],
        num_partitions: int, partition_size: int,
        offsets_path: Optional[str] = None) -> Tuple[int, np.ndarray]:
    """Stream cluster-bucket-sorted parts to binary + per-bucket counts.

    The parts MUST come from ``write_bucket_sorted_parquet`` (globally
    sorted by bucket across the name-ordered files) — verified as it
    streams; a violation raises rather than silently corrupting the
    offsets. Returns (num_edges, bucket_counts[P*P])."""
    import pyarrow.parquet as pq

    P = num_partitions
    counts = np.zeros(P * P, np.int64)
    last_key = -1
    n = 0
    with open(out_path, "wb") as f:
        for p in part_files:
            t = pq.read_table(p, columns=list(columns))
            arr = np.stack([t.column(c).to_numpy(zero_copy_only=False)
                            for c in columns], axis=1).astype(np.int32)
            if len(arr) == 0:
                continue
            keys = ((arr[:, 0] // partition_size).astype(np.int64) * P
                    + arr[:, -1] // partition_size)
            if keys[0] < last_key or np.any(np.diff(keys) < 0):
                raise ValueError(
                    f"part file {p} is not bucket-sorted — was the parquet "
                    "written by write_bucket_sorted_parquet?")
            last_key = int(keys[-1])
            counts += np.bincount(keys, minlength=P * P)
            arr.tofile(f)
            n += len(arr)
    if offsets_path is not None:
        from marius_tpu_torch.tools.preprocess.partitioner import (
            write_partition_offsets,
        )
        write_partition_offsets(offsets_path, counts)
    return n, counts


def stream_mapping_to_txt(part_files: Sequence[str], out_path: str,
                          label_col: str, id_col: str) -> int:
    """Write a `raw_label,new_id` mapping file from id-assignment parquet
    parts (node_mapping.txt / relation_mapping.txt layout)."""
    import pyarrow.parquet as pq

    n = 0
    with open(out_path, "w") as f:
        for p in part_files:
            t = pq.read_table(p, columns=[label_col, id_col])
            labels = t.column(label_col).to_pylist()
            ids = t.column(id_col).to_pylist()
            f.writelines(f"{l},{i}\n" for l, i in zip(labels, ids))
            n += len(labels)
    return n
