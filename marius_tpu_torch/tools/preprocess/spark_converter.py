"""Spark edge-list converter: cluster-distributed preprocessing.

API twin of the reference's SparkEdgeListConverter (tools/preprocess/
converters/spark_converter.py; partitioners/spark_partitioner.py; writers/
spark_writer.py). Two modes:

- ``mode="distributed"`` (default): id discovery, remap, split, and the
  edge-bucket sort ALL run as Spark jobs (spark_stages.py). The local
  process's only work is a sequential stream-convert
  of the cluster-sorted parquet parts into the binary layout — O(one part)
  memory, no local sort. This is the reference's division of labor,
  with two redesigns documented in spark_stages.py (distributed
  zipWithIndex id assignment; cluster-side range-partitioned bucket sort
  instead of bucket slices collected locally).
- ``mode="stream"``: Spark only fronts the read (any Spark-readable
  filesystem/glob); rows stream to this process partition-at-a-time
  (``toLocalIterator`` — never a full collect) and the out-of-core
  ChunkedEdgeListConverter does remap/split/partition locally. Zero cluster
  compute beyond the scan; useful when executors are scarce.

Requires pyspark (either mode). Absent pyspark, point
ChunkedEdgeListConverter at local files directly — it converts the largest
reference dataset (freebase86m-shaped, 338M edges) without a cluster. A copy
of ``marius_tpu/tools/preprocess/spark_converter.py`` over the port's
stages and converters.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
from typing import Optional


def _require_pyspark():
    try:
        from pyspark.sql import SparkSession
        return SparkSession
    except ImportError as e:
        raise RuntimeError(
            "SparkEdgeListConverter requires pyspark (`pip install pyspark`). "
            "For local files of any size use ChunkedEdgeListConverter "
            "(numpy-only, out-of-core); for in-RAM data use "
            "EdgeListConverter.") from e


class SparkEdgeListConverter:
    """Cluster-distributed convert (see module docstring)."""

    def __init__(self, output_dir: str, train_edges: str, delim: str = "\t",
                 src_column: int = 0, dst_column: int = 2,
                 edge_type_column: Optional[int] = 1,
                 splits=None, num_partitions: int = 1,
                 partitioned_evaluation: bool = False,
                 chunk_rows: int = 4_000_000,
                 spark_master: str = "local[*]",
                 mode: str = "distributed",
                 num_output_files: int = 64,
                 seed: int = 0,
                 spark_driver_memory: str = "8g",
                 spark_executor_memory: str = "4g", **kwargs):
        self.SparkSession = _require_pyspark()
        assert mode in ("distributed", "stream"), mode
        self.output_dir = output_dir
        self.train_edges = train_edges
        self.delim = delim
        self.src_column = src_column
        self.dst_column = dst_column
        self.edge_type_column = edge_type_column
        self.splits = splits
        self.num_partitions = num_partitions
        self.partitioned_evaluation = partitioned_evaluation
        self.chunk_rows = chunk_rows
        self.spark_master = spark_master
        self.mode = mode
        self.num_output_files = num_output_files
        self.seed = seed
        self.spark_driver_memory = spark_driver_memory
        self.spark_executor_memory = spark_executor_memory

    # ------------------------------------------------------------------
    def _session(self):
        return (self.SparkSession.builder.master(self.spark_master)
                .appName("marius_tpu_torch_preprocess")
                .config("spark.driver.memory", self.spark_driver_memory)
                .config("spark.executor.memory", self.spark_executor_memory)
                .getOrCreate())

    def convert(self):
        if self.mode == "stream":
            return self._convert_stream()
        return self._convert_distributed()

    # ------------------------------------------------------------------
    def _convert_distributed(self):
        from marius_tpu_torch.storage.dataset import DatasetStats, save_stats
        from marius_tpu_torch.tools.preprocess import spark_stages as st
        from marius_tpu_torch.tools.preprocess.converter import ConvertResult

        has_rel = self.edge_type_column is not None
        cols = [st.SRC, st.REL, st.DST] if has_rel else [st.SRC, st.DST]
        edges_dir = os.path.join(self.output_dir, "edges")
        nodes_dir = os.path.join(self.output_dir, "nodes")
        os.makedirs(edges_dir, exist_ok=True)
        os.makedirs(nodes_dir, exist_ok=True)
        work = tempfile.mkdtemp(prefix="marius_tpu_torch_spark_")

        spark = self._session()
        try:
            df = spark.read.csv(self.train_edges, sep=self.delim, header=False)
            sel = [df.columns[self.src_column]]
            if has_rel:
                sel.append(df.columns[self.edge_type_column])
            sel.append(df.columns[self.dst_column])
            # drop malformed rows (short/blank lines -> null columns) UP
            # FRONT: nulls would otherwise get a dense id from distinct()
            # yet vanish from every split at the inner-join remap —
            # inconsistent counts with no error
            df = df.select(*sel).toDF(*cols).na.drop()

            nodes_df = st.distinct_nodes_with_ids(df, self.seed).cache()
            rels_df = (st.distinct_rels_with_ids(df, self.seed).cache()
                       if has_rel else None)
            num_nodes = nodes_df.count()
            num_rels = rels_df.count() if rels_df is not None else 1

            # persist: each split below is its own Spark action; without
            # this the CSV scan + 3-way join re-executes per materialization
            remapped = st.remap_edges_distributed(df, nodes_df, rels_df) \
                .persist()
            tr, va, te = st.random_split_df(
                remapped, self.splits or (), self.seed)

            P = self.num_partitions
            part_size = max(1, math.ceil(num_nodes / P))
            counts = {"train": 0, "validation": 0, "test": 0}
            for name, split in (("train", tr), ("validation", va),
                                ("test", te)):
                if split is None:
                    continue
                out_bin = os.path.join(edges_dir, f"{name}_edges.bin")
                pq_dir = os.path.join(work, name)
                bucketize = P > 1 and (name == "train"
                                       or self.partitioned_evaluation)
                if bucketize:
                    st.write_bucket_sorted_parquet(
                        st.with_bucket_columns(split, part_size),
                        pq_dir, self.num_output_files)
                    counts[name], _ = st.stream_parts_to_bucketed_binary(
                        st.parquet_parts_in_order(pq_dir), out_bin, cols,
                        P, part_size,
                        offsets_path=os.path.join(
                            edges_dir, f"{name}_partition_offsets.txt"))
                else:
                    st.write_plain_parquet(split, pq_dir,
                                           self.num_output_files)
                    counts[name] = st.stream_parts_to_binary(
                        st.parquet_parts_in_order(pq_dir), out_bin, cols)
                shutil.rmtree(pq_dir, ignore_errors=True)

            remapped.unpersist()
            # label -> dense-id mappings, streamed part-at-a-time
            map_dir = os.path.join(work, "node_map")
            st.write_plain_parquet(nodes_df, map_dir, self.num_output_files)
            st.stream_mapping_to_txt(
                st.parquet_parts_in_order(map_dir),
                os.path.join(nodes_dir, "node_mapping.txt"),
                st.NODE_LABEL, st.NODE_ID)
            if rels_df is not None:
                map_dir = os.path.join(work, "rel_map")
                st.write_plain_parquet(rels_df, map_dir, 1)
                st.stream_mapping_to_txt(
                    st.parquet_parts_in_order(map_dir),
                    os.path.join(edges_dir, "relation_mapping.txt"),
                    st.REL_LABEL, st.REL_ID)
        finally:
            spark.stop()
            shutil.rmtree(work, ignore_errors=True)

        stats = DatasetStats(
            num_nodes=int(num_nodes),
            num_edges=sum(counts.values()),
            num_relations=int(num_rels),
            num_edge_cols=3 if has_rel else 2,
            num_train=counts["train"],
            num_valid=counts["validation"],
            num_test=counts["test"],
        )
        save_stats(self.output_dir, stats)
        return ConvertResult(stats, None, None)

    # ------------------------------------------------------------------
    def _convert_stream(self):
        from marius_tpu_torch.tools.preprocess.chunked_converter import (
            ChunkedEdgeListConverter,
        )

        has_rel = self.edge_type_column is not None
        spark = self._session()
        tmp = tempfile.NamedTemporaryFile(
            mode="w", suffix=".edges.tsv", delete=False)
        try:
            try:
                df = spark.read.csv(self.train_edges, sep=self.delim,
                                    header=False)
                cols = [df.columns[self.src_column]]
                if has_rel:
                    cols.append(df.columns[self.edge_type_column])
                cols.append(df.columns[self.dst_column])
                sel = df.select(*cols)
                # partition-at-a-time stream to a local TSV (string-safe for
                # raw ids like freebase mids): this process holds one Spark
                # partition of rows at once, never the full edge list
                for row in sel.toLocalIterator(prefetchPartitions=True):
                    tmp.write("\t".join(str(v) for v in row) + "\n")
            finally:
                tmp.close()
                spark.stop()

            return ChunkedEdgeListConverter(
                output_dir=self.output_dir, train_edges=tmp.name,
                format="csv", delim="\t", src_column=0,
                edge_type_column=1 if has_rel else None,
                dst_column=2 if has_rel else 1,
                splits=self.splits, num_partitions=self.num_partitions,
                partitioned_evaluation=self.partitioned_evaluation,
                chunk_rows=self.chunk_rows).convert()
        finally:
            os.unlink(tmp.name)
