"""Node-partition bucketing of edge lists for out-of-core training.

Port of ``marius_tpu/tools/preprocess/partitioner.py`` (reference
tools/preprocess/partitioners/torch_partitioner.py:12-46): nodes are divided
into ``num_partitions`` contiguous ranges of ceil(num_nodes / num_partitions);
edges are stably reordered by (src partition, dst partition) so that edge
bucket (i, j) occupies a contiguous run; the n^2 bucket sizes come back in
row-major order and are written as ``<split>_partition_offsets.txt``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from marius_tpu_torch import native


def partition_order(edges: np.ndarray, num_nodes: int, num_partitions: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Row order and bucket sizes of the row-major (src bucket, dst bucket)
    grouping. src = edges[:, 0], dst = edges[:, -1]."""
    partition_size = -(-num_nodes // num_partitions)
    src_part = edges[:, 0] // partition_size
    dst_part = edges[:, -1] // partition_size
    # stable double sort, dst first then src, as the reference's torch
    # .sort(stable=True) pair: the order inside a bucket is kept
    order = np.argsort(dst_part, kind="stable")
    order = order[np.argsort(src_part[order], kind="stable")]
    flat = src_part[order].astype(np.int64) * num_partitions + dst_part[order]
    bucket_sizes = np.bincount(flat, minlength=num_partitions ** 2)
    return order, bucket_sizes.astype(np.int64)


def partition_edges(edges: np.ndarray, num_nodes: int, num_partitions: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(edges reordered into row-major (src bucket, dst bucket) runs, the
    num_partitions**2 bucket sizes), through the native stable counting sort:
    the same order as :func:`partition_order`, in O(n)."""
    return native.partition_rows(edges, num_nodes, num_partitions)


def write_partition_offsets(path: str, bucket_sizes: np.ndarray) -> None:
    """``<split>_partition_offsets.txt``: one bucket size per line, row-major."""
    with open(path, "w") as f:
        f.write("\n".join(str(int(s)) for s in bucket_sizes) + "\n")


def read_partition_offsets(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray([int(line) for line in f if line.strip()], np.int64)
