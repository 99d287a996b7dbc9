"""Partition orderings (BETA / COMET / sequential / dispersed).

A copy of ``marius_tpu/data/ordering.py`` (reference data/ordering.cpp:
12-410), numpy only, with the same ``np.random.default_rng`` draws, so a seed
gives the identical schedule: given N node partitions and a buffer capacity
of c partitions resident at once, emit the sequence of buffer states (which
partitions are resident) plus the assignment of work (edge buckets for LP,
train nodes for NC) to each state, touching every partition pair exactly once
with few swaps. Here the buffer is the GPU-resident slice of the host-RAM
embedding table; the schedule drives the host<->device copies of
``storage/partition_buffer.py``. Runs once per epoch on the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def beta_ordering(num_partitions: int, buffer_capacity: int,
                  seed: int = 0) -> List[np.ndarray]:
    """Randomized BETA eviction schedule — the reference's round-based
    streaming construction (getBetaOrderingHelper, ordering.cpp:78-126):

    Each round holds the first ``c-1`` buffer slots as an anchor set and
    streams every on-disk partition through the last slot (the displaced
    partition re-enters the stream, pairing it with later anchors too); the
    round ends by promoting ``c-1`` fresh partitions to anchors. Rounds
    shrink the on-disk set by ``c-1``, so the schedule terminates with
    ~``(n-c)^2 / (2(c-1)) + O(n)`` admits and covers every partition pair
    (asserted downstream by the bucket assigners).

    (Replaces an earlier coverage-greedy construction whose random eviction
    could fail to co-reside the last uncovered pair for an unbounded number
    of swaps on some seeds.)
    """
    rng = np.random.default_rng(seed)
    n, c = num_partitions, buffer_capacity
    assert 1 <= c <= n
    if c >= n:
        return [np.arange(n)]
    if c < 2:
        raise ValueError(
            "edge-bucket orderings need buffer_capacity >= 2: capacity 1 can "
            "never co-reside a cross-partition pair (ordering.cpp asserts the "
            "same via its swap construction)")

    perm = rng.permutation(n)
    in_buf = [int(p) for p in perm[:c]]
    on_disk = [int(p) for p in perm[c:]]
    states = [np.sort(np.asarray(in_buf))]
    while on_disk:
        rng.shuffle(in_buf)
        rng.shuffle(on_disk)
        for i in range(len(on_disk)):
            admit = on_disk[i]
            on_disk[i] = in_buf[-1]
            in_buf[-1] = admit
            states.append(np.sort(np.asarray(in_buf)))
        rng.shuffle(on_disk)
        replaced = min(c - 1, len(on_disk))
        for i in range(replaced):
            in_buf[i] = on_disk[i]
            states.append(np.sort(np.asarray(in_buf)))
        on_disk = on_disk[replaced:]
    return states


def assign_edge_buckets(states: Sequence[np.ndarray], num_partitions: int,
                        randomly: bool = True, seed: int = 0
                        ) -> List[List[Tuple[int, int]]]:
    """Assign each (src_part, dst_part) bucket to the FIRST state where both
    are resident (random choice among eligible when ``randomly``), mirroring
    randomly/greedyAssignEdgeBucketsToBuffers (ordering.cpp:128-150)."""
    rng = np.random.default_rng(seed)
    eligible = {}
    for s_idx, st in enumerate(states):
        stset = set(int(x) for x in st)
        for i in stset:
            for j in stset:
                eligible.setdefault((i, j), []).append(s_idx)
    assignment: List[List[Tuple[int, int]]] = [[] for _ in states]
    for i in range(num_partitions):
        for j in range(num_partitions):
            opts = eligible.get((i, j))
            assert opts, f"bucket ({i},{j}) never co-resident — bad ordering"
            pick = int(rng.choice(opts)) if randomly else opts[0]
            assignment[pick].append((i, j))
    return assignment


def sequential_node_ordering(num_partitions: int, buffer_capacity: int
                             ) -> List[np.ndarray]:
    """Sequential NC ordering (getSequentialNodePartitionOrdering,
    ordering.cpp:389-410): slide the buffer window over partitions in order."""
    states = []
    for start in range(0, num_partitions, buffer_capacity):
        states.append(np.arange(start, min(start + buffer_capacity, num_partitions)))
    return states


def dispersed_node_ordering(num_partitions: int, buffer_capacity: int,
                            seed: int = 0) -> List[np.ndarray]:
    """Dispersed NC ordering (getDispersedNodePartitionOrdering,
    ordering.cpp:294-387): random partition order, windowed."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_partitions)
    states = []
    for start in range(0, num_partitions, buffer_capacity):
        states.append(np.sort(perm[start:start + buffer_capacity]))
    return states


def greedy_assign_edge_buckets(states: Sequence[np.ndarray], num_partitions: int
                               ) -> List[List[Tuple[int, int]]]:
    """Assign each bucket to the FIRST state where its pair co-resides
    (greedyAssignEdgeBucketsToBuffers, ordering.cpp:128-148) — fronts the work
    so later swaps carry less."""
    assignment: List[List[Tuple[int, int]]] = [[] for _ in states]
    interacted = np.zeros((num_partitions, num_partitions), bool)
    for s_idx, st in enumerate(states):
        for i in st:
            for j in st:
                if not interacted[i, j]:
                    interacted[i, j] = True
                    assignment[s_idx].append((int(i), int(j)))
    assert interacted.all(), "ordering does not cover all partition pairs"
    return assignment


def comet_ordering(num_partitions: int, buffer_capacity: int,
                   fine_to_coarse_ratio: int = 2, num_cache_partitions: int = 0,
                   seed: int = 0) -> List[np.ndarray]:
    """Two-level COMET ordering (getTwoLevelBetaOrdering, ordering.cpp:
    241-292): run BETA over coarse partition groups (each = `ratio` fine
    partitions, randomly grouped), optionally pinning the first
    `num_cache_partitions` coarse groups in the buffer for the whole epoch.
    Fewer, larger swaps than flat BETA: each admit moves whole contiguous
    blocks."""
    rng = np.random.default_rng(seed)
    r = fine_to_coarse_ratio
    assert num_partitions % r == 0 and buffer_capacity % r == 0
    coarse_n = num_partitions // r - num_cache_partitions
    coarse_c = buffer_capacity // r - num_cache_partitions
    assert coarse_n >= 1 and (coarse_c >= 2 or coarse_c >= coarse_n), \
        "COMET needs a coarse capacity of >= 2 (raise buffer_capacity or lower fine_to_coarse_ratio)" 

    coarse_states = beta_ordering(coarse_n, coarse_c, seed=seed)

    cached_fine = num_cache_partitions * r
    fine_map = np.concatenate([
        np.arange(cached_fine),
        rng.permutation(num_partitions - cached_fine) + cached_fine,
    ]).astype(np.int32)

    states = []
    for cs in coarse_states:
        groups = [g + num_cache_partitions for g in cs] + \
                 list(range(num_cache_partitions))
        fine = np.concatenate([fine_map[g * r:(g + 1) * r] for g in groups])
        states.append(np.sort(fine))
    return states
