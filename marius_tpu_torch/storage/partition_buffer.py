"""Partition buffer: a GPU-resident working set over a host-RAM embedding table.

Port of ``PartitionBuffer`` from ``marius_tpu/storage/partition_buffer.py``
(:62-387; reference storage/buffer.cpp:324-713). The full table and its
Adagrad state live in host RAM as numpy arrays (bfloat16 tables as the
``np.uint16`` bits of their rows, see ``storage/transfer.py``); ``capacity`` partitions of
them live on the device as two tensors that the trainer gathers from and
updates in place. The ordering schedule (``data/ordering.py``) drives swaps:
evicted partitions are copied device->host, admitted ones host->device into
the freed slots, on the copy stream of ``storage/transfer.py``.

Evictions are deferred as in the JAX package: the rows are snapshotted on the
device at swap time and land in the host arrays at the next swap or flush
(``pending_writebacks``, the reference's AsyncWriteBlock, buffer.cpp:222-322),
so the next state's work is queued before the host waits for the copy. With
dirty-row tracking (``enable_dirty_tracking``) an eviction moves only the
rows the trainer updated since the slot was admitted, unless 95% or more are
dirty; rows never updated are already authoritative on the host. The dirty
mask has one extra row, ``buffer_rows``, that takes the padding id (JAX drops
it with ``mode="drop"``; a torch index would be out of range).

Id mapping: nodes are range-partitioned (partition p owns rows
[p*psize, (p+1)*psize)); with ``slot[p]`` the buffer slot of partition p, the
buffer-local id of global node g is ``slot[g // psize] * psize + g % psize``.
Which slot a partition takes is :func:`swap_layout`'s pure function of the
resident set and the next state, so a trainer can know a state's layout
before the swap (and build that state's local graph ahead of it).

On a (data x node) mesh (``mesh``; JAX :50-58, buffer_trainer.py:152-167)
the device buffer is row-sharded over the node axis: node index i holds
buffer rows ``[i * S, (i + 1) * S)``, S = buffer_rows / num_node rounded up
(the rows past buffer_rows are padding), values and Adagrad state alike, so
no rank's card ever holds the whole pair. Every rank keeps the whole host
table and runs the same swaps. A swap admits only the rank's rows of each
admitted slot; an eviction moves the whole slot (dirty tracking is off, as
in JAX under a mesh): one ``all_gather`` over the node axis assembles the
slot's rows on every rank, whose host tables so stay identical.
``gathered_bytes`` counts what those all_gathers received.

``ReadOnlyPartitionCache`` (JAX :433-510) is the read-only tier beside it:
partitions of a host array (node features, in RAM or a memory-mapped file,
never copied on the host) in device slots, loaded through the same copy
stream and never written back. ``mirror_layout`` gives it the
embedding buffer's slot assignment, so one buffer-local id indexes both.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from marius_tpu_torch.nn.initialization import InitConfig, initialize_tensor
from marius_tpu_torch.ops.cuda import adagrad as adagrad_kernel
from marius_tpu_torch.ops.cuda import gather as gather_kernel
from marius_tpu_torch.parallel.mesh import NODE_AXIS
from marius_tpu_torch.storage import transfer

# host initialization goes chunk by chunk above this many elements
HOST_INIT_ELEMENTS = 4_000_000
# evictions move every row of a slot once this share of its rows is dirty
FULL_WRITEBACK_SHARE = 0.95


def init_host_table(seed: int, num_nodes: int, padded: int, dim: int,
                    init_config: Optional[InitConfig] = None,
                    dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(padded, dim) initial values, rows >= num_nodes zero, with fans of
    the full (num_nodes, dim) shape (io.cpp:167-188), drawn in float32 and
    rounded to ``dtype`` (JAX :110-139; bfloat16 as uint16 bits). Small
    tables are drawn by the port's initializer from a CPU generator; large
    ones on the host in 64 MB chunks from ``np.random.default_rng(seed)``, in
    place (a bfloat16 table through one float32 chunk), so a 34 GB table
    never needs a second copy."""
    cfg = init_config or InitConfig("GLOROT_UNIFORM")
    if padded * dim <= HOST_INIT_ELEMENTS:
        gen = torch.Generator().manual_seed(seed)
        t = initialize_tensor(gen, cfg, (padded, dim), torch.float32, fans=(num_nodes, dim))
        t[num_nodes:] = 0.0
        return transfer.as_array(t.to(dtype))
    values = np.empty((padded, dim), transfer.numpy_dtype(dtype))
    dist = cfg.distribution.upper()
    rng = np.random.default_rng(seed)
    step = max(1, (64 << 20) // (dim * 4))
    # a bfloat16 table is drawn chunk by chunk into one float32 scratch block
    chunk = None if dtype == torch.float32 else np.empty((step, dim), np.float32)
    for lo in range(0, padded, step):
        rows = min(step, padded - lo)
        blk = values[lo:lo + rows] if chunk is None else chunk[:rows]
        if dist == "GLOROT_UNIFORM":
            bound = np.float32(np.sqrt(6.0 / (num_nodes + dim)))
            rng.random(out=blk, dtype=np.float32)
            blk *= 2 * bound
            blk -= bound
        elif dist == "GLOROT_NORMAL":
            rng.standard_normal(out=blk, dtype=np.float32)
            blk *= np.float32(np.sqrt(2.0 / (num_nodes + dim)))
        elif dist == "NORMAL":
            rng.standard_normal(out=blk, dtype=np.float32)
            blk *= np.float32(cfg.std)
            blk += np.float32(cfg.mean)
        elif dist == "UNIFORM":
            rng.random(out=blk, dtype=np.float32)
            blk *= np.float32(2 * cfg.scale_factor)
            blk -= np.float32(cfg.scale_factor)
        elif dist == "ZEROS":
            blk[:] = 0
        elif dist == "ONES":
            blk[:] = 1
        else:
            blk[:] = cfg.constant
        if chunk is not None:
            values[lo:lo + rows] = transfer.as_array(torch.from_numpy(blk).to(dtype))
    values[num_nodes:] = 0
    return values


def swap_layout(resident: np.ndarray, new_partitions: Sequence[int]) -> np.ndarray:
    """The (capacity,) slot -> partition table (-1: empty) after a swap from
    ``resident`` to ``new_partitions`` (performNextSwap, buffer.cpp:495-541):
    a partition that stays keeps its slot, those that leave free theirs, and
    the admitted partitions, in ascending order, fill the free slots in
    ascending order."""
    new_set = {int(p) for p in new_partitions}
    out = np.asarray([int(p) if int(p) in new_set else -1 for p in resident], np.int32)
    admit = sorted(new_set - {int(p) for p in out if p >= 0})
    free = np.nonzero(out < 0)[0]
    if len(admit) > len(free):
        raise ValueError(f"{len(new_set)} partitions exceed the capacity {len(resident)}")
    out[free[:len(admit)]] = admit
    return out


def initial_layout(partitions: Sequence[int], capacity: int) -> np.ndarray:
    """The slot table of ``load(partitions)``: slot i holds the i-th partition."""
    parts = [int(p) for p in partitions]
    if len(parts) > capacity:
        raise ValueError(f"{len(parts)} partitions exceed the capacity {capacity}")
    return np.asarray(parts + [-1] * (capacity - len(parts)), np.int32)


def _part_to_slot(layout: np.ndarray, num_partitions: int) -> np.ndarray:
    out = np.full(num_partitions, -1, np.int32)
    for slot, p in enumerate(layout):
        if p >= 0:
            out[p] = slot
    return out


@dataclasses.dataclass
class PartitionBuffer:
    num_nodes: int
    num_partitions: int
    capacity: int
    dim: int
    host_values: np.ndarray                     # (num_partitions * psize, dim)
    host_state: np.ndarray                      # Adagrad accumulator, same shape
    device: torch.device = torch.device("cpu")
    dtype: torch.dtype = torch.float32          # the rows' type (bf16: uint16 host arrays)
    device_values: Optional[torch.Tensor] = None   # (capacity * psize, dim)
    device_state: Optional[torch.Tensor] = None
    resident: Optional[np.ndarray] = None       # (capacity,) partition ids, -1 empty
    part_to_slot: Optional[np.ndarray] = None   # (num_partitions,) slot or -1
    # deferred evictions, landed at the next drain:
    #   ("full", p, values_handle, state_handle)        whole slot
    #   ("sparse", p, row_ids, values_handle, state_handle)  dirty rows only
    pending_writebacks: List = dataclasses.field(default_factory=list)
    # (buffer_rows + 1,) bool on the device: rows updated since their slot was
    # admitted; the last entry takes the padding id and is never read
    dirty: Optional[torch.Tensor] = None
    # evictions that gathered their dirty rows (two row-gather launches each)
    sparse_evictions: int = 0
    # a (data x node) Mesh: the device rows are sharded over its node axis
    mesh: Optional[object] = None
    # bytes the evictions' all_gathers received on this rank
    gathered_bytes: int = 0

    @property
    def psize(self) -> int:
        return self.host_values.shape[0] // self.num_partitions

    @property
    def buffer_rows(self) -> int:
        return self.capacity * self.psize

    @property
    def shard_size(self) -> int:
        """Device rows on this rank: the whole buffer, or its node index's
        share on a mesh (rounded up)."""
        if self.mesh is None:
            return self.buffer_rows
        return -(-self.buffer_rows // self.mesh.shape[NODE_AXIS])

    def _span(self, start: int, rows: int, node: Optional[int] = None):
        """Buffer rows ``[start, start + rows)`` that node index ``node``
        (default: this rank's) holds: (first row in its shard, offset into
        the span, count); count 0 when it holds none."""
        if self.mesh is None:
            return start, 0, rows
        s = self.shard_size
        lo = (self.mesh.axis_index(NODE_AXIS) if node is None else node) * s
        a, b = max(start, lo), min(start + rows, lo + s)
        return a - lo, a - start, max(0, b - a)

    def _write_slot_rows(self, dev: torch.Tensor, host_block: np.ndarray, start: int) -> None:
        """This rank's rows of a slot's ``host_block`` into ``dev``."""
        at, off, n = self._span(start, len(host_block))
        if n:
            transfer.write_rows(dev, host_block[off:off + n], at)

    def _zero_slot_rows(self, dev: torch.Tensor, start: int, rows: int) -> None:
        at, _, n = self._span(start, rows)
        if n:
            transfer.zero_rows(dev, at, n)

    @staticmethod
    def create(seed: int, num_nodes: int, dim: int, num_partitions: int, capacity: int,
               device="cpu", init_config: Optional[InitConfig] = None,
               dtype: torch.dtype = torch.float32, mesh=None) -> "PartitionBuffer":
        psize = -(-num_nodes // num_partitions)
        padded = num_partitions * psize
        return PartitionBuffer(
            num_nodes=num_nodes, num_partitions=num_partitions, capacity=capacity, dim=dim,
            host_values=init_host_table(seed, num_nodes, padded, dim, init_config, dtype),
            # np.zeros maps zero pages lazily: 34 GB cost nothing until written
            host_state=np.zeros((padded, dim), transfer.numpy_dtype(dtype)),
            device=torch.device(device), dtype=dtype, mesh=mesh)

    def part_rows(self, p: int) -> slice:
        return slice(p * self.psize, (p + 1) * self.psize)

    def part_valid_count(self, p: int) -> int:
        return max(0, min(self.num_nodes - p * self.psize, self.psize))

    # ------------------------------------------------------------------------
    def load(self, partitions: Sequence[int]) -> None:
        """Admit an initial resident set (PartitionBuffer::load)."""
        self._drain_writebacks()
        # drop the previous tensors before allocating: holding both would
        # double the device footprint
        self.device_values = self.device_state = None
        parts = [int(p) for p in initial_layout(partitions, self.capacity)]
        dv = transfer.alloc_rows(self.shard_size, self.dim, self.dtype, self.device)
        for slot, p in enumerate(parts):
            if p >= 0:
                self._write_slot_rows(dv, self.host_values[self.part_rows(p)], slot * self.psize)
        ds = transfer.alloc_rows(self.shard_size, self.dim, self.dtype, self.device)
        for slot, p in enumerate(parts):
            block = self.host_state[self.part_rows(p)] if p >= 0 else None
            # state is all zero until a partition has trained; the allocation
            # already is: a host scan is far cheaper than the copy
            if block is not None and block.any():
                self._write_slot_rows(ds, block, slot * self.psize)
        self.device_values, self.device_state = dv, ds
        if self.dirty is not None:
            self.dirty = torch.zeros(self.buffer_rows + 1, dtype=torch.bool, device=self.device)
        self.resident = np.asarray(parts, np.int32)
        self.part_to_slot = _part_to_slot(self.resident, self.num_partitions)

    def enable_dirty_tracking(self) -> None:
        """Opt in to dirty-row (sparse) writeback: the trainer marks updated
        rows with :func:`mark_dirty`; evictions and flushes then move only
        those rows device->host. Not on a mesh, whose evictions move whole
        slots."""
        if self.mesh is not None:
            raise ValueError("a mesh-sharded buffer evicts whole slots")
        self.dirty = torch.zeros(self.buffer_rows + 1, dtype=torch.bool, device=self.device)

    def release(self) -> None:
        """Free the device tensors after a flush; the next ``load`` re-admits."""
        self._drain_writebacks()
        self.device_values = self.device_state = None
        self.resident = self.part_to_slot = None
        if self.dirty is not None:
            self.dirty = torch.zeros(self.buffer_rows + 1, dtype=torch.bool, device=self.device)

    def _drain_writebacks(self) -> None:
        """Land every deferred eviction in the host arrays."""
        while self.pending_writebacks:
            entry = self.pending_writebacks.pop(0)
            if entry[0] == "sparse":
                _, p, ids, hv, hs = entry
                rows = p * self.psize + ids
                self.host_values[rows] = transfer.drain_read(hv)
                self.host_state[rows] = transfer.drain_read(hs)
            else:
                _, p, hv, hs = entry
                transfer.drain_read(hv, self.host_values[self.part_rows(p)])
                transfer.drain_read(hs, self.host_state[self.part_rows(p)])

    def swap_to_state(self, new_partitions: Sequence[int]) -> None:
        """Evict the partitions not in the new state and admit the new ones
        into the freed slots (performNextSwap, buffer.cpp:495-541)."""
        if self.resident is None:
            raise RuntimeError("call load() first")
        self._drain_writebacks()   # the previous state's evictions land now
        layout = swap_layout(self.resident, new_partitions)
        for p in sorted(int(p) for p in self.resident if p >= 0 and p not in layout):
            self._evict_one(p)
        admitted = [(slot, int(p)) for slot, p in enumerate(layout)
                    if p >= 0 and p != self.resident[slot]]
        self.resident = layout
        self.part_to_slot = _part_to_slot(layout, self.num_partitions)
        for slot, p in admitted:
            start = slot * self.psize
            self._write_slot_rows(self.device_values, self.host_values[self.part_rows(p)], start)
            block = self.host_state[self.part_rows(p)]
            if block.any():
                self._write_slot_rows(self.device_state, block, start)
            else:
                self._zero_slot_rows(self.device_state, start, self.psize)

    def _evict_one(self, p: int) -> None:
        """Queue the device->host writeback of partition ``p``'s slot."""
        start = int(self.part_to_slot[p]) * self.psize
        if self.mesh is not None:
            values, state = self._gather_slot(start)
            self.pending_writebacks.append(("full", p, transfer.ReadHandle(values),
                                            transfer.ReadHandle(state)))
            return
        if self.dirty is None:
            self.pending_writebacks.append((
                "full", p, transfer.read_rows_async(self.device_values, start, self.psize),
                transfer.read_rows_async(self.device_state, start, self.psize)))
            return
        mask = transfer.read_rows(self.dirty, start, self.psize)
        ids = np.nonzero(mask)[0]
        k = len(ids)
        if k and k / self.psize < FULL_WRITEBACK_SHARE:
            rows = torch.from_numpy(start + ids).to(self.device)
            vals = gather_kernel.gather_rows(self.device_values, rows)
            stats = gather_kernel.gather_rows(self.device_state, rows)
            self.sparse_evictions += 1
            # the gathered rows are already a snapshot: read them as they are
            self.pending_writebacks.append(
                ("sparse", p, ids, transfer.ReadHandle(vals), transfer.ReadHandle(stats)))
        elif k:   # nearly every row is dirty: the whole slot costs less
            self.pending_writebacks.append((
                "full", p, transfer.read_rows_async(self.device_values, start, self.psize),
                transfer.read_rows_async(self.device_state, start, self.psize)))
        self.dirty[start:start + self.psize] = False

    def _gather_slot(self, start: int):
        """The whole slot at buffer row ``start`` on every rank of the node
        axis: each sends its rows of it (values and state side by side),
        padded to the largest share, in one all_gather. Returns new (psize,
        dim) values and state tensors."""
        n, d = self.mesh.shape[NODE_AXIS], self.dim
        spans = [self._span(start, self.psize, j) for j in range(n)]
        width = max(c for _, _, c in spans)
        at, _, count = self._span(start, self.psize)
        block = torch.zeros((width, 2 * d), dtype=self.device_values.dtype, device=self.device)
        if count:
            block[:count, :d] = self.device_values[at:at + count]
            block[:count, d:] = self.device_state[at:at + count]
        gathered = self.mesh.all_gather_rows(block, NODE_AXIS)
        self.gathered_bytes += gathered.numel() * gathered.element_size()
        slot = torch.cat([gathered[j * width:j * width + c] for j, (_, _, c) in enumerate(spans)])
        return slot[:, :d].contiguous(), slot[:, d:].contiguous()

    def flush(self) -> None:
        """Write every resident partition back to host RAM."""
        self._drain_writebacks()
        if self.resident is None:
            return
        for p in [int(p) for p in self.resident if p >= 0]:
            self._evict_one(p)
        self._drain_writebacks()

    # ------------------------------------------------------------------------
    def global_to_local(self, ids: np.ndarray) -> np.ndarray:
        """Map global node ids to buffer-local ids (host-side, vectorized)."""
        slot = self.part_to_slot[ids // self.psize]
        if not (slot >= 0).all():
            raise ValueError("an id lies in a partition that is not resident")
        return (slot * self.psize + ids % self.psize).astype(np.int32)

    def slot_valid_counts(self) -> np.ndarray:
        """Valid (non-padding) rows of each slot, so that in-buffer negative
        sampling stays off padding rows."""
        out = np.zeros(self.capacity, np.int32)
        for slot, p in enumerate(self.resident):
            out[slot] = self.part_valid_count(int(p)) if p >= 0 else 0
        return out


def mark_dirty(dirty: torch.Tensor, ids: torch.Tensor) -> None:
    """Set ``dirty[ids] = True`` in place; ids outside [0, len(dirty) - 1)
    go to the last entry, the padding row's (JAX drops them)."""
    n = dirty.shape[0] - 1
    dirty[torch.where((ids >= 0) & (ids < n), ids, n)] = True


def sparse_adagrad_update_buffer(values: torch.Tensor, state: torch.Tensor,
                                 unique_local_ids: torch.Tensor, grads: torch.Tensor,
                                 lr: float) -> None:
    """Row-sparse Adagrad on the device buffer, in place (batch.cpp:62-79):
    the JAX package's plain version computes this rule over unique ids and
    drops the padding id ``buffer_rows``; here the Adagrad kernel does, which
    skips ids outside [0, rows) (the plain version of the kernel on CPU
    tensors)."""
    adagrad_kernel.sparse_adagrad_update_(values, state, unique_local_ids,
                                          grads.contiguous(), lr)


@dataclasses.dataclass
class ReadOnlyPartitionCache:
    """Partition-sliced read-only device cache over a host array: the feature
    tier beside the embedding buffer (JAX :433-510; the reference streams
    feature partitions through the same PartitionBuffer). Nothing is written
    back, so an eviction only frees the slot. ``device_rows`` holds one zero
    row past ``buffer_rows``, so the padding id ``buffer_rows`` (and any id
    past it, which the gather clamps there) reads zeros.

    ``host`` is the caller's array as it is, never copied: an in-memory array
    or a read-only ``np.memmap`` of the features file, whose partitions are
    read from the file as they are admitted. Rows past ``num_rows`` of the
    last partition (the JAX package's zero padding) are zero-filled on the
    device, so a slot holds exactly JAX's padded partition."""

    num_rows: int
    num_partitions: int
    capacity: int
    host: np.ndarray                              # (>= num_rows, dim), unpadded
    device: torch.device = torch.device("cpu")
    device_rows: Optional[torch.Tensor] = None    # (capacity * psize + 1, dim)
    resident: Optional[np.ndarray] = None         # (capacity,) partition ids, -1 empty
    part_to_slot: Optional[np.ndarray] = None     # (num_partitions,) slot or -1

    @property
    def psize(self) -> int:
        return -(-self.num_rows // self.num_partitions)

    @property
    def buffer_rows(self) -> int:
        return self.capacity * self.psize

    @staticmethod
    def create(host_rows: np.ndarray, num_rows: int, num_partitions: int, capacity: int,
               device="cpu") -> "ReadOnlyPartitionCache":
        """A cache over the first ``num_rows`` rows of ``host_rows`` (not
        copied), in partitions of ceil(num_rows / num_partitions) rows."""
        if host_rows.shape[0] < num_rows:
            raise ValueError(f"{host_rows.shape[0]} host rows for {num_rows} cached rows")
        return ReadOnlyPartitionCache(num_rows=num_rows, num_partitions=num_partitions,
                                      capacity=min(capacity, num_partitions), host=host_rows,
                                      device=torch.device(device))

    def partition_rows(self, p: int) -> np.ndarray:
        """Partition ``p``'s rows of the host array (a view; the last
        partition may be short of psize rows)."""
        lo = p * self.psize
        return self.host[lo:max(lo, min(lo + self.psize, self.num_rows))]

    def _admit(self, slot: int, p: int) -> None:
        rows = self.partition_rows(p)
        start = slot * self.psize
        if len(rows):
            transfer.write_rows(self.device_rows, rows, start)
        if len(rows) < self.psize:
            transfer.zero_rows(self.device_rows, start + len(rows), self.psize - len(rows))

    def _adopt(self, layout: np.ndarray) -> None:
        """Copy in every partition of ``layout`` that its slot does not hold yet."""
        for slot, p in enumerate(layout):
            if p >= 0 and p != self.resident[slot]:
                self._admit(slot, int(p))
        self.resident = np.asarray(layout, np.int32).copy()
        self.part_to_slot = _part_to_slot(self.resident, self.num_partitions)

    def load(self, partitions: Sequence[int]) -> None:
        """Admit an initial resident set; empty slots hold zero rows."""
        self.device_rows = None
        self.device_rows = transfer.alloc_rows(self.buffer_rows + 1, self.host.shape[1],
                                               self.host.dtype, self.device)
        self.resident = np.full(self.capacity, -1, np.int32)
        self._adopt(initial_layout(partitions, self.capacity))

    def swap_to_state(self, new_partitions: Sequence[int]) -> None:
        if self.resident is None:
            self.load(new_partitions)
            return
        self._adopt(swap_layout(self.resident, new_partitions))

    def release(self) -> None:
        """Free the device rows; the next swap loads afresh."""
        self.device_rows = self.resident = self.part_to_slot = None

    def mirror_layout(self, resident: np.ndarray) -> None:
        """Adopt another buffer's slot assignment (the embedding
        PartitionBuffer's), so buffer-local ids index both tiers alike."""
        if self.resident is None:
            self.load([])
        self._adopt(np.asarray(resident, np.int32))
