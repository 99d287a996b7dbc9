"""A (data x node) mesh of ranks on ``torch.distributed``.

Port of ``marius_tpu/parallel/mesh.py``. The JAX package lays its devices
out as ``np.asarray(devices).reshape(num_data, num_node)`` (:22-30) and
lets one controller place arrays on them. Here each device is driven by a
process of its own (a rank of the default process group), and rank r sits at
``(r // num_node, r % num_node)``, the same layout. The ``data`` axis splits
each batch (dense gradients are summed over it); the ``node`` axis splits the
embedding table's rows (gathers sum over it).

A :class:`Mesh` holds one process group per node row (the ranks that share
a data index) and one per data column (the ranks that share a node index).
Every rank creates all of them with ``dist.new_group``, in the same order,
as ``torch.distributed`` requires. Its collectives count themselves in
:attr:`Mesh.collectives`, so callers can read the collectives per batch.

:meth:`Mesh.ring_start` is the one point-to-point call, the counterpart of
``lax.ppermute(block, axis, [(i, (i + 1) % S)])``: each rank sends its
tensors to the next rank of an axis and receives the previous rank's, one
``isend``/``irecv`` pair posted together (``batch_isend_irecv``, which NCCL
groups), so the ring cannot deadlock; the caller computes while the block
travels and waits after. The transport follows the backend: under NCCL a
CUDA tensor goes card to card; gloo's backend table has no CUDA
``send``/``recv``, so under gloo a CUDA tensor is copied to pinned host
memory, sent, and copied back (the ranks that share one card; logged once
and counted in :attr:`Mesh.ring_bytes_staged`). A failed transfer raises.

``shard_train_state`` puts rows ``[i * S, (i + 1) * S)`` of the table and
its Adagrad state on every rank of node index i (S = rows / num_node), read
from the whole table on the host, so no card ever holds more than its shard,
and replicates the dense parameters and their optimizer state;
``replicate_tree`` is a broadcast from rank 0. ``gather_table`` assembles
the whole table on every rank's card (evaluation, checkpoints);
``gather_table_to_host`` assembles it on the host one shard at a time
(host-streamed evaluation, whose table never enters the card whole).
``put_global``, ``put_arg`` and ``put_closure`` (:47-109) have no
counterpart: they place one controller's host arrays on devices of other
processes, and here every process owns its own tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from marius_tpu_torch.nn.optimizers import tree_leaves

DATA_AXIS = "data"
NODE_AXIS = "node"
# every rank of the mesh: the default process group
WORLD_AXIS = "world"

# how long a collective may wait for its peers before it fails
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


class Mesh:
    """``num_data x num_node`` ranks of the default process group; this
    process is ``rank`` at ``coords``, its tensors on ``device``."""

    def __init__(self, num_data: int, num_node: int, device,
                 timeout: datetime.timedelta = DEFAULT_TIMEOUT):
        world = dist.get_world_size()
        if num_data * num_node != world:
            raise ValueError(f"mesh {num_data} x {num_node} needs {num_data * num_node} "
                             f"ranks; the process group has {world}")
        self.shape = {DATA_AXIS: num_data, NODE_AXIS: num_node}
        self.rank = dist.get_rank()
        self.coords = (self.rank // num_node, self.rank % num_node)
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.collectives = 0
        # ring rotations: bytes this rank sent, bytes of them staged through
        # host memory (gloo and a CUDA tensor), host seconds spent posting
        # them (the staging copy included) and waiting for them
        self.ring_bytes = 0
        self.ring_bytes_staged = 0
        self.ring_post_s = 0.0
        self.ring_wait_s = 0.0
        # ring_timing: each card-to-card wait also records a pair of CUDA
        # events, the device's wait for the hop (ring_wait_device_s)
        self.ring_timing = False
        self._ring_events = []
        self._staging_logged = False
        rows = [dist.new_group([d * num_node + s for s in range(num_node)], timeout=timeout)
                for d in range(num_data)]
        cols = [dist.new_group([d * num_node + s for d in range(num_data)], timeout=timeout)
                for s in range(num_node)]
        self._groups = {NODE_AXIS: rows[self.coords[0]], DATA_AXIS: cols[self.coords[1]],
                        WORLD_AXIS: None}

    def group(self, axis: str):
        """The process group of this rank's ranks along ``axis`` (None, the
        default group, for ``WORLD_AXIS``)."""
        return self._groups[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[0] if axis == DATA_AXIS else self.coords[1]

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` in place over ``axis`` (``lax.psum``)."""
        self.collectives += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._groups[axis])
        return t

    def all_gather_rows(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated along dim 0 in axis order."""
        self.collectives += 1
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t.contiguous(), group=self._groups[axis])
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, src: int = 0, axis: Optional[str] = None
                  ) -> torch.Tensor:
        """Overwrite ``t`` in place with rank ``src``'s (a rank of the default
        group), over every rank or over ``axis``."""
        self.collectives += 1
        dist.broadcast(t, src=src, group=None if axis is None else self._groups[axis])
        return t

    def barrier(self) -> None:
        dist.barrier()

    def ring_start(self, tensors: Sequence[torch.Tensor], axis: str) -> "PendingShift":
        """Post one hop of the ring along ``axis``: ``tensors`` (one dtype, on
        one device) go to the next rank of the axis, the previous rank's come
        in. Returns at once; :meth:`PendingShift.wait` gives the received
        tensors, shaped as ``tensors``. Several tensors travel as one flat
        message."""
        t0 = time.perf_counter()
        s, i, group = self.shape[axis], self.axis_index(axis), self._groups[axis]

        def global_rank(j):
            return j if group is None else dist.get_global_rank(group, j)

        flat = (tensors[0] if len(tensors) == 1
                else torch.cat([t.reshape(-1) for t in tensors])).contiguous()
        staged = self.backend == "gloo" and flat.device.type == "cuda"
        if staged:
            if not self._staging_logged:
                logging.getLogger("marius_tpu_torch").info(
                    "ring rotations over gloo stage CUDA tensors through pinned host memory "
                    "(gloo has no CUDA send/recv)")
                self._staging_logged = True
            send = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            send.copy_(flat)
            recv = torch.empty_like(send, pin_memory=True)
            self.ring_bytes_staged += flat.numel() * flat.element_size()
        else:
            send, recv = flat, torch.empty_like(flat)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, global_rank((i + 1) % s), group),
            dist.P2POp(dist.irecv, recv, global_rank((i - 1) % s), group)])
        self.collectives += 1
        self.ring_bytes += flat.numel() * flat.element_size()
        self.ring_post_s += time.perf_counter() - t0
        return PendingShift(self, works, send, recv, [t.shape for t in tensors], flat.device)

    def ring_wait_device_s(self) -> float:
        """Seconds the device waited for card-to-card hops since the last
        call (``ring_timing``): between each wait's event after the step's
        local work and its event after the hop. Synchronizes."""
        events, self._ring_events = self._ring_events, []
        if events:
            events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / 1e3

    def ring_shift(self, tensors: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """:meth:`ring_start` and wait: the previous rank's ``tensors``."""
        return self.ring_start(tensors, axis).wait()


class PendingShift:
    """A posted ring hop (:meth:`Mesh.ring_start`)."""

    def __init__(self, mesh: Mesh, works, send: torch.Tensor, recv: torch.Tensor, shapes,
                 device):
        # the send buffer stays referenced until the hop has arrived
        self._mesh, self._works, self._send, self._recv = mesh, works, send, recv
        self._shapes, self._device = shapes, device

    def wait(self) -> List[torch.Tensor]:
        """Block until the hop has arrived (under NCCL: order the current
        stream after it); raises if a send or receive failed."""
        mesh, flat = self._mesh, self._recv
        timed = mesh.ring_timing and flat.device.type == "cuda"
        if timed:
            before = torch.cuda.Event(enable_timing=True)
            before.record()
        t0 = time.perf_counter()
        for w in self._works:
            if w.wait() is False:
                raise RuntimeError("a ring send or receive failed")
        mesh.ring_wait_s += time.perf_counter() - t0
        if timed:
            after = torch.cuda.Event(enable_timing=True)
            after.record()
            mesh._ring_events.append((before, after))
        if flat.device != self._device:
            flat = flat.to(self._device, non_blocking=True)
        if len(self._shapes) == 1:
            return [flat.view(self._shapes[0])]
        sizes = [int(torch.Size(sh).numel()) for sh in self._shapes]
        return [p.view(sh) for p, sh in zip(flat.split(sizes), self._shapes)]


def make_mesh(num_data: Optional[int] = None, num_node: int = 1, device=None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """A mesh over every rank of the default process group; ``num_data``
    defaults to the rest of the world size. ``device`` defaults to this
    rank's current card."""
    world = dist.get_world_size()
    if num_data is None:
        num_data = world // num_node
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(num_data, num_node, device, timeout)


def shard_rows(num_rows: int, mesh: Mesh) -> int:
    """Rows of the table each node index holds; ``num_rows`` must divide evenly."""
    s = mesh.shape[NODE_AXIS]
    if num_rows % s:
        raise ValueError(f"table rows {num_rows} not divisible by node axis {s}")
    return num_rows // s


@torch.no_grad()
def replicate_tree(tree, mesh: Mesh):
    """Give every rank rank 0's values of each tensor leaf, in place."""
    for leaf in tree_leaves(tree):
        mesh.broadcast(leaf)
    return tree


def local_rows(full: torch.Tensor, num_rows: int, mesh: Mesh, device,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's rows of a table of ``num_rows`` rows whose first
    ``len(full)`` rows are ``full`` and the rest zero: a new shard on
    ``device`` (in ``full``'s dtype unless given), copied from wherever
    ``full`` lies."""
    s = shard_rows(num_rows, mesh)
    lo = mesh.axis_index(NODE_AXIS) * s
    part = full[lo:lo + s]
    out = torch.zeros((s,) + tuple(full.shape[1:]), dtype=dtype or full.dtype, device=device)
    out[:part.shape[0]].copy_(part)
    return out


def shard_train_state(state, mesh: Mesh, num_rows: int, device, dtype: torch.dtype):
    """``state`` with this rank's rows of the table and its Adagrad state,
    the table taken as ``num_rows`` rows (a multiple of num_node) whose rows
    past its end are zero, each shard a new tensor on ``device`` in
    ``dtype``; and the dense parameters and optimizer slots replicated from
    rank 0. A table on the host reaches the card one shard per rank."""
    if state.table is not None:
        table = dataclasses.replace(
            state.table,
            values=local_rows(state.table.values, num_rows, mesh, device, dtype),
            state=local_rows(state.table.state, num_rows, mesh, device, dtype))
        state = dataclasses.replace(state, table=table)
    replicate_tree(state.params, mesh)
    replicate_tree(state.opt_state.slots, mesh)
    return state


def gather_table(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole table from every node index's rows: one all_gather over the
    node axis (what XLA does when the JAX package reads a row-sharded global
    array)."""
    return mesh.all_gather_rows(shard, NODE_AXIS)


@torch.no_grad()
def gather_table_to_host(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole table on the host, assembled one node index's rows at a
    time: a broadcast over the node axis from each in turn, copied to the
    host as it arrives, so no card holds more than two shards of it."""
    s = mesh.shape[NODE_AXIS]
    first = mesh.coords[0] * s     # the global rank of node index 0 in this row
    parts = []
    for j in range(s):
        buf = shard if j == mesh.axis_index(NODE_AXIS) else torch.empty_like(shard)
        parts.append(mesh.broadcast(buf, src=first + j, axis=NODE_AXIS).cpu())
    return torch.cat(parts)
