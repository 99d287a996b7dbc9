"""Learnable node-embedding table with row-sparse Adagrad, device-resident.

Port of ``marius_tpu/parallel/embedding_table.py``. The table and its Adagrad
accumulator are plain tensors (not ``nn.Parameter``s): autograd never sees the
table, only the gathered rows, and the update is applied in place by the
row-sparse Adagrad kernel. On CUDA tensors the gather and the update always
launch the hand-written kernels (``ops/cuda/gather.py``, ``ops/cuda/adagrad.py``);
on CPU tensors they run those kernels' plain PyTorch versions.

Update rule parity (reference batch.cpp:68-71):
    state[ids] += sum_grad**2
    values[ids] -= lr * sum_grad / (sqrt(state[ids]) + 1e-10)
``ids`` must be unique; padding rows carry id == num_nodes and are dropped.
Where the JAX version returns a new table, these functions update in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from marius_tpu_torch.nn.initialization import InitConfig, initialize_tensor
from marius_tpu_torch.ops.cuda import adagrad as adagrad_kernel
from marius_tpu_torch.ops.cuda import gather as gather_kernel


@dataclasses.dataclass
class EmbeddingTable:
    values: torch.Tensor  # (num_nodes, dim)
    state: torch.Tensor   # (num_nodes, dim) Adagrad accumulator (zeros at init, io.cpp:182)

    @property
    def num_nodes(self) -> int:
        return self.values.shape[0]

    @property
    def dim(self) -> int:
        return self.values.shape[1]


def init_embedding_table(generator: torch.Generator, num_nodes: int, dim: int,
                         init_config: Optional[InitConfig] = None,
                         dtype=torch.float32) -> EmbeddingTable:
    """Glorot-uniform by default with fans of the FULL (N, d) shape, matching
    the reference's chunked init (io.cpp:167-188 + initialization.cpp:101-119).
    Drawn on the generator's device."""
    cfg = init_config or InitConfig("GLOROT_UNIFORM")
    values = initialize_tensor(generator, cfg, (num_nodes, dim), dtype,
                               fans=(num_nodes, dim))
    return EmbeddingTable(values=values, state=torch.zeros_like(values))


def gather_rows(table_values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Clamped gather — padding ids (== num_nodes) read the last row, whose
    value is never used downstream."""
    return gather_kernel.gather_rows(table_values, ids)


def sparse_adagrad_update(table: EmbeddingTable, unique_ids: torch.Tensor,
                          grads: torch.Tensor, lr: float) -> EmbeddingTable:
    """Apply the fused Adagrad row update in place. ``unique_ids`` (U,) must be
    unique, padded with num_nodes (out-of-range ids are dropped)."""
    adagrad_kernel.sparse_adagrad_update_(table.values, table.state, unique_ids,
                                          grads.contiguous(), lr)
    return table


def sparse_adagrad_update_dense_accum(table: EmbeddingTable, ids: torch.Tensor,
                                      grads: torch.Tensor, lr: float) -> EmbeddingTable:
    """Same math as sparse_adagrad_update but WITHOUT requiring unique ids.

    Per-occurrence grads are summed into an (N + 1, d) accumulator G whose
    last row takes the padding ids (``index_add_`` raises on an out-of-range
    id, where JAX's scatter drops it); then the Adagrad rule runs over every
    row, ``ids = arange(N)`` with ``G[:N]``. Rows with G == 0 are exact no-ops.
    ``ids`` must lie in [0, N].
    """
    n, d = table.values.shape
    acc = torch.zeros((n + 1, d), dtype=grads.dtype, device=grads.device)
    acc.index_add_(0, ids, grads)
    all_rows = torch.arange(n, device=ids.device)
    adagrad_kernel.sparse_adagrad_update_(table.values, table.state, all_rows, acc[:n], lr)
    return table
