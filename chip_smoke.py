#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (marius_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``marius_tpu_torch/csrc`` with nvcc (one
process per source, in parallel) and, beside them, the host library of
``native/marius_native.cpp`` with g++, holds each kernel against its plain PyTorch
version on the card (main-path shapes and odd shapes, bit for bit), times each
(kernel, plain version, one-call PyTorch equivalent, bound; the row gather
also at the out-of-core batch, 30,000 distinct ids into a 17.2 GB partition
buffer, and at K = 1, the launch floor; the Adagrad kernel also on that
buffer's pair of 17.2 GB tensors, and with values, state and grads as views
1-3 elements into their storage and int32 ids, each timed shape printed with
its launch plan), then drives the
port's main paths through their public entry points, each with the launch
counters set to 0 just before it and read just after:

1. link prediction: FB15K-237-shaped DistMult (14,541 nodes, 237 relations,
   272,115 synthetic train edges, d=50, batch 1000, 10 chunks x 500
   negatives, Adam lr 0.1, row-sparse Adagrad lr 0.1), one warm-up and two
   timed epochs, through the row gather and the row-sparse Adagrad;
2. full-graph node classification at ogbn-arxiv shape (169,343 nodes,
   1,166,243 power-law edges, 128 features, 40 classes, 90,941 train nodes,
   FEATURE + 3 x GraphSAGE MEAN d=128 with bias, CE SUM, Adam lr 0.01, batch
   1000): the default linear-collapse trainer (setup timed, one warm-up and
   two timed epochs), then the general seed-restricted trainer
   (fg_linear_collapse=False, one warm-up and two timed epochs, evaluation
   on the non-train nodes), through the bucketed neighbour gather-sum;
3. config-driven LP through the manager (``lp_manager``): a synthetic dataset of
   FB15K-237's shape and split sizes (14,541 nodes, 237 relations, 272,115 /
   17,535 / 20,466 uniform edges from seed 0) written with the port's
   ``storage/dataset.py``, ``examples/configuration/fb15k_237.yaml`` loaded
   by the port's ``load_config`` with only dataset_dir and model_dir
   redirected and num_epochs cut from 10 to 3, ``marius_train`` (a filtered
   valid evaluation after each epoch, the filtered test evaluation at the
   end, the model saved), then ``marius_eval`` on the same config, which must
   reload the checkpoint and reproduce the test metrics exactly. The row
   gather is counted apart for training (one per batch) and evaluation (two
   per batch: source and destination rows);
4. sampled node classification through the manager (``nc_sampled``): the
   arxiv-shaped graph, features and labels with ogbn-arxiv's published split
   sizes (90,941 / 29,799 / 48,603 nodes) written with the port's
   ``storage/dataset.py``, ``examples/configuration/ogbn_arxiv.yaml``
   (FEATURE + 3 x GraphSAGE MEAN d=128, UNIFORM 32 in and out per hop, hop
   caps [1000, 16384, 65536, 169344]) loaded by ``load_config`` with only
   dataset_dir and model_dir redirected and num_epochs cut from 10 to 3,
   ``marius_train`` (per epoch loss, s, nodes/s, truncated frontier ids and
   the valid accuracy; the test accuracy and peak device memory), then
   ``marius_eval``, which must reproduce the test metrics exactly. Training
   and each evaluation are counted apart: the row gather once per batch, the
   gather-sum three times per batch, Adagrad never; the sampler's hop kernels
   must have run. ``sampled_shapes`` then
   times both kernels at one real training batch's shapes (the outer hop's
   169,344-row feature gather, the first layer's 65,536 x 64-slot neighbour
   sum and its index_add_ backward); ``sampler_shapes`` holds the neighbour
   sampler's kernels (``csrc/sampler.cu``) against its plain version bit for
   bit over every field of the batch at each of ``SAMPLER_CASES`` (the NC
   cell's batch, a tight cap with overflow, padded seeds, DROPOUT, ALL with
   relations, one direction, the GNN LP hop, the sorted branch), times both,
   times each kernel at the NC cell's shapes under the profiler, and counts
   no host synchronisation inside ``sample`` for the sampler alone and for
   one NC training batch; ``compare_sampled_nc_with_cpu`` holds
   small sampled runs, with and without an EMBEDDING stage (the Adagrad
   kernel), against the CPU.

Then GAT and RGCN (the slice of ``nn/layers/layers.py`` gat_layer and
rgcn_layer, ``data/full_graph_rel.py`` and the inverse occurrence map):

- ``nc_gat``, the main path: ``ogbn_arxiv.yaml`` with its three GraphSAGE
  layers switched to GAT with ``bench_nc_full.py:92-96``'s gat8 options (8
  heads averaged, d = 128 -> 128 -> 40, bias), the YAML's sampling and hop
  caps kept, through ``marius_train`` (2 epochs, the one cut) and
  ``marius_eval`` on the arxiv-shaped dataset: per epoch loss, s, train
  nodes/s, truncated frontier ids and valid accuracy; test accuracy, peak
  device memory, the row gather's launches (7 per batch: the outer hop's
  features and each layer's two slot gathers) and, under torch.profiler,
  host and device ms and device operations per batch. ``gat_slot_shapes``
  times the row gather at the first layer's 65,536 x 65-slot block, and
  ``gat_against_cpu`` holds the trained model's first batches at full width
  against the CPU (logits, loss, gradients);
- ``nc_rgcn_full``: exact-ALL full-graph RGCN at arxiv shape over 8 uniform
  relations (``bench_nc_full.py:69,88-113``: FEATURE 128, RGCN 128 -> 128
  -> 128 -> 40, bias, the seed-restricted final stage) through
  ``NodeClassificationTrainer``, 1 epoch and evaluation: the same figures
  and 4 gather-sum launches per batch; ``nc_gat_full``: the same with gat8
  layers, 10 batches, s per batch; ``full_graph_shapes`` holds both kernels
  bit for bit at every full-graph shape of the two (the relational anchor
  sum and occurrence backward, GAT's inverse-map backward at d = 128 and 8;
  RGCN's slot and anchor-row gathers, GAT's block gathers at d = 128 and
  8) and times each. ``compare_nc_with_cpu``,
  ``compare_sampled_nc_with_cpu`` and ``compare_gnn_lp_with_cpu`` also hold
  small GAT (with dropout) and RGCN runs against the CPU.

Then GNN- and FEATURE-encoded link prediction:

5. ``lp_gnn``: the FB15K-237-shaped dataset of ``lp_manager`` and
   ``fb15k_237.yaml`` with its encoder replaced, at the YAML's width, by the
   reference's gs_1_layer fragment (EMBEDDING 50, one GraphSAGE MEAN layer
   50 -> 50, UNIFORM 10 sampling, which the evaluation inherits) and
   num_epochs cut from 10 to 3, both printed; ``marius_train`` (per epoch
   loss, s, edges/s, truncated frontier ids, valid MRR; peak device memory)
   and ``marius_eval``, which must reproduce the test metrics exactly.
   Launches per training batch: row gather 1, gather-sum 1, Adagrad 1; per
   evaluation: gather-sum 1 and row gather 1 per node tile, and 2 row
   gathers per edge batch. ``lp_gnn_shapes`` then times the three kernels
   at one real batch's shapes (the outer hop's gather, the layer's
   gather-sum and its index_add_ backward, Adagrad over the outer hop) and
   ``compare_gnn_lp_with_cpu`` holds small GNN and FEATURE runs (in memory
   and over the partition buffer) and GNN evaluation on quantized inputs (on
   the device and host-tiled) against the CPU, exact-ALL evaluation with an
   EMBEDDING input against sampled ALL, and tests/test_lp_gnn.py's MRR band.

Then ``lp_accuracy``: DistMult, ComplEx and TransE trained on the card on the
realizable knowledge graphs of tests/test_accuracy_regression.py (copied
here), whose filtered test MRR and Hits@10 must land in the JAX package's
pinned bands.

Then out-of-core link prediction:

6. ``compare_oocore_with_cpu``: small partition-buffer runs on the card and
   on the CPU with the same injected in-buffer draws, both table-update
   branches, BETA and COMET, 2 epochs, through a staging ring cut to 4 kB
   chunks so every copy crosses many of them; ``host_eval``: ranks from
   ``evaluate()`` and ``evaluate_from_host_table()`` on a quantized table;
7. ``lp_oocore_reload``: ``examples/configuration/freebase86m_comet.yaml``
   with a named cut to 1,000,000 nodes, ``marius_train`` with the model saved,
   then ``marius_eval``, which must reproduce the test metrics exactly;
   ``lp_gnn_oocore`` the same with gs_1_layer's encoder at d = 100 (the
   buffer's GNN branch: sampling over each state's resident subgraph, whose
   edges the prefetch thread remaps and uploads and the card sorts into a
   CSR), with per-state prep, state-graph, swap
   and compute seconds and the three kernels' launches;
8. ``lp_oocore``: the same YAML at Freebase86m's published shape (86,054,151
   nodes, 14,824 relations, d = 100, 16 partitions, buffer capacity 8, COMET)
   on a synthetic dataset written with the port's ``storage/dataset.py``, with
   the cuts it prints (train edges, 1 epoch, no saved model; nodes only if the
   host's memory cannot hold the table and its Adagrad state), through
   ``marius_train``: per epoch edges/s, loss, states, per-state prep, swap
   and compute seconds, bytes copied each way, the padded-batch share, peak
   device memory, kernel launches and the valid MRR.

After the GAT and RGCN phases, the full-graph NC leftovers at arxiv shape:
``nc_locality`` trains the general seed-restricted trainer 1 epoch over the
plain adjacency and over ``locality_reorder=True`` (reverse Cuthill-McKee;
each neighbour sum permutes its input with the row gather): the losses
agree within rtol 2e-5, and the whole neighbour sum is timed in both orders
with the gather-sum alone on the permuted x; ``nc_embedding_full`` trains
EMBEDDING (d = 128) beside FEATURE full-graph GraphSAGE 1 epoch (one
all-rows Adagrad launch per batch) and evaluates, then holds the Adagrad
kernel at all 169,343 rows bit for bit, timed against its bound;
``compare_fg_leftovers_with_cpu`` runs both small on the card and the CPU.

Then out-of-core node classification, last:

9. ``compare_nc_oocore_with_cpu``: small PartitionBufferNCTrainer runs
   (2,000 nodes, 8 partitions, capacity 4) on the card and the CPU with
   the same draws, DISPERSED and SEQUENTIAL, features and features +
   EMBEDDING, 2 epochs and evaluation (all three kernels);
   ``nc_oocore_reload``: the config below cut to 1,000,000 nodes with one
   layer's own optimizer block (a grouped optimizer), through marius_train
   with the model saved; marius_eval must reproduce the test accuracy;
10. ``nc_oocore``, the slice's main path: ``ogbn_arxiv.yaml``'s model at
   ogbn-papers100M's shape (111,059,956 nodes, 128 f32 features, 172
   classes, its published train / valid / test sizes, uniform edges from
   seed 0; UNIFORM 8 per direction over 3 hops, features PARTITION_BUFFER
   in 16 partitions, capacity 8, DISPERSED), the dataset written to disk
   and its features file mapped, not read, through marius_train: 1 epoch,
   a valid and a test evaluation. Printed cuts: edges to a tenth
   (161,568,587), 1 epoch, and nodes where host memory, free disk or the
   32 GiB disk budget of its features file cannot hold them (on an H100
   host with ~95 GiB available: 64,000,000). Per epoch the loss, seconds,
   train nodes/s, states, per-state swap, state-graph and compute seconds,
   GB and GB/s to the device, the padded share, peak device memory, host
   peak RSS, truncated frontier ids and the launches; valid and test
   accuracy above chance (1/172). ``nc_oocore_shapes`` then holds the row
   gather at the outer hop's shape (K = 4,913,000 into the cache) and the
   gather-sum at layer 0's (289,000 x 16 slots) bit for bit, timed.

Relation corruption and bf16 tables and features (each phase beside the
float32 run it varies):

- ``nc_bf16`` after ``nc_sampled``: ``ogbn_arxiv.yaml`` with
  storage.embeddings.options.dtype bfloat16 on the same dataset, 2 epochs
  (the cut), through marius_train and marius_eval: bf16 features (the zero
  sentinel row) and parameters, the sampled layers' sums through the
  gather-sum's bf16 entry; accuracy beside nc_sampled's. Then
  ``bf16_kernel_shapes``: each kernel's bf16 entry bit for bit against its
  plain version and timed beside its bound (bf16 bytes) and its one-call
  PyTorch equivalent, where PyTorch takes bf16: the row gather at every
  vector width (2-byte vectors for odd widths) and at the flagship and an
  out-of-core batch; Adagrad at the flagship and on Freebase86m's bf16
  buffer pair; the gather-sum at nc_bf16's sampled layer 0 and over the
  whole arxiv adjacency;
- ``lp_corrupt_rel`` after ``lp_manager``: ``fb15k_237.yaml`` with
  model.decoder.options.edge_decoder_method CORRUPT_REL (lp_manager's cut):
  the filtered relation MRR, which marius_eval must reproduce; ``lp_bf16``:
  the YAML with a bf16 table, its MRR and the table's device bytes beside
  lp_manager's; ``compare_rel_and_bf16_with_cpu``: small CORRUPT_REL runs
  (in memory, both update branches, and over the buffer) against the CPU at
  rtol 1e-4 / atol 1e-5, and small bf16 runs (LP in memory and over the
  buffer, full-graph NC) within 2^-3 of each leaf's norm;
- ``lp_oocore_bf16`` after ``lp_oocore``: ``freebase86m_comet.yaml`` in bf16
  at all 86,054,151 nodes, train edges cut to 8,000,000 and 1 epoch
  (printed), its swap seconds and GB per state beside lp_oocore's.

The command-line tools, last (``tools_cli``), each command run in this
process through ``marius_tpu_torch.tools.cli.main(argv)`` as a shell runs it,
the launch counters set to 0 before each and read after it: raw
tab-separated FB15K-237-shaped files (272,115 / 17,535 / 20,466 lines,
string ids, seed 0) through ``preprocess`` in memory and ``--chunked`` (every
file byte-identical, seconds and rows/s each); ``config_generator`` against
the card's memory (FB15K-237: no partition buffer; Freebase86m's 86,054,151
nodes at d = 100: 16 partitions, capacity 8, COMET); ``train`` of
``fb15k_237.yaml`` with dataset_dir and model_dir redirected and 1 epoch (the
cut); ``eval`` reproducing its test metrics exactly; ``predict`` of the test
split (metrics.txt equal to eval's, 20,466 ranks whose mean 1/rank is the
MRR within 1e-6) and of 1,000 raw test lines through the mapping files;
``postprocess`` to bin (the checkpoint's table, byte for byte) and csv (raw
ids); ``verify_baselines --synthetic --dataset all`` at its 10 epochs (both
twins must pass; all three kernels); ``reporting.profiling.trace()`` around
20 batches of the trained model, whose ``op_breakdown`` must list
``gather_rows_kernel`` and ``adagrad_kernel`` (top ten printed); and
``env_info`` and ``db2graph`` (sqlite) as ``python -m
marius_tpu_torch.tools.cli`` processes that import nothing of JAX or
marius_tpu (``-X importtime``), the first naming the card.

Then the mesh (``marius_tpu_torch/parallel/``), last: ``lp_mesh`` joins a
one-rank NCCL process group and trains ``fb15k_237.yaml``'s model at
FB15K-237's shape on a 1 x 1 mesh through the explicit sharded step (the
real process group and every collective, on trivial groups), held against
the single-device trainer from the same seed (2 batches: tables and
relations to rtol 1e-4 / atol 1e-5; 3 epochs: losses to rtol 5e-3), with
s/epoch, edges/s, collectives per batch and launches; ``lp_mesh_ranks``
starts four ``python -c`` rank processes of ``mesh_rank`` with
``MARIUS_COORDINATOR`` (gloo: they share the one card, and NCCL refuses two
ranks on one device) that run the command line's ``train`` of the YAML with
``training.mesh: {data: 2, node: 2}`` for 1 epoch (the cut): every rank's
losses equal, held to one process's run of the same YAML (rtol 5e-3) and its
test MRR (within 20%), rank 0 alone printing the metrics, ``marius_eval`` in
this process reproducing them from rank 0's checkpoint, then gs_1_layer on the
same mesh over a learnable 1,000-node KG (``make_realizable_kg``: the loss
falls, the MRR passes twice chance), then gs_1_layer under ALL sampling (it
draws nothing) at FB15K-237's shape on the same mesh, each rank holding 2
batches against its own single-card trainer from the same seed (tables,
Adagrad states and dense parameters after the first batch to rtol 1e-4 /
atol 1e-5 but for elements whose gradient was nonzero and below 1e-8, the
losses of
both batches to rtol 1e-4, at ROADMAP C5's rates: dense Adagrad 0.1, the
table 0.02); each rank
prints its backend, device,
collectives per batch (<= 3) and launches. ``lp_mesh_shapes`` holds the three
kernels at the mesh's shapes (the owner-local gather, the shard's Adagrad,
the GNN layer's gather-sum at the local caps) bit for bit, timed.

Then the data-parallel meshes, each on gloo rank processes that share the
card, each rank checked against one process's run in the same call:
``lp_mesh_gspmd`` (the cases the JAX package leaves to GSPMD, on the
explicit step): fb15k_237.yaml with CORRUPT_REL on {data: 2, node: 2} and
fb15k_237.yaml on {data: 3, node: 1} (batch 1000 and 10 chunks split 4, 3,
3 chunks), 1 epoch each (losses to rtol 5e-3, ``marius_eval`` of rank 0's
checkpoint reproducing its relation or node metrics), and a FEATURE-only
encoder at FB15K-237's shape, 2 batches against one card at rtol 1e-4 /
atol 1e-5, every rank's parameters equal; ``lp_oocore_mesh``:
freebase86m_comet.yaml at lp_oocore_reload's 1,000,000-node cut on {data:
2, node: 2}, 1 epoch (each rank's card holds half the buffer pair; peak
device bytes, the eviction all_gathers' bytes and the collectives per batch
printed; ``marius_eval`` reproducing rank 0's metrics), then its first 2
buffer states with injected draws against one card at rtol 1e-4 / atol
1e-5; ``nc_mesh``: ogbn_arxiv.yaml at the arxiv shape on {data: 2, node: 1},
1 epoch (test accuracy beside one process's, above 4x chance), one sampled
batch against one card's computation of it with each index's draws, and
train_nc's LINEAR collapse model, every batch of 1 epoch against one card's
at rtol 1e-4 / atol 1e-5. ``mesh_dp_shapes`` holds the kernels at these
paths' new shapes (the owner-local gather into a buffer shard, the
unique-row Adagrad on it, the gather-sum of one data index's arxiv batch)
bit for bit, timed.

Then the node-sharded full-graph ring, last: ``nc_ring`` starts two gloo
rank processes sharing the card on {data: 1, node: 2}; each trains three
models at the arxiv shape on the ring (ogbn_arxiv.yaml's FEATURE + 3 x
GraphSAGE MEAN with ``fg_linear_collapse=False``, gat8 and RGCN over 8
relations) for 3 batches and evaluates them, printing s per batch, hops and
ring bytes per batch, the share of each step spent posting and waiting for
hops, peak device bytes and launches; this process then runs one card's
full-graph trainer of each over the same batches: the ranks' losses equal
each other and one card's within rtol 2e-4 (GAT 5e-4), their accuracies
within 5e-4. ``ring_shapes`` holds the kernels at the ring's per-step
shapes (the SAGE step sums, GAT's slot gathers of the R and value blocks
and its sums over slot positions, RGCN's cell gather and anchor sum) bit for
bit, timed.

Then out-of-core node classification on a data-parallel mesh and the
examples, last: ``nc_oocore_mesh`` writes ``nc_oocore_reload``'s
1,000,000-node cut of the papers100M-shaped dataset (edges and splits in
proportion) and starts two gloo rank processes sharing the card that run
the command line's ``train`` of ``nc_oocore``'s config (ogbn_arxiv.yaml's
model at full width, 16 partitions, capacity 8, DISPERSED, batch 1000)
with ``training.mesh: {data: 2, node: 1}`` for 1 epoch, the model saved:
every rank holds its own replica of the feature cache and scores its 500
seeds of each batch, one all_reduce per batch. Both ranks' losses and test
accuracy must be equal, the accuracy above 4x chance and reproduced exactly
by ``marius_eval`` in this process, and each rank's launches per batch
exactly 1 row gather, 3 gather-sums and no Adagrad; each rank prints s/epoch
and train nodes/s (beside one process's run of the same config in this
call), swap seconds per state, collectives per batch and peak device bytes,
then holds one state's first batch on the mesh against one card's
computation of the same (each index's share with its own draws) at rtol 1e-4
/ atol 1e-5. ``nc_oocore_mesh_shapes`` holds the row gather and the
layer-0 gather-sum at one rank's real batch shape (its 500 seeds under hop
caps for them over the buffer rows) bit for bit, timed. ``examples_torch``
runs the five one-process ``examples/python_torch`` twins on the card at
their test sizes (tests/test_torch_examples.py's data; 2 epochs) and
``fb15k_237_mesh.py`` on two gloo rank processes under torchrun's
environment, and prints each twin's seconds and launches.

Small runs on the card are compared with the same runs on the CPU (plain
versions, which tests/test_torch_*.py hold against the JAX package).

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches, errors, times and bounds. Any failure raises and
the script exits non-zero; without a CUDA device it exits 1 and prints no
result. It imports nothing of JAX or marius_tpu.
"""

from __future__ import annotations

import concurrent.futures
import copy
import datetime
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import yaml

# FB15K-237 shape (bench.py:21-25) and the flagship config (bench.py:42-51)
NUM_NODES, NUM_RELS, NUM_EDGES, DIM, BATCH = 14_541, 237, 272_115, 50, 1000
CHUNKS, NEGATIVES = 10, 500
GATHER_IDS = 2 * BATCH + 2 * CHUNKS * NEGATIVES   # ids per batch on the dense branch
# the Adagrad checks' widths (odd ones, the flagship's 50, the buffer's 100, 200-element
# rows), and the (values, state, grads) element offsets into their storage each is checked at
ADAGRAD_DIMS = (1, 33, 50, 100, 128, 200, 257)
ADAGRAD_VIEW_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 2, 0), (0, 0, 3), (1, 2, 3), (3, 1, 2))
# the row gather's widths: 4-, 8- and 16-byte vectors, d = 100 (the out-of-core width)
GATHER_DIMS = (1, 2, 3, 5, 33, 50, 100, 128, 257)
# the out-of-core batch: Freebase86m's resident partition buffer, 8 of 16 partitions of
# 86,054,151 nodes at d = 100 (examples/configuration/freebase86m_comet.yaml), and that
# config's one batch on the dedup branch, 2 x 10,000 + 2 x 10 x 500 ids made distinct
FB86M_NODES, FB86M_PARTITIONS, FB86M_BUFFER, FB86M_DIM = 86_054_151, 16, 8, 100
OOC_ROWS = FB86M_BUFFER * -(-FB86M_NODES // FB86M_PARTITIONS)   # 43,027,080 rows, 17.2 GB
OOC_IDS = 2 * 10_000 + 2 * 10 * 500
# batches cycled while timing it: 16 x 24 MB between two uses of one, far above L2's 50 MB
OOC_BATCHES = 16
# lp_oocore's cuts of Freebase86m (338,586,276 published train edges, 10 epochs), its
# valid and test splits, and the host memory kept free beside the table and its state
OOC_TRAIN_EDGES, OOC_EVAL_EDGES, OOC_EPOCHS, FB86M_RELS = 32_000_000, 100_000, 1, 14_824
OOC_HOST_SPARE = 16 << 30
# lp_oocore_reload's cut (its 2 epochs cover the epoch-to-epoch reload)
RELOAD_NODES, RELOAD_TRAIN_EDGES, RELOAD_EVAL_EDGES, RELOAD_EPOCHS = (1_000_000, 2_000_000,
                                                                      20_000, 2)
# FB15K-237's published split sizes, and the one cut of fb15k_237.yaml (10 epochs)
FB_VALID, FB_TEST, LP_MANAGER_EPOCHS = 17_535, 20_466, 3
# lp_gnn's and lp_gnn_oocore's cuts of the two YAMLs' 10 epochs
GNN_LP_EPOCHS, GNN_OOCORE_EPOCHS = 3, 2
# ogbn-arxiv shape (bench_nc_full.py:29-37) and its model (examples/configuration/ogbn_arxiv.yaml)
ARXIV_NODES, ARXIV_EDGES, ARXIV_FEATS, ARXIV_CLASSES = 169_343, 1_166_243, 128, 40
ARXIV_TRAIN, ARXIV_HUB = 90_941, 13_161
NC_DIM, NC_GNN_STAGES, NC_LR = 128, 3, 0.01
# ogbn-arxiv's published valid and test split sizes, and the one cut of ogbn_arxiv.yaml
# (10 epochs)
ARXIV_VALID, NC_SAMPLED_EPOCHS = 29_799, 3
# GAT and RGCN at arxiv shape (bench_nc_full.py:69,92-96): gat8's heads, the RGCN
# variant's relations; the cuts of ogbn_arxiv.yaml's 10 epochs for nc_gat and of
# the full-graph runs (one epoch for RGCN, a few batches for GAT)
GAT_HEADS, ARXIV_RELS, NC_GAT_EPOCHS, NC_GAT_FULL_BATCHES = 8, 8, 2, 10
# nc_gat's test accuracy floor (chance 0.025): the labels are a linear function of each
# node's own features, which gat8's attention averages with up to 64 neighbours; three
# card runs gave 0.093-0.102, and tests/test_torch_gat_arxiv_labels.py shows the JAX
# package's gat8 reaching the port's accuracy, far below GraphSAGE's, on a cut of this
# data. The nc_gat model's batches at full width on the card against the CPU:
NC_GAT_MIN_ACCURACY, NC_GAT_CPU_BATCHES, NC_GAT_GRAD_F64_TOL = 0.08, 2, 3e-2
# the neighbour sum's widths: d=1 (GCN counts), the model's 128, the collapse's 129/259/519
SUM_DIMS = (1, 33, 128, 129, 259, 519)
# ogbn-papers100M's shape (BASELINE.json configs[4], BASELINE.md:22): nodes, f32 feature
# width, classes, the published train / valid / test split sizes and edges; nc_oocore
# cuts the edges to a tenth
PAPERS_NODES, PAPERS_FEATS, PAPERS_CLASSES = 111_059_956, 128, 172
PAPERS_TRAIN, PAPERS_VALID, PAPERS_TEST = 1_207_179, 125_265, 214_338
PAPERS_EDGES, PAPERS_NC_EDGES = 1_615_685_872, 161_568_587
# its buffer (the reference's defaults, SURVEY.md:136), fanout per direction
# (bench_products.py:48), the cut of ogbn_arxiv.yaml's 10 epochs, and nc_oocore_reload's cut
PAPERS_PARTITIONS, PAPERS_BUFFER, PAPERS_FANOUT, PAPERS_EPOCHS = 16, 8, 8, 1
NC_RELOAD_NODES = 1_000_000
# the most nc_oocore writes to disk for its features file: with the rest of the run's
# datasets and checkpoints, the whole run writes well under 45 GiB
PAPERS_DISK_BYTES = 32 << 30
# the mesh phases: lp_mesh's one-rank NCCL mesh and its epochs; lp_mesh_ranks' ranks on
# the one card (gloo) as a data x node mesh, its cut of fb15k_237.yaml's 10 epochs, and
# the gs_1_layer run on a learnable KG (make_realizable_kg at 1,000 nodes; its epochs); the
# process groups' timeout and the ranks' own time limit (seconds)
LP_MESH_EPOCHS, MESH_DATA, MESH_NODE, MESH_EPOCHS = 3, 2, 2, 1
MESH_KG_NODES, MESH_KG_EPOCHS = 1000, 4
# an Adagrad accumulator below this (a gradient below 1e-8) makes the step's
# size a function of its rounding (ROADMAP C5)
ACC_FLOOR = 1e-16
MESH_TIMEOUT_S, MESH_RANKS_LIMIT_S = 300, 600
# the data-parallel mesh phases: lp_mesh_gspmd's cut of fb15k_237.yaml's 10 epochs and its
# uneven mesh (neither batch 1000 nor 10 chunks divides by 3); lp_oocore_mesh's cut of
# freebase86m_comet.yaml's (lp_oocore_reload's 1,000,000 nodes) and the buffer states it
# holds against one process; nc_mesh's mesh and its cut of ogbn_arxiv.yaml's 10 epochs
GSPMD_EPOCHS, GSPMD_UNEVEN = 1, (3, 1)
OOC_MESH_EPOCHS, OOC_MESH_STATES = 1, 2
NC_MESH, NC_MESH_EPOCHS = (2, 1), 1
# nc_oocore_mesh's cut of ogbn_arxiv.yaml's 10 epochs (nc_oocore_reload's 1,000,000 nodes,
# on NC_MESH); the examples' epochs (their test size)
NC_OOC_MESH_EPOCHS, EXAMPLE_EPOCHS = 1, 2
# the node-sharded ring (nc_ring): its mesh (gloo ranks sharing the card), its models
# (ogbn_arxiv.yaml's SAGE forced onto the ring, gat8, RGCN over 8 relations), the
# training batches each runs against one card's trainer, and the loss tolerances
NC_RING, NC_RING_BATCHES = (1, 2), 3
NC_RING_MODELS = ("sage", "gat", "rgcn")
NC_RING_RTOL = {"sage": 2e-4, "gat": 5e-4, "rgcn": 2e-4}
# the edges of the gather-sum kernel's 128-byte column slabs (32 f32 or 64 bf16 columns)
SLAB_EDGE_DIMS = (15, 16, 17, 31, 32, 63, 64, 65)
# single buckets: caps from one slot to the 13k-slot hub, with the hub split's edges
# (256 slots: one task; 257 and 512: two pieces)
SUM_SHAPES = ((1000, 1), (777, 3), (300, 40), (5, 256), (4, 257), (3, 512), (20, 700),
              (2, ARXIV_HUB))


def card_rates(name: str):
    """(bytes/s, float32 FLOP/s outside the tensor cores) from NVIDIA's data
    sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s; H100 PCIe 2.0 TB/s and 51."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    return 3.35e12, 67e12


def bound_ms(nbytes: float, ops: float, rates) -> tuple:
    t_bytes, t_ops = nbytes / rates[0], ops / rates[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50, samples: int = 7) -> float:
    """Median device time of one call, from CUDA events around ``reps`` calls.
    A sleep kernel queued first lets the launches pile up behind it, so the
    events measure the device and not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        torch.cuda._sleep(20_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def library_or_none(fn, what: str, dtype, **kw):
    """``time_ms`` of a one-call PyTorch yardstick, or None (printed) where
    PyTorch refuses the dtype; float32 calls are never excused."""
    try:
        return time_ms(fn, **kw)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        if dtype == torch.float32:
            raise
        print(f"{what} does not take {dtype}: {type(e).__name__}: {str(e)[:160]}", flush=True)
        return None


def gather_max_err(gather, table, ids) -> float:
    """Max |kernel - plain version|; raises unless they agree bit for bit."""
    out, ref = gather.gather_rows(table, ids), gather.gather_rows_plain(table, ids)
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.equal(out, ref):
        raise AssertionError(f"gather_rows differs from plain (table {tuple(table.shape)} at "
                             f"{table.storage_offset()} elements into its storage, "
                             f"{ids.shape[0]} {ids.dtype} ids)")
    return float((out - ref).abs().max())


def time_gather(gather, table, batches, rates) -> dict:
    """Kernel, plain version, index_select (on clamped ids, which it needs) and
    bound at one shape; the timed calls cycle through ``batches`` of ids."""
    def cycled(fn, ids_list):
        it = itertools.cycle(ids_list)
        return lambda: fn(table, next(it))

    n, d = table.shape
    es = table.element_size()
    clamped = [ids.clamp(0, n - 1) for ids in batches]
    rows = [int(torch.unique(c).numel()) for c in clamped]
    k = batches[0].shape[0]
    # each distinct row read once, the ids read once, K rows written
    nbytes = float(np.mean(rows)) * d * es + k * batches[0].element_size() + k * d * es
    b_ms, b_by = bound_ms(nbytes, 0.0, rates)
    return {
        "ms": time_ms(cycled(gather.gather_rows, batches)),
        "plain_ms": time_ms(cycled(gather.gather_rows_plain, batches)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(cycled(lambda t, i: torch.index_select(t, 0, i), clamped)),
        "k": k, "d": d, "distinct_rows": float(np.mean(rows)), "bound_bytes": nbytes,
    }


def gather_shapes(gather, dev, rates) -> dict:
    """The row gather timed, and checked bit for bit, at four shapes:
    the flagship batch (K = 12,000 int64 ids into the 14,541 x 50 table,
    L2-resident), the evaluation batch (the source column of 1,000 edges, made
    contiguous, into the same table, as int64 as the evaluator holds it and as
    int32), the out-of-core batch (30,000 sorted distinct ids padded with N
    into the 43,027,080 x 100 partition buffer, cycling through 16 batches so
    rows come from HBM) and the launch floor (K = 1, flagship table)."""
    from marius_tpu_torch.ops.unique import unique_padded
    from marius_tpu_torch.train.trainer import pad_edges

    g = torch.Generator(device=dev).manual_seed(4)
    table = torch.randn(NUM_NODES, DIM, device=dev, generator=g)
    ids = torch.randint(0, NUM_NODES, (GATHER_IDS,), device=dev, generator=g)
    err = max(gather_max_err(gather, table, ids), gather_max_err(gather, table, ids[:1]))
    eval_edges = torch.as_tensor(pad_edges(synthetic_edges(5, NUM_NODES, NUM_RELS, BATCH),
                                           BATCH)[0], device=dev)
    eval_ids = [eval_edges[:, col].contiguous() for col in (0, -1)]
    for col in eval_ids:
        for idt in (torch.int64, torch.int32):
            err = max(err, gather_max_err(gather, table, col.to(idt)))
    shapes = {"flagship": time_gather(gather, table, [ids], rates),
              "eval_batch": time_gather(gather, table, eval_ids, rates),
              "k1_floor": time_gather(gather, table, [ids[:1]], rates)}
    del table, ids
    big = torch.empty((OOC_ROWS, FB86M_DIM), device=dev).normal_(generator=g)
    batches = [unique_padded(torch.randint(0, OOC_ROWS, (OOC_IDS,), device=dev, generator=g),
                             OOC_IDS, OOC_ROWS).ids for _ in range(OOC_BATCHES)]
    for idt in (torch.int64, torch.int32):
        err = max(err, gather_max_err(gather, big, batches[0].to(idt)))
    shapes["out_of_core"] = time_gather(gather, big, batches, rates)
    del big, batches
    torch.cuda.empty_cache()
    shapes["max_abs_err"] = err
    return shapes


def print_gather_shapes(shapes: dict, card: str) -> None:
    for name in [n for n in ("flagship", "eval_batch", "out_of_core", "k1_floor")
                 if n in shapes]:
        s = shapes[name]
        print(f"gather_rows, {name} (K={s['k']}, d={s['d']}, {s['distinct_rows']:.1f} distinct "
              f"rows, {s['bound_bytes'] / 1e6:.4f} MB): kernel {s['ms'] * 1e3:.2f} us  plain "
              f"{s['plain_ms'] * 1e3:.2f} us  index_select {s['library_ms'] * 1e3:.2f} us  bound "
              f"{s['bound_ms'] * 1e3:.2f} us ({s['bound_by']})  [{card}]", flush=True)


def check_gather(gather, dev, rates):
    """Bit for bit against the plain version at every vector width, at tables
    that are views 4 and 8 bytes into their storage, at K = 1, 33 and 4,099,
    with both id types and ids below 0 and at or above N; then checked and
    timed at the flagship, evaluation, out-of-core and K = 1 shapes."""
    g = torch.Generator(device=dev).manual_seed(1)
    n = 1009
    for d in GATHER_DIMS:
        base = torch.randn(n * d + 2, device=dev, generator=g)
        ids = torch.randint(-3, n + 3, (4099,), device=dev, generator=g)   # n: padding id
        for off in (0, 1, 2):
            table = base[off:off + n * d].view(n, d)
            for k in (1, 33, 4099):
                for idt in (torch.int64, torch.int32):
                    gather_max_err(gather, table, ids[:k].to(idt))
    shapes = gather_shapes(gather, dev, rates)
    flagship = shapes["flagship"]
    return {
        "name": "gather_rows", "route": "cuda", "source": "marius_tpu_torch/csrc/gather.cu",
        "replaces": "marius_tpu/ops/pallas/gather.py:61", "max_abs_err": shapes["max_abs_err"],
        "ms": flagship["ms"], "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"], "bound_by": flagship["bound_by"],
        "library_ms": flagship["library_ms"],
        "eval_batch": shapes["eval_batch"], "out_of_core": shapes["out_of_core"],
        "k1_floor": shapes["k1_floor"],
    }


def plan_text(p: dict) -> str:
    """An Adagrad launch plan (``AdagradPlan._asdict()``) as printed beside its time."""
    return (f"V={p['vec_bytes']} G={p['lanes']} U={p['unroll']} grid={p['grid']} "
            f"stores={'evict-first' if p['stream_stores'] else 'default'}")


def check_adagrad_views(adagrad, dev, g, dtype) -> float:
    """The Adagrad kernel bit for bit against its plain version at every
    ADAGRAD_DIMS width, with values, state and grads each a contiguous view
    0-3 elements into its storage (ADAGRAD_VIEW_OFFSETS), with int64 and
    int32 ids, some below 0 and some at or above N (skipped); rows that no id
    names must not move. Returns the largest |kernel - plain| seen (0)."""
    n, k = 1009, 777
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    scale = 0.1 if dtype == torch.bfloat16 else 1.0   # bf16 steps kept small
    err = 0.0

    def view(rows, d, off, fill):
        return fill(torch.empty(rows * d + off, device=dev)).to(dtype)[off:].view(rows, d)

    for d in ADAGRAD_DIMS:
        for offs in ADAGRAD_VIEW_OFFSETS:
            vals = view(n, d, offs[0], lambda t: t.normal_(generator=g))
            state = view(n, d, offs[1], lambda t: t.uniform_(generator=g))
            grads = view(k, d, offs[2], lambda t: t.normal_(generator=g).mul_(scale))
            ids = torch.randperm(n + 50, device=dev, generator=g)[:k] - 20
            untouched = torch.ones(n, dtype=torch.bool, device=dev)
            untouched[ids[(ids >= 0) & (ids < n)]] = False
            before = (vals[untouched].clone(), state[untouched].clone())
            for idt in (torch.int64, torch.int32):
                v_ref, s_ref = vals.clone(), state.clone()
                adagrad.sparse_adagrad_update_plain_(v_ref, s_ref, ids, grads, 0.1)
                adagrad.sparse_adagrad_update_(vals, state, ids.to(idt), grads, 0.1)
                torch.cuda.synchronize()
                where = f"{dtype} d={d}, offsets {offs}, {idt} ids"
                err = max(err, float((vals.float() - v_ref.float()).abs().max()),
                          float((state.float() - s_ref.float()).abs().max()))
                if not (torch.equal(vals.view(bits), v_ref.view(bits))
                        and torch.equal(state.view(bits), s_ref.view(bits))):
                    raise AssertionError(f"sparse_adagrad_update_ differs from plain at {where}")
            if not (torch.equal(vals[untouched].view(bits), before[0].view(bits))
                    and torch.equal(state[untouched].view(bits), before[1].view(bits))):
                raise AssertionError(f"sparse_adagrad_update_ wrote an untouched row at {dtype} "
                                     f"d={d}, offsets {offs}")
    return err


def check_adagrad(adagrad, dev, rates):
    """Bit for bit against the plain version at every ADAGRAD_DIMS width and
    view offset with both id types (check_adagrad_views), at the flagship's
    dense-accumulate branch (every row, half with zero gradients) and on
    Freebase86m's buffer pair; timed at both, each with its plan."""
    g = torch.Generator(device=dev).manual_seed(2)
    views_err = check_adagrad_views(adagrad, dev, g, torch.float32)
    # the trainer's dense-accumulate branch: every row, about half with G == 0
    vals = torch.randn(NUM_NODES, DIM, device=dev, generator=g)
    state = torch.rand(NUM_NODES, DIM, device=dev, generator=g)
    ids = torch.arange(NUM_NODES, device=dev)
    grads = torch.randn(NUM_NODES, DIM, device=dev, generator=g)
    zero_rows = torch.rand(NUM_NODES, device=dev, generator=g) < 0.5
    grads[zero_rows] = 0.0
    v1, s1, v2, s2 = vals.clone(), state.clone(), vals.clone(), state.clone()
    adagrad.sparse_adagrad_update_(v1, s1, ids, grads, 0.1)
    adagrad.sparse_adagrad_update_plain_(v2, s2, ids, grads, 0.1)
    torch.cuda.synchronize()
    err = max(float((v1 - v2).abs().max()), float((s1 - s2).abs().max()), views_err)
    if err != 0.0:
        raise AssertionError(f"sparse_adagrad_update_ differs from plain by {err}")
    if not (torch.equal(v1[zero_rows], vals[zero_rows])
            and torch.equal(s1[zero_rows], state[zero_rows])):
        raise AssertionError("a row with zero gradient changed")
    nbytes = NUM_NODES * 8 + NUM_NODES * DIM * 4 * 5
    b_ms, b_by = bound_ms(nbytes, NUM_NODES * DIM * 7, rates)
    # the one-call yardstick: torch's functional Adagrad on a row-sparse gradient
    # (same rule and eps; it divides before scaling by lr, so it is not bit-equal)
    from torch.optim.adagrad import adagrad as torch_adagrad

    sparse_grads = torch.sparse_coo_tensor(ids[None], grads, (NUM_NODES, DIM),
                                           is_coalesced=True, check_invariants=False)
    v3, s3, step = vals.clone(), state.clone(), torch.zeros((), device=dev)

    def library():
        torch_adagrad([v3], [sparse_grads], [s3], [step], has_sparse_grad=True, lr=0.1,
                      weight_decay=0.0, lr_decay=0.0, eps=1e-10, maximize=False)

    library()
    torch.testing.assert_close(v3, v1, rtol=1e-6, atol=1e-6)
    out = {
        "name": "sparse_adagrad_update_", "route": "cuda",
        "source": "marius_tpu_torch/csrc/adagrad.cu",
        "replaces": "marius_tpu/ops/pallas/adagrad.py:89", "max_abs_err": err,
        "ms": time_ms(lambda: adagrad.sparse_adagrad_update_(v1, s1, ids, grads, 0.1)),
        "plain_ms": time_ms(lambda: adagrad.sparse_adagrad_update_plain_(v2, s2, ids, grads,
                                                                         0.1)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library),
        "plan": adagrad.tensor_plan(v1, s1, ids, grads)._asdict(),
    }
    del vals, state, v1, s1, v2, s2, v3, s3, grads, sparse_grads
    out["out_of_core"] = adagrad_out_of_core(adagrad, dev, rates)
    out["max_abs_err"] = max(out["max_abs_err"], out["out_of_core"]["max_abs_err"])
    return out


def buffer_id_batches(dev, g) -> list:
    """OOC_BATCHES batches of the out-of-core Adagrad update's ids: 30,000
    sorted distinct ids into the buffer pair, then 1,000 padding ids equal to
    buffer_rows at the tail, as unique_padded leaves them."""
    from marius_tpu_torch.ops.unique import unique_padded

    batches = []
    for _ in range(OOC_BATCHES):
        draw = torch.randint(0, OOC_ROWS, (OOC_IDS + 1000,), device=dev, generator=g)
        ids = unique_padded(draw, OOC_IDS + 1000, OOC_ROWS).ids
        if int((ids < OOC_ROWS).sum()) < OOC_IDS:
            raise AssertionError("fewer than 30,000 distinct ids drawn")
        ids[OOC_IDS:] = OOC_ROWS
        batches.append(ids)
    return batches


def adagrad_out_of_core(adagrad, dev, rates, dtype=torch.float32) -> dict:
    """The Adagrad kernel on Freebase86m's buffer pair (two 43,027,080 x 100
    f32 or bf16 tensors, 8.6e9 elements together, offsets past 2^31) with one
    batch's 30,000 sorted unique ids plus padding ids equal to buffer_rows.
    The touched rows must equal the plain version's bit for bit (applied to
    copies of those rows: a plain copy of the pair would not fit beside it)
    and a sample of untouched rows must not move. Then timed, cycling through
    16 id batches so rows come from HBM, against the bytes bound and
    torch.optim.adagrad's sparse call."""
    from torch.optim.adagrad import adagrad as torch_adagrad

    g = torch.Generator(device=dev).manual_seed(6)
    values = torch.empty((OOC_ROWS, FB86M_DIM), device=dev, dtype=dtype).normal_(generator=g)
    state = torch.empty((OOC_ROWS, FB86M_DIM), device=dev, dtype=dtype).uniform_(generator=g)
    batches = buffer_id_batches(dev, g)
    ids = batches[0]
    valid = ids[ids < OOC_ROWS]
    if int(valid.max()) * FB86M_DIM < 2 ** 31:
        raise AssertionError("the check must touch rows past 2^31 elements")
    grads = torch.randn(ids.numel(), FB86M_DIM, device=dev, generator=g).to(dtype)
    untouched = torch.randint(0, OOC_ROWS, (100_000,), device=dev, generator=g)
    untouched = untouched[~torch.isin(untouched, valid)]
    before = (values[untouched].clone(), state[untouched].clone())
    keep = ids < OOC_ROWS
    v_ref, s_ref = values[valid].clone(), state[valid].clone()
    adagrad.sparse_adagrad_update_plain_(v_ref, s_ref, torch.arange(valid.numel(), device=dev),
                                         grads[keep], 0.1)
    adagrad.sparse_adagrad_update_(values, state, ids, grads, 0.1)
    torch.cuda.synchronize()
    err = max(float((values[valid] - v_ref).abs().max()), float((state[valid] - s_ref).abs().max()))
    if err != 0.0 or not (torch.equal(values[valid], v_ref) and torch.equal(state[valid], s_ref)):
        raise AssertionError(f"the Adagrad kernel differs from plain on the buffer pair by {err}")
    if not (torch.equal(values[untouched], before[0]) and torch.equal(state[untouched], before[1])):
        raise AssertionError("the Adagrad kernel wrote an untouched row of the buffer pair")
    k = int(keep.sum())
    nbytes = 5 * k * FB86M_DIM * values.element_size() + ids.numel() * ids.element_size()
    b_ms, b_by = bound_ms(nbytes, 7 * k * FB86M_DIM, rates)
    it = itertools.cycle(batches)
    sparse = [torch.sparse_coo_tensor(b[b < OOC_ROWS][None], grads[b < OOC_ROWS],
                                      (OOC_ROWS, FB86M_DIM), is_coalesced=True,
                                      check_invariants=False) for b in batches]
    it_sparse = itertools.cycle(sparse)
    step = torch.zeros((), device=dev)

    def library():
        torch_adagrad([values], [next(it_sparse)], [state], [step], has_sparse_grad=True,
                      lr=0.1, weight_decay=0.0, lr_decay=0.0, eps=1e-10, maximize=False)

    out = {
        "ms": time_ms(lambda: adagrad.sparse_adagrad_update_(values, state, next(it), grads, 0.1)),
        "plain_ms": time_ms(lambda: adagrad.sparse_adagrad_update_plain_(
            values, state, next(it), grads, 0.1), reps=10, samples=5),
        "library_ms": library_or_none(library, "torch.optim.adagrad (sparse)", dtype,
                                      reps=10, samples=5),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "k": k, "rows": OOC_ROWS,
        "d": FB86M_DIM, "bound_bytes": nbytes,
        "plan": adagrad.tensor_plan(values, state, ids, grads)._asdict(),
    }
    del values, state, batches, sparse, grads
    torch.cuda.empty_cache()
    return out


# The six shapes the main paths launch the Adagrad kernel at: name, dtype, table rows,
# d, ids that update a row, padding ids, id dtype, share of rows whose gradient is 0.
# The buffer pairs are lp_oocore's and lp_oocore_bf16's (one batch's distinct ids, cycled
# over OOC_BATCHES); the others update every row in order: the flagship's and lp_bf16's
# dense-accumulate branch (rows no id of the batch names have a zero gradient, about
# half, as check_adagrad draws them), lp_gnn's outer hop (int32, with the padding id),
# nc_embedding_full's table.
ADAGRAD_SHAPES = (
    ("buffer_pair_f32", torch.float32, OOC_ROWS, FB86M_DIM, OOC_IDS, 1000, torch.int64, 0.0),
    ("buffer_pair_bf16", torch.bfloat16, OOC_ROWS, FB86M_DIM, OOC_IDS, 1000, torch.int64, 0.0),
    ("flagship_bf16", torch.bfloat16, NUM_NODES, DIM, NUM_NODES, 0, torch.int64, 0.5),
    ("flagship_f32", torch.float32, NUM_NODES, DIM, NUM_NODES, 0, torch.int64, 0.5),
    ("lp_gnn_outer", torch.float32, NUM_NODES, DIM, NUM_NODES, 1, torch.int32, 0.0),
    ("embedding_all_rows", torch.float32, ARXIV_NODES, NC_DIM, ARXIV_NODES, 0, torch.int64,
     0.0),
)


def parent_adagrad(path: str):
    """The Adagrad entry points of a library built from an earlier adagrad.cu
    (values, state, ids, grads, n_rows, k, d, lr, stream), by (dtype, id dtype)."""
    import ctypes

    lib = ctypes.CDLL(path)
    fns = {}
    for dt, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for it, iname in ((torch.int64, "i64"), (torch.int32, "i32")):
            fn = getattr(lib, f"marius_sparse_adagrad_{dn}_{iname}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_float,
                                                                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[dt, it] = fn
    return fns


def adagrad_turns(adagrad, rates, card, parent=None) -> dict:
    """The Adagrad kernel at each of ADAGRAD_SHAPES, timed in turns within
    one process: the parent commit's kernel (``parent``, from
    parent_adagrad, when given), the kernel with its plan, and the kernel
    with the other store policy, in the order parent, kernel, other,
    other, kernel, parent. Each runs once bit for bit against the plain
    version on the rows it touches before it is timed. Beside them: the
    plain version, torch.optim.adagrad's sparse call and the bound (each
    input read once, each output written once, at the card's rate). A
    measurement run on its own, by a script that builds the parent's
    adagrad.cu with nvcc; the smoke run does not call it."""
    from torch.optim.adagrad import adagrad as torch_adagrad

    dev = torch.device("cuda")
    out = {}
    for name, dtype, n, d, k_valid, pad, idt, zero in ADAGRAD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(31)
        values = torch.empty((n, d), device=dev, dtype=dtype).normal_(generator=g)
        state = torch.empty((n, d), device=dev, dtype=dtype).uniform_(generator=g)
        if n == OOC_ROWS:
            batches = [b.to(idt) for b in buffer_id_batches(dev, g)]
        else:
            batches = [torch.arange(n + pad, device=dev, dtype=idt)]
        k = batches[0].numel()
        grads = (torch.randn(k, d, device=dev, generator=g) * 0.1).to(dtype)
        grads[torch.rand(k, device=dev, generator=g) < zero] = 0
        p = adagrad.tensor_plan(values, state, batches[0], grads)
        plans = {"kernel": p, "other_stores": p._replace(stream_stores=not p.stream_stores)}

        def run_plan(q, ids):
            adagrad.launch(values, state, ids, grads, 0.1, q)

        def run_parent(ids):
            with torch.cuda.device(dev):
                rc = parent[dtype, idt](values.data_ptr(), state.data_ptr(), ids.data_ptr(),
                                        grads.data_ptr(), n, k, d, 0.1,
                                        torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"the parent's Adagrad kernel failed: CUDA error {rc}")

        runs = {v: (lambda ids, q=q: run_plan(q, ids)) for v, q in plans.items()}
        if parent is not None:
            runs["parent"] = run_parent
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        ids = batches[0]
        keep = (ids >= 0) & (ids < n)
        valid = ids[keep].long()
        err = 0.0
        for v, run in runs.items():
            v_ref, s_ref = values[valid].clone(), state[valid].clone()
            adagrad.sparse_adagrad_update_plain_(v_ref, s_ref, torch.arange(valid.numel(),
                                                                            device=dev),
                                                 grads[keep], 0.1)
            run(ids)
            torch.cuda.synchronize()
            if not (torch.equal(values[valid].view(bits), v_ref.view(bits))
                    and torch.equal(state[valid].view(bits), s_ref.view(bits))):
                raise AssertionError(f"Adagrad {v} differs from plain at {name}")
            err = max(err, float((values[valid].float() - v_ref.float()).abs().max()))

        def cycled(run):
            it = itertools.cycle(batches)
            return lambda: run(next(it))

        order = ["kernel", "other_stores", "other_stores", "kernel"]
        if parent is not None:
            order = ["parent", *order, "parent"]
        ms = {v: [] for v in runs}
        for v in order:
            ms[v].append(time_ms(cycled(runs[v])))
        big = n == OOC_ROWS or n == ARXIV_NODES
        plain_ms = time_ms(cycled(lambda ids: adagrad.sparse_adagrad_update_plain_(
            values, state, ids, grads, 0.1)), **({"reps": 10, "samples": 5} if big else {}))
        sparse = [torch.sparse_coo_tensor(b[(b >= 0) & (b < n)].long()[None],
                                          grads[(b >= 0) & (b < n)], (n, d), is_coalesced=True,
                                          check_invariants=False) for b in batches]
        it_sparse = itertools.cycle(sparse)
        step = torch.zeros((), device=dev)

        def library():
            torch_adagrad([values], [next(it_sparse)], [state], [step], has_sparse_grad=True,
                          lr=0.1, weight_decay=0.0, lr_decay=0.0, eps=1e-10, maximize=False)

        library_ms = library_or_none(library, "torch.optim.adagrad (sparse)", dtype,
                                     **({"reps": 10, "samples": 5} if big else {}))
        nbytes = 5 * k_valid * d * values.element_size() + k * batches[0].element_size()
        b_ms, b_by = bound_ms(nbytes, 7 * k_valid * d, rates)
        out[name] = {"ms": ms, "plans": {v: q._asdict() for v, q in plans.items()},
                     "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bound_bytes": nbytes, "max_abs_err": err,
                     "k": k, "padding": pad, "rows": n, "d": d, "dtype": str(dtype),
                     "ids": str(idt), "zero_gradient_share": zero}
        times = "  ".join(f"{v} " + ", ".join(f"{t * 1e3:.2f}" for t in ts) + " us"
                          + (f" ({plan_text(plans[v]._asdict())})" if v in plans else "")
                          for v, ts in ms.items())
        lib = "-" if library_ms is None else f"{library_ms * 1e3:.2f} us"
        print(f"adagrad turns, {name} ({k} {idt} ids, {pad} padding, {n} x {d} {dtype}, "
              f"{zero:.0%} of the rows with zero gradient, "
              f"{nbytes / 1e6:.4f} MB): {times}  plain {plain_ms * 1e3:.2f} us  "
              f"torch.optim.adagrad (sparse) {lib}  bound {b_ms * 1e3:.2f} us ({b_by})  "
              f"max_abs_err {err}  [{card}]", flush=True)
        del values, state, grads, batches, sparse
        torch.cuda.empty_cache()
    return out


def lp_model(num_rels: int, dim: int, decoder: str = "DISTMULT",
             method: str = "CORRUPT_NODE"):
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import LINK_PREDICTION, Model

    return Model(LINK_PREDICTION,
                 EncoderConfig(((LayerConfig(layer_type="EMBEDDING", output_dim=dim),),)),
                 EdgeDecoder(decoder, num_rels, dim, decoder_method=method))


def synthetic_edges(seed: int, num_nodes: int, num_rels: int, num_edges: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, num_nodes, num_edges),
                     rng.integers(0, num_rels, num_edges),
                     rng.integers(0, num_nodes, num_edges)], axis=1).astype(np.int32)


def train_flagship(card: str):
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    trainer = LinkPredictionTrainer(
        lp_model(NUM_RELS, DIM), NUM_NODES, NUM_RELS,
        synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES),
        NegativeSamplingConfig(num_chunks=CHUNKS, negatives_per_positive=NEGATIVES),
        batch_size=BATCH, seed=0)   # device=None: the GPU
    if trainer.device.type != "cuda" or not trainer.dense_accum:
        raise AssertionError("the flagship must train on the GPU's dense-accumulate branch")
    gather.launches = adagrad.launches = 0
    results = [trainer.train_epoch() for _ in range(3)]
    launches = {"gather_rows": gather.launches, "sparse_adagrad_update_": adagrad.launches}
    losses = [r["loss"] for r in results]
    for i, r in enumerate(results):
        tag = "warm-up" if i == 0 else "timed"
        print(f"flagship epoch {i} ({tag}): loss {r['loss']:.6f}  {r['epoch_time_s']:.4f} s  "
              f"{r['edges_per_sec']:.1f} edges/s  [{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"flagship losses are not finite and decreasing: {losses}")
    table = trainer.state.table.values
    if table.shape != (NUM_NODES, DIM) or not bool(torch.isfinite(table).all()):
        raise AssertionError("flagship table is not finite or has the wrong shape")
    expected = 3 * trainer.num_batches
    for name, count in launches.items():
        if count != expected:
            raise AssertionError(f"{name} launched {count} times in 3 epochs, "
                                 f"expected {expected} (one per batch)")
    timed = results[1:]
    eps = sum(r["num_edges"] for r in timed) / sum(r["epoch_time_s"] for r in timed)
    print(f"flagship timed epochs: {eps:.1f} edges/s over {len(timed)} epochs  [{card}]",
          flush=True)
    return launches


def _batch_negatives(cfg, edges, num_nodes, inverse):
    """Deterministic negatives (a function of the batch), the same on any device."""
    from marius_tpu_torch.data.samplers.negative import NegativeSample

    nb = int(cfg.negatives_per_positive * cfg.degree_fraction)
    c, nu = cfg.num_chunks, cfg.negatives_per_positive - nb
    col = 0 if inverse else edges.shape[1] - 1
    base = edges[:, col].sum() + (3 if inverse else 0)
    ar = torch.arange(c * max(nu, nb), device=edges.device)
    uni = ((base + 7 * ar[:c * nu]) % num_nodes).reshape(c, nu)
    rows = ((base + 5 * ar[:c * nb]) % edges.shape[0]).reshape(c, nb)
    return NegativeSample(torch.cat([edges[:, col][rows], uni], dim=1), rows)


def compare_lp_with_cpu():
    """A small LP run on the card against the same run on the CPU (plain kernels)."""
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    n, r, d, e = 300, 5, 50, 2000
    edges = synthetic_edges(3, n, r, e)
    cfg = NegativeSamplingConfig(num_chunks=4, negatives_per_positive=40, degree_fraction=0.25)
    worst = 0.0
    for dense in (True, False):
        trainers = [LinkPredictionTrainer(lp_model(r, d), n, r, edges, cfg, batch_size=200,
                                          seed=1, device=dev) for dev in ("cpu", "cuda")]
        cpu, gpu = trainers
        for t in trainers:
            t.dense_accum = dense
            t._sample_negatives = (lambda edges_b, inverse, _c=t.neg_config:
                                   _batch_negatives(_c, edges_b, n, inverse))
        gpu._epoch_permutation = lambda s: cpu._epoch_permutation(s).to(gpu.device)
        for _ in range(2):
            lc, lg = cpu.train_epoch()["loss"], gpu.train_epoch()["loss"]
            if not math.isclose(lc, lg, rel_tol=1e-4):
                raise AssertionError(f"loss on the card {lg} != on the CPU {lc}")
        for a, b in [(cpu.state.table.values, gpu.state.table.values),
                     (cpu.state.table.state, gpu.state.table.state),
                     (cpu.state.params["decoder"]["relations"],
                      gpu.state.params["decoder"]["relations"])]:
            b = b.detach().cpu()
            worst = max(worst, float((a.detach() - b).abs().max()))
            torch.testing.assert_close(b, a.detach(), rtol=1e-4, atol=1e-5)
    print(f"small LP run, card against CPU (both update branches, 2 epochs): "
          f"max abs difference {worst:.3g} (tolerance rtol 1e-4, atol 1e-5)", flush=True)


def compare_eval_with_cpu():
    """LP evaluation on the card against the CPU: ranks equal exactly. The
    table and relations are multiples of 1/4 in [-2, 2] at d = 32, so every
    score is exact in float32 in any order of addition and ties are common;
    300 nodes in chunks of 128 (the last partial), 250 edges (and 3
    repeated) in batches of 64 (the last partial), typed, inverse relations
    on; DistMult and ComplEx; filtered through the true-candidate list and
    through the per-chunk membership test, and sampled with the ALL local
    filter on negatives injected into both."""
    from marius_tpu_torch.convert import copy_train_state_
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.train import evaluator as evaluator_mod
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    n, r, d, e, b = 300, 5, 32, 1200, 64
    rng = np.random.default_rng(9)
    edges = synthetic_edges(9, n, r, e)
    hub = np.stack([np.full(80, 7), np.full(80, 1), rng.integers(0, n, 80)], 1)
    edges = np.concatenate([edges, hub.astype(np.int32)])   # a run of 80 true tails
    test = edges[rng.permutation(len(edges))[:250]]
    test = np.concatenate([test, test[:3]])
    neg = NegativeSamplingConfig(num_chunks=4, negatives_per_positive=16,
                                 degree_fraction=0.25, local_filter_mode="ALL")

    def inject(ev):
        ev._sample_negatives = lambda edges_b, idx, inverse, valid_rows: _batch_negatives(
            neg, edges_b, n, inverse)
        return ev

    checked = 0
    for decoder in ("DISTMULT", "COMPLEX"):
        # a model each: the decoder's relation tables live on its module
        models = [lp_model(r, d, decoder) for _ in range(2)]
        cpu, gpu = (LinkPredictionTrainer(m, n, r, edges, neg, batch_size=b, seed=1,
                                          device=dev).state
                    for m, dev in zip(models, ("cpu", "cuda")))
        with torch.no_grad():
            for t in [cpu.table.values] + list(cpu.params["decoder"].values()):
                t.copy_(torch.from_numpy(rng.integers(-8, 9, t.shape).astype(np.float32) / 4))
        copy_train_state_(gpu, cpu)
        for filtered, tail_limit in ((True, evaluator_mod.TAIL_CAP_LIMIT), (True, 0),
                                     (False, evaluator_mod.TAIL_CAP_LIMIT)):
            limit, evaluator_mod.TAIL_CAP_LIMIT = evaluator_mod.TAIL_CAP_LIMIT, tail_limit
            try:
                evs = [inject(evaluator_mod.LinkPredictionEvaluator(
                    m, n, r, test, all_edges=edges, batch_size=b, filtered=filtered,
                    neg_config=neg, node_chunk=128, device=dev))
                    for m, dev in zip(models, ("cpu", "cuda"))]
                (rc, sc), (rg, sg) = (ev.compute_all_ranks(s) for ev, s in zip(evs, (cpu, gpu)))
                res = [ev.evaluate(s) for ev, s in zip(evs, (cpu, gpu))]
            finally:
                evaluator_mod.TAIL_CAP_LIMIT = limit
            what = f"{decoder}, {'filtered' if filtered else 'sampled'}, tail limit {tail_limit}"
            if rc.shape != (2, len(test)) or not (np.array_equal(rc, rg)
                                                  and np.array_equal(sc, sg)):
                raise AssertionError(f"ranks or scores on the card differ from the CPU ({what})")
            if not (rc > 1).any():
                raise AssertionError(f"no rank above 1: the comparison is vacuous ({what})")
            for k in res[0]:
                if k != "eval_time_s" and not math.isclose(res[0][k], res[1][k], rel_tol=1e-6):
                    raise AssertionError(f"evaluate()[{k!r}] on the card {res[1][k]} != on the "
                                         f"CPU {res[0][k]} ({what})")
            checked += rc.size
    print(f"small LP evaluation, card against CPU (DistMult and ComplEx; filtered with both "
          f"correction paths, sampled with the ALL filter; 3 node chunks, partial last batch): "
          f"{checked} ranks equal exactly, evaluate() within rtol 1e-6", flush=True)


# -- config-driven LP through the manager ---------------------------------------

def write_fb15k_shaped(directory: str) -> None:
    """Uniform edges from seed 0 in FB15K-237's shape and split sizes, in the
    dataset layout (storage/dataset.py) that marius_tpu.tools.preprocess writes."""
    from marius_tpu_torch.storage.dataset import DatasetStats, save_split, save_stats

    edges = synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES + FB_VALID + FB_TEST)
    splits = {"train": edges[:NUM_EDGES], "valid": edges[NUM_EDGES:NUM_EDGES + FB_VALID],
              "test": edges[NUM_EDGES + FB_VALID:]}
    for name, part in splits.items():
        save_split(directory, name, part)
    save_stats(directory, DatasetStats(
        num_nodes=NUM_NODES, num_edges=len(edges), num_relations=NUM_RELS, num_edge_cols=3,
        num_train=NUM_EDGES, num_valid=FB_VALID, num_test=FB_TEST))


def lp_manager(card: str, tag: str = "lp_manager", edit=None) -> dict:
    """fb15k_237.yaml through marius_train and marius_eval on the card;
    ``edit(raw)`` changes the loaded YAML and returns what it changed.
    Returns {part: gather launches}, the Adagrad launches, the test metrics
    and the table's device bytes (values and Adagrad state)."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.train import evaluator as evaluator_mod

    config = Path(__file__).resolve().parent / "examples" / "configuration" / "fb15k_237.yaml"
    with open(config) as f:
        raw = yaml.safe_load(f)
    metric_keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    # each evaluation's gather launches, counted around evaluate()
    evals = []
    evaluate = evaluator_mod.LinkPredictionEvaluator.evaluate

    def counted(self, state, encoded=None):
        before = gather.launches
        res = evaluate(self, state, encoded)
        evals.append((self.num_batches, gather.launches - before))
        return res

    with tempfile.TemporaryDirectory() as tmp:
        write_fb15k_shaped(f"{tmp}/dataset")
        raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
        epochs_in_yaml = raw["training"]["num_epochs"]
        raw["training"]["num_epochs"] = LP_MANAGER_EPOCHS
        changed = "" if edit is None else f"; {edit(raw)}"
        cfg = load_config(raw, model_dir=f"{tmp}/model")
        print(f"{tag}: {config.relative_to(config.parents[2])} with dataset_dir and "
              f"model_dir redirected{changed}; one cut: num_epochs {epochs_in_yaml} -> "
              f"{LP_MANAGER_EPOCHS}", flush=True)
        evaluator_mod.LinkPredictionEvaluator.evaluate = counted
        try:
            gather.launches = adagrad.launches = 0
            out = marius_train(cfg)   # device=None: the GPU
            train_total, adagrad_launches = gather.launches, adagrad.launches
            train_evals = list(evals)
            gather.launches = 0
            again = marius_eval(cfg)
            reload_total = gather.launches
        finally:
            evaluator_mod.LinkPredictionEvaluator.evaluate = evaluate
        meta_written = Path(f"{tmp}/model/meta.yaml").exists()

    rt = out["runtime"]
    trainer, test_ev = rt.trainer, rt.test_evaluator
    if trainer.device.type != "cuda" or test_ev.device.type != "cuda":
        raise AssertionError("marius_train must run on the GPU")
    losses = [e["loss"] for e in out["epochs"]]
    for i, e in enumerate(out["epochs"]):
        print(f"{tag} epoch {i}: loss {e['loss']:.6f}  {e['epoch_time_s']:.4f} s  "
              f"{e['edges_per_sec']:.1f} edges/s  [{card}]", flush=True)
    if len(losses) != LP_MANAGER_EPOCHS or not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{tag} losses are not finite and falling: {losses}")
    valid = out["evals"]
    if [v["epoch"] for v in valid] != list(range(1, LP_MANAGER_EPOCHS + 1)) or "test" not in out:
        raise AssertionError("a valid evaluation must run after each epoch and a test "
                             "evaluation at the end")
    for res in valid + [out["test"]]:
        print(f"{tag} {res['split']} (epoch {res.get('epoch', LP_MANAGER_EPOCHS)}): "
              f"filtered MRR {res['mrr']:.6f}  Hits@1 {res['hits@1']:.6f}  "
              f"Hits@10 {res['hits@10']:.6f}  mean rank {res['mean_rank']:.2f}  over "
              f"{int(res['num_evaluated'])} ranks  {res['eval_time_s']:.4f} s  [{card}]",
              flush=True)
        if not 0.0 < res["mrr"] <= 1.0:
            raise AssertionError(f"MRR out of (0, 1]: {res}")
    if not meta_written:
        raise AssertionError("marius_train did not write meta.yaml")
    test, reloaded = out["test"], again["test"]
    if any(test[k] != reloaded[k] for k in metric_keys):
        raise AssertionError(f"marius_eval's test metrics {reloaded} differ from "
                             f"marius_train's {test}")
    s = test["eval_time_s"]
    print(f"{tag} test evaluation: {s:.4f} s (marius_eval: {reloaded['eval_time_s']:.4f} s)"
          f" for {FB_TEST} edges in {test_ev.num_batches} batches of {test_ev.batch_size}, "
          f"both directions: {FB_TEST / s:.1f} edges/s, {test['num_evaluated'] / s:.1f} ranks/s; "
          f"node_chunk {test_ev.node_chunk}, tail_cap dst {test_ev.dst_tail_cap} "
          f"src {test_ev.src_tail_cap}  [{card}]", flush=True)
    print(f"{tag}: marius_eval reloaded the checkpoint and reproduced the test metrics "
          "exactly", flush=True)

    train_batches = LP_MANAGER_EPOCHS * trainer.num_batches
    eval_launches = sum(n for _, n in train_evals)
    counts = {f"{tag} train": train_total - eval_launches,
              f"{tag} eval": eval_launches, f"{tag} marius_eval": reload_total}
    if counts[f"{tag} train"] != train_batches or adagrad_launches != train_batches:
        raise AssertionError(f"{tag} training launched the gather "
                             f"{counts[f'{tag} train']} and Adagrad {adagrad_launches} "
                             f"times, expected {train_batches} (one per batch)")
    for batches, n in evals:
        if n != 2 * batches:
            raise AssertionError(f"an evaluation of {batches} batches launched the gather "
                                 f"{n} times, expected {2 * batches}")
    print(f"{tag} gather launches: " + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f" ({len(train_evals)} evaluations in marius_train, 2 per batch)", flush=True)
    table = trainer.state.table
    return {"gather_rows": counts, "sparse_adagrad_update_": adagrad_launches, "test": test,
            "table_bytes": table.values.nbytes + table.state.nbytes,
            "table_dtype": str(table.values.dtype)}


# -- out-of-core link prediction ------------------------------------------------

def host_memory() -> dict:
    """MemTotal and MemAvailable in bytes, from /proc/meminfo."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def injected_draws(trainer, step, inverse, seed=3):
    """In-buffer draws as a function of (epoch, step, direction), the same on
    any device, for the buffer trainer's ``_in_buffer_draws`` seam."""
    cfg = trainer.neg_config
    c, n = cfg.num_chunks, cfg.negatives_per_positive
    num_deg = int(n * cfg.degree_fraction)
    rng = np.random.default_rng((seed, trainer.epoch, step, int(inverse)))
    t = lambda a: torch.from_numpy(a).to(trainer.device)  # noqa: E731
    return (t(rng.integers(0, trainer.capacity, (c, n))),
            t(rng.integers(0, trainer.buffer.psize, (c, n))),
            t(rng.integers(0, trainer.batch_size, (c, num_deg))) if num_deg else None)


def compare_oocore_with_cpu():
    """Small partition-buffer runs on the card and on the CPU (plain kernels,
    plain copies) with the same draws: BETA and COMET, both table-update
    branches, ComplEx with degree-sampled negatives, 2 epochs. The card's
    copies go through a staging ring cut to 4 kB chunks, so every admit and
    eviction crosses many of them."""
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.storage import transfer
    from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer

    n, r, d, e = 600, 5, 32, 6000
    edges = synthetic_edges(7, n, r, e)
    cfg = NegativeSamplingConfig(num_chunks=4, negatives_per_positive=40, degree_fraction=0.5)
    chunk, transfer.CHUNK_BYTES = transfer.CHUNK_BYTES, 4096
    transfer._staging.clear()
    worst = 0.0
    try:
        for ordering in ("BETA", "COMET"):
            for dense in (True, False):
                cpu, gpu = trainers = [PartitionBufferLPTrainer(
                    lp_model(r, d, "COMPLEX"), n, r, edges, cfg, batch_size=200,
                    num_partitions=8, buffer_capacity=4, ordering=ordering, seed=1, device=dev)
                    for dev in ("cpu", "cuda")]
                for t in trainers:
                    t.dense_accum = dense
                    t._in_buffer_draws = (lambda step, inverse, _t=t:
                                          injected_draws(_t, step, inverse))
                if not np.array_equal(cpu.buffer.host_values, gpu.buffer.host_values):
                    raise AssertionError("the two buffers start from different tables")
                for _ in range(2):
                    lc, lg = cpu.train_epoch()["loss"], gpu.train_epoch()["loss"]
                    if not math.isclose(lc, lg, rel_tol=1e-4):
                        raise AssertionError(f"buffer loss on the card {lg} != on the CPU {lc} "
                                             f"({ordering}, dense_accum={dense})")
                pairs = [(cpu.buffer.host_values, gpu.buffer.host_values),
                         (cpu.buffer.host_state, gpu.buffer.host_state)]
                pairs += [(a.detach().numpy(), b.detach().cpu().numpy()) for a, b in
                          zip(tree_leaves(cpu.params), tree_leaves(gpu.params))]
                for a, b in pairs:
                    worst = max(worst, float(np.abs(a - b).max()))
                    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    finally:
        transfer.CHUNK_BYTES = chunk
        transfer._staging.clear()
    print(f"small partition-buffer runs, card against CPU (BETA and COMET, both update "
          f"branches, 4 kB staging chunks, 2 epochs): max abs difference {worst:.3g} "
          f"(tolerance rtol 1e-4, atol 1e-5)", flush=True)


def host_eval_on_card():
    """Filtered ranks from evaluate() and evaluate_from_host_table() on the
    card, on quantized tables (multiples of 1/4: every score exact): the
    metrics must agree (evaluate's sums are float32: rtol 1e-6), and the
    host-tiled ones must equal the CPU's exactly. 300 nodes in tiles of 128,
    250 edges in slices of 64; DistMult and ComplEx."""
    from marius_tpu_torch.convert import copy_train_state_
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    n, r, d, b = 300, 5, 32, 64
    rng = np.random.default_rng(10)
    edges = synthetic_edges(10, n, r, 1200)
    test = edges[rng.permutation(len(edges))[:250]]
    keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    for decoder in ("DISTMULT", "COMPLEX"):
        models = [lp_model(r, d, decoder) for _ in range(2)]
        cpu, gpu = (LinkPredictionTrainer(m, n, r, edges, NegativeSamplingConfig(4, 8),
                                          batch_size=b, seed=1, device=dev).state
                    for m, dev in zip(models, ("cpu", "cuda")))
        with torch.no_grad():
            for t in [cpu.table.values] + list(cpu.params["decoder"].values()):
                t.copy_(torch.from_numpy(rng.integers(-8, 9, t.shape).astype(np.float32) / 4))
        copy_train_state_(gpu, cpu)
        evs = [LinkPredictionEvaluator(m, n, r, test, all_edges=edges, batch_size=b,
                                       node_chunk=128, device=dev)
               for m, dev in zip(models, ("cpu", "cuda"))]
        host = cpu.table.values.numpy()
        on_card = evs[1].evaluate(gpu)
        tiled = [ev.evaluate_from_host_table(host, s.params, edge_slice=64, node_tile=128)
                 for ev, s in zip(evs, (cpu, gpu))]
        for k in keys:
            if tiled[1][k] != tiled[0][k] or not math.isclose(tiled[1][k], on_card[k],
                                                              rel_tol=1e-6):
                raise AssertionError(f"host-tiled {k} on the card {tiled[1][k]} != CPU "
                                     f"{tiled[0][k]} or evaluate() {on_card[k]} ({decoder})")
    print("host-tiled evaluation on the card (DistMult and ComplEx, 3 node tiles, 4 edge "
          "slices): metrics equal the CPU's exactly and evaluate()'s within rtol 1e-6",
          flush=True)


def write_freebase_shaped(directory: str, num_nodes: int, train: int, held_out: int) -> None:
    """Uniform edges from seed 0 over ``num_nodes`` nodes and Freebase86m's
    14,824 relations, in the dataset layout of storage/dataset.py."""
    from marius_tpu_torch.storage.dataset import DatasetStats, save_split, save_stats

    edges = synthetic_edges(0, num_nodes, FB86M_RELS, train + 2 * held_out)
    for name, part in (("train", edges[:train]), ("valid", edges[train:train + held_out]),
                       ("test", edges[train + held_out:])):
        save_split(directory, name, part)
    save_stats(directory, DatasetStats(
        num_nodes=num_nodes, num_edges=len(edges), num_relations=FB86M_RELS, num_edge_cols=3,
        num_train=train, num_valid=held_out, num_test=held_out))


def freebase_raw(tmp: str, save_model: bool, encoder=None, epochs: int = OOC_EPOCHS,
                 dtype=None) -> dict:
    """freebase86m_comet.yaml as a dict with only dataset_dir redirected,
    num_epochs cut to ``epochs`` and save_model set; ``encoder``, a raw
    encoder section, replaces the YAML's; ``dtype`` sets
    storage.embeddings.options.dtype."""
    path = Path(__file__).resolve().parent / "examples" / "configuration" / "freebase86m_comet.yaml"
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
    raw["storage"]["save_model"] = save_model
    raw["training"]["num_epochs"] = epochs
    if encoder is not None:
        raw["model"]["encoder"] = encoder
    if dtype is not None:
        raw["storage"]["embeddings"]["options"]["dtype"] = dtype
    return raw


def freebase_config(tmp: str, num_nodes: int, save_model: bool, encoder=None,
                    epochs: int = OOC_EPOCHS, dtype=None):
    """:func:`freebase_raw` loaded, its model_dir redirected too."""
    from marius_tpu_torch.config import load_config

    cfg = load_config(freebase_raw(tmp, save_model, encoder, epochs, dtype),
                      model_dir=f"{tmp}/model")
    s = cfg.storage
    if (s.embeddings_backend, s.num_partitions, s.buffer_capacity, s.edge_bucket_ordering,
            cfg.model.encoder.embedding_dim) != ("PARTITION_BUFFER", 16, 8, "COMET", 100):
        raise AssertionError("freebase86m_comet.yaml no longer holds the shape this phase runs")
    return cfg


class EpochProbe:
    """Wraps PartitionBufferLPTrainer.train_epoch and
    LinkPredictionEvaluator.evaluate while a manager call runs: turns on the
    per-state timings and records, per epoch, the launch counts, the copies
    each way and the peak device memory, and per evaluation its gather
    launches. Counters are set to 0 at the start of each call and read at its end."""

    def __init__(self):
        from marius_tpu_torch.train import buffer_trainer, evaluator

        self.trainer_cls = buffer_trainer.PartitionBufferLPTrainer
        self.evaluator_cls = evaluator.LinkPredictionEvaluator
        self.epochs, self.evals, self.first_epoch_at = [], [], None

    def __enter__(self):
        from marius_tpu_torch.ops.cuda import adagrad, gather
        from marius_tpu_torch.ops.cuda import nbr_sum as ns
        from marius_tpu_torch.storage import transfer

        train_epoch, evaluate = self.trainer_cls.train_epoch, self.evaluator_cls.evaluate
        self._saved = (train_epoch, evaluate)
        probe = self

        def profiled(trainer, *a, **kw):
            if probe.first_epoch_at is None:
                probe.first_epoch_at = time.perf_counter()
            trainer.profile_states = True
            torch.cuda.reset_peak_memory_stats()
            gather.launches = adagrad.launches = ns.launches = 0
            transfer.bytes_h2d = transfer.bytes_d2h = 0
            transfer.seconds_h2d = transfer.seconds_d2h = 0.0
            evictions = trainer.buffer.sparse_evictions
            res = train_epoch(trainer, *a, **kw)
            res.update(gather=gather.launches, adagrad=adagrad.launches, gather_sum=ns.launches,
                       sparse_evictions=trainer.buffer.sparse_evictions - evictions,
                       h2d=transfer.bytes_h2d, d2h=transfer.bytes_d2h,
                       h2d_s=transfer.seconds_h2d, d2h_s=transfer.seconds_d2h,
                       peak=torch.cuda.max_memory_allocated(),
                       timings=list(trainer.last_state_timings),
                       graph_s=list(trainer.last_graph_seconds))
            probe.epochs.append(res)
            return res

        def counted(ev, state, encoded=None):
            torch.cuda.reset_peak_memory_stats()
            gather.launches = ns.launches = 0
            res = evaluate(ev, state, encoded)
            probe.evals.append((ev.num_batches, gather.launches,
                                torch.cuda.max_memory_allocated(), ns.launches))
            return res

        self.trainer_cls.train_epoch = profiled
        self.evaluator_cls.evaluate = counted
        return self

    def __exit__(self, *exc):
        self.trainer_cls.train_epoch, self.evaluator_cls.evaluate = self._saved


def report_oocore_epochs(tag: str, out: dict, probe: EpochProbe, card: str,
                         epochs: int = OOC_EPOCHS) -> dict:
    """Print each epoch's numbers, check them, and return the launches by part
    and, per epoch, the swaps: (seconds per state, GB per state to and from
    the device)."""
    rt = out["runtime"]
    trainer = rt.trainer
    if type(trainer).__name__ != "PartitionBufferLPTrainer" or trainer.device.type != "cuda" \
            or trainer.dense_accum:
        raise AssertionError(f"{tag} must train the buffer's unique-id branch on the GPU")
    layers = trainer.model.encoder.num_gnn_stages
    losses = [e["loss"] for e in out["epochs"]]
    for i, e in enumerate(probe.epochs):
        prep, swap, comp = (sum(t[k] for t in e["timings"]) for k in range(3))
        padded = e["masked_batches"] / (e["batches_run"] + e["masked_batches"])
        print(f"{tag} epoch {i}: loss {e['loss']:.6f}  {e['epoch_time_s']:.4f} s  "
              f"{e['edges_per_sec']:.1f} edges/s  {e['states_run']} of "
              f"{e['num_buffer_states']} states, {e['batches_run']} batches + "
              f"{e['masked_batches']} masked (padded share {padded:.4f}, max_batches "
              f"{e['max_batches']})  [{card}]", flush=True)
        print(f"{tag} epoch {i} per state (prep, swap, compute) s: " + ", ".join(
            f"({a:.3f}, {b:.3f}, {c:.3f})" for a, b, c in e["timings"])
            + f"; sums {prep:.3f}, {swap:.3f}, {comp:.3f}", flush=True)
        if e["graph_s"]:
            print(f"{tag} epoch {i} state graphs' edges remapped and uploaded on the "
                  f"prefetch thread (s): " + ", ".join(f"{g:.3f}" for g in e["graph_s"])
                  + f"; sum {sum(e['graph_s']):.3f}, edge arrays padded to "
                  f"{e['max_graph_edges']}", flush=True)
        print(f"{tag} epoch {i} copies: host->device {e['h2d'] / 1e9:.3f} GB in "
              f"{e['h2d_s']:.3f} s ({e['h2d'] / 1e9 / max(e['h2d_s'], 1e-9):.3f} GB/s), "
              f"device->host {e['d2h'] / 1e9:.3f} GB in {e['d2h_s']:.3f} s "
              f"({e['d2h'] / 1e9 / max(e['d2h_s'], 1e-9):.3f} GB/s); peak device memory "
              f"{e['peak'] / 2**30:.3f} GiB; launches: gather_rows {e['gather']} ("
              f"{e['batches_run']} batches + 2 x {e['sparse_evictions']} sparse evictions), "
              f"sparse_adagrad_update_ {e['adagrad']}, gather_sum {e['gather_sum']}  [{card}]",
              flush=True)
        if e["adagrad"] != e["batches_run"] or not e["adagrad"] or \
                e["gather"] != e["batches_run"] + 2 * e["sparse_evictions"] or \
                e["gather_sum"] != layers * e["batches_run"]:
            raise AssertionError(f"{tag} epoch {i}: launches do not match the batches: {e}")
    if len(losses) != epochs or not all(math.isfinite(x) for x in losses) \
            or not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{tag} losses are not finite and falling: {losses}")
    for res in out["evals"] + [out["test"]]:
        print(f"{tag} {res['split']} (epoch {res.get('epoch', epochs)}): MRR "
              f"{res['mrr']:.6f}  Hits@1 {res['hits@1']:.6f}  Hits@10 {res['hits@10']:.6f}  "
              f"over {int(res['num_evaluated'])} ranks  {res['eval_time_s']:.4f} s  [{card}]",
              flush=True)
        if not 0.0 < res["mrr"] <= 1.0:
            raise AssertionError(f"{tag}: MRR out of (0, 1]: {res}")
    evals = probe.evals
    print(f"{tag} evaluations (batches, gather launches, peak device GiB, gather_sum launches): "
          + ", ".join(f"({nb}, {g}, {peak / 2**30:.3f}, {gs})" for nb, g, peak, gs in evals),
          flush=True)
    out = {"gather_rows": {f"{tag} train": sum(e["gather"] for e in probe.epochs),
                           f"{tag} eval": sum(ev[1] for ev in evals)},
           "sparse_adagrad_update_": {f"{tag} train": sum(e["adagrad"] for e in probe.epochs)},
           "gather_sum": {}}
    if layers:
        out["gather_sum"] = {f"{tag} train": sum(e["gather_sum"] for e in probe.epochs),
                             f"{tag} eval": sum(ev[3] for ev in evals)}
    out["swaps"] = [(sum(t[1] for t in e["timings"]) / len(e["timings"]),
                     e["h2d"] / 1e9 / len(e["timings"]), e["d2h"] / 1e9 / len(e["timings"]))
                    for e in probe.epochs]
    return out


def lp_oocore_reload(card: str) -> dict:
    """freebase86m_comet.yaml at a named cut (1,000,000 nodes) through
    marius_train with the model saved, then marius_eval, which must
    reproduce the test metrics exactly."""
    from marius_tpu_torch.manager import marius_eval, marius_train

    with tempfile.TemporaryDirectory() as tmp:
        write_freebase_shaped(f"{tmp}/dataset", RELOAD_NODES, RELOAD_TRAIN_EDGES,
                              RELOAD_EVAL_EDGES)
        cfg = freebase_config(tmp, RELOAD_NODES, save_model=True, epochs=RELOAD_EPOCHS)
        print(f"lp_oocore_reload: freebase86m_comet.yaml with dataset_dir and model_dir "
              f"redirected; cuts: {RELOAD_NODES} nodes (published 86,054,151), "
              f"{RELOAD_TRAIN_EDGES} train and {RELOAD_EVAL_EDGES} valid and test edges, "
              f"num_epochs 10 -> {RELOAD_EPOCHS}", flush=True)
        with EpochProbe() as probe:
            out = marius_train(cfg)   # device=None: the GPU
            counts = report_oocore_epochs("lp_oocore_reload", out, probe, card, RELOAD_EPOCHS)
            again = marius_eval(cfg)
        if not Path(f"{tmp}/model/meta.yaml").exists():
            raise AssertionError("marius_train did not save the model")
    keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    if any(out["test"][k] != again["test"][k] for k in keys):
        raise AssertionError(f"marius_eval's test metrics {again['test']} differ from "
                             f"marius_train's {out['test']}")
    print("lp_oocore_reload: marius_eval reloaded the checkpoint and reproduced the test "
          "metrics exactly", flush=True)
    counts["gather_rows"]["lp_oocore_reload marius_eval"] = probe.evals[-1][1]
    return counts


def lp_oocore(card: str) -> dict:
    """freebase86m_comet.yaml at Freebase86m's shape through marius_train."""
    import shutil

    from marius_tpu_torch.manager import marius_train

    num_nodes = FB86M_NODES
    with tempfile.TemporaryDirectory() as tmp:
        mem = host_memory()
        disk = shutil.disk_usage(tmp)
        print(f"lp_oocore host: MemTotal {mem['MemTotal'] / 2**30:.2f} GiB, MemAvailable "
              f"{mem['MemAvailable'] / 2**30:.2f} GiB; free disk {disk.free / 2**30:.2f} GiB "
              f"under {tmp}", flush=True)
        # int32 rows of 3 columns, held about 4 times over (the loaded split, its bucket
        # grouping, the states in flight)
        edge_bytes = 4 * (OOC_TRAIN_EDGES + 2 * OOC_EVAL_EDGES) * 3 * 4

        def table_bytes(n):
            """The host table and its Adagrad state: 2 x padded rows x d x 4 bytes."""
            return 2 * FB86M_PARTITIONS * -(-n // FB86M_PARTITIONS) * FB86M_DIM * 4
        cut = ""
        if table_bytes(num_nodes) + edge_bytes + OOC_HOST_SPARE > mem["MemAvailable"]:
            room = mem["MemAvailable"] - edge_bytes - OOC_HOST_SPARE
            num_nodes = (room // (2 * FB86M_DIM * 4)) // 1_000_000 * 1_000_000
            cut = (f", nodes {FB86M_NODES} -> {num_nodes} (MemAvailable cannot hold the "
                   f"{table_bytes(FB86M_NODES) / 1e9:.1f} GB table and state with "
                   f"{OOC_HOST_SPARE / 2**30:.0f} GiB to spare)")
        t0 = time.perf_counter()
        write_freebase_shaped(f"{tmp}/dataset", num_nodes, OOC_TRAIN_EDGES, OOC_EVAL_EDGES)
        print(f"lp_oocore dataset: {num_nodes} nodes, {FB86M_RELS} relations, "
              f"{OOC_TRAIN_EDGES} train and {OOC_EVAL_EDGES} valid and test uniform edges "
              f"(seed 0), written in {time.perf_counter() - t0:.2f} s", flush=True)
        cfg = freebase_config(tmp, num_nodes, save_model=False)
        print(f"lp_oocore: freebase86m_comet.yaml with dataset_dir and model_dir redirected; "
              f"cuts: train edges 338,586,276 -> {OOC_TRAIN_EDGES}, valid and test "
              f"{OOC_EVAL_EDGES} each, num_epochs 10 -> {OOC_EPOCHS}, save_model off{cut}; "
              f"table {table_bytes(num_nodes) / 2e9:.2f} GB and Adagrad state as much in "
              f"host RAM", flush=True)
        torch.cuda.empty_cache()
        with EpochProbe() as probe:
            t0 = time.perf_counter()
            out = marius_train(cfg)   # device=None: the GPU
            total = time.perf_counter() - t0
        setup = probe.first_epoch_at - t0
        trainer = out["runtime"].trainer
        buf = trainer.buffer
        print(f"lp_oocore: marius_train {total:.2f} s, of which set-up before the first epoch "
              f"{setup:.2f} s (dataset load, host table init, partitioning); buffer "
              f"{buf.buffer_rows} x {buf.dim} rows ({2 * buf.buffer_rows * buf.dim * 4 / 1e9:.2f}"
              f" GB with its state), psize {buf.psize}; host RSS peak "
              f"{resource_peak_gib():.2f} GiB  [{card}]", flush=True)
        counts = report_oocore_epochs("lp_oocore", out, probe, card)
        del out, trainer, buf
    return counts


def resource_peak_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


# -- pinned accuracy bands (tests/test_accuracy_regression.py:40-147) ------------

def make_realizable_kg(n=500, d=8, r=10, per=4, seed=0):
    """Edges = top-``per`` DistMult scores per (node, relation) under a
    random ground-truth factorization."""
    rng = np.random.default_rng(seed)
    E = rng.normal(0, 1, (n, d))
    R = rng.normal(0, 1, (r, d))
    edges = []
    for rel in range(r):
        scores = (E * R[rel]) @ E.T
        np.fill_diagonal(scores, -np.inf)
        top = np.argsort(-scores, axis=1)[:, :per]
        for u in range(n):
            for v in top[u]:
                edges.append((u, rel, v))
    edges = np.array(edges, np.int32)
    rng.shuffle(edges)
    return edges


def make_complex_kg(n=500, d2=8, r=10, per=4, seed=0):
    """Edges = top-``per`` ComplEx scores per (node, relation) under a random
    complex ground-truth factorization."""
    rng = np.random.default_rng(seed)
    e_re, e_im = rng.normal(0, 1, (n, d2)), rng.normal(0, 1, (n, d2))
    r_re, r_im = rng.normal(0, 1, (r, d2)), rng.normal(0, 1, (r, d2))
    edges = []
    for rel in range(r):
        s_re = e_re * r_re[rel] - e_im * r_im[rel]
        s_im = e_re * r_im[rel] + e_im * r_re[rel]
        scores = s_re @ e_re.T + s_im @ e_im.T
        np.fill_diagonal(scores, -np.inf)
        top = np.argsort(-scores, 1)[:, :per]
        for u in range(n):
            for v in top[u]:
                edges.append((u, rel, v))
    edges = np.array(edges, np.int32)
    rng.shuffle(edges)
    return edges


def make_transe_kg(n=500, d=16, r=10, per=4, seed=1):
    """Edges = the ``per`` nearest neighbours of e_u + t_rel under L2."""
    rng = np.random.default_rng(seed)
    e = rng.normal(0, 1, (n, d))
    t = rng.normal(0, 0.3, (r, d))
    edges = []
    for rel in range(r):
        dist = np.linalg.norm((e[:, None, :] + t[rel]) - e[None, :, :], axis=2)
        np.fill_diagonal(dist, np.inf)
        top = np.argsort(dist, 1)[:, :per]
        for u in range(n):
            for v in top[u]:
                edges.append((u, rel, v))
    edges = np.array(edges, np.int32)
    rng.shuffle(edges)
    return edges


def run_lp_band(edges, decoder_type, dim, epochs=60, n=500, r=10, seed=0, device=None):
    """_run_lp of tests/test_accuracy_regression.py:129-147, on the card
    (``device=None``)."""
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import LINK_PREDICTION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig
    from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    tr, va = int(0.9 * len(edges)), int(0.95 * len(edges))
    train, test = edges[:tr], edges[va:]
    model = Model(LINK_PREDICTION,
                  EncoderConfig(((LayerConfig(layer_type="EMBEDDING", output_dim=dim),),)),
                  EdgeDecoder(decoder_type, num_relations=r, embedding_dim=dim),
                  loss_type="SOFTMAX_CE", loss_reduction="SUM",
                  dense_optimizer=OptimizerConfig("ADAGRAD", learning_rate=0.1), sparse_lr=0.1)
    neg = NegativeSamplingConfig(num_chunks=4, negatives_per_positive=128)
    trainer = LinkPredictionTrainer(model, n, r, train, neg, batch_size=500, seed=seed,
                                    device=device)
    for _ in range(epochs):
        trainer.train_epoch()
    ev = LinkPredictionEvaluator(model, n, r, test, all_edges=edges, batch_size=500,
                                 filtered=True, device=device)
    return ev.evaluate(trainer.state)


# (decoder, generator, dim, MRR band, Hits@10 floor): test_accuracy_regression.py:70-166
ACCURACY_BANDS = (("DISTMULT", make_realizable_kg, 32, (0.34, 0.45), 0.60),
                  ("COMPLEX", make_complex_kg, 32, (0.23, 0.35), 0.45),
                  ("TRANSE", make_transe_kg, 16, (0.15, 0.27), 0.28))


def lp_accuracy(card: str) -> None:
    for decoder, make, dim, (lo, hi), hits_floor in ACCURACY_BANDS:
        t0 = time.perf_counter()
        res = run_lp_band(make(), decoder, dim)
        print(f"lp_accuracy {decoder}: filtered MRR {res['mrr']:.6f} (band [{lo}, {hi}])  "
              f"Hits@10 {res['hits@10']:.6f} (floor {hits_floor})  60 epochs + evaluation "
              f"{time.perf_counter() - t0:.2f} s  [{card}]", flush=True)
        if not (lo <= res["mrr"] <= hi and res["hits@10"] >= hits_floor):
            raise AssertionError(f"{decoder} misses its pinned band: {res}")


# -- full-graph node classification -------------------------------------------

def arxiv_edges(num_nodes: int = ARXIV_NODES, num_edges: int = ARXIV_EDGES,
                hub: int = ARXIV_HUB) -> np.ndarray:
    """Arxiv-shaped citation graph, a copy of bench_nc_full.py:make_graph
    (:40-66): power-law in-degrees matched to ogbn-arxiv's (max 13,161, mean
    ~6.9), uniform sources. A smaller graph of the same shape takes smaller
    counts."""
    rng = np.random.default_rng(0)
    w = (np.arange(num_nodes) + 1.0) ** -0.78
    lo, hi = 0.5, 4.0
    for _ in range(40):  # bisect the scale so the clipped sum hits num_edges
        mid = (lo + hi) / 2
        s = np.minimum(np.round(w * (num_edges / w.sum()) * mid), hub).sum()
        lo, hi = (mid, hi) if s < num_edges else (lo, mid)
    deg = np.minimum(np.round(w * (num_edges / w.sum()) * lo), hub).astype(np.int64)
    short = num_edges - int(deg.sum())
    if short > 0:
        np.add.at(deg, rng.integers(0, num_nodes, short), 1)
    elif short < 0:
        deg[np.argsort(deg)[::-1][:-short]] -= 1
    if int(deg.sum()) != num_edges:
        raise AssertionError("the degree sequence does not sum to the edge count")
    dst = rng.permutation(num_nodes)[np.repeat(np.arange(num_nodes), deg)]
    src = rng.integers(0, num_nodes, num_edges)
    return np.stack([src, dst], 1).astype(np.int32)


def nc_data(seed: int, edges: np.ndarray, num_nodes: int, feat_dim: int, classes: int,
            num_train: int):
    """Features, labels (a random linear function of the features, so
    training can fit them) and train nodes, from ``seed``."""
    rng = np.random.default_rng(seed)
    features = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)
    labels = np.argmax(features @ rng.standard_normal((feat_dim, classes)), 1).astype(np.int32)
    train_nodes = rng.permutation(num_nodes)[:num_train].astype(np.int32)
    return edges, features, labels, train_nodes


def nc_model(feat_dim: int, dims):
    """FEATURE (bias) + GraphSAGE MEAN stages with bias and no activation,
    CE SUM, Adam lr 0.01 (examples/configuration/ogbn_arxiv.yaml)."""
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    stages = [(LayerConfig("FEATURE", output_dim=feat_dim, bias=True),)]
    for din, dout in zip((feat_dim,) + tuple(dims[:-1]), dims):
        stages.append((LayerConfig("GNN", input_dim=din, output_dim=dout,
                                   gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True),))
    return Model(NODE_CLASSIFICATION, EncoderConfig(tuple(stages)), None,
                 loss_type="CROSS_ENTROPY", loss_reduction="SUM",
                 dense_optimizer=OptimizerConfig("ADAM", learning_rate=NC_LR))


def check_gather_sum(adj, rates):
    """The gather-sum kernel against its plain version on the arxiv
    adjacency's real buckets (every width the NC paths use, forward and
    backward, f32 and bf16), on single buckets of odd shapes up to a 13k-slot
    hub at those widths and at the slab edges, with x 16-byte aligned and
    not, and on one layout with empty and all-padding buckets; then one
    whole neighbour sum at d=128, timed."""
    from marius_tpu_torch.data.full_graph import make_nbr_sums, nbr_sum_layout
    from marius_tpu_torch.ops.cuda import nbr_sum as ns

    dev, n = adj.device, adj.num_nodes
    g = torch.Generator(device=dev).manual_seed(3)
    layout = nbr_sum_layout(adj)

    def same(a, b, what):
        torch.cuda.synchronize()
        if a.shape != b.shape or not torch.equal(a, b):
            err = float((a - b).abs().max()) if a.shape == b.shape else float("nan")
            raise AssertionError(f"gather-sum differs from plain ({what}): {err}")

    for d in SUM_DIMS:
        x = torch.randn(n, d, device=dev, generator=g)
        same(ns.nbr_sum(x, layout), ns.nbr_sum_plain(x, layout), f"arxiv buckets, d={d}")
    x = torch.randn(n, NC_DIM, device=dev, generator=g).requires_grad_(True)
    u = torch.randn(n, NC_DIM, device=dev, generator=g)
    make_nbr_sums(adj)(x).backward(u)
    same(x.grad, ns.nbr_sum_plain(u, layout), "arxiv buckets, backward")
    xb = x.detach().to(torch.bfloat16)
    same(ns.nbr_sum(xb, layout), ns.nbr_sum_plain(xb, layout), "arxiv buckets, bf16")
    pad = lambda rows, cap: torch.full((rows, cap), 5000, dtype=torch.int32, device=dev)
    for d in sorted(SUM_DIMS + SLAB_EDGE_DIMS):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(5000, d, device=dev, generator=g).to(dtype)
            # the same values one element past a 16-byte boundary: one-element loads
            x_off = torch.empty(5000 * d + 1, device=dev, dtype=dtype)[1:].view(5000, d)
            x_off.copy_(x)
            buckets = []
            for rows, cap in SUM_SHAPES:
                ids = torch.randint(0, 5001, (rows, cap), device=dev, generator=g,
                                    dtype=torch.int32)   # 5000 = padding id
                buckets.append(ids)
                ref = ns.gather_sum_plain(x, ids)
                for xs, where in ((x, "aligned"), (x_off, "offset")):
                    same(ns.gather_sum(xs, ids), ref,
                         f"one bucket ({rows}, {cap}), d={d}, {dtype}, {where}")
            mixed = [buckets[1], pad(0, 9), pad(7, 5), buckets[4], pad(6, 300), buckets[-1],
                     pad(0, 400)]
            rows = sum(b.shape[0] for b in mixed)
            mixed_layout = ns.bucket_layout(
                mixed, torch.randperm(rows, device=dev, generator=g), rows)
            same(ns.nbr_sum(x, mixed_layout), ns.nbr_sum_plain(x, mixed_layout),
                 f"empty and all-padding buckets, d={d}, {dtype}")

    x = torch.randn(n, NC_DIM, device=dev, generator=g)
    out = ns.nbr_sum(x, layout)
    err = float((out - ns.nbr_sum_plain(x, layout)).abs().max())
    if err != 0.0:
        raise AssertionError(f"gather-sum differs from plain by {err}")
    a = layout_matrix(layout, n)

    def library():
        return torch.sparse.mm(a, x)

    # cuSPARSE sums in another order: 1e-3 absolute on sums of up to 13k unit normals
    torch.testing.assert_close(library(), out, rtol=1e-4, atol=1e-3)
    valid = layout.ids[(layout.ids >= 0) & (layout.ids < n)]
    rows_read = int(torch.unique(valid).numel())
    tasks, folds = layout.task_start.numel(), layout.fold_first.numel()
    nbytes = (rows_read * NC_DIM * 4 + layout.ids.numel() * 4 + tasks * 16 + folds * 12
              + n * NC_DIM * 4)
    b_ms, b_by = bound_ms(nbytes, (valid.numel() + layout.num_partials) * NC_DIM, rates)
    print(f"gather-sum at arxiv shape: {len(adj.nbrs)} buckets, {layout.ids.numel()} slots "
          f"({valid.numel()} real), {tasks} tasks, {folds} hub rows in "
          f"{layout.num_partials} pieces, {rows_read} distinct rows read; "
          f"sparse matrix {a._nnz()} nonzeros", flush=True)
    ms = time_ms(lambda: ns.nbr_sum(x, layout))
    # what the slot reads alone ask of the memory system: one d-wide row per real slot
    slot_rate = valid.numel() * NC_DIM * 4 / (ms * 1e-3)
    print(f"gather-sum slot reads: {valid.numel() * NC_DIM * 4 / 1e9:.4f} GB in {ms * 1e3:.2f} us"
          f" = {slot_rate / 1e12:.3f} TB/s", flush=True)
    return {
        "name": "gather_sum", "route": "cuda", "source": "marius_tpu_torch/csrc/nbr_sum.cu",
        "replaces": "marius_tpu/ops/pallas/nbr_sum.py:114", "max_abs_err": err,
        "ms": ms,
        "plain_ms": time_ms(lambda: ns.nbr_sum_plain(x, layout), reps=2, samples=3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library, reps=10, samples=5),
        "slot_read_bytes_per_s": slot_rate,
    }


def _report_epochs(tag: str, results, card: str) -> None:
    for i, r in enumerate(results):
        kind = "warm-up" if i == 0 else "timed"
        print(f"{tag} epoch {i} ({kind}): loss {r['loss']:.6f}  {r['epoch_time_s']:.4f} s  "
              f"{r['nodes_per_sec']:.1f} nodes/s  [{card}]", flush=True)
    losses = [r["loss"] for r in results]
    if not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{tag} losses are not finite and decreasing: {losses}")
    timed = results[1:]
    nps = sum(r["num_nodes"] for r in timed) / sum(r["epoch_time_s"] for r in timed)
    print(f"{tag} timed epochs: {nps:.1f} nodes/s over {len(timed)} epochs  [{card}]",
          flush=True)


def train_nc(card: str, adj, data) -> dict:
    """Arxiv-shaped full-graph NC through the port's entry points: the
    collapse trainer, then the general trainer and its evaluation. Each part
    runs with the gather-sum counter set to 0 just before it and read just
    after, and each reading is checked against what the code implies.
    Returns {part: gather-sum launches}."""
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer

    edges, features, labels, train_nodes = data
    graph = build_device_graph(edges, ARXIV_NODES)
    model = nc_model(ARXIV_FEATS, (NC_DIM, NC_DIM, ARXIV_CLASSES))
    epochs = 3   # one warm-up, two timed
    # every call on the arxiv adjacency folds hub pieces on-chip
    if max(b.shape[1] for b in adj.nbrs) <= ns.MAX_CAP:
        raise AssertionError("the arxiv-shaped adjacency must have hub rows")
    counts = {}

    def part(name, expected, fn):
        ns.launches = 0
        out = fn()
        counts[name] = ns.launches
        if counts[name] != expected:
            raise AssertionError(f"nc {name}: gather-sum launched {counts[name]} times, "
                                 f"expected {expected}")
        return out

    def build(**kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = NodeClassificationTrainer(model, graph, features, labels, train_nodes,
                                            batch_size=BATCH, seed=0, full_graph=adj, **kwargs)
        torch.cuda.synchronize()
        return trainer, time.perf_counter() - t0

    # the collapse: one neighbour sum per GNN stage at setup, none per batch
    collapse, setup_s = part("collapse setup", NC_GNN_STAGES, build)
    if collapse.device.type != "cuda" or collapse._fg_collapse is None:
        raise AssertionError("the arxiv model must train on the GPU through the collapse")
    phi = collapse._fg_collapse.phi
    print(f"nc collapse setup: {setup_s:.4f} s (phi {tuple(phi.shape)}, "
          f"{phi.numel() * 4 / 1e9:.3f} GB)  [{card}]", flush=True)
    col_res = part("collapse epochs", 0, lambda: collapse.train(epochs))
    _report_epochs("nc collapse", col_res, card)
    del collapse, phi

    # the general path: the first stage's constant input summed once at
    # setup; each batch runs the middle stages forward and backward (the
    # first is the constant, the last seed-restricted); evaluation runs
    # stages 2.. forward
    general, setup_s = part("general setup", 1, lambda: build(fg_linear_collapse=False))
    if general._fg_collapse is not None or not general._fg_seed_restrict:
        raise AssertionError("fg_linear_collapse=False must take the seed-restricted path")
    print(f"nc general setup: {setup_s:.4f} s  [{card}]", flush=True)
    gen_res = part("general epochs", epochs * general.num_batches * 2 * (NC_GNN_STAGES - 2),
                   lambda: general.train(epochs))
    _report_epochs("nc general", gen_res, card)
    # the collapse is exact up to float associativity: the same first epoch
    rel = abs(col_res[0]["loss"] - gen_res[0]["loss"]) / abs(gen_res[0]["loss"])
    print(f"nc first-epoch loss, collapse against general: relative difference {rel:.3g} "
          f"(tolerance 1e-3)", flush=True)
    if rel > 1e-3:
        raise AssertionError("the collapse and the general path disagree")

    eval_nodes = np.setdiff1d(np.arange(ARXIV_NODES), train_nodes)
    evaluator = NodeClassificationEvaluator(general, eval_nodes)
    res = part("evaluation", NC_GNN_STAGES - 1, lambda: evaluator.evaluate(general.state))
    if res["num_evaluated"] != len(eval_nodes) or not 1.0 / ARXIV_CLASSES < res["accuracy"] <= 1:
        raise AssertionError(f"evaluation is not above chance over the eval nodes: {res}")
    print(f"nc general evaluation: accuracy {res['accuracy']:.6f} over "
          f"{int(res['num_evaluated'])} non-train nodes (chance {1 / ARXIV_CLASSES})", flush=True)
    print("nc gather-sum launches per part: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()) + f"; {general.num_batches} batches per epoch",
        flush=True)
    return counts


def compare_nc_with_cpu():
    """A small NC run on the card against the same run on the CPU (plain
    gather-sum), on both paths."""
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    n, e, f = 300, 3000, 16
    rng = np.random.default_rng(5)
    w = (np.arange(n) + 1.0) ** -1.0    # Zipf destinations: hub rows wider than 256 slots
    edges = np.stack([rng.integers(0, n, e), rng.choice(n, e, p=w / w.sum())], 1)
    _, features, labels, train_nodes = nc_data(6, edges, n, f, 5, 200)
    adj = build_full_graph_adjacency(edges, n)
    if max(b.shape[1] for b in adj.nbrs) <= 256:
        raise AssertionError("the small graph must have hub rows")
    graph = build_device_graph(edges, n)
    model = nc_model(f, (16, 16, 5))
    worst = 0.0
    for collapse in (True, False):
        cpu, gpu = [NodeClassificationTrainer(model, graph, features, labels, train_nodes,
                                              batch_size=50, seed=1, full_graph=adj,
                                              fg_linear_collapse=collapse, device=dev)
                    for dev in ("cpu", "cuda")]
        gpu._epoch_permutation = lambda s, _c=cpu, _g=gpu: _c._epoch_permutation(s).to(_g.device)
        for _ in range(2):
            lc, lg = cpu.train_epoch()["loss"], gpu.train_epoch()["loss"]
            if not math.isclose(lc, lg, rel_tol=1e-4):
                raise AssertionError(f"NC loss on the card {lg} != on the CPU {lc}")
        for a, b in zip(tree_leaves([cpu.state.params, cpu.state.opt_state.slots]),
                        tree_leaves([gpu.state.params, gpu.state.opt_state.slots])):
            b = b.detach().cpu()
            worst = max(worst, float((a.detach() - b).abs().max()))
            torch.testing.assert_close(b, a.detach(), rtol=1e-4, atol=1e-5)
    print(f"small NC run, card against CPU (collapse and general, 2 epochs): "
          f"max abs difference {worst:.3g} (tolerance rtol 1e-4, atol 1e-5)", flush=True)

    # full-graph GAT (dropout masks from one CPU generator on both devices) and RGCN
    # over 3 relations, seed-restricted, through the slice's kernel consumers
    from marius_tpu_torch.nn.layers import DropoutKey
    rels = np.random.default_rng(7).integers(0, 3, len(edges))
    edges3 = np.stack([edges[:, 0], rels, edges[:, 1]], 1).astype(np.int32)
    worst = 0.0
    for gnn in ("GAT", "RGCN"):
        adj_g = build_full_graph_adjacency(edges3, n, with_relations=gnn == "RGCN")
        model = small_gnn_model(gnn, f, 3)
        graph3 = build_device_graph(edges3, n, 3)
        cpu, gpu = [NodeClassificationTrainer(model, graph3, features, labels, train_nodes,
                                              batch_size=50, seed=1, full_graph=adj_g,
                                              device=dev) for dev in ("cpu", "cuda")]
        if not gpu._fg_seed_restrict:
            raise AssertionError(f"full-graph {gnn} must take the seed-restricted path")
        keys = DropoutKey(torch.Generator().manual_seed(1))
        gpu._dropout_key = lambda _k=keys: _k
        gpu._epoch_permutation = lambda s, _c=cpu, _g=gpu: _c._epoch_permutation(s).to(_g.device)
        for _ in range(2):
            lc, lg = cpu.train_epoch()["loss"], gpu.train_epoch()["loss"]
            if not math.isclose(lc, lg, rel_tol=1e-4):
                raise AssertionError(f"full-graph {gnn} loss on the card {lg} != on the CPU {lc}")
        for a, b in zip(tree_leaves([cpu.state.params, cpu.state.opt_state.slots]),
                        tree_leaves([gpu.state.params, gpu.state.opt_state.slots])):
            b = b.detach().cpu()
            worst = max(worst, float((a.detach() - b).abs().max()))
            torch.testing.assert_close(b, a.detach(), rtol=1e-4, atol=1e-5)
    print(f"small full-graph GAT (8 heads, input and attention dropout) and RGCN (3 "
          f"relations) NC runs, card against CPU, seed-restricted, 2 epochs: max abs "
          f"difference {worst:.3g} (tolerance rtol 1e-4, atol 1e-5)", flush=True)


def small_gnn_model(gnn_type: str, f: int, rels: int):
    """FEATURE (bias), then two GNN layers with bias (RELU between): GAT with
    8 averaged heads, input dropout 0.1 and attention dropout 0.2, or RGCN
    over ``rels`` relations; 5 classes, CE SUM, Adam lr 0.01."""
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    kw = (dict(gnn_type="GAT", num_heads=8, input_dropout=0.1, attention_dropout=0.2)
          if gnn_type == "GAT" else dict(gnn_type="RGCN", num_relations=rels))
    return Model(NODE_CLASSIFICATION, EncoderConfig((
        (LayerConfig("FEATURE", output_dim=f, bias=True),),
        (LayerConfig("GNN", input_dim=f, output_dim=16, bias=True, activation="RELU", **kw),),
        (LayerConfig("GNN", input_dim=16, output_dim=5, bias=True, **kw),))), None,
        loss_type="CROSS_ENTROPY", loss_reduction="SUM",
        dense_optimizer=OptimizerConfig("ADAM", learning_rate=NC_LR))


# -- sampled node classification through the manager ----------------------------

def write_arxiv_shaped(directory: str, data) -> None:
    """The arxiv-shaped graph, features and labels with ogbn-arxiv's published
    split sizes (90,941 / 29,799 / 48,603 nodes), in the dataset layout of
    storage/dataset.py."""
    from marius_tpu_torch.storage.dataset import (
        DatasetStats,
        save_node_array,
        save_split,
        save_stats,
    )

    edges, features, labels, train_nodes = data
    rest = np.random.default_rng(1).permutation(np.setdiff1d(np.arange(ARXIV_NODES),
                                                             train_nodes)).astype(np.int32)
    save_split(directory, "train", edges)
    save_node_array(directory, "features", features)
    save_node_array(directory, "labels", labels)
    for name, part in (("train_nodes", train_nodes), ("valid_nodes", rest[:ARXIV_VALID]),
                       ("test_nodes", rest[ARXIV_VALID:])):
        save_node_array(directory, name, part)
    save_stats(directory, DatasetStats(
        num_nodes=ARXIV_NODES, num_edges=ARXIV_EDGES, num_relations=1, num_edge_cols=2,
        num_train=ARXIV_TRAIN, num_valid=ARXIV_VALID, num_test=len(rest) - ARXIV_VALID,
        num_classes=ARXIV_CLASSES, feature_dim=ARXIV_FEATS))


def nc_sampled(card: str, data, tag: str = "nc_sampled", edit=None,
               epochs: int = NC_SAMPLED_EPOCHS) -> dict:
    """ogbn_arxiv.yaml (sampled GraphSAGE, UNIFORM 32 in and out per hop, hop
    caps [1000, 16384, 65536, 169344]) through marius_train and marius_eval on
    the card. Training and each evaluation are counted apart: the row gather
    once per batch (the outer hop's feature rows), the gather-sum three times
    per batch (one per GNN layer), Adagrad never (no EMBEDDING stage).
    ``edit(raw)`` changes the loaded YAML and returns what it changed.
    Returns the launches per part, the test metrics and the trainer."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.ops.cuda import sampler as sampler_kernels
    from marius_tpu_torch.train import nc as nc_mod

    config = Path(__file__).resolve().parent / "examples" / "configuration" / "ogbn_arxiv.yaml"
    with open(config) as f:
        raw = yaml.safe_load(f)
    evals = []    # (batches, gather_rows launches, gather_sum launches) per evaluation
    evaluate = nc_mod.NodeClassificationEvaluator.evaluate

    def counted(self, state):
        before = (gather.launches, ns.launches)
        res = evaluate(self, state)
        evals.append((self.num_batches, gather.launches - before[0], ns.launches - before[1]))
        return res

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_arxiv_shaped(f"{tmp}/dataset", data)
        raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
        epochs_in_yaml = raw["training"]["num_epochs"]
        raw["training"]["num_epochs"] = epochs
        changed = "" if edit is None else f"; {edit(raw)}"
        cfg = load_config(raw, model_dir=f"{tmp}/model")
        print(f"{tag}: {config.relative_to(config.parents[2])} with dataset_dir and "
              f"model_dir redirected{changed}; one cut: num_epochs {epochs_in_yaml} -> "
              f"{epochs}; dataset written in {time.perf_counter() - t0:.2f} s", flush=True)
        nc_mod.NodeClassificationEvaluator.evaluate = counted
        try:
            torch.cuda.reset_peak_memory_stats()
            gather.launches = ns.launches = adagrad.launches = sampler_kernels.launches = 0
            out = marius_train(cfg)   # device=None: the GPU
            totals = (gather.launches, ns.launches, adagrad.launches)
            hops = sampler_kernels.launches
            peak = torch.cuda.max_memory_allocated()
            train_evals = list(evals)
            gather.launches = ns.launches = adagrad.launches = 0
            again = marius_eval(cfg)
            reload_totals = (gather.launches, ns.launches, adagrad.launches)
        finally:
            nc_mod.NodeClassificationEvaluator.evaluate = evaluate

    rt = out["runtime"]
    trainer = rt.trainer
    if trainer.device.type != "cuda" or trainer.full_graph is not None:
        raise AssertionError("ogbn_arxiv.yaml must train on the GPU through the sampled trainer")
    if trainer.hop_caps != tuple(raw["model"]["encoder"]["hop_caps"]):
        raise AssertionError(f"hop caps {trainer.hop_caps} are not the YAML's")
    losses = [e["loss"] for e in out["epochs"]]
    for i, (e, v) in enumerate(zip(out["epochs"], out["evals"])):
        print(f"{tag} epoch {i}: loss {e['loss']:.6f}  {e['epoch_time_s']:.4f} s  "
              f"{e['nodes_per_sec']:.1f} nodes/s  truncated frontier ids "
              f"{e['truncated_frontier_ids']}  valid accuracy {v['accuracy']:.6f}  [{card}]",
              flush=True)
        if not v["accuracy"] > 1.0 / ARXIV_CLASSES:
            raise AssertionError(f"valid accuracy is not above chance: {v}")
    if len(losses) != epochs or not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{tag} losses are not finite and falling: {losses}")
    timed = out["epochs"][1:]
    nps = sum(e["num_nodes"] for e in timed) / sum(e["epoch_time_s"] for e in timed)
    test, reloaded = out["test"], again["test"]
    print(f"{tag} timed epochs: {nps:.1f} train nodes/s over {len(timed)} epochs; test "
          f"accuracy {test['accuracy']:.6f} over {int(test['num_evaluated'])} nodes (chance "
          f"{1 / ARXIV_CLASSES}); peak device memory {peak / 2**30:.3f} GiB  [{card}]",
          flush=True)
    if not test["accuracy"] > 1.0 / ARXIV_CLASSES or test["num_evaluated"] != ARXIV_NODES - \
            ARXIV_TRAIN - ARXIV_VALID:
        raise AssertionError(f"test evaluation is wrong or not above chance: {test}")
    if any(test[k] != reloaded[k] for k in ("accuracy", "num_evaluated")):
        raise AssertionError(f"marius_eval's test metrics {reloaded} differ from "
                             f"marius_train's {test}")
    print(f"{tag}: marius_eval reloaded the checkpoint and reproduced the test metrics "
          "exactly", flush=True)

    train_batches = epochs * trainer.num_batches
    eval_batches = sum(b for b, _, _ in train_evals)
    train_rows, train_sums = totals[0] - sum(g for _, g, _ in train_evals), \
        totals[1] - sum(s for _, _, s in train_evals)
    if (train_rows, train_sums, totals[2]) != (train_batches, 3 * train_batches, 0):
        raise AssertionError(f"{tag} training launched gather_rows {train_rows}, "
                             f"gather_sum {train_sums} and Adagrad {totals[2]} times for "
                             f"{train_batches} batches (expected 1, 3 and 0 per batch)")
    for batches, g, s in evals:
        if (g, s) != (batches, 3 * batches):
            raise AssertionError(f"an evaluation of {batches} batches launched gather_rows {g} "
                                 f"and gather_sum {s} times (expected 1 and 3 per batch)")
    if reload_totals[2] != 0 or len(evals) != len(train_evals) + 1:
        raise AssertionError("marius_eval must evaluate once, without Adagrad")
    if hops < train_batches:
        raise AssertionError(f"the sampler's kernels launched {hops} times for {train_batches} "
                             "training batches")
    rows = {f"{tag} train": train_rows, f"{tag} eval": eval_batches,
            f"{tag} marius_eval": reload_totals[0]}
    sums = {f"{tag} train": train_sums, f"{tag} eval": 3 * eval_batches,
            f"{tag} marius_eval": reload_totals[1]}
    print(f"{tag} launches: gather_rows {rows}, gather_sum {sums}, Adagrad 0, the sampler's "
          f"hop kernels {hops} in marius_train "
          f"({trainer.num_batches} train batches per epoch, {len(train_evals)} valid "
          f"evaluations of {train_evals[0][0]} batches, test {evals[-1][0]} batches)", flush=True)
    return {"gather_rows": rows, "gather_sum": sums, "trainer": trainer, "test": test,
            "sparse_adagrad_update_": {f"{tag} train": totals[2],
                                       f"{tag} marius_eval": reload_totals[2]}}


def sampled_shapes(trainer, rates, card) -> dict:
    """The row gather and the gather-sum at the sampled path's shapes, on one
    real training batch of the nc_sampled trainer: the outer hop's feature
    gather (K = 169,344 ids into the (N + 1) x 128 table, the saturated hop:
    every row) and the first GNN layer's neighbour sum (65,536 targets x 64
    slots over that hop's 169,344 rows), each bit for bit against its plain
    version and timed beside its bound and its one-call PyTorch equivalent
    (index_select; embedding_bag with the padding row excluded), and the
    neighbour sum's backward (index_add_) for the record."""
    from marius_tpu_torch.data.samplers.neighbor import sample_neighbor_batch
    from marius_tpu_torch.ops.cuda import gather

    dev = trainer.device
    b = trainer.batch_size
    nb = sample_neighbor_batch(trainer._batch_draws(), trainer.graph, trainer.train_nodes[:b],
                               torch.ones(b, dtype=torch.bool, device=dev), trainer.nbr_configs,
                               trainer.hop_caps)
    outer = nb.node_ids[0]
    err = gather_max_err(gather, trainer.features, outer)
    rows = time_gather(gather, trainer.features, [outer], rates)
    rows["max_abs_err"] = err
    print(f"gather_rows, sampled_nc_outer (K={rows['k']}, d={rows['d']}, "
          f"{rows['distinct_rows']:.1f} distinct rows, {rows['bound_bytes'] / 1e6:.4f} MB): "
          f"max_abs_err {err}  kernel {rows['ms'] * 1e3:.2f} us  plain "
          f"{rows['plain_ms'] * 1e3:.2f} us  index_select {rows['library_ms'] * 1e3:.2f} us  "
          f"bound {rows['bound_ms'] * 1e3:.2f} us ({rows['bound_by']})  [{card}]", flush=True)

    sums = time_layer_sum(nb.layers[0], outer.shape[0], NC_DIM, rates, dev)
    print(f"gather_sum, sampled layer 0 ({sums['targets']} targets x {sums['width']} slots, "
          f"{sums['valid_slots']} real, {sums['distinct_rows']} distinct rows of "
          f"{outer.shape[0]}, d={NC_DIM}, {sums['bound_bytes'] / 1e6:.4f} MB): "
          f"max_abs_err {sums['max_abs_err']}  "
          f"kernel {sums['ms'] * 1e3:.2f} us (with the layout built: "
          f"{sums['with_layout_ms'] * 1e3:.2f} us)  plain {sums['plain_ms'] * 1e3:.2f} us  "
          f"embedding_bag {sums['library_ms'] * 1e3:.2f} us  bound {sums['bound_ms'] * 1e3:.2f} "
          f"us ({sums['bound_by']})  backward (index_add_) "
          f"{sums['backward_index_add_ms'] * 1e3:.2f} us  [{card}]", flush=True)
    return {"gather_rows": rows, "gather_sum": sums}


def time_layer_sum(adj, n_x: int, d: int, rates, dev, dtype=torch.float32) -> dict:
    """One sampled layer's neighbour sum (its in and out slots side by side
    over ``n_x`` rows of width ``d``) through the gather-sum kernel, bit for
    bit against the plain version, timed beside its bound, embedding_bag
    (the padding row excluded) and the index_add_ backward. ``ms`` is the
    kernel on the call's layout; ``with_layout_ms`` the whole ``gather_sum``
    call as a sampled layer makes it, the layout built from the slot ids
    first (small device ops whose launches the host issues one by one)."""
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.ops.segment import sampled_nbr_sum

    n = adj.self_idx.shape[0]
    ids = torch.cat([torch.where(adj.in_mask, adj.in_nbr_idx, n_x),
                     torch.where(adj.out_mask, adj.out_nbr_idx, n_x)], 1).int().contiguous()
    x = torch.randn(n_x, d, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9)).to(dtype)
    layout = ns._single_bucket(ids)
    out, ref = ns.nbr_sum(x, layout), ns.gather_sum_plain(x, ids)
    torch.cuda.synchronize()
    if not (torch.equal(out, ref) and torch.equal(ns.gather_sum(x, ids), out)):
        raise AssertionError(f"gather_sum differs from plain at {n} x {ids.shape[1]} slots, d={d}")
    err = float((out - ref).abs().max())
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    ids64 = ids.long()

    def library():
        return torch.nn.functional.embedding_bag(ids64, x_pad, mode="sum", padding_idx=n_x)

    # embedding_bag sums in another order: sums of up to 64 unit normals (in bf16, its
    # output rounded to bf16: 2^-7 of the largest sum)
    lib_ms = library_or_none(library, "embedding_bag", dtype, reps=10, samples=5)
    if lib_ms is not None:
        tol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 2 ** -7 * 40)
        torch.testing.assert_close(library().float(), out, rtol=tol[0], atol=tol[1])
    valid = ids[ids < n_x]
    rows_read = int(torch.unique(valid).numel())
    # distinct rows read once in x's type, the ids, the f32 sums written once
    nbytes = rows_read * d * x.element_size() + ids.numel() * 4 + n * d * 4
    b_ms, b_by = bound_ms(nbytes, valid.numel() * d, rates)
    xg = x.clone().requires_grad_(True)
    y = sampled_nbr_sum(xg, adj.in_nbr_idx, adj.in_mask, adj.out_nbr_idx, adj.out_mask)
    gy = torch.randn_like(y)
    return {"targets": n, "width": ids.shape[1], "slots": ids.numel(),
            "valid_slots": int(valid.numel()), "distinct_rows": rows_read, "max_abs_err": err,
            "ms": time_ms(lambda: ns.nbr_sum(x, layout)),
            "with_layout_ms": time_ms(lambda: ns.gather_sum(x, ids)),
            "plain_ms": time_ms(lambda: ns.gather_sum_plain(x, ids), reps=2, samples=3),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "library_ms": lib_ms,
            "backward_index_add_ms": time_ms(
                lambda: torch.autograd.grad(y, xg, gy, retain_graph=True), reps=5, samples=5)}


# The neighbour sampler's kernels (sampler_shapes) against its plain version:
# name -> (what it exercises, graph, seeds (count, padded, masked real ones),
# frontier id dtype, configs outermost first as (kind, fanout, rate, in, out),
# hop caps innermost first)
SAMPLER_CASES = {
    "nc_cell": ("arxiv_sage.sampled's batch", "arxiv", (1000, 0, 0), torch.int64,
                [("UNIFORM", 32, 0.0, True, True)] * 3, (1000, 16384, 65536, ARXIV_NODES + 1)),
    "tight_cap": ("caps below the hops' ids: overflow", "arxiv", (1000, 0, 0), torch.int64,
                  [("UNIFORM", 32, 0.0, True, True)] * 2, (1000, 8192, 16384)),
    "padded_seeds": ("300 padding seeds and 100 masked real ones: holes in the frontier",
                     "arxiv", (1000, 300, 100), torch.int64,
                     [("UNIFORM", 32, 0.0, True, True)] * 3,
                     (1000, 16384, 65536, ARXIV_NODES + 1)),
    "dropout": ("DROPOUT 16 at rate 0.7, every 7th uniform at float32(0.7)", "arxiv",
                (1000, 0, 0), torch.int64, [("DROPOUT", 16, 0.7, True, True)] * 2,
                (1000, 8192, 65536)),
    "all_rels": ("ALL 64 over 8 relations (RGCN's inputs)", "arxiv_rels", (1000, 0, 0),
                 torch.int64, [("ALL", 64, 0.0, True, True)] * 2,
                 (1000, 65536, ARXIV_NODES + 1)),
    "one_direction": ("outgoing only, then incoming only; int32 seeds", "arxiv", (1000, 50, 0),
                      torch.int32, [("UNIFORM", 20, 0.0, True, False),
                                    ("UNIFORM", 20, 0.0, False, True)], (1000, 16384, 65536)),
    "lp_gs1": ("fb15k237_gs1's hop: 12,000 unique ids, saturated, UNIFORM 10", "fb15k",
               (12000, 0, 0), torch.int64, [("UNIFORM", 10, 0.0, True, True)],
               (12000, NUM_NODES + 1)),
    "sorted": ("caps below the frontier: the sorted branch (sort)", "arxiv", (2000, 0, 0),
               torch.int64, [("UNIFORM", 8, 0.0, True, True)] * 2, (2000, 1500, 1200)),
    "sorted_bitmap": ("caps below the frontier: the sorted branch (bitmap)", "arxiv",
                      (20000, 0, 0), torch.int64, [("UNIFORM", 8, 0.0, True, True)],
                      (20000, 15000)),
}
SAMPLER_DROPOUT_STEP = 7


def sampler_graphs(dev) -> dict:
    """The graphs of SAMPLER_CASES on ``dev``: chip_smoke's arxiv-shaped
    graph, the same with 8 relations, and FB15K-237's shape (uniform edges,
    237 relations)."""
    from marius_tpu_torch.data.graph import build_device_graph

    e = arxiv_edges()
    rels = np.random.default_rng(1).integers(0, 8, len(e)).astype(np.int32)
    return {"arxiv": (build_device_graph(e, ARXIV_NODES, device=dev), ARXIV_NODES),
            "arxiv_rels": (build_device_graph(np.stack([e[:, 0], rels, e[:, 1]], 1),
                                              ARXIV_NODES, 8, device=dev), ARXIV_NODES),
            "fb15k": (build_device_graph(synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES),
                                         NUM_NODES, NUM_RELS, device=dev), NUM_NODES)}


def sampler_case(name: str, graphs: dict, seed: int = 0):
    """(graph, seeds, seed mask, configs, hop caps, draws) of SAMPLER_CASES[name]
    on the graphs' device. Seeds are distinct, padded with num_nodes where
    masked off (LP's are sorted, as unique_padded gives them); the draws come
    from a generator seeded with ``seed`` on that device."""
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig, generator_draws

    _, gname, (b, padded, masked), dtype, spec, caps = SAMPLER_CASES[name]
    graph, n = graphs[gname]
    dev = graph.in_offsets.device
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)[:b]
    if name == "lp_gs1":
        ids = np.sort(rng.permutation(n)[:b - 500])
        ids = np.concatenate([ids, np.full(500, n)])
    mask = np.ones(b, bool)
    mask[b - padded:] = False
    ids[b - padded:] = n
    mask[rng.choice(b - padded, masked, replace=False)] = False
    mask &= ids < n
    draws = generator_draws(torch.Generator(device=dev).manual_seed(seed))
    rate = spec[0][2]

    def boundary_draws(depth, direction, count, fanout, dropout):
        rand, uni = draws(depth, direction, count, fanout, dropout)
        if uni is not None:
            uni.view(-1)[::SAMPLER_DROPOUT_STEP] = float(np.float32(rate))
        return rand, uni

    return (graph, torch.as_tensor(ids, dtype=dtype, device=dev),
            torch.as_tensor(mask, device=dev), [NeighborSamplingConfig(*s) for s in spec],
            caps, boundary_draws if spec[0][0] == "DROPOUT" else draws)


def recorded_draws(draws):
    """(recording draws, replaying draws): the second hands back, in turn and
    round again, what the first returned."""
    calls = []
    turn = [0]

    def record(*a):
        calls.append(draws(*a))
        return calls[-1]

    def replay(*a):
        out = calls[turn[0] % len(calls)]
        turn[0] += 1
        return out

    return record, replay


def batch_mismatch(a, b) -> list:
    """The fields of two NeighborBatches that differ in presence, dtype, shape
    or any element."""
    bad = []

    def same(what, x, y):
        if (x is None) != (y is None):
            bad.append(f"{what}: None against a tensor")
        elif x is not None and (x.dtype != y.dtype or x.shape != y.shape
                                or not torch.equal(x, y)):
            bad.append(f"{what}: {x.dtype} {tuple(x.shape)} against {y.dtype} {tuple(y.shape)}")

    for h, (x, y) in enumerate(zip(a.node_ids, b.node_ids)):
        same(f"node_ids[{h}]", x, y)
    for h, (x, y) in enumerate(zip(a.node_masks, b.node_masks)):
        same(f"node_masks[{h}]", x, y)
    for h, (x, y) in enumerate(zip(a.layers, b.layers)):
        for f in ("self_idx", "in_nbr_idx", "in_mask", "out_nbr_idx", "out_mask", "node_mask",
                  "in_rel", "out_rel"):
            same(f"layers[{h}].{f}", getattr(x, f), getattr(y, f))
    same("overflow", a.overflow, b.overflow)
    if len(a.node_ids) != len(b.node_ids) or len(a.layers) != len(b.layers):
        bad.append("hop counts differ")
    return bad


def sampler_hop_bytes(n: int, fan: int, used: int, id_bytes: int, cap: int, width: int,
                      mode: str, rels: bool) -> dict:
    """Dense bytes each kernel of one hop must read or write once (the scattered
    marks and new-id writes are left out, so these are lower bounds): frontier
    ids and masks, two offsets a node and direction, a draw and a column a
    slot, the (2, n, F) indices and masks out (and relations), the per-node
    and next-hop-set outputs; for a prefix hop the id-space arrays (positions,
    marks, ranks: 4 bytes an id each) as each kernel reads or writes them."""
    slots = used * n * fan
    hop = (n * (id_bytes + 1) + used * n * 8 + slots * 8 + 2 * n * fan * (5 + 4 * rels)
           + n * 4)
    if mode == "saturated":
        return {"hop": hop + cap * 5}
    return {"hop": hop + cap * id_bytes + n * 4,
            "rank": width * 12,
            "totals": n * 5 + 8 * (-(-width // 4096)),
            "place": width * 12 + n * 4,
            "map": slots * 10 + width * 8 + cap * (id_bytes + 1)}


def sampler_shapes(card: str, trainer=None) -> dict:
    """The sampler's kernel path against its plain version on the card, bit
    for bit over every field of the NeighborBatch (dtypes included), at each
    of SAMPLER_CASES, with the same draws; both timed (device ms a call from
    CUDA events behind a sleep kernel, and host ms a call). At the NC cell's
    case, each kernel's device time a launch under torch.profiler beside its
    dense bytes; then the sampler under ``recording()`` counts no host
    synchronisation inside its ``sample`` span, as does one NC training
    batch of ``trainer`` where given."""
    from marius_tpu_torch.data.samplers.neighbor import (
        sample_neighbor_batch,
        sample_neighbor_batch_plain,
    )
    from marius_tpu_torch.ops.cuda import sampler as sampler_kernels
    from marius_tpu_torch.reporting import profiling

    dev = torch.device("cuda")
    graphs = sampler_graphs(dev)
    out = {}
    for name in SAMPLER_CASES:
        graph, seeds, mask, cfgs, caps, draws = sampler_case(name, graphs)
        record, replay = recorded_draws(draws)
        before = sampler_kernels.launches
        got = sample_neighbor_batch(record, graph, seeds, mask, cfgs, caps)
        launches = sampler_kernels.launches - before
        want = sample_neighbor_batch_plain(replay, graph, seeds, mask, cfgs, caps)
        torch.cuda.synchronize()
        bad = batch_mismatch(got, want)
        if bad:
            raise AssertionError(f"sampler {name}: the kernels differ from the plain version: "
                                 + "; ".join(bad))
        timing = {}
        for path, fn in (("kernels", sample_neighbor_batch), ("plain", sample_neighbor_batch_plain)):
            call = (lambda fn=fn: fn(replay, graph, seeds, mask, cfgs, caps))
            timing[f"{path}_ms"] = time_ms(call, reps=10, samples=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                call()
            timing[f"{path}_host_ms"] = (time.perf_counter() - t0) / 10 * 1e3
            torch.cuda.synchronize()
        out[name] = {"overflow": int(got.overflow), "launches": launches, **timing}
        print(f"sampler, {name} ({SAMPLER_CASES[name][0]}): bit for bit over every field; "
              f"overflow {int(got.overflow)}; kernel launches {launches}; kernels "
              f"{timing['kernels_ms']:.3f} ms (host {timing['kernels_host_ms']:.3f} ms) a batch, "
              f"plain {timing['plain_ms']:.3f} ms (host {timing['plain_host_ms']:.3f} ms)  "
              f"[{card}]", flush=True)

    # each kernel at the NC cell's shapes, under the profiler
    graph, seeds, mask, cfgs, caps, draws = sampler_case("nc_cell", graphs)
    record, replay = recorded_draws(draws)
    sample_neighbor_batch(record, graph, seeds, mask, cfgs, caps)
    torch.cuda.synchronize()
    reps = 20
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            sample_neighbor_batch(replay, graph, seeds, mask, cfgs, caps)
        torch.cuda.synchronize()
    # each kernel's launches in batch order: launch i of a batch is hop i of that kernel
    names = ("sampler_hop_kernel", "sampler_rank_kernel", "sampler_totals_kernel",
             "sampler_place_kernel", "sampler_map_kernel", "Memset")
    runs = {k: [] for k in names}
    device_ops = 0
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        device_ops += 1
        for k in names:
            if k in e.name:
                runs[k].append(e.time_range.elapsed_us())
    idb = seeds.element_size()
    width = ARXIV_NODES + 1
    bytes_by_hop = [sampler_hop_bytes(1000, 32, 2, idb, 16384, width, "prefix", False),
                    sampler_hop_bytes(16384, 32, 2, idb, 65536, width, "prefix", False),
                    sampler_hop_bytes(65536, 32, 2, idb, width, width, "saturated", False)]
    rates = card_rates(torch.cuda.get_device_name(0))
    kernels = {}
    for k, times in runs.items():
        per_batch = len(times) // reps
        if not per_batch:
            continue
        for i in range(per_batch):
            us = float(np.median(times[i::per_batch]))
            nbytes = bytes_by_hop[i].get(k.split("_")[1]) if k != "Memset" else None
            kernels[f"{k}[{i}]"] = us
            line = f"sampler, nc_cell {k} launch {i} of {per_batch} a batch: {us:.2f} us"
            if nbytes:
                line += (f"; dense bytes {nbytes / 1e6:.3f} MB, bound "
                         f"{nbytes / rates[0] * 1e6:.2f} us")
            print(line + f"  [{card}]", flush=True)
    print(f"sampler, nc_cell: {device_ops / reps:.1f} device operations a batch (the draws "
          f"replayed, so none drawn)  [{card}]", flush=True)
    out["nc_cell"]["kernels_us"] = kernels

    # no host synchronisation inside the sample span
    with profiling.recording() as log:
        sample_neighbor_batch(draws, graph, seeds, mask, cfgs, caps)
        if trainer is not None:
            b = trainer.batch_size
            trainer._sampled_batch_step(trainer.train_nodes[:b],
                                        torch.ones(b, dtype=torch.bool, device=dev))
        torch.cuda.synchronize()
    spans = [s for s in log.spans if s.name == "sample"]
    syncs = sum((s.counts or {}).get("host_syncs", 0) for s in spans)
    print(f"sampler: {len(spans)} sample spans under recording(), {syncs} host syncs inside "
          f"them (the sampler alone{', then one NC training batch' if trainer else ''})  "
          f"[{card}]", flush=True)
    if syncs:
        raise AssertionError(f"the sampler synchronised with the host {syncs} times")
    return out


def compare_sampled_nc_with_cpu():
    """Small sampled NC runs on the card against the same runs on the CPU
    (plain versions), with the same sampler numbers (both from a CPU
    generator) and permutation, without and with an EMBEDDING stage (the
    Adagrad kernel), 2 epochs, hop caps tight enough to truncate."""
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig, generator_draws
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig, tree_leaves
    from marius_tpu_torch.ops.cuda import adagrad
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    n, e, f = 300, 3000, 16
    rng = np.random.default_rng(5)
    w = (np.arange(n) + 1.0) ** -1.0
    edges = np.stack([rng.integers(0, n, e), rng.choice(n, e, p=w / w.sum())], 1)
    _, features, labels, train_nodes = nc_data(6, edges, n, f, 5, 200)
    graph = build_device_graph(edges, n)
    nbr = [NeighborSamplingConfig("UNIFORM", 8), NeighborSamplingConfig("DROPOUT", 6, rate=0.2)]

    worst, truncated = 0.0, 0
    for emb in (False, True):
        first = [LayerConfig("FEATURE", output_dim=f, bias=True)]
        if emb:
            first.append(LayerConfig("EMBEDDING", output_dim=8))
        width = f + (8 if emb else 0)
        model = Model(NODE_CLASSIFICATION, EncoderConfig((
            tuple(first),
            (LayerConfig("GNN", input_dim=width, output_dim=16, gnn_type="GRAPH_SAGE",
                         aggregator="MEAN", bias=True, activation="RELU"),),
            (LayerConfig("GNN", input_dim=16, output_dim=5, gnn_type="GCN", bias=True),))),
            None, loss_type="CROSS_ENTROPY", loss_reduction="SUM",
            dense_optimizer=OptimizerConfig("ADAM", learning_rate=NC_LR), sparse_lr=0.1)
        cpu, gpu = [NodeClassificationTrainer(model, graph, features, labels, train_nodes, nbr,
                                              batch_size=50, hop_caps=[50, 160, 260], seed=1,
                                              device=dev) for dev in ("cpu", "cuda")]
        gpu_draws = _moved(generator_draws(torch.Generator().manual_seed(1)), gpu.device)
        gpu._batch_draws = lambda: gpu_draws
        gpu._epoch_permutation = lambda p, _c=cpu, _g=gpu: _c._epoch_permutation(p).to(_g.device)
        adagrad.launches = 0
        for _ in range(2):
            rc, rg = cpu.train_epoch(), gpu.train_epoch()
            if not math.isclose(rc["loss"], rg["loss"], rel_tol=1e-4) or \
                    rc["truncated_frontier_ids"] != rg["truncated_frontier_ids"]:
                raise AssertionError(f"sampled NC on the card {rg} != on the CPU {rc}")
            truncated += rg["truncated_frontier_ids"]
        if emb and adagrad.launches != 2 * gpu.num_batches:
            raise AssertionError(f"the EMBEDDING table's Adagrad ran {adagrad.launches} times")
        leaves = [cpu.state.params, cpu.state.opt_state.slots], \
            [gpu.state.params, gpu.state.opt_state.slots]
        if emb:
            leaves[0].append([cpu.state.table.values, cpu.state.table.state])
            leaves[1].append([gpu.state.table.values, gpu.state.table.state])
        for a, b in zip(tree_leaves(leaves[0]), tree_leaves(leaves[1])):
            b = b.detach().cpu()
            worst = max(worst, float((a.detach() - b).abs().max()))
            torch.testing.assert_close(b, a.detach(), rtol=1e-4, atol=1e-5)
    if not truncated:
        raise AssertionError("the tight hop caps must truncate frontier ids")
    print(f"small sampled NC runs, card against CPU (without and with an EMBEDDING stage, "
          f"UNIFORM and DROPOUT hops, tight caps: {truncated} frontier ids truncated, 2 "
          f"epochs): max abs difference {worst:.3g} (tolerance rtol 1e-4, atol 1e-5)",
          flush=True)

    # sampled GAT (the sampler's numbers and the dropout masks from one CPU
    # generator, in the CPU trainer's order) and RGCN over 3 relations
    from marius_tpu_torch.nn.layers import DropoutKey
    rels = np.random.default_rng(7).integers(0, 3, len(edges))
    graph3 = build_device_graph(np.stack([edges[:, 0], rels, edges[:, 1]], 1), n, 3)
    worst = 0.0
    for gnn in ("GAT", "RGCN"):
        cpu, gpu = [NodeClassificationTrainer(small_gnn_model(gnn, f, 3), graph3, features,
                                              labels, train_nodes, nbr, batch_size=50,
                                              hop_caps=[50, 160, 260], seed=1, device=dev)
                    for dev in ("cpu", "cuda")]
        g1 = torch.Generator().manual_seed(1)
        gpu_draws, keys = _moved(generator_draws(g1), gpu.device), DropoutKey(g1)
        gpu._batch_draws, gpu._dropout_key = (lambda: gpu_draws), (lambda: keys)
        gpu._epoch_permutation = lambda p, _c=cpu, _g=gpu: _c._epoch_permutation(p).to(_g.device)
        for _ in range(2):
            rc, rg = cpu.train_epoch(), gpu.train_epoch()
            if not math.isclose(rc["loss"], rg["loss"], rel_tol=1e-4):
                raise AssertionError(f"sampled {gnn} NC on the card {rg} != on the CPU {rc}")
        for a, b in zip(tree_leaves([cpu.state.params, cpu.state.opt_state.slots]),
                        tree_leaves([gpu.state.params, gpu.state.opt_state.slots])):
            b = b.detach().cpu()
            worst = max(worst, float((a.detach() - b).abs().max()))
            torch.testing.assert_close(b, a.detach(), rtol=1e-4, atol=1e-5)
    print(f"small sampled GAT (8 heads, input and attention dropout) and RGCN (3 relations) "
          f"NC runs, card against CPU, 2 epochs: max abs difference {worst:.3g} (tolerance "
          f"rtol 1e-4, atol 1e-5)", flush=True)


# -- GAT and RGCN ------------------------------------------------------------------

def profile_steps(step, nb: int, tag: str, card: str) -> dict:
    """``nb`` training batches (``step`` each) through
    profile_torch_lp.profile_batches: host and device ms per batch, busy
    share, device operations per batch, the top kernels."""
    from profile_torch_lp import profile_batches

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nb):
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return profile_batches(run, nb, card, f"{tag}: ")


def layout_matrix(layout, n_in: int):
    """A gather-sum layout as an (num_out, n_in) f32 CSR matrix, padding
    dropped and repeated slots as counts: torch.sparse.mm(A, x) is the same
    sum in one library call (cuSPARSE)."""
    dev = layout.ids.device
    lens = layout.task_len.long()
    first = torch.cumsum(lens, 0) - lens
    slot = torch.repeat_interleave(layout.task_start, lens) + (
        torch.arange(int(lens.sum()), device=dev) - torch.repeat_interleave(first, lens))
    hub_of_piece = torch.zeros(max(layout.num_partials, 1), dtype=torch.long, device=dev)
    for k in range(int(layout.fold_count.max()) if layout.fold_count.numel() else 0):
        has = k < layout.fold_count
        hub_of_piece[(layout.fold_first[has] + k).long()] = layout.fold_dest[has].long()
    dest = layout.task_dest.long()
    row = torch.where(dest >= 0, dest, hub_of_piece[(-dest - 1).clamp(min=0)])
    rows, cols = torch.repeat_interleave(row, lens), layout.ids[slot].long()
    keep = (cols >= 0) & (cols < n_in)
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  torch.ones(int(keep.sum()), device=dev),
                                  (layout.num_out, n_in), check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def time_layout_sum(layout, n_in: int, d: int, rates, what: str, card: str,
                    dtype=torch.float32) -> dict:
    """The gather-sum kernel on one layout of a new consumer, bit for bit
    against its plain version, timed beside the plain version, the bound
    (each distinct row of x that a real slot names read once, the ids, the
    output written once; one add per real slot element) and
    torch.sparse.mm."""
    from marius_tpu_torch.ops.cuda import nbr_sum as ns

    dev = layout.ids.device
    x = torch.randn(n_in, d, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(11)).to(dtype)
    out = ns.nbr_sum(x, layout)
    ref = ns.nbr_sum_plain(x, layout)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"gather-sum differs from plain at {what}")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    a = layout_matrix(layout, n_in)
    library = None
    try:
        a = a.to(dtype)
    except (RuntimeError, NotImplementedError) as e:
        print(f"a CSR matrix does not convert to {dtype}: {str(e)[:160]}", flush=True)
    else:
        library = library_or_none(lambda: torch.sparse.mm(a, x), "torch.sparse.mm (CSR)", dtype,
                                  reps=10, samples=5)
    if library is not None and dtype == torch.float32:
        # cuSPARSE sums in another order
        torch.testing.assert_close(torch.sparse.mm(a, x), out, rtol=1e-4, atol=1e-3)
    elif library is not None:
        # cuSPARSE's bf16 product keeps bf16 partial sums: a hub row of 13k slots moves
        # by several percent, so it is held to the kernel's sums as a whole
        lib = torch.sparse.mm(a, x).float()
        rel = float((lib - out).norm() / out.norm())
        print(f"torch.sparse.mm in {dtype}: {rel:.3g} of the f32-accumulated sums' norm off, "
              f"worst element {float((lib - out).abs().max()):.3g}", flush=True)
        if not rel <= 2 ** -4:
            raise AssertionError(f"torch.sparse.mm in {dtype} is not the same sum: {rel}")
    valid = layout.ids[(layout.ids >= 0) & (layout.ids < n_in)]
    real, distinct = valid.numel(), int(torch.unique(valid).numel())
    nbytes = distinct * d * x.element_size() + layout.ids.numel() * 4 + layout.num_out * d * 4
    b_ms, b_by = bound_ms(nbytes, real * d, rates)
    r = {"slots": layout.ids.numel(), "real_slots": real, "distinct_rows": distinct,
         "rows_out": layout.num_out, "d": d,
         "max_abs_err": err, "ms": time_ms(lambda: ns.nbr_sum(x, layout)),
         "plain_ms": time_ms(lambda: ns.nbr_sum_plain(x, layout), reps=2, samples=3),
         "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes, "library_ms": library}
    lib = "-" if library is None else f"{library * 1e3:.2f} us"
    print(f"gather_sum, {what} ({r['slots']} slots, {real} real, {distinct} distinct rows, "
          f"{layout.num_out} rows out, d={d}, {dtype}, {nbytes / 1e6:.4f} MB): max_abs_err "
          f"{err}  kernel {r['ms'] * 1e3:.2f} us  plain {r['plain_ms'] * 1e3:.2f} us  "
          f"torch.sparse.mm {lib}  bound {b_ms * 1e3:.2f} us ({b_by})  [{card}]", flush=True)
    return r


def gat_options() -> dict:
    """bench_nc_full.py:92-96's gat8: 8 heads, averaged."""
    return {"type": "GAT", "num_heads": GAT_HEADS, "average_heads": True}


def nc_gat(card: str, data) -> dict:
    """The slice's main path: examples/configuration/ogbn_arxiv.yaml with its
    three GraphSAGE layers switched to GAT (gat8: 8 heads averaged, d = 128
    -> 128 -> 40, bias; the YAML's UNIFORM 32 in and out and hop caps)
    through marius_train and marius_eval on the card. Every GAT layer here
    takes the aggregate-then-project form (8 x 128 > 128 and 8 x 40 > 128):
    two slot gathers (the raw rows, the per-head logits) through the row
    gather, so training and each evaluation launch it 7 times per batch (the
    outer hop's features and 2 per layer) and the gather-sum never.
    Returns the launches per part and the trainer."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.train import nc as nc_mod

    config = Path(__file__).resolve().parent / "examples" / "configuration" / "ogbn_arxiv.yaml"
    with open(config) as f:
        raw = yaml.safe_load(f)
    for stage in raw["model"]["encoder"]["layers"][1:]:
        stage[0]["options"] = gat_options()
    per_batch = 1 + 2 * NC_GNN_STAGES
    evals = []
    evaluate = nc_mod.NodeClassificationEvaluator.evaluate

    def counted(self, state):
        before = (gather.launches, ns.launches)
        res = evaluate(self, state)
        evals.append((self.num_batches, gather.launches - before[0], ns.launches - before[1]))
        return res

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_arxiv_shaped(f"{tmp}/dataset", data)
        raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
        epochs_in_yaml = raw["training"]["num_epochs"]
        raw["training"]["num_epochs"] = NC_GAT_EPOCHS
        cfg = load_config(raw, model_dir=f"{tmp}/model")
        print(f"nc_gat: {config.relative_to(config.parents[2])} with its GRAPH_SAGE layers "
              f"switched to {gat_options()}, dataset_dir and model_dir redirected; one cut: "
              f"num_epochs {epochs_in_yaml} -> {NC_GAT_EPOCHS}; dataset written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        nc_mod.NodeClassificationEvaluator.evaluate = counted
        try:
            torch.cuda.reset_peak_memory_stats()
            gather.launches = ns.launches = adagrad.launches = 0
            out = marius_train(cfg)   # device=None: the GPU
            totals = (gather.launches, ns.launches, adagrad.launches)
            peak = torch.cuda.max_memory_allocated()
            train_evals = list(evals)
            gather.launches = ns.launches = adagrad.launches = 0
            again = marius_eval(cfg)
            reload_totals = (gather.launches, ns.launches, adagrad.launches)
        finally:
            nc_mod.NodeClassificationEvaluator.evaluate = evaluate

    trainer = out["runtime"].trainer
    layers = [s[0] for s in trainer.model.encoder.stages[1:]]
    if trainer.device.type != "cuda" or trainer.full_graph is not None or any(
            (l.gnn_type, l.num_heads, l.average_heads) != ("GAT", GAT_HEADS, True)
            for l in layers):
        raise AssertionError("the GAT model must train on the GPU through the sampled trainer")
    if trainer.hop_caps != tuple(raw["model"]["encoder"]["hop_caps"]):
        raise AssertionError(f"hop caps {trainer.hop_caps} are not the YAML's")
    losses = [e["loss"] for e in out["epochs"]]
    for i, (e, v) in enumerate(zip(out["epochs"], out["evals"])):
        print(f"nc_gat epoch {i}: loss {e['loss']:.6f}  {e['epoch_time_s']:.4f} s  "
              f"{e['nodes_per_sec']:.1f} train nodes/s  truncated frontier ids "
              f"{e['truncated_frontier_ids']}  valid accuracy {v['accuracy']:.6f}  [{card}]",
              flush=True)
        if not v["accuracy"] > 1.0 / ARXIV_CLASSES:
            raise AssertionError(f"valid accuracy is not above chance: {v}")
    if len(losses) != NC_GAT_EPOCHS or not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"nc_gat losses are not finite and falling: {losses}")
    test, reloaded = out["test"], again["test"]
    print(f"nc_gat: test accuracy {test['accuracy']:.6f} over {int(test['num_evaluated'])} "
          f"nodes (chance {1 / ARXIV_CLASSES}, floor {NC_GAT_MIN_ACCURACY}); peak device "
          f"memory {peak / 2**30:.3f} GiB  [{card}]", flush=True)
    if not test["accuracy"] >= NC_GAT_MIN_ACCURACY or test["num_evaluated"] != ARXIV_NODES - \
            ARXIV_TRAIN - ARXIV_VALID:
        raise AssertionError(f"test evaluation is wrong or below {NC_GAT_MIN_ACCURACY}: {test}")
    if any(test[k] != reloaded[k] for k in ("accuracy", "num_evaluated")):
        raise AssertionError(f"marius_eval's test metrics {reloaded} differ from "
                             f"marius_train's {test}")
    print("nc_gat: marius_eval reloaded the checkpoint and reproduced the test metrics exactly",
          flush=True)

    train_batches = NC_GAT_EPOCHS * trainer.num_batches
    eval_batches = sum(b for b, _, _ in train_evals)
    train_rows = totals[0] - sum(g for _, g, _ in train_evals)
    train_sums = totals[1] - sum(s for _, _, s in train_evals)
    if (train_rows, train_sums, totals[2]) != (per_batch * train_batches, 0, 0):
        raise AssertionError(f"nc_gat training launched gather_rows {train_rows}, gather_sum "
                             f"{train_sums} and Adagrad {totals[2]} times for {train_batches} "
                             f"batches (expected {per_batch}, 0 and 0 per batch)")
    for batches, g, s in evals:
        if (g, s) != (per_batch * batches, 0):
            raise AssertionError(f"an evaluation of {batches} batches launched gather_rows {g} "
                                 f"and gather_sum {s} times (expected {per_batch} and 0 per "
                                 "batch)")
    if reload_totals[2] != 0 or len(evals) != len(train_evals) + 1:
        raise AssertionError("marius_eval must evaluate once, without Adagrad")
    rows = {"nc_gat train": train_rows, "nc_gat eval": per_batch * eval_batches,
            "nc_gat marius_eval": reload_totals[0]}
    print(f"nc_gat launches: gather_rows {rows} ({per_batch} per batch), gather_sum 0, Adagrad "
          f"0 ({trainer.num_batches} train batches per epoch, {len(train_evals)} valid "
          f"evaluations of {train_evals[0][0]} batches, test {evals[-1][0]} batches)", flush=True)

    b = trainer.batch_size
    seeds = trainer.train_nodes[:b]
    mask = torch.ones(b, dtype=torch.bool, device=trainer.device)
    prof = profile_steps(lambda: trainer._sampled_batch_step(seeds, mask), 5, "nc_gat step",
                         card)
    timed = out["epochs"][1:] or out["epochs"]
    return {"gather_rows": rows, "trainer": trainer, "profile": prof,
            "gather_sum": {"nc_gat train": totals[1], "nc_gat marius_eval": reload_totals[1]},
            "sparse_adagrad_update_": {"nc_gat train": totals[2],
                                       "nc_gat marius_eval": reload_totals[2]},
            "nodes_per_s": sum(e["num_nodes"] for e in timed) / sum(
                e["epoch_time_s"] for e in timed)}


def gat_slot_shapes(trainer, rates, card) -> dict:
    """The row gather at the GAT slot block of one real nc_gat training
    batch's first layer: 65,536 targets x 65 slots (32 in, 32 out, self)
    into the outer hop's 169,344 rows, d = 128, bit for bit against the
    plain version, timed beside its bound and index_select."""
    from marius_tpu_torch.data.samplers.neighbor import sample_neighbor_batch
    from marius_tpu_torch.ops.cuda import gather
    from marius_tpu_torch.ops.segment import slot_ids

    dev, b = trainer.device, trainer.batch_size
    nb = sample_neighbor_batch(trainer._batch_draws(), trainer.graph, trainer.train_nodes[:b],
                               torch.ones(b, dtype=torch.bool, device=dev), trainer.nbr_configs,
                               trainer.hop_caps)
    adj, n_x = nb.layers[0], nb.node_ids[0].shape[0]
    ids = torch.cat([slot_ids(n_x, adj.in_nbr_idx.long(), adj.in_mask),
                     slot_ids(n_x, adj.out_nbr_idx.long(), adj.out_mask),
                     adj.self_idx.long().clamp(max=n_x - 1)[:, None]], 1).int().reshape(-1)
    table = torch.randn(n_x, NC_DIM, device=dev, generator=torch.Generator(device=dev)
                        .manual_seed(12))
    err = gather_max_err(gather, table, ids)
    r = time_gather(gather, table, [ids], rates)
    r["max_abs_err"] = err
    print(f"gather_rows, GAT layer 0 slots (K={r['k']} = {adj.self_idx.shape[0]} x "
          f"{ids.numel() // adj.self_idx.shape[0]}, d={r['d']}, {r['distinct_rows']:.0f} "
          f"distinct rows, {r['bound_bytes'] / 1e6:.4f} MB): max_abs_err {err}  kernel "
          f"{r['ms'] * 1e3:.2f} us  plain {r['plain_ms'] * 1e3:.2f} us  index_select "
          f"{r['library_ms'] * 1e3:.2f} us  bound {r['bound_ms'] * 1e3:.2f} us "
          f"({r['bound_by']})  [{card}]", flush=True)
    return r


def gat_against_cpu(gpu, data, card) -> dict:
    """The nc_gat model as trained, at full width, on the card against the
    same model on the CPU (the kernels' plain versions): NC_GAT_CPU_BATCHES
    training batches of the first train nodes, each from the trained
    parameters with the same sampler numbers (one CPU generator per device,
    seeded alike) at the YAML's hop caps. The truncated frontier ids must be
    equal and the loss agrees to rtol 1e-4 / atol 1e-5, as in the small
    card-against-CPU runs. Logits and gradients are float32 results whose
    order of summation differs between the devices, so each device is held
    against the same batch in float64 on the CPU. The logits: the card's
    largest error, relative to the largest logit, at most 10 times the CPU
    float32 run's, or 1e-6. The gradients, normwise (|g - g64| / |g64|), on
    both devices at most NC_GAT_GRAD_F64_TOL: by softmax's shift invariance
    the target-side attention term (a_l, and through it the first layer's w
    and bias and the FEATURE bias) has a gradient that is a residual of
    per-slot terms which cancel except where LeakyReLU bends, and float32
    leaves up to ~3e-3 of it (on either device, in different trained
    states); a fault in a gather or its backward moves whole rows. Returns
    the worst of each."""
    from marius_tpu_torch.data.samplers.neighbor import generator_draws
    from marius_tpu_torch.nn.encoder import encoder_forward
    from marius_tpu_torch.nn.model import nc_batch_loss
    from marius_tpu_torch.nn.optimizers import tree_leaves, tree_map
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    _, features, labels, train_nodes = data
    t0 = time.perf_counter()
    cpu = NodeClassificationTrainer(gpu.model, gpu.graph.to("cpu"), features, labels,
                                    train_nodes, gpu.nbr_configs, batch_size=gpu.batch_size,
                                    hop_caps=gpu.hop_caps, device="cpu")
    with torch.no_grad():
        for a, b in zip(tree_leaves(cpu.state.params), tree_leaves(gpu.state.params)):
            a.copy_(b.cpu())
    params64 = tree_map(lambda x: x.detach().double().requires_grad_(True), cpu.state.params)

    def grads_of(t, params, nb, feats, seeds, mask):
        logits = encoder_forward(t.model.encoder, params["encoder"], None, feats, nb,
                                 degrees=t.graph.degrees, train=True,
                                 dropout_key=t._dropout_key())
        loss = nc_batch_loss(t.model, logits, t.labels[seeds], mask & nb.seed_mask)
        return logits.detach(), loss.detach(), torch.autograd.grad(loss, tree_leaves(params))

    def batch(t, draws, seeds):
        mask = torch.ones(seeds.shape[0], dtype=torch.bool, device=t.device)
        nb, feats, _ = t._encode_batch(None, draws, seeds, mask, t.hop_caps)
        out = grads_of(t, t.state.params, nb, feats, seeds, mask)
        ref = grads_of(t, params64, nb, feats.double(), seeds, mask) if t is cpu else None
        return int(nb.overflow), out, ref

    def rel_err(g, ref):
        return float((g.cpu().double() - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)

    def norm_err(g, ref):
        return float((g.cpu().double() - ref).norm()) / max(float(ref.norm()), 1e-300)

    worst = {"logits": 0.0, "logits_card_vs_f64": 0.0, "logits_cpu_vs_f64": 0.0,
             "loss_rel": 0.0, "grad_rel": 0.0, "grad_card_vs_f64": 0.0, "grad_cpu_vs_f64": 0.0}
    b = gpu.batch_size
    for i in range(NC_GAT_CPU_BATCHES):
        seeds = gpu.train_nodes[i * b:(i + 1) * b]
        gd = _moved(generator_draws(torch.Generator().manual_seed(100 + i)), gpu.device)
        cd = generator_draws(torch.Generator().manual_seed(100 + i))
        og, (lg, sg, gg), _ = batch(gpu, gd, seeds)
        oc, (lc, sc, gc), (l64, _, g64) = batch(cpu, cd, seeds.cpu())
        if og != oc:
            raise AssertionError(f"nc_gat batch {i}: {og} frontier ids truncated on the card, "
                                 f"{oc} on the CPU")
        torch.testing.assert_close(sg.cpu(), sc, rtol=1e-4, atol=1e-5)
        worst["logits"] = max(worst["logits"], float((lg.cpu() - lc).abs().max()))
        worst["loss_rel"] = max(worst["loss_rel"], abs(float(sg) - float(sc)) / abs(float(sc)))
        card_err, cpu_err = rel_err(lg, l64), rel_err(lc, l64)
        worst["logits_card_vs_f64"] = max(worst["logits_card_vs_f64"], card_err)
        worst["logits_cpu_vs_f64"] = max(worst["logits_cpu_vs_f64"], cpu_err)
        if card_err > max(10 * cpu_err, 1e-6):
            raise AssertionError(f"nc_gat batch {i}: the logits are {card_err:.3g} of the "
                                 f"largest from the float64 reference on the card, "
                                 f"{cpu_err:.3g} on the CPU")
        for a, c, r in zip(gg, gc, g64):
            card_err, cpu_err = norm_err(a, r), norm_err(c, r)
            worst["grad_rel"] = max(worst["grad_rel"], norm_err(a, c.double()))
            worst["grad_card_vs_f64"] = max(worst["grad_card_vs_f64"], card_err)
            worst["grad_cpu_vs_f64"] = max(worst["grad_cpu_vs_f64"], cpu_err)
            if max(card_err, cpu_err) > NC_GAT_GRAD_F64_TOL:
                raise AssertionError(f"nc_gat batch {i}: a {tuple(c.shape)} gradient is "
                                     f"{card_err:.3g} (card) and {cpu_err:.3g} (CPU) of its "
                                     f"norm from the float64 reference")
    print(f"nc_gat at full width, card against CPU ({NC_GAT_CPU_BATCHES} training batches of "
          f"{b} seeds from the trained parameters, same sampler numbers, hop caps "
          f"{gpu.hop_caps}, {og} frontier ids truncated in the last): loss relative "
          f"{worst['loss_rel']:.3g} (tolerance rtol 1e-4, atol 1e-5); logits card against CPU "
          f"{worst['logits']:.3g} max abs; relative to their largest element, against float64 "
          f"card {worst['logits_card_vs_f64']:.3g} and CPU {worst['logits_cpu_vs_f64']:.3g} "
          f"(tolerance: the card within 10 times the CPU's error, or 1e-6); gradients, "
          f"normwise: card against CPU {worst['grad_rel']:.3g}, against float64 card "
          f"{worst['grad_card_vs_f64']:.3g} and CPU {worst['grad_cpu_vs_f64']:.3g} (tolerance "
          f"{NC_GAT_GRAD_F64_TOL} on both); {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    return worst


def arxiv_gnn_model(gnn_type: str):
    """bench_nc_full.py:88-113: FEATURE 128 (bias), then three GNN layers 128
    -> 128 -> 128 -> 40 with bias (GAT: gat8; RGCN: 8 relations), CE SUM,
    Adam lr 0.01."""
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    def gnn(din, dout):
        return (LayerConfig("GNN", input_dim=din, output_dim=dout, gnn_type=gnn_type,
                            bias=True, num_heads=GAT_HEADS, average_heads=True,
                            num_relations=ARXIV_RELS),)

    return Model(NODE_CLASSIFICATION, EncoderConfig((
        (LayerConfig("FEATURE", output_dim=ARXIV_FEATS, bias=True),),
        gnn(ARXIV_FEATS, NC_DIM), gnn(NC_DIM, NC_DIM), gnn(NC_DIM, ARXIV_CLASSES))), None,
        loss_type="CROSS_ENTROPY", loss_reduction="SUM",
        dense_optimizer=OptimizerConfig("ADAM", learning_rate=NC_LR))


def nc_full_graph_gnn(card: str, data, gnn_type: str, batches=None) -> dict:
    """Exact-ALL full-graph NC at arxiv shape through NodeClassificationTrainer
    (as bench_nc_full.py drives it), the final stage seed-restricted: RGCN
    over 8 uniform relations drawn from a seed (bench_nc_full.py:69), one
    epoch, then evaluation on the non-train nodes; or gat8, ``batches``
    batches. Per training batch the two full stages launch the gather-sum
    twice each (RGCN: the anchor sum and the slot gather's backward; GAT:
    the inverse-map backward of the raw rows and of the logits) and the row
    gather twice each (RGCN: the slot gather and the anchor sum's backward;
    GAT: the two slot gathers); evaluation runs the three stages forward
    (RGCN: one slot gather and one anchor sum each)."""
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer

    def zero():
        gather.launches = ns.launches = adagrad.launches = 0

    def read():
        return gather.launches, ns.launches, adagrad.launches

    tag = f"nc_{gnn_type.lower()}_full"
    edges, features, labels, train_nodes = data
    rels = gnn_type == "RGCN"
    if rels:
        r = np.random.default_rng(8).integers(0, ARXIV_RELS, len(edges)).astype(np.int32)
        edges = np.stack([edges[:, 0], r, edges[:, 1]], 1)
    t0 = time.perf_counter()
    adj = build_full_graph_adjacency(edges, ARXIV_NODES, with_relations=rels)
    graph = build_device_graph(edges, ARXIV_NODES, ARXIV_RELS if rels else 1)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    t0 = time.perf_counter()
    trainer = NodeClassificationTrainer(arxiv_gnn_model(gnn_type), graph, features, labels,
                                        train_nodes, batch_size=BATCH, seed=0, full_graph=adj)
    torch.cuda.synchronize()
    setup = (time.perf_counter() - t0,) + read()
    if trainer.device.type != "cuda" or trainer._fg_collapse is not None or \
            not trainer._fg_seed_restrict or (trainer._fg_rel_csr is not None) != rels or \
            (trainer.full_graph.inv_map is not None) == rels:
        raise AssertionError(f"{tag} must train on the GPU on the seed-restricted general path")
    what = (f"{adj.rel.total_slots} relational slots ({ARXIV_RELS} relations), "
            f"{len(adj.rel.anchor_slots)} anchor and {len(adj.rel.occ_slots)} occurrence "
            "buckets" if rels else f"{adj.total_slots} slots in {len(adj.nbrs)} buckets, the "
            "inverse occurrence map of the same shapes")
    print(f"{tag}: adjacency and graph on the host {host_s:.2f} s ({what}); trainer set-up "
          f"{setup[0]:.2f} s, launches gather_rows {setup[1]}, gather_sum {setup[2]}, Adagrad "
          f"{setup[3]}  [{card}]", flush=True)
    counts = {f"{tag} setup": setup[1:]}
    zero()
    if batches is None:
        res = trainer.train_epoch()
        nb = trainer.num_batches
        print(f"{tag} epoch: loss {res['loss']:.6f}  {res['epoch_time_s']:.4f} s  "
              f"{res['nodes_per_sec']:.1f} train nodes/s  "
              f"{res['epoch_time_s'] / nb * 1e3:.4f} ms per batch  [{card}]", flush=True)
        if not math.isfinite(res["loss"]):
            raise AssertionError(f"{tag} loss is not finite: {res}")
        out = {"epoch_s": res["epoch_time_s"], "nodes_per_s": res["nodes_per_sec"]}
    else:
        nb = batches
        perm = trainer._epoch_permutation(0)[:nb * BATCH]
        seeds = trainer.train_nodes[perm].reshape(nb, BATCH)
        masks = (perm < trainer.num_train).reshape(nb, BATCH)
        slots = trainer._batch_slot_counts(seeds, masks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [trainer._batch_step(seeds[i], masks[i], slots[i]) for i in range(nb)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        print(f"{tag}: {nb} batches of the first epoch in {dt:.4f} s, {dt / nb:.4f} s per "
              f"batch, {nb * BATCH / dt:.1f} train nodes/s; losses {losses[0]:.3f} ... "
              f"{losses[-1]:.3f}  [{card}]", flush=True)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{tag} losses are not finite: {losses}")
        out = {"s_per_batch": dt / nb, "nodes_per_s": nb * BATCH / dt}
    counts[f"{tag} train"] = read()
    if counts[f"{tag} setup"] != (0, 0, 0) or counts[f"{tag} train"] != (4 * nb, 4 * nb, 0):
        raise AssertionError(f"{tag} launched (gather_rows, gather_sum, Adagrad) {counts} for "
                             f"{nb} training batches (expected none at set-up; 4, 4 and 0 per "
                             "batch)")
    peak = torch.cuda.max_memory_allocated()
    if batches is not None:
        out["profile"] = profile_steps(lambda: trainer._batch_step(seeds[0], masks[0],
                                                                   slots[0]), 2,
                                       f"{tag} step", card)
    else:
        eval_nodes = np.setdiff1d(np.arange(ARXIV_NODES), train_nodes)
        zero()
        t0 = time.perf_counter()
        acc = NodeClassificationEvaluator(trainer, eval_nodes).evaluate(trainer.state)
        eval_s = time.perf_counter() - t0
        counts[f"{tag} evaluation"] = read()
        expect = (NC_GNN_STAGES, NC_GNN_STAGES, 0) if rels else (2 * NC_GNN_STAGES, 0, 0)
        if counts[f"{tag} evaluation"] != expect or not acc["accuracy"] > 1.0 / ARXIV_CLASSES:
            raise AssertionError(f"{tag} evaluation: {acc}, launches "
                                 f"{counts[f'{tag} evaluation']} (expected {expect})")
        print(f"{tag} evaluation: accuracy {acc['accuracy']:.6f} over "
              f"{int(acc['num_evaluated'])} non-train nodes (chance {1 / ARXIV_CLASSES}) in "
              f"{eval_s:.4f} s", flush=True)
        out["accuracy"] = acc["accuracy"]
        b = trainer.batch_size
        seeds, mask = trainer.train_nodes[:b], torch.ones(b, dtype=torch.bool,
                                                          device=trainer.device)
        slots = trainer._batch_slot_counts(seeds[None], mask[None])[0]
        out["profile"] = profile_steps(lambda: trainer._batch_step(seeds, mask, slots), 5,
                                       f"{tag} step", card)
    print(f"{tag}: peak device memory {peak / 2**30:.3f} GiB; launches (gather_rows, "
          f"gather_sum, Adagrad) {counts}: 4, 4 and 0 per training batch  [{card}]", flush=True)
    out.update(trainer=trainer, peak_gib=peak / 2**30,
               gather_rows={k: v[0] for k, v in counts.items()},
               gather_sum={k: v[1] for k, v in counts.items()},
               sparse_adagrad_update_={k: v[2] for k, v in counts.items()})
    return out


def full_graph_shapes(rgcn_trainer, gat_trainer, rates, card) -> dict:
    """Both kernels at every shape the full-graph RGCN and GAT stages give
    them, each bit for bit against its plain version and timed beside its
    bound and library call. The gather-sum: the relational anchor sum (each
    node's transformed out-edge slots, 8 relations at arxiv shape) and the
    slot gather's backward over the occurrence layout (each node's slots
    among the relation buckets), at d = 128; GAT's inverse-map backward
    (each node's occurrences among the adjacency's slots) at d = 128 (the raw
    rows) and d = 8 (the per-head logits). The row gather, over x with its
    zero row appended: RGCN's slot gather and the anchor sum's backward (each
    slot's anchor row) at d = 128, GAT's block gathers at d = 128 and 8."""
    from marius_tpu_torch.ops.cuda import gather
    from marius_tpu_torch.ops.cuda import nbr_sum as ns

    rel_sum = rgcn_trainer._fg_ops["rel_sum"]
    adj = gat_trainer.full_graph
    perm = torch.argsort(adj.inv_pos.long(), stable=True)
    inv_layout = ns.bucket_layout(adj.inv_map, perm, adj.num_nodes)
    t = rel_sum.rg.total_slots
    sums = {"rgcn_anchor_sum": time_layout_sum(
                rel_sum.anchor_layout, t, NC_DIM, rates, "RGCN relational anchor sum", card),
            "rgcn_slot_gather_backward": time_layout_sum(
                rel_sum.occ_layout, t, NC_DIM, rates, "RGCN slot gather's backward (occurrence "
                "layout)", card),
            "gat_inverse_map": time_layout_sum(
                inv_layout, adj.total_slots, NC_DIM, rates, "GAT inverse-map backward", card),
            "gat_inverse_map_logits": time_layout_sum(
                inv_layout, adj.total_slots, GAT_HEADS, rates,
                "GAT inverse-map backward of the logits", card)}

    dev, n = adj.nbrs[0].device, adj.num_nodes
    g = torch.Generator(device=dev).manual_seed(13)
    block_ids = torch.cat([b.reshape(-1) for b in adj.nbrs])
    rows = {}
    for name, ids, d in (("rgcn_slot_gather", rel_sum.ids, NC_DIM),
                         ("rgcn_anchor_sum_backward", rel_sum.rg.slot_src, NC_DIM),
                         ("gat_block_gather", block_ids, NC_DIM),
                         ("gat_block_gather_logits", block_ids, GAT_HEADS)):
        table = torch.randn(n + 1, d, device=dev, generator=g)
        table[n] = 0
        err = gather_max_err(gather, table, ids)
        r = rows[name] = time_gather(gather, table, [ids], rates)
        r["max_abs_err"] = err
        print(f"gather_rows, {name} (K={r['k']} {ids.dtype} ids into ({n + 1}, {d}), "
              f"{r['distinct_rows']:.0f} distinct rows, {r['bound_bytes'] / 1e6:.4f} MB): "
              f"max_abs_err {err}  kernel {r['ms'] * 1e3:.2f} us  plain "
              f"{r['plain_ms'] * 1e3:.2f} us  index_select {r['library_ms'] * 1e3:.2f} us  "
              f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})  [{card}]", flush=True)
    return {"gather_rows": rows, "gather_sum": sums}


# -- GNN- and FEATURE-encoded link prediction ---------------------------------

def gnn_encoder(dim: int) -> dict:
    """The reference's gs_1_layer LP fragment at width ``dim``: an EMBEDDING
    stage, then one GraphSAGE MEAN layer over UNIFORM 10 sampling, which the
    evaluation inherits (marius_tpu/config/schema.py:457-458)."""
    return {"layers": [[{"type": "EMBEDDING", "output_dim": dim}],
                       [{"type": "GNN", "input_dim": dim, "output_dim": dim,
                         "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}]],
            "train_neighbor_sampling": [{"type": "UNIFORM", "options": {"max_neighbors": 10}}]}


def lp_gnn(card: str) -> dict:
    """fb15k_237.yaml with its encoder replaced by gs_1_layer's at the YAML's
    width through marius_train and marius_eval on the card. Training and each
    evaluation are counted apart: per training batch one row gather (the
    outer hop's table rows), one gather-sum and one Adagrad; per evaluation
    one gather-sum and one gather per node tile, and two gathers per edge
    batch. Returns the launches per part and the trainer."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.train import evaluator as evaluator_mod

    config = Path(__file__).resolve().parent / "examples" / "configuration" / "fb15k_237.yaml"
    with open(config) as f:
        raw = yaml.safe_load(f)
    metric_keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    evals = []    # (edge batches, node tiles, gather, gather_sum, adagrad) per evaluation
    evaluate = evaluator_mod.LinkPredictionEvaluator.evaluate

    def counted(self, state, encoded=None):
        before = (gather.launches, ns.launches, adagrad.launches)
        res = evaluate(self, state, encoded)
        evals.append((self.num_batches, -(-self.num_nodes // self.batch_size),
                      gather.launches - before[0], ns.launches - before[1],
                      adagrad.launches - before[2]))
        return res

    with tempfile.TemporaryDirectory() as tmp:
        write_fb15k_shaped(f"{tmp}/dataset")
        raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
        epochs_in_yaml = raw["training"]["num_epochs"]
        raw["training"]["num_epochs"] = GNN_LP_EPOCHS
        raw["model"]["encoder"] = gnn_encoder(DIM)
        cfg = load_config(raw, model_dir=f"{tmp}/model")
        print(f"lp_gnn: {config.relative_to(config.parents[2])} with dataset_dir and model_dir "
              f"redirected; overrides: encoder [[EMBEDDING {DIM}]], [[GNN GRAPH_SAGE MEAN "
              f"{DIM}->{DIM}]], train_neighbor_sampling [UNIFORM max_neighbors 10] (eval "
              f"inherits it; the reference's gs_1_layer fragment); cut: num_epochs "
              f"{epochs_in_yaml} -> {GNN_LP_EPOCHS}", flush=True)
        evaluator_mod.LinkPredictionEvaluator.evaluate = counted
        try:
            torch.cuda.reset_peak_memory_stats()
            gather.launches = ns.launches = adagrad.launches = 0
            out = marius_train(cfg)   # device=None: the GPU
            totals = (gather.launches, ns.launches, adagrad.launches)
            peak = torch.cuda.max_memory_allocated()
            train_evals = list(evals)
            gather.launches = ns.launches = adagrad.launches = 0
            again = marius_eval(cfg)
            reload_totals = (gather.launches, ns.launches, adagrad.launches)
        finally:
            evaluator_mod.LinkPredictionEvaluator.evaluate = evaluate
        meta_written = Path(f"{tmp}/model/meta.yaml").exists()

    rt = out["runtime"]
    trainer, test_ev = rt.trainer, rt.test_evaluator
    if trainer.device.type != "cuda" or not trainer.nbr_configs or trainer.dense_accum:
        raise AssertionError("lp_gnn must train the sampled GNN branch on the GPU")
    if test_ev.nbr_configs != trainer.nbr_configs or test_ev.full_graph is not None:
        raise AssertionError("the evaluation must inherit the UNIFORM 10 sampling")
    losses = [e["loss"] for e in out["epochs"]]
    for i, (e, v) in enumerate(zip(out["epochs"], out["evals"])):
        print(f"lp_gnn epoch {i}: loss {e['loss']:.6f}  {e['epoch_time_s']:.4f} s  "
              f"{e['edges_per_sec']:.1f} edges/s  truncated frontier ids "
              f"{e['truncated_frontier_ids']}  valid filtered MRR {v['mrr']:.6f} "
              f"({v['eval_time_s']:.4f} s)  [{card}]", flush=True)
    if len(losses) != GNN_LP_EPOCHS or not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"lp_gnn losses are not finite and falling: {losses}")
    if [v["epoch"] for v in out["evals"]] != list(range(1, GNN_LP_EPOCHS + 1)):
        raise AssertionError("a valid evaluation must run after each epoch")
    test, reloaded = out["test"], again["test"]
    for res in out["evals"] + [test]:
        if not 0.0 < res["mrr"] <= 1.0:
            raise AssertionError(f"MRR out of (0, 1]: {res}")
    timed = out["epochs"][1:]
    eps = sum(e["num_edges"] for e in timed) / sum(e["epoch_time_s"] for e in timed)
    print(f"lp_gnn: hop caps {trainer.hop_caps} (the outer hop every node: saturated), "
          f"{trainer.num_batches} batches per epoch; timed epochs {eps:.1f} edges/s; test "
          f"filtered MRR {test['mrr']:.6f}  Hits@10 {test['hits@10']:.6f}  over "
          f"{int(test['num_evaluated'])} ranks in {test['eval_time_s']:.4f} s; peak device "
          f"memory {peak / 2**30:.3f} GiB  [{card}]", flush=True)
    if not meta_written:
        raise AssertionError("marius_train did not write meta.yaml")
    if any(test[k] != reloaded[k] for k in metric_keys):
        raise AssertionError(f"marius_eval's test metrics {reloaded} differ from "
                             f"marius_train's {test}")
    print("lp_gnn: marius_eval reloaded the checkpoint and reproduced the test metrics exactly",
          flush=True)

    batches = GNN_LP_EPOCHS * trainer.num_batches
    train = tuple(t - sum(e[2 + k] for e in train_evals) for k, t in enumerate(totals))
    if train != (batches, batches, batches):
        raise AssertionError(f"lp_gnn training launched gather_rows, gather_sum and Adagrad "
                             f"{train} times for {batches} batches (1 each per batch)")
    for edge_batches, tiles, g, s_, a in evals:
        if (g, s_, a) != (tiles + 2 * edge_batches, tiles, 0):
            raise AssertionError(f"an evaluation of {tiles} node tiles and {edge_batches} edge "
                                 f"batches launched gather_rows {g}, gather_sum {s_}, Adagrad "
                                 f"{a} times")
    if reload_totals[2] != 0 or len(evals) != len(train_evals) + 1:
        raise AssertionError("marius_eval must evaluate once, without Adagrad")
    counts = {
        "gather_rows": {"lp_gnn train": train[0], "lp_gnn eval": sum(e[2] for e in train_evals),
                        "lp_gnn marius_eval": reload_totals[0]},
        "gather_sum": {"lp_gnn train": train[1], "lp_gnn eval": sum(e[3] for e in train_evals),
                       "lp_gnn marius_eval": reload_totals[1]},
        "sparse_adagrad_update_": {"lp_gnn train": train[2]},
    }
    print(f"lp_gnn launches: {counts} ({trainer.num_batches} train batches per epoch; "
          f"{len(train_evals)} evaluations in marius_train, the valid ones of "
          f"{train_evals[0][1]} node tiles and {train_evals[0][0]} edge batches, the test of "
          f"{evals[-1][1]} and {evals[-1][0]})", flush=True)
    counts["trainer"] = trainer
    return counts


def lp_gnn_batch(trainer):
    """One real training batch of a GNN LP trainer: (the batch's sorted unique
    ids, its neighbour batch), with the trainer's own negatives and draws."""
    from marius_tpu_torch.data.samplers.neighbor import sample_neighbor_batch
    from marius_tpu_torch.ops.unique import unique_padded

    b, n = trainer.batch_size, trainer.num_nodes
    edges_b = trainer.edges[:b]
    negs = [trainer._sample_negatives(edges_b, inverse).ids.reshape(-1)
            for inverse in (False, True)]
    ids = unique_padded(torch.cat([edges_b[:, 0], edges_b[:, -1]] + negs),
                        size=trainer.unique_cap, fill_value=n).ids
    nb = sample_neighbor_batch(trainer._batch_draws(), trainer.graph, ids, ids < n,
                               trainer.nbr_configs, trainer.hop_caps)
    return ids, nb


def lp_gnn_shapes(trainer, rates, card) -> dict:
    """The three kernels at one real lp_gnn batch's shapes: the outer hop's
    row gather (every one of the 14,541 rows and the padding id), the GNN
    layer's gather-sum (12,000 seeds x 20 slots over the outer hop) and its
    index_add_ backward, and the Adagrad update over the outer hop's ids
    (the padding id skipped). Each bit for bit against its plain version,
    timed beside its bound (bytes at the card's rate) and its one-call
    PyTorch equivalent: index_select, embedding_bag, torch's sparse Adagrad."""
    from torch.optim.adagrad import adagrad as torch_adagrad

    from marius_tpu_torch.ops.cuda import adagrad, gather

    dev = trainer.device
    _, nb = lp_gnn_batch(trainer)
    outer = nb.node_ids[0]
    table = trainer.state.table.values
    n, d = table.shape
    rows = time_gather(gather, table, [outer], rates)
    rows["max_abs_err"] = gather_max_err(gather, table, outer)
    print(f"gather_rows, lp_gnn_outer (K={rows['k']}, d={d}, {rows['distinct_rows']:.1f} "
          f"distinct rows, {rows['bound_bytes'] / 1e6:.4f} MB): max_abs_err "
          f"{rows['max_abs_err']}  kernel {rows['ms'] * 1e3:.2f} us  plain "
          f"{rows['plain_ms'] * 1e3:.2f} us  index_select {rows['library_ms'] * 1e3:.2f} us  "
          f"bound {rows['bound_ms'] * 1e3:.2f} us ({rows['bound_by']})  [{card}]", flush=True)

    sums = time_layer_sum(nb.layers[0], outer.shape[0], d, rates, dev)
    print(f"gather_sum, lp_gnn layer ({sums['targets']} seeds x {sums['width']} slots, "
          f"{sums['valid_slots']} real, {sums['distinct_rows']} distinct rows of "
          f"{outer.shape[0]}, d={d}, {sums['bound_bytes'] / 1e6:.4f} MB): "
          f"max_abs_err {sums['max_abs_err']}  "
          f"kernel {sums['ms'] * 1e3:.2f} us (with the layout built: "
          f"{sums['with_layout_ms'] * 1e3:.2f} us)  plain {sums['plain_ms'] * 1e3:.2f} us  "
          f"embedding_bag {sums['library_ms'] * 1e3:.2f} us  bound {sums['bound_ms'] * 1e3:.2f} "
          f"us ({sums['bound_by']})  backward (index_add_) "
          f"{sums['backward_index_add_ms'] * 1e3:.2f} us  [{card}]", flush=True)

    g = torch.Generator(device=dev).manual_seed(8)
    grads = torch.randn(outer.shape[0], d, device=dev, generator=g)
    state = torch.rand(n, d, device=dev, generator=g)
    v1, s1, v2, s2 = table.clone(), state.clone(), table.clone(), state.clone()
    adagrad.sparse_adagrad_update_(v1, s1, outer, grads, 0.1)
    adagrad.sparse_adagrad_update_plain_(v2, s2, outer, grads, 0.1)
    torch.cuda.synchronize()
    err = max(float((v1 - v2).abs().max()), float((s1 - s2).abs().max()))
    if err != 0.0:
        raise AssertionError(f"sparse_adagrad_update_ differs from plain at lp_gnn_outer: {err}")
    keep = outer < n
    k = int(keep.sum())
    nbytes = 5 * k * d * 4 + outer.numel() * outer.element_size()
    b_ms, b_by = bound_ms(nbytes, 7 * k * d, rates)
    sparse = torch.sparse_coo_tensor(outer[keep].long()[None], grads[keep], (n, d),
                                     is_coalesced=True, check_invariants=False)
    v3, s3, step = table.clone(), state.clone(), torch.zeros((), device=dev)

    def library():
        torch_adagrad([v3], [sparse], [s3], [step], has_sparse_grad=True, lr=0.1,
                      weight_decay=0.0, lr_decay=0.0, eps=1e-10, maximize=False)

    ada = {"k": k, "padding_ids": outer.numel() - k, "d": d, "max_abs_err": err,
           "ms": time_ms(lambda: adagrad.sparse_adagrad_update_(v1, s1, outer, grads, 0.1)),
           "plain_ms": time_ms(lambda: adagrad.sparse_adagrad_update_plain_(
               v2, s2, outer, grads, 0.1)),
           "library_ms": time_ms(library), "bound_ms": b_ms, "bound_by": b_by,
           "bound_bytes": nbytes, "plan": adagrad.tensor_plan(v1, s1, outer, grads)._asdict()}
    print(f"sparse_adagrad_update_, lp_gnn_outer ({k} {outer.dtype} ids + {ada['padding_ids']} "
          f"padding, d={d}, {nbytes / 1e6:.4f} MB): max_abs_err {err}  kernel "
          f"{ada['ms'] * 1e3:.2f} us  plain {ada['plain_ms'] * 1e3:.2f} us  torch.optim.adagrad "
          f"(sparse) {ada['library_ms'] * 1e3:.2f} us  bound {b_ms * 1e3:.2f} us ({b_by})  plan "
          f"{plan_text(ada['plan'])}  [{card}]", flush=True)
    return {"gather_rows": rows, "gather_sum": sums, "sparse_adagrad_update_": ada}


# compare_gnn_lp_with_cpu: fb15k_237.yaml's and freebase86m_comet.yaml's
# learning rate, of the dense optimizer and of the table's Adagrad alike
YAML_LR = 0.1


def _close_leaves(a_tree, b_tree, worst: float) -> float:
    """Each pair of matching leaves held to rtol 1e-4, atol 1e-5; returns the
    largest |a - b| / (atol + rtol |a|) so far (1 is the tolerance)."""
    from marius_tpu_torch.nn.optimizers import tree_leaves

    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        a, b = torch.as_tensor(a).detach(), torch.as_tensor(b).detach().cpu()
        worst = max(worst, float(((a - b).abs() / (1e-5 + 1e-4 * a.abs())).max()))
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)
    return worst


def _gnn_lp_stages(variant: str, d: int = 8, f: int = 6, r: int = 4):
    from marius_tpu_torch.nn.layers import LayerConfig as L

    emb = (L("EMBEDDING", output_dim=d),)
    sage = dict(gnn_type="GRAPH_SAGE", aggregator="MEAN", bias=True)
    return {
        "sage-mean": (emb, (L("GNN", input_dim=d, output_dim=d, **sage),)),
        "gcn": (emb, (L("GNN", input_dim=d, output_dim=d, gnn_type="GCN", bias=True),)),
        "sage-2-layers": (emb, (L("GNN", input_dim=d, output_dim=d, **sage),),
                          (L("GNN", input_dim=d, output_dim=d, **sage),)),
        "gnn-feature": ((L("EMBEDDING", output_dim=d - f), L("FEATURE", output_dim=f)),
                        (L("REDUCTION", reduction="CONCAT", output_dim=d),),
                        (L("GNN", input_dim=d, output_dim=d, **sage),)),
        "embedding-feature": ((L("EMBEDDING", output_dim=d - f),
                               L("FEATURE", output_dim=f, bias=True)),),
        "pure-feature": ((L("FEATURE", output_dim=f, bias=True),),),
        # the reference's gat_1_layer and rgcn_1_layer fragments (tests/test_manager.py:239)
        "gat": (emb, (L("GNN", input_dim=d, output_dim=d, gnn_type="GAT", num_heads=2),)),
        "rgcn": (emb, (L("GNN", input_dim=d, output_dim=d, gnn_type="RGCN", num_relations=r,
                         bias=True),)),
    }[variant]


def _gnn_lp_model(variant: str, r: int, d: int = 8, opt: str = "ADAGRAD", lr: float = 0.1,
                  sparse_lr: float = 0.02):
    from marius_tpu_torch.nn.decoders.edge import EdgeDecoder
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.model import LINK_PREDICTION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    enc = EncoderConfig(_gnn_lp_stages(variant, d, r=r))
    width = sum(layer.output_dim for layer in enc.stages[-1])   # parallel outputs concatenate
    return Model(LINK_PREDICTION, enc, EdgeDecoder("DISTMULT", r, width),
                 loss_type="SOFTMAX_CE", loss_reduction="SUM",
                 dense_optimizer=OptimizerConfig(opt, learning_rate=lr), sparse_lr=sparse_lr)


def _cpu_draws(device, *key):
    """Sampler numbers from a CPU generator seeded from ``key``, moved to
    ``device``: the same on any device."""
    from marius_tpu_torch.data.samplers.neighbor import generator_draws

    s = int(np.random.SeedSequence(key).generate_state(1)[0])
    return _moved(generator_draws(torch.Generator().manual_seed(s)), device)


def _step_draws(trainer, step: int, seed: int = 5):
    """A buffer trainer's sampler numbers for (epoch, step), drawn on the CPU
    and moved to its device: the same on any device."""
    return _cpu_draws(trainer.device, seed, trainer.epoch, step)


def _moved(draw, device):
    """A Draws callable whose numbers come from ``draw`` (on the CPU) moved to ``device``."""
    def moved(*a):
        r, u = draw(*a)
        return r.to(device), None if u is None else u.to(device)
    return moved


def _exact_eval_data(n=200, r=4):
    """Every node with in- and out-degree >= 2 (i -> i+1, i -> i+7) plus
    random edges: under a fanout of 2 each neighbour sum has exactly 4 slots,
    so quantized inputs give exact encodings and scores in any order."""
    rng = np.random.default_rng(4)
    i = np.arange(n)
    ring = np.concatenate([np.stack([i, rng.integers(0, r, n), (i + k) % n], 1)
                           for k in (1, 7)])
    extra = np.stack([rng.integers(0, n, 600), rng.integers(0, r, 600),
                      rng.integers(0, n, 600)], 1)
    edges = np.unique(np.concatenate([ring, extra]), axis=0).astype(np.int32)
    return edges, edges[rng.permutation(len(edges))[:120]]


def _quantized_eval_on(model, st, edges_q, test_q, en, er, eb, nbr_q) -> dict:
    """{device: (ranks, evaluate(), evaluate_from_host_table())} of the
    quantized state ``st`` on the CPU and the card."""
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator

    results = {}
    for dev in ("cpu", "cuda"):
        g = build_device_graph(edges_q, en, er, device=dev)
        ev = LinkPredictionEvaluator(model, en, er, test_q, all_edges=edges_q, batch_size=eb,
                                     node_chunk=64, graph=g, nbr_configs=nbr_q, device=dev)
        state = type(st)(table=type(st.table)(values=st.table.values.to(dev),
                                              state=st.table.state.to(dev)),
                         params={k: [[{n_: t.detach().to(dev) for n_, t in p.items()}
                                      for p in stage] for stage in v] if k == "encoder"
                                 else {n_: t.detach().to(dev) for n_, t in v.items()}
                                 for k, v in st.params.items()},
                         opt_state=st.opt_state, epoch=0)
        ranks = ev.compute_all_ranks(state)[0]
        on_dev = ev.evaluate(state)
        tiled = ev.evaluate_from_host_table(st.table.values.numpy(), state.params,
                                            edge_slice=32, node_tile=64)
        results[dev] = (ranks, on_dev, tiled)
    return results


def compare_gnn_lp_with_cpu():
    """Small GNN and FEATURE LP runs on the card against the same runs on the
    CPU (plain versions), with the same negatives, permutation and sampler
    numbers, at the optimizers and learning rates of fb15k_237.yaml (in
    memory: SAGE, GCN, 2 layers, EMBEDDING + FEATURE, pure FEATURE, and the
    reference's gat_1_layer and rgcn_1_layer) and freebase86m_comet.yaml
    (over the partition buffer: GNN, GNN + FEATURE under COMET and BETA;
    GAT and RGCN with the table at lr 0.02). Every leaf of the state is held to the tolerance
    of tests/test_torch_lp_gnn.py (rtol 1e-4, atol 1e-5) after the first 2
    batches or 2 buffer states; over 2 whole epochs, the loss of each epoch
    (rtol 1e-4). The card's atomics add in another order than the CPU, and
    at these rates float32 noise grows past the leaves' tolerance within a
    few more batches, as it does against JAX (ROADMAP C5). Then
    filtered ranks through a GNN on quantized inputs (evaluate() and the
    host-tiled evaluation, card and CPU exactly equal), exact-ALL evaluation
    with an EMBEDDING input against sampled ALL (SAGE, RGCN with the
    relational companion, GAT), and the MRR of tests/test_lp_gnn.py's graph
    above twice a random ranking's."""
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig, generator_draws
    from marius_tpu_torch.train import graph_encoder
    from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer
    from marius_tpu_torch.train.evaluator import LinkPredictionEvaluator
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    n, r, e = 1000, 4, 3000
    rng = np.random.default_rng(0)
    w = (np.arange(n) + 1.0) ** -0.8
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, r, e),
                      rng.choice(n, e, p=w / w.sum())], 1).astype(np.int32)
    feats = np.random.default_rng(1).standard_normal((n, 6)).astype(np.float32)
    graph = build_device_graph(edges, n, r)
    cfg = NegativeSamplingConfig(num_chunks=2, negatives_per_positive=8)
    nbr = {"sage-mean": [NeighborSamplingConfig("UNIFORM", 3)],
           "gcn": [NeighborSamplingConfig("DROPOUT", 3, rate=0.3)],
           "sage-2-layers": [NeighborSamplingConfig("UNIFORM", 2),
                             NeighborSamplingConfig("UNIFORM", 3)],
           "gat": [NeighborSamplingConfig("UNIFORM", 3)],
           "rgcn": [NeighborSamplingConfig("UNIFORM", 3)]}
    variants = ("sage-mean", "gcn", "sage-2-layers", "embedding-feature", "pure-feature", "gat",
                "rgcn")
    buffer_runs = (("gnn", "sage-mean", 2000, "COMET"), ("gnn", "sage-mean", 80, "BETA"),
                   ("gnn-feature", "gnn-feature", 80, "COMET"),
                   ("gnn-feature", "gnn-feature", 2000, "BETA"),
                   # the table at tests/test_torch_buffer_trainer.py's lr 0.02: at 0.1 one
                   # element of the GAT run's table drifted to 2x the tolerance within 2
                   # buffer states, float32 noise that Adagrad amplifies (ROADMAP C5)
                   ("gat", "gat", 2000, "COMET", 0.02), ("rgcn", "rgcn", 80, "BETA", 0.02))

    def in_memory_pair(variant, train_edges):
        """fb15k_237.yaml's optimizers: dense Adam and table Adagrad at YAML_LR."""
        nbr_v = nbr.get(variant, [])
        cpu, gpu = trainers = [LinkPredictionTrainer(
            _gnn_lp_model(variant, r, opt="ADAM", lr=YAML_LR, sparse_lr=YAML_LR), n, r,
            train_edges, cfg, batch_size=32, seed=1, graph=graph if nbr_v else None,
            nbr_configs=nbr_v, features=feats if "feature" in variant else None, device=dev)
            for dev in ("cpu", "cuda")]
        draws = generator_draws(torch.Generator().manual_seed(2))
        for t in trainers:
            t._sample_negatives = (lambda edges_b, inverse, _c=t.neg_config:
                                   _batch_negatives(_c, edges_b, n, inverse))
        cpu._batch_draws = lambda: draws
        gpu_draws = _moved(generator_draws(torch.Generator().manual_seed(2)), gpu.device)
        gpu._batch_draws = lambda: gpu_draws
        gpu._epoch_permutation = lambda s: cpu._epoch_permutation(s).to(gpu.device)
        return cpu, gpu

    def buffer_pair(name, stages, nb_n, ordering, sparse_lr=YAML_LR):
        """freebase86m_comet.yaml's optimizers: dense and table Adagrad at
        YAML_LR (the table at ``sparse_lr``); the same in-buffer and sampler
        draws on both devices."""
        be = synthetic_edges(7, nb_n, r, 1500)
        bf = np.random.default_rng(6).standard_normal((nb_n, 6)).astype(np.float32)
        cpu, gpu = trainers = [PartitionBufferLPTrainer(
            _gnn_lp_model(stages, r, d=12, lr=YAML_LR, sparse_lr=sparse_lr), nb_n, r, be, cfg,
            batch_size=50 if nb_n > 80 else 100,
            num_partitions=4, buffer_capacity=2, ordering=ordering, seed=1,
            nbr_configs=[NeighborSamplingConfig("UNIFORM", 2)],
            features=bf if "feature" in name else None, device=dev) for dev in ("cpu", "cuda")]
        for t in trainers:
            t._in_buffer_draws = (lambda step, inverse, _t=t: injected_draws(_t, step, inverse))
            t._gnn_draws = lambda step, _t=t: _step_draws(_t, step)
        return cpu, gpu

    loss_gaps = []

    def same_loss(tag, lc, lg):
        loss_gaps.append(abs(lc - lg) / (1e-4 * abs(lc)))
        if not math.isclose(lc, lg, rel_tol=1e-4):
            raise AssertionError(f"{tag}: loss on the card {lg} != on the CPU {lc}")

    # the first 2 batches in memory and the first 2 buffer states (a swap and a
    # prefetched state graph between them): every leaf at the tolerance
    worst = 0.0
    for variant in variants:
        cpu, gpu = in_memory_pair(variant, edges[:64])
        same_loss(variant, cpu.train_epoch()["loss"], gpu.train_epoch()["loss"])
        a, b = [cpu.state.params, cpu.state.opt_state.slots], \
            [gpu.state.params, gpu.state.opt_state.slots]
        if cpu.state.table is not None:
            a.append([cpu.state.table.values, cpu.state.table.state])
            b.append([gpu.state.table.values, gpu.state.table.state])
        worst = _close_leaves(a, b, worst)
    for run in buffer_runs:
        cpu, gpu = buffer_pair(*run)
        same_loss(f"buffer {run}", cpu.train_epoch(max_states=2)["loss"],
                  gpu.train_epoch(max_states=2)["loss"])
        worst = _close_leaves([cpu.buffer.host_values, cpu.buffer.host_state, cpu.params],
                              [gpu.buffer.host_values, gpu.buffer.host_state, gpu.params], worst)
    print(f"small GNN and FEATURE LP runs at the YAMLs' lr {YAML_LR}, card against CPU, the "
          f"state after 2 batches ({', '.join(variants)}) and 2 buffer states ("
          + ", ".join(f"{nm} {o} {k} nodes" for nm, _, k, o, *_ in buffer_runs)
          + f"): largest difference {worst:.3g} of the tolerance (rtol 1e-4, atol 1e-5)",
          flush=True)

    # the whole schedules, 2 epochs each: the loss of every epoch
    loss_gaps.clear()
    for variant in variants:
        cpu, gpu = in_memory_pair(variant, edges)
        for _ in range(2):
            same_loss(variant, cpu.train_epoch()["loss"], gpu.train_epoch()["loss"])
    for run in buffer_runs:
        cpu, gpu = buffer_pair(*run)
        for _ in range(2):
            same_loss(f"buffer {run}", cpu.train_epoch()["loss"], gpu.train_epoch()["loss"])
    print(f"the same runs over 2 whole epochs: every epoch's loss within "
          f"{max(loss_gaps):.3g} of rtol 1e-4", flush=True)

    # filtered ranks through a GNN, quantized inputs: exact on both devices
    en, er, eb = 200, 4, 50
    edges_q, test_q = _exact_eval_data(en, er)
    qrng = np.random.default_rng(5)
    q = lambda shape, k, lim: torch.from_numpy(  # noqa: E731
        qrng.integers(-lim, lim + 1, shape).astype(np.float32) / k)
    model = _gnn_lp_model("sage-mean", er)
    nbr_q = [NeighborSamplingConfig("UNIFORM", 2)]
    base = LinkPredictionTrainer(model, en, er, edges_q, cfg, batch_size=eb, device="cpu",
                                 graph=build_device_graph(edges_q, en, er), nbr_configs=nbr_q)
    st = base.state
    with torch.no_grad():
        st.table.values.copy_(q(st.table.values.shape, 4, 1))
        for stage in st.params["encoder"]:
            for p in stage:
                for t in p.values():
                    t.copy_(q(t.shape, 4, 2))
        for t in st.params["decoder"].values():
            t.copy_(q(t.shape, 1, 1))
    keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    # the all-node encoding's per-tile sampler numbers, drawn on the CPU for both
    # devices (a CUDA generator gives other numbers from the same seed)
    seeded = graph_encoder.seeded_draws
    graph_encoder.seeded_draws = lambda seed, i, dev: _moved(seeded(seed, i, "cpu"), dev)
    try:
        results = _quantized_eval_on(model, st, edges_q, test_q, en, er, eb, nbr_q)
    finally:
        graph_encoder.seeded_draws = seeded
    (rc, ec, tc), (rg, eg, tg) = results["cpu"], results["cuda"]
    # evaluate()'s rank sums are float32 (the JAX scan's), the host-tiled ones float64
    if not np.array_equal(rc, rg) or any(
            tc[k] != tg[k] or not math.isclose(tg[k], eg[k], rel_tol=1e-6)
            or not math.isclose(ec[k], eg[k], rel_tol=1e-6) for k in keys):
        raise AssertionError(f"GNN ranks on the card differ from the CPU's: {eg} {tg} vs "
                             f"{ec} {tc}")
    print(f"GNN LP evaluation on quantized inputs (SAGE MEAN, fanout 2, 4 node tiles): "
          f"{rc.size} ranks and the host-tiled metrics equal the CPU's exactly, evaluate()'s "
          f"within rtol 1e-6 (MRR {tg['mrr']:.6f})", flush=True)

    # exact ALL with an EMBEDDING input against sampled ALL, and the MRR band, on the
    # random graph of tests/test_lp_gnn.py (100 nodes, 10 relations)
    rng = np.random.default_rng(0)
    lp_edges = np.unique(np.stack([rng.integers(0, 100, 1000), rng.integers(0, 10, 1000),
                                   rng.integers(0, 100, 1000)], 1).astype(np.int32), axis=0)
    perm = rng.permutation(len(lp_edges))
    train_e, test_e = lp_edges[perm[:int(0.9 * len(perm))]], lp_edges[perm[int(0.9 * len(perm)):]]
    g = build_device_graph(train_e, 100, 10, device="cuda")
    model = _gnn_lp_model("sage-mean", 10, d=16, opt="ADAM", lr=0.05, sparse_lr=0.1)
    tr = LinkPredictionTrainer(model, 100, 10, train_e, NegativeSamplingConfig(5, 20),
                               batch_size=100, seed=0, graph=g,
                               nbr_configs=[NeighborSamplingConfig("UNIFORM", 5)])
    stats = [tr.train_epoch() for _ in range(4)]
    if not stats[-1]["loss"] < stats[0]["loss"]:
        raise AssertionError(f"the small GNN LP loss does not fall: {stats}")
    kw = dict(all_edges=lp_edges, batch_size=100, graph=g)
    mrr = LinkPredictionEvaluator(model, 100, 10, train_e[:100],
                                  nbr_configs=[NeighborSamplingConfig("UNIFORM", 5)],
                                  **kw).evaluate(tr.state)["mrr"]
    random_mrr = sum(1.0 / k for k in range(1, 101)) / 100
    if not mrr > 2 * random_mrr:
        raise AssertionError(f"GNN LP MRR {mrr} is not above twice a random ranking's")
    max_deg = int(g.degrees.max())
    nbr_all = [NeighborSamplingConfig("ALL", max_neighbors=max_deg)]
    sampled = LinkPredictionEvaluator(model, 100, 10, test_e, nbr_configs=nbr_all, **kw)
    exact = LinkPredictionEvaluator(model, 100, 10, test_e, nbr_configs=nbr_all,
                                    full_graph=build_full_graph_adjacency(train_e, 100), **kw)
    a, b = sampled.evaluate(tr.state), exact.evaluate(tr.state)
    enc_a, enc_b = sampled._encode(tr.state), exact._encode(tr.state)
    torch.testing.assert_close(enc_b, enc_a, rtol=1e-5, atol=1e-6)
    if abs(a["mrr"] - b["mrr"]) > 1e-4:
        raise AssertionError(f"exact-ALL MRR {b['mrr']} != sampled ALL {a['mrr']}")
    print(f"GNN LP on tests/test_lp_gnn.py's graph on the card: MRR {mrr:.4f} (random "
          f"{random_mrr:.4f}); exact-ALL evaluation with an EMBEDDING input: MRR "
          f"{b['mrr']:.6f}, sampled ALL {a['mrr']:.6f}, encodings within rtol 1e-5, "
          f"atol 1e-6", flush=True)
    # the same with RGCN (tests/test_lp_gnn.py:195; the relational companion) and GAT
    # encoders, trained 2 epochs under ALL sampling
    for variant in ("rgcn", "gat"):
        model = _gnn_lp_model(variant, 10, d=16, opt="ADAM", lr=0.05, sparse_lr=0.1)
        tr = LinkPredictionTrainer(model, 100, 10, train_e, NegativeSamplingConfig(5, 20),
                                   batch_size=100, seed=0, graph=g, nbr_configs=nbr_all)
        tr.train(2)
        sampled = LinkPredictionEvaluator(model, 100, 10, test_e, nbr_configs=nbr_all, **kw)
        exact = LinkPredictionEvaluator(model, 100, 10, test_e, nbr_configs=nbr_all,
                                        full_graph=build_full_graph_adjacency(
                                            train_e, 100, with_relations=variant == "rgcn"),
                                        **kw)
        a, b = sampled.evaluate(tr.state), exact.evaluate(tr.state)
        torch.testing.assert_close(exact._encode(tr.state), sampled._encode(tr.state),
                                   rtol=1e-5, atol=1e-5)
        if abs(a["mrr"] - b["mrr"]) > 1e-4:
            raise AssertionError(f"{variant} exact-ALL MRR {b['mrr']} != sampled ALL {a['mrr']}")
        print(f"{variant} LP exact-ALL evaluation on the card: MRR {b['mrr']:.6f}, sampled "
              f"ALL {a['mrr']:.6f}, encodings within rtol 1e-5, atol 1e-5", flush=True)


def lp_gnn_oocore(card: str) -> dict:
    """freebase86m_comet.yaml's model (ComplEx d = 100, 16 partitions, buffer
    capacity 8, COMET, batch 10,000) with gs_1_layer's encoder at d = 100 and
    UNIFORM 10, at lp_oocore_reload's cut, through marius_train with the
    model saved, then marius_eval, which must reproduce the test metrics."""
    from marius_tpu_torch.manager import marius_eval, marius_train

    with tempfile.TemporaryDirectory() as tmp:
        write_freebase_shaped(f"{tmp}/dataset", RELOAD_NODES, RELOAD_TRAIN_EDGES,
                              RELOAD_EVAL_EDGES)
        cfg = freebase_config(tmp, RELOAD_NODES, save_model=True,
                              encoder=gnn_encoder(FB86M_DIM), epochs=GNN_OOCORE_EPOCHS)
        print(f"lp_gnn_oocore: freebase86m_comet.yaml with dataset_dir and model_dir "
              f"redirected; override: encoder [[EMBEDDING {FB86M_DIM}]], [[GNN GRAPH_SAGE MEAN "
              f"{FB86M_DIM}->{FB86M_DIM}]], train_neighbor_sampling [UNIFORM max_neighbors 10] "
              f"(eval inherits it); cuts: {RELOAD_NODES} nodes (published 86,054,151), "
              f"{RELOAD_TRAIN_EDGES} train and {RELOAD_EVAL_EDGES} valid and test edges, "
              f"num_epochs 10 -> {GNN_OOCORE_EPOCHS}", flush=True)
        with EpochProbe() as probe:
            t0 = time.perf_counter()
            out = marius_train(cfg)   # device=None: the GPU
            total = time.perf_counter() - t0
            trainer = out["runtime"].trainer
            print(f"lp_gnn_oocore: marius_train {total:.2f} s; hop caps {trainer.hop_caps} over "
                  f"{trainer.buffer.buffer_rows} buffer rows; batch {trainer.batch_size}",
                  flush=True)
            counts = report_oocore_epochs("lp_gnn_oocore", out, probe, card,
                                          GNN_OOCORE_EPOCHS)
            again = marius_eval(cfg)
        if not Path(f"{tmp}/model/meta.yaml").exists():
            raise AssertionError("marius_train did not save the model")
    if not trainer.nbr_configs:
        raise AssertionError("lp_gnn_oocore must train the buffer's GNN branch")
    keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    if any(out["test"][k] != again["test"][k] for k in keys):
        raise AssertionError(f"marius_eval's test metrics {again['test']} differ from "
                             f"marius_train's {out['test']}")
    print("lp_gnn_oocore: marius_eval reloaded the checkpoint and reproduced the test "
          "metrics exactly", flush=True)
    counts["gather_rows"]["lp_gnn_oocore marius_eval"] = probe.evals[-1][1]
    counts["gather_sum"]["lp_gnn_oocore marius_eval"] = probe.evals[-1][3]
    return counts


# -- out-of-core node classification and the full-graph leftovers -----------------

def concat_sage_model(feat_dim: int, emb_dim: int, dims, feature_bias: bool = False):
    """FEATURE (and an EMBEDDING table of ``emb_dim`` beside it,
    concatenated), then GraphSAGE MEAN stages of widths ``dims`` with bias
    and RELU between, CE SUM, Adam lr 0.01, table lr 0.1."""
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.model import NODE_CLASSIFICATION, Model
    from marius_tpu_torch.nn.optimizers import OptimizerConfig

    first = [LayerConfig("FEATURE", output_dim=feat_dim, bias=feature_bias)]
    if emb_dim:
        first.append(LayerConfig("EMBEDDING", output_dim=emb_dim))
    d = feat_dim + emb_dim
    stages = [tuple(first)]
    if emb_dim:
        stages.append((LayerConfig("REDUCTION", input_dim=d, output_dim=d, reduction="CONCAT"),))
    for i, (din, dout) in enumerate(zip((d,) + tuple(dims[:-1]), dims)):
        stages.append((LayerConfig("GNN", input_dim=din, output_dim=dout, gnn_type="GRAPH_SAGE",
                                   aggregator="MEAN", bias=True,
                                   activation="RELU" if i < len(dims) - 1 else "NONE"),))
    return Model(NODE_CLASSIFICATION, EncoderConfig(tuple(stages)), None,
                 loss_type="CROSS_ENTROPY", loss_reduction="SUM", sparse_lr=0.1,
                 dense_optimizer=OptimizerConfig("ADAM", learning_rate=NC_LR))


def compare_nc_oocore_with_cpu():
    """Small out-of-core NC runs on the card and on the CPU with the same
    draws (one CPU generator per (epoch, step) and per evaluation batch, on
    both devices): DISPERSED and SEQUENTIAL, features only and features +
    EMBEDDING, 2000 nodes in 8 partitions, capacity 4, 2 epochs; every dense
    leaf, the flushed co-buffer and the evaluation accuracy agree. Runs all
    three kernels (row gather, gather-sum, Adagrad)."""
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.train.nc_buffer import PartitionBufferNCTrainer

    n, e, f, classes = 2000, 16000, 16, 5
    edges = synthetic_edges(11, n, 1, e)[:, [0, 2]]
    _, features, labels, train_nodes = nc_data(12, edges, n, f, classes, 1200)
    eval_nodes = np.setdiff1d(np.arange(n), train_nodes)
    nbr = [NeighborSamplingConfig("UNIFORM", 4)] * 2
    worst, launches = 0.0, [0, 0, 0]
    for ordering in ("DISPERSED", "SEQUENTIAL"):
        for emb_dim in (0, 8):
            model = concat_sage_model(f, emb_dim, (16, classes))
            pair = [PartitionBufferNCTrainer(model, edges, features, labels, train_nodes, nbr,
                                             num_nodes=n, batch_size=100, num_partitions=8,
                                             buffer_capacity=4, ordering=ordering, seed=2,
                                             device=dev) for dev in ("cpu", "cuda")]
            for t in pair:
                t._batch_draws = (lambda ep, step, data_index=0, _t=t:
                                  _cpu_draws(_t.device, 9, ep, step))
                t._eval_draws = lambda count, _t=t: _cpu_draws(_t.device, 10, count)
            cpu, gpu = pair
            if emb_dim and not np.array_equal(cpu.emb_buffer.host_values,
                                              gpu.emb_buffer.host_values):
                raise AssertionError("the two co-buffers start from different tables")
            gather.launches = ns.launches = adagrad.launches = 0
            for _ in range(2):
                lc, lg = cpu.train_epoch()["loss"], gpu.train_epoch()["loss"]
                if not math.isclose(lc, lg, rel_tol=1e-4):
                    raise AssertionError(f"out-of-core NC loss on the card {lg} != on the CPU "
                                         f"{lc} ({ordering}, EMBEDDING {emb_dim})")
            ac, ag = cpu.evaluate_nodes(eval_nodes), gpu.evaluate_nodes(eval_nodes)
            for i, k in enumerate((gather.launches, ns.launches, adagrad.launches)):
                launches[i] += k
            if ac["num_evaluated"] != ag["num_evaluated"] or not math.isclose(
                    ac["accuracy"], ag["accuracy"], rel_tol=1e-4):
                raise AssertionError(f"out-of-core NC accuracy on the card {ag} != on the CPU "
                                     f"{ac} ({ordering}, EMBEDDING {emb_dim})")
            pairs = [(a.detach(), b.detach().cpu()) for a, b in zip(
                tree_leaves([cpu.params, cpu.opt_state.slots]),
                tree_leaves([gpu.params, gpu.opt_state.slots]))]
            if emb_dim:
                cpu.flush()
                gpu.flush()
                pairs += [(torch.from_numpy(cpu.emb_buffer.host_values),
                           torch.from_numpy(gpu.emb_buffer.host_values)),
                          (torch.from_numpy(cpu.emb_buffer.host_state),
                           torch.from_numpy(gpu.emb_buffer.host_state))]
            for a, b in pairs:
                worst = max(worst, float((a - b).abs().max()))
                torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)
            if gpu.opt_state.step != cpu.opt_state.step:
                raise AssertionError("the two optimizers took different step counts")
    if not all(launches):
        raise AssertionError(f"the small out-of-core runs must launch every kernel: {launches}")
    print(f"small out-of-core NC runs, card against CPU (DISPERSED and SEQUENTIAL, features "
          f"and features + EMBEDDING, 2 epochs and evaluation): max abs difference "
          f"{worst:.3g} (tolerance rtol 1e-4, atol 1e-5), accuracy equal within rtol 1e-4; "
          f"card launches gather_rows {launches[0]}, gather_sum {launches[1]}, "
          f"sparse_adagrad_update_ {launches[2]}", flush=True)


def write_papers_shaped(directory: str, num_nodes: int, num_edges: int, splits) -> float:
    """A papers100M-shaped dataset in the layout of storage/dataset.py, made on
    the card from seed 0 and written in chunks: f32 features of PAPERS_FEATS
    unit normals, labels the argmax of a random linear function of each
    node's own features (as nc_data makes them), uniform edges, and train,
    valid and test nodes of the given sizes, disjoint. Returns the seconds."""
    import os

    from marius_tpu_torch.storage.dataset import (
        NODE_FILES,
        DatasetStats,
        save_node_array,
        save_split,
        save_stats,
    )

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(PAPERS_FEATS, PAPERS_CLASSES, device=dev, generator=g)
    labels = np.empty(num_nodes, np.int32)
    path = os.path.join(directory, NODE_FILES["features"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    chunk = 1 << 22
    with open(path, "wb") as fh:
        for lo in range(0, num_nodes, chunk):
            x = torch.randn(min(chunk, num_nodes - lo), PAPERS_FEATS, device=dev, generator=g)
            labels[lo:lo + len(x)] = torch.argmax(x @ w, 1).int().cpu().numpy()
            x.cpu().numpy().tofile(fh)
    edges = torch.randint(0, num_nodes, (num_edges, 2), device=dev, generator=g,
                          dtype=torch.int32).cpu().numpy()
    save_split(directory, "train", edges)
    del edges
    nodes = torch.randperm(num_nodes, device=dev, generator=g)[:sum(splits)].int().cpu().numpy()
    save_node_array(directory, "labels", labels)
    bounds = np.cumsum((0,) + tuple(splits))
    for name, lo, hi in zip(("train_nodes", "valid_nodes", "test_nodes"), bounds, bounds[1:]):
        save_node_array(directory, name, nodes[lo:hi])
    save_stats(directory, DatasetStats(
        num_nodes=num_nodes, num_edges=num_edges, num_relations=1, num_edge_cols=2,
        num_train=splits[0], num_valid=splits[1], num_test=splits[2],
        num_classes=PAPERS_CLASSES, feature_dim=PAPERS_FEATS))
    return time.perf_counter() - t0


def papers_raw(tmp: str, epochs: int, save_model: bool, grouped: bool = False) -> dict:
    """examples/configuration/ogbn_arxiv.yaml's model (FEATURE 128, 3 x
    GraphSAGE MEAN, bias, CE SUM, Adam lr 0.01, batch 1000) over the
    papers100M-shaped dataset in ``tmp``: 172 classes, UNIFORM 8 per
    direction over 3 hops (bench_products.py:48), the YAML's hop caps
    dropped (the buffer trainer sizes them over its buffer rows), node
    features in a PARTITION_BUFFER of 16 partitions, capacity 8, DISPERSED
    (the reference's defaults); ``grouped`` gives the second GNN layer its
    own optimizer block. The raw dict, the model in ``tmp``/model."""
    path = Path(__file__).resolve().parent / "examples" / "configuration" / "ogbn_arxiv.yaml"
    with open(path) as f:
        raw = yaml.safe_load(f)
    enc = raw["model"]["encoder"]
    del enc["hop_caps"]
    enc["train_neighbor_sampling"] = [{"type": "UNIFORM",
                                       "options": {"max_neighbors": PAPERS_FANOUT}}] * 3
    enc["layers"][-1][0]["output_dim"] = PAPERS_CLASSES
    if grouped:
        enc["layers"][2][0]["optimizer"] = {"type": "ADAGRAD", "options": {"learning_rate": 0.01}}
    raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
    raw["storage"]["features"] = {"type": "PARTITION_BUFFER"}
    raw["storage"]["embeddings"] = {"options": {
        "num_partitions": PAPERS_PARTITIONS, "buffer_capacity": PAPERS_BUFFER,
        "node_partition_ordering": "DISPERSED"}}
    raw["storage"]["save_model"] = save_model
    raw["storage"]["model_dir"] = f"{tmp}/model"
    raw["training"]["num_epochs"] = epochs
    return raw


def papers_config(tmp: str, epochs: int, save_model: bool, grouped: bool = False):
    """``papers_raw`` loaded."""
    from marius_tpu_torch.config import load_config

    return load_config(papers_raw(tmp, epochs, save_model, grouped), model_dir=f"{tmp}/model")


class RssSampler:
    """Samples this process's resident memory (VmRSS, /proc/self/status)
    every 0.1 s on a thread and keeps the peak; the pages of a mapped file
    that the process has read count in it."""

    def __enter__(self):
        import threading

        self.peak = 0
        self._stop = threading.Event()

        def run():
            while not self._stop.is_set():
                with open("/proc/self/status") as f:
                    for line in f:
                        if line.startswith("VmRSS:"):
                            self.peak = max(self.peak, int(line.split()[1]) * 1024)
                self._stop.wait(0.1)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


class NCBufferProbe:
    """Wraps PartitionBufferNCTrainer.train_epoch and evaluate_nodes while a
    manager call runs: per-state timings on, and per epoch and evaluation
    the launch counts (counters set to 0 at the start of each call, read at
    its end), the bytes copied to the device, peak device memory and the
    seconds."""

    def __init__(self):
        from marius_tpu_torch.train import nc_buffer

        self.cls = nc_buffer.PartitionBufferNCTrainer
        self.epochs, self.evals, self.first_epoch_at = [], [], None

    def __enter__(self):
        from marius_tpu_torch.ops.cuda import adagrad, gather
        from marius_tpu_torch.ops.cuda import nbr_sum as ns
        from marius_tpu_torch.storage import transfer

        train_epoch, evaluate = self.cls.train_epoch, self.cls.evaluate_nodes
        self._saved = (train_epoch, evaluate)
        probe = self

        def reset():
            torch.cuda.reset_peak_memory_stats()
            gather.launches = adagrad.launches = ns.launches = 0
            transfer.bytes_h2d = transfer.bytes_d2h = 0
            transfer.seconds_h2d = transfer.seconds_d2h = 0.0

        def read(res):
            res.update(gather=gather.launches, adagrad=adagrad.launches, gather_sum=ns.launches,
                       h2d=transfer.bytes_h2d, h2d_s=transfer.seconds_h2d,
                       peak=torch.cuda.max_memory_allocated())
            return res

        def profiled(trainer, *a, **kw):
            if probe.first_epoch_at is None:
                probe.first_epoch_at = time.perf_counter()
            trainer.profile_states = True
            reset()
            res = read(train_epoch(trainer, *a, **kw))
            res["timings"] = list(trainer.last_state_timings)
            probe.epochs.append(res)
            return res

        def counted(trainer, nodes):
            reset()
            t0 = time.perf_counter()
            res = evaluate(trainer, nodes)
            probe.evals.append(read({"s": time.perf_counter() - t0,
                                     "batches": trainer.last_eval_batches}))
            return res

        self.cls.train_epoch = profiled
        self.cls.evaluate_nodes = counted
        return self

    def __exit__(self, *exc):
        self.cls.train_epoch, self.cls.evaluate_nodes = self._saved


def report_nc_oocore(tag: str, out: dict, probe: NCBufferProbe, card: str, epochs: int) -> dict:
    """Print and check each epoch and evaluation of a papers-shaped run;
    return the launches by part."""
    trainer = out["runtime"].trainer
    if type(trainer).__name__ != "PartitionBufferNCTrainer" or trainer.device.type != "cuda":
        raise AssertionError(f"{tag} must train through PartitionBufferNCTrainer on the GPU")
    layers = trainer.model.encoder.num_gnn_stages
    for i, e in enumerate(probe.epochs):
        swap, graph, comp = (sum(t[k] for t in e["timings"]) for k in range(3))
        padded = e["masked_batches"] / (e["batches_run"] + e["masked_batches"])
        print(f"{tag} epoch {i}: loss {e['loss']:.6f}  {e['epoch_time_s']:.4f} s  "
              f"{e['nodes_per_sec']:.1f} train nodes/s  {len(e['timings'])} of "
              f"{e['num_buffer_states']} states, {e['batches_run']} batches + "
              f"{e['masked_batches']} padded (padded share {padded:.4f}, max_batches "
              f"{e['max_batches']}), truncated frontier ids {e['truncated_frontier_ids']}  "
              f"[{card}]", flush=True)
        print(f"{tag} epoch {i} per state (swap, state graph, compute) s: " + ", ".join(
            f"({a:.3f}, {b:.3f}, {c:.3f})" for a, b, c in e["timings"])
            + f"; sums {swap:.3f}, {graph:.3f}, {comp:.3f}; edge arrays padded to "
            f"{e['max_graph_edges']}", flush=True)
        print(f"{tag} epoch {i}: host->device {e['h2d'] / 1e9:.3f} GB in {e['h2d_s']:.3f} s "
              f"({e['h2d'] / 1e9 / max(e['h2d_s'], 1e-9):.3f} GB/s); peak device memory "
              f"{e['peak'] / 2**30:.3f} GiB; launches gather_rows {e['gather']}, gather_sum "
              f"{e['gather_sum']}, sparse_adagrad_update_ {e['adagrad']}  [{card}]", flush=True)
        if (e["gather"], e["gather_sum"], e["adagrad"]) != (
                e["batches_run"], layers * e["batches_run"], 0) or not e["batches_run"]:
            raise AssertionError(f"{tag} epoch {i}: launches do not match the batches: {e}")
        if not math.isfinite(e["loss"]):
            raise AssertionError(f"{tag} epoch {i}: the loss is not finite")
    if len(probe.epochs) != epochs:
        raise AssertionError(f"{tag} ran {len(probe.epochs)} epochs, not {epochs}")
    for ev in probe.evals:
        print(f"{tag} evaluation: {ev['batches']} batches in {ev['s']:.3f} s, host->device "
              f"{ev['h2d'] / 1e9:.3f} GB, peak device memory {ev['peak'] / 2**30:.3f} GiB, "
              f"launches gather_rows {ev['gather']}, gather_sum {ev['gather_sum']}  [{card}]",
              flush=True)
        if (ev["gather"], ev["gather_sum"], ev["adagrad"]) != (
                ev["batches"], layers * ev["batches"], 0):
            raise AssertionError(f"{tag}: an evaluation's launches do not match its batches")
    for res in out["evals"] + [out["test"]]:
        print(f"{tag} {res['split']} accuracy {res['accuracy']:.6f} over "
              f"{int(res['num_evaluated'])} nodes (chance {1 / PAPERS_CLASSES:.6f})  [{card}]",
              flush=True)
        if not 1.0 / PAPERS_CLASSES < res["accuracy"] <= 1.0:
            raise AssertionError(f"{tag}: {res['split']} accuracy is not above chance: {res}")
    return {"gather_rows": {f"{tag} train": sum(e["gather"] for e in probe.epochs),
                            f"{tag} eval": sum(ev["gather"] for ev in probe.evals)},
            "gather_sum": {f"{tag} train": sum(e["gather_sum"] for e in probe.epochs),
                           f"{tag} eval": sum(ev["gather_sum"] for ev in probe.evals)},
            "sparse_adagrad_update_": {f"{tag} train": sum(e["adagrad"] for e in probe.epochs)}}


def papers_splits(num_nodes: int):
    """Train, valid and test sizes: papers100M's, scaled with the node count."""
    return tuple(int(round(k * num_nodes / PAPERS_NODES))
                 for k in (PAPERS_TRAIN, PAPERS_VALID, PAPERS_TEST))


def nc_oocore_reload(card: str) -> dict:
    """The main config cut to NC_RELOAD_NODES nodes (edges and splits in
    proportion), the second GNN layer with its own optimizer block (a
    grouped optimizer), 1 epoch through marius_train with the model saved;
    marius_eval must reproduce the test accuracy exactly."""
    from marius_tpu_torch.manager import marius_eval, marius_train
    from marius_tpu_torch.nn.optimizers import GroupedOptimizerConfig

    n = NC_RELOAD_NODES
    edges = int(round(PAPERS_NC_EDGES * n / PAPERS_NODES))
    with tempfile.TemporaryDirectory() as tmp:
        secs = write_papers_shaped(f"{tmp}/dataset", n, edges, papers_splits(n))
        cfg = papers_config(tmp, 1, save_model=True, grouped=True)
        if not isinstance(cfg.model.dense_optimizer, GroupedOptimizerConfig):
            raise AssertionError("the layer's optimizer block must build a grouped optimizer")
        print(f"nc_oocore_reload: the nc_oocore config cut to {n} nodes, {edges} edges, "
              f"splits {papers_splits(n)}, 1 epoch; layer 2 with its own Adagrad block; "
              f"dataset written in {secs:.2f} s", flush=True)
        with NCBufferProbe() as probe:
            out = marius_train(cfg)   # device=None: the GPU
            counts = report_nc_oocore("nc_oocore_reload", out, probe, card, 1)
            again = marius_eval(cfg)
        if not Path(f"{tmp}/model/meta.yaml").exists():
            raise AssertionError("marius_train did not save the model")
    if any(out["test"][k] != again["test"][k] for k in ("accuracy", "num_evaluated")):
        raise AssertionError(f"marius_eval's test metrics {again['test']} differ from "
                             f"marius_train's {out['test']}")
    print("nc_oocore_reload: marius_eval reloaded the checkpoint (grouped optimizer state "
          "included) and reproduced the test accuracy exactly", flush=True)
    counts["gather_rows"]["nc_oocore_reload marius_eval"] = probe.evals[-1]["gather"]
    counts["gather_sum"]["nc_oocore_reload marius_eval"] = probe.evals[-1]["gather_sum"]
    return counts


def nc_oocore(card: str, rates) -> dict:
    """The papers100M-shaped PARTITION_BUFFER config through marius_train
    (1 epoch, a valid evaluation, the test evaluation), then the row gather
    and the gather-sum at one real batch's shapes of its last state."""
    import shutil

    from marius_tpu_torch.data.samplers.neighbor import estimate_hop_caps
    from marius_tpu_torch.manager import marius_train

    n, edges = PAPERS_NODES, PAPERS_NC_EDGES
    with tempfile.TemporaryDirectory() as tmp:
        mem, disk = host_memory(), shutil.disk_usage(tmp)
        print(f"nc_oocore host: MemTotal {mem['MemTotal'] / 2**30:.2f} GiB, MemAvailable "
              f"{mem['MemAvailable'] / 2**30:.2f} GiB; free disk {disk.free / 2**30:.2f} GiB "
              f"under {tmp}", flush=True)
        # host memory: the features' pages, the edges held about 4 times over, a spare;
        # disk: the features file and the edges file, within PAPERS_DISK_BYTES
        row = PAPERS_FEATS * 4
        rooms = {"MemAvailable": mem["MemAvailable"] - OOC_HOST_SPARE - 4 * edges * 8,
                 "free disk": disk.free - (8 << 30) - edges * 8,
                 f"the {PAPERS_DISK_BYTES / 2**30:.0f} GiB disk budget":
                     PAPERS_DISK_BYTES - edges * 8}
        cut = ""
        limit = min(rooms, key=rooms.get)
        if n * row > rooms[limit]:
            n = int(rooms[limit] // row) // 1_000_000 * 1_000_000
            cut = (f", nodes {PAPERS_NODES} -> {n} ({limit} cannot hold the "
                   f"{PAPERS_NODES * row / 2**30:.1f} GiB of features and "
                   f"{edges * 8 / 2**30:.1f} GiB of edges)")
        splits = (PAPERS_TRAIN, PAPERS_VALID, PAPERS_TEST)
        secs = write_papers_shaped(f"{tmp}/dataset", n, edges, splits)
        print(f"nc_oocore dataset: {n} nodes, {n * row / 1e9:.2f} GB of f32 features, "
              f"{edges} uniform edges, papers100M's splits {splits}, written in {secs:.2f} s",
              flush=True)
        cfg = papers_config(tmp, PAPERS_EPOCHS, save_model=False)
        print(f"nc_oocore: ogbn_arxiv.yaml's model at papers100M's shape (172 classes), "
              f"UNIFORM {PAPERS_FANOUT} per direction over 3 hops, features PARTITION_BUFFER "
              f"{PAPERS_PARTITIONS} partitions, capacity {PAPERS_BUFFER}, DISPERSED; cuts: "
              f"edges {PAPERS_EDGES} -> {edges}, num_epochs 10 -> {PAPERS_EPOCHS}{cut}",
              flush=True)
        torch.cuda.empty_cache()
        with NCBufferProbe() as probe, RssSampler() as rss:
            t0 = time.perf_counter()
            out = marius_train(cfg)   # device=None: the GPU
            total = time.perf_counter() - t0
        trainer = out["runtime"].trainer
        cache = trainer.cache
        expected = tuple(estimate_hop_caps(BATCH, trainer.nbr_configs, cache.buffer_rows))
        print(f"nc_oocore: marius_train {total:.2f} s, of which set-up before the first epoch "
              f"{probe.first_epoch_at - t0:.2f} s; cache {cache.buffer_rows} x "
              f"{cache.host.shape[1]} rows ({cache.buffer_rows * cache.host.shape[1] * 4 / 1e9:.2f}"
              f" GB), psize {cache.psize}, hop caps {trainer.hop_caps}; host peak RSS "
              f"{rss.peak / 2**30:.2f} GiB (the mapped features file's pages read "
              f"included: {n * PAPERS_FEATS * 4 / 2**30:.2f} GiB if every one was)  [{card}]",
              flush=True)
        if trainer.hop_caps != expected or not isinstance(cache.host, np.memmap):
            raise AssertionError("nc_oocore must read a mapped features file under worst-case "
                                 "caps over the buffer rows")
        counts = report_nc_oocore("nc_oocore", out, probe, card, PAPERS_EPOCHS)
        shapes = nc_oocore_shapes(trainer, rates, card)
        del out, trainer, cache
    return {**counts, "shapes": shapes}


def nc_oocore_shapes(trainer, rates, card) -> dict:
    """One real training batch of the last resident state: the row gather
    at the outer hop's shape (K = the outermost cap, into the cache's rows)
    and the gather-sum at layer 0's, each bit for bit against its plain
    version and timed beside its bound and its library call; between them,
    host and device ms per training step (profile_steps)."""
    from marius_tpu_torch.data.samplers.neighbor import sample_neighbor_batch
    from marius_tpu_torch.ops.cuda import gather

    dev = trainer.device
    st = [int(p) for p in trainer.cache.resident if p >= 0]
    max_edges = 1 << (trainer._state_edges(st) - 1).bit_length()
    graph = trainer._state_graph(max_edges)
    seeds_g = np.concatenate([trainer.train_by_part[p] for p in st])[:trainer.batch_size]
    seeds, labels = trainer._local_seeds(seeds_g)
    mask = torch.ones(len(seeds), dtype=torch.bool, device=dev)
    draws = trainer._batch_draws(trainer.epoch, 0)   # the trainer's own, on the card
    nb = sample_neighbor_batch(draws, graph, seeds, mask, trainer.nbr_configs, trainer.hop_caps)
    outer = nb.node_ids[0]
    table = trainer.cache.device_rows
    err = gather_max_err(gather, table, outer)
    rows = time_gather(gather, table, [outer], rates)
    rows["max_abs_err"] = err
    print(f"gather_rows, nc_oocore_outer (K={rows['k']} into {table.shape[0]} x {rows['d']}, "
          f"{rows['distinct_rows']:.1f} distinct rows, {rows['bound_bytes'] / 1e6:.4f} MB): "
          f"max_abs_err {err}  kernel {rows['ms'] * 1e3:.2f} us  plain "
          f"{rows['plain_ms'] * 1e3:.2f} us  index_select {rows['library_ms'] * 1e3:.2f} us  "
          f"bound {rows['bound_ms'] * 1e3:.2f} us ({rows['bound_by']})  [{card}]", flush=True)
    # where one training step's time goes (5 steps on these seeds, twice:
    # timed, then under the profiler)
    profile_steps(lambda: trainer._batch_step(graph, seeds, mask, labels, draws,
                                              trainer._dropout), 5, "nc_oocore step", card)
    sums = time_layer_sum(nb.layers[0], outer.shape[0], NC_DIM, rates, dev)
    print(f"gather_sum, nc_oocore layer 0 ({sums['targets']} targets x {sums['width']} slots, "
          f"{sums['valid_slots']} real, {sums['distinct_rows']} distinct rows of "
          f"{outer.shape[0]}, d={NC_DIM}, {sums['bound_bytes'] / 1e6:.4f} MB): "
          f"max_abs_err {sums['max_abs_err']}  "
          f"kernel {sums['ms'] * 1e3:.2f} us  plain {sums['plain_ms'] * 1e3:.2f} us  "
          f"embedding_bag {sums['library_ms'] * 1e3:.2f} us  bound {sums['bound_ms'] * 1e3:.2f} "
          f"us ({sums['bound_by']})  [{card}]", flush=True)
    return {"gather_rows": rows, "gather_sum": sums}


def nc_locality(card: str, adj, data, rates) -> dict:
    """train_nc's general seed-restricted trainer at arxiv shape, 1 epoch
    over the plain adjacency and over build_full_graph_adjacency(...,
    locality_reorder=True) from the same initial state and permutation: the
    losses agree within rtol 2e-5; then the whole neighbour sum (d = 128)
    timed in the two orders, and the gather-sum alone on the permuted x."""
    from marius_tpu_torch.data.full_graph import (
        build_full_graph_adjacency,
        make_nbr_sums,
        nbr_sum_layout,
    )
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.ops.cuda import gather
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    edges, features, labels, train_nodes = data
    t0 = time.perf_counter()
    adj_l = build_full_graph_adjacency(edges, ARXIV_NODES, locality_reorder=True)
    print(f"nc_locality: reverse Cuthill-McKee and the locality adjacency on the host in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    graph = build_device_graph(edges, ARXIV_NODES)
    model = nc_model(ARXIV_FEATS, (NC_DIM, NC_DIM, ARXIV_CLASSES))
    losses, counts = {}, {}
    for name, a in (("plain", adj), ("locality", adj_l)):
        gather.launches = ns.launches = 0
        tr = NodeClassificationTrainer(model, graph, features, labels, train_nodes,
                                       batch_size=BATCH, seed=0, full_graph=a,
                                       fg_linear_collapse=False)
        res = tr.train_epoch()
        losses[name] = res["loss"]
        counts[name] = (gather.launches, ns.launches, tr.num_batches)
        print(f"nc_locality {name}: loss {res['loss']:.6f}  {res['epoch_time_s']:.4f} s  "
              f"{res['nodes_per_sec']:.1f} nodes/s; launches gather_rows {gather.launches}, "
              f"gather_sum {ns.launches} over {tr.num_batches} batches  [{card}]", flush=True)
        del tr
    rel = abs(losses["locality"] - losses["plain"]) / abs(losses["plain"])
    print(f"nc_locality: loss relative difference {rel:.3g} (tolerance 2e-5)", flush=True)
    if rel > 2e-5:
        raise AssertionError("the locality adjacency's loss differs from the plain one's")
    # the general path: one neighbour sum at setup and 2 per batch (a middle stage,
    # forward and backward); each locality sum adds one row gather (the permutation)
    (g_p, s_p, nb), (g_l, s_l, _) = counts["plain"], counts["locality"]
    if not s_p == s_l == 1 + 2 * nb or g_l - g_p != s_l:
        raise AssertionError(f"nc_locality launches do not match the batches: {counts}")
    x = torch.randn(ARXIV_NODES, NC_DIM, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4))
    a_p, a_l = adj.to("cuda"), adj_l.to("cuda")
    f_p, f_l = make_nbr_sums(a_p), make_nbr_sums(a_l)
    y_p, y_l = f_p(x), f_l(x)
    torch.cuda.synchronize()
    if not torch.equal(y_p, y_l):
        raise AssertionError("the locality neighbour sum differs from the plain one")
    lay_p, lay_l = nbr_sum_layout(a_p), nbr_sum_layout(a_l)
    sums = time_layout_sum(lay_l, ARXIV_NODES, NC_DIM, rates, "nc_locality order", card)
    sums.update(plain_sum_ms=time_ms(lambda: f_p(x)), locality_sum_ms=time_ms(lambda: f_l(x)),
                kernel_plain_order_ms=time_ms(lambda: ns.nbr_sum(x, lay_p)))
    perm = time_gather(gather, x, [a_l.loc_perm], rates)
    perm["max_abs_err"] = gather_max_err(gather, x, a_l.loc_perm)
    print(f"nc_locality neighbour sum (N={ARXIV_NODES}, d={NC_DIM}): whole sum plain "
          f"{sums['plain_sum_ms'] * 1e3:.2f} us, locality {sums['locality_sum_ms'] * 1e3:.2f} "
          f"us; gather-sum kernel alone: original order "
          f"{sums['kernel_plain_order_ms'] * 1e3:.2f} us, locality order "
          f"{sums['ms'] * 1e3:.2f} us  [{card}]", flush=True)
    print(f"gather_rows, nc_locality permutation (K={perm['k']} into {ARXIV_NODES} x "
          f"{NC_DIM}): max_abs_err {perm['max_abs_err']}  kernel {perm['ms'] * 1e3:.2f} us  "
          f"plain {perm['plain_ms'] * 1e3:.2f} us  index_select {perm['library_ms'] * 1e3:.2f} "
          f"us  bound {perm['bound_ms'] * 1e3:.2f} us ({perm['bound_by']})  [{card}]",
          flush=True)
    return {"gather_rows": {"nc_locality plain train": g_p, "nc_locality train": g_l},
            "gather_sum": {"nc_locality plain train": s_p, "nc_locality train": s_l},
            "sum_shape": sums, "permute_shape": perm}


def nc_embedding_full(card: str, data, rates) -> dict:
    """EMBEDDING (d = 128) beside FEATURE, full-graph GraphSAGE at arxiv
    shape, 1 epoch through NodeClassificationTrainer and the evaluation: one
    all-rows Adagrad launch per batch; then the Adagrad kernel at all
    169,343 rows, bit for bit against the plain version, timed beside its
    bound and torch's sparse Adagrad."""
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.ops.cuda import nbr_sum as ns
    from marius_tpu_torch.train.nc import NodeClassificationEvaluator, NodeClassificationTrainer

    edges, features, labels, train_nodes = data
    model = concat_sage_model(ARXIV_FEATS, NC_DIM, (NC_DIM, NC_DIM, ARXIV_CLASSES),
                              feature_bias=True)
    adj = build_full_graph_adjacency(edges, ARXIV_NODES)
    tr = NodeClassificationTrainer(model, build_device_graph(edges, ARXIV_NODES), features,
                                   labels, train_nodes, batch_size=BATCH, seed=0, full_graph=adj)
    if tr._fg_collapse is not None or tr.state.table is None:
        raise AssertionError("an EMBEDDING encoder must take the general full-graph path")
    before = tr.state.table.values.clone()
    torch.cuda.reset_peak_memory_stats()
    gather.launches = ns.launches = adagrad.launches = 0
    res = tr.train_epoch()
    train = (gather.launches, ns.launches, adagrad.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"nc_embedding_full epoch 0: loss {res['loss']:.6f}  {res['epoch_time_s']:.4f} s  "
          f"{res['nodes_per_sec']:.1f} nodes/s  ({res['epoch_time_s'] / tr.num_batches * 1e3:.2f}"
          f" ms per batch); launches gather_rows {train[0]}, gather_sum {train[1]}, "
          f"sparse_adagrad_update_ {train[2]} over {tr.num_batches} batches; peak device memory "
          f"{peak / 2**30:.3f} GiB  [{card}]", flush=True)
    if train[2] != tr.num_batches or not math.isfinite(res["loss"]) or torch.equal(
            before, tr.state.table.values):
        raise AssertionError(f"nc_embedding_full: one Adagrad launch per batch and a trained "
                             f"table expected: {train}")
    gather.launches = ns.launches = adagrad.launches = 0
    eval_nodes = np.setdiff1d(np.arange(ARXIV_NODES), train_nodes)
    acc = NodeClassificationEvaluator(tr, eval_nodes).evaluate(tr.state)
    evals = (gather.launches, ns.launches, adagrad.launches)
    print(f"nc_embedding_full evaluation: accuracy {acc['accuracy']:.6f} over "
          f"{int(acc['num_evaluated'])} nodes; launches gather_rows {evals[0]}, gather_sum "
          f"{evals[1]}, Adagrad {evals[2]}  [{card}]", flush=True)
    if evals[2] or not 1.0 / ARXIV_CLASSES < acc["accuracy"] <= 1.0:
        raise AssertionError(f"nc_embedding_full evaluation is wrong: {acc}")

    table = tr.state.table
    g = torch.Generator(device="cuda").manual_seed(6)
    grads = torch.randn(table.values.shape, device="cuda", generator=g)
    ids = tr._all_ids
    v1, s1, v2, s2 = (t.clone() for t in (table.values, table.state) * 2)
    adagrad.sparse_adagrad_update_(v1, s1, ids, grads, 0.1)
    adagrad.sparse_adagrad_update_plain_(v2, s2, ids, grads, 0.1)
    torch.cuda.synchronize()
    err = max(float((v1 - v2).abs().max()), float((s1 - s2).abs().max()))
    if err != 0.0 or not torch.equal(v1, v2):
        raise AssertionError(f"sparse_adagrad_update_ over all rows differs from plain by {err}")
    n, d = table.values.shape
    b_ms, b_by = bound_ms(n * 8 + n * d * 4 * 5, n * d * 7, rates)
    from torch.optim.adagrad import adagrad as torch_adagrad

    sparse = torch.sparse_coo_tensor(ids[None], grads, (n, d), is_coalesced=True,
                                     check_invariants=False)
    v3, s3, step = v1.clone(), s1.clone(), torch.zeros((), device="cuda")
    shape = {"rows": n, "d": d, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
             "ms": time_ms(lambda: adagrad.sparse_adagrad_update_(v1, s1, ids, grads, 0.1)),
             "plain_ms": time_ms(lambda: adagrad.sparse_adagrad_update_plain_(
                 v2, s2, ids, grads, 0.1)),
             "library_ms": time_ms(lambda: torch_adagrad(
                 [v3], [sparse], [s3], [step], has_sparse_grad=True, lr=0.1, weight_decay=0.0,
                 lr_decay=0.0, eps=1e-10, maximize=False)),
             "plan": adagrad.tensor_plan(v1, s1, ids, grads)._asdict()}
    print(f"sparse_adagrad_update_, nc_embedding_full all rows ({n} x {d}): max_abs_err {err}  "
          f"kernel {shape['ms'] * 1e3:.2f} us  plain {shape['plain_ms'] * 1e3:.2f} us  "
          f"torch.optim.adagrad (sparse) {shape['library_ms'] * 1e3:.2f} us  bound "
          f"{b_ms * 1e3:.2f} us ({b_by})  plan {plan_text(shape['plan'])}  [{card}]", flush=True)
    return {"gather_rows": {"nc_embedding_full train": train[0],
                            "nc_embedding_full eval": evals[0]},
            "gather_sum": {"nc_embedding_full train": train[1],
                           "nc_embedding_full eval": evals[1]},
            "sparse_adagrad_update_": {"nc_embedding_full train": train[2]},
            "shape": shape}


def compare_fg_leftovers_with_cpu():
    """Small full-graph runs on the card against the CPU: the general
    trainer over the locality adjacency, and EMBEDDING + FEATURE; 2 epochs
    each, every dense leaf (and the table) within rtol 1e-4 / atol 1e-5."""
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    n, e, f = 300, 3000, 16
    rng = np.random.default_rng(5)
    w = (np.arange(n) + 1.0) ** -1.0
    edges = np.stack([rng.integers(0, n, e), rng.choice(n, e, p=w / w.sum())], 1)
    _, features, labels, train_nodes = nc_data(6, edges, n, f, 5, 200)
    graph = build_device_graph(edges, n)
    worst = 0.0
    for name, model, loc in (("locality", nc_model(f, (16, 16, 5)), True),
                             ("EMBEDDING + FEATURE",
                              concat_sage_model(f, 8, (16, 5), feature_bias=True), False)):
        adj = build_full_graph_adjacency(edges, n, locality_reorder=loc)
        cpu, gpu = [NodeClassificationTrainer(model, graph, features, labels, train_nodes,
                                              batch_size=50, seed=1, full_graph=adj,
                                              fg_linear_collapse=False, device=dev)
                    for dev in ("cpu", "cuda")]
        gpu._epoch_permutation = lambda s, _c=cpu, _g=gpu: _c._epoch_permutation(s).to(_g.device)
        for _ in range(2):
            lc, lg = cpu.train_epoch()["loss"], gpu.train_epoch()["loss"]
            if not math.isclose(lc, lg, rel_tol=1e-4):
                raise AssertionError(f"full-graph {name} loss on the card {lg} != CPU {lc}")
        leaves = [(a, b) for a, b in zip(
            tree_leaves([cpu.state.params, cpu.state.opt_state.slots]),
            tree_leaves([gpu.state.params, gpu.state.opt_state.slots]))]
        if cpu.state.table is not None:
            leaves += [(cpu.state.table.values, gpu.state.table.values),
                       (cpu.state.table.state, gpu.state.table.state)]
        for a, b in leaves:
            b = b.detach().cpu()
            worst = max(worst, float((a.detach() - b).abs().max()))
            torch.testing.assert_close(b, a.detach(), rtol=1e-4, atol=1e-5)
    print(f"small full-graph runs over the locality adjacency and with an EMBEDDING table, "
          f"card against CPU, 2 epochs: max abs difference {worst:.3g} (tolerance rtol 1e-4, "
          f"atol 1e-5)", flush=True)


# -- relation corruption (CORRUPT_REL) and bf16 tables and features -----------------

# bf16 against the CPU: after the first 2 batches each state leaf within 2^-5 of its
# norm (||card - cpu|| <= 2^-5 ||cpu||, 4 bf16 ulps); over 2 epochs the losses within
# rtol 2^-6. Elementwise bounds do not hold, nor norms over epochs: a row's gradient is
# the bf16 sum of its occurrences' gradients, which the card's atomics add in any order
# and its reductions and index backward in another than the CPU's, each add rounded to
# bf16; where they cancel the sum moves by many ulps, and Adagrad's step
# lr * g / sqrt(state) turns a moved sum into a step (ROADMAP C10). On an NVIDIA H100
# 80GB HBM3 (700 W), one epoch over the buffer: a leaf 0.07-0.15 of its norm from the
# CPU's, 0.05 between two card runs with atomics, 0 without (f32: 8.6e-7)
BF16_NORM_TOL, BF16_LOSS_RTOL, BF16_BATCHES = 2 ** -5, 2 ** -6, 2
# lp_oocore_bf16's cuts of freebase86m_comet.yaml (all 86,054,151 nodes kept)
OOC_BF16_TRAIN_EDGES, OOC_BF16_EPOCHS = 8_000_000, 1
NC_BF16_EPOCHS = 2


def set_corrupt_rel(raw) -> str:
    raw["model"]["decoder"].setdefault("options", {})["edge_decoder_method"] = "CORRUPT_REL"
    return "model.decoder.options.edge_decoder_method: CORRUPT_REL"


def set_bf16(raw) -> str:
    raw["storage"].setdefault("embeddings", {}).setdefault("options", {})["dtype"] = "bfloat16"
    return "storage.embeddings.options.dtype: bfloat16"


def lp_corrupt_rel(card: str) -> dict:
    """fb15k_237.yaml with relation corruption through marius_train and
    marius_eval (lp_manager's cut): the filtered relation MRR, which
    marius_eval must reproduce; the row gather and Adagrad launch once per
    training batch (the endpoints' rows), the gather twice per evaluation batch."""
    out = lp_manager(card, "lp_corrupt_rel", set_corrupt_rel)
    test = out["test"]
    if not test["mean_rank"] <= NUM_RELS:
        raise AssertionError(f"a relation rank above R = {NUM_RELS}: {test}")
    print(f"lp_corrupt_rel: filtered relation MRR {test['mrr']:.6f} over "
          f"{int(test['num_evaluated'])} ranks against all {NUM_RELS} relations (a uniform "
          f"ranking gives {sum(1 / k for k in range(1, NUM_RELS + 1)) / NUM_RELS:.6f}), "
          f"reproduced by marius_eval  [{card}]", flush=True)
    return out


def lp_bf16(card: str, f32: dict) -> dict:
    """fb15k_237.yaml with a bf16 table through marius_train and marius_eval
    (lp_manager's cut), beside the float32 lp_manager run of this call."""
    out = lp_manager(card, "lp_bf16", set_bf16)
    if out["table_dtype"] != "torch.bfloat16":
        raise AssertionError(f"lp_bf16 trained a {out['table_dtype']} table")
    print(f"lp_bf16: test filtered MRR {out['test']['mrr']:.6f} (float32 lp_manager "
          f"{f32['test']['mrr']:.6f}); table and Adagrad state on the device "
          f"{out['table_bytes'] / 1e6:.3f} MB (float32 {f32['table_bytes'] / 1e6:.3f} MB)  "
          f"[{card}]", flush=True)
    return out


def nc_bf16(card: str, data, f32: dict) -> dict:
    """ogbn_arxiv.yaml with bf16 features and parameters on nc_sampled's
    dataset, 2 epochs, through marius_train and marius_eval: the sampled
    layers' sums through the gather-sum's bf16 entry, beside the float32
    nc_sampled accuracy of this call."""
    out = nc_sampled(card, data, "nc_bf16", set_bf16, NC_BF16_EPOCHS)
    trainer = out["trainer"]
    if trainer.features.dtype != torch.bfloat16:
        raise AssertionError("nc_bf16 must train on bf16 features")
    print(f"nc_bf16: test accuracy {out['test']['accuracy']:.6f} after {NC_BF16_EPOCHS} epochs "
          f"(float32 nc_sampled {f32['test']['accuracy']:.6f} after {NC_SAMPLED_EPOCHS}); "
          f"features on the device {trainer.features.nbytes / 1e6:.3f} MB (float32 "
          f"{trainer.features.numel() * 4 / 1e6:.3f} MB)  [{card}]", flush=True)
    return out


def lp_oocore_bf16(card: str, f32_swaps) -> dict:
    """freebase86m_comet.yaml in bf16 at Freebase86m's 86,054,151 nodes (the
    host table and its Adagrad state 2 x 17.2 GB of bf16), train edges cut to
    8,000,000 and 1 epoch, through marius_train: the swap seconds and GB per
    state beside the float32 lp_oocore's of this call."""
    from marius_tpu_torch.manager import marius_train

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_freebase_shaped(f"{tmp}/dataset", FB86M_NODES, OOC_BF16_TRAIN_EDGES, OOC_EVAL_EDGES)
        cfg = freebase_config(tmp, FB86M_NODES, save_model=False, epochs=OOC_BF16_EPOCHS,
                              dtype="bfloat16")
        print(f"lp_oocore_bf16: freebase86m_comet.yaml with dataset_dir and model_dir "
              f"redirected and storage.embeddings.options.dtype bfloat16; cuts: nodes none "
              f"({FB86M_NODES}), train edges 338,586,276 -> {OOC_BF16_TRAIN_EDGES}, valid and "
              f"test {OOC_EVAL_EDGES} each, num_epochs 10 -> {OOC_BF16_EPOCHS}, save_model "
              f"off; dataset written in {time.perf_counter() - t0:.2f} s", flush=True)
        torch.cuda.empty_cache()
        with EpochProbe() as probe:
            t0 = time.perf_counter()
            out = marius_train(cfg)   # device=None: the GPU
            total = time.perf_counter() - t0
        buf = out["runtime"].trainer.buffer
        if buf.dtype != torch.bfloat16 or buf.host_values.dtype != np.uint16:
            raise AssertionError("lp_oocore_bf16 must train a bf16 buffer")
        print(f"lp_oocore_bf16: marius_train {total:.2f} s, set-up before the first epoch "
              f"{probe.first_epoch_at - t0:.2f} s; buffer {buf.buffer_rows} x {buf.dim} bf16 "
              f"rows ({2 * buf.buffer_rows * buf.dim * 2 / 1e9:.2f} GB with its state); host "
              f"RSS peak {resource_peak_gib():.2f} GiB  [{card}]", flush=True)
        counts = report_oocore_epochs("lp_oocore_bf16", out, probe, card, OOC_BF16_EPOCHS)
        del out, buf
    # against lp_oocore's first epoch, which also admits every partition with its Adagrad
    # state still zero (zero-filled on the card, not copied); the evictions move the rows
    # each state's edges made dirty, 4 times fewer here
    (s16, h16, d16), (s32, h32, d32) = counts["swaps"][0], f32_swaps[0]
    print(f"lp_oocore_bf16 swaps per state: {s16:.3f} s, {h16:.3f} GB to and {d16:.3f} GB from "
          f"the device (float32 lp_oocore, its first epoch: {s32:.3f} s, {h32:.3f} GB and "
          f"{d32:.3f} GB)  [{card}]", flush=True)
    return counts


def time_bf16_gather(gather, rows: int, dim: int, k: int, batches: int, rates, dev,
                     distinct: bool) -> dict:
    """The row gather's bf16 entry at one shape: ``batches`` batches of ``k``
    ids into a (rows, dim) bf16 table (uniform, as the dense-accumulate
    branch gathers them, or sorted distinct ids padded with the row count, as
    the dedup branch does), bit for bit against the plain version, timed
    beside index_select and the bf16 bytes' bound."""
    from marius_tpu_torch.ops.unique import unique_padded

    g = torch.Generator(device=dev).manual_seed(12)
    table = torch.empty((rows, dim), device=dev, dtype=torch.bfloat16).normal_(generator=g)
    ids = [torch.randint(0, rows, (k,), device=dev, generator=g) for _ in range(batches)]
    if distinct:
        ids = [unique_padded(b, k, rows).ids for b in ids]
    err = max(gather_max_err(gather, table, b.to(idt)) for b in ids[:1]
              for idt in (torch.int64, torch.int32))
    out = time_gather(gather, table, ids, rates)
    out["max_abs_err"] = err
    del table
    torch.cuda.empty_cache()
    return out


def bf16_kernel_shapes(gather, adagrad, adj, nc_trainer, rates, card) -> dict:
    """Each kernel's bf16 entry, bit for bit against its plain version and
    timed beside its bound (the bf16 bytes at the card's rate) and its
    one-call PyTorch equivalent: the row gather at every vector width (2-byte
    vectors for odd widths; tables 2, 4 and 6 bytes into their storage), at
    the flagship table (14,541 x 50) and at an out-of-core batch (30,000
    distinct ids into 43,027,080 x 100); Adagrad at the flagship (every row,
    as the dense-accumulate branch runs it) and on Freebase86m's bf16 buffer
    pair; the gather-sum at nc_bf16's sampled layer 0 and over the whole
    arxiv adjacency. Returns each kernel's bf16 shapes."""
    from marius_tpu_torch.data.full_graph import nbr_sum_layout
    from marius_tpu_torch.data.samplers.neighbor import sample_neighbor_batch
    from marius_tpu_torch.ops.cuda import nbr_sum as ns

    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(14)
    n = 1009
    for d in GATHER_DIMS:
        base = torch.randn(n * d + 3, device=dev, generator=g).to(bf)
        ids = torch.randint(-3, n + 3, (4099,), device=dev, generator=g)
        for off in (0, 1, 2, 3):
            table = base[off:off + n * d].view(n, d)
            for k in (1, 33, 4099):
                for idt in (torch.int64, torch.int32):
                    gather_max_err(gather, table, ids[:k].to(idt))
    rows = {"flagship": time_bf16_gather(gather, NUM_NODES, DIM, GATHER_IDS, 1, rates, dev,
                                         distinct=False),
            "out_of_core": time_bf16_gather(gather, OOC_ROWS, FB86M_DIM, OOC_IDS, OOC_BATCHES,
                                            rates, dev, distinct=True)}

    views_err = check_adagrad_views(adagrad, dev, g, bf)
    vals = torch.randn(NUM_NODES, DIM, device=dev, generator=g).to(bf)
    state = torch.rand(NUM_NODES, DIM, device=dev, generator=g).to(bf)
    ids = torch.arange(NUM_NODES, device=dev)
    grads = (torch.randn(NUM_NODES, DIM, device=dev, generator=g) * 0.1).to(bf)
    grads[torch.rand(NUM_NODES, device=dev, generator=g) < 0.5] = 0
    v1, s1, v2, s2 = vals.clone(), state.clone(), vals.clone(), state.clone()
    adagrad.sparse_adagrad_update_(v1, s1, ids, grads, 0.1)
    adagrad.sparse_adagrad_update_plain_(v2, s2, ids, grads, 0.1)
    torch.cuda.synchronize()
    if not (torch.equal(v1.view(torch.int16), v2.view(torch.int16))
            and torch.equal(s1.view(torch.int16), s2.view(torch.int16))):
        raise AssertionError("the bf16 Adagrad kernel differs from plain at the flagship")
    from torch.optim.adagrad import adagrad as torch_adagrad

    sparse = torch.sparse_coo_tensor(ids[None], grads, (NUM_NODES, DIM), is_coalesced=True,
                                     check_invariants=False)
    v3, s3, step = vals.clone(), state.clone(), torch.zeros((), device=dev)

    def library():
        torch_adagrad([v3], [sparse], [s3], [step], has_sparse_grad=True, lr=0.1,
                      weight_decay=0.0, lr_decay=0.0, eps=1e-10, maximize=False)

    b_ms, b_by = bound_ms(NUM_NODES * 8 + NUM_NODES * DIM * 2 * 5, NUM_NODES * DIM * 7, rates)
    err = max(float((v1.float() - v2.float()).abs().max()),
              float((s1.float() - s2.float()).abs().max()), views_err)
    flag = {"max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "plan": adagrad.tensor_plan(v1, s1, ids, grads)._asdict(),
            "ms": time_ms(lambda: adagrad.sparse_adagrad_update_(v1, s1, ids, grads, 0.1)),
            "plain_ms": time_ms(lambda: adagrad.sparse_adagrad_update_plain_(v2, s2, ids, grads,
                                                                             0.1)),
            "library_ms": library_or_none(library, "torch.optim.adagrad (sparse)", bf),
            "k": NUM_NODES, "d": DIM}
    del vals, state, v1, s1, v2, s2, v3, s3, grads, sparse
    torch.cuda.empty_cache()
    adagrad_rows = {"flagship": flag, "out_of_core": adagrad_out_of_core(adagrad, dev, rates, bf)}

    b = nc_trainer.batch_size
    nb = sample_neighbor_batch(nc_trainer._batch_draws(), nc_trainer.graph,
                               nc_trainer.train_nodes[:b], torch.ones(b, dtype=torch.bool,
                                                                      device=dev),
                               nc_trainer.nbr_configs, nc_trainer.hop_caps)
    layer0 = time_layer_sum(nb.layers[0], nb.node_ids[0].shape[0], NC_DIM, rates, dev, bf)
    whole = time_layout_sum(nbr_sum_layout(adj), ARXIV_NODES, NC_DIM, rates,
                            "whole arxiv sum, bf16 x", card, bf)
    sums = {"sampled_layer0": layer0, "whole_sum": whole}

    def lib(r):
        return "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"

    for name, shapes, yard in (("gather_rows", rows, "index_select"),
                               ("sparse_adagrad_update_", adagrad_rows,
                                "torch.optim.adagrad (sparse)"),
                               ("gather_sum", sums, "embedding_bag / torch.sparse.mm")):
        for shape, r in shapes.items():
            plan = f"  plan {plan_text(r['plan'])}" if "plan" in r else ""
            print(f"{name} bf16, {shape}: max_abs_err {r['max_abs_err']}  kernel "
                  f"{r['ms'] * 1e3:.2f} us  plain {r['plain_ms'] * 1e3:.2f} us  {yard} "
                  f"{lib(r)}  bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}){plan}  "
                  f"[{card}]", flush=True)
    for shapes in (rows, adagrad_rows, sums):
        for r in shapes.values():
            if r["max_abs_err"] != 0.0:
                raise AssertionError(f"a bf16 kernel differs from its plain version: {r}")
    return {"gather_rows": rows, "sparse_adagrad_update_": adagrad_rows, "gather_sum": sums}


def _seq_relations(trainer, r: int, seed: int = 21):
    """Relation negatives from a numpy stream, the same sequence on any device."""
    rng = np.random.default_rng(seed)
    c, n = trainer.neg_config.num_chunks, trainer.neg_config.negatives_per_positive
    return lambda *_: torch.from_numpy(rng.integers(0, r, (c, n))).to(trainer.device)


def _random_relations(params, seed: int = 5) -> None:
    """Distinct relations: DistMult's start at ones, where every relation
    negative scores as its positive and the table gradients cancel to noise."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name in sorted(params["decoder"]):
            p = params["decoder"][name]
            p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, tuple(p.shape)).astype(np.float32)))


def _close_on_cpu(pairs, rtol, atol, what) -> float:
    worst = 0.0
    for a, b in pairs:
        a = torch.as_tensor(a).detach().float().cpu()
        b = torch.as_tensor(b).detach().float().cpu()
        worst = max(worst, float((a - b).abs().max()))
        torch.testing.assert_close(b, a, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return worst


def _normwise_on_cpu(pairs, tol, what, joint: bool = False) -> tuple:
    """(worst ||card - cpu|| / ||cpu||, worst elementwise difference) over the
    leaves, or over all leaves as one vector (``joint``); raises beyond ``tol``."""
    worst = elem = 0.0
    pairs = [(torch.as_tensor(a).detach().float().cpu().reshape(-1),
              torch.as_tensor(b).detach().float().cpu().reshape(-1)) for a, b in pairs]
    if joint:
        pairs = [(torch.cat([a for a, _ in pairs]), torch.cat([b for _, b in pairs]))]
    for a, b in pairs:
        rel = float((a - b).norm() / a.norm().clamp(min=1e-30))
        worst, elem = max(worst, rel), max(elem, float((a - b).abs().max()))
        if not rel <= tol:
            raise AssertionError(f"{what}: a leaf of shape {tuple(a.shape)} differs by {rel:.3g} "
                                 f"of its norm (tolerance {tol})")
    return worst, elem


def compare_rel_and_bf16_with_cpu():
    """Small CORRUPT_REL runs on the card against the CPU, in memory (both
    table-update branches) and over the partition buffer (BETA), with the same
    relation negatives and draws and distinct relations, 2 epochs (rtol 1e-4,
    atol 1e-5); then small bf16 runs (LP in memory, both branches; LP over the
    buffer; full-graph NC on the general path, bf16 gather-sums) at the bf16
    tolerance."""
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.storage import transfer
    from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer
    from marius_tpu_torch.train.nc import NodeClassificationTrainer
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    n, r, d, e = 600, 12, 32, 4000
    edges = synthetic_edges(13, n, r, e)
    cfg = NegativeSamplingConfig(num_chunks=4, negatives_per_positive=20, degree_fraction=0.25)

    def mem_pair(method, dtype, dense, rows=edges):
        cpu, gpu = ts = [LinkPredictionTrainer(lp_model(r, d, "DISTMULT", method), n, r, rows,
                                               cfg, batch_size=200, seed=1, dtype=dtype,
                                               device=dev) for dev in ("cpu", "cuda")]
        for t in ts:
            t.dense_accum = dense
            t._sample_negatives = (lambda edges_b, inverse, _c=t.neg_config:
                                   _batch_negatives(_c, edges_b, n, inverse))
            t._sample_rel_negatives = _seq_relations(t, r)
            _random_relations(t.state.params)
        gpu._epoch_permutation = lambda s: cpu._epoch_permutation(s).to(gpu.device)
        return cpu, gpu

    def buffer_pair(method, dtype, rows=edges):
        ts = [PartitionBufferLPTrainer(lp_model(r, d, "COMPLEX", method), n, r, rows, cfg,
                                       batch_size=200, num_partitions=8, buffer_capacity=4,
                                       ordering="BETA", seed=1, dtype=dtype, device=dev)
              for dev in ("cpu", "cuda")]
        for t in ts:
            t._in_buffer_draws = lambda step, inverse, _t=t: injected_draws(_t, step, inverse)
            t._rel_negatives = _seq_relations(t, r)
            _random_relations(t.params)
        return ts

    def run(cpu, gpu, epochs, loss_rtol, what):
        for _ in range(epochs):
            lc, lg = cpu.train_epoch()["loss"], gpu.train_epoch()["loss"]
            if not math.isclose(lc, lg, rel_tol=loss_rtol):
                raise AssertionError(f"{what}: loss on the card {lg} != on the CPU {lc}")

    worst = 0.0
    for dense in (True, False):
        cpu, gpu = mem_pair("CORRUPT_REL", torch.float32, dense)
        if cpu.unique_cap != 2 * 200:
            raise AssertionError("CORRUPT_REL must gather the endpoints only")
        run(cpu, gpu, 2, 1e-4, f"CORRUPT_REL in memory, dense_accum={dense}")
        worst = max(worst, _close_on_cpu(
            [(cpu.state.table.values, gpu.state.table.values),
             (cpu.state.table.state, gpu.state.table.state)]
            + list(zip(tree_leaves(cpu.state.params), tree_leaves(gpu.state.params))),
            1e-4, 1e-5, "CORRUPT_REL in memory"))
    cpu, gpu = buffer_pair("CORRUPT_REL", torch.float32)
    run(cpu, gpu, 2, 1e-4, "CORRUPT_REL over the buffer")
    worst = max(worst, _close_on_cpu(
        [(cpu.buffer.host_values, gpu.buffer.host_values),
         (cpu.buffer.host_state, gpu.buffer.host_state)]
        + list(zip(tree_leaves(cpu.params), tree_leaves(gpu.params))),
        1e-4, 1e-5, "CORRUPT_REL over the buffer"))
    print(f"small CORRUPT_REL runs, card against CPU (in memory, both update branches; "
          f"over the buffer, BETA; 2 epochs): max abs difference {worst:.3g} (tolerance rtol "
          f"1e-4, atol 1e-5)", flush=True)

    worst = [(0.0, 0.0)]
    bf = torch.bfloat16
    short = edges[:BF16_BATCHES * 200]   # 2 batches of 200: an epoch of them
    for dense in (True, False):
        cpu, gpu = mem_pair("CORRUPT_NODE", bf, dense)
        run(cpu, gpu, 2, BF16_LOSS_RTOL, f"bf16 in memory, dense_accum={dense}")
        cpu, gpu = mem_pair("CORRUPT_NODE", bf, dense, short)
        run(cpu, gpu, 1, BF16_LOSS_RTOL, f"bf16 in memory, 2 batches, dense_accum={dense}")
        worst.append(_normwise_on_cpu(
            [(cpu.state.table.values, gpu.state.table.values),
             (cpu.state.table.state, gpu.state.table.state)]
            + list(zip(tree_leaves(cpu.state.params), tree_leaves(gpu.state.params))),
            BF16_NORM_TOL, "bf16 LP in memory, 2 batches"))
    cpu, gpu = buffer_pair("CORRUPT_NODE", bf)
    run(cpu, gpu, 1, BF16_LOSS_RTOL, "bf16 over the buffer")
    cpu, gpu = buffer_pair("CORRUPT_NODE", bf, short)
    run(cpu, gpu, 1, BF16_LOSS_RTOL, "bf16 over the buffer, 2 batches")
    host = lambda t, a: transfer.as_tensor(getattr(t.buffer, a), bf)  # noqa: E731
    worst.append(_normwise_on_cpu(
        [(host(cpu, "host_values"), host(gpu, "host_values")),
         (host(cpu, "host_state"), host(gpu, "host_state"))],
        BF16_NORM_TOL, "bf16 LP over the buffer, 2 batches"))
    nn_, ne, f = 300, 3000, 16
    rng = np.random.default_rng(5)
    w = (np.arange(nn_) + 1.0) ** -1.0
    nc_edges = np.stack([rng.integers(0, nn_, ne), rng.choice(nn_, ne, p=w / w.sum())], 1)
    _, features, labels, train_nodes = nc_data(6, nc_edges, nn_, f, 5, 200)
    adj, graph = build_full_graph_adjacency(nc_edges, nn_), build_device_graph(nc_edges, nn_)
    for nodes, epochs in ((train_nodes, 2), (train_nodes[:BF16_BATCHES * 50], 1)):
        cpu, gpu = [NodeClassificationTrainer(nc_model(f, (16, 16, 5)), graph, features, labels,
                                              nodes, batch_size=50, seed=1, full_graph=adj,
                                              fg_linear_collapse=False, dtype=bf, device=dev)
                    for dev in ("cpu", "cuda")]
        gpu._epoch_permutation = lambda s, _c=cpu, _g=gpu: _c._epoch_permutation(s).to(_g.device)
        run(cpu, gpu, epochs, BF16_LOSS_RTOL, f"bf16 full-graph NC, {len(nodes)} train nodes")
    # the dense parameters as one vector: Adam's first steps move each element by about
    # lr * sign(g), so a bias whose gradient is near 0 (the biases start at 0) flips
    worst.append(_normwise_on_cpu(
        zip(tree_leaves(cpu.state.params), tree_leaves(gpu.state.params)),
        BF16_NORM_TOL, "bf16 full-graph NC, 2 batches", joint=True))
    print(f"small bf16 runs, card against CPU (LP in memory, both update branches, 2 epochs; "
          f"LP over the buffer, 1 epoch; full-graph NC, general path, 2 epochs): losses within "
          f"rtol 2^-6; after 2 batches the worst leaf (NC: all parameters as one vector) "
          f"{max(w for w, _ in worst):.3g} of its norm (tolerance 2^-5), the largest element "
          f"difference "
          f"{max(e for _, e in worst):.3g}", flush=True)


# -- the command-line tools (tools_cli) --------------------------------------------

TOOLS_PROFILE_BATCHES, TOOLS_PREDICT_LINES = 20, 1000
# Freebase86m's published train edges (the config generator reads only the node count)
FB86M_TRAIN_EDGES = 338_586_276
TOOLS_METRIC_KEYS = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")


def write_fb15k_raw(directory: Path) -> list:
    """Raw tab-separated string-id triples of FB15K-237's sizes: the uniform
    edges of write_fb15k_shaped (seed 0) as ids like /m/00001 and /rel/7."""
    edges = synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES + FB_VALID + FB_TEST).tolist()
    cuts = {"train.txt": (0, NUM_EDGES), "valid.txt": (NUM_EDGES, NUM_EDGES + FB_VALID),
            "test.txt": (NUM_EDGES + FB_VALID, len(edges))}
    directory.mkdir(parents=True)
    paths = []
    for name, (a, b) in cuts.items():
        paths.append(directory / name)
        paths[-1].write_text("".join(f"/m/{s:05d}\t/rel/{r}\t/m/{d:05d}\n"
                                     for s, r, d in edges[a:b]))
    return paths


def dir_bytes(directory: Path) -> dict:
    return {str(p.relative_to(directory)): p.read_bytes()
            for p in sorted(directory.rglob("*")) if p.is_file()}


def imported_modules(stderr: str) -> set:
    """The modules a ``python -X importtime`` process imported."""
    return {line.rsplit("|", 1)[-1].strip() for line in stderr.splitlines()
            if line.startswith("import time:")}


class ToolsRun:
    """Runs the port's commands in this process as a shell runs them
    (``marius_tpu_torch.tools.cli.main(argv)``; ``device`` None: the GPU),
    each with the launch counters set to 0 just before it and read just
    after; keeps each part's launches and echoes its standard output."""

    def __init__(self, device=None):
        from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum

        self.device = device
        self.counters = {"gather_rows": gather, "sparse_adagrad_update_": adagrad,
                         "gather_sum": nbr_sum}
        self.launches = {name: {} for name in self.counters}

    def __call__(self, part: str, argv: list, expect_rc: int = 0):
        import contextlib
        import io

        from marius_tpu_torch.tools import cli

        for c in self.counters.values():
            c.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, device=self.device)
        dt = time.perf_counter() - t0
        counts = {name: c.launches for name, c in self.counters.items()}
        out = buf.getvalue().splitlines()
        for line in out[-6:]:
            print(f"  {part} | {line[:300]}", flush=True)
        if rc != expect_rc:
            raise AssertionError(f"tools_cli {part}: {argv[0]} returned {rc}")
        for name, n in counts.items():
            self.launches[name][f"tools_cli {part}"] = n
        return out, dt, counts


def tools_cli(card: str, device=None) -> dict:
    """The port's commands end to end at fb15k_237.yaml's width on raw
    FB15K-237-shaped files: preprocess (in memory and chunked, the same
    bytes), config_generator (the card's memory; Freebase86m's stats), train,
    eval, predict (a split and a raw input file), postprocess (bin and csv),
    verify_baselines --synthetic, torch.profiler around 20 of the trained
    model's batches, and env_info and db2graph in processes of their own.
    Returns {kernel: {part: launches}}. ``device`` None is the GPU; "cpu"
    rehearses the in-process steps on the CPU (the kernels' plain versions;
    the subprocess checks, which read the card, are left out)."""
    from marius_tpu_torch.reporting import profiling
    from marius_tpu_torch.storage.dataset import DatasetStats, load_split, load_stats, save_stats
    from marius_tpu_torch.tools import config_generator
    from marius_tpu_torch.tools.predict import _load_input_edges
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    here = Path(__file__).resolve().parent
    run = ToolsRun(device)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        # 1. preprocess, in memory and chunked
        t0 = time.perf_counter()
        raw_paths = write_fb15k_raw(tmp / "raw")
        rows = NUM_EDGES + FB_VALID + FB_TEST
        print(f"tools_cli: raw files of FB15K-237's sizes ({NUM_EDGES} / {FB_VALID} / {FB_TEST} "
              f"lines, string ids, seed 0) written in {time.perf_counter() - t0:.2f} s",
              flush=True)
        outputs = {}
        for tag, extra in (("in memory", []), ("chunked", ["--chunked"])):
            out_dir = tmp / f"ds_{tag.replace(' ', '_')}"
            _, dt, counts = run(f"preprocess {tag}", ["preprocess", "--edges", *map(str, raw_paths),
                                                       "--output_directory", str(out_dir), *extra])
            if any(counts.values()):
                raise AssertionError(f"preprocess launched kernels: {counts}")
            outputs[tag] = dir_bytes(out_dir)
            print(f"tools_cli preprocess {tag}: {dt:.3f} s, {rows / dt:.1f} rows/s", flush=True)
        mem, chunked = outputs["in memory"], outputs["chunked"]
        if sorted(mem) != sorted(chunked) or any(mem[k] != chunked[k] for k in mem):
            raise AssertionError(f"preprocess in memory and --chunked wrote different files: "
                                 f"{sorted(mem)} / {sorted(chunked)}")
        ds = tmp / "ds_in_memory"
        stats = load_stats(str(ds))
        if (stats.num_nodes, stats.num_relations, stats.num_train, stats.num_valid,
                stats.num_test) != (NUM_NODES, NUM_RELS, NUM_EDGES, FB_VALID, FB_TEST):
            raise AssertionError(f"preprocessed stats {stats}")
        print(f"tools_cli preprocess: {len(mem)} files ({sorted(mem)}), byte-identical in memory "
              f"and chunked; {stats.num_nodes} nodes, {stats.num_relations} relations",
              flush=True)

        # 2. config generator against the card's memory
        hbm = config_generator._device_hbm_bytes(device)
        gen = tmp / "generated.yaml"
        run("config_generator", ["config_generator", str(ds), "--output", str(gen)])
        if "embeddings" in yaml.safe_load(gen.read_text())["storage"]:
            raise AssertionError("config_generator sized a partition buffer for FB15K-237")
        fb86 = tmp / "freebase86m_stats"
        save_stats(str(fb86), DatasetStats(num_nodes=FB86M_NODES, num_edges=FB86M_TRAIN_EDGES,
                                           num_relations=FB86M_RELS, num_edge_cols=3,
                                           num_train=FB86M_TRAIN_EDGES))
        run("config_generator", ["config_generator", str(fb86), "--embedding_dim", "100",
                                 "--output", str(gen)])
        emb = yaml.safe_load(gen.read_text())["storage"].get("embeddings")
        want = {"type": "PARTITION_BUFFER", "options": {
            "num_partitions": 16, "buffer_capacity": 8, "edge_bucket_ordering": "COMET"}}
        if emb != want:
            raise AssertionError(f"config_generator on Freebase86m's stats gave {emb}")
        table = FB86M_NODES * 100 * 4 * 2
        print(f"tools_cli config_generator: read {hbm:.0f} bytes of device memory; FB15K-237: "
              f"no partition buffer; Freebase86m (d = 100): table and Adagrad state "
              f"{table / 1e9:.2f} GB against 0.6 x {hbm / 1e9:.2f} GB -> {emb['options']}  "
              f"[{card}]", flush=True)

        # 3. train fb15k_237.yaml, 1 epoch
        with open(here / "examples" / "configuration" / "fb15k_237.yaml") as f:
            raw = yaml.safe_load(f)
        epochs_in_yaml = raw["training"]["num_epochs"]
        raw["storage"]["dataset"]["dataset_dir"] = str(ds)
        raw["storage"]["model_dir"] = str(tmp / "model")
        raw["training"]["num_epochs"] = 1
        cfg = tmp / "fb15k_237.yaml"
        cfg.write_text(yaml.safe_dump(raw))
        epochs = []
        train_epoch = LinkPredictionTrainer.train_epoch

        def recorded(self):
            stats = train_epoch(self)
            epochs.append((self, stats))
            return stats

        LinkPredictionTrainer.train_epoch = recorded
        try:
            out, dt, counts = run("train", ["train", str(cfg)])
        finally:
            LinkPredictionTrainer.train_epoch = train_epoch
        trained = json.loads(out[-1])
        trainer, e = epochs[0]
        if trainer.device.type != ("cuda" if device is None else torch.device(device).type):
            raise AssertionError("train did not run on the GPU")
        print(f"tools_cli train: examples/configuration/fb15k_237.yaml with dataset_dir and "
              f"model_dir redirected; one cut: num_epochs {epochs_in_yaml} -> 1. Epoch: loss "
              f"{e['loss']:.6f}  {e['epoch_time_s']:.4f} s  {e['edges_per_sec']:.1f} edges/s; "
              f"command {dt:.2f} s; test MRR {trained['mrr']:.6f}  [{card}]", flush=True)
        batches = trainer.num_batches
        eval_batches = -(-FB_VALID // BATCH) + -(-FB_TEST // BATCH)
        if counts != {"gather_rows": batches + 2 * eval_batches,
                      "sparse_adagrad_update_": batches, "gather_sum": 0}:
            raise AssertionError(f"train launched {counts}, expected {batches} training "
                                 f"batches and {eval_batches} evaluation batches")

        # 4. eval, predict, postprocess
        out, dt, counts = run("eval", ["eval", str(cfg)])
        evaluated = json.loads(out[-1])
        test_batches = -(-FB_TEST // BATCH)
        if any(evaluated[k] != trained[k] for k in TOOLS_METRIC_KEYS):
            raise AssertionError(f"eval gave {evaluated}, train {trained}")
        if counts != {"gather_rows": 2 * test_batches, "sparse_adagrad_update_": 0,
                      "gather_sum": 0}:
            raise AssertionError(f"eval launched {counts}")
        print(f"tools_cli eval: {dt:.2f} s; reproduced train's test metrics exactly", flush=True)
        pred = tmp / "predict"
        _, dt, counts = run("predict", ["predict", "--config", str(cfg), "--output_dir",
                                        str(pred), "--save_ranks", "--save_scores"])
        metrics = {}
        for line in (pred / "metrics.txt").read_text().splitlines():
            k, v = line.split(": ")
            metrics[k] = v
        if any(float(metrics[k]) != evaluated[k] for k in TOOLS_METRIC_KEYS):
            raise AssertionError(f"predict's metrics.txt {metrics} differ from eval's {evaluated}")
        ranks = np.loadtxt(pred / "ranks.csv", delimiter=",", ndmin=2)
        scores = np.loadtxt(pred / "scores.csv", delimiter=",", ndmin=2)
        mrr_err = abs(float(np.mean(1.0 / ranks)) - evaluated["mrr"])
        if ranks.shape[0] != FB_TEST or scores.shape != ranks.shape or mrr_err > 1e-6 or \
                not np.isfinite(scores).all():
            raise AssertionError(f"ranks {ranks.shape}, scores {scores.shape}, mean 1/rank off "
                                 f"the MRR by {mrr_err}")
        if counts["gather_rows"] != 4 * test_batches or counts["sparse_adagrad_update_"]:
            raise AssertionError(f"predict launched {counts}")
        print(f"tools_cli predict: {dt:.2f} s; metrics.txt equals eval's; ranks.csv "
              f"{ranks.shape[0]} rows x {ranks.shape[1]} directions, mean 1/rank off the MRR "
              f"by {mrr_err:.2e}", flush=True)
        query = tmp / "query.tsv"
        query.write_text("".join(raw_paths[2].read_text().splitlines(True)[:TOOLS_PREDICT_LINES]))
        pred_raw = tmp / "predict_raw"
        out, dt, counts = run("predict input_file", [
            "predict", "--config", str(cfg), "--output_dir", str(pred_raw), "--save_ranks",
            "--input_file", str(query)])
        mapped = _load_input_edges(str(query), str(ds))
        if not np.array_equal(mapped, load_split(str(ds), "test")[:TOOLS_PREDICT_LINES]):
            raise AssertionError("the raw input's ids did not map to the preprocessed test edges")
        res = json.loads(out[-1])
        ranks = np.loadtxt(pred_raw / "ranks.csv", delimiter=",", ndmin=2)
        if res["num_evaluated"] != 2 * TOOLS_PREDICT_LINES or ranks.shape[0] != TOOLS_PREDICT_LINES \
                or not 0.0 < res["mrr"] <= 1.0 or counts["gather_rows"] == 0:
            raise AssertionError(f"predict --input_file: {res}, ranks {ranks.shape}, {counts}")
        print(f"tools_cli predict --input_file: {TOOLS_PREDICT_LINES} raw test lines through the "
              f"mapping files in {dt:.2f} s, MRR {res['mrr']:.6f}", flush=True)
        values = np.load(tmp / "model" / "table__values.npy")
        _, dt_bin, _ = run("postprocess bin", ["postprocess", "--model_dir", str(tmp / "model"),
                                               "--output_dir", str(tmp / "emb_bin"),
                                               "--format", "bin"])
        if (tmp / "emb_bin" / "embeddings.bin").read_bytes() != values.astype(np.float32).tobytes():
            raise AssertionError("postprocess --format bin differs from the checkpoint's table")
        _, dt_csv, _ = run("postprocess csv", ["postprocess", "--model_dir", str(tmp / "model"),
                                               "--output_dir", str(tmp / "emb_csv"),
                                               "--dataset_dir", str(ds)])
        lines = (tmp / "emb_csv" / "embeddings.csv").read_text().splitlines()
        mapping = np.genfromtxt(ds / "nodes" / "node_mapping.txt", delimiter=",", dtype=str)
        rows_by_id = {line.split(",", 1)[0]: line for line in lines}
        for raw_id, new_id in mapping[:: max(1, len(mapping) // 100)]:
            want_line = raw_id + "," + ",".join(f"{x:.6f}" for x in values[int(new_id)])
            if rows_by_id.get(raw_id) != want_line:
                raise AssertionError(f"embeddings.csv row of {raw_id} is not table row {new_id}")
        if len(lines) != len(values) or not set(mapping[:, 0]) <= set(rows_by_id):
            raise AssertionError(f"embeddings.csv has {len(lines)} rows for {len(values)} table "
                                 "rows, or misses raw ids")
        print(f"tools_cli postprocess: bin ({dt_bin:.2f} s) equals the checkpoint's "
              f"{values.shape} table; csv ({dt_csv:.2f} s) one row per table row, raw ids from "
              f"node_mapping.txt ({len(mapping)} nodes)", flush=True)

        # 5. verify_baselines on the synthetic twins, 10 epochs
        out, dt, counts = run("verify_baselines", ["verify_baselines", "--synthetic", "--dataset",
                                                   "all", "--data-root", str(tmp / "vb")])
        reports = [json.loads(line) for line in out if line.startswith("{")]
        if [r["dataset"] for r in reports] != ["fb15k_237", "ogbn_arxiv"] or not all(
                r["passed"] for r in reports) or min(counts.values()) == 0:
            raise AssertionError(f"verify_baselines: {reports}, launches {counts}")
        print(f"tools_cli verify_baselines --synthetic: {dt:.2f} s, "
              + "; ".join(f"{r['dataset']} {r['metric']} {r['value']} (>= {r['threshold']})"
                          for r in reports) + f"  [{card}]", flush=True)

        # 6. torch.profiler around 20 batches of the trained model
        b = trainer.batch_size
        perm = trainer._epoch_permutation(1)
        shuffled, masks = trainer.edges[perm], perm < trainer.num_edges
        for c in run.counters.values():
            c.launches = 0
        with profiling.trace(str(tmp / "trace"), device=device):
            for i in range(TOOLS_PROFILE_BATCHES):
                trainer._batch_step(shuffled[i * b:(i + 1) * b], masks[i * b:(i + 1) * b])
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
        for name, c in run.counters.items():
            run.launches[name]["tools_cli profiling"] = c.launches
        kernels = profiling.op_breakdown(str(tmp / "trace"), top=100_000, category="kernel")
        names = [k["op"] for k in kernels]
        for want_kernel in ("gather_rows_kernel", "adagrad_kernel"):
            if trainer.device.type == "cuda" and not any(want_kernel in n for n in names):
                raise AssertionError(f"op_breakdown lists no {want_kernel}: {names[:20]}")
        print(f"tools_cli profiling: {TOOLS_PROFILE_BATCHES} batches under "
              f"profiling.trace(), op_breakdown's top ten device operations (us per batch):",
              flush=True)
        for k in kernels[:10]:
            print(f"  {k['total_us'] / TOOLS_PROFILE_BATCHES:10.2f}  {k['op'][:100]}", flush=True)
        total_us = sum(k["total_us"] for k in kernels)
        print(f"tools_cli profiling: {total_us / TOOLS_PROFILE_BATCHES:.2f} us of device "
              f"kernels per batch in {len(kernels)} kinds; the port's own (us per batch):",
              flush=True)
        for k in kernels:
            if "gather_rows_kernel" in k["op"] or "adagrad_kernel" in k["op"]:
                print(f"  {k['total_us'] / TOOLS_PROFILE_BATCHES:10.2f}  rank "
                      f"{names.index(k['op']) + 1}  {k['op'][:100]}  [{card}]", flush=True)

        # 7. env_info and db2graph in processes of their own, importing no JAX
        if device is None:
            proc = subprocess.run([sys.executable, "-X", "importtime", "-m",
                                   "marius_tpu_torch.tools.cli", "env_info"], cwd=here,
                                  capture_output=True, text=True, timeout=300, check=True)
            info = yaml.safe_load(proc.stdout)
            kind = torch.cuda.get_device_name(0)
            if kind not in proc.stdout or info["devices"]["platform"] != "gpu" or \
                    info["devices"]["count"] != torch.cuda.device_count():
                raise AssertionError(f"env_info does not name the card {kind}: {info}")
            modules = imported_modules(proc.stderr)
            import sqlite3
            db = tmp / "graph.db"
            conn = sqlite3.connect(db)
            conn.execute("CREATE TABLE follows (a TEXT, rel TEXT, b TEXT)")
            conn.executemany("INSERT INTO follows VALUES (?,?,?)",
                             [("u1", "follows", "u2"), ("u2", "follows", "u3"),
                              ("u3", "likes", "u1")])
            conn.commit()
            conn.close()
            db_cfg = tmp / "db.yaml"
            db_cfg.write_text(yaml.safe_dump({"db_type": "sqlite", "connection": {
                "database": str(db)}, "edge_queries": ["SELECT a, rel, b FROM follows"]}))
            proc = subprocess.run([sys.executable, "-X", "importtime", "-m",
                                   "marius_tpu_torch.tools.cli", "db2graph", "--config_path",
                                   str(db_cfg), "--output_directory", str(tmp / "db_out")],
                                  cwd=here, capture_output=True, text=True, timeout=300, check=True)
            if (tmp / "db_out" / "edges.txt").read_text() != \
                    "u1\tfollows\tu2\nu2\tfollows\tu3\nu3\tlikes\tu1\n":
                raise AssertionError("db2graph wrote another edges.txt")
            modules |= imported_modules(proc.stderr)
            bad = sorted(m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "marius_tpu"))
            if bad or "marius_tpu_torch.tools.env_info" not in modules:
                raise AssertionError(f"the command processes imported {bad}")
            print(f"tools_cli subprocesses: env_info names {kind} "
                  f"({info['devices']['count']} device); db2graph wrote the expected "
                  f"edges.txt; {len(modules)} modules imported, none of JAX or marius_tpu",
                  flush=True)
    return run.launches


# -- the mesh: ranks of a torch.distributed process group -----------------------

def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _assert_close(got, want, what, rtol=1e-4, atol=1e-5) -> float:
    """The largest |got - want| beyond rtol, as a share of atol; raises past the tolerance."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return float(((got - want).abs() - rtol * want.abs()).max()) / atol


def lp_mesh(card: str, device=None) -> dict:
    """fb15k_237.yaml's model at FB15K-237's shape on a 1 x 1 mesh over a
    one-rank process group (NCCL on the card: the real process group and
    the whole sharded step on trivial groups), held against the
    single-device trainer from the same seed: two batches of the first
    epoch's permutation (tables and relations to rtol 1e-4 / atol 1e-5),
    then 3 epochs each (losses to rtol 5e-3). Returns the mesh run's
    launches and its s/epoch."""
    from marius_tpu_torch.data.samplers.negative import NegativeSamplingConfig
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.parallel import multihost
    from marius_tpu_torch.parallel.mesh import make_mesh
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    timeout = datetime.timedelta(seconds=MESH_TIMEOUT_S)
    dev = multihost.initialize(f"localhost:{free_port()}", 1, 0, device=device, timeout=timeout)
    try:
        mesh = make_mesh(1, 1, device=dev, timeout=timeout)
        edges = synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES)
        neg = NegativeSamplingConfig(num_chunks=CHUNKS, negatives_per_positive=NEGATIVES)

        def trainer(m):
            return LinkPredictionTrainer(lp_model(NUM_RELS, DIM), NUM_NODES, NUM_RELS, edges, neg,
                                         batch_size=BATCH, seed=0, mesh=m, device=dev)

        meshed, single = trainer(mesh), trainer(None)
        for t in (meshed, single):
            perm = t._epoch_permutation(0)
            for i in range(2):
                rows = perm[i * BATCH:(i + 1) * BATCH]
                t._batch_step(t.edges[rows], rows < t.num_edges)
        full = meshed.gathered_state()
        worst = max(_assert_close(full.table.values, single.state.table.values, "values"),
                    _assert_close(full.table.state, single.state.table.state, "Adagrad state"),
                    *(_assert_close(full.params["decoder"][k], single.state.params["decoder"][k],
                                    k) for k in ("relations", "inverse_relations")))
        print(f"lp_mesh: process group backend {mesh.backend}, 1 rank on {dev}, mesh "
              f"{mesh.shape}; after 2 batches the mesh trainer's table, Adagrad state and "
              f"relations equal the single-device trainer's within rtol 1e-4 / atol 1e-5 "
              f"(largest difference {worst:.3f} of atol past rtol)  [{card}]", flush=True)

        meshed, single = trainer(mesh), trainer(None)
        gather.launches = adagrad.launches = 0
        res = [meshed.train_epoch() for _ in range(LP_MESH_EPOCHS)]
        launches = {"gather_rows": gather.launches, "sparse_adagrad_update_": adagrad.launches}
        ref = [single.train_epoch() for _ in range(LP_MESH_EPOCHS)]
    finally:
        multihost.shutdown()
    losses, ref_losses = [r["loss"] for r in res], [r["loss"] for r in ref]
    for i, (r, f) in enumerate(zip(res, ref)):
        print(f"lp_mesh epoch {i}: loss {r['loss']:.6f} (single device {f['loss']:.6f})  "
              f"{r['epoch_time_s']:.4f} s ({f['epoch_time_s']:.4f} s)  "
              f"{r['edges_per_sec']:.1f} edges/s ({f['edges_per_sec']:.1f})  collectives per "
              f"batch {r['collectives_per_batch']}  [{card}]", flush=True)
    if not np.allclose(losses, ref_losses, rtol=5e-3, atol=0.0):
        raise AssertionError(f"lp_mesh losses {losses} differ from the single-device "
                             f"trainer's {ref_losses} beyond rtol 5e-3")
    if any(r["collectives_per_batch"] > 3 for r in res):
        raise AssertionError("lp_mesh makes more than 3 collectives per batch")
    batches = LP_MESH_EPOCHS * meshed.num_batches
    if launches != {"gather_rows": batches, "sparse_adagrad_update_": batches}:
        raise AssertionError(f"lp_mesh launched {launches} in {batches} batches (1 each per "
                             f"batch: the owner-local gather and the shard's Adagrad)")
    print(f"lp_mesh launches: {launches} ({batches} batches)  [{card}]", flush=True)
    return {"gather_rows": {"lp_mesh train": launches["gather_rows"]},
            "sparse_adagrad_update_": {"lp_mesh train": launches["sparse_adagrad_update_"]},
            "s_per_epoch": [r["epoch_time_s"] for r in res]}


def _train_in_group(config_path: str, device, trainer_cls):
    """The command line's ``train`` of ``config_path`` in this rank process
    (it joins the process group from MARIUS_COORDINATOR, MARIUS_NUM_PROCESSES
    and MARIUS_PROCESS_ID; rank 0 prints the test metrics), the three
    kernels' launches counted in ``trainer_cls.train_epoch`` (set to 0 before
    it, read after) and in all. Returns (marius_train's result, training
    launches, all launches, the card's peak bytes per epoch)."""
    from marius_tpu_torch import manager
    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum
    from marius_tpu_torch.tools import cli

    kernels = {"gather_rows": gather, "sparse_adagrad_update_": adagrad, "gather_sum": nbr_sum}
    train = dict.fromkeys(kernels, 0)
    seen, peaks = {}, []
    train_epoch, run = trainer_cls.train_epoch, manager.marius_train

    def counted(self, *args, **kwargs):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        before = {k: m.launches for k, m in kernels.items()}
        out = train_epoch(self, *args, **kwargs)
        for k, m in kernels.items():
            train[k] += m.launches - before[k]
        peaks.append(torch.cuda.max_memory_allocated(self.device) if cuda else None)
        return out

    def captured(*args, **kwargs):
        seen["result"] = run(*args, **kwargs)
        return seen["result"]

    for m in kernels.values():
        m.launches = 0
    trainer_cls.train_epoch, manager.marius_train = counted, captured
    try:
        cli.main(["train", config_path], device=device)
    finally:
        trainer_cls.train_epoch, manager.marius_train = train_epoch, run
    return seen["result"], train, {k: m.launches for k, m in kernels.items()}, peaks


def _rank_record(result, train, launches, rate_key: str = "edges_per_sec") -> dict:
    """The fields of a MESH_RANK line every rank function prints."""
    tr = result["runtime"].trainer
    epochs = result["epochs"]
    return {"rank": tr.mesh.rank, "coords": tr.mesh.coords, "backend": tr.mesh.backend,
            "device": str(tr.device), "shape": tr.mesh.shape,
            "losses": [e["loss"] for e in epochs], "seconds": [e["epoch_time_s"] for e in epochs],
            "rates": [e[rate_key] for e in epochs],
            "collectives_per_batch": [e["collectives_per_batch"] for e in epochs],
            "train_launches": train, "launches": launches,
            "test": {k: v for k, v in result["test"].items() if isinstance(v, (int, float))}}


def mesh_rank(config_path: str, device=None) -> int:
    """One rank of lp_mesh_ranks (and of lp_mesh_gspmd's uneven mesh), in a
    process of its own: the command line's ``train``, then a line
    ``MESH_RANK {...}``: this rank's backend, device, mesh coordinates,
    losses, seconds and collectives per epoch, and the three kernels'
    launches in training and in all."""
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    result, train, launches, _ = _train_in_group(config_path, device, LinkPredictionTrainer)
    tr = result["runtime"].trainer
    print("MESH_RANK " + json.dumps({
        **_rank_record(result, train, launches), "mode": tr.sharding_mode,
        "shard_rows": tr.state.table.values.shape[0], "batches": tr.num_batches,
        "hop_caps": getattr(tr, "mesh_hop_caps", None),
        "edges_per_sec": [e["edges_per_sec"] for e in result["epochs"]]}), flush=True)
    return 0


def mesh_gnn_all_rank(config_path: str, device=None) -> int:
    """One rank of lp_mesh_ranks' gs_1_layer check at FB15K-237's shape, in
    a process of its own: the config's model (fb15k_237.yaml with gs_1_layer's
    encoder under ALL sampling, which draws nothing, so every data index's
    samples are one device's, and ROADMAP C5's rates) on the MESH_DATA x
    MESH_NODE mesh (per-data-index dedup, generators and local hop caps;
    14,541 rows in two shards of 7,271, the last with the padding row) and on
    this rank's card alone, from the same seed, two batches of the first
    epoch's permutation each. After the first batch the table, the dense
    parameters and every Adagrad accumulator must agree to rtol 1e-4 / atol
    1e-5, but for the elements whose gradient was nonzero and below 1e-8
    (accumulator below ACC_FLOOR), which are counted; the losses of both batches to rtol
    1e-4 / atol 1e-5. Past the first batch C5 amplifies the data axis's other
    summation order in leaves, so the largest difference after two is
    reported, not held. Prints ``MESH_RANK {...}``."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.neighbor import resolve_all_caps
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum
    from marius_tpu_torch.parallel import multihost
    from marius_tpu_torch.parallel.mesh import make_mesh
    from marius_tpu_torch.storage.dataset import load_split, load_stats
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    cfg = load_config(config_path)
    ds = cfg.storage.dataset.dataset_dir
    stats = load_stats(ds)
    edges = load_split(ds, "train", stats)
    n, r = stats.num_nodes, stats.num_relations
    timeout = datetime.timedelta(seconds=MESH_TIMEOUT_S)
    dev = multihost.initialize(os.environ["MARIUS_COORDINATOR"],
                               int(os.environ["MARIUS_NUM_PROCESSES"]),
                               int(os.environ["MARIUS_PROCESS_ID"]), device=device,
                               timeout=timeout)
    kernels = {"gather_rows": gather, "sparse_adagrad_update_": adagrad, "gather_sum": nbr_sum}
    try:
        mesh = make_mesh(MESH_DATA, MESH_NODE, device=dev, timeout=timeout)
        graph = build_device_graph(edges, n, r, device=dev)
        nbr = resolve_all_caps(cfg.train_neighbor_sampling, graph.in_offsets,
                               graph.out_offsets, cap_limit=cfg.all_cap_limit)

        def trainer(m):
            # a model of its own: the decoder's relations are its module's parameters
            return LinkPredictionTrainer(load_config(config_path).model, n, r, edges,
                                         cfg.training.negative_sampling,
                                         batch_size=cfg.training.batch_size,
                                         seed=cfg.training.seed, graph=graph, nbr_configs=nbr,
                                         mesh=m, device=dev)

        # the card's peak while the mesh trainer starts: its shard, not the whole table
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        meshed = trainer(mesh)
        init_peak = (torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda"
                     else None)
        single = trainer(None)
        pairs = (("mesh", meshed), ("single", single))
        losses = {name: [] for name, _ in pairs}
        launches = {name: dict.fromkeys(kernels, 0) for name, _ in pairs}
        perms = {name: t._epoch_permutation(0) for name, t in pairs}
        for i in range(2):
            for name, t in pairs:
                before = {k: m.launches for k, m in kernels.items()}
                rows = perms[name][i * t.batch_size:(i + 1) * t.batch_size]
                losses[name].append(float(t._batch_step(t.edges[rows], rows < t.num_edges)))
                for k, m in kernels.items():
                    launches[name][k] += m.launches - before[k]
            full, ref = meshed.gathered_state(), single.state
            if i == 0:
                # every leaf after the first batch; an element whose gradient is
                # nonzero but below 1e-8 (its accumulator below 1e-16) is counted,
                # not held: lr * g / (|g| + 1e-10) turns its rounding into the
                # step's size
                if set(ref.opt_state.slots) != {"sum"}:
                    raise ValueError("the check reads Adagrad's dense accumulators")
                acc = [ref.table.state] + tree_leaves(ref.opt_state.slots)
                got = [full.table.values] + tree_leaves(full.params)
                want = [ref.table.values] + tree_leaves(ref.params)
                held = [(a == 0) | (a >= ACC_FLOOR) for a in acc]
                worst = max(
                    _assert_close(full.table.state, ref.table.state, "Adagrad state"),
                    *(_assert_close(g, w, f"dense accumulator {j}") for j, (g, w) in enumerate(
                        zip(tree_leaves(full.opt_state.slots), acc[1:]))),
                    *(_assert_close(g[k], w[k], f"leaf {j} after one batch")
                      for j, (g, w, k) in enumerate(zip(got, want, held))))
                unheld = sum(int((~k).sum()) for k in held)
        _assert_close(torch.tensor(losses["mesh"]), torch.tensor(losses["single"]), "losses")
        after_two = max(float((g - w).abs().max()) for g, w in zip(
            [full.table.values] + tree_leaves(full.params),
            [ref.table.values] + tree_leaves(ref.params)))
        print("MESH_RANK " + json.dumps({
            "rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend,
            "device": str(dev), "shard_rows": meshed.state.table.values.shape[0],
            "hop_caps": list(meshed.mesh_hop_caps), "single_hop_caps": list(single.hop_caps),
            "overflow": [int(meshed._overflow), int(single._overflow)],
            "elements": sum(int(k.numel()) for k in held), "unheld": unheld,
            "after_two": after_two,
            "losses": losses, "worst": worst, "launches": launches,
            "init_peak_bytes": init_peak,
            "table_bytes": 2 * single.state.table.values.nbytes,
            "shard_bytes": 2 * meshed.state.table.values.nbytes}), flush=True)
    finally:
        multihost.shutdown()
    return 0


# what each rank process of run_mesh_ranks runs (the config's path is its argument)
MESH_RANK_CODE = "import sys, chip_smoke; sys.exit(chip_smoke.{fn}(sys.argv[1], {device!r}))"


def run_mesh_ranks(tag: str, raw: dict, tmp: str, card: str, device=None,
                   fn: str = "mesh_rank", shape=(MESH_DATA, MESH_NODE)) -> list:
    """``raw`` through data x node (``shape``) rank processes of ``fn``
    (``mesh_rank``, ``mesh_gnn_all_rank``, ``gspmd_rank``, ``oocore_mesh_rank``
    or ``nc_mesh_rank``), rank i on card i % cards. Each gets two rendezvous
    addresses: MARIUS_COORDINATOR for the command line's process group and
    MESH_CHECK_COORDINATOR for a second one after it. Returns each rank's
    MESH_RANK record, with the metrics it printed; a rank that fails fails
    the phase."""
    here = Path(__file__).resolve().parent
    world = shape[0] * shape[1]
    cfg = Path(tmp) / f"{tag.replace(' ', '_')}.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    env = {**os.environ, "MARIUS_COORDINATOR": f"localhost:{free_port()}",
           "MESH_CHECK_COORDINATOR": f"localhost:{free_port()}",
           "MARIUS_NUM_PROCESSES": str(world)}
    code = MESH_RANK_CODE.format(fn=fn, device=device)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(cfg)], cwd=here,
                              env={**env, "MARIUS_PROCESS_ID": str(i)}, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(world)]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_RANKS_LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            for j, o in enumerate(outs):
                print(f"--- {tag} rank {j} (exit {procs[j].returncode}) ---\n{o[-6000:]}",
                      flush=True)
            raise AssertionError(f"{tag}: rank {i} exited {p.returncode}")
    records = []
    for out in outs:
        rec = json.loads([ln for ln in out.splitlines() if ln.startswith("MESH_RANK ")][-1][10:])
        rec["printed"] = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        records.append(rec)
    print(f"{tag}: {world} rank processes, {wall:.1f} s from start to the last exit", flush=True)
    return records


def _check_mesh_records(tag: str, records: list, card: str,
                        mesh=(MESH_DATA, MESH_NODE)) -> dict:
    """Every rank on the data x node ``mesh``, the same losses everywhere,
    <= 3 collectives per batch, one gather and one Adagrad per training
    batch (one gather-sum per GNN layer); rank 0 alone prints the metrics.
    Returns the launches per part."""
    counts = {"gather_rows": {}, "sparse_adagrad_update_": {}, "gather_sum": {}}
    for rec in records:
        shape = {"data": mesh[0], "node": mesh[1]}
        if rec["shape"] != shape or rec["mode"] != "explicit" or rec["coords"] != [
                rec["rank"] // mesh[1], rec["rank"] % mesh[1]]:
            raise AssertionError(f"{tag}: rank {rec['rank']} is not on the {shape} mesh: {rec}")
        if rec["losses"] != records[0]["losses"]:
            raise AssertionError(f"{tag}: rank {rec['rank']}'s losses {rec['losses']} differ "
                                 f"from rank 0's {records[0]['losses']}")
        if max(rec["collectives_per_batch"]) > 3:
            raise AssertionError(f"{tag}: {rec['collectives_per_batch']} collectives per batch")
        if (len(rec["printed"]) == 1) != (rec["rank"] == 0):
            raise AssertionError(f"{tag}: rank {rec['rank']} printed {rec['printed']}")
        batches = len(rec["losses"]) * rec["batches"]
        layers = 1 if rec["hop_caps"] else 0
        want = {"gather_rows": batches, "sparse_adagrad_update_": batches,
                "gather_sum": layers * batches}
        if rec["train_launches"] != want:
            raise AssertionError(f"{tag}: rank {rec['rank']} launched {rec['train_launches']} "
                                 f"in training, expected {want}")
        for k, n in rec["train_launches"].items():
            if n:
                counts[k][f"{tag} rank {rec['rank']} train"] = n
        print(f"{tag} rank {rec['rank']}: backend {rec['backend']} on {rec['device']} at "
              f"{rec['coords']}, shard rows {rec['shard_rows']}, hop caps {rec['hop_caps']}; "
              f"losses {rec['losses']}; s/epoch {rec['seconds']}; edges/s "
              f"{[round(x, 1) for x in rec['edges_per_sec']]}; collectives per batch "
              f"{rec['collectives_per_batch']}; launches in training {rec['train_launches']}, "
              f"in all {rec['launches']}  [{card}]", flush=True)
    return counts


def write_kg_dataset(directory: str, edges: np.ndarray, num_nodes: int, num_rels: int) -> None:
    """A learnable KG (shuffled) in the dataset layout, split 90 / 5 / 5."""
    from marius_tpu_torch.storage.dataset import DatasetStats, save_split, save_stats

    tr, va = int(0.9 * len(edges)), int(0.95 * len(edges))
    for name, part in (("train", edges[:tr]), ("valid", edges[tr:va]), ("test", edges[va:])):
        save_split(directory, name, part)
    save_stats(directory, DatasetStats(
        num_nodes=num_nodes, num_edges=len(edges), num_relations=num_rels, num_edge_cols=3,
        num_train=tr, num_valid=va - tr, num_test=len(edges) - va))


def lp_mesh_ranks(card: str, device=None) -> dict:
    """fb15k_237.yaml on a MESH_DATA x MESH_NODE mesh of rank processes
    through the command line (rank i on card i % cards: on one card they
    share it over gloo, with CUDA tensors), MESH_EPOCHS epochs at full
    width: each rank's losses held to the single-device run's (rtol 5e-3)
    and the test MRR to its band, then ``marius_eval`` in this one process
    reloads rank 0's checkpoint and must reproduce rank 0's test metrics
    exactly. Then gs_1_layer on the same mesh over a learnable KG: the loss
    falls and the MRR is above chance; and gs_1_layer under ALL sampling at
    FB15K-237's shape on each rank, held to one card's trainer over 2
    batches (``mesh_gnn_all_rank``)."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train

    config = Path(__file__).resolve().parent / "examples" / "configuration" / "fb15k_237.yaml"
    metric_keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    with open(config) as f:
        yaml_raw = yaml.safe_load(f)
    mesh = {"data": MESH_DATA, "node": MESH_NODE}
    with tempfile.TemporaryDirectory() as tmp:
        write_fb15k_shaped(f"{tmp}/dataset")
        raw = copy.deepcopy(yaml_raw)
        raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
        raw["storage"]["model_dir"] = f"{tmp}/model_mesh"
        raw["training"]["num_epochs"] = MESH_EPOCHS
        single_raw = copy.deepcopy(raw)
        single_raw["storage"]["model_dir"] = f"{tmp}/model_single"
        raw["training"]["mesh"] = mesh
        print(f"lp_mesh_ranks: {config.relative_to(config.parents[2])} with dataset_dir and "
              f"model_dir redirected and training.mesh {mesh}; one cut: num_epochs "
              f"{yaml_raw['training']['num_epochs']} -> {MESH_EPOCHS}", flush=True)
        records = run_mesh_ranks("lp_mesh_ranks", raw, tmp, card, device)
        single = marius_train(load_config(single_raw), device=device)
        again = marius_eval(load_config(raw), device=device)

        kg = make_realizable_kg(n=MESH_KG_NODES, d=8, r=10, per=4, seed=0)
        write_kg_dataset(f"{tmp}/kg", kg, MESH_KG_NODES, 10)
        gnn_raw = copy.deepcopy(yaml_raw)
        gnn_raw["model"]["encoder"] = gnn_encoder(DIM)
        gnn_raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/kg"
        gnn_raw["storage"]["model_dir"] = f"{tmp}/model_gnn"
        gnn_raw["training"]["num_epochs"] = MESH_KG_EPOCHS
        gnn_raw["training"]["mesh"] = mesh
        print(f"lp_mesh_ranks gs_1_layer: the same YAML with gs_1_layer's encoder (EMBEDDING "
              f"{DIM}, GraphSAGE MEAN, UNIFORM 10) on make_realizable_kg's {len(kg)} edges over "
              f"{MESH_KG_NODES} nodes and 10 relations, {MESH_KG_EPOCHS} epochs", flush=True)
        gnn_records = run_mesh_ranks("lp_mesh_ranks gs_1_layer", gnn_raw, tmp, card, device)

        all_raw = copy.deepcopy(raw)
        all_raw["model"]["encoder"] = dict(gnn_encoder(DIM),
                                           train_neighbor_sampling=[{"type": "ALL"}])
        all_raw["storage"]["model_dir"] = f"{tmp}/model_gnn_all"
        # ROADMAP C5's rates: Adam's first step, lr * g / (|g| + 1e-8), turns the
        # rounding of a near-zero dense gradient (the data axis sums it in
        # another order) into a leaf difference past the tolerance
        all_raw["model"]["dense_optimizer"] = {"type": "ADAGRAD",
                                               "options": {"learning_rate": 0.1}}
        all_raw["model"]["sparse_optimizer"] = {"type": "ADAGRAD",
                                                "options": {"learning_rate": 0.02}}
        print(f"lp_mesh_ranks gs_1_layer ALL: the YAML with gs_1_layer's encoder under ALL "
              f"sampling at FB15K-237's shape, dense Adagrad at lr 0.1 and the table at 0.02 "
              f"(ROADMAP C5), 2 batches on the mesh and on one card from the same seed, on "
              f"each rank", flush=True)
        all_records = run_mesh_ranks("lp_mesh_ranks gs_1_layer ALL", all_raw, tmp, card, device,
                                     fn="mesh_gnn_all_rank")

    counts = _check_mesh_records("lp_mesh_ranks", records, card)
    losses = records[0]["losses"]
    ref = [e["loss"] for e in single["epochs"]]
    if not np.allclose(losses, ref, rtol=5e-3, atol=0.0):
        raise AssertionError(f"lp_mesh_ranks losses {losses} differ from the single-device "
                             f"run's {ref} beyond rtol 5e-3")
    test, ref_test = records[0]["printed"][0], single["test"]
    if not 0.0 < test["mrr"] <= 1.0 or abs(test["mrr"] - ref_test["mrr"]) > 0.2 * ref_test["mrr"]:
        raise AssertionError(f"lp_mesh_ranks test MRR {test['mrr']} is outside 20% of the "
                             f"single-device run's {ref_test['mrr']}")
    print(f"lp_mesh_ranks against one process on the card: losses {losses} vs {ref} (rtol "
          f"5e-3); test filtered MRR {test['mrr']:.6f} vs {ref_test['mrr']:.6f}, Hits@10 "
          f"{test['hits@10']:.6f} vs {ref_test['hits@10']:.6f}; single-device s/epoch "
          f"{[round(e['epoch_time_s'], 4) for e in single['epochs']]}  [{card}]", flush=True)
    if any(test[k] != again["test"][k] for k in metric_keys):
        raise AssertionError(f"marius_eval of rank 0's checkpoint gave {again['test']}, rank 0 "
                             f"printed {test}")
    print("lp_mesh_ranks: marius_eval on one rank reloaded rank 0's checkpoint and reproduced "
          "its test metrics exactly", flush=True)

    gcounts = _check_mesh_records("lp_mesh_ranks gs_1_layer", gnn_records, card)
    glosses = gnn_records[0]["losses"]
    gtest = gnn_records[0]["printed"][0]
    chance = sum(1.0 / k for k in range(1, MESH_KG_NODES + 1)) / MESH_KG_NODES
    if not all(b < a for a, b in zip(glosses, glosses[1:])) or not gtest["mrr"] > 2 * chance:
        raise AssertionError(f"lp_mesh_ranks gs_1_layer: losses {glosses} must fall and the "
                             f"test MRR {gtest['mrr']} pass twice chance ({chance:.5f})")
    print(f"lp_mesh_ranks gs_1_layer: losses {glosses} fall; test filtered MRR "
          f"{gtest['mrr']:.6f}, Hits@10 {gtest['hits@10']:.6f} (chance MRR {chance:.6f})  "
          f"[{card}]", flush=True)
    for rec in all_records:
        want = {"gather_rows": 2, "sparse_adagrad_update_": 2, "gather_sum": 2}
        if rec["launches"]["mesh"] != want:
            raise AssertionError(f"lp_mesh_ranks gs_1_layer ALL: rank {rec['rank']} launched "
                                 f"{rec['launches']['mesh']} in 2 mesh batches, expected {want}")
        print(f"lp_mesh_ranks gs_1_layer ALL rank {rec['rank']}: backend {rec['backend']} on "
              f"{rec['device']} at {rec['coords']}, shard rows {rec['shard_rows']}, local hop "
              f"caps {rec['hop_caps']} (one card: {rec['single_hop_caps']}); losses "
              f"{rec['losses']['mesh']} vs one card {rec['losses']['single']} (rtol 1e-4); "
              f"after 1 batch the table, dense parameters and accumulators equal one card's "
              f"within rtol 1e-4 / atol 1e-5 (largest difference {rec['worst']:.3f} of atol "
              f"past rtol; {rec['unheld']} of {rec['elements']} elements with a nonzero "
              f"gradient below 1e-8 not held, ROADMAP C5); after 2 batches the largest leaf "
              f"difference {rec['after_two']:.3g}; hop overflow {rec['overflow']}; "
              f"launches {rec['launches']}; the card's peak while the mesh trainer started "
              f"{rec['init_peak_bytes']} bytes above its base (the table and its Adagrad "
              f"state {rec['table_bytes']} bytes whole, {rec['shard_bytes']} this shard)  "
              f"[{card}]", flush=True)
        for k, n in rec["launches"]["mesh"].items():
            gcounts[k][f"lp_mesh_ranks gs_1_layer ALL rank {rec['rank']} train"] = n
    for k in counts:
        counts[k].update(gcounts[k])
    counts["s_per_epoch"] = {"fb15k": records[0]["seconds"],
                             "gs_1_layer": gnn_records[0]["seconds"]}
    return counts


def lp_mesh_shapes(rates, card) -> dict:
    """The three kernels at lp_mesh_ranks' shapes on the card, each bit for
    bit against its plain version and timed beside its bound and its
    one-call PyTorch equivalent: the owner-local row gather of data index
    0's part of a batch (500 positives and 5 chunks of 500 negatives each
    way: K = 6,000) into node index 1's 7,271 x 50 shard (ids it does not
    own clamp to a row of the shard and are zeroed after); the shard's
    Adagrad over all its rows with a summed gradient G that is zero on the
    rows no data index touched; and the GNN layer's gather-sum at the local
    caps (that part's unique ids as seeds, UNIFORM 10 over the train graph)."""
    from torch.optim.adagrad import adagrad as torch_adagrad

    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.neighbor import (
        NeighborSamplingConfig,
        estimate_hop_caps,
        generator_draws,
        sample_neighbor_batch,
    )
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.ops.unique import unique_padded

    dev = torch.device("cuda")
    rows = -(-NUM_NODES // MESH_NODE)
    g = torch.Generator(device=dev).manual_seed(11)
    edges_np = synthetic_edges(0, NUM_NODES, NUM_RELS, NUM_EDGES)
    edges = torch.as_tensor(edges_np[:BATCH], device=dev).long()
    b, c = BATCH // MESH_DATA, CHUNKS // MESH_DATA
    negs = torch.randint(0, NUM_NODES, (2, c * NEGATIVES), generator=g, device=dev)
    ids = torch.cat([edges[:b, 0], edges[:b, 2], negs[0], negs[1]])
    shard = torch.randn(rows, DIM, device=dev, generator=g)
    local = ids - rows   # node index 1: ids below its rows are negative
    gat = time_gather(gather, shard, [local], rates)
    gat["max_abs_err"] = gather_max_err(gather, shard, local)
    print(f"gather_rows, lp_mesh_ranks owner-local (K={gat['k']} int64 ids into the "
          f"{rows} x {DIM} shard, {gat['distinct_rows']:.0f} distinct rows after the clamp, "
          f"{gat['bound_bytes'] / 1e6:.4f} MB): max_abs_err {gat['max_abs_err']}  kernel "
          f"{gat['ms'] * 1e3:.2f} us  plain {gat['plain_ms'] * 1e3:.2f} us  index_select "
          f"{gat['library_ms'] * 1e3:.2f} us  bound {gat['bound_ms'] * 1e3:.2f} us "
          f"({gat['bound_by']})  [{card}]", flush=True)

    # G: the rows of node index 1 that the whole batch (both data indices) touches
    whole = torch.cat([edges[:, 0], edges[:, 2],
                       torch.randint(0, NUM_NODES, (2 * CHUNKS * NEGATIVES,), generator=g,
                                     device=dev)]) - rows
    touched = torch.zeros(rows, dtype=torch.bool, device=dev)
    touched[whole[(whole >= 0) & (whole < rows)]] = True
    G = torch.randn(rows, DIM, device=dev, generator=g) * touched[:, None]
    values, state = torch.randn(rows, DIM, device=dev, generator=g), torch.rand(
        rows, DIM, device=dev, generator=g)
    all_rows = torch.arange(rows, device=dev)
    v1, s1, v2, s2 = values.clone(), state.clone(), values.clone(), state.clone()
    adagrad.sparse_adagrad_update_(v1, s1, all_rows, G, 0.1)
    adagrad.sparse_adagrad_update_plain_(v2, s2, all_rows, G, 0.1)
    torch.cuda.synchronize()
    err = max(float((v1 - v2).abs().max()), float((s1 - s2).abs().max()))
    if err != 0.0:
        raise AssertionError(f"sparse_adagrad_update_ differs from plain on the shard: {err}")
    nbytes = 5 * rows * DIM * 4 + rows * 8
    b_ms, b_by = bound_ms(nbytes, 7 * rows * DIM, rates)
    sparse = torch.sparse_coo_tensor(all_rows[None], G, (rows, DIM), is_coalesced=True,
                                     check_invariants=False)
    v3, s3, step = values.clone(), state.clone(), torch.zeros((), device=dev)

    def library():
        torch_adagrad([v3], [sparse], [s3], [step], has_sparse_grad=True, lr=0.1,
                      weight_decay=0.0, lr_decay=0.0, eps=1e-10, maximize=False)

    ada = {"k": rows, "touched_rows": int(touched.sum()), "d": DIM, "max_abs_err": err,
           "ms": time_ms(lambda: adagrad.sparse_adagrad_update_(v1, s1, all_rows, G, 0.1)),
           "plain_ms": time_ms(lambda: adagrad.sparse_adagrad_update_plain_(
               v2, s2, all_rows, G, 0.1)),
           "library_ms": time_ms(library), "bound_ms": b_ms, "bound_by": b_by,
           "bound_bytes": nbytes, "plan": adagrad.tensor_plan(v1, s1, all_rows, G)._asdict()}
    print(f"sparse_adagrad_update_, lp_mesh_ranks shard (all {rows} rows x {DIM}, "
          f"{ada['touched_rows']} with a nonzero G, {nbytes / 1e6:.4f} MB): max_abs_err {err}  "
          f"kernel {ada['ms'] * 1e3:.2f} us  plain {ada['plain_ms'] * 1e3:.2f} us  "
          f"torch.optim.adagrad (sparse) {ada['library_ms'] * 1e3:.2f} us  bound "
          f"{b_ms * 1e3:.2f} us ({b_by})  plan {plan_text(ada['plan'])}  [{card}]", flush=True)

    graph = build_device_graph(edges_np, NUM_NODES, NUM_RELS, device=dev)
    configs = (NeighborSamplingConfig("UNIFORM", max_neighbors=10),)
    cap = 2 * b + 2 * c * NEGATIVES
    uniq = unique_padded(ids, size=cap, fill_value=NUM_NODES).ids
    nb = sample_neighbor_batch(generator_draws(g), graph, uniq, uniq < NUM_NODES, configs,
                               estimate_hop_caps(cap, configs, NUM_NODES))
    sums = time_layer_sum(nb.layers[0], nb.node_ids[0].shape[0], DIM, rates, dev)
    print(f"gather_sum, lp_mesh_ranks gs_1_layer layer ({sums['targets']} seeds x "
          f"{sums['width']} slots, {sums['valid_slots']} real, {sums['distinct_rows']} distinct "
          f"rows of {nb.node_ids[0].shape[0]}, d={DIM}, {sums['bound_bytes'] / 1e6:.4f} MB): "
          f"max_abs_err {sums['max_abs_err']}  kernel {sums['ms'] * 1e3:.2f} us (with the "
          f"layout built: {sums['with_layout_ms'] * 1e3:.2f} us)  plain "
          f"{sums['plain_ms'] * 1e3:.2f} us  embedding_bag {sums['library_ms'] * 1e3:.2f} us  "
          f"bound {sums['bound_ms'] * 1e3:.2f} us ({sums['bound_by']})  [{card}]", flush=True)
    return {"gather_rows": gat, "sparse_adagrad_update_": ada, "gather_sum": sums}


# -- the data-parallel meshes: the GSPMD-only LP cases, the buffer, NC -----------------

def _check_group(device):
    """This rank's second process group (MESH_CHECK_COORDINATOR): the
    checks after the command line's run, which left its own."""
    from marius_tpu_torch.parallel import multihost

    return multihost.initialize(os.environ["MESH_CHECK_COORDINATOR"],
                                int(os.environ["MARIUS_NUM_PROCESSES"]),
                                int(os.environ["MARIUS_PROCESS_ID"]), device=device,
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))


def _held_close(got, want, grad, what: str) -> tuple:
    """``got`` against ``want`` at rtol 1e-4 / atol 1e-5 where the reference
    gradient ``grad`` is at least 1e-6 (an Adam or Adagrad first step
    lr * g / (|g| + eps) turns a smaller one's rounding into the step's size,
    ROADMAP C5); returns (largest difference past rtol as a share of atol,
    elements not held)."""
    keep = grad.abs() >= 1e-6
    worst = _assert_close(got[keep], want[keep], what) if bool(keep.any()) else 0.0
    return worst, int((~keep).sum())


def gspmd_rank(config_path: str, device=None) -> int:
    """One rank of lp_mesh_gspmd's 2 x 2 mesh: the command line's ``train``
    of fb15k_237.yaml with CORRUPT_REL, then, in a second process group, a
    FEATURE-only encoder at FB15K-237's shape (FEATURE 50 with a bias, then
    the config's DistMult corrupting relations; random features from seed 0) on the mesh and on this
    rank's card alone from the same seed, 2 batches of the first epoch's
    permutation each: the losses, the relations and the FEATURE bias to rtol
    1e-4 / atol 1e-5. Prints ``MESH_RANK {...}``."""
    import dataclasses

    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.nn.encoder import EncoderConfig
    from marius_tpu_torch.nn.layers import LayerConfig
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum
    from marius_tpu_torch.parallel import multihost
    from marius_tpu_torch.parallel.mesh import make_mesh
    from marius_tpu_torch.storage.dataset import load_split, load_stats
    from marius_tpu_torch.train.trainer import LinkPredictionTrainer

    result, train, launches, _ = _train_in_group(config_path, device, LinkPredictionTrainer)
    tr = result["runtime"].trainer
    record = {**_rank_record(result, train, launches), "mode": tr.sharding_mode,
              "decoder_method": tr.decoder_method, "batches": tr.num_batches,
              "shard_rows": tr.state.table.values.shape[0], "hop_caps": None,
              "edges_per_sec": [e["edges_per_sec"] for e in result["epochs"]]}

    cfg = load_config(config_path)
    ds = cfg.storage.dataset.dataset_dir
    stats = load_stats(ds)
    edges = load_split(ds, "train", stats)
    n, r, d = stats.num_nodes, stats.num_relations, DIM
    features = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    dev = _check_group(device)
    kernels = {"gather_rows": gather, "sparse_adagrad_update_": adagrad, "gather_sum": nbr_sum}
    try:
        mesh = make_mesh(MESH_DATA, MESH_NODE, device=dev)

        def trainer(m):
            # the config's decoder (relation corruption) over a FEATURE-only encoder
            model = dataclasses.replace(load_config(config_path).model, encoder=EncoderConfig(
                ((LayerConfig("FEATURE", output_dim=d, bias=True),),)))
            return LinkPredictionTrainer(model, n, r, edges, cfg.training.negative_sampling,
                                         batch_size=cfg.training.batch_size,
                                         seed=cfg.training.seed, features=features, mesh=m,
                                         device=dev)

        pairs = (("mesh", trainer(mesh)), ("single", trainer(None)))
        losses = {name: [] for name, _ in pairs}
        counts = {name: dict.fromkeys(kernels, 0) for name, _ in pairs}
        collectives = pairs[0][1].mesh.collectives
        for i in range(2):
            for name, t in pairs:
                before = {k: m.launches for k, m in kernels.items()}
                rows = t._epoch_permutation(0)[i * t.batch_size:(i + 1) * t.batch_size]
                losses[name].append(float(t._batch_step(t.edges[rows], rows < t.num_edges)))
                for k, m in kernels.items():
                    counts[name][k] += m.launches - before[k]
        meshed, single = pairs[0][1], pairs[1][1]
        if meshed.state.table is not None:
            raise AssertionError("a FEATURE-only encoder has no table")
        _assert_close(torch.tensor(losses["mesh"]), torch.tensor(losses["single"]), "losses")
        worst = max(_assert_close(g, w, f"leaf {j}") for j, (g, w) in enumerate(
            zip(tree_leaves(meshed.state.params), tree_leaves(single.state.params))))
        record["feature_only"] = {
            "losses": losses, "worst": worst, "launches": counts,
            "collectives_per_batch": (meshed.mesh.collectives - collectives) / 2,
            "leaves": [float(t.detach().double().sum()) for t in
                       tree_leaves(meshed.state.params)]}
    finally:
        multihost.shutdown()
    print("MESH_RANK " + json.dumps(record), flush=True)
    return 0


def lp_mesh_gspmd(card: str, device=None) -> dict:
    """The LP cases the JAX package leaves to GSPMD, on the explicit step:
    fb15k_237.yaml with CORRUPT_REL on a 2 x 2 mesh of four rank processes
    (the command line, GSPMD_EPOCHS epochs: each rank's loss held to one
    process's run in this call at rtol 5e-3, and marius_eval in this process
    reproduces rank 0's relation metrics from its checkpoint); fb15k_237.yaml
    on a 3 x 1 mesh (batch 1000 and 10 chunks split 4, 3, 3 chunks: the same
    checks); and, in the 2 x 2 ranks, a FEATURE-only encoder at FB15K-237's
    shape held to one card's trainer over 2 batches (``gspmd_rank``)."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train

    config = Path(__file__).resolve().parent / "examples" / "configuration" / "fb15k_237.yaml"
    metric_keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    with open(config) as f:
        yaml_raw = yaml.safe_load(f)
    counts = {"gather_rows": {}, "sparse_adagrad_update_": {}, "gather_sum": {}}
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_fb15k_shaped(f"{tmp}/dataset")
        for tag, shape, fn, edit in (("lp_mesh_gspmd corrupt_rel", (MESH_DATA, MESH_NODE),
                                      "gspmd_rank", set_corrupt_rel),
                                     ("lp_mesh_gspmd uneven", GSPMD_UNEVEN, "mesh_rank", None)):
            raw = copy.deepcopy(yaml_raw)
            changed = "" if edit is None else f", {edit(raw)}"
            raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
            raw["storage"]["model_dir"] = f"{tmp}/model_{fn}"
            raw["training"]["num_epochs"] = GSPMD_EPOCHS
            single_raw = copy.deepcopy(raw)
            single_raw["storage"]["model_dir"] = f"{tmp}/single_{fn}"
            raw["training"]["mesh"] = {"data": shape[0], "node": shape[1]}
            print(f"{tag}: {config.relative_to(config.parents[2])} with dataset_dir and "
                  f"model_dir redirected{changed} and training.mesh {raw['training']['mesh']}; "
                  f"one cut: num_epochs {yaml_raw['training']['num_epochs']} -> {GSPMD_EPOCHS}",
                  flush=True)
            records = run_mesh_ranks(tag, raw, tmp, card, device, fn=fn, shape=shape)
            t0 = time.perf_counter()
            single = marius_train(load_config(single_raw), device=device)
            single_s = time.perf_counter() - t0
            again = marius_eval(load_config(raw), device=device)
            part = _check_mesh_records(tag, records, card, shape)
            for k in counts:
                counts[k].update(part[k])
            losses, ref = records[0]["losses"], [e["loss"] for e in single["epochs"]]
            if not np.allclose(losses, ref, rtol=5e-3, atol=0.0):
                raise AssertionError(f"{tag} losses {losses} differ from one process's {ref}")
            test = records[0]["printed"][0]
            if any(test[k] != again["test"][k] for k in metric_keys):
                raise AssertionError(f"{tag}: marius_eval of rank 0's checkpoint gave "
                                     f"{again['test']}, rank 0 printed {test}")
            seconds[tag] = records[0]["seconds"]
            print(f"{tag} against one process in this call: losses {losses} vs {ref} (rtol "
                  f"5e-3); s/epoch per rank {records[0]['seconds']} vs one process "
                  f"{[round(e['epoch_time_s'], 4) for e in single['epochs']]} ({single_s:.1f} s "
                  f"with its evaluations); edges/s per rank {records[0]['edges_per_sec']} vs "
                  f"{[round(e['edges_per_sec'], 1) for e in single['epochs']]}; test filtered "
                  f"MRR {test['mrr']:.6f} (one process {single['test']['mrr']:.6f}), reproduced "
                  f"exactly by marius_eval of rank 0's checkpoint  [{card}]", flush=True)
            if edit is not None:
                if any(rec["decoder_method"] != "CORRUPT_REL" for rec in records) or \
                        not test["mean_rank"] <= NUM_RELS:
                    raise AssertionError(f"{tag} must rank relations: {test}")
                for rec in records:
                    fo = rec["feature_only"]
                    want = {"gather_rows": 2, "sparse_adagrad_update_": 0, "gather_sum": 0}
                    if fo["launches"]["mesh"] != want or fo["collectives_per_batch"] != 1.0:
                        raise AssertionError(f"lp_mesh_gspmd feature_only rank {rec['rank']}: "
                                             f"launches {fo['launches']}, collectives "
                                             f"{fo['collectives_per_batch']} per batch")
                    if fo["leaves"] != records[0]["feature_only"]["leaves"]:
                        raise AssertionError(
                            f"lp_mesh_gspmd feature_only: rank {rec['rank']}'s parameters "
                            f"{fo['leaves']} differ from rank 0's "
                            f"{records[0]['feature_only']['leaves']} (the node axis holds "
                            f"replicas)")
                    counts["gather_rows"][f"lp_mesh_gspmd feature_only rank {rec['rank']}"] = \
                        fo["launches"]["mesh"]["gather_rows"]
                    print(f"lp_mesh_gspmd feature_only rank {rec['rank']} (FEATURE {DIM} with a "
                          f"bias at FB15K-237's shape, 2 batches on the 2 x 2 mesh and on one "
                          f"card): losses {fo['losses']['mesh']} vs {fo['losses']['single']}; "
                          f"leaves within rtol 1e-4 / atol 1e-5 (largest difference "
                          f"{fo['worst']:.3f} of atol past rtol); every rank's parameters "
                          f"equal; collectives per batch {fo['collectives_per_batch']}; "
                          f"launches {fo['launches']}  [{card}]", flush=True)
    return {**counts, "s_per_epoch": seconds}


def _buffer_trainer(config_path: str, mesh, dev):
    """The PartitionBufferLPTrainer marius_train builds for the config, with
    a model of its own (the decoder's relations are its module's)."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.storage.dataset import load_split, load_stats
    from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer

    cfg = load_config(config_path)
    ds, s, t = cfg.storage.dataset.dataset_dir, cfg.storage, cfg.training
    stats = load_stats(ds)
    return PartitionBufferLPTrainer(
        cfg.model, stats.num_nodes,
        stats.num_relations, load_split(ds, "train", stats), t.negative_sampling,
        batch_size=t.batch_size, num_partitions=s.num_partitions,
        buffer_capacity=s.buffer_capacity, seed=t.seed, ordering=s.edge_bucket_ordering,
        fine_to_coarse_ratio=s.fine_to_coarse_ratio,
        num_cache_partitions=s.num_cache_partitions,
        randomly_assign_edge_buckets=s.randomly_assign_edge_buckets,
        sparse_writeback=s.sparse_writeback, mesh=mesh, device=dev)


def _buffer_leaves(trainer, mesh) -> dict:
    """The buffer trainer's leaves now, on the device in the single-device
    layout: the buffer's values and Adagrad state (assembled over the node
    axis on a mesh), the dense parameters; and each one's Adagrad
    accumulator (the table's state, the dense optimizer's sums)."""
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.parallel.mesh import NODE_AXIS

    buf = trainer.buffer
    values, state = buf.device_values, buf.device_state
    if mesh is not None:
        values = mesh.all_gather_rows(values.contiguous(), NODE_AXIS)
        state = mesh.all_gather_rows(state.contiguous(), NODE_AXIS)
    rows = buf.buffer_rows
    params = [p.detach().clone() for p in tree_leaves(trainer.params)]
    if set(trainer.opt_state.slots) != {"sum"}:
        raise ValueError("the check reads Adagrad's dense accumulators")
    sums = [t.detach().clone() for t in tree_leaves(trainer.opt_state.slots)]
    return {"leaves": [values[:rows].clone(), state[:rows].clone()] + params,
            "accumulators": [state[:rows].clone(), state[:rows].clone()] + sums}


def oocore_mesh_rank(config_path: str, device=None) -> int:
    """One rank of lp_oocore_mesh: the command line's ``train`` of
    freebase86m_comet.yaml on the 2 x 2 mesh (this rank's shard of the
    buffer, its peak device bytes and the bytes its evictions' all_gathers
    received), then, in a second process group, the first OOC_MESH_STATES
    buffer states on the mesh and on this rank's card alone from the same
    seed with the same injected in-buffer draws: every batch's loss to rtol
    1e-4 / atol 1e-5; after the first batch the buffer (values and Adagrad
    state), the relations and their accumulators to the same tolerance but
    for elements whose accumulator is nonzero and below ACC_FLOOR, which are
    counted (ROADMAP C5); after the states the flushed host table's and the
    relations' largest differences, reported beside those between two
    one-card trainers that sum the table's gradients in another order.
    Prints ``MESH_RANK {...}``."""
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum
    from marius_tpu_torch.parallel import multihost
    from marius_tpu_torch.parallel.mesh import make_mesh
    from marius_tpu_torch.train.buffer_trainer import PartitionBufferLPTrainer

    result, train, launches, peaks = _train_in_group(config_path, device,
                                                     PartitionBufferLPTrainer)
    tr = result["runtime"].trainer
    buf = tr.buffer
    epochs = result["epochs"]
    record = {**_rank_record(result, train, launches), "mode": "explicit", "hop_caps": None,
              "batches_run": [e["batches_run"] for e in epochs],
              "gathered_bytes": [e["gathered_bytes"] for e in epochs],
              "states": [e["states_run"] for e in epochs], "peak_bytes": peaks,
              "shard_rows": buf.shard_size, "buffer_rows": buf.buffer_rows,
              "pair_bytes": 2 * buf.buffer_rows * buf.dim * 4,
              "shard_bytes": 2 * buf.shard_size * buf.dim * 4}
    del result, tr, buf
    gc.collect()
    torch.cuda.empty_cache()

    kernels = {"gather_rows": gather, "sparse_adagrad_update_": adagrad, "gather_sum": nbr_sum}
    dev = _check_group(device)
    try:
        mesh = make_mesh(MESH_DATA, MESH_NODE, device=dev)
        out = {}
        # a second one-card trainer that sums the table's gradients per
        # occurrence (dense_accum) instead of per unique row: how far apart
        # the summation order alone puts two one-card runs
        for name, m, occurrence in (("mesh", mesh, False), ("single", None, False),
                                    ("occurrence", None, True)):
            t = _buffer_trainer(config_path, m, dev)
            t.dense_accum = occurrence
            t._in_buffer_draws = lambda step, inverse, _t=t: injected_draws(_t, step, inverse)
            losses, first = [], {}
            step = t._batch_step

            def recorded(*args, _t=t, _m=m, _step=step, _losses=losses, _first=first, **kwargs):
                loss = _step(*args, **kwargs)
                _losses.append(float(loss))
                if len(_losses) == 1:
                    _first.update(_buffer_leaves(_t, _m))
                return loss

            t._batch_step = recorded
            before = {k: km.launches for k, km in kernels.items()}
            res = t.train_epoch(max_states=OOC_MESH_STATES, final_flush=False)
            launched = {k: km.launches - before[k] for k, km in kernels.items()}
            device_rows = t.buffer.device_values.shape[0]
            t.buffer.flush()
            out[name] = {"losses": losses, "first": first, "batches": res["batches_run"],
                         "device_rows": device_rows, "launches": launched,
                         "host": [torch.from_numpy(t.buffer.host_values),
                                  torch.from_numpy(t.buffer.host_state)]
                         + [p.detach() for p in tree_leaves(t.params)]}
        got, want = out["mesh"], out["single"]
        _assert_close(torch.tensor(got["losses"]), torch.tensor(want["losses"]), "batch losses")
        # after the first batch every leaf, but for elements whose Adagrad
        # accumulator is nonzero and below ACC_FLOOR (ROADMAP C5)
        worst = unheld = elements = 0
        for j, (g, w, acc) in enumerate(zip(got["first"]["leaves"], want["first"]["leaves"],
                                            want["first"]["accumulators"])):
            held = (acc == 0) | (acc >= ACC_FLOOR)
            worst = max(worst, _assert_close(g[held], w[held], f"leaf {j} after one batch"))
            unheld += int((~held).sum())
            elements += int(held.numel())
        # after the states: reported, not held (C5 amplifies the other summation order)
        def apart(a, b):
            return [(float((g - w).abs().max()), int((~torch.isclose(g, w, rtol=1e-4,
                                                                       atol=1e-5)).sum()))
                    for g, w in zip(a, b)]

        after = apart(got["host"], want["host"])
        record["states_check"] = {
            "losses": [sum(got["losses"]), sum(want["losses"])], "worst": worst,
            "unheld": unheld, "elements": elements, "after": after,
            "order": apart(out["occurrence"]["host"], want["host"]),
            "sizes": [int(t.numel()) for t in want["host"]],
            "device_rows": [got["device_rows"], want["device_rows"]],
            "batches": got["batches"], "launches": got["launches"]}
    finally:
        multihost.shutdown()
    print("MESH_RANK " + json.dumps(record), flush=True)
    return 0


def lp_oocore_mesh(card: str, device=None) -> dict:
    """freebase86m_comet.yaml's model and layout (ComplEx d = 100, 16
    partitions, capacity 8, COMET) at lp_oocore_reload's 1,000,000-node cut
    on a 2 x 2 mesh of four rank processes (the command line,
    OOC_MESH_EPOCHS epoch, the model saved): each rank's card holds half the
    buffer pair; each rank's loss held to one process's run in this call
    (rtol 5e-3); marius_eval in this process reproduces rank 0's metrics from
    its checkpoint; and each rank's first OOC_MESH_STATES states held to one
    card's (``oocore_mesh_rank``)."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train

    keys = ("mrr", "mean_rank", "hits@1", "hits@10", "num_evaluated")
    tag = "lp_oocore_mesh"
    with tempfile.TemporaryDirectory() as tmp:
        write_freebase_shaped(f"{tmp}/dataset", RELOAD_NODES, RELOAD_TRAIN_EDGES,
                              RELOAD_EVAL_EDGES)
        raw = freebase_raw(tmp, save_model=True, epochs=OOC_MESH_EPOCHS)
        cfg = freebase_config(tmp, RELOAD_NODES, save_model=True, epochs=OOC_MESH_EPOCHS)
        raw["training"]["mesh"] = {"data": MESH_DATA, "node": MESH_NODE}
        raw["storage"]["model_dir"] = f"{tmp}/model_mesh"
        print(f"{tag}: freebase86m_comet.yaml with dataset_dir and model_dir redirected and "
              f"training.mesh {raw['training']['mesh']}; cuts: {RELOAD_NODES} nodes (published "
              f"86,054,151), {RELOAD_TRAIN_EDGES} train and {RELOAD_EVAL_EDGES} valid and test "
              f"edges, num_epochs 10 -> {OOC_MESH_EPOCHS}", flush=True)
        records = run_mesh_ranks(tag, raw, tmp, card, device, fn="oocore_mesh_rank")
        t0 = time.perf_counter()
        single = marius_train(cfg, device=device)
        single_s = time.perf_counter() - t0
        again = marius_eval(load_config(raw), device=device)
    counts = {"gather_rows": {}, "sparse_adagrad_update_": {}, "gather_sum": {}}
    test = records[0]["printed"][0]
    for rec in records:
        if rec["shape"] != {"data": MESH_DATA, "node": MESH_NODE} or \
                rec["losses"] != records[0]["losses"]:
            raise AssertionError(f"{tag}: rank {rec['rank']} is off the mesh or its losses "
                                 f"{rec['losses']} differ from rank 0's")
        if (len(rec["printed"]) == 1) != (rec["rank"] == 0):
            raise AssertionError(f"{tag}: rank {rec['rank']} printed {rec['printed']}")
        batches = sum(rec["batches_run"])
        want = {"gather_rows": batches, "sparse_adagrad_update_": batches, "gather_sum": 0}
        if rec["train_launches"] != want:
            raise AssertionError(f"{tag}: rank {rec['rank']} launched {rec['train_launches']} "
                                 f"in training, expected {want}")
        check = rec["states_check"]
        share = -(-rec["buffer_rows"] // MESH_NODE)
        if rec["shard_rows"] != share or check["device_rows"] != [share, rec["buffer_rows"]]:
            raise AssertionError(f"{tag}: rank {rec['rank']}'s card held {check['device_rows']} "
                                 f"buffer rows (mesh, one card) of {rec['buffer_rows']}, not its "
                                 f"node index's share {share}")
        for k, n in rec["train_launches"].items():
            if n:
                counts[k][f"{tag} rank {rec['rank']} train"] = n
        for k, n in check["launches"].items():
            if n:
                counts[k][f"{tag} rank {rec['rank']} states check"] = n
        print(f"{tag} rank {rec['rank']}: backend {rec['backend']} on {rec['device']} at "
              f"{rec['coords']}; shard {rec['shard_rows']} of {rec['buffer_rows']} buffer rows "
              f"({rec['shard_bytes']} bytes with its Adagrad state, the whole pair "
              f"{rec['pair_bytes']}); peak device bytes per epoch {rec['peak_bytes']}; losses "
              f"{rec['losses']}; s/epoch {rec['seconds']}; edges/s "
              f"{[round(x, 1) for x in rec['rates']]}; {rec['batches_run']} batches over "
              f"{rec['states']} states; collectives per batch {rec['collectives_per_batch']}; "
              f"eviction all_gathers received {rec['gathered_bytes']} bytes "
              f"({[round(b / max(1, s), 1) for b, s in zip(rec['gathered_bytes'], rec['states'])]}"
              f" per state); launches in training {rec['train_launches']}  [{card}]", flush=True)
        print(f"{tag} rank {rec['rank']} first {OOC_MESH_STATES} states against one card "
              f"({check['batches']} batches): every batch's loss within rtol 1e-4 / atol 1e-5 "
              f"(sums {check['losses']}); after the first batch the buffer, its Adagrad state, "
              f"the relations and their accumulators within rtol 1e-4 / atol 1e-5 (largest "
              f"difference {check['worst']:.3f} of atol past rtol; {check['unheld']} of "
              f"{check['elements']} elements with a nonzero accumulator below {ACC_FLOOR} not "
              f"held, ROADMAP C5); after the states (largest difference, elements past the "
              f"tolerance) host table {check['after'][0]}, Adagrad state {check['after'][1]}, "
              f"relations {check['after'][2:]} of {check['sizes']} elements (reported, C5); "
              f"two one-card trainers that differ only in summing the table gradients per "
              f"unique row or per occurrence: {check['order'][0]}, {check['order'][1]}, "
              f"{check['order'][2:]}  [{card}]", flush=True)
    losses, ref = records[0]["losses"], [e["loss"] for e in single["epochs"]]
    if not np.allclose(losses, ref, rtol=5e-3, atol=0.0):
        raise AssertionError(f"{tag} losses {losses} differ from one process's {ref}")
    if any(test[k] != again["test"][k] for k in keys):
        raise AssertionError(f"{tag}: marius_eval of rank 0's checkpoint gave {again['test']}, "
                             f"rank 0 printed {test}")
    print(f"{tag} against one process in this call: losses {losses} vs {ref} (rtol 5e-3); "
          f"s/epoch per rank {records[0]['seconds']} vs one process "
          f"{[round(e['epoch_time_s'], 4) for e in single['epochs']]} ({single_s:.1f} s with "
          f"its evaluations); test MRR {test['mrr']:.6f} (one process "
          f"{single['test']['mrr']:.6f}), reproduced exactly by marius_eval of rank 0's "
          f"checkpoint  [{card}]", flush=True)
    return {**counts, "s_per_epoch": records[0]["seconds"]}


def _nc_dp_reference(single, seeds, mask, draws, caps):
    """One data-parallel NC batch computed on one card: each data index's
    part sampled with its own ``draws`` under ``caps`` and scored, the parts'
    SUM losses added, one backward, one Adam step. Returns (loss, dense
    gradients)."""
    from marius_tpu_torch.nn.model import nc_batch_loss
    from marius_tpu_torch.nn.optimizers import apply_optimizer, tree_leaves, tree_map

    st, model = single.state, single.model
    parts = len(draws)
    bl = seeds.shape[0] // parts
    total = 0.0
    for i, draw in enumerate(draws):
        s, m = seeds[i * bl:(i + 1) * bl], mask[i * bl:(i + 1) * bl]
        nb, feats, emb = single._encode_batch(None, draw, s, m, caps)
        logits = single._sampled_logits(st.params, nb, feats, emb, True)
        total = total + nc_batch_loss(model, logits, single.labels[s.clamp(max=single.num_nodes)],
                                      m & nb.seed_mask)
    leaves = tree_leaves(st.params)
    grads = torch.autograd.grad(total, leaves)
    it = iter(grads)
    _, st.opt_state = apply_optimizer(model.dense_optimizer, st.params, st.opt_state,
                                      tree_map(lambda _: next(it), st.params))
    return float(total), grads


def nc_mesh_rank(config_path: str, device=None) -> int:
    """One rank of nc_mesh: the command line's ``train`` of ogbn_arxiv.yaml
    on the data-parallel mesh, then, in a second process group, one sampled
    batch on the mesh against one card's computation of the same (each data
    index's seeds with its own injected draws, ``_nc_dp_reference``), and
    train_nc's LINEAR collapse model (every hop ALL) for one epoch on the
    mesh and on one card, every batch's loss held at rtol 1e-4 / atol 1e-5.
    Prints ``MESH_RANK {...}``."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig, seeded_draws
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum
    from marius_tpu_torch.parallel import multihost
    from marius_tpu_torch.parallel.mesh import make_mesh
    from marius_tpu_torch.storage.dataset import (
        load_features,
        load_labels,
        load_node_split,
        load_split,
        load_stats,
    )
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    result, train, launches, peaks = _train_in_group(config_path, device,
                                                     NodeClassificationTrainer)
    tr = result["runtime"].trainer
    record = {**_rank_record(result, train, launches, "nodes_per_sec"), "mode": "explicit",
              "batches": tr.num_batches, "hop_caps": list(tr.hop_caps), "peak_bytes": peaks,
              "valid": [e["accuracy"] for e in result["evals"]]}
    del result, tr
    gc.collect()

    cfg = load_config(config_path)
    ds = cfg.storage.dataset.dataset_dir
    stats = load_stats(ds)
    edges = load_split(ds, "train", stats)
    feats, labels = load_features(ds), load_labels(ds)
    train_nodes = load_node_split(ds, "train")
    n = stats.num_nodes
    kernels = {"gather_rows": gather, "sparse_adagrad_update_": adagrad, "gather_sum": nbr_sum}
    dev = _check_group(device)
    try:
        mesh = make_mesh(NC_MESH[0], NC_MESH[1], device=dev)
        graph = build_device_graph(edges, n, device=dev)
        nbr = cfg.train_neighbor_sampling
        caps = tuple(cfg.hop_caps)

        def sampled(m):
            return NodeClassificationTrainer(load_config(config_path).model, graph, feats, labels,
                                             train_nodes, nbr, batch_size=cfg.training.batch_size,
                                             hop_caps=caps, seed=cfg.training.seed, mesh=m,
                                             device=dev)

        meshed, single = sampled(mesh), sampled(None)
        draws = [seeded_draws(77, i, dev) for i in range(NC_MESH[0])]
        meshed._batch_draws = lambda data_index=0: draws[data_index]
        perm = meshed._epoch_permutation(0)
        seeds, mask = meshed.train_nodes[perm[:meshed.batch_size]], \
            perm[:meshed.batch_size] < meshed.num_train
        before = {k: km.launches for k, km in kernels.items()}
        loss, _ = meshed._mesh_sampled_batch_step(seeds, mask)
        batch_launches = {k: km.launches - before[k] for k, km in kernels.items()}
        ref_loss, grads = _nc_dp_reference(single, seeds, mask,
                                           [seeded_draws(77, i, dev) for i in range(NC_MESH[0])],
                                           caps)
        _assert_close(loss.reshape(1), torch.tensor([ref_loss]), "the batch's loss")
        worst = unheld = 0
        for j, (g, w, grad) in enumerate(zip(tree_leaves(meshed.state.params),
                                             tree_leaves(single.state.params), grads)):
            wj, uj = _held_close(g, w, grad, f"leaf {j}")
            worst, unheld = max(worst, wj), unheld + uj
        record["sampled_check"] = {"loss": [float(loss), ref_loss], "worst": worst,
                                   "unheld": unheld, "launches": batch_launches,
                                   "elements": sum(int(g.numel()) for g in grads)}
        del meshed, single

        adj = build_full_graph_adjacency(edges, n).to(dev)

        def collapse(m):
            return NodeClassificationTrainer(
                nc_model(ARXIV_FEATS, (NC_DIM, NC_DIM, ARXIV_CLASSES)),
                graph, feats, labels, train_nodes, [NeighborSamplingConfig("ALL")] * NC_GNN_STAGES,
                batch_size=cfg.training.batch_size, seed=0, mesh=m, full_graph=adj, device=dev)

        pairs = (("mesh", collapse(mesh)), ("single", collapse(None)))
        if any(t._fg_collapse is None for _, t in pairs):
            raise AssertionError("train_nc's model must train through the linear collapse")
        losses = {name: [] for name, _ in pairs}
        counts = {name: dict.fromkeys(kernels, 0) for name, _ in pairs}
        seconds = {}
        for name, t in pairs:
            perm = t._epoch_permutation(0)
            shuffled = t.train_nodes[perm].reshape(t.num_batches, t.batch_size)
            masks = (perm < t.num_train).reshape(t.num_batches, t.batch_size)
            before = {k: km.launches for k, km in kernels.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            batch_losses = [t._batch_step(shuffled[i], masks[i], None)
                            for i in range(t.num_batches)]
            losses[name] = torch.stack(batch_losses).cpu()
            seconds[name] = time.perf_counter() - t0
            counts[name] = {k: km.launches - before[k] for k, km in kernels.items()}
        worst_c = _assert_close(losses["mesh"], losses["single"], "collapse batch losses")
        record["collapse_check"] = {"batches": len(losses["mesh"]), "worst": worst_c,
                                    "launches": counts, "seconds": seconds,
                                    "loss": [float(losses["mesh"].sum()),
                                             float(losses["single"].sum())]}
    finally:
        multihost.shutdown()
    print("MESH_RANK " + json.dumps(record), flush=True)
    return 0


def nc_mesh(card: str, data, device=None) -> dict:
    """ogbn_arxiv.yaml at the arxiv shape on a data-parallel {data: 2, node:
    1} mesh of two rank processes (the command line, NC_MESH_EPOCHS epoch):
    the same losses on both ranks, the test accuracy beside one process's
    run in this call and above 4x chance; then each rank's sampled batch and
    collapse epoch against one card (``nc_mesh_rank``)."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_train

    config = Path(__file__).resolve().parent / "examples" / "configuration" / "ogbn_arxiv.yaml"
    with open(config) as f:
        yaml_raw = yaml.safe_load(f)
    tag = "nc_mesh"
    with tempfile.TemporaryDirectory() as tmp:
        write_arxiv_shaped(f"{tmp}/dataset", data)
        raw = copy.deepcopy(yaml_raw)
        raw["storage"]["dataset"]["dataset_dir"] = f"{tmp}/dataset"
        raw["storage"]["model_dir"] = f"{tmp}/model"
        raw["training"]["num_epochs"] = NC_MESH_EPOCHS
        single_raw = copy.deepcopy(raw)
        raw["training"]["mesh"] = {"data": NC_MESH[0], "node": NC_MESH[1]}
        print(f"{tag}: {config.relative_to(config.parents[2])} with dataset_dir and model_dir "
              f"redirected and training.mesh {raw['training']['mesh']}; one cut: num_epochs "
              f"{yaml_raw['training']['num_epochs']} -> {NC_MESH_EPOCHS}", flush=True)
        records = run_mesh_ranks(tag, raw, tmp, card, device, fn="nc_mesh_rank", shape=NC_MESH)
        t0 = time.perf_counter()
        single = marius_train(load_config(single_raw), device=device)
        single_s = time.perf_counter() - t0
    counts = {"gather_rows": {}, "sparse_adagrad_update_": {}, "gather_sum": {}}
    test = records[0]["printed"][0]
    for rec in records:
        if rec["shape"] != {"data": NC_MESH[0], "node": NC_MESH[1]} or \
                rec["losses"] != records[0]["losses"] or rec["test"] != records[0]["test"]:
            raise AssertionError(f"{tag}: rank {rec['rank']} is off the mesh or differs from "
                                 f"rank 0: {rec}")
        if (len(rec["printed"]) == 1) != (rec["rank"] == 0):
            raise AssertionError(f"{tag}: rank {rec['rank']} printed {rec['printed']}")
        batches = NC_MESH_EPOCHS * rec["batches"]
        want = {"gather_rows": batches, "sparse_adagrad_update_": 0, "gather_sum": 3 * batches}
        if rec["train_launches"] != want:
            raise AssertionError(f"{tag}: rank {rec['rank']} launched {rec['train_launches']} "
                                 f"in training, expected {want}")
        sc, cc = rec["sampled_check"], rec["collapse_check"]
        if sc["launches"] != {"gather_rows": 1, "sparse_adagrad_update_": 0, "gather_sum": 3}:
            raise AssertionError(f"{tag}: the checked batch launched {sc['launches']}")
        for k, n in rec["train_launches"].items():
            if n:
                counts[k][f"{tag} rank {rec['rank']} train"] = n
        for k, n in sc["launches"].items():
            if n:
                counts[k][f"{tag} rank {rec['rank']} sampled check"] = n
        for k, n in cc["launches"]["mesh"].items():
            if n:
                counts[k][f"{tag} rank {rec['rank']} collapse"] = n
        print(f"{tag} rank {rec['rank']}: backend {rec['backend']} on {rec['device']} at "
              f"{rec['coords']}; local hop caps {rec['hop_caps']}; losses {rec['losses']}; "
              f"s/epoch {rec['seconds']}; train nodes/s {[round(x, 1) for x in rec['rates']]}; "
              f"collectives per batch {rec['collectives_per_batch']}; peak device bytes "
              f"{rec['peak_bytes']}; valid accuracy {rec['valid']}; launches in training "
              f"{rec['train_launches']}  [{card}]", flush=True)
        print(f"{tag} rank {rec['rank']} sampled batch against one card (each index's seeds "
              f"with its own draws): loss {sc['loss'][0]:.6f} vs {sc['loss'][1]:.6f}; "
              f"parameters within rtol 1e-4 / atol 1e-5 (largest difference {sc['worst']:.3f} "
              f"of atol past rtol; {sc['unheld']} of {sc['elements']} elements with a gradient "
              f"below 1e-6 not held, ROADMAP C5); launches {sc['launches']}  [{card}]",
              flush=True)
        print(f"{tag} rank {rec['rank']} collapse (train_nc's LINEAR model, every hop ALL): "
              f"{cc['batches']} batch losses on the mesh equal one card's within rtol 1e-4 / "
              f"atol 1e-5 (largest difference {cc['worst']:.3f} of atol past rtol), epoch loss "
              f"{cc['loss'][0]:.6f} vs {cc['loss'][1]:.6f}; s/epoch {cc['seconds']['mesh']:.4f} "
              f"vs one card {cc['seconds']['single']:.4f}; launches {cc['launches']}  [{card}]",
              flush=True)
    ref = single["test"]["accuracy"]
    if not test["accuracy"] > 4.0 / ARXIV_CLASSES:
        raise AssertionError(f"{tag} test accuracy {test['accuracy']} is not above 4x chance")
    print(f"{tag} against one process in this call: losses {records[0]['losses']} vs "
          f"{[e['loss'] for e in single['epochs']]}; s/epoch per rank {records[0]['seconds']} "
          f"vs one process {[round(e['epoch_time_s'], 4) for e in single['epochs']]} "
          f"({single_s:.1f} s with its evaluations); train nodes/s per rank "
          f"{[round(x, 1) for x in records[0]['rates']]} vs "
          f"{[round(e['nodes_per_sec'], 1) for e in single['epochs']]}; test accuracy "
          f"{test['accuracy']:.6f} vs one process {ref:.6f} (chance {1 / ARXIV_CLASSES})  "
          f"[{card}]", flush=True)
    return {**counts, "s_per_epoch": records[0]["seconds"]}


def mesh_dp_shapes(rates, card, data) -> dict:
    """The three kernels at this slice's new shapes on the card, each bit for
    bit against its plain version and timed beside its bound and its
    one-call PyTorch equivalent: the owner-local row gather of one
    freebase86m_comet.yaml batch's 30,000 unique ids into node index 1's half
    (250,000 x 100) of lp_oocore_mesh's 1,000,000-node buffer (the ids it
    does not own clamp to a row of the shard and are zeroed after); the
    unique-row Adagrad on that shard at those ids (the others skipped by the
    kernel's id >= N rule); and the gather-sum at ogbn_arxiv.yaml's layer 0
    for one data index's 500 seeds (UNIFORM 32, the YAML's hop caps)."""
    from torch.optim.adagrad import adagrad as torch_adagrad

    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.data.samplers.neighbor import (
        NeighborSamplingConfig,
        generator_draws,
        sample_neighbor_batch,
    )
    from marius_tpu_torch.ops.cuda import adagrad, gather
    from marius_tpu_torch.parallel.collectives import owner_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    psize = -(-RELOAD_NODES // FB86M_PARTITIONS)
    buffer_rows = FB86M_BUFFER * psize
    rows = -(-buffer_rows // MESH_NODE)
    ids = torch.randperm(buffer_rows, generator=g, device=dev)[:OOC_IDS]
    shard = torch.randn(rows, FB86M_DIM, device=dev, generator=g)
    local = ids - rows
    gat = time_gather(gather, shard, [local], rates)
    gat["max_abs_err"] = gather_max_err(gather, shard, local)
    print(f"gather_rows, lp_oocore_mesh owner-local (K={gat['k']} int64 ids into node index "
          f"1's {rows} x {FB86M_DIM} shard of the {buffer_rows}-row buffer, "
          f"{gat['distinct_rows']:.0f} distinct rows after the clamp, "
          f"{gat['bound_bytes'] / 1e6:.4f} MB): max_abs_err {gat['max_abs_err']}  kernel "
          f"{gat['ms'] * 1e3:.2f} us  plain {gat['plain_ms'] * 1e3:.2f} us  index_select "
          f"{gat['library_ms'] * 1e3:.2f} us  bound {gat['bound_ms'] * 1e3:.2f} us "
          f"({gat['bound_by']})  [{card}]", flush=True)

    class NodeOne:
        shape = {"node": MESH_NODE}

        def axis_index(self, axis):
            return 1

    owned = owner_rows(ids, rows, NodeOne(), buffer_rows)
    mine = int((owned < rows).sum())
    G = torch.randn(OOC_IDS, FB86M_DIM, device=dev, generator=g)
    values, state = torch.randn(rows, FB86M_DIM, device=dev, generator=g), torch.rand(
        rows, FB86M_DIM, device=dev, generator=g)
    v1, s1, v2, s2 = values.clone(), state.clone(), values.clone(), state.clone()
    adagrad.sparse_adagrad_update_(v1, s1, owned, G, 0.1)
    adagrad.sparse_adagrad_update_plain_(v2, s2, owned, G, 0.1)
    torch.cuda.synchronize()
    err = max(float((v1 - v2).abs().max()), float((s1 - s2).abs().max()))
    if err != 0.0:
        raise AssertionError(f"sparse_adagrad_update_ differs from plain on the buffer shard: "
                             f"{err}")
    # this node index's rows: values and state read and written, its G rows read, all ids read
    nbytes = 5 * mine * FB86M_DIM * 4 + OOC_IDS * 8
    b_ms, b_by = bound_ms(nbytes, 7 * mine * FB86M_DIM, rates)
    keep = owned < rows
    sparse = torch.sparse_coo_tensor(owned[keep][None], G[keep], (rows, FB86M_DIM),
                                     is_coalesced=True, check_invariants=False)
    v3, s3, step = values.clone(), state.clone(), torch.zeros((), device=dev)

    def library():
        torch_adagrad([v3], [sparse], [s3], [step], has_sparse_grad=True, lr=0.1,
                      weight_decay=0.0, lr_decay=0.0, eps=1e-10, maximize=False)

    ada = {"k": OOC_IDS, "owned_rows": mine, "d": FB86M_DIM, "max_abs_err": err,
           "ms": time_ms(lambda: adagrad.sparse_adagrad_update_(v1, s1, owned, G, 0.1)),
           "plain_ms": time_ms(lambda: adagrad.sparse_adagrad_update_plain_(
               v2, s2, owned, G, 0.1)),
           "library_ms": time_ms(library), "bound_ms": b_ms, "bound_by": b_by,
           "bound_bytes": nbytes, "plan": adagrad.tensor_plan(v1, s1, owned, G)._asdict()}
    print(f"sparse_adagrad_update_, lp_oocore_mesh unique rows on the shard ({OOC_IDS} ids, "
          f"{mine} owned by node index 1, x {FB86M_DIM}, {nbytes / 1e6:.4f} MB): max_abs_err "
          f"{err}  kernel {ada['ms'] * 1e3:.2f} us  plain {ada['plain_ms'] * 1e3:.2f} us  "
          f"torch.optim.adagrad (sparse) {ada['library_ms'] * 1e3:.2f} us  bound "
          f"{b_ms * 1e3:.2f} us ({b_by})  plan {plan_text(ada['plan'])}  [{card}]", flush=True)

    edges, features, _, train_nodes = data
    graph = build_device_graph(edges, ARXIV_NODES, device=dev)
    configs = (NeighborSamplingConfig("UNIFORM", max_neighbors=32),) * NC_GNN_STAGES
    seeds = torch.as_tensor(train_nodes[:1000 // NC_MESH[0]], device=dev).long()
    nb = sample_neighbor_batch(generator_draws(g), graph, seeds,
                               torch.ones_like(seeds, dtype=torch.bool), configs,
                               (1000, 16384, 65536, 169344))
    sums = time_layer_sum(nb.layers[0], nb.node_ids[0].shape[0], NC_DIM, rates, dev)
    print(f"gather_sum, nc_mesh layer 0 of one data index ({sums['targets']} targets x "
          f"{sums['width']} slots, {sums['valid_slots']} real, {sums['distinct_rows']} distinct "
          f"rows of {nb.node_ids[0].shape[0]}, d={NC_DIM}, {sums['bound_bytes'] / 1e6:.4f} MB): "
          f"max_abs_err {sums['max_abs_err']}  kernel {sums['ms'] * 1e3:.2f} us (with the "
          f"layout built: {sums['with_layout_ms'] * 1e3:.2f} us)  plain "
          f"{sums['plain_ms'] * 1e3:.2f} us  embedding_bag {sums['library_ms'] * 1e3:.2f} us  "
          f"bound {sums['bound_ms'] * 1e3:.2f} us ({sums['bound_by']})  [{card}]", flush=True)
    return {"gather_rows": gat, "sparse_adagrad_update_": ada, "gather_sum": sums}


# -- the node-sharded full-graph ring ---------------------------------------------


def ring_model(name: str):
    """nc_ring's models at full width: ogbn_arxiv.yaml's FEATURE + 3 x
    GraphSAGE MEAN (``nc_model``), gat8 and RGCN (``arxiv_gnn_model``)."""
    if name == "sage":
        return nc_model(ARXIV_FEATS, (NC_DIM, NC_DIM, ARXIV_CLASSES))
    return arxiv_gnn_model(name.upper())


def ring_edges(name: str, edges: np.ndarray) -> np.ndarray:
    """RGCN's edges carry 8 relations drawn from a seed (nc_full_graph_gnn's)."""
    if name != "rgcn":
        return edges
    r = np.random.default_rng(8).integers(0, ARXIV_RELS, len(edges)).astype(np.int32)
    return np.stack([edges[:, 0], r, edges[:, 1]], 1)


def ring_trainer(name: str, data, dev, mesh=None):
    """The model's full-graph trainer at arxiv shape (never the collapse): on
    ``mesh`` the node-sharded ring, else one card's (seed-restricted final
    stage, the default)."""
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.data.graph import build_device_graph
    from marius_tpu_torch.train.nc import NodeClassificationTrainer

    edges, features, labels, train_nodes = data
    e, rels = ring_edges(name, edges), name == "rgcn"
    adj = build_full_graph_adjacency(e, ARXIV_NODES, with_relations=rels)
    graph = build_device_graph(e, ARXIV_NODES, ARXIV_RELS if rels else 1, device=dev)
    return NodeClassificationTrainer(ring_model(name), graph, features, labels, train_nodes,
                                     batch_size=BATCH, seed=0, full_graph=adj, mesh=mesh,
                                     fg_linear_collapse=False, device=dev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_reset(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def ring_run(trainer, data, dev) -> dict:
    """NC_RING_BATCHES batches of epoch 0's permutation, each timed (synced)
    with its ring hops, bytes and waits; then one evaluation over the
    non-train nodes. The three kernels' counts are set to 0 before each part
    and read after it."""
    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum
    from marius_tpu_torch.train.nc import NodeClassificationEvaluator

    kernels = {"gather_rows": gather, "sparse_adagrad_update_": adagrad, "gather_sum": nbr_sum}
    nb, mesh = NC_RING_BATCHES, trainer.mesh
    perm = trainer._epoch_permutation(0)[:nb * BATCH].to(dev)
    seeds = trainer.train_nodes[perm].reshape(nb, BATCH)
    masks = (perm < trainer.num_train).reshape(nb, BATCH)
    slots = (trainer._batch_slot_counts(seeds, masks) if trainer._fg_seed_restrict
             else [None] * nb)
    out = {"losses": [], "seconds": [], "hops": [], "ring_bytes": [], "wait_s": [],
           "post_s": [], "device_wait_s": []}
    for m in kernels.values():
        m.launches = 0
    for i in range(nb):
        if mesh is not None:
            before = (mesh.collectives, mesh.ring_bytes, mesh.ring_wait_s, mesh.ring_post_s)
            mesh.ring_wait_device_s()
        _sync(dev)
        t0 = time.perf_counter()
        loss = float(trainer._batch_step(seeds[i], masks[i], slots[i]))
        _sync(dev)
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        if mesh is not None:
            out["hops"].append(mesh.collectives - before[0])
            out["ring_bytes"].append(mesh.ring_bytes - before[1])
            out["wait_s"].append(mesh.ring_wait_s - before[2])
            out["post_s"].append(mesh.ring_post_s - before[3])
            out["device_wait_s"].append(mesh.ring_wait_device_s())
    out["train_launches"] = {k: m.launches for k, m in kernels.items()}
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"{trainer.model.encoder} losses are not finite: {out['losses']}")
    eval_nodes = np.setdiff1d(np.arange(ARXIV_NODES), data[3])
    for m in kernels.values():
        m.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    acc = NodeClassificationEvaluator(trainer, eval_nodes).evaluate(trainer.state)
    out["eval_s"] = time.perf_counter() - t0
    out["eval_launches"] = {k: m.launches for k, m in kernels.items()}
    out["accuracy"], out["num_evaluated"] = acc["accuracy"], acc["num_evaluated"]
    return out


def ring_data(path: str):
    """The arxiv-shaped (edges, features, labels, train nodes) saved by nc_ring."""
    f = np.load(path)
    return f["edges"], f["features"], f["labels"], f["train"]


def nc_ring_rank(config_path: str, device=None) -> int:
    """One rank of nc_ring, in a process of its own: joins the process group
    of MESH_CHECK_COORDINATOR, lays the config's mesh over it, and for each
    model builds the ring trainer (set-up seconds), runs ``ring_run`` and
    reads the card's peak bytes. Prints ``MESH_RANK {...}``."""
    from marius_tpu_torch.parallel import multihost
    from marius_tpu_torch.parallel.mesh import make_mesh

    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    dev = _check_group(device)
    try:
        mesh = make_mesh(*cfg["mesh"], device=dev)
        mesh.ring_timing = True
        data = ring_data(cfg["data"])
        record = {"rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend,
                  "device": str(dev), "shape": mesh.shape, "models": {}}
        for name in cfg["models"]:
            _peak_reset(dev)
            t0 = time.perf_counter()
            trainer = ring_trainer(name, data, dev, mesh)
            setup_s = time.perf_counter() - t0
            if trainer._ring_axis != "node" or trainer._fg_collapse is not None:
                raise AssertionError(f"nc_ring {name} is not on the node ring")
            out = ring_run(trainer, data, dev)
            out.update(setup_s=setup_s, peak_bytes=_peak(dev),
                       n_loc=trainer._ring_rows[1])
            record["models"][name] = out
            del trainer
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        multihost.shutdown()
    print("MESH_RANK " + json.dumps(record), flush=True)
    return 0


def nc_ring(card: str, data, device=None, models=NC_RING_MODELS, shape=NC_RING) -> dict:
    """The node-sharded full-graph ring at arxiv shape: rank processes of
    ``nc_ring_rank`` on a {data: 1, node: S} mesh (two gloo ranks sharing
    this card; one NCCL rank per card where each rank has one) train each
    model NC_RING_BATCHES batches and evaluate, then this process runs one
    card's trainer of each over the same batches: the losses held at
    NC_RING_RTOL, the accuracies side by side, s per batch, hops and ring
    bytes per batch, the wait shares and peak bytes printed."""
    tag = "nc_ring"
    dev = torch.device(device or "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        edges, features, labels, train_nodes = data
        np.savez(f"{tmp}/arxiv.npz", edges=edges, features=features, labels=labels,
                 train=train_nodes)
        raw = {"data": f"{tmp}/arxiv.npz", "mesh": list(shape), "models": list(models)}
        print(f"{tag}: {', '.join(models)} at arxiv shape on {{data: {shape[0]}, node: "
              f"{shape[1]}}}, {NC_RING_BATCHES} training batches of {BATCH} each and one "
              f"evaluation; one card's trainer of each after it  [{card}]", flush=True)
        records = run_mesh_ranks(tag, raw, tmp, card, device, fn="nc_ring_rank", shape=shape)
    counts = {"gather_rows": {}, "sparse_adagrad_update_": {}, "gather_sum": {}}
    summary = {}
    for name in models:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _peak_reset(dev)
        t0 = time.perf_counter()
        one_tr = ring_trainer(name, data, dev)
        setup_s = time.perf_counter() - t0
        one = ring_run(one_tr, data, dev)
        one_peak = _peak(dev)
        del one_tr
        rtol = NC_RING_RTOL[name]
        ranks = [rec["models"][name] for rec in records]
        for rec, got in zip(records, ranks):
            if got["losses"] != ranks[0]["losses"]:
                raise AssertionError(f"{tag} {name}: rank {rec['rank']}'s losses "
                                     f"{got['losses']} differ from rank 0's")
            np.testing.assert_allclose(got["losses"], one["losses"], rtol=rtol,
                                       err_msg=f"{tag} {name}: ring against one card")
            if got["accuracy"] != ranks[0]["accuracy"] or \
                    abs(got["accuracy"] - one["accuracy"]) > 5e-4:
                raise AssertionError(f"{tag} {name}: accuracy {got['accuracy']} against one "
                                     f"card's {one['accuracy']}")
            if got["num_evaluated"] != one["num_evaluated"]:
                raise AssertionError(f"{tag} {name}: evaluated {got['num_evaluated']} nodes")
            for part in ("train", "eval"):
                launched = got[f"{part}_launches"]
                if launched["sparse_adagrad_update_"] or not launched["gather_sum"] or (
                        name != "sage" and not launched["gather_rows"]):
                    raise AssertionError(f"{tag} {name}: rank {rec['rank']} {part} launched "
                                         f"{launched}")
                for k, n in launched.items():
                    if n:
                        counts[k][f"{tag} {name} rank {rec['rank']} {part}"] = n
            step = got["seconds"]
            waits = [w / t for w, t in zip(got["wait_s"], step)]
            posts = [w / t for w, t in zip(got["post_s"], step)]
            dwaits = [w / t for w, t in zip(got["device_wait_s"], step)]
            print(f"{tag} {name} rank {rec['rank']}: backend {rec['backend']} on "
                  f"{rec['device']} at {rec['coords']}, n_loc {got['n_loc']}; set-up "
                  f"{got['setup_s']:.2f} s; s per batch {[round(x, 4) for x in step]}; losses "
                  f"{got['losses']}; hops per batch {got['hops']}; ring MB sent per batch "
                  f"{[round(b / 1e6, 2) for b in got['ring_bytes']]}; share of the step in the "
                  f"hops' waits (host) {[round(x, 4) for x in waits]}, posting them (host; "
                  f"gloo's staging copy included) {[round(x, 4) for x in posts]}, the device's "
                  f"wait for card-to-card hops "
                  f"{[round(x, 4) for x in dwaits]}; peak device bytes {got['peak_bytes']}; "
                  f"accuracy {got['accuracy']:.6f} over {got['num_evaluated']:.0f} nodes in "
                  f"{got['eval_s']:.2f} s; launches training {got['train_launches']}, "
                  f"evaluation {got['eval_launches']}  [{card}]", flush=True)
        print(f"{tag} {name} one card: set-up {setup_s:.2f} s; s per batch "
              f"{[round(x, 4) for x in one['seconds']]}; losses {one['losses']} (the ring's "
              f"within rtol {rtol}); peak device bytes {one_peak}; accuracy "
              f"{one['accuracy']:.6f}; launches training {one['train_launches']}  [{card}]",
              flush=True)
        summary[name] = {"s_per_batch": ranks[0]["seconds"], "one_card_s": one["seconds"],
                         "peak_bytes": [r["peak_bytes"] for r in ranks],
                         "one_card_peak": one_peak}
    return {**counts, "summary": summary}


def ring_shapes(rates, card, data) -> dict:
    """The two kernels at the ring's per-step shapes on shard 0 of nc_ring's
    {data: 1, node: 2} mesh, each bit for bit against its plain version and
    timed beside its bound and one-call PyTorch equivalent: the SAGE ring's
    step sums (the visiting block's rows into the local rows, d = 128),
    GAT's per-slot gathers of the visiting R (d = 8) and value (d = 8 x 128)
    blocks and its numerator and visiting-gradient sums over slot positions
    (d = 1024), RGCN's cell gather (d = 128) and anchor sum of step 0."""
    from marius_tpu_torch.data.full_graph import (
        build_full_graph_adjacency,
        host_csr_from_adjacency,
    )
    from marius_tpu_torch.data.full_graph_rel import _RingCells, build_sharded_rel_graph
    from marius_tpu_torch.data.full_graph_sharded import (
        _place,
        build_sharded_from_csr,
        csr_layout,
    )
    from marius_tpu_torch.ops.cuda import gather

    dev = torch.device("cuda")
    s = NC_RING[1]
    edges = data[0]
    sg = _place(build_sharded_from_csr(*host_csr_from_adjacency(
        build_full_graph_adjacency(edges, ARXIV_NODES)), ARXIV_NODES, s), 0, dev)
    n_loc = sg.n_loc
    sums, rows = {}, {}
    g = torch.Generator(device=dev).manual_seed(17)
    for k in range(s):
        nbr, seg = sg.flat_nbr[k][0], sg.flat_seg[k][0]
        nbr_h, seg_h = nbr.cpu().numpy(), seg.cpu().numpy()
        pos = np.arange(len(seg_h))
        sums[f"nc_ring_sage_step{k}"] = time_layout_sum(
            csr_layout(seg_h, nbr_h, n_loc, n_loc, dev), n_loc, NC_DIM, rates,
            f"nc_ring SAGE step {k} (shard 0's rows, the visiting block's {n_loc} rows)", card)
        if k:
            continue
        h, width = GAT_HEADS, GAT_HEADS * NC_DIM
        sums["nc_ring_gat_numerator"] = time_layout_sum(
            csr_layout(seg_h, pos, n_loc, len(pos), dev), len(pos), width, rates,
            f"nc_ring GAT step {k} numerator over slot positions", card)
        sums["nc_ring_gat_visiting_grad"] = time_layout_sum(
            csr_layout(nbr_h, pos, n_loc, len(pos), dev), len(pos), width, rates,
            f"nc_ring GAT step {k} the visiting block's dt over slot positions", card)
        for name, d in (("nc_ring_gat_value_slots", width), ("nc_ring_gat_r_slots", h)):
            table = torch.randn(n_loc, d, device=dev, generator=g)
            err = gather_max_err(gather, table, nbr)
            r = rows[name] = time_gather(gather, table, [nbr], rates)
            r["max_abs_err"] = err
            print(f"gather_rows, {name} (K={r['k']} int32 slot ids of step {k} into the "
                  f"visiting ({n_loc}, {d}) block, {r['distinct_rows']:.0f} distinct rows, "
                  f"{r['bound_bytes'] / 1e6:.4f} MB): max_abs_err {err}  kernel "
                  f"{r['ms'] * 1e3:.2f} us  plain {r['plain_ms'] * 1e3:.2f} us  index_select "
                  f"{r['library_ms'] * 1e3:.2f} us  bound {r['bound_ms'] * 1e3:.2f} us "
                  f"({r['bound_by']})  [{card}]", flush=True)
            del table
    cells = _RingCells(_place(build_sharded_rel_graph(ring_edges("rgcn", edges), ARXIV_NODES,
                                                      s).fwd, 0, dev), n_loc, dev)
    ids = torch.cat([b[0] for b in cells.buckets[0]])
    table = torch.randn(n_loc + 1, NC_DIM, device=dev, generator=g)
    table[n_loc] = 0
    err = gather_max_err(gather, table, ids)
    r = rows["nc_ring_rgcn_cell_gather"] = time_gather(gather, table, [ids], rates)
    r["max_abs_err"] = err
    print(f"gather_rows, nc_ring_rgcn_cell_gather (K={r['k']} int32 ids of step 0's "
          f"{len(cells.buckets[0])} relation buckets into the visiting ({n_loc + 1}, {NC_DIM}) "
          f"block, {r['distinct_rows']:.0f} distinct rows, {r['bound_bytes'] / 1e6:.4f} MB): "
          f"max_abs_err {err}  kernel {r['ms'] * 1e3:.2f} us  plain {r['plain_ms'] * 1e3:.2f} us"
          f"  index_select {r['library_ms'] * 1e3:.2f} us  bound {r['bound_ms'] * 1e3:.2f} us "
          f"({r['bound_by']})  [{card}]", flush=True)
    del table
    sums["nc_ring_rgcn_anchor_sum"] = time_layout_sum(
        cells.layouts[0], ids.shape[0], NC_DIM, rates,
        "nc_ring RGCN step 0 anchor sum (ids perm, rows seg)", card)
    return {"gather_rows": rows, "gather_sum": sums}


# -- out-of-core node classification on a data-parallel mesh, and the examples ------


def _state_batch(trainer, st, size: int):
    """(buffer-local seeds, labels, mask) of the first ``size`` train seeds
    of state ``st``, padded as the trainer pads a state's last batch."""
    seeds_g = np.concatenate([trainer.train_by_part[p] for p in st])[:size]
    seeds, labels = trainer._local_seeds(seeds_g)
    pad = size - len(seeds_g)
    mask = torch.arange(size, device=trainer.device) < len(seeds_g)
    return (torch.cat([seeds, seeds.new_full((pad,), trainer._ref.buffer_rows)]),
            torch.cat([labels, labels.new_zeros(pad)]), mask)


def _nc_buffer_dp_reference(single, graph, seeds, mask, labels, draws):
    """One data-parallel out-of-core batch computed on one card: each data
    index's share of ``seeds`` sampled with its own ``draws`` under hop caps
    for that share over the buffer rows and scored, the shares' SUM losses
    added, one backward, one dense optimizer step. Returns (loss, dense
    gradients)."""
    from marius_tpu_torch.data.samplers.neighbor import estimate_hop_caps, sample_neighbor_batch
    from marius_tpu_torch.nn.encoder import encoder_forward
    from marius_tpu_torch.nn.model import nc_batch_loss
    from marius_tpu_torch.nn.optimizers import apply_optimizer, tree_leaves, tree_map

    model = single.model
    if model.loss_reduction.upper() != "SUM":
        raise AssertionError("the reference adds the shares' losses: SUM only")
    bl = seeds.shape[0] // len(draws)
    caps = estimate_hop_caps(bl, single.nbr_configs, single._ref.buffer_rows)
    total = 0.0
    for i, draw in enumerate(draws):
        part = slice(i * bl, (i + 1) * bl)
        nb = sample_neighbor_batch(draw, graph, seeds[part], mask[part], single.nbr_configs,
                                   caps)
        feats, emb = single._outer_rows(nb.node_ids[0])
        logits = encoder_forward(model.encoder, single.params["encoder"], emb, feats, nb,
                                 degrees=graph.degrees, train=True, dropout_key=single._dropout)
        total = total + nc_batch_loss(model, logits, labels[part], mask[part] & nb.seed_mask)
    grads = torch.autograd.grad(total, tree_leaves(single.params))
    it = iter(grads)
    _, single.opt_state = apply_optimizer(model.dense_optimizer, single.params,
                                          single.opt_state,
                                          tree_map(lambda _: next(it), single.params))
    return float(total), grads


def nc_oocore_mesh_rank(config_path: str, device=None) -> int:
    """One rank of nc_oocore_mesh: the command line's ``train`` of the cut
    papers config on the data-parallel mesh (per-state timings on), then, in
    a second process group, one state's first batch on the mesh against one
    card's computation of the same, each data index's share with its own
    injected draws (``_nc_buffer_dp_reference``). Prints ``MESH_RANK {...}``."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.data.samplers.neighbor import seeded_draws
    from marius_tpu_torch.nn.optimizers import tree_leaves
    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum
    from marius_tpu_torch.parallel import multihost
    from marius_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
    from marius_tpu_torch.storage.dataset import (
        load_features,
        load_labels,
        load_node_split,
        load_split,
        load_stats,
    )
    from marius_tpu_torch.train.nc_buffer import PartitionBufferNCTrainer

    cls, train_epoch, timings = PartitionBufferNCTrainer, PartitionBufferNCTrainer.train_epoch, []

    def timed(self, *args, **kwargs):
        self.profile_states = True
        out = train_epoch(self, *args, **kwargs)
        timings.append([list(t) for t in self.last_state_timings])
        return out

    cls.train_epoch = timed
    try:
        result, train, launches, peaks = _train_in_group(config_path, device, cls)
    finally:
        cls.train_epoch = train_epoch
    tr = result["runtime"].trainer
    record = {**_rank_record(result, train, launches, "nodes_per_sec"), "mode": "explicit",
              "batches": [e["batches_run"] for e in result["epochs"]],
              "padded": [e["masked_batches"] for e in result["epochs"]],
              "hop_caps": list(tr.hop_caps), "eval_caps": list(tr._eval_caps),
              "cache_rows": tr.cache.buffer_rows, "peak_bytes": peaks,
              "state_timings": timings, "valid": [e["accuracy"] for e in result["evals"]]}
    del result, tr
    gc.collect()

    cfg = load_config(config_path)
    ds, s = cfg.storage.dataset.dataset_dir, cfg.storage
    stats = load_stats(ds)
    edges, feats = load_split(ds, "train", stats), load_features(ds, stats, mmap=True)
    labels, train_nodes = load_labels(ds), load_node_split(ds, "train")
    kernels = {"gather_rows": gather, "sparse_adagrad_update_": adagrad, "gather_sum": nbr_sum}
    dev = _check_group(device)
    try:
        mesh = make_mesh(NC_MESH[0], NC_MESH[1], device=dev)

        def trainer(m):
            return PartitionBufferNCTrainer(
                load_config(config_path).model, edges, feats, labels, train_nodes,
                cfg.train_neighbor_sampling, num_nodes=stats.num_nodes,
                batch_size=cfg.training.batch_size, num_partitions=s.num_partitions,
                buffer_capacity=s.buffer_capacity, ordering=s.node_partition_ordering,
                seed=cfg.training.seed, mesh=m, device=dev)

        meshed, single = trainer(mesh), trainer(None)
        st = meshed._plan_epoch()[0]
        for t in (meshed, single):
            t._swap_state(st)
        graph = meshed._state_graph(1 << (meshed._state_edges(st) - 1).bit_length())
        seeds, batch_labels, mask = _state_batch(meshed, st, cfg.training.batch_size)
        draws = [seeded_draws(77, i, dev) for i in range(NC_MESH[0])]
        before = {k: km.launches for k, km in kernels.items()}
        collectives = mesh.collectives
        loss, _ = meshed._batch_step(graph, seeds, mask, batch_labels,
                                     draws[mesh.axis_index(DATA_AXIS)], meshed._dropout)
        batch_launches = {k: km.launches - before[k] for k, km in kernels.items()}
        collectives = mesh.collectives - collectives
        ref_loss, grads = _nc_buffer_dp_reference(
            single, graph, seeds, mask, batch_labels,
            [seeded_draws(77, i, dev) for i in range(NC_MESH[0])])
        _assert_close(loss.reshape(1), torch.tensor([ref_loss]), "the batch's loss")
        worst = unheld = 0
        for j, (g, w, grad) in enumerate(zip(tree_leaves(meshed.params),
                                             tree_leaves(single.params), grads)):
            wj, uj = _held_close(g, w, grad, f"leaf {j}")
            worst, unheld = max(worst, wj), unheld + uj
        record["batch_check"] = {"loss": [float(loss), ref_loss], "worst": worst,
                                 "unheld": unheld, "launches": batch_launches,
                                 "collectives": collectives,
                                 "elements": sum(int(g.numel()) for g in grads)}
    finally:
        multihost.shutdown()
    print("MESH_RANK " + json.dumps(record), flush=True)
    return 0


def nc_oocore_mesh_shapes(trainer, rates, card) -> dict:
    """One rank's real training batch on nc_oocore_mesh's mesh: a one-card
    trainer of the same config, its resident state's first ``batch /
    n_data`` train seeds sampled under hop caps for them over the buffer rows
    (the mesh trainer's local caps); the row gather at the outer hop's shape
    and the gather-sum at layer 0's, each bit for bit against its plain
    version and timed beside its bound and its library call."""
    from marius_tpu_torch.data.samplers.neighbor import estimate_hop_caps, sample_neighbor_batch
    from marius_tpu_torch.ops.cuda import gather

    dev = trainer.device
    st = [int(p) for p in trainer.cache.resident if p >= 0]
    graph = trainer._state_graph(1 << (trainer._state_edges(st) - 1).bit_length())
    bl = trainer.batch_size // NC_MESH[0]
    caps = tuple(estimate_hop_caps(bl, trainer.nbr_configs, trainer.cache.buffer_rows))
    seeds, _, mask = _state_batch(trainer, st, bl)
    nb = sample_neighbor_batch(trainer._batch_draws(trainer.epoch, 0), graph, seeds, mask,
                               trainer.nbr_configs, caps)
    outer = nb.node_ids[0]
    table = trainer.cache.device_rows
    rows = time_gather(gather, table, [outer], rates)
    rows["max_abs_err"] = gather_max_err(gather, table, outer)
    rows["hop_caps"] = list(caps)
    print(f"gather_rows, nc_oocore_mesh_outer (one rank's {bl} seeds under local caps {caps}: "
          f"K={rows['k']} into {table.shape[0]} x {rows['d']}, {rows['distinct_rows']:.1f} "
          f"distinct rows, {rows['bound_bytes'] / 1e6:.4f} MB): max_abs_err "
          f"{rows['max_abs_err']}  kernel {rows['ms'] * 1e3:.2f} us  plain "
          f"{rows['plain_ms'] * 1e3:.2f} us  index_select {rows['library_ms'] * 1e3:.2f} us  "
          f"bound {rows['bound_ms'] * 1e3:.2f} us ({rows['bound_by']})  [{card}]", flush=True)
    sums = time_layer_sum(nb.layers[0], outer.shape[0], NC_DIM, rates, dev)
    print(f"gather_sum, nc_oocore_mesh layer 0 ({sums['targets']} targets x {sums['width']} "
          f"slots, {sums['valid_slots']} real, {sums['distinct_rows']} distinct rows of "
          f"{outer.shape[0]}, d={NC_DIM}, {sums['bound_bytes'] / 1e6:.4f} MB): max_abs_err "
          f"{sums['max_abs_err']}  kernel {sums['ms'] * 1e3:.2f} us (with the layout built: "
          f"{sums['with_layout_ms'] * 1e3:.2f} us)  plain {sums['plain_ms'] * 1e3:.2f} us  "
          f"embedding_bag {sums['library_ms'] * 1e3:.2f} us  bound {sums['bound_ms'] * 1e3:.2f} "
          f"us ({sums['bound_by']})  [{card}]", flush=True)
    return {"gather_rows": rows, "gather_sum": sums}


def nc_oocore_mesh(card: str, rates, device=None) -> dict:
    """nc_oocore's config (ogbn_arxiv.yaml's model at papers100M's shape,
    features in a PARTITION_BUFFER) cut to NC_RELOAD_NODES nodes, on a
    data-parallel {data: 2, node: 1} mesh of two rank processes through the
    command line (``nc_oocore_mesh_rank``), NC_OOC_MESH_EPOCHS epoch with the
    model saved: both ranks' losses and test accuracy equal, the accuracy
    above 4x chance and reproduced exactly by ``marius_eval`` here, exactly 1
    row gather, 3 gather-sums and no Adagrad per batch on each rank, one
    collective per batch; beside one process's run of the same config in
    this call. Then the kernels at one rank's batch shape
    (``nc_oocore_mesh_shapes``)."""
    from marius_tpu_torch.config import load_config
    from marius_tpu_torch.manager import marius_eval, marius_train

    tag = "nc_oocore_mesh"
    n = NC_RELOAD_NODES
    edges = int(round(PAPERS_NC_EDGES * n / PAPERS_NODES))
    counts = {"gather_rows": {}, "sparse_adagrad_update_": {}, "gather_sum": {}}
    with tempfile.TemporaryDirectory() as tmp:
        secs = write_papers_shaped(f"{tmp}/dataset", n, edges, papers_splits(n))
        raw = papers_raw(tmp, NC_OOC_MESH_EPOCHS, save_model=True)
        single_raw = copy.deepcopy(raw)
        single_raw["storage"]["model_dir"] = f"{tmp}/model_single"
        single_raw["storage"]["save_model"] = False
        raw["training"]["mesh"] = {"data": NC_MESH[0], "node": NC_MESH[1]}
        print(f"{tag}: nc_oocore's config cut to {n} nodes, {edges} edges, splits "
              f"{papers_splits(n)} (nc_oocore_reload's cut), num_epochs 10 -> "
              f"{NC_OOC_MESH_EPOCHS}, the model saved, training.mesh {raw['training']['mesh']}; "
              f"dataset written in {secs:.2f} s", flush=True)
        records = run_mesh_ranks(tag, raw, tmp, card, device, fn="nc_oocore_mesh_rank",
                                 shape=NC_MESH)
        again = marius_eval(load_config(raw), device=device)
        t0 = time.perf_counter()
        single = marius_train(load_config(single_raw), device=device)
        single_s = time.perf_counter() - t0
        shapes = nc_oocore_mesh_shapes(single.pop("runtime").trainer, rates, card)
    test = records[0]["printed"][0]
    layers = NC_GNN_STAGES
    for rec in records:
        if rec["shape"] != {"data": NC_MESH[0], "node": NC_MESH[1]} or \
                rec["losses"] != records[0]["losses"] or rec["test"] != records[0]["test"]:
            raise AssertionError(f"{tag}: rank {rec['rank']} is off the mesh or differs from "
                                 f"rank 0: {rec}")
        if (len(rec["printed"]) == 1) != (rec["rank"] == 0):
            raise AssertionError(f"{tag}: rank {rec['rank']} printed {rec['printed']}")
        batches = sum(rec["batches"])
        want = {"gather_rows": batches, "sparse_adagrad_update_": 0,
                "gather_sum": layers * batches}
        if rec["train_launches"] != want or not batches:
            raise AssertionError(f"{tag}: rank {rec['rank']} launched {rec['train_launches']} "
                                 f"in training, expected {want}")
        if any(c != 1.0 for c in rec["collectives_per_batch"]):
            raise AssertionError(f"{tag}: {rec['collectives_per_batch']} collectives per batch "
                                 f"(one all_reduce under SUM)")
        bc = rec["batch_check"]
        if bc["launches"] != {"gather_rows": 1, "sparse_adagrad_update_": 0,
                              "gather_sum": layers} or bc["collectives"] != 1:
            raise AssertionError(f"{tag}: the checked batch launched {bc['launches']} with "
                                 f"{bc['collectives']} collectives")
        for k, v in rec["train_launches"].items():
            if v:
                counts[k][f"{tag} rank {rec['rank']} train"] = v
        for k, v in bc["launches"].items():
            if v:
                counts[k][f"{tag} rank {rec['rank']} batch check"] = v
        swaps = [round(t[0], 4) for ep in rec["state_timings"] for t in ep]
        print(f"{tag} rank {rec['rank']}: backend {rec['backend']} on {rec['device']} at "
              f"{rec['coords']}; cache {rec['cache_rows']} rows per rank (replicated); local hop "
              f"caps {rec['hop_caps']} (evaluation {rec['eval_caps']}); losses {rec['losses']}; "
              f"s/epoch {rec['seconds']}; train nodes/s {[round(x, 1) for x in rec['rates']]}; "
              f"batches {rec['batches']} + {rec['padded']} padded; swap s per state {swaps}; "
              f"collectives per batch {rec['collectives_per_batch']}; peak device bytes "
              f"{rec['peak_bytes']}; valid accuracy {rec['valid']}; launches in training "
              f"{rec['train_launches']}, in all {rec['launches']}  [{card}]", flush=True)
        print(f"{tag} rank {rec['rank']} batch check (one state's first batch on the mesh "
              f"against one card's computation of it, each index's share with its own draws): "
              f"loss {bc['loss'][0]:.6f} vs {bc['loss'][1]:.6f}; parameters within rtol 1e-4 / "
              f"atol 1e-5 (largest difference {bc['worst']:.3f} of atol past rtol; "
              f"{bc['unheld']} of {bc['elements']} elements with a gradient below 1e-6 not "
              f"held, ROADMAP C5); launches {bc['launches']}, collectives {bc['collectives']}  "
              f"[{card}]", flush=True)
    print(f"{tag} against one process in this call: losses {records[0]['losses']} vs "
          f"{[e['loss'] for e in single['epochs']]}; s/epoch per rank {records[0]['seconds']} "
          f"vs one process {[round(e['epoch_time_s'], 4) for e in single['epochs']]} "
          f"({single_s:.1f} s with its evaluations); train nodes/s per rank "
          f"{[round(x, 1) for x in records[0]['rates']]} vs "
          f"{[round(e['nodes_per_sec'], 1) for e in single['epochs']]}; test accuracy "
          f"{test['accuracy']:.6f} (one process {single['test']['accuracy']:.6f}, chance "
          f"{1 / PAPERS_CLASSES:.6f}); marius_eval of rank 0's checkpoint "
          f"{again['test']['accuracy']:.6f}  [{card}]", flush=True)
    if not test["accuracy"] > 4.0 / PAPERS_CLASSES:
        raise AssertionError(f"{tag} test accuracy {test['accuracy']} is not above 4x chance "
                             f"({4.0 / PAPERS_CLASSES:.6f})")
    if any(test[k] != again["test"][k] for k in ("accuracy", "num_evaluated")):
        raise AssertionError(f"{tag}: marius_eval of rank 0's checkpoint gave {again['test']}, "
                             f"rank 0 printed {test}")
    return {**counts, "shapes": shapes, "s_per_epoch": records[0]["seconds"]}


TWIN_LAUNCH_CODE = (
    "import importlib.util, json, sys\n"
    "from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum\n"
    "sys.argv = sys.argv[1:]\n"
    "spec = importlib.util.spec_from_file_location('twin', sys.argv[0])\n"
    "mod = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(mod)\n"
    "mod.NUM_EPOCHS = {epochs}\n"
    "gather.launches = adagrad.launches = nbr_sum.launches = 0\n"
    "mod.main({device!r})\n"
    "print('TWIN_LAUNCHES ' + json.dumps({{'gather_rows': gather.launches, "
    "'sparse_adagrad_update_': adagrad.launches, 'gather_sum': nbr_sum.launches}}), "
    "flush=True)\n")


def _fake_cora(directory: Path, class_names) -> None:
    """tests/test_torch_examples.py's CORA-shaped raw files: 80 papers of 12
    0/1 words, 300 citations, from seed 0."""
    rng = np.random.default_rng(0)
    n, f = 80, 12
    directory.mkdir(parents=True)
    ids = rng.choice(10_000, size=n, replace=False)
    with open(directory / "cora.content", "w") as fh:
        for i in range(n):
            words = rng.integers(0, 2, size=f)
            cls = class_names[rng.integers(len(class_names))]
            fh.write(f"{ids[i]}\t" + "\t".join(map(str, words)) + f"\t{cls}\n")
    with open(directory / "cora.cites", "w") as fh:
        for _ in range(300):
            a, b = rng.choice(ids, size=2, replace=False)
            fh.write(f"{a}\t{b}\n")


def examples_torch(card: str, device=None) -> dict:
    """The examples/python_torch twins on the card at their test sizes
    (tests/test_torch_examples.py's data, EXAMPLE_EPOCHS epochs): the five
    one-process twins in this process, their downloads replaced by
    fabricated raw files, then fb15k_237_mesh.py on two gloo rank processes
    under torchrun's environment. Each twin's seconds and launches (set to 0
    just before it, read just after); every twin's metrics must be finite
    and each must launch the kernels its path runs."""
    import ast
    import importlib.util

    from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum
    from marius_tpu_torch.tools.preprocess.generate import (
        generate_random_dataset_lp,
        generate_random_dataset_nc,
    )

    here = Path(__file__).resolve().parent
    twins = here / "examples" / "python_torch"
    kernels = {"gather_rows": gather, "sparse_adagrad_update_": adagrad, "gather_sum": nbr_sum}
    counts = {k: {} for k in kernels}

    def load(name, argv):
        spec = importlib.util.spec_from_file_location(f"twin_{name}", twins / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        saved = sys.argv
        sys.argv = [str(twins / f"{name}.py"), *argv]
        try:
            spec.loader.exec_module(mod)
        finally:
            sys.argv = saved
        mod.NUM_EPOCHS = EXAMPLE_EPOCHS
        return mod

    def record(name, seconds, launches, metrics, want):
        print(f"examples_torch {name}: {seconds:.2f} s; launches {launches}; metrics "
              f"{ {k: round(float(v), 6) for k, v in metrics.items()} }  [{card}]", flush=True)
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError(f"examples_torch {name}: metrics are not finite: {metrics}")
        if any(bool(launches[k]) != on for k, on in want.items()):
            raise AssertionError(f"examples_torch {name}: launches {launches}, expected "
                                 f"{'/'.join(k for k, on in want.items() if on)} only")
        for k, v in launches.items():
            if v:
                counts[k][f"examples_torch {name}"] = v

    lp_path = {"gather_rows": True, "sparse_adagrad_update_": True, "gather_sum": False}
    nc_path = {"gather_rows": True, "sparse_adagrad_update_": False, "gather_sum": True}
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lp_ds, nc_ds = f"{tmp}/lp", f"{tmp}/nc"
        generate_random_dataset_lp(lp_ds, num_nodes=60, num_edges=600, num_relations=4)
        generate_random_dataset_nc(nc_ds, num_nodes=200, num_edges=800, num_classes=5,
                                   feature_dim=8)
        csv = Path(tmp) / "edge.csv"
        rng = np.random.default_rng(1)
        csv.write_text("".join(f"{1000 + a},{1000 + b}\n"
                               for a, b in rng.integers(0, 70, (700, 2))))
        runs = (("fb15k_237", [lp_ds], lp_path), ("ogbn_arxiv_nc", [nc_ds], nc_path),
                # the registered layer sums with plain torch ops: no gather-sum
                ("custom_layer", [], lp_path), ("custom_lp", [f"{tmp}/custom_lp"], lp_path),
                ("custom_nc_graphsage", [f"{tmp}/cora"], nc_path))
        for name, argv, want in runs:
            mod = load(name, argv)
            if name == "custom_lp":
                mod.MyDataset.download = lambda self, overwrite=False: setattr(
                    self, "input_train_edges_file", csv)
            elif name == "custom_nc_graphsage":
                raw = Path(tmp) / "cora_raw"
                _fake_cora(raw, mod.CLASS_NAMES)

                def fake(self, overwrite=False, raw=raw):
                    self.content_file, self.cites_file = raw / "cora.content", raw / "cora.cites"

                mod.Cora.download = fake
            for m in kernels.values():
                m.launches = 0
            if device is None:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mod.main(device)
            if device is None:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: m.launches for k, m in kernels.items()}
            metrics = res["test"] if "test" in res else res
            metrics = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
            record(name, dt, launches, metrics, want)

        code = TWIN_LAUNCH_CODE.format(epochs=EXAMPLE_EPOCHS, device=device)
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
               "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code, str(twins / "fb15k_237_mesh.py"),
                                   lp_ds], cwd=here, text=True,
                                  env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MESH_RANKS_LIMIT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        dt = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:], flush=True)
            raise AssertionError(f"examples_torch fb15k_237_mesh: rank {r} exited "
                                 f"{p.returncode}")
        lines = out.splitlines()
        launches = json.loads([ln for ln in lines if ln.startswith("TWIN_LAUNCHES ")][-1][14:])
        mesh_line = [ln for ln in lines if ln.startswith("mesh: ")]
        metrics = [ln for ln in lines if ln.startswith("{")]
        if (bool(mesh_line) and bool(metrics)) != (r == 0):
            raise AssertionError(f"examples_torch fb15k_237_mesh: rank {r} printed "
                                 f"{mesh_line + metrics}")
        if r == 0:
            print(f"examples_torch fb15k_237_mesh: {mesh_line[0]}", flush=True)
        record(f"fb15k_237_mesh rank {r}", dt, launches,
               ast.literal_eval(metrics[-1]) if metrics else {}, lp_path)
    print(f"examples_torch: {time.perf_counter() - t_all:.1f} s in all (fb15k_237_mesh's two "
          f"rank processes {dt:.1f} s from start to the last exit)", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    import marius_tpu_torch
    from marius_tpu_torch import native
    from marius_tpu_torch.data.full_graph import build_full_graph_adjacency
    from marius_tpu_torch.ops.cuda import adagrad, build, gather

    here = Path(__file__).resolve().parent
    if Path(marius_tpu_torch.__file__).resolve().parents[1] != here:
        raise RuntimeError(f"marius_tpu_torch was imported from {marius_tpu_torch.__file__}, "
                           f"not from this checkout ({here})")

    # f32 matmuls stay full f32: TF32 would shift ranks and the card-CPU comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_name()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    rates = card_rates(kind)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        host_lib = pool.submit(native.load)   # g++, beside the nvcc builds
        logs = build.build_all()
        print(f"kernel build (nvcc, {len(logs)} sources in parallel): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        print(f"native host library (g++ -O3, native/marius_native.cpp): "
              f"{Path(host_lib.result()._name).relative_to(here)}, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    nc = nc_data(0, arxiv_edges(), ARXIV_NODES, ARXIV_FEATS, ARXIV_CLASSES, ARXIV_TRAIN)
    adj = build_full_graph_adjacency(nc[0], ARXIV_NODES)
    print(f"arxiv-shaped graph and adjacency on the host: {time.perf_counter() - t0:.2f} s "
          f"({adj.total_slots} padded slots, {len(adj.nbrs)} buckets, widest "
          f"{max(b.shape[1] for b in adj.nbrs)})", flush=True)

    kernels = [check_gather(gather, torch.device("cuda"), rates),
               check_adagrad(adagrad, torch.device("cuda"), rates),
               check_gather_sum(adj.to("cuda"), rates)]
    for k in kernels:
        lib = "-" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.2f} us"
        print(f"{k['name']}: max_abs_err {k['max_abs_err']} (bit for bit against the plain "
              f"version)  kernel {k['ms'] * 1e3:.2f} us  plain {k['plain_ms'] * 1e3:.2f} us  "
              f"library {lib}  bound {k['bound_ms'] * 1e3:.2f} us ({k['bound_by']})  [{card}]",
              flush=True)
    print_gather_shapes(kernels[0], card)
    print(f"sparse_adagrad_update_, flagship plan: {plan_text(kernels[1]['plan'])}", flush=True)
    a = kernels[1]["out_of_core"]
    print(f"sparse_adagrad_update_, out_of_core ({a['rows']} x {a['d']} f32 values and state, "
          f"{a['k']} ids + 1000 padding, {a['bound_bytes'] / 1e6:.4f} MB): "
          f"max_abs_err {a['max_abs_err']} on the touched rows  kernel {a['ms'] * 1e3:.2f} us  "
          f"plain {a['plain_ms'] * 1e3:.2f} us  torch.optim.adagrad (sparse) "
          f"{a['library_ms'] * 1e3:.2f} us  bound {a['bound_ms'] * 1e3:.2f} us ({a['bound_by']})"
          f"  plan {plan_text(a['plan'])}  [{card}]", flush=True)

    flagship = train_flagship(card)
    compare_lp_with_cpu()
    compare_eval_with_cpu()
    nc_counts = train_nc(card, adj, nc)
    compare_nc_with_cpu()
    sampled = nc_sampled(card, nc)
    nc_trainer = sampled.pop("trainer")
    shapes = sampled_shapes(nc_trainer, rates, card)
    sampler_shapes(card, nc_trainer)
    del nc_trainer
    kernels[0]["sampled_nc_outer"] = shapes["gather_rows"]
    kernels[2]["sampled_layer0"] = shapes["gather_sum"]
    torch.cuda.empty_cache()
    nc16 = nc_bf16(card, nc, sampled)
    shapes = bf16_kernel_shapes(gather, adagrad, adj.to("cuda"), nc16.pop("trainer"), rates,
                                card)
    for k in kernels:
        k["bf16"] = shapes[k["name"]]
        k["max_abs_err"] = max([k["max_abs_err"]]
                               + [r["max_abs_err"] for r in k["bf16"].values()])
    torch.cuda.empty_cache()
    compare_sampled_nc_with_cpu()
    gat = nc_gat(card, nc)
    gat_trainer = gat.pop("trainer")
    kernels[0]["gat_layer0_slots"] = gat_slot_shapes(gat_trainer, rates, card)
    gat_against_cpu(gat_trainer, nc, card)
    del gat_trainer
    torch.cuda.empty_cache()
    rgcn_full = nc_full_graph_gnn(card, nc, "RGCN")
    gat_full = nc_full_graph_gnn(card, nc, "GAT", batches=NC_GAT_FULL_BATCHES)
    shapes = full_graph_shapes(rgcn_full.pop("trainer"), gat_full.pop("trainer"), rates, card)
    kernels[0].update(shapes["gather_rows"])
    kernels[2].update(shapes["gather_sum"])
    torch.cuda.empty_cache()
    locality = nc_locality(card, adj, nc, rates)
    kernels[2]["nc_locality_order"] = locality.pop("sum_shape")
    kernels[0]["nc_locality_permutation"] = locality.pop("permute_shape")
    emb_full = nc_embedding_full(card, nc, rates)
    kernels[1]["nc_embedding_full_all_rows"] = emb_full.pop("shape")
    compare_fg_leftovers_with_cpu()
    torch.cuda.empty_cache()
    manager = lp_manager(card)
    rel = lp_corrupt_rel(card)
    lp16 = lp_bf16(card, manager)
    compare_rel_and_bf16_with_cpu()
    gnn = lp_gnn(card)
    shapes = lp_gnn_shapes(gnn.pop("trainer"), rates, card)
    for k in kernels:
        k["lp_gnn"] = shapes[k["name"]]
    torch.cuda.empty_cache()
    compare_gnn_lp_with_cpu()
    lp_accuracy(card)
    compare_oocore_with_cpu()
    host_eval_on_card()
    reload = lp_oocore_reload(card)
    gnn_oocore = lp_gnn_oocore(card)
    oocore = lp_oocore(card)
    gc.collect()
    torch.cuda.empty_cache()
    oocore16 = lp_oocore_bf16(card, oocore["swaps"])
    gc.collect()
    torch.cuda.empty_cache()
    compare_nc_oocore_with_cpu()
    nc_reload = nc_oocore_reload(card)
    nc_ooc = nc_oocore(card, rates)
    shapes = nc_ooc.pop("shapes")
    kernels[0]["nc_oocore_outer"] = shapes["gather_rows"]
    kernels[2]["nc_oocore_layer0"] = shapes["gather_sum"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tools = tools_cli(card)
    print(f"tools_cli: {time.perf_counter() - t0:.1f} s in all", flush=True)
    t0 = time.perf_counter()
    mesh1 = lp_mesh(card)
    ranks = lp_mesh_ranks(card)
    shapes = lp_mesh_shapes(rates, card)
    for k in kernels:
        k["lp_mesh_ranks"] = shapes[k["name"]]
    print(f"mesh phases: {time.perf_counter() - t0:.1f} s in all", flush=True)
    t0 = time.perf_counter()
    gspmd = lp_mesh_gspmd(card)
    oocore_mesh = lp_oocore_mesh(card)
    ncm = nc_mesh(card, nc)
    shapes = mesh_dp_shapes(rates, card, nc)
    for k in kernels:
        k["mesh_dp"] = shapes[k["name"]]
    print(f"data-parallel mesh phases: {time.perf_counter() - t0:.1f} s in all", flush=True)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ring = nc_ring(card, nc)
    ring.pop("summary")
    shapes = ring_shapes(rates, card, nc)
    kernels[0].update(shapes["gather_rows"])
    kernels[2].update(shapes["gather_sum"])
    print(f"node-sharded ring phases: {time.perf_counter() - t0:.1f} s in all", flush=True)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ooc_mesh = nc_oocore_mesh(card, rates)
    shapes = ooc_mesh.pop("shapes")
    kernels[0]["nc_oocore_mesh_outer"] = shapes["gather_rows"]
    kernels[2]["nc_oocore_mesh_layer0"] = shapes["gather_sum"]
    print(f"out-of-core NC mesh phases: {time.perf_counter() - t0:.1f} s in all", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    examples = examples_torch(card)

    # each row's launches: the sum over the paths it runs on, each part's beside it
    by_part = {
        "gather_rows": {"lp flagship": flagship["gather_rows"], **manager["gather_rows"],
                        **sampled["gather_rows"], **gat["gather_rows"],
                        **rgcn_full["gather_rows"], **gat_full["gather_rows"],
                        **gnn["gather_rows"], **reload["gather_rows"],
                        **gnn_oocore["gather_rows"], **oocore["gather_rows"],
                        **locality["gather_rows"], **emb_full["gather_rows"],
                        **nc_reload["gather_rows"], **nc_ooc["gather_rows"],
                        **rel["gather_rows"], **lp16["gather_rows"], **nc16["gather_rows"],
                        **oocore16["gather_rows"], **tools["gather_rows"],
                        **mesh1["gather_rows"], **ranks["gather_rows"],
                        **gspmd["gather_rows"], **oocore_mesh["gather_rows"],
                        **ncm["gather_rows"], **ring["gather_rows"],
                        **ooc_mesh["gather_rows"], **examples["gather_rows"]},
        "sparse_adagrad_update_": {"lp flagship": flagship["sparse_adagrad_update_"],
                                   "lp_manager train": manager["sparse_adagrad_update_"],
                                   **sampled["sparse_adagrad_update_"],
                                   **gat["sparse_adagrad_update_"],
                                   **rgcn_full["sparse_adagrad_update_"],
                                   **gat_full["sparse_adagrad_update_"],
                                   **gnn["sparse_adagrad_update_"],
                                   **reload["sparse_adagrad_update_"],
                                   **gnn_oocore["sparse_adagrad_update_"],
                                   **oocore["sparse_adagrad_update_"],
                                   **emb_full["sparse_adagrad_update_"],
                                   **nc_reload["sparse_adagrad_update_"],
                                   **nc_ooc["sparse_adagrad_update_"],
                                   "lp_corrupt_rel train": rel["sparse_adagrad_update_"],
                                   "lp_bf16 train": lp16["sparse_adagrad_update_"],
                                   **nc16["sparse_adagrad_update_"],
                                   **oocore16["sparse_adagrad_update_"],
                                   **tools["sparse_adagrad_update_"],
                                   **mesh1["sparse_adagrad_update_"],
                                   **ranks["sparse_adagrad_update_"],
                                   **gspmd["sparse_adagrad_update_"],
                                   **oocore_mesh["sparse_adagrad_update_"],
                                   **ncm["sparse_adagrad_update_"],
                                   **ring["sparse_adagrad_update_"],
                                   **ooc_mesh["sparse_adagrad_update_"],
                                   **examples["sparse_adagrad_update_"]},
        "gather_sum": {**nc_counts, **sampled["gather_sum"], **gat["gather_sum"],
                       **rgcn_full["gather_sum"], **gat_full["gather_sum"], **gnn["gather_sum"],
                       **gnn_oocore["gather_sum"], **locality["gather_sum"],
                       **emb_full["gather_sum"], **nc_reload["gather_sum"],
                       **nc_ooc["gather_sum"], **nc16["gather_sum"], **tools["gather_sum"],
                       **ranks["gather_sum"], **gspmd["gather_sum"],
                       **oocore_mesh["gather_sum"], **ncm["gather_sum"],
                       **ring["gather_sum"], **ooc_mesh["gather_sum"],
                       **examples["gather_sum"]},
    }
    for k in kernels:
        k["launches"] = sum(by_part[k["name"]].values())
        k["launches_by_part"] = by_part[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
