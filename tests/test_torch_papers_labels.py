"""ogbn_arxiv.yaml's model on papers100M-shaped labels, on the CPU.

chip_smoke.py's ``nc_oocore`` trains ogbn_arxiv.yaml's model (FEATURE 128,
then 3 x GraphSAGE MEAN 128 -> 128 -> 172 with bias and no activation, CE
SUM, Adam 0.01, UNIFORM 8 per direction) on labels that are a random linear
function of each node's own features over 172 classes, on uniform random
edges (``chip_smoke.write_papers_shaped``: 2.52 out-edges per node at its
node cut), so a neighbour's features carry no label signal. Here the same
model, labels, fanout and edge density run through the port's sampled
trainer on a 20,000-node cut, 2 epochs, beside one GraphSAGE layer and a
linear softmax classifier of the own features trained on the same batches.
Every stacked layer adds a mean of random nodes' features that the model
must learn to cancel, and its own-feature path is a product of three
matrices: the 3-layer model fits these labels far worse than the one-layer
model and the linear classifier do at the same steps. That is why
``nc_oocore``'s accuracy stays well under the linear classifier's; the
trainers themselves match JAX (``tests/test_torch_sampled_nc.py``,
``tests/test_torch_nc_buffer.py``).

Run with ``-s`` to see the accuracies.
"""

import numpy as np
import torch

from chip_smoke import NC_DIM, NC_LR, PAPERS_CLASSES, PAPERS_FEATS, nc_data, nc_model
from marius_tpu_torch.data.graph import build_device_graph
from marius_tpu_torch.data.samplers.neighbor import NeighborSamplingConfig
from marius_tpu_torch.train import nc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, TRAIN, BATCH, EPOCHS, FANOUT = 20_000, 16_000, 1000, 2, 8
OUT_DEGREE = 2.52   # chip_smoke's papers-shaped edges per node (161,568,587 over 64M nodes)


def _sage_accuracy(edges, x, labels, train, eval_nodes, dims):
    tr = nc.NodeClassificationTrainer(
        nc_model(PAPERS_FEATS, dims), build_device_graph(edges, N), x, labels, train,
        [NeighborSamplingConfig("UNIFORM", FANOUT)] * len(dims), batch_size=BATCH, seed=0,
        device="cpu")
    tr.train(EPOCHS)
    return nc.NodeClassificationEvaluator(tr, eval_nodes).evaluate(tr.state)["accuracy"]


def _linear_accuracy(x, labels, train, eval_nodes):
    torch.manual_seed(0)
    lin = torch.nn.Linear(PAPERS_FEATS, PAPERS_CLASSES)
    opt = torch.optim.Adam(lin.parameters(), lr=NC_LR)
    xt, yt = torch.from_numpy(x), torch.from_numpy(labels).long()
    g = torch.Generator().manual_seed(0)
    for _ in range(EPOCHS):
        order = torch.from_numpy(train).long()[torch.randperm(len(train), generator=g)]
        for i in range(0, len(order), BATCH):
            idx = order[i:i + BATCH]
            loss = torch.nn.functional.cross_entropy(lin(xt[idx]), yt[idx], reduction="sum")
            opt.zero_grad()
            loss.backward()
            opt.step()
    ev = torch.from_numpy(eval_nodes).long()
    with torch.no_grad():
        return float((lin(xt[ev]).argmax(1) == yt[ev]).float().mean())


def test_three_sage_layers_fit_papers_shaped_labels_worse_than_one():
    rng = np.random.default_rng(5)
    edges = rng.integers(0, N, (round(OUT_DEGREE * N), 2)).astype(np.int32)
    edges, x, labels, train = nc_data(0, edges, N, PAPERS_FEATS, PAPERS_CLASSES, TRAIN)
    eval_nodes = np.setdiff1d(np.arange(N), train)
    sage3 = _sage_accuracy(edges, x, labels, train, eval_nodes,
                           (NC_DIM, NC_DIM, PAPERS_CLASSES))
    sage1 = _sage_accuracy(edges, x, labels, train, eval_nodes, (PAPERS_CLASSES,))
    linear = _linear_accuracy(x, labels, train, eval_nodes)
    print(f"\n{N} nodes, {len(edges)} uniform edges, {TRAIN} train, {len(eval_nodes)} "
          f"evaluated, {EPOCHS} epochs of {TRAIN // BATCH} batches: accuracy 3 SAGE layers "
          f"{sage3:.4f}, 1 SAGE layer {sage1:.4f}, linear {linear:.4f}; chance "
          f"{1 / PAPERS_CLASSES:.4f}")
    assert 1 / PAPERS_CLASSES < sage3 < sage1 - 0.05
    assert sage1 < linear
