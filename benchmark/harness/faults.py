"""Faults planted underneath a run, to show that ``correct`` catches them:
each takes the program's runtime once it is built, before the warm-up cycle
the check records, and returns the patches that undo it.

- ``frozen_state``: every optimizer step returns the state unchanged (the
  dense optimizer and the table's Adagrad do nothing);
- ``half_batch``: each training step leaves out the second half of its
  batch, and the loss is taken over the rest;
- ``reversed_update``: every optimizer step moves each parameter (and the
  table) by its update's right size in the opposite direction;
- ``altered_answer``: the evaluation alters one answer of every batch where
  it is produced (node classification: the first node's logits are rolled by
  one class; link prediction: the first edge's rank becomes 1; a rank off by
  one is a tie broken the other way, which rounding alone also does).

Node classification's evaluation only (``NC_FAULTS``):

- ``dropped_nodes``: the first node of every evaluation batch is masked out
  of the accuracy;
- ``padded_count``: the accuracy counts the padding of the last batch as
  evaluated nodes.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from benchmark.harness import program


def frozen_state(rt) -> program.Patches:
    from marius_tpu_torch.train import nc, trainer

    p = program.Patches()
    for mod in (nc, trainer):
        p.set(mod, "apply_optimizer", lambda config, params, state, grads: (params, state))
        p.set(mod, "sparse_adagrad_update", lambda table, *args: table)
    return p


def half_batch(rt) -> program.Patches:
    tr = rt.trainer
    name = "_sampled_batch_step" if hasattr(tr, "_sampled_batch_step") else "_batch_step"
    step = getattr(tr, name)

    def halved(batch, mask):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = False
        return step(batch, mask)

    p = program.Patches()
    p.set(tr, name, halved)
    return p


def reversed_update(rt) -> program.Patches:
    from marius_tpu_torch.nn import optimizers
    from marius_tpu_torch.parallel import embedding_table

    dense, sparse = optimizers.apply_optimizer, embedding_table.sparse_adagrad_update

    def reversed_dense(config, params, state, grads):
        names = program.leaf_names(params)
        before = [program.leaf(params, k).detach().clone() for k in names]
        out = dense(config, params, state, grads)
        with torch.no_grad():
            for k, b in zip(names, before):
                leaf = program.leaf(params, k)
                leaf.copy_(2 * b - leaf)
        return out

    def reversed_sparse(table, *args):
        before = table.values.detach().clone()
        out = sparse(table, *args)
        with torch.no_grad():
            table.values.copy_(2 * before - table.values)
        return out

    p = program.Patches()
    p.everywhere(dense, reversed_dense)
    p.everywhere(sparse, reversed_sparse)
    return p


def altered_answer(rt) -> program.Patches:
    ev = rt.valid_evaluator
    p = program.Patches()
    if hasattr(ev, "_direction_ranks"):
        ranks = ev._direction_ranks

        def altered_ranks(*args, **kwargs):
            r = ranks(*args, **kwargs).clone()
            r[0] = 1
            return r

        p.set(ev, "_direction_ranks", altered_ranks)
        return p
    return _evaluation_masks(rt, lambda lg, mask: (_rolled_first(lg), mask))


def _rolled_first(lg):
    lg = lg.clone()
    lg[0] = lg[0].roll(1)
    return lg


def _evaluation_masks(rt, change: Callable) -> program.Patches:
    """Node classification's evaluation with each batch's (logits, mask)
    passed through ``change``."""
    ev = rt.valid_evaluator
    logits = ev._logits

    def changed(state):
        for lg, seeds, mask in logits(state):
            lg, mask = change(lg, mask)
            yield lg, seeds, mask

    p = program.Patches()
    p.set(ev, "_logits", changed)
    return p


def dropped_nodes(rt) -> program.Patches:
    def drop_first(lg, mask):
        mask = mask.clone()
        mask[0] = False
        return lg, mask
    return _evaluation_masks(rt, drop_first)


def padded_count(rt) -> program.Patches:
    return _evaluation_masks(rt, lambda lg, mask: (lg, torch.ones_like(mask)))


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "reversed_update": reversed_update, "altered_answer": altered_answer}
NC_FAULTS = {"dropped_nodes": dropped_nodes, "padded_count": padded_count}


def of_task(task: str) -> Dict[str, Callable]:
    """Every fault a cell of ``task`` (``nc_sampled``, ``lp_gnn``) can have."""
    return {**FAULTS, **(NC_FAULTS if task == "nc_sampled" else {})}
