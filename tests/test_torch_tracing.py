"""The port's tracer (``reporting/profiling.py``): spans and counters at the
training and evaluation loops' layer boundaries, on the CPU.

Off, ``span`` hands back one shared no-op and nothing is recorded. On,
spans nest by a stack, self time is a span less its children, counters
land on the innermost open span, ``counters()`` reads the kernels' launch
counters, and the synchronisation counter counts the warnings of
``torch.cuda.set_sync_debug_mode("warn")`` and restores the mode it found.
Span stamps share ``torch.profiler``'s clock. Tiny LP (sampled encoder) and
sampled NC runs give exact span counts, and train bit for bit as with the
tracer off; the out-of-core trainers' ``last_state_timings`` come from
their state spans.
"""

import copy
import gzip
import json
import warnings

import numpy as np
import pytest
import torch

from marius_tpu_torch.config import load_config
from marius_tpu_torch.manager import marius_init
from marius_tpu_torch.nn.optimizers import tree_leaves
from marius_tpu_torch.ops.cuda import adagrad, gather, nbr_sum, sampler
from marius_tpu_torch.reporting import profiling
from marius_tpu_torch.tools.preprocess.generate import (
    generate_random_dataset_lp,
    generate_random_dataset_nc,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _names(log):
    return [s.name for s in log.spans]


def _named(log, name):
    return [i for i, s in enumerate(log.spans) if s.name == name]


def _ancestor(log, i, name):
    """The nearest span called ``name`` holding span ``i`` (itself included), or -1."""
    while i >= 0 and log.spans[i].name != name:
        i = log.spans[i].parent
    return i


def _path(log, i):
    names = []
    while i >= 0:
        names.append(log.spans[i].name)
        i = log.spans[i].parent
    return "/".join(reversed(names))


def _self_ns(log):
    out = [s.duration_ns for s in log.spans]
    for s in log.spans:
        if s.parent >= 0:
            out[s.parent] -= s.duration_ns
    return out


def _count_under(log, name, i):
    """Counter ``name`` recorded inside span ``i`` and the spans it holds."""
    def inside(j):
        while j >= 0 and j != i:
            j = log.spans[j].parent
        return j == i
    return sum((s.counts or {}).get(name, 0) for j, s in enumerate(log.spans) if inside(j))


def test_off_span_is_the_shared_no_op_and_records_nothing():
    assert not profiling._on
    a, b = profiling.span("train.batch", (0, 1)), profiling.span("forward")
    assert a is b is profiling._OFF
    with a as inner:
        assert inner is a
        profiling.count("host_syncs")
    with profiling.recording(sync_debug=False) as log:
        pass
    assert log.spans == [] and dict(log.counts) == {}


def test_spans_nest_self_time_and_counts(monkeypatch):
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(profiling.time, "time_ns", lambda: next(clock))
    with profiling.recording(sync_debug=False) as log:
        with profiling.span("train.epoch"):                       # 0 .. 90
            with profiling.span("train.batch", (3, 0)) as batch:  # 10 .. 60
                with profiling.span("sample"):                    # 20 .. 30
                    profiling.count("host_syncs", 2)
                with profiling.span("forward"):                   # 40 .. 50
                    pass
                profiling.count("train.batches")
            with profiling.span("train.readback"):               # 70 .. 80
                profiling.count("host_syncs")
        profiling.count("eval.batches")
    assert _names(log) == ["train.epoch", "train.batch", "sample", "forward", "train.readback"]
    assert [s.parent for s in log.spans] == [-1, 0, 1, 1, 0]
    assert batch.key == (3, 0) and log.spans[1] is batch
    assert [s.duration_ns for s in log.spans] == [90, 50, 10, 10, 10]
    assert _self_ns(log) == [90 - 50 - 10, 50 - 10 - 10, 10, 10, 10]
    assert _path(log, 3) == "train.epoch/train.batch/forward"
    assert _ancestor(log, 2, "train.batch") == 1 and _ancestor(log, 4, "train.batch") == -1
    assert dict(log.counts) == {"host_syncs": 3, "train.batches": 1, "eval.batches": 1}
    assert _count_under(log, "host_syncs", 0) == 3 and _count_under(log, "host_syncs", 1) == 2
    assert _named(log, "sample") == [2]
    assert not profiling._on and profiling.span("x") is profiling._OFF


def test_a_nested_recording_shares_the_log():
    with profiling.recording(sync_debug=False) as outer:
        with profiling.recording(sync_debug=True) as inner:
            with profiling.span("state.swap"):
                pass
        assert inner is outer and profiling._on
    assert _names(outer) == ["state.swap"] and not profiling._on


def test_counters_read_the_kernels_launches(monkeypatch):
    monkeypatch.setattr(gather, "launches", 7)
    monkeypatch.setattr(nbr_sum, "launches", 5)
    monkeypatch.setattr(adagrad, "launches", 3)
    monkeypatch.setattr(sampler, "launches", 9)

    class FakeMesh:
        collectives = 11

    with profiling.recording(sync_debug=False):
        profiling.count("train.batches", 4)
        snap = profiling.counters(mesh=FakeMesh())
    assert snap == {"train.batches": 4, "gather.launches": 7, "nbr_sum.launches": 5,
                    "adagrad.launches": 3, "sampler.launches": 9, "mesh.collectives": 11}
    # the last recording's counters stay readable after it ends
    assert profiling.counters()["train.batches"] == 4


def test_the_sync_counter_counts_warnings_and_restores_the_mode(monkeypatch):
    modes = [2]   # the mode found: "error"
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: modes.append(m))

    def sync_op():
        warnings.warn(profiling.SYNC_WARNING + " (Triggered internally at CUDAFunctions.cpp)",
                      UserWarning)

    with warnings.catch_warnings(record=True) as passed:
        warnings.simplefilter("always")
        with profiling.recording(sync_debug=True) as log:
            assert modes[-1] == "warn"
            with profiling.span("train.epoch"):
                with profiling.span("train.batch", (0, 0)):
                    for _ in range(3):          # one call site, counted each time
                        sync_op()
                with profiling.span("train.readback"):
                    sync_op()
            sync_op()
            warnings.warn("something else", UserWarning)
    assert modes[-1] == 2
    assert log.counts["host_syncs"] == 5
    assert log.spans[1].counts["host_syncs"] == 3 and log.spans[2].counts["host_syncs"] == 1
    assert _count_under(log, "host_syncs", 0) == 4
    # the synchronisation warnings are swallowed, others pass
    assert [str(w.message) for w in passed] == ["something else"]


def test_spans_share_the_profiler_clock():
    """A ``record_function`` mark opened inside a span lies inside it on
    kineto's timeline: the span's ``time.time_ns()`` stamps and the
    profiler's event times are one clock."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording(sync_debug=False) as log:
            for _ in range(3):
                with profiling.span("sample"):
                    with torch.profiler.record_function("inner_mark"):
                        torch.ones(256, 256).sum()
    marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events() if e.name() == "inner_mark")
    assert len(marks) == 3
    for s, (start, end) in zip(log.spans, marks):
        assert s.start_ns <= start and end <= s.end_ns, (s.start_ns, start, end, s.end_ns)


def test_trace_marks_each_span_in_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as log:
        with profiling.span("train.batch", (0, 0)):
            with profiling.span("forward"):
                torch.ones(64, 64).sum()
    assert _names(log) == ["train.batch", "forward"]
    (path,) = tmp_path.glob("*.pt.trace.json.gz")
    with gzip.open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("train.batch") == 1 and names.count("forward") == 1
    assert not profiling._on and not profiling._marks


# -- the loops ------------------------------------------------------------------

LP_RAW = {
    "model": {
        "learning_task": "LINK_PREDICTION",
        "encoder": {
            "layers": [[{"type": "EMBEDDING", "output_dim": 8}],
                       [{"type": "GNN", "input_dim": 8, "output_dim": 8,
                         "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"}}]],
            "train_neighbor_sampling": [{"type": "UNIFORM", "options": {"max_neighbors": 4}}]},
        "decoder": {"type": "DISTMULT", "options": {"input_dim": 8}},
        "loss": {"type": "SOFTMAX_CE", "options": {"reduction": "SUM"}},
        "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": 0.1}},
        "sparse_optimizer": {"type": "ADAGRAD", "options": {"learning_rate": 0.1}},
    },
    "storage": {"dataset": {"dataset_dir": ""}, "save_model": False},
    "training": {"batch_size": 100, "negative_sampling": {"num_chunks": 2,
                                                         "negatives_per_positive": 10},
                 "num_epochs": 1},
    "evaluation": {"batch_size": 20, "negative_sampling": {"filtered": True}},
}
NC_RAW = {
    "model": {
        "learning_task": "NODE_CLASSIFICATION",
        "encoder": {
            "train_neighbor_sampling": [{"type": "UNIFORM", "options": {"max_neighbors": 4}}] * 2,
            "layers": [[{"type": "FEATURE", "output_dim": 8, "bias": True}],
                       [{"type": "GNN", "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"},
                         "input_dim": 8, "output_dim": 8, "bias": True}],
                       [{"type": "GNN", "options": {"type": "GRAPH_SAGE", "aggregator": "MEAN"},
                         "input_dim": 8, "output_dim": 4, "bias": True}]]},
        "decoder": {"type": "NODE"},
        "loss": {"type": "CROSS_ENTROPY", "options": {"reduction": "SUM"}},
        "dense_optimizer": {"type": "ADAM", "options": {"learning_rate": 0.01}},
    },
    "storage": {"dataset": {"dataset_dir": ""}, "save_model": False},
    "training": {"batch_size": 64, "num_epochs": 1},
    "evaluation": {"batch_size": 10},
}


def _raw(base, ds_dir, **overrides):
    raw = copy.deepcopy(base)
    raw["storage"]["dataset"]["dataset_dir"] = ds_dir
    for path, val in overrides.items():
        node = raw
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = copy.deepcopy(val)
    return raw


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    generate_random_dataset_lp(str(root / "lp"), num_nodes=60, num_edges=600, num_relations=5)
    generate_random_dataset_nc(str(root / "nc"), num_nodes=240, num_edges=720, num_classes=4,
                               feature_dim=8)
    return {"lp": str(root / "lp"), "nc": str(root / "nc")}


def _cycle(raw, traced):
    """marius_init, one epoch and the validation evaluation, with the
    tracer on or off; returns (epoch stats, evaluation, state leaves, log,
    runtime)."""
    rt = marius_init(load_config(raw), device="cpu")
    log = None
    if traced:
        with profiling.recording(sync_debug=False) as log:
            stats = rt.trainer.train_epoch()
            result = rt.valid_evaluator.evaluate(rt.trainer.state)
    else:
        stats = rt.trainer.train_epoch()
        result = rt.valid_evaluator.evaluate(rt.trainer.state)
    st = rt.trainer.state
    leaves = [t.detach().clone() for t in tree_leaves(st.params)]
    if st.table is not None:
        leaves += [st.table.values.clone(), st.table.state.clone()]
    return stats, result, leaves, log, rt


def _same_run(off, on):
    assert off[0]["loss"] == on[0]["loss"]
    assert {k: v for k, v in off[1].items() if k != "eval_time_s"} == \
        {k: v for k, v in on[1].items() if k != "eval_time_s"}
    assert len(off[2]) == len(on[2])
    for a, b in zip(off[2], on[2]):
        assert torch.equal(a, b)


def _under(log, name, parent):
    return [i for i in _named(log, name) if _ancestor(log, i, parent) >= 0]


@pytest.mark.parametrize("task", ["lp", "nc"])
def test_one_traced_cycle_counts_its_spans_and_trains_bit_for_bit(datasets, task):
    raw = _raw(LP_RAW if task == "lp" else NC_RAW, datasets[task])
    off = _cycle(raw, traced=False)
    on = _cycle(raw, traced=True)
    _same_run(off, on)
    log, rt = on[3], on[4]
    tr, ev = rt.trainer, rt.valid_evaluator
    nb = tr.num_batches
    assert nb >= 3
    batches = _named(log, "train.batch")
    assert len(batches) == nb == log.counts["train.batches"]
    assert [log.spans[i].key for i in batches] == [(0, i) for i in range(nb)]
    assert len(_named(log, "train.epoch")) == 1 and len(_named(log, "train.readback")) == 1
    assert len(_under(log, "sample", "train.batch")) == nb
    per_batch = ["gather", "forward", "backward", "dense_update"]
    if task == "lp":
        per_batch += ["negatives", "unique", "sparse_update"]
        # node tiles of the encoding, then the edge batches of the ranking
        tiles = -(-tr.num_nodes // ev.batch_size)
        eval_batches = tiles + ev.num_batches
        assert tiles == 3 and ev.num_batches == 2
    else:
        eval_batches = tiles = ev.num_batches
        assert eval_batches == 3
    for name in per_batch:
        assert len(_under(log, name, "train.batch")) == nb, name
    assert len(_named(log, "eval.batch")) == eval_batches == log.counts["eval.batches"]
    # one sample per node tile (LP) or evaluation batch (NC)
    assert len(_under(log, "sample", "eval.batch")) == tiles
    assert len(_named(log, "eval.evaluate")) == 1 and len(_named(log, "eval.readback")) == 1
    for i in _named(log, "eval.batch"):
        assert _path(log, i) == "eval.evaluate/eval.batch"
    for i in _under(log, "backward", "train.batch"):
        assert _path(log, i) == "train.epoch/train.batch/backward"
    assert log.counts["host_syncs"] == 0
    # every span closed, inside its parent
    for s in log.spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = log.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


PB = {"type": "PARTITION_BUFFER", "options": {"num_partitions": 4, "buffer_capacity": 2}}


@pytest.mark.parametrize("task", ["lp", "nc"])
def test_state_timings_come_from_the_state_spans(datasets, task):
    if task == "lp":
        raw = _raw(LP_RAW, datasets["lp"], **{"storage.embeddings": PB})
        names = ("state.prep", "state.swap", "state.train")
    else:
        raw = _raw(NC_RAW, datasets["nc"], **{"storage.features": {"type": "PARTITION_BUFFER"},
                                              "storage.embeddings": {"options": PB["options"]}})
        names = ("state.swap", "state.graph", "state.train")
    tr = marius_init(load_config(raw), device="cpu").trainer
    tr.profile_states = True
    stats = tr.train_epoch()
    log = profiling._last
    assert not profiling._on
    spans = {n: [log.spans[i] for i in _named(log, n)] for n in names}
    states = len(spans["state.train"])
    assert states >= 2 and all(len(v) == states for v in spans.values())
    assert len(tr.last_state_timings) == states
    for k, timing in enumerate(tr.last_state_timings):
        assert timing == tuple(spans[n][k].duration_ns * 1e-9 for n in names)
    assert len(_named(log, "train.batch")) == stats.get("batches_run", log.counts["train.batches"])
    assert np.isfinite(stats["loss"])
    # without profile_states nothing is recorded
    tr.profile_states = False
    tr.train_epoch()
    assert profiling._last is log and tr.last_state_timings == []
