"""The harness finds every configuration, traffic mix, limit and metric by
the names in BENCHMARK.json, and BENCHMARK.json keeps to its contract."""

from __future__ import annotations

import re

import bench_tiny  # noqa: F401  (puts the repository root on the path)
import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark_spec()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    cfg = spec.config(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", WORKLOADS)
def test_each_cell_finds_its_files(name):
    w = spec.workload(name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    spec.config(w["config"])
    spec.traffic(w["traffic"])
    limits = spec.limits(name)
    assert limits and all("limit" in v for v in limits.values())
    e2e = [m["name"] for m in spec.metrics_of(name, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = spec.metrics_of(name, "per_layer")
    assert per
    for m in per:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))


def test_metrics_keep_to_the_contract():
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e_names
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e_names
        assert all(w in WORKLOADS for w in m.get("workloads", []))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_a_missing_metric_file_is_an_error():
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.nc")


def test_a_suffixed_metric_is_read_by_its_base_file(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "width.py").write_text("def read(ctx):\n    return 1.0\n")
    (tmp_path / "metrics" / "width.lp.py").write_text("def read(ctx):\n    return 2.0\n")
    monkeypatch.setattr(spec, "BENCH", tmp_path)
    # a file of its own wins; a suffix without one falls back to the base
    assert spec.reader("width.lp")({}) == 2.0
    assert spec.reader("width.nc")({}) == 1.0
    assert spec.reader("width")({}) == 1.0
    with pytest.raises(FileNotFoundError):
        spec.reader("height.nc")

