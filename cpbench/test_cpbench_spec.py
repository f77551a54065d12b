"""CPU tests: BENCHMARK.json against the benchmark's contract, and every
piece of a cell found by its name."""

from __future__ import annotations

import json
import re

import pytest

from cpbench import check, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER_METRICS = [m["name"] for m in BENCH["per_layer"]]
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_has_the_contract_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cpbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[sec]]
    assert len(names) == len(set(names))
    assert all(spec.NAME.fullmatch(n) for n in names)


def test_configs_are_files_under_the_paths():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"cpbench/configs/{c['name']}.json"
        assert _line(c["why"]) and _line(c["source"])
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"sweep_ms", "problems_per_s", "request_p95_ms", "setup_s"} <= set(e2e)
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_metric_and_a_layer_metric(cell):
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")]
    layers = spec.metrics_of(BENCH, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:  # each layer metric moves an end-to-end metric its cells report
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_workload_file_agrees_with_benchmark_json(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"} and _line(entry["why"])
    w = spec.workload(cell)
    assert (w["config"], w["traffic"], w["chips"]) == (entry["config"], entry["traffic"],
                                                       entry["chips"])
    assert entry["chips"] == 1
    assert w["limits"] and set(w["limits"]) <= set(check.NUMBERS)
    assert spec.driver(w["driver"]).__name__ == "Driver"
    config = spec.config(w["config"])
    assert {"shape", "dtype", "tf32", "rank", "source", "reduced", "assumed"} <= set(config)
    assert check.control_precision(config) == "tf32"
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert pairs.count((entry["config"], entry["traffic"])) == 1


@pytest.mark.parametrize("name", LAYER_METRICS)
def test_layer_metric_reader_found_by_name(name):
    m = next(x for x in BENCH["per_layer"] if x["name"] == name)
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert _line(m["layer"]) and UNIT.fullmatch(m["unit"])
    read = spec.metric(name)
    empty = type("Run", (), {"trace": None, "batched": name.endswith(".batched"),
                             "counts": {}, "sweeps": 0, "least_sweep_s": 1.0})()
    assert read(empty) is None  # nothing to read: the metric is left out, never 0


@pytest.mark.parametrize("bad", ["../configs/fmri4d", "a/b", "", ".hidden", "x" * 65])
def test_names_outside_the_pattern_are_refused(bad):
    with pytest.raises(ValueError):
        spec.workload(bad)


def test_unknown_names_are_not_found():
    with pytest.raises(FileNotFoundError):
        spec.config("no_such_config")
    with pytest.raises(FileNotFoundError):
        spec.metric("no_such.metric")
