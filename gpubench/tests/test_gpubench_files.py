"""Every cell, configuration, traffic mix and per-layer metric is a file
of its own, found by the name ``BENCHMARK.json`` gives it, and
``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from gpubench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in names and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.workload["name"] == cell and c.chips == 1
    assert c.config["name"] == c.entry["config"]
    assert any(m.name == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m.name))
    assert set(c.workload["check"]["limits"])
    assert os.path.exists(os.path.join(spec.BENCH_DIR, "drivers",
                                       c.workload["driver"] + ".py"))


def test_each_config_states_its_cut():
    for c in BENCH["configs"]:
        f = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert f["source"] == c["source"] and c["file"].startswith("gpubench/configs/")
        for key in ("reduced", "assumed", "deployment", "departures", "port"):
            assert key in f, key
        assert sorted(f["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")), key
    mixtral = spec.config_file("mixtral_8x7b")
    assert any("renormalise" in d for d in mixtral["departures"])


def test_every_file_is_used_by_some_entry():
    metrics = {m["name"] for m in BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(spec.BENCH_DIR, "layer_metrics"))
             if f.endswith(".py")}
    assert files == metrics
    cells = {f[:-5] for f in os.listdir(os.path.join(spec.BENCH_DIR, "workloads"))}
    assert cells == set(CELLS)
