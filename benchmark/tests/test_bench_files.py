"""Every name in BENCHMARK.json resolves to its file, and the file keeps
the benchmark contract's shape."""

import importlib
import json
import os
import re

import pytest

from benchmark import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    wl = run.load_json(run.BENCH, "workloads", cell + ".json")
    assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
    importlib.import_module("benchmark.entries." + wl["entry"])
    e2e, layer = run.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    limits = run.load_json(run.BENCH, "limits", cell + ".json")
    assert limits and all(isinstance(v, (int, float)) and v >= 0
                          for v in limits.values())


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_resolves(cfg):
    c = next(x for x in BENCH["configs"] if x["name"] == cfg)
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/configs/")
    body = json.load(open(os.path.join(run.ROOT, c["file"])))
    for key in c["reduced"]:
        assert NAME.match(key)
        assert key in body and key in body["source_values"]
        assert not key.endswith(("_dim", "_rank"))
    assert any(w["config"] == cfg for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_resolves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert callable(run.metric_reader(metric))
    for cell in m.get("workloads", []):
        assert cell in CELLS


def test_names_and_units():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
