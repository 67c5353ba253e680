"""The manifest meets the benchmark's contract, and every cell's files
are found by name."""

import json
import os
import re

import pytest

from benchmark.harness.manifest import BENCH_DIR, ROOT, Cell, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]] + \
        [w["name"] for w in m["workloads"]] + \
        [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in m["workloads"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert UNIT.match(p["unit"]) and p["moves"] in e2e
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in p["layer"]
    assert len(json.dumps(m)) < 64 * 1024


def test_full_check_fits_its_time():
    m = manifest()
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = Cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.config["path"] == "model_step"
    assert c.config["reduced"] == []
    groups = c.limits["amounts"]
    names = {"start_gap"} | {f"{g}.{k}" for g in groups
                             for k in ("state_gap", "increment_gap")}
    assert "start_gap" in c.limits["limits"]
    assert set(c.limits["limits"]) <= names
    assert c.end_to_end and c.per_layer
    for m in c.per_layer:
        assert callable(metric_reader(m["name"]))


def test_every_metric_has_a_reader():
    names = {p["name"] for p in manifest()["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "metrics"))
             if f.endswith(".py")}
    assert names <= files
    for f in files:
        assert callable(metric_reader(f))
