"""Finds a cell's files by the names in `BENCHMARK.json`:
  * `benchmark/configs/<config>.json`: the configuration as it is run;
  * `benchmark/traffic/<traffic>.json`: the traffic mix, read by the one
    general generator (`harness/inputs.py`);
  * `benchmark/workloads/<cell>.json`: the cell's amounts and limits for
    `correct` and the number of steps it samples;
  * `benchmark/metrics/<metric>.py`: one reader a per-layer metric;
  * `benchmark/reference/<phase>.py`: one phase of the reference's step,
    named in the configuration's "reference" list
    (`reference/model.py`).
A later change adds a cell, a configuration, a reference phase or a
metric by adding files and entries; no file here needs an edit."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root=ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """A workload of the manifest with its configuration, traffic, limits
    and metrics.  entry: a workload entry of the manifest's form, for a
    cell the manifest does not list yet (the benchmark's own tests); its
    configuration is `benchmark/configs/<config>.json`."""

    def __init__(self, name, root=ROOT, entry=None):
        m = manifest(root)
        found = [w for w in m["workloads"] if w["name"] == name]
        if entry is None and not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = entry or found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = load_json(os.path.join(
            BENCH_DIR, "configs", self.workload["config"] + ".json"))
        self.traffic = load_json(os.path.join(
            BENCH_DIR, "traffic", self.workload["traffic"] + ".json"))
        limits = os.path.join(BENCH_DIR, "workloads", name + ".json")
        self.limits = load_json(limits) if os.path.exists(limits) else {}
        self.end_to_end = [e for e in m["end_to_end"]
                           if name in e.get("workloads", [name])]
        self.per_layer = [e for e in m["per_layer"]
                          if name in e.get("workloads", [name])]
        self.run_seconds = m["run_seconds"]

    def apply(self, overrides=None):
        """Merge the groups of overrides ("config", "traffic", "workload")
        over the cell's files."""
        o = overrides or {}
        self.config = merge(self.config, o.get("config", {}))
        self.traffic = merge(self.traffic, o.get("traffic", {}))
        self.limits = merge(self.limits, o.get("workload", {}))


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def metric_reader(name: str):
    """The `read(ctx)` of `benchmark/metrics/<name>.py`."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
