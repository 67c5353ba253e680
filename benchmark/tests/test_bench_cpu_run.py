"""A cell runs end to end on the CPU at a small size, with the kernels'
plain versions, and prints the contract's last line; without a card the
command prints no result and fails."""

import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness.manifest import Cell

from .small import CELLS, ROOT, run_cpu


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell,entry,small", CELLS)
def test_cell_runs_and_prints_the_last_line(cell, entry, small, trace):
    rc, result, err = run_cpu(cell, trace=trace, overrides=small,
                              entry=entry)
    assert rc == 0, err[-3000:]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "compared"
    assert result["correct"] is True, err[-3000:]
    assert result["attempted"] >= 1 and result["failed"] == 0
    c = Cell(cell, entry=entry)
    names = set(result["metrics"])
    if trace:
        assert names <= {m["name"] for m in c.per_layer}
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert "breakdown" in result
    else:
        assert names == {m["name"] for m in c.end_to_end}
    for k, v in result["compared"].items():
        assert v["value"] <= v["limit"], k
    tail = err.strip().splitlines()[-len(result["compared"]):]
    assert [line.split()[1] for line in tail] == list(result["compared"])


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0][0], "--seed", "7", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_outside_a_checkout_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the program is missing and a run fails, on the CPU too."""
    import json
    import shutil

    from .small import SMALL, _DRIVER
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".build",
                                                  "__pycache__"))
    spec = {"argv": ["--workload", CELLS[0][0], "--seed", "7", "--seconds",
                     "1", "--trace", "0"], "overrides": SMALL,
            "fault": None, "entry": None}
    r = subprocess.run([sys.executable, "-c",
                        _DRIVER.format(root=str(tmp_path)),
                        json.dumps(spec)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and r.stdout == ""
    assert "seaice_tpu_torch" in r.stderr
