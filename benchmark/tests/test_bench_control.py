"""The comparison fails what it must: at a small size on the CPU, sound
runs read under every limit of the cell, while the control (the reference
in float32 with its result held in bfloat16) and each planted fault of
the program's step (its state unchanged, half of the cells unstepped, one
answer altered where it is produced, the velocity solve's loop ended after
half of its subcycles) read over one of them, both in the
calibration's readings and through a whole run of the harness."""

import pytest

from benchmark.calibrate import readings
from benchmark.harness.manifest import Cell

from .small import CELLS, run_cpu

FAULTS = ("unchanged", "half_cells", "altered", "loop_cut_short")


def over_a_limit(reading, limits):
    return any(reading[k][0] > limits[k] for k in reading if k in limits)


@pytest.mark.parametrize("cell,entry,small", CELLS)
def test_control_and_faults_read_over_a_limit(cell, entry, small):
    c = Cell(cell, entry=entry)
    c.apply(small)
    limits = c.limits["limits"]
    for r in readings(cell, [21, 22], [21, 22], 3, "cpu", small, entry):
        assert r["start_gap"][0] <= limits["start_gap"]
        assert not over_a_limit(r["program"], limits), r["program"]
        assert over_a_limit(r["control"], limits), r["control"]
        for fault in FAULTS:
            assert over_a_limit(r[fault], limits), (fault, r[fault])


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell,entry,small", CELLS)
def test_broken_step_is_not_correct(cell, entry, small, fault):
    rc, result, err = run_cpu(cell, fault=fault, overrides=small,
                              entry=entry)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["compared"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c for c, entry, _ in CELLS if entry is None])
def test_cell_correct_on_the_card(card, cell):
    """One short run of each cell on the card (the benchmark's command)."""
    import json
    import subprocess
    import sys

    from .small import ROOT
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cell, "--seed", "987654321987", "--seconds", "5",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
