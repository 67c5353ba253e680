"""Small sizes for the CPU tests: the cells' own configurations and
traffic with a subdivision-2 mesh (162 cells) and 8 elastic subcycles,
and a run of the harness in a process of its own (so that no module a
test process has loaded counts against the run)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL = {"config": {"mesh": {"subdivisions": 2},
                    "velocity": {"elastic_subcycle_number": 8}},
         "traffic": {"trace_steps": 3}}

# (cell, workload entry or None, overrides)
CELLS = [("qu60_dycore.winter_caps", None, SMALL)]

_DRIVER = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.harness.cli import main
from benchmark.tests import faults
spec = json.loads(sys.argv[1])
fault = getattr(faults, spec["fault"]) if spec["fault"] else None
sys.exit(main(spec["argv"], device="cpu", overrides=spec["overrides"],
              fault=fault, entry=spec["entry"]))
"""


def run_cpu(cell, seed=123456789012, seconds=1.0, trace=0, fault=None,
            overrides=SMALL, entry=None):
    """(exit code, result dict or None, stderr) of one run on the CPU."""
    spec = {"argv": ["--workload", cell, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", str(trace)],
            "overrides": overrides, "fault": fault, "entry": entry}
    r = subprocess.run([sys.executable, "-c", _DRIVER.format(root=ROOT),
                        json.dumps(spec)], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and r.returncode == 0 else None
    return r.returncode, result, r.stderr
