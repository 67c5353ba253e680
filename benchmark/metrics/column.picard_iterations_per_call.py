"""The column's Picard heat solve: iterations a call, the program's
counters `column.picard_iterations` over `column.picard_calls`
(`column/bl99.py::run_until_converged`) as the recorder keeps them for
the process (the warm-up, the window and the steps around it; set-up
builds no column); None where the program keeps no such counters."""

import importlib

PROGRAM = "seaice_tpu_torch"


def read(ctx):
    try:
        diag = importlib.import_module(f"{PROGRAM}.diagnostics")
    except ImportError:
        return None
    counters = getattr(getattr(diag, "RECORDER", None), "counters", None)
    if not counters or not counters.get("column.picard_calls"):
        return None
    return counters["column.picard_iterations"] / \
        counters["column.picard_calls"]
