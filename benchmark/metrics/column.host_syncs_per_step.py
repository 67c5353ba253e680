"""Column thermodynamics: the synchronising runtime calls the host made
inside the program's `column.thermo` span, a step (`harness/spans.py`):
the Picard loop's convergence fetch every second iteration, and any
other; None where the program has no such span."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps or not sp.intervals("column.thermo"):
        return None
    return sp.syncs_inside("column.thermo") / ctx.steps
