"""Ridging (`column/driver.py::step_ridging`: exponential participation
and redistribution, 3 passes, then the small-ice cleanup): device busy ms
a step of the operations launched inside the program's `column.ridging`
span (`harness/spans.py`); None where the program has no such span."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps or not sp.intervals("column.ridging"):
        return None
    return sp.device_us("column.ridging") / 1e3 / ctx.steps
