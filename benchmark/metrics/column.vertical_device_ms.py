"""The mushy-layer vertical thermodynamics (`column/vertical.py::
thermo_vertical`, the Picard heat solve and the growth and melt): device
busy ms a step of the operations launched inside the program's
`column.vertical` span, part of `column.thermo` (`harness/spans.py`);
None where the program has no such span."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps or not sp.intervals("column.vertical"):
        return None
    return sp.device_us("column.vertical") / 1e3 / ctx.steps
