"""Column thermodynamics (`model.py::column_before_dynamics` ->
`column/driver.py::step_thermodynamics`): device busy ms a step of the
operations launched inside the program's `column.thermo` span
(`harness/spans.py`); None where the program has no such span."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps or not sp.intervals("column.thermo"):
        return None
    return sp.device_us("column.thermo") / 1e3 / ctx.steps
