"""The delta-Eddington shortwave (`column/dedd.py::shortwave_dedd`, three
bands, the snow-or-bare and the ponded columns): device busy ms a step of
the operations launched inside the program's `column.shortwave` span,
part of `column.thermo` (`harness/spans.py`); None where the program has
no such span."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps or not sp.intervals("column.shortwave"):
        return None
    return sp.device_us("column.shortwave") / 1e3 / ctx.steps
