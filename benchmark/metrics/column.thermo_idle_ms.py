"""Column thermodynamics: ms a step in which no device operation ran
while the host was inside the program's `column.thermo` span
(`harness/spans.py`): the host's eager launches and the Picard loop's
convergence fetches.  Like `transport.remap_idle_ms`, it follows the
profiler's host cost, so it compares two commits only traced in turns in
one call."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps or not sp.intervals("column.thermo"):
        return None
    return sp.idle_inside_us("column.thermo") / 1e3 / ctx.steps
