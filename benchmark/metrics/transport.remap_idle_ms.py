"""IR transport: ms a step in which no device operation ran while the
host was inside the program's `transport.remap` span
(`harness/spans.py`).

Under the profiler the host launches the remap's few-microsecond
operations slower than the card runs them, so this idle follows the
profiler's host cost, which differs from run to run (2 to 16 ms a step
on one tree).  It compares two commits only when both are traced in
turns in one call, never across separate runs; `transport.remap_device_ms`
is the remap's number that does."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps:
        return None
    return sp.idle_inside_us("transport.remap") / 1e3 / ctx.steps
