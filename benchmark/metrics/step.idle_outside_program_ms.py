"""Model step: ms a step in which no device operation ran while the host
was outside every `step` span of the program: the harness's state check
and its fetch, and the Python between steps (`harness/spans.py`)."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps:
        return None
    return sp.idle_outside_us("step") / 1e3 / ctx.steps
