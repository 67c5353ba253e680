"""IR transport (`model.py::_transport` -> `transport/remap.py`): device
busy ms a step of the operations launched inside the program's
`transport.remap` span, K2 included (`harness/spans.py`)."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps:
        return None
    return sp.device_us("transport.remap") / 1e3 / ctx.steps
