"""Host layouts (`dynamics/evp.py::build_dynamics_tensors`: the
Wachspress basis and its upload): the program's
`setup.dynamics_tensors` span's total, in seconds
(`harness/spans.py`)."""

from benchmark.harness.spans import setup_total


def read(ctx):
    return setup_total("setup.dynamics_tensors")
