"""Host layouts (`transport/geometry.py::build_remap_geometry`: the
remap's stencils and least-squares coefficients): the program's
`setup.remap_geometry` span's total, in seconds (`harness/spans.py`)."""

from benchmark.harness.spans import setup_total


def read(ctx):
    return setup_total("setup.remap_geometry")
