"""Host layouts (`mesh/panels.py::panel_reorder`): the program's
`setup.panel_reorder` span's total, in seconds (`harness/spans.py`)."""

from benchmark.harness.spans import setup_total


def read(ctx):
    return setup_total("setup.panel_reorder")
