"""Velocity solve, K3 (`dynamics/cuda_panel_fused.py` ->
`panel_loop_kernel`): the least time of the calls (from the frozen
`evp_panel_loop_work`, N = 2**subdivisions) over their device time in
the trace, in %."""

from benchmark.harness.peaks import bound_seconds
from benchmark.harness.work import evp_panel_loop_work


def read(ctx):
    ts = ctx.kernels("panel_loop_kernel")
    if not ts:
        return None
    v = ctx.conf["velocity"]
    work = evp_panel_loop_work(2 ** ctx.conf["mesh"]["subdivisions"],
                               v["elastic_subcycle_number"],
                               v["include_metric_terms"],
                               ctx.extra["itemsize"])
    return 100.0 * len(ts) * bound_seconds(*work) / sum(ts)
