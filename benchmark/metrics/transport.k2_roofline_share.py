"""IR transport, K2 (`transport/cuda_flux.py` -> `ir_flux_kernel`): the
least time of the traced calls over their device time, in %.  A call's
least time is the larger of its bytes over the HBM bandwidth and its
operations over the float32 rate, counted from the inputs of the calls
of the untraced steps just before and just after the traced window
(`work.flux_work_finish`; their mean stands for each traced call, whose
inputs move by a step's transport between them)."""

from benchmark.harness.peaks import bound_seconds
from benchmark.harness.work import flux_work_finish


def read(ctx):
    ts = ctx.kernels("ir_flux_kernel")
    if not ts or not ctx.flux_calls:
        return None
    least = sum(bound_seconds(*flux_work_finish(start, itemsize)[:2])
                for start, itemsize in ctx.flux_calls) / len(ctx.flux_calls)
    return 100.0 * least * len(ts) / sum(ts)
