"""Model step (`model.py::SeaIceModel.make_step`): device kernels (the
profiler's CUDA events, copies and sets left out) a step of the traced
window."""


def read(ctx):
    n = ctx.n_kernels()
    if not n or not ctx.steps:
        return None
    return n / ctx.steps
