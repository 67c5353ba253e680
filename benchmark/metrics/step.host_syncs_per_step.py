"""Model step: the synchronising runtime calls (`cudaStreamSynchronize`,
`cudaDeviceSynchronize`, `cudaEventSynchronize`, a blocking `cudaMemcpy`)
the host made inside the program's `step` spans, a step
(`harness/spans.py`)."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp.ok or not ctx.steps:
        return None
    return sp.syncs_inside("step") / ctx.steps
