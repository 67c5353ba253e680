"""The measured window: a closed loop of one client, each step waiting
for the one before.

`run_window` steps until `seconds` have passed (untraced run) or for a
fixed number of steps under `torch.profiler` (traced run).  Each step is
timed by CUDA events on the device's clock, from its start to the end of
its synchronise and state check; the window's length is the host clock
over all of it.  A seeded reservoir keeps `samples` steps of the window,
drawn uniformly from all of its steps, with the state before and after
each, as device copies; the comparison with the reference reads them once
the window has closed."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List

import torch

from .inputs import rng_for


@dataclasses.dataclass
class Window:
    steps: int = 0
    failed: int = 0
    failures: List[str] = dataclasses.field(default_factory=list)
    step_ms: List[float] = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    samples: list = dataclasses.field(default_factory=list)
    trace: dict = None


class _Clock:
    """Step boundaries: CUDA events on a card, the host clock elsewhere
    (the CPU runs of the benchmark's tests)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            return float(a.elapsed_time(b))
        return (b - a) * 1e3


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def _flux_calls():
    """The work counts of every flux-integration call (K2) made inside,
    read on the device from its inputs (`work.flux_work_start`) and
    finished after the window."""
    calls = []
    from seaice_tpu_torch.transport import cuda_flux

    from .work import flux_work_start
    orig = cuda_flux.integrate_fluxes_cuda

    def kept(tree, recon, rt, cell, xq, yq, area, mask_edge):
        calls.append((flux_work_start(tree, recon, cell, area, mask_edge),
                      xq.element_size()))
        return orig(tree, recon, rt, cell, xq, yq, area, mask_edge)

    cuda_flux.integrate_fluxes_cuda = kept
    try:
        yield calls
    finally:
        cuda_flux.integrate_fluxes_cuda = orig


def _counted_step(side, calls):
    """One untraced step outside the window whose K2 calls are counted."""
    with _flux_calls() as c:
        side.step()
        side.check()
        sync(side.device)
    calls.extend(c)


def run_window(side, seconds, seed, samples, trace_steps=None):
    """The window.  trace_steps: None for the untraced run, else the
    number of steps to trace.  A traced window is framed by one untraced
    step before it and one after it, whose K2 calls are counted: their
    work stands for the traced calls', so that the trace holds none of
    the counting's kernels."""
    traced = trace_steps is not None
    rng = rng_for(seed, "samples")
    clock = _Clock(side.device)
    w = Window()
    marks = []
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if clock.cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    flux_calls = []
    if traced:
        _counted_step(side, flux_calls)
    sync(side.device)
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        _loop(side, w, marks, clock, rng, seconds, samples, trace_steps)
        sync(side.device)
        w.window_s = time.perf_counter() - t0
    w.step_ms = [clock.ms(a, b) for a, b in marks]
    if traced:
        _counted_step(side, flux_calls)
        w.trace = reduce_trace(prof, flux_calls)
    return w


def _loop(side, w, marks, clock, rng, seconds, samples, trace_steps):
    """The window's steps (see `run_window`), from now on."""
    t0 = time.perf_counter()
    while True:
        n = w.steps
        slot = n if n < samples else int(rng.integers(0, n + 1))
        pre = side.snapshot() if slot < samples else None
        start = clock.mark()
        side.step()
        flags = side.check()
        end = clock.mark()
        marks.append((start, end))
        w.steps += 1
        bad = [k for k, ok in flags.items() if not ok]
        if bad:
            w.failed += 1
            w.failures.append(f"step {n}: {', '.join(bad)}")
            break
        if pre is not None:
            item = (n, pre, side.snapshot())
            if n < samples:
                w.samples.append(item)
            else:
                w.samples[slot] = item
        if trace_steps is not None:
            if w.steps >= trace_steps:
                break
        elif time.perf_counter() - t0 >= seconds:
            break


def reduce_trace(prof, flux_calls) -> dict:
    """From the profiler's events: every device operation and the host's
    operations, each (name, start, end) in us, and the counted K2
    calls."""
    from torch.autograd import DeviceType
    device_ops, host_ops = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            device_ops.append((e.name, tr.start, tr.end))
        else:
            host_ops.append((e.name, tr.start, tr.end))
    return {"device_ops": device_ops, "host_ops": host_ops,
            "flux_calls": flux_calls}
