"""The readers of the program's spans on a trace made by hand: marks,
launch calls and device operations.  Each reads its value; on a trace
whose launch calls and device operations do not pair, or that holds no
marks (a program without spans), each returns nothing."""

import pytest

from benchmark.harness import spans
from benchmark.harness.manifest import metric_reader
from benchmark.harness.tracectx import TraceContext
from benchmark.harness.window import Window

SPAN_READERS = ("transport.remap_device_ms", "transport.remap_idle_ms",
                "step.idle_outside_program_ms", "step.host_syncs_per_step")
SETUP = {"setup.panel_reorder_s": "setup.panel_reorder",
         "setup.dynamics_tensors_s": "setup.dynamics_tensors",
         "setup.remap_geometry_s": "setup.remap_geometry"}

# one step: a launch before the remap, two inside it with a synchronise
# between them, then the harness's fetch outside the step (us)
HOST = [("seaice>step#1", 0, 1), ("cudaLaunchKernel", 10, 12),
        ("seaice>transport.remap#1", 100, 101),
        ("seaice>remap.flux#1", 140, 141), ("cudaLaunchKernel", 150, 152),
        ("cudaStreamSynchronize", 200, 260),
        ("seaice<remap.flux#1", 270, 271),
        ("cudaLaunchKernelExC_v11060", 300, 302),
        ("seaice<transport.remap#1", 499, 500), ("seaice<step#1", 599, 600),
        ("cudaMemcpyAsync", 700, 702), ("cudaStreamSynchronize", 703, 740),
        ("aten::add", 800, 1000)]
DEVICE = [("elementwise_kernel", 20, 90), ("index_kernel", 160, 260),
          ("void ir_flux_kernel<float>(int)", 320, 420),
          ("Memcpy DtoH (Device -> Pageable)", 720, 730)]


def context(host, device):
    w = Window(steps=1, window_s=0.001)
    w.trace = {"device_ops": device, "host_ops": host, "flux_calls": []}
    return TraceContext(w, {}, {}, {})


def test_span_readers_of_a_step():
    ctx = context(HOST, DEVICE)
    read = {n: metric_reader(n)(ctx) for n in SPAN_READERS}
    assert read["transport.remap_device_ms"] == pytest.approx(0.2)
    # [100, 500] less the two operations launched there
    assert read["transport.remap_idle_ms"] == pytest.approx(0.2)
    # [600, 1000] less the fetch's copy
    assert read["step.idle_outside_program_ms"] == pytest.approx(0.39)
    assert read["step.host_syncs_per_step"] == 1
    sp = spans.of(ctx)
    assert (sp.n_launches, sp.n_device) == (4, 4)
    # every idle us lies under one innermost span or outside them all
    idle = sp.idle_by_innermost()
    assert idle == pytest.approx({"step": 130.0, "transport.remap": 169.0,
                                  "remap.flux": 31.0, None: 390.0})
    assert sum(idle.values()) == pytest.approx(1e6 * ctx.window_s -
                                               1e6 * ctx.busy_s)
    assert sp.device_by_innermost() == pytest.approx(
        {"step": 70.0, "remap.flux": 100.0, "transport.remap": 100.0,
         None: 10.0})


def test_span_readers_find_nothing_unpaired_or_without_marks():
    extra = HOST + [("cudaLaunchKernel", 550, 551)]   # no device operation
    unmarked = [h for h in HOST if not h[0].startswith("seaice")]
    for host in (extra, unmarked):
        ctx = context(host, DEVICE)
        assert not spans.of(ctx).ok
        for n in SPAN_READERS:
            assert metric_reader(n)(ctx) is None


def test_setup_readers_read_the_recorder(monkeypatch):
    from seaice_tpu_torch.diagnostics import RECORDER
    ctx = context([], [])
    monkeypatch.setattr(RECORDER, "totals", {v: 1.5 + i for i, v in
                                             enumerate(SETUP.values())})
    assert [metric_reader(n)(ctx) for n in SETUP] == [1.5, 2.5, 3.5]
    # a program that keeps no recorder
    monkeypatch.setattr(spans, "PROGRAM", "benchmark.harness")
    assert [metric_reader(n)(ctx) for n in SETUP] == [None] * 3


def with_ids(ops, ids):
    """The ops with the profiler's correlation id, keyed by start (an id
    of 0 for the rest)."""
    return [op + (ids.get(op[1], 0),) for op in ops]


def test_spans_pair_by_correlation_id_past_a_lost_record():
    host = with_ids(HOST, {10: 1, 150: 2, 300: 3, 700: 4, 200: 5, 703: 6,
                           800: 2})             # an aten op's id may clash
    device = with_ids(DEVICE, {20: 1, 160: 2, 320: 3, 720: 4})
    sp = spans.Spans(device, host)
    assert sp.ok and sp.launch_names == {"cudaLaunchKernel",
                                         "cudaLaunchKernelExC",
                                         "cudaMemcpyAsync"}
    assert sp.device_us("transport.remap") == pytest.approx(200.0)
    # a lost device record leaves the rest paired; in order it would not
    lost = [d for d in device if d[1] != 160]
    sp = spans.Spans(lost, host)
    assert sp.ok and sp.device_us("transport.remap") == pytest.approx(100.0)
    assert not spans.Spans([d[:3] for d in lost], [h[:3] for h in host]).ok
    # a device operation whose call the trace lost is named, not guessed
    sp = spans.Spans(device, [h for h in host if h[1] != 150])
    assert not sp.ok and sp.unpaired == [("index_kernel", 160)]
