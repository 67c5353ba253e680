"""The per-layer readers on a trace made by hand: each reads its layer,
and a reader that finds nothing returns nothing."""

import pytest

from benchmark.harness.manifest import metric_reader
from benchmark.harness.peaks import bound_seconds
from benchmark.harness.tracectx import TraceContext
from benchmark.harness.window import Window
from benchmark.harness.work import evp_panel_loop_work

CONF = {"mesh": {"subdivisions": 7},
        "velocity": {"elastic_subcycle_number": 120,
                     "include_metric_terms": True}}
MESH = {"n_cells": 163842, "n_vertices": 327680, "max_edges": 6,
        "vertex_degree": 3}
READERS = ("step.device_kernels_per_step", "device.idle_share",
           "velocity.k3_roofline_share", "transport.k2_roofline_share")


def context(device_ops, extra=None):
    w = Window(steps=2, window_s=0.01)
    w.trace = {"device_ops": device_ops, "host_ops": [], "flux_calls": []}
    return TraceContext(w, CONF, MESH, dict({"itemsize": 4}, **(extra or {})))


def test_readers_of_a_dycore_step():
    ops = [("void panel_loop_kernel<float>(PanelArgs<float>)", 0, 2000),
           ("void panel_loop_kernel<float>(PanelArgs<float>)", 5000, 7000),
           ("elementwise_kernel", 2000, 3000),
           ("Memcpy HtoD (Pinned -> Device)", 3000, 3100)]
    ctx = context(ops, {"layout_s": 30.0})
    assert ctx.busy_s == pytest.approx(0.0051)
    assert metric_reader("step.device_kernels_per_step")(ctx) == 1.5
    assert metric_reader("device.idle_share")(ctx) == pytest.approx(49.0)
    assert metric_reader("setup.layout_s")(ctx) == 30.0
    bound = bound_seconds(*evp_panel_loop_work(128, 120, True, 4))
    assert metric_reader("velocity.k3_roofline_share")(ctx) == \
        pytest.approx(100 * bound / 0.002)
    assert metric_reader("transport.k2_roofline_share")(ctx) is None


def test_k2_share_from_the_counted_calls():
    """The mean of the counted calls stands for each traced call."""
    import torch

    from benchmark.harness.work import flux_work, flux_work_start
    from seaice_tpu_torch.transport.tracers import standard_tracer_tree
    tree = standard_tracer_tree(n_ice_layers=7, n_snow_layers=1)
    recon = {s.name: {"center": torch.zeros(
        (40, 5) + ((s.n_layers,) if s.n_layers else ()))}
        for s in tree.specs}
    g = torch.Generator().manual_seed(3)
    cell = torch.randint(0, 40, (60, 6), generator=g)
    areas = [torch.rand(60, 6, generator=g) for _ in range(2)]
    mask = torch.ones(60)
    k2 = "void ir_flux_kernel<float>(int)"
    ctx = context([(k2, 0, 50), (k2, 100, 130), (k2, 200, 240)])
    ctx.flux_calls = [(flux_work_start(tree, recon, cell, a, mask), 4)
                      for a in areas]
    least = sum(bound_seconds(*flux_work(tree, recon, cell, a, mask, 4)[:2])
                for a in areas) / 2
    assert metric_reader("transport.k2_roofline_share")(ctx) == \
        pytest.approx(100 * 3 * least / 120e-6)


def test_readers_find_nothing_in_an_empty_trace():
    ctx = context([])
    for name in READERS:
        assert metric_reader(name)(ctx) is None
