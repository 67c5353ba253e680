"""The program's spans and counters (`seaice_tpu_torch/diagnostics.py`,
`RECORDER`): the recorder itself, the marks a step puts into a
`torch.profiler` trace on the CPU (one dycore step of the subdiv-2 panel
sphere, and one step of the same sphere in two blocks driven in lockstep),
and the counters of the Picard loop, the flag fetch and the kernel
build, whose span is set-up."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seaice_tpu_torch import config as C
from seaice_tpu_torch.diagnostics import (MARK_CLOSE, MARK_OPEN, RECORDER,
                                          Recorder)
from seaice_tpu_torch.dynamics.evp import DynamicsForcing
from seaice_tpu_torch.mesh import icosahedral_mesh
from seaice_tpu_torch.mesh.panels import panel_reorder
from seaice_tpu_torch.transport.tracers import standard_tracer_tree

torch.set_num_threads(1)
F64 = torch.float64
REMAP_STAGES = ["remap.reconstruct", "remap.departure", "remap.flux",
                "remap.update"]


def test_recorder_totals_counts_parents_and_counters():
    rec = Recorder()
    for _ in range(2):
        with rec.span("step"):
            with rec.span("transport.remap"):
                with rec.span("remap.flux"):
                    assert rec.open_spans() == ["step", "transport.remap",
                                                "remap.flux"]
            with rec.span("transport.remap"):
                pass
    rec.count("host.flag_fetches")
    rec.count("column.picard_iterations", 4)
    rec.count("column.picard_iterations", 2)
    assert rec.counts == {"step": 2, "transport.remap": 4, "remap.flux": 2}
    assert rec.parents == {"step": None, "transport.remap": "step",
                           "remap.flux": "transport.remap"}
    assert rec.totals["step"] >= rec.totals["transport.remap"] >= \
        rec.totals["remap.flux"] > 0.0
    assert rec.counters == {"host.flag_fetches": 1,
                            "column.picard_iterations": 6}
    assert rec.step_id == 2 and rec.open_spans() == []
    report = rec.report()
    assert "remap.flux" in report and "column.picard_iterations" in report

    @rec.span("setup.mesh")
    def build(x):
        return x + 1

    assert build(1) == 2 and rec.counts["setup.mesh"] == 1

    # disabled, it keeps nothing, marks nothing, and stays balanced
    # across a switch inside a span
    before = rec.snapshot()
    rec.enabled = False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("step"):
            rec.enabled = True
            rec.count("host.flag_fetches", 0)
        rec.enabled = False
        rec.count("host.flag_fetches")
        with rec.span("step"):
            pass
    assert rec.snapshot() == before and rec.open_spans() == []
    assert not [e for e in prof.events() if e.name.startswith("seaice")]


def mark_spans(prof):
    """(name, step id, depth) of every span instance in the order the
    spans opened, from the trace's marks; asserts they are balanced and
    well nested."""
    marks = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith((MARK_OPEN, MARK_CLOSE)))
    out, stack = [], []
    for _, mark in marks:
        name, step = mark[len(MARK_OPEN):].rsplit("#", 1)
        if mark.startswith(MARK_OPEN):
            out.append((name, int(step), len(stack)))
            stack.append(name)
        else:
            assert stack and stack.pop() == name, mark
    assert not stack
    return out


def sphere_case():
    mesh = icosahedral_mesh(2)
    cfg = C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=2, n_ice_layers=2,
                        n_snow_layers=1),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=4, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(conservation_check=True),
        column=C.ColumnConfig(use_column_package=False))
    rng = np.random.default_rng(0)
    nc = mesh.n_cells
    area = np.where((np.abs(mesh.lat_cell) > 0.5)[:, None],
                    rng.uniform(0.1, 0.45, (nc, 2)), 0.0)
    z = np.zeros(nc)
    forcing = dict(u_air_velocity=5.0 * rng.standard_normal(nc),
                   v_air_velocity=5.0 * rng.standard_normal(nc),
                   air_density=np.full(nc, 1.3), u_ocean_velocity=z,
                   v_ocean_velocity=z, sea_surface_tilt_u=z,
                   sea_surface_tilt_v=z, land_ice_mask=z)
    return mesh, cfg, (area, 1.5 * area, 0.1 * area), forcing


def test_marks_of_a_dycore_step():
    """The spans of one step of the panel sphere (K3's route, the remap
    with its conservation check) under a CPU profiler: balanced, well
    nested, all of the step's instance, in the step's order."""
    from seaice_tpu_torch.model import SeaIceModel
    mesh, cfg, ice, f = sphere_case()
    mesh, _ = panel_reorder(mesh, 2)
    model = SeaIceModel(mesh, cfg, F64, device="cpu",
                        tracer_tree=standard_tracer_tree(2, 1))
    state = model.init_state(*ice)
    forcing = DynamicsForcing(**{k: torch.as_tensor(v) for k, v in
                                 f.items()})
    step = model.make_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model.tensors, state, forcing)
    spans = mark_spans(prof)
    assert {k for _, k, _ in spans} == {RECORDER.step_id}
    assert spans[0] == ("step", RECORDER.step_id, 0)
    assert [s for s in spans if s[0] == "step"] == spans[:1]
    names = [n for n, _, _ in spans]
    assert names[1:] == (["velocity.prepare"] * 3 + ["velocity.loop",
                         "velocity.finish", "remap.checks",
                         "transport.remap"] + REMAP_STAGES +
                         ["remap.checks"])
    depth = {n: d for n, _, d in spans}
    assert depth["transport.remap"] == 1 and \
        {depth[n] for n in REMAP_STAGES} == {2}


def test_marks_of_a_lockstep_step_stay_in_their_block():
    """Two blocks of the same sphere in one process, driven in lockstep:
    at every exchange no span of a block's generator is open (each closes
    before its generator yields), and the marks nest."""
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    mesh, cfg, ice, f = sphere_case()
    sm = ShardedSeaIceModel(mesh, cfg, 2, F64, devices="cpu",
                            tracer_tree=standard_tracer_tree(2, 1))
    states = sm.init_state(*ice)
    forcings = sm.scatter_cell_tree(DynamicsForcing(**f))
    seen = []

    def watch(fn):
        def watched(*a, **k):
            seen.append(tuple(RECORDER.open_spans()))
            return fn(*a, **k)
        return watched

    sm.exchange = watch(sm.exchange)
    sm.evp_subcycle = watch(sm.evp_subcycle)
    step = sm.make_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(sm.tensors, sm.halo, states, forcings)
    assert set(seen) == {("step",), ("step", "velocity.loop")}
    assert seen.count(("step", "velocity.loop")) == 4
    spans = mark_spans(prof)
    names = [n for n, _, _ in spans]
    assert names.count("step") == 1 and names.count("transport.remap") == 2
    assert names.count("remap.flux") == 2
    # block 0, then block 1, up to each exchange: two pieces of the
    # preparation each, then the third and K6's set-up before the first
    # subcycle
    assert names[1:9] == ["velocity.prepare"] * 5 + [
        "velocity.loop", "velocity.prepare", "velocity.loop"]


def test_picard_counters_count_the_loop():
    from seaice_tpu_torch.column.bl99 import run_until_converged
    calls0 = RECORDER.counters.get("column.picard_calls", 0)
    iters0 = RECORDER.counters.get("column.picard_iterations", 0)

    def one(carry, niter):
        return carry[0] + 1, torch.tensor([niter >= 5])

    carry, n = run_until_converged(one, (0, torch.tensor([False])), 1)
    assert n == 6 == carry[0]            # tested every 2 iterations
    run_until_converged(one, (0, torch.tensor([False])), 1, nitermax=3)
    assert RECORDER.counters["column.picard_calls"] - calls0 == 2
    assert RECORDER.counters["column.picard_iterations"] - iters0 == 9


def test_flag_fetch_counter():
    from seaice_tpu_torch.error import fetch_flags
    n0 = RECORDER.counters.get("host.flag_fetches", 0)
    assert fetch_flags({"ok": torch.tensor(True)}) == {"ok": True}
    assert RECORDER.counters["host.flag_fetches"] == n0 + 1


class FakeNvcc:
    """`subprocess.Popen` of one nvcc run: writes its output file."""
    returncode = 0

    def __init__(self, cmd, **_):
        open(cmd[cmd.index("-o") + 1], "w").close()

    def communicate(self):
        return "", None


def test_kernel_build_is_one_setup_span(tmp_path, monkeypatch):
    """`setup.kernels` opens once, at the top level, with one
    `kernels.compiled` per nvcc run; the wrappers' first launches then
    open each library without reopening the span, one `kernels.loaded`
    per library found built (nvcc and the loader faked)."""
    from seaice_tpu_torch.kernels import build
    monkeypatch.setattr(build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    for name in ("_libs", "_built"):
        monkeypatch.setattr(build, name, {})
    monkeypatch.setattr(build, "_compiled", set())
    srcs = build.cuda_sources()
    assert len(srcs) > 1
    for src in srcs[1:]:                  # all but the first found built
        open(build._cuda_lib_path(src), "w").close()
    before = dict(RECORDER.counters)
    spans0 = RECORDER.counts.get("setup.kernels", 0)

    def grew(name):
        return RECORDER.counters.get(name, 0) - before.get(name, 0)

    paths = build.build_cuda()
    assert sorted(paths) == sorted(build._built) and len(paths) == len(srcs)
    assert grew("kernels.compiled") == 1 and grew("kernels.loaded") == 0
    for _ in range(2):
        for name in paths:
            assert build.get_cuda_lib(name) == paths[name]
    assert grew("kernels.compiled") == 1
    assert grew("kernels.loaded") == len(srcs) - 1
    assert RECORDER.counts["setup.kernels"] == spans0 + 1
    assert RECORDER.parents["setup.kernels"] is None


@pytest.mark.parametrize("name", ["setup.mesh", "setup.panel_reorder",
                                  "setup.dynamics_tensors",
                                  "setup.remap_geometry", "setup.upload"])
def test_setup_spans(name):
    """Building a model opens each set-up span, outside any step."""
    from seaice_tpu_torch.model import SeaIceModel
    n0 = RECORDER.counts.get(name, 0)
    mesh, cfg, _, _ = sphere_case()
    mesh, _ = panel_reorder(mesh, 2)
    SeaIceModel(mesh, cfg, F64, device="cpu")
    assert RECORDER.counts[name] > n0
    assert RECORDER.parents[name] in (None, "setup.dynamics_tensors")


COLUMN_CHILDREN = ["column.shortwave", "column.atmo", "column.vertical",
                   "column.ponds", "column.itd_thermo"]


@pytest.mark.parametrize("on", [True, False], ids=["column_on",
                                                   "column_off"])
def test_column_thermo_child_spans(on):
    """A step of the subdiv-2 sphere with MPAS-Seaice's standard column
    (mushy, dEdd, level-ice ponds, age, first-year ice) opens each child
    span of `column.thermo` once, directly inside it and in the column's
    order; with the column package off, no column span opens."""
    import dataclasses
    from seaice_tpu_torch.column.driver import AtmosForcing, OceanForcing
    from seaice_tpu_torch.model import SeaIceModel
    mesh, cfg, ice, f = sphere_case()
    cfg = dataclasses.replace(cfg, column=C.ColumnConfig(
        use_column_package=on, ktherm=2, shortwave="dEdd",
        pond_scheme="lvl", use_level_ice=True, use_ice_age=True,
        use_first_year_ice=True))
    model = SeaIceModel(mesh, cfg, F64, device="cpu")
    state = model.init_state(*ice)
    nc = mesh.n_cells

    def full(v):
        return torch.full((nc,), v, dtype=F64)

    atmos = AtmosForcing(
        air_temperature=full(255.0), specific_humidity=full(4e-4),
        u_air=torch.as_tensor(f["u_air_velocity"]),
        v_air=torch.as_tensor(f["v_air_velocity"]),
        longwave_down=full(180.0), sw_vis_dir=full(60.0),
        sw_vis_dif=full(50.0), sw_ir_dir=full(65.0), sw_ir_dif=full(35.0),
        rain_rate=full(0.0), snow_rate=full(2e-6), air_density=full(1.3),
        air_level_height=full(10.0))
    ocean = OceanForcing(sst=full(-1.8), sss=full(34.0),
                         freezing_temperature=full(-1.8), frzmlt=full(10.0),
                         mixed_layer_depth=full(20.0))
    forcing = DynamicsForcing(**{k: torch.as_tensor(v) for k, v in
                                 f.items()})
    step = model.make_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model.tensors, state, forcing, atmos=atmos, ocean=ocean,
             coszen=full(0.3), day_of_year=1,
             lat=torch.as_tensor(mesh.lat_cell, dtype=F64))
    spans = mark_spans(prof)
    names = [n for n, _, _ in spans]
    if not on:
        assert not [n for n in names if n.startswith("column.")]
        return
    i = names.index("column.thermo")
    top = spans[i][2]
    children = []
    for n, _, d in spans[i + 1:]:
        if d <= top:
            break
        if d == top + 1:
            children.append(n)
    assert children == COLUMN_CHILDREN
    assert all(names.count(n) == 1 for n in COLUMN_CHILDREN)
