"""The port's run loop, diagnostics and abort gate (`seaice_tpu_torch/
run.py`, `diagnostics.py`, `error.py`) against the JAX package's, float64
on the CPU.

The runners are held to each other without a JAX full-physics step: in
both, the model step is replaced by a recorder that keeps what the runner
hands it and returns the state unchanged, and the two runners' forcing
(dynamics, atmosphere, ocean with the slab ocean's frzmlt, coszen) is
compared over two steps (the JAX runner's step program run op by op
under `jax.disable_jit`).  The step itself is held to JAX by
`test_torch_column_model.py`.  With the column off the JAX runner is
small enough to run whole (jitted): the two runners' states after 4 box
steps are compared.  The full-physics file-driven run with a restart is
held to itself: restarted, bitwise the straight run."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from seaice_tpu_torch import config as C
from seaice_tpu_torch.model import SeaIceModel

from tests.mpas_fixture import write_icosahedral_mpas_file

torch.set_num_threads(1)
F64 = torch.float64
FORCING_RTOL = 1e-13
RUNNER_RTOL = 1e-11


def write_forcing_files(outdir, mesh):
    """The CORE 6-hourly and monthly atmosphere and the NCAR ocean files
    of `tests/test_mpas_files.py`, written with plain netcdf calls."""
    nc_cells, lat = mesh.n_cells, mesh.lat_cell

    def write(path_, times, fields):
        f = netcdf_file(path_, "w")
        f.createDimension("Time", len(times))
        f.createDimension("nCells", nc_cells)
        v = f.createVariable("xtime_seconds", "d", ("Time",))
        v[:] = times
        for k, a in fields.items():
            v = f.createVariable(k, "d", ("Time", "nCells"))
            v[:] = a
        f.close()

    t6 = np.arange(0.0, 4 * 21600.0, 21600.0)
    one = np.ones((len(t6), nc_cells))
    paths = [os.path.join(outdir, n) for n in
             ("core_sixhourly.nc", "core_monthly.nc", "ocean.nc")]
    write(paths[0], t6, {
        "airTemperature": 260.0 * one +
        5.0 * np.sin(t6)[:, None] * np.cos(lat)[None, :],
        "airSpecificHumidity": 8e-4 * one,
        "uAirVelocity": 6.0 * one, "vAirVelocity": 1.0 * one})
    tm = (np.arange(12) + 0.5) * (365.0 * 86400.0 / 12)
    onem = np.ones((12, nc_cells))
    write(paths[1], tm, {"cloudFraction": 0.6 * onem,
                         "rainfallRate": 2e-6 * onem})
    write(paths[2], tm, {
        "seaSurfaceTemperature": np.where(np.abs(lat) > 0.9, -1.7,
                                          6.0)[None, :] * onem,
        "seaSurfaceSalinity": 34.0 * onem,
        "uOceanVelocity": 0.0 * onem, "vOceanVelocity": 0.0 * onem,
        "oceanMixedLayerDepth": 20.0 * onem})
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The subdiv-2 MPAS file of `tests/mpas_fixture.py` and its forcing
    files."""
    from seaice_tpu_torch.io import read_mpas_mesh
    d = tmp_path_factory.mktemp("files")
    mesh_path = str(d / "mesh_icos2.nc")
    write_icosahedral_mpas_file(mesh_path, subdiv=2)
    return (mesh_path, *write_forcing_files(str(d),
                                            read_mpas_mesh(mesh_path)))


def _forcing(pkg, files):
    """(mesh, CoreAtmosForcing, NcarOceanForcing) read by `pkg`'s
    readers (`pkg`: "seaice_tpu" or "seaice_tpu_torch")."""
    import importlib
    io = importlib.import_module(pkg + ".io.forcing_reader")
    mesh = importlib.import_module(pkg + ".io.mesh_reader").read_mpas_mesh(
        files[0])
    return (mesh, io.core_atmos_from_files(files[1], files[2], mesh.lon_cell,
                                           mesh.lat_cell),
            io.ncar_ocean_from_file(files[3]))


def _full_physics_cfg(C, n_sub=4):
    """The main path's column (mushy thermodynamics, dEdd, level-ice
    ponds, Rothrock strength, ridging) at a small width."""
    return C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=3, n_ice_layers=4),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=n_sub, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(),
        column=C.ColumnConfig(ktherm=2, shortwave="dEdd",
                              pond_scheme="lvl", kstrength=1))


SETUP = dict(initial_condition_type="cice_default",
             initial_latitude_north=55.0, initial_latitude_south=-55.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


# -- the runner's forcing, held to JAX through a recording step ---------------

def test_runner_forcing_matches_reference(files):
    from seaice_tpu import config as J
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.namelist import RunSetup as JSetup
    from seaice_tpu.namelist import initial_state_from_setup as jinit
    from seaice_tpu.run import StandaloneRunner as JRunner
    from seaice_tpu_torch.convert import flatten_arrays
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.run import StandaloneRunner

    def recorder(log):
        def step(tensors, state, dyn, atmf, ocnf, coszen=None, **kw):
            log.append(dict(flatten_arrays({
                "dyn": dyn, "atm": atmf, "ocn": ocnf, "coszen": coszen}),
                **{k: np.asarray(v) for k, v in kw.items()
                   if v is not None and k in ("day_of_year", "lat")}))
            return state, {}
        return step

    logs = {}
    jmesh, jatm, jocn = _forcing("seaice_tpu", files)
    jmodel = JModel(jmesh, _full_physics_cfg(J), dtype=jnp.float64)
    jr = JRunner(jmodel, jinit(jmodel, JSetup(**SETUP)),
                 atmos_forcing=jatm, ocean_forcing=jocn)
    jr.step_fn = recorder(logs.setdefault("jax", []))
    jr._device_step = jr._build_device_step()
    with jax.disable_jit():
        jr.run(2)

    mesh, atm, ocn = _forcing("seaice_tpu_torch", files)
    model = SeaIceModel(mesh, _full_physics_cfg(C), dtype=F64, device="cpu")
    r = StandaloneRunner(model, initial_state_from_setup(model,
                                                         RunSetup(**SETUP)),
                         atmos_forcing=atm, ocean_forcing=ocn)
    r.step_fn = recorder(logs.setdefault("port", []))
    r._device_step = r._build_device_step()
    r.run(2)

    assert len(logs["jax"]) == len(logs["port"]) == 2
    for i, (got, want) in enumerate(zip(logs["port"], logs["jax"])):
        # the step's first-year-ice inputs, as the JAX runner passes them
        assert float(want.pop("day_of_year")) == 1.0
        assert float(got.pop("day_of_year")) == 1.0
        assert np.array_equal(got.pop("lat"), want.pop("lat"))
        assert set(got) == set(want)
        assert {"atm.longwave_down", "ocn.frzmlt", "coszen",
                "dyn.u_air_velocity"} <= set(got)
        for k in want:
            assert got[k].dtype == np.float64, k
            assert _rel(got[k], want[k]) <= FORCING_RTOL, (i, k)
    # the two steps' forcing differs (6-hourly records, the sun)
    assert _rel(logs["port"][1]["coszen"], logs["port"][0]["coszen"]) > 0.01
    assert r.clock.seconds == 2 * 1800.0


# -- diagnostics --------------------------------------------------------------

@pytest.fixture(scope="module")
def diag_states(files, tmp_path_factory):
    """A seeded full-physics state on the file mesh, in both packages
    (carried across by a checkpoint), and both packages' mesh tensors."""
    from seaice_tpu.io.checkpoint import load_checkpoint as jload
    from seaice_tpu.io.mesh_reader import read_mpas_mesh as jread
    from seaice_tpu_torch.io import read_mpas_mesh, save_checkpoint
    mesh = read_mpas_mesh(files[0])
    model = SeaIceModel(mesh, _full_physics_cfg(C), dtype=F64, device="cpu")
    rng = np.random.default_rng(3)
    nc, nv = mesh.n_cells, mesh.n_vertices
    area = rng.uniform(0.0, 0.3, (nc, 3)) * (rng.random((nc, 1)) > 0.3)
    state = model.init_state(area, area * rng.uniform(0.5, 3.0, (nc, 3)),
                             area * 0.1)
    tr = dict(state.tracers)
    for k in ("pondArea", "pondDepth"):
        tr[k] = torch.as_tensor(rng.uniform(0.0, 0.2, (nc, 3)))
    vel = state.velocity.replace(
        u_velocity=torch.as_tensor(rng.standard_normal(nv) * 0.3),
        v_velocity=torch.as_tensor(rng.standard_normal(nv) * 0.3))
    state = state.replace(tracers=tr, velocity=vel)
    path = str(tmp_path_factory.mktemp("diag") / "state.npz")
    save_checkpoint(path, state)
    jstate, _ = jload(path)
    return (model, state, mesh.tensors(F64, "cpu"), jstate,
            jread(files[0]).tensors(jnp.float64))


def _poison(check, state):
    """The state changed so that `check` fails."""
    tr = dict(state.tracers)
    vel = state.velocity
    a, v = tr["iceAreaCategory"].clone(), tr["iceVolumeCategory"].clone()
    u = vel.u_velocity.clone()
    if check == "finite_area":
        a[5, 1] = float("nan")
    elif check == "finite_volume":
        v[7, 0] = float("inf")
    elif check == "finite_velocity":
        u[3] = float("inf")
    elif check == "area_bounds":
        a[9] = 0.5
    elif check == "volume_nonneg":
        v[11, 2] = -1e-3
    elif check == "velocity_bound":
        u[4] = 6.0
    elif check == "thickness_bound":
        a[13, 0], v[13, 0] = 0.1, 6.0
    tr["iceAreaCategory"], tr["iceVolumeCategory"] = a, v
    return state.replace(tracers=tr, velocity=vel.replace(u_velocity=u))


CHECKS = ("finite_area", "finite_volume", "finite_velocity", "area_bounds",
          "volume_nonneg", "velocity_bound", "thickness_bound")


def test_check_state_matches_reference_and_fails_each_check(diag_states):
    from seaice_tpu.diagnostics import check_state as jcheck
    from seaice_tpu_torch.diagnostics import check_state
    from seaice_tpu_torch.error import fetch_flags
    _, state, _, _, _ = diag_states
    for bad in (None,) + CHECKS:
        st = state if bad is None else _poison(bad, state)
        got = check_state(st)
        assert all(t.dim() == 0 and t.dtype == torch.bool
                   for t in got.values())
        want = jcheck(types.SimpleNamespace(
            tracers={k: jnp.asarray(t.numpy())
                     for k, t in st.tracers.items()},
            velocity=types.SimpleNamespace(
                u_velocity=jnp.asarray(st.velocity.u_velocity.numpy()),
                v_velocity=jnp.asarray(st.velocity.v_velocity.numpy()))))
        flags = fetch_flags(got)
        assert flags == {k: bool(v) for k, v in want.items()}, bad
        failed = {k for k, ok in flags.items() if not ok} - {"ok"}
        # a NaN or an infinity fails its bound as well
        assert failed == set() if bad is None else bad in failed


def test_budgets_monitor_and_regional_statistics_match_reference(
        diag_states):
    from seaice_tpu import diagnostics as J
    from seaice_tpu_torch import diagnostics as T
    model, state, mesh_t, jstate, jmesh_t = diag_states
    ac = model.tensors.area_cell
    jac = jnp.asarray(ac.numpy())
    got, want = T.total_budgets(state, ac), J.total_budgets(jstate, jac)
    assert set(got) == set(want) and "salt_mass" in got
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-14, k

    mon, jmon = T.ConservationMonitor(ac), J.ConservationMonitor(jac)
    mon.reset(state)
    jmon.reset(jstate)
    rng = np.random.default_rng(5)
    fl = {k: rng.standard_normal(model.mesh.n_cells) * 1e-6
          for k in ("fresh", "fsalt", "fhocn")}
    mon.accumulate_fluxes(types.SimpleNamespace(
        **{k: torch.as_tensor(v) for k, v in fl.items()}), 1800.0)
    jmon.accumulate_fluxes(types.SimpleNamespace(
        **{k: jnp.asarray(v) for k, v in fl.items()}), 1800.0)
    for k in jmon.accumulated:
        assert _rel(mon.accumulated[k], jmon.accumulated[k]) <= 1e-13, k
    e, je = mon.errors(state), jmon.errors(jstate)
    assert set(e) == {"mass_closure", "salt_closure"} == set(je)
    for k in je:
        assert _rel(e[k], je[k]) <= 1e-10, k

    region = T.hemisphere_region_mask(model.mesh)
    np.testing.assert_array_equal(region,
                                  J.hemisphere_region_mask(model.mesh))
    assert 0 < region.sum() < len(region)
    got = T.regional_statistics(state, ac, torch.as_tensor(region), 2,
                                mesh_t)
    want = J.regional_statistics(jstate, jac, jnp.asarray(region), 2,
                                 jmesh_t)
    assert set(got) == set(want) and "total_kinetic_energy" in got
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-13, k
    total = float(got["total_ice_area"].sum())
    direct = float((state.tracers["iceAreaCategory"].sum(-1) * ac).sum())
    assert abs(total - direct) <= 1e-12 * direct


def test_phase_timers():
    """The runner's report is a view of the program's recorder from its
    creation on: spans and counters kept there before it are left out."""
    from seaice_tpu_torch.diagnostics import RECORDER, PhaseTimers
    with RECORDER.span("before"):
        pass
    t = PhaseTimers()
    for _ in range(2):
        with t.time("a"):
            sum(range(1000))
    assert t.timed("b", lambda x: x + 1, 1) == 2
    RECORDER.count("host.flag_fetches")
    assert t.counts == {"a": 2, "b": 1}
    assert RECORDER.counts["a"] >= 2 and RECORDER.parents["a"] is None
    assert set(t.totals) == {"a", "b"} and t.totals["a"] > 0.0
    report = t.report()
    assert "a" in report and "before" not in report
    assert "host.flag_fetches          " in report


# -- abort --------------------------------------------------------------------

def test_abort_dump(diag_states, tmp_path):
    """A failed state check dumps the full state, then raises (the
    reference abort-stream protocol, mpas_seaice_error.F:44-119)."""
    from seaice_tpu_torch.error import SeaIceAbort, check_critical_error
    from seaice_tpu_torch.io import load_checkpoint
    _, state, _, _, _ = diag_states
    check_critical_error(state, "0001-01-01_00:00:00", str(tmp_path))
    bad = _poison("finite_velocity", state)
    with pytest.raises(SeaIceAbort, match="finite_velocity") as ei:
        check_critical_error(bad, "0001-01-01_01:00:00", str(tmp_path))
    assert os.path.exists(ei.value.dump_path)
    dumped, meta = load_checkpoint(ei.value.dump_path, device="cpu")
    assert torch.equal(dumped.velocity.u_velocity, bad.velocity.u_velocity)
    assert "finite_velocity" in list(meta["failed_checks"])


def test_column_warning_cell_dump(diag_states, tmp_path):
    """Column warnings with per-cell attribution: the failing cells'
    FULL column state is dumped (the reference warning buffer and
    per-cell abort dump, ice_warnings.F90 /
    mpas_seaice_column.F:1872-1939)."""
    import glob
    from seaice_tpu_torch.error import SeaIceAbort, raise_on_failed_checks
    _, state, _, _, _ = diag_states
    ncat = state.tracers["iceAreaCategory"].shape[1]
    mask = torch.zeros(state.tracers["iceAreaCategory"].shape,
                       dtype=torch.bool)
    mask[5, 0] = True
    mask[17, ncat - 1] = True
    checks = {"ok": torch.tensor(False),
              "column_thermo_unconverged": torch.tensor(False)}
    with pytest.raises(SeaIceAbort):
        raise_on_failed_checks(
            checks, state, "0001-01-01_02:00:00", str(tmp_path),
            cell_masks={"column_thermo_unconverged": mask})
    dumps = glob.glob(str(tmp_path / "cell_failure.*.npz"))
    assert len(dumps) == 1
    with np.load(dumps[0]) as z:
        np.testing.assert_array_equal(sorted(z["cell_index"]), [5, 17])
        assert str(z["reason"]) == "column_thermo_unconverged"
        for name in state.tracers:
            key = "tracer_" + name
            assert key in z.files, key
            np.testing.assert_array_equal(
                z[key][list(z["cell_index"]).index(5)],
                state.tracers[name][5].numpy())
    # a partitioned state: the cell index runs over the blocks' cells
    two = [state, state]
    n = state.tracers["iceAreaCategory"].shape[0]
    from seaice_tpu_torch.error import write_cell_failure_dump
    p = write_cell_failure_dump(str(tmp_path), two, [n + 5], "x", "t")
    with np.load(p) as z:
        np.testing.assert_array_equal(
            z["tracer_iceEnthalpy"][0], state.tracers["iceEnthalpy"][5])


# -- the runner, column off: the whole runner held to JAX ---------------------

def _box_runner(pkg, tmp, n_cells_hint=None):
    """`tests/test_forcing_io.py::test_standalone_runner`'s box run (8 x 8,
    column off, 4 subcycles, one category, dt 3600 s) in `pkg`."""
    import importlib
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    box, core, run = m("testcases.box"), m("forcing.core"), m("run")
    cfg = m("config").box_test_config(elastic_subcycles=4)
    cfg = cfg.replace(run=cfg.run.__class__(dt=3600.0, n_categories=1))
    mesh = box.box_test_mesh(8, 8)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    if pkg == "seaice_tpu":
        model = m("model").SeaIceModel(mesh, cfg, dtype=jnp.float64)
    else:
        model = SeaIceModel(mesh, cfg, dtype=F64, device="cpu")
    state = model.init_state(*box.box_initial_state(mesh, 1))
    nc = mesh.n_cells
    six = core.ForcingSeries(
        times=np.array([0.0, 180 * 86400.0]),
        fields={"airTemperature": np.full((2, nc), 255.0),
                "airSpecificHumidity": np.full((2, nc), 4e-4),
                "uAirVelocity": np.full((2, nc), 4.0),
                "vAirVelocity": np.full((2, nc), 1.0)})
    mon = core.ForcingSeries(
        times=core.monthly_times(),
        fields={"cloudFraction": np.full((12, nc), 0.5),
                "precipitationRate": np.full((12, nc), 1e-6)})
    atmos = core.CoreAtmosForcing(six_hourly=six, monthly=mon,
                                  lon=np.zeros(nc),
                                  lat=np.full(nc, np.deg2rad(75.0)))
    ocean = core.NcarOceanForcing(monthly=core.constant_series(
        nc, seaSurfaceTemperature=-1.7, seaSurfaceSalinity=34.0,
        seaFreezingTemperature=-1.8, oceanMixedLayerDepth=20.0,
        uOceanVelocity=0.0, vOceanVelocity=0.0))
    out = m("io.output").OutputStream(os.path.join(tmp, "out.npz"),
                                      {"nCells": nc})
    return run.StandaloneRunner(
        model, state, atmos_forcing=atmos, ocean_forcing=ocean,
        streams=run.RunStreams(output=out, output_interval=2 * 3600.0,
                               restart_dir=tmp,
                               restart_interval=3 * 3600.0))


def test_runner_column_off_matches_reference(tmp_path):
    from seaice_tpu_torch.convert import flatten_arrays
    from seaice_tpu_torch.io import read_restart_timestamp
    runners = {}
    for pkg in ("seaice_tpu", "seaice_tpu_torch"):
        d = str(tmp_path / pkg)
        os.makedirs(d)
        runners[pkg] = r = _box_runner(pkg, d)
        r.run(4, check_interval=2)
        r.streams.output.flush()
    jr, r = runners["seaice_tpu"], runners["seaice_tpu_torch"]
    got, want = flatten_arrays(r.state), flatten_arrays(jr.state)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= RUNNER_RTOL, k
    assert float(np.abs(got["velocity.u_velocity"]).max()) > 1e-3
    assert r.clock.seconds == jr.clock.seconds == 4 * 3600.0
    assert r.streams.output.timestamps == jr.streams.output.timestamps
    for rec, jrec in zip(r.streams.output.records, jr.streams.output.records):
        for k in jrec:
            assert _rel(rec[k], jrec[k]) <= RUNNER_RTOL, k
    ts = read_restart_timestamp(str(tmp_path / "seaice_tpu_torch"))
    assert ts == read_restart_timestamp(str(tmp_path / "seaice_tpu"))
    assert sorted(os.listdir(tmp_path / "seaice_tpu_torch")) == \
        sorted(os.listdir(tmp_path / "seaice_tpu"))
    assert {"forcing", "timestep", "state_check", "output",
            "restart_write"} <= set(r.timers.totals)
    # the analysis members run in the loop (held to JAX in
    # test_torch_analysis.py)
    from seaice_tpu_torch.analysis import AnalysisDriver, default_members
    members = default_members(compute_interval=3600.0)
    r2 = type(r)(r.model, r.state, analysis=AnalysisDriver(members))
    r2.run(1)
    assert "analysis" in r2.timers.totals
    assert sum(bool(m.results) for m in members) >= 10


# -- the runner's step with first-year ice ----------------------------------

def test_runner_step_with_first_year_ice_matches_reference(files):
    """A StandaloneRunner step with ice age and first-year ice on day 265:
    the runner hands the step the day of year and the latitudes the JAX
    runner hands its step (recorded in both, the JAX runner op by op);
    the port runner's real step equals the model step called with them
    bitwise (that step is held to JAX, day 265 included, by
    test_torch_column_model.py), and it resets the northern first-year
    ice while the south keeps it."""
    import dataclasses
    from seaice_tpu import config as J
    from seaice_tpu.forcing.clock import ModelClock as JClock
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.namelist import RunSetup as JSetup
    from seaice_tpu.namelist import initial_state_from_setup as jinit
    from seaice_tpu.run import StandaloneRunner as JRunner
    from seaice_tpu_torch.forcing.clock import ModelClock
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.run import StandaloneRunner

    def cfg(P):
        c = _full_physics_cfg(P)
        return dataclasses.replace(c, column=dataclasses.replace(
            c.column, use_ice_age=True, use_first_year_ice=True))

    day265 = 264 * 86400.0
    seen = {}

    def recorder(key):
        def step(tensors, state, *a, day_of_year=None, lat=None, **kw):
            seen[key] = (float(np.asarray(day_of_year)),
                         np.asarray(lat, np.float64))
            return state, {}
        return step

    jmesh, jatm, jocn = _forcing("seaice_tpu", files)
    jmodel = JModel(jmesh, cfg(J), dtype=jnp.float64)
    jr = JRunner(jmodel, jinit(jmodel, JSetup(**SETUP)), atmos_forcing=jatm,
                 ocean_forcing=jocn, clock=JClock(seconds=day265))
    jr.step_fn = recorder("jax")
    jr._device_step = jr._build_device_step()
    with jax.disable_jit():
        jr.run(1)

    mesh, atm, ocn = _forcing("seaice_tpu_torch", files)
    model = SeaIceModel(mesh, cfg(C), dtype=F64, device="cpu")
    state = initial_state_from_setup(model, RunSetup(**SETUP))
    tr = dict(state.tracers)
    tr["firstYearIceArea"] = torch.full_like(tr["iceAreaCategory"], 0.6)
    state = state.replace(tracers=tr)
    r = StandaloneRunner(model, state, atmos_forcing=atm, ocean_forcing=ocn,
                         clock=ModelClock(seconds=day265))
    step = r.step_fn
    r.step_fn = recorder("port")
    r._device_step = r._build_device_step()
    r.run(1)
    assert seen["port"][0] == seen["jax"][0] == 265.0
    assert np.array_equal(seen["port"][1], seen["jax"][1])

    r = StandaloneRunner(model, state, atmos_forcing=atm, ocean_forcing=ocn,
                         clock=ModelClock(seconds=day265))
    dyn, atmf, ocnf, coszen = r.next_step_inputs()
    want, _ = step(model.tensors, state, dyn, atmf, ocnf, coszen=coszen,
                   day_of_year=265.0, lat=torch.as_tensor(atm.lat))
    got = r.run(1)
    for k in want.tracers:
        assert torch.equal(got.tracers[k], want.tracers[k]), k
    fy = got.tracers["firstYearIceArea"].numpy()
    a = got.tracers["iceAreaCategory"].numpy()
    lat = np.asarray(atm.lat)[:, None]
    north, south = (lat >= 0) & (a > 1e-3), (lat < 0) & (a > 1e-3)
    assert north.sum() and south.sum()
    assert fy[north].mean() < 0.2 and fy[south].min() >= 0.6 - 1e-12


# -- the runner, full physics from files: a bitwise restart -------------------

def test_file_driven_full_physics_restart_is_bitwise(files, tmp_path):
    """Six steps straight against three, a restart file, and three more
    in a new model and runner: every tracer, u and v bitwise; the restart
    alarms of the two runs fire at the same times."""
    from seaice_tpu_torch.io import load_checkpoint, read_restart_timestamp
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.run import RunStreams, StandaloneRunner
    mesh, atm, ocn = _forcing("seaice_tpu_torch", files)

    def runner(restart_dir, state=None):
        model = SeaIceModel(mesh, _full_physics_cfg(C), dtype=F64,
                            device="cpu")
        if state is None:
            state = initial_state_from_setup(model, RunSetup(**SETUP))
        os.makedirs(restart_dir, exist_ok=True)
        return StandaloneRunner(
            model, state, atmos_forcing=atm, ocean_forcing=ocn,
            streams=RunStreams(restart_dir=restart_dir,
                               restart_interval=3 * 1800.0))

    straight = runner(str(tmp_path / "a"))
    final_a = straight.run(6)
    first = runner(str(tmp_path / "b"))
    first.run(3)
    ts = read_restart_timestamp(str(tmp_path / "b"))
    assert ts == first.clock.timestamp() == "0001-01-01_01:30:00"
    state, meta = load_checkpoint(str(tmp_path / "b" / f"restart.{ts}.npz"),
                                  device="cpu")
    second = runner(str(tmp_path / "b"), state)
    second.restore_clock(meta)
    final_b = second.run(3)
    assert second.clock.seconds == straight.clock.seconds == 6 * 1800.0
    assert float(final_b.time) == float(final_a.time) == 6 * 1800.0
    assert sorted(os.listdir(tmp_path / "a")) == \
        sorted(os.listdir(tmp_path / "b"))
    for k in final_a.tracers:
        assert torch.equal(final_a.tracers[k], final_b.tracers[k]), k
    for k in ("u_velocity", "v_velocity", "stress11", "stress12"):
        assert torch.equal(getattr(final_a.velocity, k),
                           getattr(final_b.velocity, k)), k
    assert float(final_a.velocity.u_velocity.abs().max()) > 1e-4
    # the thermodynamics ran: the column changed the ice
    ice0 = initial_state_from_setup(straight.model, RunSetup(**SETUP))
    assert not torch.equal(final_a.tracers["iceEnthalpy"],
                           ice0.tracers["iceEnthalpy"])
