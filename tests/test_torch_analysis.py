"""The port's analysis members (`seaice_tpu_torch/analysis/`) against the
JAX package's, float64 on the CPU: every member of `default_members` on
the same full-column state of the subdiv-2 sphere (the JAX state carried
across by `convert.py`), to 1e-12 of each result's max; the roster; and
the runners driving the members on their alarms on the column-off box of
`tests/test_analysis.py::test_runner_drives_analysis_members`, against
the JAX runner's member results (its step jitted: the column is off),
and the sharded runner's members against the unsharded runner's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaice_tpu_torch import config as C

torch.set_num_threads(1)
F64 = torch.float64
LIMIT = 1e-12
CLOSURE_LIMIT = 1e-12      # the closure errors are relative errors already


def _column_cfg(C):
    return C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=3, n_ice_layers=4),
        velocity=C.VelocitySolverConfig(elastic_subcycle_number=2),
        advection=C.AdvectionConfig(),
        column=C.ColumnConfig(ktherm=2, shortwave="dEdd", pond_scheme="lvl",
                              use_ice_age=True, use_first_year_ice=True))


def _host(results):
    from seaice_tpu_torch.utils.containers import to_host
    return to_host(results)


def _close(name, got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    if name.startswith("closure_"):
        assert float(np.abs(got - want).max()) <= CLOSURE_LIMIT, name
        return
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= LIMIT, (name, err)


@pytest.fixture(scope="module")
def states():
    """A seeded full-column state of the subdiv-2 sphere in both packages
    and both models."""
    from seaice_tpu import config as JC
    from seaice_tpu.mesh import icosahedral_mesh as jicos
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.utils.pytree import replace
    from seaice_tpu_torch.convert import flatten_arrays, from_reference_arrays
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.model import SeaIceModel
    jm = JModel(jicos(2), _column_cfg(JC), dtype=jnp.float64,
                build_unstructured=False)
    tm = SeaIceModel(icosahedral_mesh(2), _column_cfg(C), dtype=F64,
                     device="cpu")
    nc, nv = jm.mesh.n_cells, jm.mesh.n_vertices
    rng = np.random.default_rng(21)
    js = jm.init_state()
    tr = {}
    for k, v in js.tracers.items():
        a = rng.uniform(0.0, 1.0, v.shape)
        if k in ("iceEnthalpy", "snowEnthalpy"):
            a = -3e8 * a
        if k == "surfaceTemperature":
            a = -20.0 * a
        tr[k] = a
    tr["iceAreaCategory"] *= 0.3 * (rng.random((nc, 1)) > 0.2)
    tr["iceVolumeCategory"] = tr["iceAreaCategory"] * rng.uniform(
        0.3, 3.0, (nc, 3))
    tr["iceAge"] = 86400.0 * 200 * tr["iceAge"]
    vel = replace(js.velocity, u_velocity=jnp.asarray(
        0.2 * rng.standard_normal(nv)), v_velocity=jnp.asarray(
        0.2 * rng.standard_normal(nv)))
    js = replace(js, tracers={k: jnp.asarray(v) for k, v in tr.items()},
                 velocity=vel)
    _, ts, _ = from_reference_arrays(None, flatten_arrays(js), "cpu", F64)
    diags = {k: rng.standard_normal(nc) for k in ("dardg1dt", "dardg2dt",
                                                   "dvirdgdt", "opening")}
    return jm, js, tm, ts, diags


def _members(pkg):
    import importlib
    return importlib.import_module(pkg + ".analysis").default_members(
        compute_interval=3600.0)


def test_default_members_roster_matches_reference():
    names = [m.name for m in _members("seaice_tpu_torch")]
    assert names == [m.name for m in _members("seaice_tpu")]
    assert len(names) == len(set(names)) == 19


def test_every_member_matches_reference(states):
    """Each member's bootstrap, init, two precomputes and compute on the
    same state (and the same ridging diagnostics) in both packages."""
    from seaice_tpu.forcing.clock import ModelClock as JClock
    from seaice_tpu_torch.forcing.clock import ModelClock
    jm, js, tm, ts, diags = states
    jclk, clk = JClock(), ModelClock()
    for c in (jclk, clk):
        c.advance(3600.0)
    seen = set()
    for jmem, mem in zip(_members("seaice_tpu"), _members("seaice_tpu_torch")):
        assert jmem.name == mem.name
        for m, model, state, d in ((jmem, jm, js, {
                k: jnp.asarray(v) for k, v in diags.items()}),
                (mem, tm, ts, {k: torch.as_tensor(v)
                               for k, v in diags.items()})):
            m.bootstrap(model, state)
            m.init(model, state)
            m.last_diags = d
            for _ in range(2):
                m.precompute(model, state, jclk if m is jmem else clk)
        want = jmem.compute(jm, js, jclk)
        got = _host(mem.compute(tm, ts, clk))
        assert set(got) == set(want), (mem.name, set(got) ^ set(want))
        for k in want:
            _close(f"{mem.name}.{k}", got[k], want[k])
        if want:
            seen.add(mem.name)
    # every member computed something on this state
    assert len(seen) == 19, seen


def test_members_compute_on_the_device_of_the_state(states):
    """A member's results stay tensors on the state's device until it
    writes; `write` fetches them (one copy per dtype) into the stream."""
    from seaice_tpu_torch.analysis import AnalysisDriver
    from seaice_tpu_torch.forcing.clock import ModelClock

    class Stream:
        def __init__(self):
            self.records = []

        def write(self, fields, ts):
            self.records.append(fields)

    _, _, tm, ts, _ = states
    members = _members("seaice_tpu_torch")
    stream = Stream()
    drv = AnalysisDriver(members, stream=stream)
    drv.bootstrap(tm, ts)
    drv.init(tm, ts)
    clk = ModelClock()
    clk.advance(3600.0)
    drv.on_timestep(tm, ts, clk)
    hf = drv.result("high_frequency_output")
    assert all(isinstance(v, torch.Tensor) for v in hf.values())
    assert stream.records and all(
        isinstance(v, np.ndarray) or np.isscalar(v)
        for r in stream.records for v in r.values())


def _box_runner(pkg, sharded=False, members=None):
    """The JAX analysis test's runner (column-off 6 x 6 box, 4 subcycles,
    constant forcing at 75 N) with `default_members(2 h)`, or `members`,
    run 4 steps of 600 s."""
    import importlib
    mods = {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "config", "model", "testcases.box", "forcing.core", "run",
        "analysis")}
    box = mods["testcases.box"]
    cfg = mods["config"].box_test_config(elastic_subcycles=4)
    mesh = box.box_test_mesh(6, 6)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    torch_pkg = pkg == "seaice_tpu_torch"
    kw = dict(dtype=F64, device="cpu") if torch_pkg else dict(
        dtype=jnp.float64)
    area, vol, snow = box.box_initial_state(mesh, 1)
    if sharded:
        from seaice_tpu_torch.parallel import ShardedSeaIceModel
        model = ShardedSeaIceModel(mesh, cfg, 4, F64, devices="cpu")
        Runner = mods["run"].ShardedStandaloneRunner
    else:
        model = mods["model"].SeaIceModel(mesh, cfg, **kw)
        Runner = mods["run"].StandaloneRunner
    state = model.init_state(area, vol, snow)
    nc = mesh.n_cells
    fc = mods["forcing.core"]
    six = fc.ForcingSeries(
        times=np.array([0.0, 180 * 86400.0]),
        fields={"airTemperature": np.full((2, nc), 255.0),
                "airSpecificHumidity": np.full((2, nc), 4e-4),
                "uAirVelocity": np.full((2, nc), 4.0),
                "vAirVelocity": np.full((2, nc), 1.0)})
    mon = fc.ForcingSeries(
        times=fc.monthly_times(),
        fields={"cloudFraction": np.full((12, nc), 0.5),
                "precipitationRate": np.full((12, nc), 1e-6)})
    atmos = fc.CoreAtmosForcing(six_hourly=six, monthly=mon,
                                lon=np.zeros(nc),
                                lat=np.full(nc, np.deg2rad(75.0)))
    ocean = fc.NcarOceanForcing(monthly=fc.constant_series(
        nc, seaSurfaceTemperature=-1.7, seaSurfaceSalinity=34.0,
        seaFreezingTemperature=-1.8, oceanMixedLayerDepth=20.0,
        uOceanVelocity=0.0, vOceanVelocity=0.0))
    if members is None:
        members = mods["analysis"].default_members(
            compute_interval=2 * 3600.0)
    drv = mods["analysis"].AnalysisDriver(members)
    runner = Runner(model, state, atmos_forcing=atmos, ocean_forcing=ocean,
                    analysis=drv)
    runner.run(4)
    assert "analysis" in runner.timers.totals
    return members


@pytest.fixture(scope="module")
def reference_runner_members():
    return _box_runner("seaice_tpu")


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["runner", "sharded_runner"])
def test_runner_drives_members_like_the_reference(reference_runner_members,
                                                  sharded):
    """After 4 box steps with members on a 2-hour alarm, every member's
    last results equal the JAX runner's to LIMIT (the sharded runner: its
    members see the gathered whole mesh).  The conservation check's
    budgets are compared; its closure errors are rounding noise."""
    want = reference_runner_members
    got = _box_runner("seaice_tpu_torch", sharded=sharded)
    assert [m.name for m in got] == [m.name for m in want]
    computed = 0
    for g, w in zip(got, want):
        res = _host(g.results)
        assert set(res) == set(w.results), g.name
        for k, v in w.results.items():
            if k == "nCellsProc" and sharded:
                continue        # the member's partition is not given
            _close(f"{g.name}.{k}", res[k], v)
        computed += bool(res)
    assert computed >= 15


@pytest.mark.parametrize("with_precompute, gathers", [(False, 1), (True, 4)],
                         ids=["alarm_only", "precompute_member"])
def test_sharded_runner_gathers_only_when_a_member_runs(monkeypatch,
                                                        with_precompute,
                                                        gathers):
    """The sharded runner gathers the whole state only in a step where a
    member precomputes or computes: members on a 2-hour alarm gather once
    in 4 steps of 600 s (the alarm's first ring); a time-series member,
    which accumulates every step, makes it gather every step."""
    from seaice_tpu_torch.analysis import members as M
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    calls = []
    gather = ShardedSeaIceModel.gather_state

    def counted(self, states):
        calls.append(1)
        return gather(self, states)

    monkeypatch.setattr(ShardedSeaIceModel, "gather_state", counted)
    members = [M.IcePresenceMember(compute_interval=7200.0),
               M.RidgingDiagnosticsMember(compute_interval=7200.0)]
    if with_precompute:
        members.append(M.TimeSeriesStatsMember(compute_interval=7200.0))
    _box_runner("seaice_tpu_torch", sharded=True, members=members)
    # one gather before the loop, for the members' bootstrap and init
    assert len(calls) == 1 + gathers
    assert members[0].results        # the ice-presence member computed
