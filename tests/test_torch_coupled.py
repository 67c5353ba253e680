"""The port's coupled entry points (`seaice_tpu_torch/coupler.py`,
`coupled.py`, `prescribed.py`, `special_boundaries.py`) against the JAX
package's, float64 on the CPU: the import/export surface, the prescribed
ice state and the special boundaries on the same numpy inputs, and the
coupled driver on the JAX test's 8 x 8 box with the column
(`tests/test_coupled.py`): 4 subcycles, a coupling interval of 2 dt, 2
intervals.

The JAX driver runs once, in a module-scoped fixture, under
`jax.disable_jit()`: its jitted sub-loop (one `lax.scan`) rounds the
freshwater and salt fluxes otherwise than its own op-by-op run (7.3e-11
and 3.9e-11 of their max after 2 intervals on this box), while the port
follows the op-by-op run to 1.4e-14.  Op by op it costs 13 to 20 s, jitted
7 s, on one CPU process; a second op-by-op run in prescribed mode cost
48 s, so prescribed mode is held through its pieces: the state each
substep starts from is `prescribe_ice_state`'s (held to JAX below) with
the velocity state zero."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaice_tpu_torch import config as C
from seaice_tpu_torch.model import SeaIceModel
from seaice_tpu_torch.testcases import box

torch.set_num_threads(1)
F64 = torch.float64
LIMIT = 1e-12        # the drivers' exports after 2 intervals
EXACT = 1e-15        # import/export, prescribed ice, special boundaries
N_INTERVALS = 2


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def _box(pkg_config, pkg_box, Model, nx=8, column=True, prescribed=False,
         **kw):
    """The JAX test's box; prescribed: the calc_Tsfc=False column
    (BL99, the atmosphere model's surface fluxes)."""
    cfg = pkg_config.box_test_config(elastic_subcycles=4)
    if column:
        cfg = dataclasses.replace(cfg, column=dataclasses.replace(
            cfg.column, use_column_package=True))
    if prescribed:
        cfg = dataclasses.replace(cfg, column=dataclasses.replace(
            cfg.column, ktherm=1, calc_surface_temperature=False))
    mesh = pkg_box.box_test_mesh(nx, nx)
    mesh.f_vertex = pkg_box.box_coriolis_parameter(mesh)
    model = Model(mesh, cfg, **kw)
    area, vol, snow = pkg_box.box_initial_state(mesh, n_categories=1)
    return model, model.init_state(area, vol, snow), mesh


def _jax_box(**kw):
    from seaice_tpu import config as JC
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.testcases import box as jbox
    return _box(JC, jbox, JModel, dtype=jnp.float64, **kw)


def _port_box(**kw):
    return _box(C, box, SeaIceModel, dtype=F64, device="cpu", **kw)


def _imports(nc):
    """The JAX test's import fields (seed 3)."""
    rng = np.random.default_rng(3)
    return {
        "So_t": np.full(nc, -1.6), "So_s": np.full(nc, 32.0),
        "So_u": 0.02 * rng.standard_normal(nc),
        "So_v": 0.02 * rng.standard_normal(nc),
        "Sa_u": 5.0 + rng.standard_normal(nc),
        "Sa_v": 2.0 + rng.standard_normal(nc),
        "Sa_ptem": np.full(nc, 260.0), "Sa_tbot": np.full(nc, 260.0),
        "Sa_shum": np.full(nc, 8e-4), "Sa_dens": np.full(nc, 1.3),
        "Faxa_lwdn": np.full(nc, 200.0),
        "Faxa_swvdr": np.full(nc, 30.0), "Faxa_swvdf": np.full(nc, 20.0),
        "Faxa_swndr": np.full(nc, 25.0), "Faxa_swndf": np.full(nc, 15.0),
        "Faxa_rain": np.zeros(nc), "Faxa_snow": np.full(nc, 1e-8),
    }


def _sfc_imports(nc, ncat=1):
    """The calc_Tsfc=False imports: per-category surface fluxes of an
    atmosphere model (seed 4), W/m^2."""
    rng = np.random.default_rng(4)
    return {"surfaceHeatFluxCouple": rng.uniform(-30.0, 10.0, (nc, ncat)),
            "surfaceConductiveFluxCouple": rng.uniform(-25.0, 5.0,
                                                       (nc, ncat)),
            "latentHeatFluxCouple": rng.uniform(-6.0, 0.0, (nc, ncat)),
            "sensibleHeatFluxCouple": rng.uniform(-15.0, 5.0, (nc, ncat))}


def _coverage(mesh):
    """The JAX test's prescribed coverage: 0.8 east of the middle."""
    from seaice_tpu_torch.forcing.core import ForcingSeries
    cov = np.where(mesh.x_cell > mesh.x_cell.mean(), 0.8, 0.0)
    return cov, ForcingSeries(times=np.array([0.0]),
                              fields={"iceCoverage": cov[None, :]})


@pytest.fixture(scope="module")
def reference_driver():
    """The JAX CoupledDriver's exports over N_INTERVALS intervals and its
    final tracers, op by op (see the module docstring)."""
    from seaice_tpu.coupled import CoupledDriver as JDriver
    model, state, mesh = _jax_box()
    fields = _imports(mesh.n_cells)
    with jax.disable_jit():
        drv = JDriver(model, state, coupling_interval=2 * model.cfg.run.dt)
        outs = [{k: np.asarray(v) for k, v in drv.advance(fields).items()}
                for _ in range(N_INTERVALS)]
    return outs, {k: np.asarray(v) for k, v in drv.state.tracers.items()}


def _port_driver():
    from seaice_tpu_torch.coupled import CoupledDriver
    model, state, mesh = _port_box()
    drv = CoupledDriver(model, state, coupling_interval=2 * model.cfg.run.dt)
    fields = _imports(mesh.n_cells)
    return drv, [drv.advance(fields) for _ in range(N_INTERVALS)]


def test_coupled_driver_matches_reference(reference_driver):
    """Every export of both intervals to LIMIT of its max, the final
    tracers too, the roster equal."""
    want, want_tr = reference_driver
    drv, got = _port_driver()
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (i, set(g) ^ set(w))
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            assert _rel(g[k], w[k]) <= LIMIT, (i, k, _rel(g[k], w[k]))
    for k, w in want_tr.items():
        assert _rel(drv.state.tracers[k].numpy(), w) <= LIMIT, k
    assert drv.clock.seconds == N_INTERVALS * 2 * drv.model.cfg.run.dt


def test_prescribed_mode_imposes_coverage_and_zeroes_velocity():
    """At the head of every substep the coverage is imposed and every
    field of the velocity state zeroed: the substeps' inputs of two
    intervals, recorded; after them the data-ice pattern dominates the
    state (the JAX test's checks)."""
    from seaice_tpu_torch.coupled import CoupledDriver
    model, state, mesh = _port_box()
    cov, series = _coverage(mesh)
    drv = CoupledDriver(model, state, coupling_interval=2 * model.cfg.run.dt,
                        prescribed_coverage=series)
    seen, step = [], drv.step_fn

    def recorder(tensors, st, *a, **kw):
        seen.append(st)
        return step(tensors, st, *a, **kw)
    drv.step_fn = recorder
    out = [drv.advance(_imports(mesh.n_cells)) for _ in range(N_INTERVALS)]
    assert len(seen) == 2 * N_INTERVALS
    for st in seen:
        vel = st.velocity
        for f in dataclasses.fields(vel):
            assert not bool(getattr(vel, f.name).any()), f.name
        aice = st.tracers["iceAreaCategory"].sum(-1).numpy()
        np.testing.assert_array_equal(aice, np.where(cov >= 1e-4, cov, 0.0))
        h = st.tracers["iceVolumeCategory"].sum(-1).numpy()
        np.testing.assert_array_equal(h, 2.0 * aice)
    aice = drv.state.tracers["iceAreaCategory"].sum(-1).numpy()
    assert abs(aice[cov > 0].mean() - 0.8) < 0.05
    assert aice[cov == 0].max() < 0.05
    assert all(np.isfinite(v).all() for o in out for v in o.values())
    assert out[-1]["Si_ifrac"][cov > 0].mean() > 0.5


def test_roster_divisibility_and_prescribed_needs_the_column():
    from seaice_tpu.coupler import EXPORT_FIELDS as JE, IMPORT_FIELDS as JI
    from seaice_tpu_torch.coupled import CoupledDriver, ShardedCoupledDriver
    model, state, mesh = _port_box(column=False)
    dt = model.cfg.run.dt
    with pytest.raises(ValueError, match="integer multiple"):
        CoupledDriver(model, state, coupling_interval=2.5 * dt)
    drv = CoupledDriver(model, state, coupling_interval=4 * dt)
    assert drv.advertise() == (JI, JE) and drv.n_substeps == 4
    with pytest.raises(ValueError, match="column package"):
        CoupledDriver(model, state, coupling_interval=4 * dt,
                      prescribed_coverage=_coverage(mesh)[1])
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    sm = ShardedSeaIceModel(mesh, model.cfg, 2, F64, devices="cpu")
    with pytest.raises(ValueError, match="integer multiple"):
        ShardedCoupledDriver(sm, sm.init_state(), coupling_interval=0.5 * dt)


def test_sharded_coupled_driver_matches_single_device():
    """ShardedCoupledDriver in 4 blocks against the port's CoupledDriver
    on the same box (no lat/lon: the solar zenith plays no part, the
    ccsm3 shortwave does not read it), both intervals, every export."""
    from seaice_tpu_torch.coupled import ShardedCoupledDriver
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    drv, want = _port_driver()
    model, _, mesh = _port_box()
    sm = ShardedSeaIceModel(mesh, model.cfg, 4, F64, devices="cpu")
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    sdrv = ShardedCoupledDriver(sm, sm.init_state(area, vol, snow),
                                coupling_interval=2 * model.cfg.run.dt)
    fields = _imports(mesh.n_cells)
    for i, w in enumerate(want):
        g = sdrv.advance(fields)
        # the sharded driver exports no ocean stress (as in JAX)
        assert set(g) == set(w) - {"Fioi_taux", "Fioi_tauy"}
        for k in g:
            assert _rel(g[k], w[k]) <= LIMIT, (i, k, _rel(g[k], w[k]))
    assert sdrv.clock.seconds == drv.clock.seconds


# -- the import/export surface, prescribed ice, special boundaries ----------

def _column_state(nc, ncat):
    """A seeded full column state [nCells, nCat, ...] as numpy."""
    rng = np.random.default_rng(11)
    area = rng.uniform(0.0, 0.3, (nc, ncat)) * (rng.random((nc, 1)) > 0.2)
    return {"iceAreaCategory": area,
            "iceVolumeCategory": area * rng.uniform(0.2, 3.0, (nc, ncat)),
            "snowVolumeCategory": area * rng.uniform(0.0, 0.3, (nc, ncat)),
            "surfaceTemperature": rng.uniform(-20.0, 0.0, (nc, ncat)),
            "iceEnthalpy": -rng.uniform(1e8, 3e8, (nc, ncat, 4)) *
            (rng.random((nc, ncat, 1)) > 0.3),
            "iceSalinity": rng.uniform(1.0, 10.0, (nc, ncat, 4)),
            "snowEnthalpy": -rng.uniform(1e8, 1.2e8, (nc, ncat, 1)) *
            (rng.random((nc, ncat, 1)) > 0.3)}


def test_import_and_export_match_reference():
    from seaice_tpu import coupler as JCp
    from seaice_tpu.utils.pytree import replace as jreplace
    from seaice_tpu_torch import coupler as TCp
    jm, js, mesh = _jax_box(column=False)
    tm, ts, _ = _port_box(column=False)
    nc, nv = mesh.n_cells, mesh.n_vertices
    fields = _imports(nc)
    fields["So_t"] = fields["So_t"] + 273.15
    fields["Sa_z"] = np.full(nc, 12.0)
    for kw in (dict(sst_in_kelvin=True, tfrz_option="linear_salt"),
               dict(tfrz_option="minus1p8")):
        want = JCp.import_state(fields, 1800.0, dtype=jnp.float64, **kw)
        got = TCp.import_state(fields, 1800.0, dtype=F64, device="cpu", **kw)
        for w, g in zip(want, got):
            for f in dataclasses.fields(w):
                assert _rel(getattr(g, f.name).numpy(),
                            getattr(w, f.name)) <= EXACT, f.name
    tr = _column_state(nc, 1)
    rng = np.random.default_rng(5)
    flux_names = ("flat", "fsens", "flwout", "evap", "fhocn", "fswthru",
                  "fresh", "fsalt", "albedo_vis_dir", "albedo_vis_dif",
                  "albedo_ir_dir", "albedo_ir_dif")
    fl = {k: rng.standard_normal(nc) for k in flux_names}
    stress = {"ocean_stress_u": rng.standard_normal(nv),
              "ocean_stress_v": rng.standard_normal(nv)}
    jst = jreplace(js, tracers={k: jnp.asarray(v) for k, v in tr.items()})
    tst = ts.replace(tracers={k: torch.as_tensor(v) for k, v in tr.items()})
    for mesh_t in (True, False):
        want = JCp.export_state(
            jst, _Fluxes({k: jnp.asarray(v) for k, v in fl.items()}),
            {k: jnp.asarray(v) for k, v in stress.items()},
            mesh_tensors=jm.tensors.mesh if mesh_t else None)
        got = TCp.export_state(
            tst, _Fluxes({k: torch.as_tensor(v) for k, v in fl.items()}),
            {k: torch.as_tensor(v) for k, v in stress.items()},
            mesh_tensors=tm.tensors.mesh if mesh_t else None)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            assert _rel(got[k], want[k]) <= EXACT, k


class _Fluxes:
    """The ColumnFluxes fields the export reads."""

    def __init__(self, d):
        self.__dict__.update(d)


def test_sfc_flux_import_converts_and_the_step_refuses_it():
    from seaice_tpu import coupler as JCp
    from seaice_tpu_torch import coupler as TCp
    rng = np.random.default_rng(2)
    f = {k: rng.standard_normal((10, 3)) for k in TCp.SFC_FLUX_IMPORT_FIELDS}
    want = JCp.import_sfc_fluxes(f, jnp.float64)
    got = TCp.import_sfc_fluxes(f, F64, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    with pytest.raises(KeyError):
        TCp.import_sfc_fluxes({}, F64, device="cpu")
    # a calc_Tsfc=False model's step refuses to run without them
    model, state, mesh = _port_box(prescribed=True)
    from seaice_tpu_torch.coupler import import_state
    dyn, atm, ocn = import_state(_imports(mesh.n_cells), 1800.0, F64,
                                 device="cpu")
    with pytest.raises(ValueError, match="sfc_fluxes"):
        model.make_step()(model.tensors, state, dyn, atm, ocn)


def test_coupled_driver_with_prescribed_fluxes_matches_reference():
    """One CoupledDriver interval with calc_Tsfc=False (BL99) and the
    per-category flux imports in both packages (the JAX driver op by
    op): every export and every tracer to LIMIT; the fluxes moved the
    answer off the calc_Tsfc=True driver's."""
    from seaice_tpu.coupled import CoupledDriver as JDriver
    from seaice_tpu_torch.coupled import CoupledDriver
    jm, js, mesh = _jax_box(prescribed=True)
    fields = dict(_imports(mesh.n_cells), **_sfc_imports(mesh.n_cells))
    with jax.disable_jit():
        jdrv = JDriver(jm, js, coupling_interval=2 * jm.cfg.run.dt)
        want = {k: np.asarray(v) for k, v in jdrv.advance(fields).items()}
    model, state, _ = _port_box(prescribed=True)
    drv = CoupledDriver(model, state, coupling_interval=2 * model.cfg.run.dt)
    got = drv.advance(fields)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= LIMIT, (k, _rel(got[k], want[k]))
    for k, v in jdrv.state.tracers.items():
        assert _rel(drv.state.tracers[k].numpy(), v) <= LIMIT, k
    calc = CoupledDriver(*_port_box()[:2],
                         coupling_interval=2 * model.cfg.run.dt)
    assert _rel(calc.advance(fields)["Si_t"], got["Si_t"]) > 1e-3


def test_sharded_coupled_driver_passes_prescribed_fluxes():
    """ShardedCoupledDriver with calc_Tsfc=False scatters the flux
    imports to its 2 blocks: the exports equal the single-device
    driver's to LIMIT."""
    from seaice_tpu_torch.coupled import CoupledDriver, ShardedCoupledDriver
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    model, state, mesh = _port_box(prescribed=True)
    fields = dict(_imports(mesh.n_cells), **_sfc_imports(mesh.n_cells))
    dt2 = 2 * model.cfg.run.dt
    want = CoupledDriver(model, state, coupling_interval=dt2).advance(fields)
    sm = ShardedSeaIceModel(mesh, model.cfg, 2, F64, devices="cpu")
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    got = ShardedCoupledDriver(sm, sm.init_state(area, vol, snow),
                               coupling_interval=dt2).advance(fields)
    for k in got:
        assert _rel(got[k], want[k]) <= LIMIT, (k, _rel(got[k], want[k]))


def _bgc_options(name):
    from seaice_tpu_torch.column.zbgc import ZbgcParams
    if name == "zsal_skl":
        return dict(ktherm=1, solve_zsalinity=True,
                    use_skeletal_biochemistry=True)
    return dict(use_biogeochemistry=True, shortwave="dEdd",
                zbgc_params=ZbgcParams(
                    n_algae=3, use_C=True, use_DON=True, use_Fe=True,
                    use_DMS=True, use_PON=True, use_hum=True,
                    use_zaero=True, n_zaero=3))


@pytest.mark.parametrize("name", ["zsal_skl", "zbgc_zaero"])
def test_coupled_drivers_run_the_bgc_options(name):
    """The brine height, z-salinity and biogeochemistry options through
    both coupled drivers (the box, one interval of 2 substeps): the
    exports finite, the options' tracers moved; the 2-block driver's
    exports equal the single-device driver's to LIMIT."""
    from seaice_tpu_torch.coupled import CoupledDriver, ShardedCoupledDriver
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    model, state, mesh = _port_box()
    model = model.with_column(**_bgc_options(name))
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    state = model.init_state(area, vol, snow)
    own = [k for k in ("brineHeight", "verticalSalinity", "sklBgc",
                       "bioTracers") if k in state.tracers]
    fields = _imports(mesh.n_cells)
    dt2 = 2 * model.cfg.run.dt
    drv = CoupledDriver(model, state, coupling_interval=dt2)
    want = drv.advance(fields)
    assert all(np.isfinite(v).all() for v in want.values())
    for k in own:
        assert not torch.equal(drv.state.tracers[k], state.tracers[k]), k
    sm = ShardedSeaIceModel(mesh, model.cfg, 2, F64, devices="cpu")
    got = ShardedCoupledDriver(sm, sm.init_state(area, vol, snow),
                               coupling_interval=dt2).advance(fields)
    for k in got:
        assert _rel(got[k], want[k]) <= LIMIT, (k, _rel(got[k], want[k]))


def test_prescribe_ice_state_matches_reference():
    from seaice_tpu.prescribed import prescribe_ice_state as jpres
    from seaice_tpu_torch.column.itd import category_boundaries
    from seaice_tpu_torch.prescribed import prescribe_ice_state
    mesh = box.box_test_mesh(6, 6)
    nc, ncat = mesh.n_cells, 5
    tr = _column_state(nc, ncat)
    rng = np.random.default_rng(9)
    cov = rng.uniform(-0.1, 1.1, nc) * (rng.random(nc) > 0.2)
    cov[:3] = (0.0, 5e-5, 1e-4)
    lat = rng.uniform(-1.2, 1.2, nc)
    tf = rng.uniform(-1.9, -1.7, nc)
    hin_max = category_boundaries(ncat, 0, 1)
    want = jpres({k: jnp.asarray(v) for k, v in tr.items()},
                 jnp.asarray(cov), jnp.asarray(lat), jnp.asarray(tf), hin_max)
    got = prescribe_ice_state({k: torch.as_tensor(v) for k, v in tr.items()},
                              torch.as_tensor(cov), torch.as_tensor(lat),
                              torch.as_tensor(tf), hin_max)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == F64
        assert _rel(got[k].numpy(), want[k]) <= EXACT, k
    a = got["iceAreaCategory"].numpy()
    assert (np.count_nonzero(a, axis=-1) <= 1).all()
    assert a[:, 2][lat >= 0].max() > 0 and a[:, 1][lat < 0].max() > 0


def test_special_boundaries_match_reference():
    from seaice_tpu import special_boundaries as JSB
    from seaice_tpu_torch import special_boundaries as TSB
    rng = np.random.default_rng(4)
    nv, nc = 30, 20
    u, v = rng.standard_normal(nv), rng.standard_normal(nv)
    vm = (rng.random(nv) > 0.7).astype(float)
    cm = (rng.random(nc) > 0.6).astype(float)
    tr = {"iceAreaCategory": rng.random((nc, 2)),
          "iceEnthalpy": rng.random((nc, 2, 3)),
          "snowVolumeCategory": rng.random((nc, 2))}
    targets = {"iceAreaCategory": rng.random((nc, 2)),
               "iceEnthalpy": rng.random((nc, 2, 3)), "absent": np.ones(nc)}
    vals = (rng.standard_normal(nv), rng.standard_normal(nv))

    def run(mod, arr, **kw):
        sb = mod.SpecialBoundaries(
            vertex_mask=arr(vm), u_value=arr(vals[0]), v_value=arr(vals[1]),
            cell_mask=arr(cm), tracer_values={k: arr(t)
                                              for k, t in targets.items()})
        out = mod.apply_velocity_boundaries(sb, arr(u), arr(v))
        out2 = mod.apply_tracer_boundaries(sb, {k: arr(t)
                                                for k, t in tr.items()})
        none = mod.no_special_boundaries(nv, nc, **kw)
        out3 = mod.apply_velocity_boundaries(none, arr(u), arr(v))
        return [np.asarray(x) for x in (*out, *out3)], \
            {k: np.asarray(x) for k, x in out2.items()}

    jv, jt = run(JSB, jnp.asarray)
    tv, tt = run(TSB, torch.as_tensor, device="cpu")
    for a, b in zip(tv, jv):
        assert _rel(a, b) <= EXACT
    assert set(tt) == set(jt)
    for k in jt:
        assert _rel(tt[k], jt[k]) <= EXACT, k
    assert np.array_equal(tv[2], u)
