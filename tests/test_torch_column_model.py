"""The full-physics step of the port (`SeaIceModel` with the column
package) on the CPU in float64: ports of the JAX package's ridging-box
tests (`tests/test_ridging_cases.py`) and of its pinned sphere
regression (`tests/test_regression.py::test_sphere_full_physics_regression`,
against the same `tests/data_regression_sphere.npz`), the ridging box and
one full-physics sphere step held against `seaice_tpu`, and the dtype of a
float32 step."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from seaice_tpu_torch import config as C
from seaice_tpu_torch.dynamics.evp import DynamicsForcing
from seaice_tpu_torch.mesh import icosahedral_mesh, planar_quad_mesh
from seaice_tpu_torch.mesh.panels import panel_reorder
from seaice_tpu_torch.model import SeaIceModel
from seaice_tpu_torch.parallel.sharded import full_physics_inputs

torch.set_num_threads(1)
F64 = torch.float64
HERE = os.path.dirname(os.path.abspath(__file__))


# -- the ridging box (reference testcases ridging_1D / ridging_island) ----

def _ridging_cfg(C, ncat=5, subcycles=60, ridging=True):
    return C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=ncat),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=subcycles, rotate_cartesian_grid=False,
            include_metric_terms=False, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(
            advection_type=C.AdvectionType.INCREMENTAL_REMAP),
        column=C.ColumnConfig(
            use_column_package=True, use_shortwave=False,
            use_vertical_thermodynamics=False,
            use_itd_thermodynamics=False, use_ridging=ridging,
            use_ice_age=False, use_first_year_ice=False, kstrength=1))


def _wind_forcing(nc, u_wind, land=None):
    z = np.zeros(nc)
    return dict(u_air_velocity=np.full(nc, u_wind), v_air_velocity=z,
                air_density=np.full(nc, 1.3), u_ocean_velocity=z,
                v_ocean_velocity=z, sea_surface_tilt_u=z,
                sea_surface_tilt_v=z,
                land_ice_mask=z if land is None else land)


def _port_forcing(f):
    return DynamicsForcing(**{k: torch.as_tensor(np.asarray(v, float))
                              for k, v in f.items()})


def _initial_ice(nc, ncat, aice=0.95, hi=0.5, land=None):
    # all ice starts in category 1 (the reference ridging ICs start thin
    # so redistribution into category 2+ is observable)
    area = np.zeros((nc, ncat))
    vol = np.zeros((nc, ncat))
    area[:, 0] = aice if land is None else np.where(land > 0, 0.0, aice)
    vol[:, 0] = area[:, 0] * hi
    return area, vol, np.zeros_like(area)


def _run(model, state, forcing, n_steps, **make_step):
    step = model.make_step(**make_step)
    for _ in range(n_steps):
        state, _ = step(model.tensors, state, forcing)
    return state


def _volume(model, state):
    return float((state.tracers["iceVolumeCategory"].sum(-1) *
                  model.tensors.area_cell).sum())


def test_ridging_1d_wall():
    """Wind blows the pack against the +x wall (reference ridging_1D,
    shrunk): area is consumed into ridged categories at the wall, total
    volume is conserved, aice stays <= 1, and the thickness profile
    steepens toward the wall."""
    mesh = planar_quad_mesh(24, 5, 20e3, periodic=False)
    model = SeaIceModel(mesh, _ridging_cfg(C), dtype=F64, device="cpu")
    state = model.init_state(*_initial_ice(mesh.n_cells, 5))
    forcing = _port_forcing(_wind_forcing(mesh.n_cells, 20.0))
    vol0 = _volume(model, state)
    state = _run(model, state, forcing, 96)       # 2 days (dt=1800)
    tr = state.tracers
    aice = tr["iceAreaCategory"].sum(-1).numpy()
    vice = tr["iceVolumeCategory"].sum(-1).numpy()

    # volume conservation (transport + ridging are conservative)
    np.testing.assert_allclose(_volume(model, state), vol0, rtol=1e-9)
    # ridging keeps concentration physical under convergence
    assert aice.max() <= 1.0 + 1e-9
    # the pack piles up downwind
    x = np.asarray(mesh.x_cell)
    h = np.where(aice > 0.01, vice / np.maximum(aice, 1e-12), 0.0)
    h_down = h[x > 0.75 * x.max()].mean()
    h_up = h[x < 0.25 * x.max()].mean()
    assert h_down > h_up * 1.08, (h_down, h_up)
    # ridged ice reaches thicker categories at the wall
    cat_area = tr["iceAreaCategory"].numpy()
    wall = x > 0.9 * x.max()
    assert cat_area[wall, 1:].sum() > 0.0
    # ice slows toward the wall (strength resists convergence)
    u = state.velocity.u_velocity.numpy()
    xv = np.asarray(mesh.x_vertex)
    u_wall = np.abs(u[xv > 0.9 * xv.max()]).mean()
    u_free = np.abs(u[(xv > 0.3 * xv.max()) &
                      (xv < 0.5 * xv.max())]).mean()
    assert u_wall < u_free


def test_ridging_1d_no_ridging_violates_bounds():
    """Control: with ridging disabled the same convergent flow drives
    aice past 1 — the redistribution is what enforces the bound."""
    mesh = planar_quad_mesh(24, 5, 20e3, periodic=False)
    model = SeaIceModel(mesh, _ridging_cfg(C, ridging=False), dtype=F64,
                        device="cpu")
    state = model.init_state(*_initial_ice(mesh.n_cells, 5))
    forcing = _port_forcing(_wind_forcing(mesh.n_cells, 20.0))
    state = _run(model, state, forcing, 96)
    assert state.tracers["iceAreaCategory"].sum(-1).max() > 1.0 + 1e-6


def test_ridging_island():
    """Flow past a land island (reference ridging_island): ice ridges on
    the upstream side and thins in the wake; volume is conserved and
    aice stays bounded."""
    mesh = planar_quad_mesh(24, 11, 20e3, periodic=False)
    x = np.asarray(mesh.x_cell)
    y = np.asarray(mesh.y_cell)
    land = (((x > 0.5 * x.max()) & (x < 0.65 * x.max())) &
            ((y > 0.35 * y.max()) & (y < 0.65 * y.max()))).astype(float)
    model = SeaIceModel(mesh, _ridging_cfg(C), dtype=F64, device="cpu")
    state = model.init_state(*_initial_ice(mesh.n_cells, 5, land=land))
    forcing = _port_forcing(_wind_forcing(mesh.n_cells, 20.0, land))
    vol0 = _volume(model, state)
    state = _run(model, state, forcing, 24)
    tr = state.tracers
    aice = tr["iceAreaCategory"].sum(-1).numpy()
    vice = tr["iceVolumeCategory"].sum(-1).numpy()
    np.testing.assert_allclose(_volume(model, state), vol0, rtol=1e-9)
    assert aice.max() <= 1.0 + 1e-9

    ocean = land == 0
    mid = (y > 0.35 * y.max()) & (y < 0.65 * y.max()) & ocean
    h = np.where(aice > 0.01, vice / np.maximum(aice, 1e-12), 0.0)
    upstream = mid & (x > 0.35 * x.max()) & (x < 0.5 * x.max())
    wake = mid & (x > 0.65 * x.max()) & (x < 0.8 * x.max())
    assert h[upstream].mean() > h[wake].mean(), \
        (h[upstream].mean(), h[wake].mean())


def _fields(state):
    """{"u", "v", tracer: numpy} of a JAX or a port State."""
    out = {"u": np.asarray(state.velocity.u_velocity),
           "v": np.asarray(state.velocity.v_velocity)}
    for k, v in state.tracers.items():
        out[k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


# a tracer whose reference max stays below this is rounding noise (the
# winter step's melt ponds hold 7e-10 of meltwater made of f64 rounding
# in the top-melt balance): the port's must stay below it too
NOISE = 1e-8


def _compare_states(ref, got, limit):
    """Every tracer to `limit` of its own max |value| (below NOISE: the
    port's max below NOISE too), u and v to `limit` of the largest speed
    component (v is the small cross-wind component of the ridging box:
    its own max would magnify rounding)."""
    assert set(ref) == set(got)
    speed = max(np.abs(ref["u"]).max(), np.abs(ref["v"]).max())
    for k in ref:
        _close(k, got[k], ref[k], limit, speed if k in ("u", "v") else None)


def _close(name, got, ref, limit, scale=None):
    """max|got - ref| / scale <= limit, scale max|ref| by default; a
    reference below NOISE asks the port's to be below it too."""
    scale = float(np.abs(ref).max()) if scale is None else scale
    if scale < NOISE:
        assert float(np.abs(got).max()) < NOISE, name
        return
    err = float(np.abs(got - ref).max()) / scale
    assert err <= limit, (name, err)


# the ridging box against seaice_tpu over two steps
RIDGING_BOX_LIMIT = 1e-10


def test_ridging_box_two_steps_match_reference():
    """Two steps of the ridging-box configuration (10 x 10 mesh, 10
    subcycles, 3 categories, aice 0.8 under a 10 m/s wind: it ridges
    while the pack stays soft enough that the EVP loop does not magnify
    rounding) in both packages: every tracer and u, v to
    RIDGING_BOX_LIMIT."""
    import jax.numpy as jnp
    from seaice_tpu import config as JC
    from seaice_tpu.dynamics.evp import DynamicsForcing as JForcing
    from seaice_tpu.mesh import planar_quad_mesh as jquad
    from seaice_tpu.model import SeaIceModel as JModel

    nx, ncat = 10, 3
    mesh_j = jquad(nx, nx, 20e3, periodic=False)
    mesh_t = planar_quad_mesh(nx, nx, 20e3, periodic=False)
    ice = _initial_ice(mesh_t.n_cells, ncat, aice=0.8)
    f = _wind_forcing(mesh_t.n_cells, 10.0)

    jm = JModel(mesh_j, _ridging_cfg(JC, ncat, subcycles=10),
                dtype=jnp.float64)
    js = _run(jm, jm.init_state(*ice),
              JForcing(**{k: jnp.asarray(v, jnp.float64)
                          for k, v in f.items()}), 2)
    tm = SeaIceModel(mesh_t, _ridging_cfg(C, ncat, subcycles=10),
                     dtype=F64, device="cpu")
    ts = _run(tm, tm.init_state(*ice), _port_forcing(f), 2)
    ref, got = _fields(js), _fields(ts)
    assert ref["iceAreaCategory"][:, 1:].max() > 1e-5    # it did ridge
    _compare_states(ref, got, RIDGING_BOX_LIMIT)


# -- the full-physics sphere ----------------------------------------------

def _sphere_cfg(C, n_sub=8, n_cat=3, n_ice=4):
    return C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=n_cat, n_ice_layers=n_ice),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=n_sub, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(),
        column=C.ColumnConfig(ktherm=2, shortwave="dEdd",
                              pond_scheme="lvl", kstrength=1))


def _sphere_forcing(nc):
    """The regression test's dynamics forcing, as numpy (seed 7)."""
    rng = np.random.default_rng(7)
    return dict(
        u_air_velocity=5 * rng.standard_normal(nc),
        v_air_velocity=2 * rng.standard_normal(nc),
        air_density=np.full(nc, 1.3),
        u_ocean_velocity=0.05 * rng.standard_normal(nc),
        v_ocean_velocity=0.05 * rng.standard_normal(nc),
        sea_surface_tilt_u=np.zeros(nc), sea_surface_tilt_v=np.zeros(nc),
        land_ice_mask=np.zeros(nc))


def _port_sphere(subdiv, cfg, dtype=F64):
    mesh, _ = panel_reorder(icosahedral_mesh(subdiv), subdiv)
    model = SeaIceModel(mesh, cfg, dtype=dtype, device="cpu")
    area, vol, snow, extra, atm, ocn, coszen = full_physics_inputs(
        mesh, cfg, dtype, "cpu")
    state = model.init_state(area, vol, snow)
    state = state.replace(tracers=dict(state.tracers, **extra))
    forcing = DynamicsForcing(**{
        k: torch.as_tensor(v).to(dtype)
        for k, v in _sphere_forcing(mesh.n_cells).items()})
    return model, state, forcing, atm, ocn, coszen


def test_sphere_full_physics_regression():
    """The port's three full-physics steps on the panel sphere (mushy +
    dEdd + lvl ponds + Rothrock + IR + metric terms + ridging), f64,
    against the JAX package's pinned trajectory: rtol 1e-10, atol 1e-12
    in u, v, area, volume and Tsfc, the reference test's limits."""
    model, state, forcing, atm, ocn, coszen = _port_sphere(
        3, _sphere_cfg(C))
    step = model.make_step()
    for _ in range(3):
        state, diags = step(model.tensors, state, forcing, atm, ocn,
                            coszen=coszen)
    ref = np.load(os.path.join(HERE, "data_regression_sphere.npz"))
    got = _fields(state)
    for name, key in (("u", "u"), ("v", "v"), ("iceAreaCategory", "area"),
                      ("iceVolumeCategory", "vol"),
                      ("surfaceTemperature", "tsfc")):
        np.testing.assert_allclose(got[name], ref[key], rtol=1e-10,
                                   atol=1e-12, err_msg=name)
    assert not bool(diags["column_fluxes"].warnings[
        "thermo_unconverged"].any())


# one full-physics step of the port against one of seaice_tpu
STEP_LIMIT = 1e-10
# a melting variant of the atmosphere: real melt ponds form in one step
MELT = dict(air_temperature=275.0, longwave_down=320.0, sw_vis_dir=120.0,
            sw_vis_dif=60.0, sw_ir_dir=100.0, sw_ir_dif=50.0,
            rain_rate=1e-5, specific_humidity=4e-3)


SUBDIV = 2


@pytest.fixture(scope="module")
def reference_steps():
    """One full-physics step of `seaice_tpu` on the subdiv-2 panel sphere
    from its `full_physics_inputs`, under the winter atmosphere
    (melt=False) and under MELT: {melt: (tracer and u, v fields, column
    fluxes as numpy)}.  The reference runs op by op: measured on one CPU
    process with an empty compilation cache, this test took 58 s op by
    op against 91 s with the step jitted (the compilation of the whole
    step outweighs the op-by-op dispatch of two steps)."""
    import jax.numpy as jnp
    from seaice_tpu import config as JC
    from seaice_tpu.dynamics.evp import DynamicsForcing as JForcing
    from seaice_tpu.mesh import icosahedral_mesh as jicos
    from seaice_tpu.mesh.panels import panel_reorder as jreorder
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.parallel.sharded import full_physics_inputs as jinputs
    from seaice_tpu.utils.pytree import replace

    mesh_j, _ = jreorder(jicos(SUBDIV), SUBDIV)
    jm = JModel(mesh_j, _sphere_cfg(JC), dtype=jnp.float64)
    area, vol, snow, extra, atm, ocn, coszen = jinputs(
        mesh_j, jm.cfg, jnp.float64)
    jf = JForcing(**{k: jnp.asarray(v) for k, v in
                     _sphere_forcing(mesh_j.n_cells).items()})
    jstep = jm.make_step(jit=False)
    ocn_j = type(ocn)(**{f.name: jnp.asarray(getattr(ocn, f.name))
                         for f in dataclasses.fields(ocn)})
    nc = mesh_j.n_cells
    out = {}
    for melt in (False, True):
        atm_j = type(atm)(**{f.name: jnp.asarray(
            np.full(nc, MELT[f.name]) if melt and f.name in MELT
            else getattr(atm, f.name)) for f in dataclasses.fields(atm)})
        js = jm.init_state(area, vol, snow)
        js = replace(js, tracers=dict(js.tracers, **extra))
        js, jd = jstep(jm.tensors, js, jf, atm_j, ocn_j,
                       coszen=jnp.asarray(coszen))
        fl = jd["column_fluxes"]
        fluxes = {f.name: np.asarray(getattr(fl, f.name))
                  for f in dataclasses.fields(fl)
                  if getattr(fl, f.name) is not None
                  and f.name != "warnings"}
        fluxes["thermo_unconverged"] = np.asarray(
            fl.warnings["thermo_unconverged"])
        out[melt] = (_fields(js), fluxes)
    return out


@pytest.mark.parametrize("melt", [False, True], ids=["winter", "melt"])
def test_full_physics_step_matches_reference(reference_steps, melt):
    """One full-physics step of both packages on the subdiv-2 panel
    sphere (the regression test's configuration) from
    `full_physics_inputs`, under its winter atmosphere and under a
    melting one (MELT: ponds form): every tracer and u, v to STEP_LIMIT,
    the column fluxes likewise and the unconverged-column masks equal."""
    model, state0, forcing, atm, ocn, coszen = _port_sphere(
        SUBDIV, _sphere_cfg(C))
    nc = model.mesh.n_cells
    if melt:
        atm = atm.replace(**{k: torch.full((nc,), v, dtype=F64)
                             for k, v in MELT.items()})
    state, diags = model.make_step()(model.tensors, state0, forcing, atm,
                                     ocn, coszen=coszen)
    ref, ref_fluxes = reference_steps[melt]
    _compare_states(ref, _fields(state), STEP_LIMIT)
    if melt:
        assert ref["pondArea"].max() > 1e-3      # ponds did form
    fl = diags["column_fluxes"]
    for name, a in ref_fluxes.items():
        if name != "thermo_unconverged":
            _close(name, getattr(fl, name).numpy(), a, STEP_LIMIT)
    assert np.array_equal(ref_fluxes["thermo_unconverged"],
                          fl.warnings["thermo_unconverged"].numpy())


# ice age and first-year ice: the day of year of each case (265 resets
# the northern first-year ice), and the limit of the step against
# seaice_tpu with them
AGE_DAYS = (100.0, 265.0)
AGE_STEP_LIMIT = 1e-12


def _age_cfg(C):
    cfg = _sphere_cfg(C)
    return dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, use_ice_age=True, use_first_year_ice=True))


def _age_tracers(nc, ncat):
    """Uniform initial ice age (s) and first-year area fraction (numpy):
    transport and ridging keep a uniform tracer uniform, so where no new
    ice forms the age after the step is the age before plus dt."""
    return {"iceAge": np.full((nc, ncat), 1.0e7),
            "firstYearIceArea": np.full((nc, ncat), 0.7)}


@pytest.fixture(scope="module")
def reference_age_steps():
    """One full-physics step of `seaice_tpu` with ice age and first-year
    ice on the subdiv-2 panel sphere, the winter atmosphere, from
    `full_physics_inputs` with seeded age and first-year tracers, for
    each day of AGE_DAYS, op by op: {day: fields as numpy}."""
    import jax.numpy as jnp
    from seaice_tpu import config as JC
    from seaice_tpu.dynamics.evp import DynamicsForcing as JForcing
    from seaice_tpu.mesh import icosahedral_mesh as jicos
    from seaice_tpu.mesh.panels import panel_reorder as jreorder
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.parallel.sharded import full_physics_inputs as jinputs
    from seaice_tpu.utils.pytree import replace

    mesh_j, _ = jreorder(jicos(SUBDIV), SUBDIV)
    jm = JModel(mesh_j, _age_cfg(JC), dtype=jnp.float64)
    area, vol, snow, extra, atm, ocn, coszen = jinputs(
        mesh_j, jm.cfg, jnp.float64)
    jf = JForcing(**{k: jnp.asarray(v) for k, v in
                     _sphere_forcing(mesh_j.n_cells).items()})
    jstep = jm.make_step(jit=False)
    js = jm.init_state(area, vol, snow)
    age = {k: jnp.asarray(v) for k, v in _age_tracers(
        mesh_j.n_cells, jm.cfg.run.n_categories).items()}
    js = replace(js, tracers=dict(js.tracers, **extra, **age))
    lat = jnp.asarray(mesh_j.lat_cell)
    out = {}
    for day in AGE_DAYS:
        s1, _ = jstep(jm.tensors, js, jf, atm, ocn,
                      coszen=jnp.asarray(coszen), day_of_year=day, lat=lat)
        out[day] = _fields(s1)
    return out


@pytest.mark.parametrize("day", AGE_DAYS, ids=["day100", "day265"])
def test_age_and_first_year_ice_match_reference(reference_age_steps, day):
    """The full-physics step with ice age and first-year ice, day_of_year
    and lat passed, against `seaice_tpu`: every tracer and u, v to
    AGE_STEP_LIMIT (pond fields under NOISE).  Where a category keeps its
    ice and takes no new ice, its age grows by dt; on day 265 the northern
    first-year area is reset (only new ice, which is first-year, is left),
    on day 100 it is not."""
    model, state0, forcing, atm, ocn, coszen = _port_sphere(
        SUBDIV, _age_cfg(C))
    nc, ncat = model.mesh.n_cells, model.cfg.run.n_categories
    age = {k: torch.as_tensor(v) for k, v in _age_tracers(nc, ncat).items()}
    state0 = state0.replace(tracers=dict(state0.tracers, **age))
    lat = torch.as_tensor(model.mesh.lat_cell)
    state, _ = model.make_step()(model.tensors, state0, forcing, atm, ocn,
                                 coszen=coszen, day_of_year=day, lat=lat)
    ref = reference_age_steps[day]
    got = _fields(state)
    _compare_states(ref, got, AGE_STEP_LIMIT)
    # categories 2 and up take no new ice (it forms in category 1)
    a1 = got["iceAreaCategory"][:, 1:]
    ice = a1 > 1e-3
    assert ice.sum() > 10
    np.testing.assert_allclose(got["iceAge"][:, 1:][ice],
                               1.0e7 + model.cfg.run.dt, rtol=1e-12)
    fy1 = got["firstYearIceArea"]
    assert (fy1 >= 0.0).all() and (fy1 <= 1.0).all()
    lat_c = model.mesh.lat_cell[:, None]
    north = (lat_c >= 0.0) & (got["iceAreaCategory"] > 1e-3)
    south = (lat_c < 0.0) & (got["iceAreaCategory"] > 1e-3)
    assert north.sum() > 10 and south.sum() > 10
    # day 265 resets the north (its first-year area is new ice only),
    # not the south (where transport mixes in a little of the north's
    # near the equator); on day 100 new ice only adds first-year area
    if day == 265.0:
        assert fy1[north].mean() < 0.2 and fy1[south].mean() > 0.65
    else:
        assert fy1[north | south].min() >= 0.7 - 1e-12


def test_float32_step_keeps_float32():
    """A small float32 full-physics model: every tracer, the velocity and
    every column flux stay float32 (numpy's float64 tables must not
    promote the step)."""
    model, state, forcing, atm, ocn, coszen = _port_sphere(
        1, _sphere_cfg(C, n_sub=2), dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in state.tracers.values())
    state, diags = model.make_step()(model.tensors, state, forcing, atm,
                                     ocn, coszen=coszen)
    for k, t in state.tracers.items():
        assert t.dtype == torch.float32, k
        assert bool(torch.isfinite(t).all()), k
    assert state.velocity.u_velocity.dtype == torch.float32
    fl = diags["column_fluxes"]
    for f in dataclasses.fields(fl):
        v = getattr(fl, f.name)
        if isinstance(v, torch.Tensor):
            assert v.dtype == torch.float32, f.name
    for k, v in diags["coupling_prep"].items():
        assert v.dtype == torch.float32, k


@pytest.mark.parametrize("option, value", [
    ("use_brine_height", True), ("use_biogeochemistry", True),
    ("use_skeletal_biochemistry", True), ("solve_zsalinity", True)])
def test_left_out_column_options_raise(option, value):
    """The column options the port once left out (brine height,
    z-salinity and biogeochemistry, ROADMAP Queue 1 item 10e, ported
    since) build in `SeaIceModel` and `ShardedSeaIceModel` and carry
    their tracers, every block with the whole model's tree (their
    initial profiles against the JAX package's:
    `test_convert_carries_bgc_tracers`)."""
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    cfg = _sphere_cfg(C)
    cfg = dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, **{option: value}))
    mesh, _ = panel_reorder(icosahedral_mesh(1), 1)
    model = SeaIceModel(mesh, cfg, dtype=F64, device="cpu")
    own = {"use_brine_height": ("brineHeight",),
           "use_biogeochemistry": ("brineHeight", "bioTracers",
                                   "bioMobileFraction"),
           "use_skeletal_biochemistry": ("sklBgc",),
           "solve_zsalinity": ("brineHeight", "verticalSalinity")}[option]
    assert set(own) <= set(model.tree.names)
    sm = ShardedSeaIceModel(mesh, cfg, 2, devices="cpu")
    assert all(m.column is not None and m.tree.names == model.tree.names
               for m in sm.models)
    for s in sm.init_state():
        assert set(own) <= set(s.tracers)


# the column options: one model each, stepped twice by both packages (the
# first step starts from rest, so highfreq sees moving ice in the second);
# the pond and radiation paths (the two of chip_smoke.py's column options
# phase) under MELT, with seeded aerosol deposition
SNOW_CASE = "snow_ITDrdg_formdrag_highfreq"
PONDS_SNICAR = "cesm_sliq_snicar_aero"
PONDS_MODAL = "topo_feedback_dedd_modal_aero"
ZSAL_SKL = "bl99_zsal_skl"
ZBGC_ZAERO = "zbgc_full_zaero"
OPTION_CASES = {
    SNOW_CASE: dict(use_snow_tracers=True, snwredist="ITDrdg",
                    use_form_drag=True, highfreq=True),
    "ktherm0": dict(ktherm=0),
    "prescribed_fluxes_bl99": dict(ktherm=1,
                                   calc_surface_temperature=False),
    PONDS_SNICAR: dict(pond_scheme="cesm", use_snow_tracers=True,
                       use_snow_liquid_ponds=True,
                       use_snicar=True, n_aerosols=2),
    # only topographic ponds book the pond water the feedback withholds
    PONDS_MODAL: dict(pond_scheme="topo",
                      include_pond_freshwater_feedback=True,
                      n_aerosols=2, use_modal_aerosols=True),
    # brine height, z-salinity and biogeochemistry: BL99 with the
    # vertical salinity and the skeletal scheme (winter), and mushy with
    # the vertical zBGC on the full roster and the z-layer aerosols
    # (MELT, seeded deposition); `zbgc_params` as the keyword arguments
    # of each package's ZbgcParams.  4 bio layers, not the default 7: the
    # reference's zBGC runs its reaction network layer by layer, op by op,
    # and 7 layers cost 5 s more of this file's 60-s budget for these cases
    ZSAL_SKL: dict(ktherm=1, solve_zsalinity=True,
                   use_skeletal_biochemistry=True, n_bio_layers=4),
    ZBGC_ZAERO: dict(use_biogeochemistry=True, n_bio_layers=4,
                     zbgc_params=dict(
        n_algae=3, use_C=True, use_DON=True, use_Fe=True, use_DMS=True,
        use_PON=True, use_hum=True, use_zaero=True, n_zaero=3)),
}
# the column fluxes these options add, held like the tracers
OPTION_FLUXES = ("faero_ocn", "fpond", "fresh")
# the BGC diagnostics (`ColumnFluxes.bgc`) of the BGC cases, held like
# the tracers but the carbon residual (a sum of reaction terms that
# cancel to rounding), held to TRACER_LIMIT of the largest bio tracer,
# and the two fluxes formed as differences of brine heights, held to
# BRINE_DIFFERENCE_LIMIT (ROADMAP Queue 3, fault 17): the Darcy velocity
# (the brine surface's height above sea level times 1 - exp(-rate dt),
# a difference that cancels where the rate is slow) and the bio flux to
# the ocean (the column content times the brine height's fall, hbr -
# hbr_old), where a last-bit difference grows by the cancellation
CARBON_RESIDUAL = "bgc_carbon_error"
BRINE_DIFFERENCES = ("darcy_v", "flux_bio")
BRINE_DIFFERENCE_LIMIT = 1e-11
# the other snow redistribution schemes: SNOW_CASE's first step, then its
# second under the scheme (winter atmosphere)
SNWREDIST_CASES = {"snow_bulk": "bulk", "snow_ITDsd": "ITDsd"}
# u and v to U_LIMIT of the largest speed component, tracers to
# TRACER_LIMIT of their own max (NOISE fields: the port's below NOISE)
U_LIMIT = 1e-11
TRACER_LIMIT = 1e-12


def _option_cfg(C, name):
    """The sphere config with the options of OPTION_CASES[name] (C: the
    port's or the JAX package's config module; `zbgc_params` made by the
    same package's ZbgcParams)."""
    cfg = _sphere_cfg(C)
    opts = dict(OPTION_CASES[name])
    if "zbgc_params" in opts:
        if C.__name__.startswith("seaice_tpu_torch"):
            from seaice_tpu_torch.column.zbgc import ZbgcParams
        else:
            from seaice_tpu.column.zbgc import ZbgcParams
        opts["zbgc_params"] = ZbgcParams(**opts["zbgc_params"])
    return dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, **opts))


def _deposition_species(cfg):
    """The species of aerosol deposition a config's column takes: its
    bulk aerosols, or its z-layer aerosols."""
    col = cfg.column
    if col.n_aerosols:
        return col.n_aerosols
    zp = col.zbgc_params
    return zp.n_zaero if zp is not None and zp.use_zaero else 0


def _sfc_fluxes(nc, ncat):
    """Per-category surface fluxes of an atmosphere model (seed 3)."""
    rng = np.random.default_rng(3)
    return dict(fsurf=rng.uniform(-20.0, 40.0, (nc, ncat)),
                fcondtop=rng.uniform(-30.0, 10.0, (nc, ncat)),
                flat=rng.uniform(-5.0, 0.0, (nc, ncat)),
                fsens=rng.uniform(-10.0, 10.0, (nc, ncat)))


def _option_runs(name):
    """(melt,) pairs to run: the combined snow case also under MELT,
    where real ponds feed the form drag; the pond cases under MELT
    only."""
    if OPTION_CASES[name].get("n_aerosols") or name == ZBGC_ZAERO:
        return (True,)
    return (False, True) if name == SNOW_CASE else (False,)


def _faero(nc, n_aero):
    """Aerosol deposition rates [nCells, nAero] (kg/m^2/s, seed 4)."""
    return np.random.default_rng(4).uniform(0.0, 2e-12, (nc, n_aero))


def _real_ponds(tracers, names):
    """Ponds of 0.3 of the ice area and 5 cm depth wherever a category
    holds ice (numpy, for the tracers of `names` the model carries): the
    pond schemes then evolve real ponds from the first step, where the
    melt of two steps makes only rounding noise (ROADMAP Queue 3 fault
    4)."""
    ice = np.asarray(tracers["iceAreaCategory"]) > 0.0
    ponds = {"pondArea": np.where(ice, 0.3, 0.0),
             "pondDepth": np.where(ice, 0.05, 0.0)}
    return {k: v for k, v in ponds.items() if k in names}


@pytest.fixture(scope="module")
def reference_option_steps():
    """Two full-physics steps of `seaice_tpu` for each OPTION_CASES
    model on the subdiv-2 panel sphere from `full_physics_inputs`, and
    the second step of SNOW_CASE's winter run under each scheme of
    SNWREDIST_CASES (SNOW_CASE's model with its column's scheme set),
    op by op: {(name, melt): fields as numpy}, and for the aerosol cases
    {(name, melt, "fluxes"): OPTION_FLUXES of the second step}."""
    import jax.numpy as jnp
    from seaice_tpu import config as JC
    from seaice_tpu.dynamics.evp import DynamicsForcing as JForcing
    from seaice_tpu.mesh import icosahedral_mesh as jicos
    from seaice_tpu.mesh.panels import panel_reorder as jreorder
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.parallel.sharded import full_physics_inputs as jinputs
    from seaice_tpu.utils.pytree import replace

    mesh_j, _ = jreorder(jicos(SUBDIV), SUBDIV)
    nc = mesh_j.n_cells
    jf = JForcing(**{k: jnp.asarray(v) for k, v in
                     _sphere_forcing(nc).items()})
    out = {}
    for name in OPTION_CASES:
        jm = JModel(mesh_j, _option_cfg(JC, name), dtype=jnp.float64)
        area, vol, snow, extra, atm, ocn, coszen = jinputs(
            mesh_j, jm.cfg, jnp.float64)
        sfc = None
        if not jm.cfg.column.calc_surface_temperature:
            sfc = {k: jnp.asarray(v) for k, v in _sfc_fluxes(
                nc, jm.cfg.run.n_categories).items()}
        n_aero = jm.cfg.column.n_aerosols
        n_dep = _deposition_species(jm.cfg)
        faero = jnp.asarray(_faero(nc, n_dep)) if n_dep else None
        jstep = jm.make_step(jit=False)
        for melt in _option_runs(name):
            atm_j = type(atm)(**{f.name: jnp.asarray(
                np.full(nc, MELT[f.name]) if melt and f.name in MELT
                else getattr(atm, f.name)) for f in dataclasses.fields(atm)})
            js = jm.init_state(area, vol, snow)
            js = replace(js, tracers=dict(js.tracers, **extra))
            if n_aero:
                js = replace(js, tracers=dict(js.tracers, **{
                    k: jnp.asarray(v) for k, v in _real_ponds(
                        js.tracers, js.tracers).items()}))
            for i in range(2):
                if i == 1 and name == SNOW_CASE and not melt:
                    # the unjitted step reads the column's scheme at
                    # each call
                    for case, scheme in SNWREDIST_CASES.items():
                        jm.column.snwredist = scheme
                        out[case, False] = _fields(jstep(
                            jm.tensors, js, jf, atm_j, ocn,
                            coszen=jnp.asarray(coszen))[0])
                    jm.column.snwredist = OPTION_CASES[name]["snwredist"]
                js, jd = jstep(jm.tensors, js, jf, atm_j, ocn,
                               coszen=jnp.asarray(coszen), sfc_fluxes=sfc,
                               faero_atm=faero)
            out[name, melt] = _fields(js)
            if n_aero:
                out[name, melt, "fluxes"] = {
                    k: np.asarray(getattr(jd["column_fluxes"], k))
                    for k in OPTION_FLUXES}
            if jd["column_fluxes"].bgc is not None:
                out[name, melt, "bgc"] = {
                    k: np.asarray(v)
                    for k, v in jd["column_fluxes"].bgc.items()}
    return out


@pytest.mark.parametrize("name, melt", [
    (n, m) for n in OPTION_CASES for m in _option_runs(n)] + [
    (n, False) for n in SNWREDIST_CASES],
    ids=lambda x: x if isinstance(x, str) else ("melt" if x else "winter"))
def test_column_option_steps_match_reference(reference_option_steps, name,
                                             melt):
    """Two full-physics steps with each option of the thermodynamics,
    surface and snow against `seaice_tpu` (the second step of a
    SNWREDIST_CASES case under its scheme, by `SeaIceModel.with_column`):
    u, v to U_LIMIT, every tracer to TRACER_LIMIT (the noise ponds of the
    winter forcing under NOISE: the form drag reads them and stays within
    the limits, ROADMAP Queue 3 fault 12); the option's own tracers are
    there and moved."""
    model, state, forcing, atm, ocn, coszen = _port_sphere(
        SUBDIV, _option_cfg(C, SNOW_CASE if name in SNWREDIST_CASES
                            else name))
    nc, ncat = model.mesh.n_cells, model.cfg.run.n_categories
    if melt:
        atm = atm.replace(**{k: torch.full((nc,), v, dtype=F64)
                             for k, v in MELT.items()})
    sfc = None
    if not model.cfg.column.calc_surface_temperature:
        sfc = {k: torch.as_tensor(v)
               for k, v in _sfc_fluxes(nc, ncat).items()}
    n_aero = model.cfg.column.n_aerosols
    n_dep = _deposition_species(model.cfg)
    faero = torch.as_tensor(_faero(nc, n_dep)) if n_dep else None
    if n_aero:
        state = state.replace(tracers=dict(state.tracers, **{
            k: torch.as_tensor(v) for k, v in _real_ponds(
                state.tracers, state.tracers).items()}))
    models = [model, model]
    if name in SNWREDIST_CASES:
        models[1] = model.with_column(snwredist=SNWREDIST_CASES[name])
    for m in models:
        state, diags = m.make_step()(m.tensors, state, forcing, atm, ocn,
                                     coszen=coszen, sfc_fluxes=sfc,
                                     faero_atm=faero)
    ref, got = reference_option_steps[name, melt], _fields(state)
    assert set(ref) == set(got)
    speed = max(np.abs(ref["u"]).max(), np.abs(ref["v"]).max())
    for k in ref:
        if k in ("u", "v"):
            _close(k, got[k], ref[k], U_LIMIT, speed)
        else:
            _close(k, got[k], ref[k], TRACER_LIMIT)
    if model.column.use_snow_tracers:
        assert (got["snowGrainRadius"] > 54.526).any()
    if model.column.use_form_drag:
        assert diags["column_fluxes"].Cdn_atm is not None
    if n_aero:
        fl = diags["column_fluxes"]
        for k, a in reference_option_steps[name, melt, "fluxes"].items():
            _close(k, getattr(fl, k).numpy(), a, TRACER_LIMIT)
        assert got["pondArea"].max() > 1e-3          # real ponds
        assert float(fl.faero_ocn.abs().max()) > 0.0
        if model.column.include_pond_freshwater_feedback:
            assert float(fl.fpond.abs().max()) > 0.0   # fresh withheld
    if (name, melt, "bgc") in reference_option_steps:
        bgc_ref = reference_option_steps[name, melt, "bgc"]
        bgc_got = diags["column_fluxes"].bgc
        assert set(bgc_got) == set(bgc_ref)
        bio = np.abs(got.get("bioTracers", 0.0)).max()
        for k, a in bgc_ref.items():
            if k == CARBON_RESIDUAL:
                err = float(np.abs(bgc_got[k].numpy() - a).max())
                assert err <= TRACER_LIMIT * bio, (k, err, bio)
            else:
                _close(k, bgc_got[k].numpy(), a,
                       BRINE_DIFFERENCE_LIMIT if k in BRINE_DIFFERENCES
                       else TRACER_LIMIT)
    if name == ZSAL_SKL:
        assert (got["verticalSalinity"] >= 0.1 - 1e-12).all()
        assert (got["sklBgc"][..., 0][got["iceAreaCategory"] > 1e-6]
                > 0.0).all()
    if name == ZBGC_ZAERO:
        zp = model.column.zbgc_params
        zsl = zp.index()["zaero"]
        bio = got["bioTracers"]
        bio = bio.reshape(bio.shape[:-1] + (zp.n_bio, -1))
        # the remap leaves rounding-size negatives (-2e-61), as in JAX
        assert bio.min() > -NOISE and bio[..., zsl, :].max() > 0.0


# the flags of the brine height, z-salinity and biogeochemistry: one column
# step (`ColumnPhysics.step_thermodynamics`) of the sphere's full-physics
# column (winter atmosphere) with each flag on against the same step with
# it off, both packages, op by op after the option steps above (the same
# shapes: the vertical zBGC on ZBGC_ZAERO's roster).  The z-layer aerosols
# are held by their deposition: the same roster with seeded `faero_atm`
# against it without (the empty slots are passive, and a roster without
# them would compile every zBGC operation of the reference again)
BGC_FLAGS = {
    "use_brine_height": dict(use_brine_height=True, n_bio_layers=4),
    "solve_zsalinity": dict(solve_zsalinity=True, n_bio_layers=4),
    "use_skeletal_biochemistry": dict(use_skeletal_biochemistry=True),
    "use_biogeochemistry": dict(
        use_biogeochemistry=True, n_bio_layers=4,
        zbgc_params=OPTION_CASES[ZBGC_ZAERO]["zbgc_params"]),
}
BGC_FLAGS["use_zaero"] = BGC_FLAGS["use_biogeochemistry"]
BGC_FLAG_OFF = {"use_zaero": "use_biogeochemistry"}
# a field moved where it changed by more than this share of its max
MOVED = 1e-9


def _flag_deposition(name, cfg, nc):
    """The z-aerosol deposition of a flag case: for use_zaero, seeded up
    to 1e-9 kg/m^2/s (the rate of `tests/test_zaero.py`)."""
    return 500.0 * _faero(nc, _deposition_species(cfg)) \
        if name == "use_zaero" else None


def _flag_cfg(C, name):
    cfg = _sphere_cfg(C)
    opts = dict(BGC_FLAGS.get(name, {}))
    if "zbgc_params" in opts:
        if C.__name__.startswith("seaice_tpu_torch"):
            from seaice_tpu_torch.column.zbgc import ZbgcParams
        else:
            from seaice_tpu.column.zbgc import ZbgcParams
        opts["zbgc_params"] = ZbgcParams(**opts["zbgc_params"])
    return dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, **opts))


def _column_fields(tracers, fl):
    """{name: numpy} of a column step's tracers, its column fluxes and its
    BGC diagnostics (prefixed "bgc.")."""
    def arr(v):
        return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    out = {k: arr(v) for k, v in tracers.items()}
    for f in dataclasses.fields(fl):
        v = getattr(fl, f.name)
        if f.name not in ("bgc", "warnings", "thermo_iterations") and \
                v is not None:
            out[f.name] = arr(v)
    for k, v in (fl.bgc or {}).items():
        out["bgc." + k] = arr(v)
    return out


def _moved(on, off, start):
    """The fields of the step `on` that moved against the step `off` (a
    field `off` lacks: against its value before the step, `start`; one of
    another shape moved)."""
    moved = set()
    for k, a in on.items():
        b = off.get(k, start.get(k))
        if b is None or b.shape != a.shape or np.abs(a - b).max() > \
                MOVED * max(np.abs(a).max(), np.abs(b).max(), 1e-300):
            moved.add(k)
    return moved


@pytest.fixture(scope="module")
def reference_flag_steps(reference_option_steps):
    """`seaice_tpu`'s column step of each BGC_FLAGS case and of the base
    (the sphere's column): {name: (fields, the tracers before)}."""
    import jax.numpy as jnp
    from seaice_tpu import config as JC
    from seaice_tpu.mesh import icosahedral_mesh as jicos
    from seaice_tpu.mesh.panels import panel_reorder as jreorder
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.parallel.sharded import full_physics_inputs as jinputs

    mesh_j, _ = jreorder(jicos(SUBDIV), SUBDIV)
    nc = mesh_j.n_cells
    out = {}
    for name in ("base",) + tuple(BGC_FLAGS):
        jm = JModel(mesh_j, _flag_cfg(JC, name), dtype=jnp.float64,
                    build_unstructured=False)
        area, vol, snow, extra, atm, ocn, coszen = jinputs(
            mesh_j, jm.cfg, jnp.float64)
        atm_j, ocn_j = (type(f)(**{g.name: jnp.asarray(getattr(f, g.name))
                                   for g in dataclasses.fields(f)})
                        for f in (atm, ocn))
        tr = dict(jm.init_state(area, vol, snow).tracers, **extra)
        dep = _flag_deposition(name, jm.cfg, nc)
        tr1, fl = jm.column.step_thermodynamics(
            jm.cfg.run.dt, dict(tr), atm_j, ocn_j,
            coszen=jnp.asarray(coszen),
            faero_atm=None if dep is None else jnp.asarray(dep))
        out[name] = (_column_fields(tr1, fl),
                     {k: np.asarray(v) for k, v in tr.items()})
    return out


@pytest.mark.parametrize("flag", list(BGC_FLAGS))
def test_bgc_flag_moves_answer_as_reference(reference_flag_steps, flag):
    """Each flag of the brine height, z-salinity and biogeochemistry moves
    the port's column step, and moves it as it moves `seaice_tpu`'s: the
    step with the flag on equals the reference's (every tracer and flux
    to TRACER_LIMIT, NOISE fields under NOISE, the carbon residual to
    TRACER_LIMIT of the largest bio tracer, the Darcy velocity and the
    bio flux to BRINE_DIFFERENCE_LIMIT), and the fields it moves
    against the step with the flag off are the reference's, its own
    tracer among them."""
    off_name = BGC_FLAG_OFF.get(flag, "base")
    got = {}
    for name in (flag, off_name):
        model, state, _, atm, ocn, coszen = _port_sphere(
            SUBDIV, _flag_cfg(C, name))
        dep = _flag_deposition(name, model.cfg, model.mesh.n_cells)
        tr1, fl = model.column.step_thermodynamics(
            model.cfg.run.dt, dict(state.tracers), atm, ocn, coszen=coszen,
            faero_atm=None if dep is None else torch.as_tensor(dep))
        got[name] = _column_fields(tr1, fl)
    ref_on, start = reference_flag_steps[flag]
    ref_off = reference_flag_steps[off_name][0]
    on = got[flag]
    assert set(on) == set(ref_on)
    bio = np.abs(on["bioTracers"]).max() if "bioTracers" in on else 1.0
    for k, a in ref_on.items():
        if k == "bgc." + CARBON_RESIDUAL:
            assert np.abs(on[k] - a).max() <= TRACER_LIMIT * bio, k
        else:
            _close(k, on[k], a, BRINE_DIFFERENCE_LIMIT
                   if k[len("bgc."):] in BRINE_DIFFERENCES else TRACER_LIMIT)
    moved = _moved(on, got[off_name], start)
    assert moved == _moved(ref_on, ref_off, start), (
        sorted(moved ^ _moved(ref_on, ref_off, start)))
    own = {"use_brine_height": "brineHeight",
           "solve_zsalinity": "verticalSalinity",
           "use_skeletal_biochemistry": "sklBgc",
           "use_biogeochemistry": "bioTracers",
           "use_zaero": "bioTracers"}[flag]
    assert own in moved, (flag, sorted(moved))


def test_convert_carries_snow_tracers():
    """`convert` carries the three snow tracers of a JAX State bitwise;
    both packages start the grain radius at RSNW_FALL."""
    import jax.numpy as jnp
    from seaice_tpu import config as JC
    from seaice_tpu.mesh import icosahedral_mesh as jicos
    from seaice_tpu.mesh.panels import panel_reorder as jreorder
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.utils.pytree import replace
    from seaice_tpu_torch.column.snow import RSNW_FALL
    from seaice_tpu_torch.convert import flatten_arrays, from_reference_arrays

    name = SNOW_CASE
    mesh_j, _ = jreorder(jicos(1), 1)
    jm = JModel(mesh_j, _option_cfg(JC, name), dtype=jnp.float64,
                build_unstructured=False)
    model, own, _, _, _, _ = _port_sphere(1, _option_cfg(C, name))
    nc, ncat = mesh_j.n_cells, jm.cfg.run.n_categories
    js = jm.init_state(*(np.asarray(own.tracers[k]) for k in (
        "iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory")))
    snow_names = ("snowIceMass", "snowLiquidMass", "snowGrainRadius")
    for k in snow_names:
        assert np.array_equal(own.tracers[k].numpy(),
                              np.asarray(js.tracers[k])), k
    assert float(own.tracers["snowGrainRadius"].min()) == RSNW_FALL
    rng = np.random.default_rng(8)
    snow = {k: jnp.asarray(rng.uniform(0.0, 500.0, (nc, ncat, 1)))
            for k in snow_names}
    js = replace(js, tracers=dict(js.tracers, **snow))
    _, state, _ = from_reference_arrays(None, flatten_arrays(js), "cpu",
                                        F64)
    assert set(state.tracers) == set(model.tree.names)
    for k in snow_names:
        assert torch.equal(state.tracers[k],
                           torch.as_tensor(np.array(snow[k]))), k


def test_convert_carries_bgc_tracers():
    """`convert` carries a JAX State with the brine height, the bio
    tracers and their mobile fractions, the vertical salinity and the
    skeletal pools bitwise (one tree with all five: the model of the
    vertical zBGC and the z-salinity, handed the skeletal pools too), and
    the JAX package's initial profiles of them equal the port's."""
    import jax.numpy as jnp
    from seaice_tpu import config as JC
    from seaice_tpu.mesh import icosahedral_mesh as jicos
    from seaice_tpu.mesh.panels import panel_reorder as jreorder
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.transport.tracers import standard_tracer_tree as jtree
    from seaice_tpu.utils.pytree import replace
    from seaice_tpu_torch.convert import flatten_arrays, from_reference_arrays
    from seaice_tpu_torch.transport.tracers import standard_tracer_tree

    bgc = dict(use_biogeochemistry=True, solve_zsalinity=True)
    kw = dict(n_ice_layers=4, n_snow_layers=1, pond_scheme="lvl",
              use_level_ice=True, use_brine_height=True,
              n_bio_tracers=4 * 8, n_bio_grid_points=8,
              use_skeletal_bgc=True, n_vertical_salinity=7)
    mesh_j, _ = jreorder(jicos(1), 1)
    jm = JModel(mesh_j, dataclasses.replace(_sphere_cfg(JC), column=(
        dataclasses.replace(_sphere_cfg(JC).column, **bgc))),
        dtype=jnp.float64, tracer_tree=jtree(**kw),
        build_unstructured=False)
    mesh, _ = panel_reorder(icosahedral_mesh(1), 1)
    model = SeaIceModel(mesh, dataclasses.replace(_sphere_cfg(C), column=(
        dataclasses.replace(_sphere_cfg(C).column, **bgc))), dtype=F64,
        device="cpu", tracer_tree=standard_tracer_tree(**kw))
    names = ("brineHeight", "bioTracers", "bioMobileFraction",
             "verticalSalinity", "sklBgc")
    nc, ncat = mesh.n_cells, jm.cfg.run.n_categories
    area = np.full((nc, ncat), 0.3)
    js = jm.init_state(area, area * 1.2, area * 0.1)
    own = model.init_state(area, area * 1.2, area * 0.1)
    assert set(names) <= set(js.tracers) and set(own.tracers) == set(
        js.tracers)
    for k in names:
        assert np.array_equal(own.tracers[k].numpy(),
                              np.asarray(js.tracers[k])), k
    rng = np.random.default_rng(9)
    new = {k: jnp.asarray(rng.uniform(0.0, 30.0, js.tracers[k].shape))
           for k in names}
    js = replace(js, tracers=dict(js.tracers, **new))
    _, state, _ = from_reference_arrays(None, flatten_arrays(js), "cpu",
                                        F64)
    assert set(state.tracers) == set(model.tree.names)
    for k in names:
        assert torch.equal(state.tracers[k],
                           torch.as_tensor(np.array(new[k]))), k


def test_convert_carries_full_physics_state_and_forcing():
    """`convert` carries the JAX package's full-physics State (every
    tracer) and its column forcing across; they equal the port's own
    `full_physics_inputs` bitwise."""
    import jax
    import jax.numpy as jnp
    from seaice_tpu import config as JC
    from seaice_tpu.mesh import icosahedral_mesh as jicos
    from seaice_tpu.mesh.panels import panel_reorder as jreorder
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.parallel.sharded import full_physics_inputs as jinputs
    from seaice_tpu.utils.pytree import replace
    from seaice_tpu_torch.convert import (
        column_forcing_from_reference_arrays, flatten_arrays,
        from_reference_arrays)

    mesh_j, _ = jreorder(jicos(1), 1)
    jm = JModel(mesh_j, _sphere_cfg(JC), dtype=jnp.float64,
                build_unstructured=False)
    area, vol, snow, extra, atm, ocn, coszen = jinputs(
        mesh_j, jm.cfg, jnp.float64)
    js = jm.init_state(area, vol, snow)
    js = replace(js, tracers=dict(js.tracers, **extra))
    _, state, _ = from_reference_arrays(None, flatten_arrays(js), "cpu",
                                        F64)
    atm_c, ocn_c = column_forcing_from_reference_arrays(
        flatten_arrays(jax.tree.map(jnp.asarray, atm)),
        flatten_arrays(jax.tree.map(jnp.asarray, ocn)), "cpu", F64)

    model, own, _, atm_t, ocn_t, _ = _port_sphere(1, _sphere_cfg(C))
    assert set(state.tracers) == set(own.tracers) == set(model.tree.names)
    for k, v in own.tracers.items():
        assert torch.equal(state.tracers[k], v), k
    for got, want in ((atm_c, atm_t), (ocn_c, ocn_t)):
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name),
                               getattr(want, f.name)), f.name
