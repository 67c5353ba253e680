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
        mesh, cfg, dtype)
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
    ("ktherm", 0), ("calc_surface_temperature", False),
    ("pond_scheme", "cesm"), ("pond_scheme", "topo"),
    ("use_ice_age", True), ("use_first_year_ice", True),
    ("use_snow_tracers", True), ("snwredist", "bulk"),
    ("n_aerosols", 2), ("use_snicar", True), ("use_form_drag", True),
    ("highfreq", True), ("use_brine_height", True),
    ("use_biogeochemistry", True), ("use_skeletal_biochemistry", True),
    ("solve_zsalinity", True)])
def test_left_out_column_options_raise(option, value):
    """Every column option the port leaves out raises when the model is
    built, naming the roadmap item; none runs silently."""
    cfg = _sphere_cfg(C)
    if option == "calc_surface_temperature":
        cfg = dataclasses.replace(cfg, column=dataclasses.replace(
            cfg.column, ktherm=1))
    cfg = dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, **{option: value}))
    mesh, _ = panel_reorder(icosahedral_mesh(1), 1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        SeaIceModel(mesh, cfg, dtype=F64, device="cpu")


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
