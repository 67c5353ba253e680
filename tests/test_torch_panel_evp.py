"""The velocity solve on the panel-reordered sphere: the port's two panel
routes (whole-loop kernel, per-subcycle cell kernel; on the CPU their
plain versions) against the JAX package's XLA panel path and against its
two Pallas kernels in interpret mode.  Same numpy inputs, float64, 1e-10
of each field's max."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import seaice_tpu.mesh as jmesh
import seaice_tpu_torch.mesh as tmesh
from seaice_tpu import config as jconfig
from seaice_tpu_torch import config as tconfig
from seaice_tpu.dynamics import evp as jevp
from seaice_tpu.mesh.panels import panel_reorder as jreorder
from seaice_tpu_torch.dynamics import evp as tevp
from seaice_tpu_torch.mesh.panels import panel_reorder as treorder

torch.set_num_threads(1)

TOL = 1e-10
SUBDIV = 3
FIELDS = ("u_velocity", "v_velocity", "stress11", "stress22", "stress12")


def _cfg(c, metric, n_sub=6, **vel):
    return c.Config(
        run=c.RunConfig(n_categories=1),
        velocity=c.VelocitySolverConfig(
            elastic_subcycle_number=n_sub, rotate_cartesian_grid=True,
            include_metric_terms=metric, **vel),
        column=c.ColumnConfig(use_column_package=False))


_CACHE = {}


def _problem(metric):
    """Both packages' meshes, dynamics tensors, states and forcings."""
    if metric in _CACHE:
        return _CACHE[metric]
    mj, lj = jreorder(jmesh.icosahedral_mesh(SUBDIV), SUBDIV)
    mt, lt = treorder(tmesh.icosahedral_mesh(SUBDIV), SUBDIV)
    rng = np.random.default_rng(5)
    nc = mj.n_cells
    ice = np.abs(mj.lat_cell)[:, None] > 0.5
    area = np.where(ice, rng.uniform(0.3, 0.9, (nc, 1)), 0.0)
    vol = area * rng.uniform(0.5, 2.0, (nc, 1))
    snow = area * 0.1
    f = dict(
        u_air_velocity=5.0 * rng.standard_normal(nc),
        v_air_velocity=5.0 * rng.standard_normal(nc),
        air_density=np.full(nc, 1.3),
        u_ocean_velocity=0.05 * rng.standard_normal(nc),
        v_ocean_velocity=0.05 * rng.standard_normal(nc),
        sea_surface_tilt_u=np.zeros(nc), sea_surface_tilt_v=np.zeros(nc),
        land_ice_mask=np.zeros(nc))
    dj = jevp.build_dynamics_tensors(mj, _cfg(jconfig, metric), jnp.float64,
                                     build_unstructured=False)
    dt = tevp.build_dynamics_tensors(mt, _cfg(tconfig, metric),
                                     torch.float64, "cpu")
    out = dict(
        mj=mj, lj=lj, mt=mt, lt=lt, dj=dj, dt=dt,
        mdv=float(np.min(mj.dv_edge[mj.dv_edge > 0])),
        sj=jevp.init_velocity_state(mj, jnp.float64),
        st=tevp.init_velocity_state(mt, torch.float64, "cpu"),
        fj=jevp.DynamicsForcing(**{k: jnp.asarray(v) for k, v in f.items()}),
        ft=tevp.DynamicsForcing(**{k: torch.as_tensor(v)
                                   for k, v in f.items()}),
        ice_j=tuple(jnp.asarray(a) for a in (area, vol, snow)),
        ice_t=tuple(torch.as_tensor(a) for a in (area, vol, snow)))
    _CACHE[metric] = out
    return out


def _run_j(p, solver, n=2):
    s = p["sj"]
    for _ in range(n):
        s, d = solver(p["dj"], s, p["fj"], *p["ice_j"])
    return s, d


def _run_t(p, solver, n=2):
    s = p["st"]
    for _ in range(n):
        s, d = solver(p["dt"], s, p["ft"], *p["ice_t"])
    return s, d


def _assert_states_close(got, ref, tol=TOL):
    for k in FIELDS:
        a = np.asarray(getattr(ref, k))
        b = getattr(got, k).numpy()
        assert a.shape == b.shape, k
        assert np.abs(a).max() > 0, k
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * np.abs(a).max(),
                                   err_msg=k)


# the JAX package's three panel routes
J_ROUTES = {
    "xla": lambda p: dict(panel_n=p["lj"].N, use_pallas=False),
    "fused_interpret": lambda p: dict(panel_n=p["lj"].N, use_pallas=True,
                                      panel_mesh=p["mj"]),
    "cell_interpret": lambda p: dict(panel_n=p["lj"].N, use_pallas=True),
}
# the port's two: whole-loop kernel, per-subcycle cell kernel
T_ROUTES = {
    "loop": lambda p: dict(panel_n=p["lt"].N, panel_mesh=p["mt"]),
    "cell": lambda p: dict(panel_n=p["lt"].N),
}


# tracing the whole-loop Pallas kernel for interpret mode takes about half
# a minute per solve: one solve, and the case without metric terms (a
# subset of the traced program) only in the long run
CASES = [
    ("loop", "xla", False, 2), ("loop", "xla", True, 2),
    ("cell", "xla", False, 2), ("cell", "xla", True, 2),
    ("cell", "cell_interpret", False, 2), ("cell", "cell_interpret", True, 2),
    ("loop", "fused_interpret", True, 1),
    pytest.param("loop", "fused_interpret", False, 1,
                 marks=pytest.mark.slow),
]


@pytest.mark.parametrize("t_route, j_route, metric, n_solves", CASES)
def test_panel_velocity_solve_matches_reference(t_route, j_route, metric,
                                                n_solves):
    """Velocity solves of 6 subcycles from rest, each port route against
    the XLA panel path and against the Pallas kernel it replaces
    (interpret mode)."""
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    p = _problem(metric)
    sj, dj = _run_j(p, jevp.make_velocity_solver(
        _cfg(jconfig, metric), min_dv_edge=p["mdv"], **J_ROUTES[j_route](p)),
        n=n_solves)
    reset_launch_counts()
    st, dt = _run_t(p, tevp.make_velocity_solver(
        _cfg(tconfig, metric), **T_ROUTES[t_route](p)), n=n_solves)
    # on the CPU the wrappers take their plain versions: no launch
    assert set(launch_counts().values()) == {0}
    _assert_states_close(st, sj)
    # post-subcycle strain diagnostics go through strain_tensor_P
    for k in ("divergence", "shear"):
        a, b = np.asarray(dj[k]), dt[k].numpy()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=TOL * np.abs(a).max(), err_msg=k)


@pytest.mark.parametrize("metric", [False, True])
def test_config_option_selects_the_cell_route(metric):
    """`use_fused_panel_loop=False` with the mesh object given takes the
    per-subcycle route (one `panel_cell_step` per subcycle); both routes
    give the same solve."""
    from seaice_tpu_torch.dynamics import evp as evp_mod
    p = _problem(metric)
    calls = {"cell": 0, "loop": 0}
    cell, loop = evp_mod.panel_cell_step, evp_mod.evp_panel_loop

    def count(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    evp_mod.panel_cell_step = count("cell", cell)
    evp_mod.evp_panel_loop = count("loop", loop)
    try:
        kw = dict(panel_n=p["lt"].N, panel_mesh=p["mt"])
        s_cell, _ = _run_t(p, tevp.make_velocity_solver(
            _cfg(tconfig, metric, use_fused_panel_loop=False), **kw), n=1)
        assert calls == {"cell": 6, "loop": 0}
        s_loop, _ = _run_t(p, tevp.make_velocity_solver(
            _cfg(tconfig, metric), **kw), n=1)
        assert calls == {"cell": 6, "loop": 1}
    finally:
        evp_mod.panel_cell_step, evp_mod.evp_panel_loop = cell, loop
    for k in FIELDS:
        a, b = getattr(s_loop, k), getattr(s_cell, k)
        assert float((a - b).abs().max()) <= 1e-12 * float(a.abs().max()), k


def test_panel_route_errors():
    p = _problem(False)
    with pytest.raises(ValueError, match="use_fused_panel_loop"):
        tevp.make_velocity_solver(
            _cfg(tconfig, False, use_fused_panel_loop=True),
            panel_n=p["lt"].N)
    with pytest.raises(NotImplementedError, match="use_pallas=False"):
        tevp.make_velocity_solver(_cfg(tconfig, False), panel_n=p["lt"].N,
                                  use_pallas=False)
    # the panel loop runs on a whole mesh: no halo exchange with it
    with pytest.raises(ValueError, match="halo exchange"):
        tevp.make_velocity_solver(_cfg(tconfig, False), panel_n=p["lt"].N,
                                  halo_exchange_vertex=lambda u, v: (u, v))
    # panel_n on tensors without panel layout
    mt = tmesh.icosahedral_mesh(1)
    dyn = tevp.build_dynamics_tensors(mt, _cfg(tconfig, False),
                                      torch.float64, "cpu")
    assert dyn.panel is None
    solver = tevp.make_velocity_solver(_cfg(tconfig, False), panel_n=2)
    z = torch.zeros((mt.n_cells, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="panel"):
        solver(dyn, tevp.init_velocity_state(mt, torch.float64, "cpu"),
               tevp.zero_forcing(mt, torch.float64, "cpu"), z, z, z)


def _loop_inputs(mesh, rng):
    nv, nc = mesh.n_vertices, mesh.n_cells

    def f(a):
        return torch.as_tensor(a)

    return (f(0.1 * rng.standard_normal(nv)), f(0.1 * rng.standard_normal(nv)),
            *(f(1e3 * rng.standard_normal((6, nc))) for _ in range(3)),
            f(rng.uniform(1e3, 1e4, nc)),
            f((rng.uniform(size=nc) > 0.1).astype(np.float64)),
            f(0.05 * rng.standard_normal(nv)),
            f(0.05 * rng.standard_normal(nv)),
            f(rng.uniform(500.0, 2000.0, nv)),
            f(0.2 * rng.standard_normal(nv)),
            f(0.1 * rng.standard_normal(nv)), f(0.1 * rng.standard_normal(nv)),
            f(0.05 * rng.standard_normal(nv)),
            f(0.05 * rng.standard_normal(nv)),
            f((rng.uniform(size=nv) > 0.15).astype(np.float64)),
            f(rng.uniform(0.1, 1.0, nv)))


@pytest.mark.parametrize("metric", [False, True])
def test_panel_loop_plain_matches_unstructured_loop_plain(metric):
    """Two plain versions of one function: the panel loop (static
    offsets, ghost strips, exception cells) and the any-connectivity loop
    (index gathers) on the same panel mesh and the same random inputs,
    masks included."""
    from seaice_tpu_torch.dynamics.cuda_panel_fused import (
        evp_panel_loop, evp_panel_loop_plain)
    from seaice_tpu_torch.dynamics.cuda_unstructured import (
        evp_subcycle_loop_plain)
    p = _problem(metric)
    args = _loop_inputs(p["mt"], np.random.default_rng(11))
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=8,
              include_metric=metric)
    a = evp_panel_loop_plain(p["dt"].panel, *args, **kw)
    b = evp_subcycle_loop_plain(p["dt"].fast, *args, **kw)
    valid = torch.as_tensor(
        np.arange(6)[:, None] < p["mt"].n_edges_on_cell[None, :])
    for n, x, y in zip(("u", "v", "s11", "s22", "s12"), a, b):
        if x.dim() == 2:          # ring entries beyond a pentagon's five
            x, y = x * valid, y * valid
        assert float((x - y).abs().max()) <= 1e-12 * float(y.abs().max()), n
    # CPU tensors: the wrapper is the plain version, and counts nothing
    before = (evp_panel_loop.launches, evp_panel_loop.inner_launches)
    c = evp_panel_loop(p["dt"].panel, *args, **kw)
    assert (evp_panel_loop.launches, evp_panel_loop.inner_launches) == before
    for x, y in zip(a, c):
        assert torch.equal(x, y)


@pytest.mark.parametrize("metric", [False, True])
def test_panel_cell_plain_is_the_cell_side_of_the_loop(metric):
    """K5's plain version on planes built from u, v gives the stresses of
    the first subcycle of the loop (exception columns left alone) and
    the partials of `divergence_partials`."""
    from seaice_tpu_torch.dynamics import variational_panel as vpn
    from seaice_tpu_torch.dynamics import constitutive
    from seaice_tpu_torch.dynamics.cuda_panel import (panel_cell_plain,
                                                      panel_cell_step)
    p = _problem(metric)
    pt, N = p["dt"].panel, p["lt"].N
    args = _loop_inputs(p["mt"], np.random.default_rng(12))
    u, v, s11, s22, s12, pressure, ss = args[:7]
    t = [vpn.stress_ring_to_slot(pt, s) for s in (s11, s22, s12)]
    p_pad, ss_pad = vpn.cells_to_padded(pt, pressure), vpn.cells_to_padded(
        pt, ss)
    ss_k = ss_pad.clone()
    ss_k[pt.exc_pad_cols] = 0
    planes = vpn.velocity_planes(pt, N, u, v, metric)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0,
              include_metric=metric)
    n11, n22, n12, part = panel_cell_plain(pt, planes, *t, p_pad, ss_k, **kw)
    e = vpn.strain_tensor_P(pt, N, u, v, metric)
    w = constitutive.evp_stress_update(*t, *e, p_pad[None, :], 15.0, 648.0)
    keep = torch.ones_like(ss_pad, dtype=torch.bool)
    keep[pt.exc_pad_cols] = False
    for got, new, old in zip((n11, n22, n12), w[:3], t):
        want = torch.where((ss_pad > 0)[None, :], new, old)
        assert torch.equal(got[:, keep], want[:, keep])
        assert torch.equal(got[:, ~keep], old[:, ~keep])
    assert torch.equal(part, vpn.divergence_partials(pt, n11, n22, n12,
                                                     metric))
    assert part.shape == (6, pt.basis_grad_S.shape[-1], 4 if metric else 2)
    before = panel_cell_step.launches
    again = panel_cell_step(pt, planes, *t, p_pad, ss_k, **kw)
    assert panel_cell_step.launches == before
    for x, y in zip(again, (n11, n22, n12, part)):
        assert torch.equal(x, y)


def test_work_counts_of_the_panel_kernels():
    from seaice_tpu_torch.dynamics.cuda_panel import panel_cell_work
    from seaice_tpu_torch.dynamics.cuda_panel_fused import (
        evp_panel_loop_work)
    b1, f1 = evp_panel_loop_work(64, 1, True, 4)
    b120, f120 = evp_panel_loop_work(64, 120, True, 4)
    assert b1 == b120 > 0 and f120 == 120 * f1 > 0
    # the three basis tensors dominate: 5*36*42252*4 B = 30.4 MB
    basis = 5 * 36 * 42252 * 4
    assert basis < b1 < 1.5 * basis
    bc, fc = panel_cell_work(64, True, 4)
    assert basis < bc < 1.5 * basis
    # one launch does the cell side of one subcycle
    assert 0.8 * f1 < fc < f1
    assert panel_cell_work(64, False, 4)[0] < bc


@pytest.mark.gpu
@pytest.mark.parametrize("metric", [False, True])
def test_panel_kernels_match_plain_versions_on_the_card(metric):
    """Needs an NVIDIA GPU and nvcc: K3 and K5 against their plain
    versions on the subdiv-3 panel mesh, float64, one and eight
    subcycles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python3 chip_smoke.py` "
                    "on a machine with one")
    from seaice_tpu_torch.dynamics import variational_panel as vpn
    from seaice_tpu_torch.dynamics.cuda_panel import (panel_cell_plain,
                                                      panel_cell_step)
    from seaice_tpu_torch.dynamics.cuda_panel_fused import (
        evp_panel_loop, evp_panel_loop_plain)
    p = _problem(metric)
    pt = p["dt"].panel.to("cuda")
    args = tuple(a.cuda() for a in _loop_inputs(p["mt"],
                                                np.random.default_rng(13)))
    for n_sub, tol in ((1, 1e-12), (8, 1e-10)):
        kw = dict(dt_elastic=15.0, damping_timescale=648.0,
                  n_subcycles=n_sub, include_metric=metric)
        got = evp_panel_loop(pt, *args, **kw)
        want = evp_panel_loop_plain(pt, *args, **kw)
        for x, y in zip(got, want):
            assert float((x - y).abs().max()) <= tol * float(y.abs().max())
    u, v, s11, s22, s12, pressure, ss = args[:7]
    t = [vpn.stress_ring_to_slot(pt, s) for s in (s11, s22, s12)]
    ss_k = vpn.cells_to_padded(pt, ss)
    ss_k[pt.exc_pad_cols] = 0
    planes = vpn.velocity_planes(pt, p["lt"].N, u, v, metric)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0,
              include_metric=metric)
    a5 = (pt, planes, *t, vpn.cells_to_padded(pt, pressure), ss_k)
    for x, y in zip(panel_cell_step(*a5, **kw), panel_cell_plain(*a5, **kw)):
        assert float((x - y).abs().max()) <= 1e-12 * float(y.abs().max())
