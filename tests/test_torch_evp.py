"""The port's velocity solve (its plain subcycle loop, the version the
CUDA kernel is held against on the card) against the JAX package's: the
XLA path and the Pallas kernel `build_unstructured_solver` in interpret
mode.  float64, same numpy inputs to both."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import seaice_tpu.mesh as jmesh
import seaice_tpu_torch.mesh as tmesh
from seaice_tpu import config as jconfig
from seaice_tpu_torch import config as tconfig
from seaice_tpu.dynamics import evp as jevp
from seaice_tpu_torch.dynamics import evp as tevp

torch.set_num_threads(1)

FIELDS = ("u_velocity", "v_velocity", "stress11", "stress22", "stress12")


def _cfg(c, metric, subcycles):
    return c.Config(
        run=c.RunConfig(dt=1800.0, n_categories=1),
        velocity=c.VelocitySolverConfig(
            elastic_subcycle_number=subcycles, rotate_cartesian_grid=True,
            include_metric_terms=metric, geostrophic_surface_tilt=False))


def _inputs(nc):
    rng = np.random.default_rng(0)
    area = np.clip(rng.uniform(-0.3, 0.95, (nc, 1)), 0.0, 1.0)
    vol = area * rng.uniform(0.5, 2.5, (nc, 1))
    forcing = dict(
        u_air_velocity=5.0 * rng.standard_normal(nc),
        v_air_velocity=2.0 * rng.standard_normal(nc),
        air_density=np.full(nc, 1.3),
        u_ocean_velocity=0.05 * rng.standard_normal(nc),
        v_ocean_velocity=0.05 * rng.standard_normal(nc),
        sea_surface_tilt_u=1e-6 * rng.standard_normal(nc),
        sea_surface_tilt_v=1e-6 * rng.standard_normal(nc),
        land_ice_mask=np.zeros(nc))
    return area, vol, np.zeros_like(vol), forcing


def _solve_port(subdiv, metric, subcycles, n_steps):
    mesh = tmesh.icosahedral_mesh(subdiv)
    cfg = _cfg(tconfig, metric, subcycles)
    dyn = tevp.build_dynamics_tensors(mesh, cfg, torch.float64, "cpu")
    area, vol, snow, f = _inputs(mesh.n_cells)
    forcing = tevp.DynamicsForcing(
        **{k: torch.as_tensor(v) for k, v in f.items()})
    state = tevp.init_velocity_state(mesh, torch.float64, "cpu")
    solver = tevp.make_velocity_solver(cfg)
    for _ in range(n_steps):
        state, diags = solver(dyn, state, forcing, torch.as_tensor(area),
                              torch.as_tensor(vol), torch.as_tensor(snow))
    return state, diags


def _solve_reference(subdiv, metric, subcycles, n_steps, pallas):
    mesh = jmesh.icosahedral_mesh(subdiv)
    cfg = _cfg(jconfig, metric, subcycles)
    dyn = jevp.build_dynamics_tensors(mesh, cfg, jnp.float64,
                                      build_unstructured=pallas)
    area, vol, snow, f = _inputs(mesh.n_cells)
    forcing = jevp.DynamicsForcing(
        **{k: jnp.asarray(v) for k, v in f.items()})
    state = jevp.init_velocity_state(mesh, jnp.float64)
    # jitted: compiling the solve once costs less than running it eagerly
    solver = jax.jit(jevp.make_velocity_solver(
        cfg, use_pallas=pallas,
        unstructured_plan=dyn.unstructured if pallas else None))
    for _ in range(n_steps):
        state, diags = solver(dyn, state, forcing, jnp.asarray(area),
                              jnp.asarray(vol), jnp.asarray(snow))
    return state, diags


@pytest.mark.parametrize("metric", [False, True])
def test_velocity_solve_matches_xla_path(metric):
    """Two dynamics steps, 6 subcycles each, icos subdiv 2: state and
    diagnostics to 1e-11 of each field's max (sum order only)."""
    got, dg = _solve_port(2, metric, 6, 2)
    ref, dr = _solve_reference(2, metric, 6, 2, pallas=False)
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-11 * np.abs(a).max(), err_msg=f)
    for k in dr:
        a, b = np.asarray(dr[k], np.float64), dg[k].numpy()
        np.testing.assert_allclose(
            b, a, rtol=0, atol=1e-11 * max(np.abs(a).max(), 1e-300),
            err_msg=k)


@pytest.mark.parametrize("metric", [False, True])
def test_velocity_solve_matches_pallas_interpret(metric):
    """One solve against the TPU kernel the CUDA kernel replaces, run in
    interpret mode as the JAX package's own tests run it: 1e-11 of each
    field's max."""
    got, _ = _solve_port(2, metric, 4, 1)
    ref, _ = _solve_reference(2, metric, 4, 1, pallas=True)
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-11 * np.abs(a).max(), err_msg=f)


def test_layouts_agree():
    """The natural-layout operators (variational.py) and the transposed
    ones (variational_fast.py) of the port give the same strain and stress
    divergence: 1e-13 of the max."""
    from seaice_tpu_torch.dynamics import variational, variational_fast
    mesh = tmesh.icosahedral_mesh(2)
    cfg = _cfg(tconfig, True, 1)
    dyn = tevp.build_dynamics_tensors(mesh, cfg, torch.float64, "cpu")
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.standard_normal(mesh.n_vertices))
    v = torch.as_tensor(rng.standard_normal(mesh.n_vertices))
    e = variational.strain_tensor(u, v, dyn.tan_lat_vertex, dyn.mesh,
                                  dyn.basis_gradient_u, dyn.basis_gradient_v)
    eT = variational_fast.strain_tensor_T(dyn.fast, u, v, True)
    for a, b in zip(e, eT):
        assert float((a - b.t()).abs().max()) <= 1e-13 * float(a.abs().max())
    s = [torch.as_tensor(rng.standard_normal((mesh.n_cells, 6)))
         for _ in range(3)]
    sv = torch.ones(mesh.n_vertices, dtype=torch.float64)
    d = variational.stress_divergence(
        *s, dyn.tan_lat_vertex, dyn.mesh, dyn.basis_integrals_u,
        dyn.basis_integrals_v, dyn.basis_integrals_metric,
        dyn.variational_denominator, sv)
    dT = variational_fast.stress_divergence_T(
        dyn.fast, *(x.t().contiguous() for x in s), sv, True)
    for a, b in zip(d, dT):
        assert float((a - b).abs().max()) <= 1e-13 * float(a.abs().max())


@pytest.mark.parametrize("what", ["halo"])
def test_later_slices_raise(what):
    """What the port once left out is ported: the overlap of the vertex
    exchange with the interior's compute (`halo_overlap`) is accepted
    for standard EVP, and a configuration it cannot split raises the
    JAX package's ValueError (the weak scheme here; the overlap itself
    is held in `test_torch_sharded.py`)."""
    kw = {"halo_overlap": (None, lambda buf: buf, 0)}
    cfg = tconfig.Config(velocity=tconfig.VelocitySolverConfig(
        elastic_subcycle_number=2, include_metric_terms=False))
    assert callable(tevp.make_velocity_solver(cfg, **kw))
    weak = dataclasses.replace(cfg, velocity=dataclasses.replace(
        cfg.velocity, strain_scheme=tconfig.StrainScheme.WEAK,
        stress_divergence_scheme=tconfig.StressDivergenceScheme.WEAK))
    with pytest.raises(ValueError, match="halo_overlap requires the fast "
                       "variational path with standard EVP"):
        tevp.make_velocity_solver(weak, **kw)
