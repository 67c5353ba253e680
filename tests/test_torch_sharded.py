"""The port's partitioned model (`seaice_tpu_torch/parallel/sharded.py`)
and the loop form of the one-subcycle EVP kernel (K6), float64 on the CPU,
where the kernel wrappers run their plain versions.

(a) the sharded step against the JAX package's `ShardedSeaIceModel` on its
    K6 path (`use_fused_unstructured=True`, the Pallas kernel in interpret
    mode), the same inputs carried across with `convert.py`;
(b) the ring exchange against the all-gather, bitwise;
(c) the sphere with transport, sharded against the port's own
    single-device step (held against the JAX package by
    `test_torch_model.py`);
(d) K6's loop form against the JAX package's
    `build_unstructured_loop_solver` on one block."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaice_tpu.config import box_test_config as jbox_config
from seaice_tpu.parallel import ShardedSeaIceModel as JSharded
from seaice_tpu.testcases import box as jbox
from seaice_tpu_torch import config as tconfig
from seaice_tpu_torch.convert import (flatten_arrays,
                                      from_sharded_reference_arrays,
                                      to_stacked_arrays)
from seaice_tpu_torch.dynamics import cuda_unstructured as K
from seaice_tpu_torch.dynamics.evp import DynamicsForcing
from seaice_tpu_torch.model import SeaIceModel
from seaice_tpu_torch.parallel import ShardedSeaIceModel
from seaice_tpu_torch.testcases import box as tbox

torch.set_num_threads(1)
F64 = torch.float64

_JAX = {}


def _jax_box(n_shards):
    """The JAX package's sharded box step on its K6 path: the model, its
    inputs and its result (cached: (a) and (d) share the 4-block one)."""
    if n_shards not in _JAX:
        cfg = jbox_config(elastic_subcycles=4)
        cfg = dataclasses.replace(cfg, velocity=dataclasses.replace(
            cfg.velocity, use_fused_unstructured=True,
            use_pallas_subcycle=False))
        mesh = jbox.box_test_mesh(12, 12)
        mesh.f_vertex = jbox.box_coriolis_parameter(mesh)
        area, vol, snow = jbox.box_initial_state(mesh, n_categories=1)
        sm = JSharded(mesh, cfg, n_shards, dtype=jnp.float64)
        assert sm.use_fused_unstructured
        state = sm.init_state(area, vol, snow)
        forcing = sm.scatter_forcing(lambda m: jbox.box_forcing(m, t=0.0))
        out, _ = sm.make_step()(sm.tensors, sm.halo, state, forcing)
        _JAX[n_shards] = (sm, state, forcing, out)
    return _JAX[n_shards]


def _port_box(n_shards, halo_mode="ring"):
    mesh = tbox.box_test_mesh(12, 12)
    mesh.f_vertex = tbox.box_coriolis_parameter(mesh)
    return ShardedSeaIceModel(mesh, tconfig.box_test_config(4), n_shards,
                              dtype=F64, devices="cpu", halo_mode=halo_mode)


def _port_box_step(sm, jax_state, jax_forcing):
    states, forcings = from_sharded_reference_arrays(
        flatten_arrays(jax_state), "cpu", F64, flatten_arrays(jax_forcing))
    out, diags = sm.make_step()(sm.tensors, sm.halo, states, forcings)
    return out, diags


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_step_matches_reference(n_shards):
    jm, jstate, jforcing, jout = _jax_box(n_shards)
    sm = _port_box(n_shards)
    assert sm.halo_perms == jm.halo_perms
    out, diags = _port_box_step(sm, jstate, jforcing)
    assert len(out) == len(diags) == n_shards
    u, v = sm.gather_velocity(out)
    u_r, v_r = jm.gather_velocity(jout)
    assert np.abs(u_r).max() > 1e-3          # the ice moves
    np.testing.assert_allclose(u, u_r, atol=1e-12, rtol=1e-9)
    np.testing.assert_allclose(v, v_r, atol=1e-12, rtol=1e-9)
    tr, tr_r = sm.gather_tracers(out), jm.gather_tracers(jout)
    assert set(tr) == set(tr_r)
    for name in tr:
        np.testing.assert_allclose(tr[name], tr_r[name], atol=1e-13,
                                   rtol=1e-10, err_msg=name)
    # the stacked carry-back: every block's velocities and stresses
    stacked = to_stacked_arrays(out)
    ref = flatten_arrays(jout)
    for k in ("velocity.u_velocity", "velocity.v_velocity",
              "velocity.stress11", "velocity.solve_velocity_prev"):
        assert stacked[k].shape == ref[k].shape, k
        owned = sm.n_vertices_owned if "stress" not in k else sm.n_cells_owned
        np.testing.assert_allclose(stacked[k][:, :owned], ref[k][:, :owned],
                                   atol=1e-12 * max(1.0, np.abs(ref[k]).max()),
                                   rtol=1e-9, err_msg=k)


def test_ring_matches_allgather_bitwise():
    """On owned values: the modes differ only in padded halo slots (zero
    in the ring, export entry (0, 0) in the all-gather)."""
    _, jstate, jforcing, _ = _jax_box(4)
    outs = {}
    for mode in ("ring", "allgather"):
        sm = _port_box(4, mode)
        out, _ = _port_box_step(sm, jstate, jforcing)
        outs[mode] = (*sm.gather_velocity(out), sm.gather_tracers(out))
    for a, b in zip(outs["ring"][:2], outs["allgather"][:2]):
        assert np.array_equal(a, b)
    for k, a in outs["ring"][2].items():
        assert np.array_equal(a, outs["allgather"][2][k]), k
    # and on the padded slots they differ as the JAX package's do
    ring, gather = _port_box(4, "ring"), _port_box(4, "allgather")
    for s, (hr, hg) in enumerate(zip(ring.halo, gather.halo)):
        pad = hr.vertex_halo_color < 0
        n_exp = hr.vertex_export_idx.shape[0]
        assert bool((hr.vertex_halo_gather[pad] == 4 * n_exp).all())
        assert bool((hg.vertex_halo_gather[pad] == 0).all())
        assert torch.equal(hr.vertex_halo_gather[~pad],
                           hg.vertex_halo_gather[~pad])
    f = [torch.arange(1.0, 1.0 + b.mesh.n_vertices, dtype=F64)
         for b in ring.part.blocks]
    ring.exchange("vertex_field", [(x,) for x in f])
    nv = ring.n_vertices_owned
    for s, (x, h) in enumerate(zip(f, ring.halo)):
        pad = (h.vertex_halo_color < 0).nonzero().flatten()
        assert bool((x[nv + pad] == 0).all())


def _sphere_inputs(mesh):
    rng = np.random.default_rng(0)
    nc = mesh.n_cells
    polar = np.abs(mesh.lat_cell) > np.deg2rad(30.0)
    area = np.where(polar[:, None], rng.uniform(0.1, 0.45, (nc, 2)), 0.0)
    vol = area * rng.uniform(0.5, 2.0, (nc, 2))
    forcing = dict(
        u_air_velocity=5.0 * rng.standard_normal(nc),
        v_air_velocity=5.0 * rng.standard_normal(nc),
        air_density=np.full(nc, 1.3),
        u_ocean_velocity=0.05 * rng.standard_normal(nc),
        v_ocean_velocity=0.05 * rng.standard_normal(nc),
        sea_surface_tilt_u=np.zeros(nc), sea_surface_tilt_v=np.zeros(nc),
        land_ice_mask=np.zeros(nc))
    return area, vol, area * 0.1, forcing


def test_sharded_sphere_matches_single_device():
    """Icosahedral subdiv 2, metric terms, incremental remapping of the
    standard tracer tree, 4 blocks, two steps; every block edge crosses
    ice."""
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.transport.tracers import standard_tracer_tree
    mesh = icosahedral_mesh(2)
    cfg = tconfig.Config(
        run=tconfig.RunConfig(dt=1800.0, n_categories=2, n_ice_layers=2,
                              n_snow_layers=1),
        velocity=tconfig.VelocitySolverConfig(
            elastic_subcycle_number=6, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False),
        advection=tconfig.AdvectionConfig(),
        column=tconfig.ColumnConfig(use_column_package=False))
    tree = standard_tracer_tree(2, 1)
    area, vol, snow, f = _sphere_inputs(mesh)
    ref = SeaIceModel(mesh, cfg, F64, device="cpu", tracer_tree=tree)
    state = ref.init_state(area, vol, snow)
    forcing = DynamicsForcing(**{k: torch.as_tensor(v) for k, v in f.items()})
    step = ref.make_step()
    sm = ShardedSeaIceModel(mesh, cfg, 4, F64, devices="cpu",
                            tracer_tree=tree)
    sstate = sm.init_state(area, vol, snow)
    sforcing = sm.scatter_cell_tree(DynamicsForcing(**f))
    sstep = sm.make_step()
    for _ in range(2):
        state, _ = step(ref.tensors, state, forcing)
        sstate, _ = sstep(sm.tensors, sm.halo, sstate, sforcing)
    u, v = sm.gather_velocity(sstate)
    assert np.abs(u).max() > 1e-2
    np.testing.assert_allclose(u, state.velocity.u_velocity.numpy(),
                               atol=1e-11, rtol=1e-9)
    np.testing.assert_allclose(v, state.velocity.v_velocity.numpy(),
                               atol=1e-11, rtol=1e-9)
    tr = sm.gather_tracers(sstate)
    assert set(tr) == set(state.tracers) and len(tr) == 7
    for name, a in tr.items():
        r = state.tracers[name].numpy()
        np.testing.assert_allclose(a, r, atol=1e-11 * max(1.0, np.abs(r).max()),
                                   rtol=1e-9, err_msg=name)


def _loop_inputs(nc, nv, me, rng):
    def f(a):
        return torch.as_tensor(a)

    return (f(0.1 * rng.standard_normal(nv)), f(0.1 * rng.standard_normal(nv)),
            *(f(1e3 * rng.standard_normal((me, nc))) for _ in range(3)),
            f(rng.uniform(1e3, 1e4, nc)),
            f((rng.uniform(size=nc) > 0.1).astype(np.float64)),
            f(0.05 * rng.standard_normal(nv)), f(0.05 * rng.standard_normal(nv)),
            f(rng.uniform(500.0, 2000.0, nv)), f(0.2 * rng.standard_normal(nv)),
            f(0.1 * rng.standard_normal(nv)), f(0.1 * rng.standard_normal(nv)),
            f(0.05 * rng.standard_normal(nv)), f(0.05 * rng.standard_normal(nv)),
            f((rng.uniform(size=nv) > 0.15).astype(np.float64)),
            f(rng.uniform(0.1, 1.0, nv)))


def test_loop_form_matches_reference_and_whole_loop():
    """K6 on block 0 of the 4-block box: prepare, 3 x (step, identity
    exchange), finish against the JAX package's prepare / step1 / finish
    (interpret mode) to 1e-12 of each field's max; and bitwise against the
    port's own whole loop of 3 subcycles."""
    from seaice_tpu.dynamics.pallas_unstructured import (
        build_unstructured_loop_solver)
    jm = _jax_box(4)[0]
    sm = _port_box(4)
    cfg = sm.cfg
    kw = dict(dt_elastic=cfg.elastic_timestep,
              damping_timescale=cfg.evp_damping_timescale,
              include_metric=False)
    ft = sm.tensors[0].dynamics.fast
    me, nc = ft.voc_T.shape
    nv = ft.flat_corner_idx.shape[1]
    args = _loop_inputs(nc, nv, me, np.random.default_rng(4))

    loop = K.evp_subcycle_prepare(ft, *args, **kw)
    for _ in range(3):
        K.evp_subcycle_step(loop)
        # the exchange of a block alone is the identity
    got = K.evp_subcycle_finish(loop)
    whole = K.evp_subcycle_loop(ft, *args, n_subcycles=3, **kw)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)

    plan = jm.models[0].tensors.dynamics.unstructured
    prepare, step1, finish = build_unstructured_loop_solver(plan, **kw)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    carry, ctx = prepare(plan, *jargs)
    for _ in range(3):
        carry = step1(plan, carry, ctx)
    want = finish(plan, carry)
    for name, g, w in zip(("u", "v", "s11", "s22", "s12"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-12 * np.abs(w).max(), name
