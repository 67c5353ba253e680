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
import os

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


def test_lockstep_makes_one_k6_call_per_subcycle_for_all_blocks(
        monkeypatch):
    """The sharded step advances every block's velocity solve by one
    subcycle in ONE call of the K6 wrapper, the loops in block order, once
    per elastic subcycle, and exchanges their velocities on one shared
    buffer bitwise as block by block; a block's solve driven alone
    (`drive`, the same call with one loop) equals the whole-loop solve
    bitwise."""
    from seaice_tpu_torch.dynamics import evp as tevp
    from seaice_tpu_torch.parallel import sharded
    _, jstate, jforcing, _ = _jax_box(4)
    sm = _port_box(4)
    calls = []

    def recording(*loops):
        calls.append([lp.ft for lp in loops])
        return K.evp_subcycle_step(*loops)

    monkeypatch.setattr(sharded, "evp_subcycle_step", recording)
    out, _ = _port_box_step(sm, jstate, jforcing)
    n_sub = sm.cfg.velocity.elastic_subcycle_number
    assert len(calls) == n_sub == 4
    for c in calls:
        assert len(c) == 4
        assert all(ft is t.dynamics.fast for ft, t in zip(c, sm.tensors))
    monkeypatch.undo()
    ref, _ = _port_box_step(sm, jstate, jforcing)
    for a, b in zip(sm.gather_velocity(out), sm.gather_velocity(ref)):
        assert np.array_equal(a, b)
    # the velocities' exchange on the loops' shared buffer (one gather, one
    # scatter) gives every block, halo entries included, what the exchange
    # block by block gives
    exchange = sm.exchange
    fast = []

    def by_block(kind, fields, halo=None, solve=None):
        fast.append(bool(solve))
        return exchange(kind, fields, halo)

    monkeypatch.setattr(sm, "exchange", by_block)
    slow, _ = _port_box_step(sm, jstate, jforcing)
    assert fast.count(True) >= n_sub
    a, b = to_stacked_arrays(ref), to_stacked_arrays(slow)
    for k in a:
        assert np.array_equal(a[k], b[k]), k

    states, forcings = from_sharded_reference_arrays(
        flatten_arrays(jstate), "cpu", F64, flatten_arrays(jforcing))
    tr, dyn = states[0].tracers, sm.tensors[0].dynamics
    args = (dyn, states[0].velocity, forcings[0], tr["iceAreaCategory"],
            tr["iceVolumeCategory"], tr["snowVolumeCategory"])
    alone, _ = tevp.make_velocity_solver(
        sm.cfg, halo_exchange_vertex=lambda u, v: (u, v))(*args)
    whole, _ = tevp.make_velocity_solver(sm.cfg)(*args)
    for k in ("u_velocity", "v_velocity", "stress11", "stress22",
              "stress12"):
        assert torch.equal(getattr(alone, k), getattr(whole, k)), k


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


# -- the sharded step with the column physics ---------------------------------

def _full_physics_box(nx=10, n_sub=2):
    """`tests/test_sharded.py`'s 'base' case: the 10 x 10 box, 5
    categories, 7 layers, mushy thermodynamics, dEdd, level ponds,
    Rothrock strength, ridging; 2 subcycles."""
    cfg = tconfig.Config(
        run=tconfig.RunConfig(dt=1800.0, n_categories=5, n_ice_layers=7),
        velocity=tconfig.VelocitySolverConfig(
            elastic_subcycle_number=n_sub, rotate_cartesian_grid=False,
            include_metric_terms=False, geostrophic_surface_tilt=False),
        advection=tconfig.AdvectionConfig(),
        column=tconfig.ColumnConfig(ktherm=2, shortwave="dEdd",
                                    pond_scheme="lvl", kstrength=1))
    mesh = tbox.box_test_mesh(nx, nx)
    mesh.f_vertex = tbox.box_coriolis_parameter(mesh)
    return mesh, cfg


# JAX's own limits for the sharded full-physics step
# (`tests/test_sharded.py::test_sharded_full_physics_matches_single_device`)
U_LIMITS = dict(atol=1e-8, rtol=1e-6)
TRACER_LIMITS = dict(atol=1e-7, rtol=1e-5)
TRACERS = ("iceAreaCategory", "iceVolumeCategory", "surfaceTemperature",
           "iceSalinity", "iceEnthalpy", "pondArea", "pondDepth",
           "levelIceArea")


def _hold_to_unsharded(label, sm, sstate, state, tracers=TRACERS):
    """Every block's state gathered against the unsharded state at JAX's
    limits; prints the distances."""
    u, v = sm.gather_velocity(sstate)
    tr = sm.gather_tracers(sstate)
    dist = {"u": float(np.abs(u - state.velocity.u_velocity.numpy()).max()),
            "v": float(np.abs(v - state.velocity.v_velocity.numpy()).max())}
    dist.update({k: float(np.abs(tr[k] - state.tracers[k].numpy()).max())
                 for k in tracers})
    print(f"{label}: max |sharded - unsharded| {dist}")
    assert np.abs(u).max() > 1e-3
    np.testing.assert_allclose(u, state.velocity.u_velocity.numpy(),
                               **U_LIMITS)
    np.testing.assert_allclose(v, state.velocity.v_velocity.numpy(),
                               **U_LIMITS)
    for k in tracers:
        np.testing.assert_allclose(tr[k], state.tracers[k].numpy(),
                                   err_msg=k, **TRACER_LIMITS)


def _sharded_full_physics(mesh, cfg, n_shards, n_steps, faero=None):
    """n_steps of the unsharded and the n_shards-block full-physics step
    from the same `full_physics_inputs` (with the aerosol deposition
    faero [nCells, nAero], numpy, where given): (sm, sstate, sdiags,
    state, ex), ex the blocks' initial thermodynamic tracers."""
    from seaice_tpu_torch.parallel.sharded import full_physics_inputs
    area, vol, snow, extra, atm, ocn, coszen = full_physics_inputs(
        mesh, cfg, F64, "cpu")
    ref = SeaIceModel(mesh, cfg, F64, device="cpu")
    state = ref.init_state(area, vol, snow)
    state = state.replace(tracers=dict(state.tracers, **extra))
    forcing = tbox.box_forcing(mesh, t=0.0, device="cpu")
    sm = ShardedSeaIceModel(mesh, cfg, n_shards, F64, devices="cpu")
    assert all(m.column is not None for m in sm.models)
    sstate = sm.init_state(area, vol, snow)
    ex = sm.scatter_cell_tree(extra)
    sstate = [st.replace(tracers=dict(st.tracers, **e))
              for st, e in zip(sstate, ex)]
    sforcing = sm.scatter_forcing(
        lambda m: tbox.box_forcing(m, t=0.0, device="cpu"))
    satm, socn = sm.scatter_cell_tree(atm), sm.scatter_cell_tree(ocn)
    scz = sm.scatter_cell_tree(coszen)
    fa = None if faero is None else torch.as_tensor(faero)
    sfa = None if faero is None else sm.scatter_cell_tree(fa)
    step, sstep = ref.make_step(), sm.make_step()
    for _ in range(n_steps):
        state, diags = step(ref.tensors, state, forcing, atm, ocn,
                            coszen=coszen, faero_atm=fa)
        sstate, sdiags = sstep(sm.tensors, sm.halo, sstate, sforcing, satm,
                               socn, scz, faero_atm=sfa)
    assert all("column_fluxes" in d and "coupling_prep" in d
               for d in sdiags)
    return sm, sstate, sdiags, state, ex


def test_sharded_full_physics_matches_unsharded():
    """Each block runs the column on its own cells: two steps of the
    4-block step against the unsharded step, at JAX's own limits."""
    mesh, cfg = _full_physics_box()
    sm, sstate, _, state, ex = _sharded_full_physics(mesh, cfg, 4, 2)
    _hold_to_unsharded("sharded full physics", sm, sstate, state)
    # the column did work: the ice is not where the dynamics alone put it
    assert float(np.abs(sm.gather_tracers(sstate)["iceEnthalpy"] -
                        sm.part.gather_cell_field(
                            np.stack([e["iceEnthalpy"].numpy() for e in ex]),
                            mesh.n_cells)).max()) > 1.0


def test_sharded_highfreq_snow_matches_unsharded():
    """High-frequency coupling with the snow tracers, ITDrdg snow
    redistribution and form drag in 2 blocks: each block takes its cell
    velocities from its own vertices, which the previous step's last
    exchange refreshed, so three steps (the second and third see moving
    ice) match the unsharded step at JAX's own limits, the snow tracers
    included."""
    mesh, cfg = _full_physics_box()
    cfg = dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, highfreq=True, use_snow_tracers=True,
        snwredist="ITDrdg", use_form_drag=True))
    sm, sstate, sdiags, state, _ = _sharded_full_physics(mesh, cfg, 2, 3)
    _hold_to_unsharded("sharded highfreq + snow", sm, sstate, state,
                       TRACERS + ("snowVolumeCategory", "snowIceMass",
                                  "snowLiquidMass", "snowGrainRadius"))
    assert all("redist_fresh" in d["coupling_prep"] for d in sdiags)
    # the cell velocity of every local cell (halo cells included) is the
    # one the whole mesh gives: its vertices' velocities are current
    from seaice_tpu_torch.mesh.core import vertex_to_cell
    u, _ = sm.gather_velocity(sstate)
    u_cell = vertex_to_cell(mesh.tensors(F64, "cpu"), torch.as_tensor(u))
    for s, b in enumerate(sm.part.blocks):
        ok = b.cell_global >= 0
        got = vertex_to_cell(sm.tensors[s].mesh,
                             sstate[s].velocity.u_velocity)[
                                 torch.as_tensor(ok)]
        np.testing.assert_allclose(got.numpy(),
                                   u_cell[b.cell_global[ok]].numpy(),
                                   rtol=0, atol=1e-15)
    assert float(sm.gather_tracers(sstate)["snowGrainRadius"].max()) > \
        54.526


def test_sharded_zbgc_zaero_matches_unsharded():
    """The vertical zBGC on the full roster (3 algal classes, every pool)
    with 3 z-layer aerosol bins and seeded deposition in 2 blocks: two
    steps against the unsharded step at JAX's own limits, the brine
    height, the bio tracers and their mobile fractions included; the
    BGC diagnostics of every block are there."""
    from seaice_tpu_torch.column.zbgc import ZbgcParams
    mesh, cfg = _full_physics_box()
    zp = ZbgcParams(n_algae=3, use_C=True, use_DON=True, use_Fe=True,
                    use_DMS=True, use_PON=True, use_hum=True,
                    use_zaero=True, n_zaero=3)
    cfg = dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, use_biogeochemistry=True, zbgc_params=zp))
    faero = np.random.default_rng(4).uniform(0.0, 1e-9, (mesh.n_cells, 3))
    sm, sstate, sdiags, state, _ = _sharded_full_physics(mesh, cfg, 2, 2,
                                                         faero)
    _hold_to_unsharded("sharded zBGC + z-aerosols", sm, sstate, state,
                       TRACERS + ("brineHeight", "bioTracers",
                                  "bioMobileFraction"))
    assert all({"flux_bio", "bgc_carbon_error"} <=
               set(d["column_fluxes"].bgc) for d in sdiags)
    assert float(sm.gather_tracers(sstate)["bioTracers"].max()) > 1.0


def _runner_forcing(mesh):
    from seaice_tpu_torch.forcing.core import (CoreAtmosForcing,
                                               ForcingSeries,
                                               NcarOceanForcing,
                                               constant_series,
                                               monthly_times)
    nc = mesh.n_cells
    rng = np.random.default_rng(7)
    six = ForcingSeries(
        times=np.array([0.0, 21600.0]),
        fields={"airTemperature": rng.uniform(245.0, 260.0, (2, nc)),
                "airSpecificHumidity": np.full((2, nc), 4e-4),
                "uAirVelocity": rng.uniform(2.0, 6.0, (2, nc)),
                "vAirVelocity": rng.uniform(-2.0, 2.0, (2, nc))})
    mon = ForcingSeries(
        times=monthly_times(),
        fields={"cloudFraction": rng.uniform(0.2, 0.8, (12, nc)),
                "precipitationRate": np.full((12, nc), 1e-6)})
    atmos = CoreAtmosForcing(six_hourly=six, monthly=mon,
                             lon=mesh.lon_cell, lat=mesh.lat_cell)
    ocean = NcarOceanForcing(monthly=constant_series(
        nc, seaSurfaceTemperature=-1.7, seaSurfaceSalinity=34.0,
        seaFreezingTemperature=-1.8, oceanMixedLayerDepth=20.0,
        uOceanVelocity=0.0, vOceanVelocity=0.0))
    return atmos, ocean


def test_sharded_runner_matches_runner(tmp_path):
    """ShardedStandaloneRunner (raw records scattered to the blocks, the
    derived forcing per block) against StandaloneRunner: two full-physics
    steps, at JAX's limits; its per-block restart reads back bitwise."""
    from seaice_tpu_torch.io import (ShardedOutputStream, assemble_history,
                                     load_sharded_checkpoint,
                                     read_restart_timestamp)
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.run import (RunStreams, ShardedStandaloneRunner,
                                      StandaloneRunner)
    mesh, cfg = _full_physics_box()
    mesh.lat_cell = np.deg2rad(np.linspace(70.0, 85.0, mesh.n_cells))
    mesh.lon_cell = np.linspace(0.0, 1.0, mesh.n_cells)
    atmos, ocean = _runner_forcing(mesh)
    setup = RunSetup(initial_latitude_north=60.0)
    ref = SeaIceModel(mesh, cfg, F64, device="cpu")
    state = initial_state_from_setup(ref, setup)
    r = StandaloneRunner(ref, state, atmos_forcing=atmos,
                         ocean_forcing=ocean)
    sm = ShardedSeaIceModel(mesh, cfg, 4, F64, devices="cpu")
    arrays = {k: t.numpy() for k, t in state.tracers.items()}
    sstate = [st.replace(tracers=t) for st, t in
              zip(sm.init_state(), sm.scatter_cell_tree(arrays))]
    out = ShardedOutputStream(str(tmp_path), "history", sm.part,
                              mesh.n_cells, mesh.n_vertices)
    sr = ShardedStandaloneRunner(
        sm, sstate, atmos_forcing=atmos, ocean_forcing=ocean,
        streams=RunStreams(output=out, output_interval=1800.0,
                           restart_dir=str(tmp_path),
                           restart_interval=2 * 1800.0))
    r.run(2)
    sr.run(2)
    _hold_to_unsharded("sharded runner", sm, sr.state, r.state)
    out.flush()
    hist, xtime = assemble_history(str(tmp_path), "history")
    assert xtime == ["0001-01-01_00:30:00", "0001-01-01_01:00:00"]
    np.testing.assert_array_equal(hist["iceAreaCell"][1], torch.as_tensor(
        sm.gather_tracers(sr.state)["iceAreaCategory"]).sum(-1).numpy())
    ts = read_restart_timestamp(str(tmp_path))
    assert ts == "0001-01-01_01:00:00"
    back, clock = load_sharded_checkpoint(str(tmp_path), f"restart.{ts}",
                                          sm.part, sm.init_state(),
                                          device="cpu")
    assert clock == {"year": 1, "seconds": 3600.0}
    got, want = to_stacked_arrays(back), to_stacked_arrays(sr.state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sharded_runner_abort_gate(tmp_path):
    """The sharded runner runs the state check of the unpartitioned one
    on every block: a non-finite ice area in one block stops the run
    with SeaIceAbort after the step, and the abort dump is written in the
    per-block layout, with the failed checks in its manifest, and reads
    back."""
    from seaice_tpu_torch.error import SeaIceAbort
    from seaice_tpu_torch.io import load_sharded_checkpoint
    from seaice_tpu_torch.run import RunStreams, ShardedStandaloneRunner
    sm = _port_box(4)
    rng = np.random.default_rng(4)
    area = rng.uniform(0.2, 0.9, (sm.global_mesh.n_cells, 1))
    states = sm.init_state(area, area * 1.5, area * 0.1)
    bad = states[2].tracers["iceAreaCategory"].clone()
    bad[0, 0] = float("nan")
    states[2] = states[2].replace(tracers=dict(states[2].tracers,
                                               iceAreaCategory=bad))
    runner = ShardedStandaloneRunner(
        sm, states, streams=RunStreams(restart_dir=str(tmp_path)))
    with pytest.raises(SeaIceAbort, match="finite_area") as ei:
        runner.run(1)
    name = os.path.basename(ei.value.dump_path)
    assert name == "abort.0001-01-01_00:10:00"      # dt 600 s
    back, meta = load_sharded_checkpoint(str(tmp_path), name, sm.part,
                                         sm.init_state(), device="cpu")
    assert "finite_area" in meta["failed_checks"]
    assert meta["seconds"] == 600.0
    got, want = sm.gather_tracers(back), sm.gather_tracers(runner.state)
    assert np.isnan(want["iceAreaCategory"]).any()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for g, w in zip(sm.gather_velocity(back),
                    sm.gather_velocity(runner.state)):
        np.testing.assert_array_equal(g, w)


def test_reference_sharded_checkpoint_loads_bitwise(tmp_path):
    """A sharded restart written by the JAX package (its stacked state)
    loads into the port's blocks bitwise, halos included; the port's
    own writes the same part files (bitwise), and `assemble_checkpoint`
    gives the global fields."""
    from seaice_tpu.io.parallel import save_sharded_checkpoint as jsave
    from seaice_tpu.parallel import ShardedSeaIceModel as JSharded
    from seaice_tpu_torch.io import (assemble_checkpoint,
                                     load_sharded_checkpoint,
                                     save_sharded_checkpoint)
    mesh = jbox.box_test_mesh(12, 12)
    mesh.f_vertex = jbox.box_coriolis_parameter(mesh)
    jm = JSharded(mesh, jbox_config(elastic_subcycles=2), 4,
                  dtype=jnp.float64)
    rng = np.random.default_rng(9)
    area = rng.uniform(0.0, 1.0, (mesh.n_cells, 1))
    jstate = jm.init_state(area, area * 2.0, area * 0.1)
    jsave(str(tmp_path / "j"), "restart", jstate, jm.part, mesh.n_cells,
          mesh.n_vertices, clock_metadata={"year": 1, "seconds": 60.0})
    sm = _port_box(4)
    states, clock = load_sharded_checkpoint(
        str(tmp_path / "j"), "restart", sm.part, sm.init_state(),
        device="cpu")
    assert clock == {"year": 1, "seconds": 60.0}
    got, want = to_stacked_arrays(states), flatten_arrays(jstate)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    save_sharded_checkpoint(str(tmp_path / "p"), "restart", states,
                            sm.part, mesh.n_cells, mesh.n_vertices,
                            clock_metadata={"year": 1, "seconds": 60.0})
    for s in range(4):
        name = f"restart.part-{s:04d}.npz"
        with np.load(tmp_path / "j" / name) as a, \
                np.load(tmp_path / "p" / name) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    glob_, _ = assemble_checkpoint(str(tmp_path / "p"), "restart")
    np.testing.assert_array_equal(glob_["tracers.iceAreaCategory"], area)


def _variant_sphere_cfg(c, variant, advection=None):
    vel = {"revised_evp": dict(
        constitutive_relation=c.ConstitutiveRelation.EVP_REVISED),
        "weak": dict(strain_scheme=c.StrainScheme.WEAK,
                     stress_divergence_scheme=(
                         c.StressDivergenceScheme.WEAK))}[variant]
    return c.Config(
        run=c.RunConfig(dt=1800.0, n_categories=2, n_ice_layers=2,
                        n_snow_layers=1),
        velocity=c.VelocitySolverConfig(
            elastic_subcycle_number=6, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False,
            **vel),
        advection=advection or c.AdvectionConfig(),
        column=c.ColumnConfig(use_column_package=False))


@pytest.mark.parametrize("variant", ["revised_evp", "weak"])
def test_sharded_variants_match_unsharded(variant):
    """A solver variant on 2 blocks of the subdiv-2 sphere with
    incremental remapping, two steps, against the port's unsharded step:
    each block runs the variant's plain loop (no K6 call) with the vertex
    halo exchanged after every subcycle, revised EVP with the global
    minimum edge length.  Measured on the CPU: u, v bitwise, the tracers
    within 2.7e-16 of their max (the remap's one-ulp block-edge rounding,
    ROADMAP Queue 3, fault 3); held at the sphere test's limits (u, v
    1e-11 absolute, tracers 1e-11 of their max)."""
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.parallel import sharded
    from seaice_tpu_torch.transport.tracers import standard_tracer_tree
    mesh = icosahedral_mesh(2)
    cfg = _variant_sphere_cfg(tconfig, variant)
    tree = standard_tracer_tree(2, 1)
    area, vol, snow, f = _sphere_inputs(mesh)
    ref = SeaIceModel(mesh, cfg, F64, device="cpu", tracer_tree=tree)
    state = ref.init_state(area, vol, snow)
    forcing = DynamicsForcing(**{k: torch.as_tensor(v) for k, v in f.items()})
    step = ref.make_step()
    sm = ShardedSeaIceModel(mesh, cfg, 2, F64, devices="cpu",
                            tracer_tree=tree)
    assert sm.part.min_dv_edge == float(mesh.dv_edge[mesh.dv_edge > 0].min())
    sstate = sm.init_state(area, vol, snow)
    sforcing = sm.scatter_cell_tree(DynamicsForcing(**f))
    calls = []
    real = sharded.evp_subcycle_step
    sharded.evp_subcycle_step = lambda *a: calls.append(a) or real(*a)
    try:
        sstep = sm.make_step()
        for _ in range(2):
            state, _ = step(ref.tensors, state, forcing)
            sstate, _ = sstep(sm.tensors, sm.halo, sstate, sforcing)
    finally:
        sharded.evp_subcycle_step = real
    assert calls == []
    u, v = sm.gather_velocity(sstate)
    assert np.abs(u).max() > 1e-2
    np.testing.assert_allclose(u, state.velocity.u_velocity.numpy(),
                               atol=1e-11, rtol=0)
    np.testing.assert_allclose(v, state.velocity.v_velocity.numpy(),
                               atol=1e-11, rtol=0)
    tr = sm.gather_tracers(sstate)
    for name, a in tr.items():
        r = state.tracers[name].numpy()
        np.testing.assert_allclose(
            a, r, atol=1e-11 * max(1.0, np.abs(r).max()), rtol=0,
            err_msg=name)


def test_sharded_upwind_raises():
    """Upwind advection on the partitioned mesh raises, naming the
    reference's fault (ROADMAP Queue 3, fault 10): the port does not copy
    a sharded step that drops transport."""
    from seaice_tpu_torch.mesh import icosahedral_mesh
    cfg = _variant_sphere_cfg(tconfig, "revised_evp", tconfig.AdvectionConfig(
        advection_type=tconfig.AdvectionType.UPWIND))
    with pytest.raises(ValueError, match="Queue 3, fault 10"):
        ShardedSeaIceModel(icosahedral_mesh(2), cfg, 2, F64, devices="cpu")


def test_reference_sharded_step_skips_upwind_transport():
    """The witness of Queue 3 fault 10: under upwind advection the JAX
    package's sharded step leaves `iceAreaCategory` where it was, where
    its unsharded step moves it."""
    from seaice_tpu import config as jconfig
    from seaice_tpu.dynamics.evp import DynamicsForcing as JForcing
    from seaice_tpu.mesh import icosahedral_mesh
    from seaice_tpu.model import SeaIceModel as JModel
    mesh = icosahedral_mesh(2)
    cfg = _variant_sphere_cfg(jconfig, "revised_evp", jconfig.AdvectionConfig(
        advection_type=jconfig.AdvectionType.UPWIND))
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, n_categories=1))
    area, vol, snow, f = _sphere_inputs(mesh)
    area, vol, snow = area[:, :1], vol[:, :1], snow[:, :1]
    forcing = JForcing(**{k: jnp.asarray(v) for k, v in f.items()})
    ref = JModel(mesh, cfg, dtype=jnp.float64, build_unstructured=False)
    out, _ = ref.make_step()(ref.tensors, ref.init_state(area, vol, snow),
                             forcing)
    moved = np.abs(np.asarray(out.tracers["iceAreaCategory"]) - area).max()
    sm = JSharded(mesh, cfg, 2, dtype=jnp.float64)
    sout, _ = sm.make_step()(sm.tensors, sm.halo,
                             sm.init_state(area, vol, snow),
                             sm.scatter_cell_tree(forcing))
    u, _ = sm.gather_velocity(sout)
    assert np.abs(u).max() > 1e-2                  # the ice moves
    assert moved > 1e-5                            # unsharded: transport
    assert np.array_equal(sm.gather_tracers(sout)["iceAreaCategory"],
                          area)                    # sharded: none


# -- the partitioned model across ranks -----------------------------------
#
# One gloo group of two ranks runs every case of `torch_rank_cases.py`
# (each rank its blocks, the gathers collective); the same functions run
# here, in one process, as the reference they are held to bitwise.

import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import torch_rank_cases as rank_cases  # noqa: E402

WORLD = 2


class _Ranks:
    """The two ranks, started at once; `result(case)` waits for a case's
    files of both ranks and fails the test where a rank failed or the
    wait passes its limit."""

    def __init__(self, out):
        self.out = str(out)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))),
            GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
        script = os.path.abspath(rank_cases.__file__)
        self.logs = [open(os.path.join(self.out, f"log.rank{r}.txt"), "w")
                     for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, script, str(r), str(WORLD),
             os.path.join(self.out, "rendezvous"), self.out],
            env=env, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self.logs)]

    def result(self, case, limit=120.0):
        paths = [os.path.join(self.out, f"{case}.rank{r}.npz")
                 for r in range(WORLD)]
        t0 = time.monotonic()
        while not all(os.path.exists(p) for p in paths):
            failed = [r for r, p in enumerate(self.procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() - t0 > limit:
                self.stop()
                logs = "".join(open(log.name).read() for log in self.logs)
                pytest.fail(f"ranks {failed or 'timed out'} before "
                            f"{case!r}:\n{logs[-4000:]}")
            time.sleep(0.02)
        return [dict(np.load(p)) for p in paths]

    def stop(self):
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for log in self.logs:
            log.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = _Ranks(tmp_path_factory.mktemp("ranks"))
    yield run
    run.stop()
    assert all(p.returncode == 0 for p in run.procs)


def _one_process(case, workdir=None):
    """The case run here, in one process."""
    return dict(rank_cases.cases(str(workdir))).get(case)()


def _bitwise(got, want, keys=None):
    """Both ranks' results equal the one-process run's, bitwise (a rank
    holds the halo fields of its own blocks only)."""
    for r, g in enumerate(got):
        for k in (keys or want):
            if k in g:
                np.testing.assert_array_equal(g[k], want[k],
                                              err_msg=f"rank {r}: {k}")
    halos = {k for g in got for k in g if k.startswith("halo_field.")}
    assert halos == {k for k in want if k.startswith("halo_field.")}


def _hold_box_to_reference(got, jm, jout):
    u_r, v_r = jm.gather_velocity(jout)
    assert np.abs(u_r).max() > 1e-3
    np.testing.assert_allclose(got["u"], u_r, atol=1e-12, rtol=1e-9)
    np.testing.assert_allclose(got["v"], v_r, atol=1e-12, rtol=1e-9)
    for name, a in jm.gather_tracers(jout).items():
        np.testing.assert_allclose(got["tracer." + name], a, atol=1e-13,
                                   rtol=1e-10, err_msg=name)


@pytest.mark.parametrize("mode", ["ring", "allgather"])
def test_ranks_box_match_reference_and_one_process(ranks, mode):
    """The 12 x 12 box in 4 blocks on 2 ranks of a gloo group: against the
    JAX package's sharded step at `test_sharded_step_matches_reference`'s
    limits, and bitwise the one-process port, the halo slots of a
    refreshed vertex field included (zero in a padded slot of the ring,
    entry (0, 0) in the all-gather's)."""
    want = _one_process(f"box4_{mode}")
    jm, _, _, jout = _jax_box(4)
    got = ranks.result(f"box4_{mode}")
    _bitwise(got, want)
    _hold_box_to_reference(got[0], jm, jout)


def test_ranks_two_blocks_match_reference(ranks):
    """2 blocks on 2 ranks: one block a rank, every halo row across the
    group."""
    want = _one_process("box2")
    jm, _, _, jout = _jax_box(2)
    got = ranks.result("box2")
    _bitwise(got, want)
    _hold_box_to_reference(got[0], jm, jout)


def test_ranks_overlap_matches_reference(ranks):
    """The interior/boundary overlap on 2 ranks (the 16 x 16 box, 8
    subcycles, 4 blocks, 3 steps): every subcycle overlapped, against the
    JAX package's `ShardedSeaIceModel(overlap=True)` to 1e-12 of max |u|
    (`tests/test_sharded.py::test_overlap_matches_no_overlap`'s limit),
    and bitwise the one-process overlap."""
    cfg = jbox_config(elastic_subcycles=8)
    mesh = jbox.box_test_mesh(16, 16)
    mesh.f_vertex = jbox.box_coriolis_parameter(mesh)
    jm = JSharded(mesh, cfg, 4, dtype=jnp.float64, overlap=True)
    assert jm.overlap_enabled and not jm.use_fused_unstructured
    jstate = jm.init_state(*jbox.box_initial_state(mesh, n_categories=1))
    jforcing = jm.scatter_forcing(lambda m: jbox.box_forcing(m, t=0.0))
    jstep = jm.make_step()
    for _ in range(3):
        jstate, _ = jstep(jm.tensors, jm.halo, jstate, jforcing)
    want = _one_process("overlap")
    got = ranks.result("overlap")
    _bitwise(got, want)
    assert int(got[0]["overlapped_subcycles"]) == 3 * 8
    u_r, v_r = jm.gather_velocity(jstate)
    scale = np.abs(u_r).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got[0]["u"], u_r, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(got[0]["v"], v_r, rtol=0, atol=1e-12 * scale)
    for name, a in jm.gather_tracers(jstate).items():
        np.testing.assert_allclose(got[0]["tracer." + name], a, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("variant", ["weak", "metric", "revised"])
def test_overlap_enabled_as_reference(variant):
    """`overlap_enabled` is the JAX package's decision: off for the weak
    scheme, metric terms and revised EVP (and on for the box's standard
    EVP, `test_ranks_overlap_matches_reference`)."""
    from seaice_tpu import config as jconfig
    vel = {"weak": lambda c: dict(
        strain_scheme=c.StrainScheme.WEAK,
        stress_divergence_scheme=c.StressDivergenceScheme.WEAK),
        "metric": lambda c: dict(include_metric_terms=True),
        "revised": lambda c: dict(
            constitutive_relation=c.ConstitutiveRelation.EVP_REVISED),
    }[variant]
    got = {}
    for pkg, box_pkg, Model, kw in (
            (jconfig, jbox, JSharded, dict(dtype=jnp.float64)),
            (tconfig, tbox, ShardedSeaIceModel,
             dict(dtype=F64, devices="cpu"))):
        cfg = pkg.box_test_config(elastic_subcycles=2)
        cfg = dataclasses.replace(cfg, velocity=dataclasses.replace(
            cfg.velocity, **vel(pkg)))
        got[pkg is jconfig] = Model(box_pkg.box_test_mesh(8, 8), cfg, 2,
                                    overlap=True, **kw).overlap_enabled
    assert got[False] is got[True] is False


def test_ranks_sphere_with_column_bitwise(ranks):
    """The subdiv-2 sphere with the column (metric terms, remap, ridging)
    in 4 blocks on 2 ranks, 2 steps: bitwise the one-process run."""
    want = _one_process("sphere_column")
    got = ranks.result("sphere_column")
    assert np.abs(want["u"]).max() > 1e-3
    assert np.abs(want["ridge_convergence"]).max() > 0
    _bitwise(got, want)


def test_ranks_runner_checkpoint_bitwise(ranks, tmp_path):
    """ShardedStandaloneRunner on 2 ranks, 2 full-physics steps: each
    rank writes its blocks' restart and history parts and reads its
    blocks' restart back bitwise; the assembled restart and history, and
    the state, equal the one-process run's."""
    want = _one_process("runner", tmp_path)
    got = ranks.result("runner")
    assert set(got[0]) == set(want)
    _bitwise(got, want)
    for g in got:
        assert len(g["blocks_read_back_differ"]) == 0
        assert float(g["clock_seconds"]) == 3600.0
    assert "restart.tracers.iceAreaCategory" in want


def test_ranks_coupled_driver_bitwise(ranks):
    """ShardedCoupledDriver on 2 ranks, one interval: every rank returns
    the export of the one-process driver, bitwise."""
    want = _one_process("coupled")
    got = ranks.result("coupled")
    assert set(got[0]) == set(want) and len(want) > 10
    _bitwise(got, want)


def test_ranks_abort_gate_takes_one_branch(ranks, tmp_path):
    """A non-finite ice area in one rank's block stops every rank: the
    state-check flags are max-reduced across ranks before the abort gate,
    each rank writes its blocks' abort dump and reads them back, as the
    one-process runner does."""
    want = _one_process("abort", tmp_path)
    got = ranks.result("abort")
    assert "finite_area" in str(want["message"])
    for g in got:
        assert str(g["message"]).startswith(
            "critical state-check failure at 0001-01-01_00:10:00")
        assert "finite_area" in g["failed_checks"].tolist()
    _bitwise(got, want, ["area", "failed_checks"])
    assert np.isnan(want["area"]).any()


def test_ranks_dryrun_multichip_bitwise(ranks):
    """`entry_torch.dryrun_multichip(4)` on 2 ranks (the overlap on, every
    subcycle under it): each rank's blocks bitwise the one-process run
    with the overlap."""
    want = _one_process("dryrun")
    got = ranks.result("dryrun")
    assert int(want["overlapped_subcycles"]) > 0
    blocks = set()
    for g in got:
        assert int(g["overlapped_subcycles"]) == int(
            want["overlapped_subcycles"])
        keys = [k for k in g if k.startswith("block")]
        blocks |= {k.split(".")[0] for k in keys}
        _bitwise([{k: g[k] for k in keys}], want)
    assert blocks == {f"block{s}" for s in range(4)}


def test_ranks_analysis_member_writes_on_rank_zero(ranks, tmp_path):
    """ShardedStandaloneRunner with one analysis member on 2 ranks: the
    member's results, computed on the collective gathers, equal the
    one-process run's on both ranks, bitwise; only rank 0 writes."""
    want = _one_process("analysis", tmp_path)
    got = ranks.result("analysis")
    assert int(want["records_written"]) == 1
    assert float(want["member.total_ice_area"][0]) > 0
    members = [k for k in want if k.startswith("member.")]
    _bitwise(got, want, members)
    assert all(set(members) <= set(g) for g in got)
    assert [int(g["records_written"]) for g in got] == [1, 0]


def test_ranks_world_size_must_divide_blocks(ranks):
    """3 blocks on 2 ranks raise ValueError; one process naming two
    distinct devices raises ValueError asking for one process per
    card."""
    for g in ranks.result("indivisible"):
        assert "multiple of the world size" in str(g["message"])
    mesh = tbox.box_test_mesh(8, 8)
    with pytest.raises(ValueError, match="one process per card"):
        ShardedSeaIceModel(mesh, tconfig.box_test_config(2), 2, F64,
                           devices=["cpu", "meta"])


def test_overlap_raises_where_the_reference_mixes_drag_laws():
    """Linear ocean drag with `overlap=True`: the JAX package enables its
    overlap and drags the export vertices quadratically (ROADMAP Queue 3,
    fault 18); the port raises ValueError naming the fault, and builds
    without the overlap."""
    cfg = tconfig.box_test_config(2)
    cfg = dataclasses.replace(cfg, velocity=dataclasses.replace(
        cfg.velocity, ocean_stress_type=tconfig.OceanStressType.LINEAR))
    mesh = tbox.box_test_mesh(8, 8)
    with pytest.raises(ValueError, match="fault 18"):
        ShardedSeaIceModel(mesh, cfg, 2, F64, devices="cpu", overlap=True)
    assert not ShardedSeaIceModel(mesh, cfg, 2, F64,
                                  devices="cpu").overlap_enabled
