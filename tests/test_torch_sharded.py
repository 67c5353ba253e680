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


def _hold_to_unsharded(label, sm, sstate, state):
    """Every block's state gathered against the unsharded state at JAX's
    limits; prints the distances."""
    u, v = sm.gather_velocity(sstate)
    tr = sm.gather_tracers(sstate)
    dist = {"u": float(np.abs(u - state.velocity.u_velocity.numpy()).max()),
            "v": float(np.abs(v - state.velocity.v_velocity.numpy()).max())}
    dist.update({k: float(np.abs(tr[k] - state.tracers[k].numpy()).max())
                 for k in TRACERS})
    print(f"{label}: max |sharded - unsharded| {dist}")
    assert np.abs(u).max() > 1e-3
    np.testing.assert_allclose(u, state.velocity.u_velocity.numpy(),
                               **U_LIMITS)
    np.testing.assert_allclose(v, state.velocity.v_velocity.numpy(),
                               **U_LIMITS)
    for k in TRACERS:
        np.testing.assert_allclose(tr[k], state.tracers[k].numpy(),
                                   err_msg=k, **TRACER_LIMITS)


def test_sharded_full_physics_matches_unsharded():
    """Each block runs the column on its own cells: two steps of the
    4-block step against the unsharded step, at JAX's own limits."""
    from seaice_tpu_torch.parallel.sharded import full_physics_inputs
    mesh, cfg = _full_physics_box()
    area, vol, snow, extra, atm, ocn, coszen = full_physics_inputs(
        mesh, cfg, F64, "cpu")
    ref = SeaIceModel(mesh, cfg, F64, device="cpu")
    state = ref.init_state(area, vol, snow)
    state = state.replace(tracers=dict(state.tracers, **extra))
    forcing = tbox.box_forcing(mesh, t=0.0, device="cpu")
    sm = ShardedSeaIceModel(mesh, cfg, 4, F64, devices="cpu")
    assert all(m.column is not None for m in sm.models)
    sstate = sm.init_state(area, vol, snow)
    ex = sm.scatter_cell_tree(extra)
    sstate = [st.replace(tracers=dict(st.tracers, **e))
              for st, e in zip(sstate, ex)]
    sforcing = sm.scatter_forcing(
        lambda m: tbox.box_forcing(m, t=0.0, device="cpu"))
    satm, socn = sm.scatter_cell_tree(atm), sm.scatter_cell_tree(ocn)
    scz = sm.scatter_cell_tree(coszen)
    step, sstep = ref.make_step(), sm.make_step()
    for _ in range(2):
        state, diags = step(ref.tensors, state, forcing, atm, ocn,
                            coszen=coszen)
        sstate, sdiags = sstep(sm.tensors, sm.halo, sstate, sforcing, satm,
                               socn, scz)
    assert all("column_fluxes" in d and "coupling_prep" in d
               for d in sdiags)
    _hold_to_unsharded("sharded full physics", sm, sstate, state)
    # the column did work: the ice is not where the dynamics alone put it
    assert float(np.abs(sm.gather_tracers(sstate)["iceEnthalpy"] -
                        sm.part.gather_cell_field(
                            np.stack([e["iceEnthalpy"].numpy() for e in ex]),
                            mesh.n_cells)).max()) > 1.0


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
