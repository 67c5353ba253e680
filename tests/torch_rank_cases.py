"""The partitioned model's cases across ranks, float64 on the CPU: each
case builds its model with no group named, so that it runs in one
process where no process group is initialised (the reference) and on
every rank of the group where one is (`ShardedSeaIceModel(group=None)`).
Each returns its results as numpy arrays, the whole fields on every rank
(the model's gathers are collective).  It imports torch, numpy and the
port, never JAX.

Run as a rank of a gloo group (`tests/test_torch_sharded.py` starts two):

    python tests/torch_rank_cases.py RANK WORLD RENDEZVOUS_FILE OUTDIR

Each rank writes OUTDIR/<case>.rank<RANK>.npz after each case, and
OUTDIR/error.rank<RANK>.txt with the traceback if one fails."""

import dataclasses
import datetime
import os
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from seaice_tpu_torch import config as C  # noqa: E402
from seaice_tpu_torch.parallel import ShardedSeaIceModel  # noqa: E402
from seaice_tpu_torch.testcases import box  # noqa: E402

F64 = torch.float64


def _fields(sm, states):
    u, v = sm.gather_velocity(states)
    return dict(u=u, v=v, **{"tracer." + k: a for k, a in
                             sm.gather_tracers(states).items()})


def _box_model(nx, n_sub, n_shards, **kw):
    mesh = box.box_test_mesh(nx, nx)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    sm = ShardedSeaIceModel(mesh, C.box_test_config(n_sub), n_shards,
                            dtype=F64, devices="cpu", **kw)
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    return sm, sm.init_state(area, vol, snow), sm.scatter_forcing(
        lambda m: box.box_forcing(m, t=0.0, device="cpu"))


def box_steps(nx=12, n_sub=4, n_shards=4, n_steps=1, **kw):
    """`test_sharded_step_matches_reference`'s box (the JAX test's), the
    subcycles run under the overlap counted; then the halo of a vertex
    field refreshed (results "halo_field.<block>", of the rank's blocks
    only)."""
    sm, state, forcing = _box_model(nx, n_sub, n_shards, **kw)
    overlapped = []
    evp_overlap = sm.evp_overlap
    sm.evp_overlap = lambda *a: overlapped.append(1) or evp_overlap(*a)
    step = sm.make_step()
    for _ in range(n_steps):
        state, _ = step(sm.tensors, sm.halo, state, forcing)
    out = _fields(sm, state)
    out["overlapped_subcycles"] = np.array(len(overlapped))
    f = [torch.arange(1.0, 1.0 + b.mesh.n_vertices, dtype=F64) + 1e4 * s
         for s, b in zip(sm.block_ids, sm.blocks)]
    sm.exchange("vertex_field", [(x,) for x in f])
    out.update({f"halo_field.{s}": x.numpy()
                for s, x in zip(sm.block_ids, f)})
    return out


def sphere_column(n_shards=4, n_steps=2):
    """The subdiv-2 sphere with the column (mushy, dEdd, level ponds,
    Rothrock strength, ridging), the JAX package's full-physics inputs."""
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.parallel.sharded import full_physics_inputs
    mesh = icosahedral_mesh(2)
    cfg = C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=3, n_ice_layers=4),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=4, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(),
        column=C.ColumnConfig(ktherm=2, shortwave="dEdd",
                              pond_scheme="lvl", kstrength=1))
    sm = ShardedSeaIceModel(mesh, cfg, n_shards, F64, devices="cpu")
    area, vol, snow, extra, atm, ocn, coszen = full_physics_inputs(
        mesh, cfg, F64, "cpu")
    polar = (np.abs(mesh.lat_cell) > np.deg2rad(40.0))[:, None]
    area, vol, snow = area * polar, vol * polar, snow * polar
    state = [st.replace(tracers=dict(st.tracers, **e)) for st, e in zip(
        sm.init_state(area, vol, snow), sm.scatter_cell_tree(extra))]
    rng = np.random.default_rng(0)
    nc = mesh.n_cells
    z = np.zeros(nc)
    forcing = sm.scatter_cell_tree(DynamicsForcing(
        u_air_velocity=5.0 * rng.standard_normal(nc),
        v_air_velocity=5.0 * rng.standard_normal(nc),
        air_density=np.full(nc, 1.3),
        u_ocean_velocity=0.05 * rng.standard_normal(nc),
        v_ocean_velocity=0.05 * rng.standard_normal(nc),
        sea_surface_tilt_u=z, sea_surface_tilt_v=z, land_ice_mask=z))
    col = [sm.scatter_cell_tree(x) for x in (atm, ocn, coszen)]
    step = sm.make_step()
    for _ in range(n_steps):
        state, diags = step(sm.tensors, sm.halo, state, forcing, *col)
    out = _fields(sm, state)
    out["ridge_convergence"] = sm.gather_cells(
        [d["ridge_convergence"] for d in diags]).numpy()
    return out


def runner(workdir):
    """Two full-physics steps of ShardedStandaloneRunner on the 10 x 10
    box (`test_sharded_runner_matches_runner`'s), the restart and the
    history written per rank; the restart read back by every rank for its
    own blocks, and assembled."""
    from seaice_tpu_torch.io import (ShardedOutputStream, assemble_checkpoint,
                                     assemble_history,
                                     load_sharded_checkpoint,
                                     read_restart_timestamp)
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.run import RunStreams, ShardedStandaloneRunner
    mesh, cfg = full_physics_box()
    mesh.lat_cell = np.deg2rad(np.linspace(70.0, 85.0, mesh.n_cells))
    mesh.lon_cell = np.linspace(0.0, 1.0, mesh.n_cells)
    atmos, ocean = runner_forcing(mesh)
    state = initial_state_from_setup(
        SeaIceModel(mesh, cfg, F64, device="cpu"),
        RunSetup(initial_latitude_north=60.0))
    sm = ShardedSeaIceModel(mesh, cfg, 4, F64, devices="cpu")
    arrays = {k: t.numpy() for k, t in state.tracers.items()}
    sstate = [st.replace(tracers=t) for st, t in
              zip(sm.init_state(), sm.scatter_cell_tree(arrays))]
    os.makedirs(workdir, exist_ok=True)
    out = ShardedOutputStream(workdir, "history", sm.part, mesh.n_cells,
                              mesh.n_vertices)
    sr = ShardedStandaloneRunner(
        sm, sstate, atmos_forcing=atmos, ocean_forcing=ocean,
        streams=RunStreams(output=out, output_interval=1800.0,
                           restart_dir=workdir,
                           restart_interval=2 * 1800.0))
    sr.run(2)
    out.flush()
    ts = read_restart_timestamp(workdir)
    back, clock = load_sharded_checkpoint(
        workdir, f"restart.{ts}", sm.part, sm.init_state(),
        shards=sm.block_ids, device="cpu")
    differ = [s for s, (a, b) in enumerate(zip(back, sr.state))
              if not all(torch.equal(x, y) for x, y in zip(
                  _leaves(a), _leaves(b)))]
    res = _fields(sm, sr.state)
    glob, _ = assemble_checkpoint(workdir, f"restart.{ts}")
    hist, xtime = assemble_history(workdir, "history")
    res.update({"restart." + k: a for k, a in glob.items()})
    res.update({"history." + k: a for k, a in hist.items()})
    res["blocks_read_back_differ"] = np.array(differ, np.int64)
    res["clock_seconds"] = np.array(clock["seconds"])
    res["xtime"] = np.array(xtime)
    return res


def _leaves(st):
    v = st.velocity
    return [getattr(v, k) for k in ("u_velocity", "v_velocity", "stress11",
                                    "stress22", "stress12",
                                    "solve_velocity_prev")] + \
        [st.tracers[k] for k in sorted(st.tracers)]


def coupled():
    """One interval (2 substeps) of ShardedCoupledDriver on the 8 x 8 box
    with the column, 4 blocks (`test_torch_coupled.py`'s)."""
    from seaice_tpu_torch.coupled import ShardedCoupledDriver
    cfg = C.box_test_config(elastic_subcycles=4)
    cfg = dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, use_column_package=True))
    mesh = box.box_test_mesh(8, 8)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    sm = ShardedSeaIceModel(mesh, cfg, 4, F64, devices="cpu")
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    drv = ShardedCoupledDriver(sm, sm.init_state(area, vol, snow),
                               coupling_interval=2 * cfg.run.dt)
    out = drv.advance(coupled_imports(mesh.n_cells))
    return {"export." + k: np.asarray(a) for k, a in out.items()}


def coupled_imports(nc):
    """`test_torch_coupled.py`'s import fields (seed 3)."""
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


def full_physics_box(nx=10, n_sub=2):
    """`tests/test_sharded.py`'s 'base' case: the 10 x 10 box, 5
    categories, 7 layers, mushy thermodynamics, dEdd, level ponds,
    Rothrock strength, ridging; 2 subcycles."""
    cfg = C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=5, n_ice_layers=7),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=n_sub, rotate_cartesian_grid=False,
            include_metric_terms=False, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(),
        column=C.ColumnConfig(ktherm=2, shortwave="dEdd",
                              pond_scheme="lvl", kstrength=1))
    mesh = box.box_test_mesh(nx, nx)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    return mesh, cfg


def runner_forcing(mesh):
    """Seeded CORE six-hourly and monthly records and constant NCAR ocean
    records on the mesh's cells."""
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


def abort(workdir):
    """A non-finite ice area in block 2 alone (rank 1's across 2 ranks):
    the state check's flags are reduced over the ranks, so every rank
    raises SeaIceAbort after the step and the abort dump is written per
    block (rank 0 the manifest)."""
    from seaice_tpu_torch.error import SeaIceAbort
    from seaice_tpu_torch.io import load_sharded_checkpoint
    from seaice_tpu_torch.run import RunStreams, ShardedStandaloneRunner
    sm, states, _ = _box_model(12, 2, 4)
    for i, s in enumerate(sm.block_ids):
        if s == 2:
            bad = states[i].tracers["iceAreaCategory"].clone()
            bad[0, 0] = float("nan")
            states[i] = states[i].replace(tracers=dict(
                states[i].tracers, iceAreaCategory=bad))
    os.makedirs(workdir, exist_ok=True)
    runner = ShardedStandaloneRunner(
        sm, states, streams=RunStreams(restart_dir=workdir))
    try:
        runner.run(1)
    except SeaIceAbort as e:
        back, meta = load_sharded_checkpoint(
            workdir, os.path.basename(e.dump_path), sm.part,
            sm.init_state(), shards=sm.block_ids, device="cpu")
        return {"message": np.array(str(e)),
                "failed_checks": np.array(meta["failed_checks"]),
                "area": sm.gather_tracers(back)["iceAreaCategory"]}
    return {"message": np.array("")}


def dryrun():
    """`entry_torch.dryrun_multichip(4, "cpu", nx=8, subcycles=2)` with
    the overlap on (its default under a group; named, so that one process
    runs it too), the subcycles run under the overlap counted: the
    states of the rank's blocks, "block<id>.<field>"."""
    import entry_torch
    overlapped = []
    evp_overlap = ShardedSeaIceModel.evp_overlap
    ShardedSeaIceModel.evp_overlap = \
        lambda sm, *a: overlapped.append(1) or evp_overlap(sm, *a)
    try:
        states = entry_torch.dryrun_multichip(4, "cpu", nx=8, subcycles=2,
                                              overlap=True)
    finally:
        ShardedSeaIceModel.evp_overlap = evp_overlap
    k = len(states)
    out = {"overlapped_subcycles": np.array(len(overlapped))}
    for s, st in zip(range(_rank() * k, (_rank() + 1) * k), states):
        out.update({f"block{s}.{i}": x.numpy()
                    for i, x in enumerate(_leaves(st))})
    return out


def analysis(workdir):
    """One ShardedStandaloneRunner step of the 8 x 8 box in 4 blocks with
    one analysis member (regional statistics, computed and written every
    step) and its stream: the member computes on the collective gathers
    on every rank; only rank 0 writes (its records are counted)."""
    from seaice_tpu_torch.analysis import AnalysisDriver
    from seaice_tpu_torch.analysis.members import RegionalStatisticsMember
    from seaice_tpu_torch.io.output import OutputStream
    from seaice_tpu_torch.run import ShardedStandaloneRunner
    from seaice_tpu_torch.utils.containers import to_host
    sm, states, _ = _box_model(8, 2, 4)
    member = RegionalStatisticsMember(compute_interval=sm.cfg.run.dt)
    stream = OutputStream(os.path.join(workdir, "analysis.npz"), {})
    runner = ShardedStandaloneRunner(
        sm, states, analysis=AnalysisDriver([member], stream=stream))
    runner.run(1)
    out = {"member." + k: np.asarray(v)
           for k, v in to_host(member.results).items()}
    out["records_written"] = np.array(len(stream.records))
    return out


def _rank():
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def indivisible():
    """Three blocks: a world size of 2 does not divide them."""
    try:
        _box_model(8, 2, 3)
    except ValueError as e:
        return {"message": np.array(str(e))}
    return {"message": np.array("")}


def cases(workdir):
    """(name, thunk) of every case, in the order the ranks run them."""
    return [
        ("box4_ring", lambda: box_steps()),
        ("box4_allgather", lambda: box_steps(halo_mode="allgather")),
        ("box2", lambda: box_steps(n_shards=2)),
        ("overlap", lambda: box_steps(16, 8, 4, 3, overlap=True)),
        ("sphere_column", sphere_column),
        ("runner", lambda: runner(os.path.join(workdir, "runner"))),
        ("coupled", coupled),
        ("abort", lambda: abort(os.path.join(workdir, "abort"))),
        ("dryrun", dryrun),
        ("analysis", lambda: analysis(os.path.join(workdir, "analysis"))),
        ("indivisible", indivisible),
    ]


def main(rank, world, rendezvous, outdir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + rendezvous, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        for name, run in cases(outdir):
            res = run()
            tmp = os.path.join(outdir, f".{name}.rank{rank}.npz")
            np.savez(tmp, **res)
            os.replace(tmp, os.path.join(outdir, f"{name}.rank{rank}.npz"))
        if any(m == "jax" or m.startswith(("jax.", "seaice_tpu."))
               for m in sys.modules):
            raise RuntimeError("a rank imported jax or the JAX package")
    except BaseException:
        with open(os.path.join(outdir, f"error.rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
