#!/usr/bin/env python
"""The file-driven 5-day run at QU120km scale on the PyTorch port.

Everything comes from files, none of them written by the port's own
writers: the mesh is an MPAS-convention NetCDF file produced by the
independent ConvexHull-based generator `tests/mpas_fixture.py`, and the
atmosphere and ocean forcing are CORE-layout NetCDF files written with
plain scipy netcdf calls (`seaice_tpu_torch/io/synthetic.py`).  The
whole path is file -> mesh reader -> forcing reader -> StandaloneRunner
-> restart.  The same arguments and output as
`examples/run_5day_from_files.py` (without its JAX-only --no-fused and
--no-pallas-flux: the port has no plain path on the card), plus
--device; --outdir defaults to a new directory under the system's
temporary directory.

Usage:
  python examples/torch_run_5day_from_files.py           # subdiv 6, the card
  python examples/torch_run_5day_from_files.py --subdiv 3 --days 0.5 \\
      --device cpu
  python examples/torch_run_5day_from_files.py --verify-restart
"""

import argparse
import os
import sys
import tempfile
import time

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--days", type=float, default=5.0)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--outdir", default=None,
                    help="mesh, forcing and restart directory (default: a "
                         "new directory under the system's temporary "
                         "directory)")
    ap.add_argument("--verify-restart", action="store_true",
                    help="rerun the second half from the mid-run "
                    "restart file and require bitwise equality")
    ap.add_argument("--save-final", default=None,
                    help="write the final prognostic state to this "
                    ".npz (for precision/trajectory comparisons)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from seaice_tpu_torch.config import (AdvectionConfig, AdvectionType,
                                         ColumnConfig, Config, RunConfig,
                                         VelocitySolverConfig)
    from seaice_tpu_torch.io.checkpoint import (load_checkpoint,
                                                save_checkpoint)
    from seaice_tpu_torch.io.forcing_reader import (core_atmos_from_files,
                                                    ncar_ocean_from_file)
    from seaice_tpu_torch.io.mesh_reader import read_mpas_mesh
    from seaice_tpu_torch.io.synthetic import write_forcing_files
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.run import StandaloneRunner
    from seaice_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.outdir is None:
        args.outdir = tempfile.mkdtemp(prefix="seaice_5day_files_")
    os.makedirs(args.outdir, exist_ok=True)
    dtype = torch.float64 if args.f64 else torch.float32

    # -- mesh file: generate once with the independent generator, then
    #    always READ it back through the MPAS reader
    mesh_path = os.path.join(args.outdir, f"mesh_icos{args.subdiv}.nc")
    if not os.path.exists(mesh_path):
        sys.path.insert(0, os.path.join(_ROOT, "tests"))
        from mpas_fixture import write_icosahedral_mpas_file
        t0 = time.perf_counter()
        write_icosahedral_mpas_file(mesh_path, subdiv=args.subdiv)
        print(f"mesh file generated in {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    mesh = read_mpas_mesh(mesh_path)
    print(f"mesh read: {mesh.n_cells} cells "
          f"(~{np.sqrt(mesh.area_cell.mean())/1e3:.0f} km) in "
          f"{time.perf_counter()-t0:.1f}s")

    # -- forcing files (written if absent), read via the readers
    six_path = os.path.join(args.outdir, "core_sixhourly.nc")
    if not os.path.exists(six_path):
        write_forcing_files(args.outdir, mesh)
    atmos = core_atmos_from_files(
        six_path, os.path.join(args.outdir, "core_monthly.nc"),
        mesh.lon_cell, mesh.lat_cell)
    ocean = ncar_ocean_from_file(os.path.join(args.outdir, "ocean.nc"))

    cfg = Config(
        run=RunConfig(dt=args.dt, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=args.subcycles,
            rotate_cartesian_grid=True, include_metric_terms=True,
            geostrophic_surface_tilt=False),
        advection=AdvectionConfig(
            advection_type=AdvectionType.INCREMENTAL_REMAP),
        column=ColumnConfig())
    setup = RunSetup(initial_condition_type="cice_default",
                     initial_latitude_north=65.0,
                     initial_latitude_south=-65.0)

    t0 = time.perf_counter()
    model = SeaIceModel(mesh, cfg, dtype=dtype, device=device)
    state = initial_state_from_setup(model, setup)
    print(f"tensors in {time.perf_counter()-t0:.1f}s")

    n = max(int(args.days * 86400 / args.dt), 1)
    n_half = n // 2
    check = min(24, max(n_half, 1))
    runner = StandaloneRunner(model, state, atmos_forcing=atmos,
                              ocean_forcing=ocean)
    print(f"running {n} steps ({args.days} days) from files...")
    t0 = time.perf_counter()
    state_mid = runner.run(n_half, check_interval=check)
    ckpt = os.path.join(args.outdir, "restart_mid.npz")
    save_checkpoint(ckpt, state_mid,
                    {"clock_seconds": runner.clock.seconds})
    state = runner.run(n - n_half, check_interval=check)
    wall = time.perf_counter() - t0

    a = state.tracers["iceAreaCategory"].sum(-1).cpu().numpy()
    v = state.tracers["iceVolumeCategory"].sum(-1).cpu().numpy()
    u = state.velocity.u_velocity.cpu().numpy()
    print(f"done in {wall:.1f}s wall "
          f"({wall/n*1e3:.1f} ms/step incl. host loop; "
          f"{mesh.n_cells*args.subcycles*n/wall/1e6:.1f} "
          f"Mcell-subcyc/s)")
    print(runner.timers.report())
    print(f"final: aice max {a.max():.3f}, total volume "
          f"{(v*mesh.area_cell).sum()/1e12:.2f} thousand km^3, "
          f"max|u| {np.abs(u).max():.3f} m/s")
    assert np.isfinite(a).all() and np.abs(u).max() < 1.5
    if args.save_final:
        np.savez(args.save_final,
                 u_velocity=state.velocity.u_velocity.cpu().numpy(),
                 v_velocity=state.velocity.v_velocity.cpu().numpy(),
                 **{k: t.cpu().numpy() for k, t in state.tracers.items()})
        print(f"final state -> {args.save_final}")

    if args.verify_restart:
        state_r, meta = load_checkpoint(ckpt, dtype=dtype, device=device)
        model2 = SeaIceModel(mesh, cfg, dtype=dtype, device=device)
        runner2 = StandaloneRunner(model2, state_r, atmos_forcing=atmos,
                                   ocean_forcing=ocean)
        runner2.clock.seconds = float(meta["clock_seconds"])
        state_b = runner2.run(n - n_half, check_interval=check)
        for k in state.tracers:
            assert torch.equal(state.tracers[k], state_b.tracers[k]), k
        assert torch.equal(state.velocity.u_velocity,
                           state_b.velocity.u_velocity)
        print("restart bitwise OK")
    print("5-day file-driven run OK")


if __name__ == "__main__":
    main()
