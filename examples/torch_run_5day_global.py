#!/usr/bin/env python
"""The 5-day global standalone configuration on the PyTorch port.

The analog of the reference's headline configuration (5-day QU120km
standalone run): full physics (column thermodynamics, EVP with 120
subcycles and the variational Wachspress operators, incremental-remapping
transport, ridging) on a quasi-uniform icosahedral mesh with synthetic
seasonal CORE-style forcing through the forcing subsystem and the
standalone run loop (output and restart streams, state checks).  The
same arguments and output as `examples/run_5day_global.py`, plus
--device; --outdir defaults to a new directory under the system's
temporary directory.

Usage:
  python examples/torch_run_5day_global.py --subdiv 5          # the card
  python examples/torch_run_5day_global.py --subdiv 3 --days 1 --device cpu
"""

import argparse
import os
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, ".."))
sys.path.insert(0, _HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=5)
    ap.add_argument("--days", type=float, default=5.0)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--outdir", default=None,
                    help="output and restart directory (default: a new "
                         "directory under the system's temporary directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from seaice_tpu_torch.config import (AdvectionConfig, AdvectionType,
                                         ColumnConfig, Config, RunConfig,
                                         VelocitySolverConfig)
    from seaice_tpu_torch.forcing import ForcingSeries
    from seaice_tpu_torch.forcing.core import (CoreAtmosForcing,
                                               NcarOceanForcing,
                                               monthly_times)
    from seaice_tpu_torch.io.output import OutputStream
    from seaice_tpu_torch.io.synthetic import (cloud_fraction, polar_sst,
                                               six_hourly_atmosphere)
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.run import RunStreams, StandaloneRunner
    from torch_run_global import polar_ice_state

    dtype = torch.float64 if args.f64 else torch.float32
    t0 = time.perf_counter()
    mesh = icosahedral_mesh(args.subdiv)
    print(f"mesh: {mesh.n_cells} cells "
          f"(~{np.sqrt(mesh.area_cell.mean())/1e3:.0f} km) in "
          f"{time.perf_counter()-t0:.1f}s")

    cfg = Config(
        run=RunConfig(dt=args.dt, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=args.subcycles,
            rotate_cartesian_grid=True, include_metric_terms=True,
            geostrophic_surface_tilt=False),
        advection=AdvectionConfig(
            advection_type=AdvectionType.INCREMENTAL_REMAP),
        column=ColumnConfig())
    t0 = time.perf_counter()
    model = SeaIceModel(mesh, cfg, dtype=dtype, device=args.device)
    print(f"tensors in {time.perf_counter()-t0:.1f}s")

    # initial polar ice
    nc = mesh.n_cells
    polar = np.abs(mesh.lat_cell) > np.deg2rad(65.0)
    state = polar_ice_state(model, polar, concentration=0.9)

    # synthetic CORE-style forcing: seasonal + latitude-dependent
    # 6-hourly atmosphere (16 sample times across the year, cyclic) and
    # monthly cloud/precipitation
    lat, lon = mesh.lat_cell, mesh.lon_cell
    times, six_fields = six_hourly_atmosphere(mesh)
    six = ForcingSeries(times=times, fields=six_fields)
    mon = ForcingSeries(times=monthly_times(), fields={
        "cloudFraction": np.tile(cloud_fraction(mesh)[None, :], (12, 1)),
        "precipitationRate": np.full((12, nc), 2e-6)})
    atmos = CoreAtmosForcing(six_hourly=six, monthly=mon, lon=lon, lat=lat)
    ocean = NcarOceanForcing(ForcingSeries(
        times=np.array([0.0]),
        fields={"seaSurfaceTemperature": polar_sst(mesh)[None, :],
                "seaSurfaceSalinity": np.full((1, nc), 34.0),
                "seaFreezingTemperature": np.full((1, nc), -1.8),
                "oceanMixedLayerDepth": np.full((1, nc), 20.0),
                "uOceanVelocity": np.zeros((1, nc)),
                "vOceanVelocity": np.zeros((1, nc))}))

    if args.outdir is None:
        args.outdir = tempfile.mkdtemp(prefix="seaice_5day_")
    os.makedirs(args.outdir, exist_ok=True)
    out = OutputStream(os.path.join(args.outdir, "output.nc"),
                       {"nCells": nc, "nVertices": mesh.n_vertices})
    runner = StandaloneRunner(
        model, state, atmos_forcing=atmos, ocean_forcing=ocean,
        streams=RunStreams(output=out, output_interval=86400.0,
                           restart_dir=args.outdir,
                           restart_interval=5 * 86400.0))

    n = max(int(args.days * 86400 / args.dt), 1)
    print(f"running {n} steps ({args.days} days), output in "
          f"{args.outdir} ...")
    t0 = time.perf_counter()
    state = runner.run(n, check_interval=min(24, n))
    wall = time.perf_counter() - t0
    out.flush()

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
    print("5-day global run OK")


if __name__ == "__main__":
    main()
