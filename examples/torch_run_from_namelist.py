#!/usr/bin/env python
"""Run the standalone model of the PyTorch port entirely from a namelist.

The analog of `mpirun ./seaice_model` with `namelist.seaice`: every
physics, scheme and tuning choice comes from the namelist (parsed and
validated against the Registry audit, `seaice_tpu_torch/namelist.py`); the
mesh comes from an MPAS NetCDF file (--mesh) or a generated icosahedral
mesh (--subdiv), mirroring the reference's mesh stream.  The same
arguments and output as `examples/run_from_namelist.py`, plus --device.

Usage:
  python examples/torch_run_from_namelist.py \\
      --namelist examples/namelist.seaice.example --subdiv 3 --device cpu
  python examples/torch_run_from_namelist.py \\
      --namelist examples/namelist.seaice.example --subdiv 6   # the card
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--namelist", required=True)
    ap.add_argument("--mesh", help="MPAS NetCDF mesh file")
    ap.add_argument("--subdiv", type=int, default=3,
                    help="icosahedral subdivisions if no --mesh")
    ap.add_argument("--outdir", default=None,
                    help="output and restart directory (default: a new "
                         "directory under the system's temporary directory)")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from seaice_tpu_torch.io.output import OutputStream
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.namelist import (config_from_namelist,
                                           initial_state_from_setup,
                                           _parse_duration)
    from seaice_tpu_torch.run import RunStreams, StandaloneRunner

    cfg, setup = config_from_namelist(args.namelist)
    print(f"namelist {args.namelist}: dt={cfg.run.dt}s, "
          f"ktherm={cfg.column.ktherm}, "
          f"shortwave={cfg.column.shortwave}, "
          f"ponds={cfg.column.pond_scheme}, "
          f"subcycles={cfg.velocity.elastic_subcycle_number}, "
          f"duration={setup.run_duration}")

    if args.mesh:
        from seaice_tpu_torch.io.mesh_reader import read_mpas_mesh
        mesh = read_mpas_mesh(args.mesh)
    else:
        from seaice_tpu_torch.mesh import icosahedral_mesh
        mesh = icosahedral_mesh(args.subdiv, radius=setup.earth_radius)
    print(f"mesh: {mesh.n_cells} cells")

    dtype = torch.float64 if args.f64 else torch.float32
    model = SeaIceModel(mesh, cfg, dtype=dtype, device=args.device)
    state = initial_state_from_setup(model, setup)

    if args.outdir is None:
        args.outdir = tempfile.mkdtemp(prefix="seaice_namelist_run_")
    os.makedirs(args.outdir, exist_ok=True)
    out = OutputStream(os.path.join(args.outdir, "output.nc"),
                       {"nCells": mesh.n_cells,
                        "nVertices": mesh.n_vertices})
    runner = StandaloneRunner(
        model, state,
        streams=RunStreams(output=out, output_interval=86400.0,
                           restart_dir=args.outdir))

    n = int(round(_parse_duration(setup.run_duration) / cfg.run.dt))
    print(f"running {n} steps...")
    t0 = time.perf_counter()
    state = runner.run(n, check_interval=max(1, n // 4)
                       if not setup.check_state else 1)
    wall = time.perf_counter() - t0
    out.flush()

    a = state.tracers["iceAreaCategory"].sum(-1).cpu().numpy()
    u = state.velocity.u_velocity.cpu().numpy()
    assert np.isfinite(a).all() and np.abs(u).max() < 1.5
    print(f"done in {wall:.1f}s: aice max {a.max():.3f}, "
          f"max|u| {np.abs(u).max():.3f} m/s")
    print("namelist-driven run OK")


if __name__ == "__main__":
    main()
