#!/usr/bin/env python3
"""The JAX package's own float32 file-driven run against its float64
run, on the CPU: the reference side of `dev/file_run_drift.py`.

    JAX_PLATFORMS=cpu python dev/reference_file_run_drift.py
        [--subdiv 3] [--subcycles 8] [--steps 48] [--every 8]
        [--column mushy|bl99]

Writes the MPAS file of `tests/mpas_fixture.py` and the forcing files of
`examples/run_5day_from_files.py` into a temporary directory, runs
`seaice_tpu.run.StandaloneRunner` from `cice_default` (polar caps
poleward of 65 degrees) once in float32 and once in float64 (each in its
own process, since float64 needs `jax_enable_x64`), and prints one JSON
line every `--every` steps with the distances `dev/file_run_drift.py`
prints for the port: area, volume and enthalpy relative to their max,
u relative, surface temperature in K.  The column: `mushy` is the
north-star column of `chip_smoke.py` (mushy, dEdd, level ponds,
Rothrock), `bl99` the defaults of `ColumnConfig()`.  Small sizes only:
each dtype jit-compiles the full-physics step (about a minute and a half
on a CPU).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.worker == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    sys.path[:0] = [ROOT, os.path.join(ROOT, "examples"),
                    os.path.join(ROOT, "tests")]
    from mpas_fixture import write_icosahedral_mpas_file
    from run_5day_from_files import write_forcing_files
    from seaice_tpu.config import (AdvectionConfig, ColumnConfig, Config,
                                   RunConfig, VelocitySolverConfig)
    from seaice_tpu.io.forcing_reader import (core_atmos_from_files,
                                              ncar_ocean_from_file)
    from seaice_tpu.io.mesh_reader import read_mpas_mesh
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu.run import StandaloneRunner

    d = args.dir
    mesh_path = os.path.join(d, "mesh.nc")
    if not os.path.exists(mesh_path):
        write_icosahedral_mpas_file(mesh_path, subdiv=args.subdiv)
    mesh = read_mpas_mesh(mesh_path)
    if not os.path.exists(os.path.join(d, "ocean.nc")):
        write_forcing_files(d, mesh)
    atmos = core_atmos_from_files(os.path.join(d, "core_sixhourly.nc"),
                                  os.path.join(d, "core_monthly.nc"),
                                  mesh.lon_cell, mesh.lat_cell)
    ocean = ncar_ocean_from_file(os.path.join(d, "ocean.nc"))
    column = (ColumnConfig(ktherm=2, shortwave="dEdd", pond_scheme="lvl",
                           kstrength=1) if args.column == "mushy"
              else ColumnConfig())
    cfg = Config(
        run=RunConfig(dt=1800.0, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=args.subcycles,
            rotate_cartesian_grid=True, include_metric_terms=True,
            geostrophic_surface_tilt=False),
        advection=AdvectionConfig(conservation_check=True), column=column)
    dtype = jnp.float64 if args.worker == "f64" else jnp.float32
    model = SeaIceModel(mesh, cfg, dtype=dtype)
    state = initial_state_from_setup(model, RunSetup(
        initial_condition_type="cice_default", initial_latitude_north=65.0,
        initial_latitude_south=-65.0))
    runner = StandaloneRunner(model, state, atmos_forcing=atmos,
                              ocean_forcing=ocean)
    out = {}
    for i in range(1, args.steps + 1):
        s = runner.run(1)
        if i % args.every == 0 or i == args.steps:
            for k in ("iceAreaCategory", "iceVolumeCategory", "iceEnthalpy",
                      "surfaceTemperature"):
                out[f"{i}.{k}"] = np.asarray(s.tracers[k], np.float64)
            out[f"{i}.u"] = np.asarray(s.velocity.u_velocity, np.float64)
    np.savez(os.path.join(d, f"{args.worker}.npz"), **out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--subcycles", type=int, default=8)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--every", type=int, default=8)
    ap.add_argument("--column", default="mushy")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    import numpy as np
    with tempfile.TemporaryDirectory(prefix="reference_drift_") as d:
        for w in ("f32", "f64"):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", w, "--dir", d] + sys.argv[1:],
                           check=True, env=dict(os.environ,
                                                JAX_PLATFORMS="cpu"))
        a, b = np.load(os.path.join(d, "f32.npz")), \
            np.load(os.path.join(d, "f64.npz"))
        steps = sorted({int(k.split(".")[0]) for k in a.files})
        for i in steps:
            row = {k: float(np.abs(a[f"{i}.{k}"] - b[f"{i}.{k}"]).max() /
                            np.abs(b[f"{i}.{k}"]).max())
                   for k in ("iceAreaCategory", "iceVolumeCategory",
                             "iceEnthalpy", "u")}
            row["surfaceTemperature_max_abs_K"] = float(np.abs(
                a[f"{i}.surfaceTemperature"] -
                b[f"{i}.surfaceTemperature"]).max())
            print(json.dumps({"package": "seaice_tpu", "column": args.column,
                              "subdiv": args.subdiv,
                              "subcycles": args.subcycles, "step": i,
                              **row}), flush=True)


if __name__ == "__main__":
    main()
