#!/usr/bin/env python
"""Coupled-driver demo of the PyTorch port: drive the ice model through
the NUOPC-style import/export surface (the reference's
ice_comp_mct/ice_comp_nuopc role, driver/ice_comp_mct.F:1004).

A toy "coupler" supplies atmosphere and ocean fields each coupling
interval; the ice model sub-cycles its own dt on the device and returns
interval-mean fluxes.  The same arguments and output as
`examples/run_coupled.py`, plus --device and --f64 (the JAX example runs
in float64).

    python examples/torch_run_coupled.py --hours 6 --device cpu --f64
    python examples/torch_run_coupled.py --hours 6          # the card, f32
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=12)
    ap.add_argument("--hours", type=float, default=6.0)
    ap.add_argument("--couple-interval", type=float, default=3600.0)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    from seaice_tpu_torch.config import box_test_config
    from seaice_tpu_torch.coupled import CoupledDriver
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.testcases import box

    cfg = box_test_config(elastic_subcycles=40)
    cfg = dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, use_column_package=True))
    mesh = box.box_test_mesh(args.nx, args.nx)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    dtype = torch.float64 if args.f64 else torch.float32
    model = SeaIceModel(mesh, cfg, dtype=dtype, device=args.device)
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    state = model.init_state(area, vol, snow)

    drv = CoupledDriver(model, state,
                        coupling_interval=args.couple_interval)
    imports, exports = drv.advertise()
    print(f"advertised {len(imports)} import / {len(exports)} export "
          f"fields; {drv.n_substeps} substeps per couple interval")

    nc = mesh.n_cells
    rng = np.random.default_rng(0)
    fields = {
        "So_t": np.full(nc, -1.6), "So_s": np.full(nc, 32.0),
        "Sa_u": 6.0 + rng.standard_normal(nc),
        "Sa_v": 2.0 + rng.standard_normal(nc),
        "Sa_ptem": np.full(nc, 258.0), "Sa_shum": np.full(nc, 8e-4),
        "Sa_dens": np.full(nc, 1.3),
        "Faxa_lwdn": np.full(nc, 200.0),
        "Faxa_swvdr": np.full(nc, 30.0),
        "Faxa_swvdf": np.full(nc, 20.0),
        "Faxa_swndr": np.full(nc, 25.0),
        "Faxa_swndf": np.full(nc, 15.0),
        "Faxa_rain": np.zeros(nc), "Faxa_snow": np.full(nc, 1e-8),
    }

    n_couples = int(args.hours * 3600.0 / args.couple_interval)
    for i in range(n_couples):
        out = drv.advance(fields)
        print(f"couple step {i + 1}/{n_couples} "
              f"t={drv.clock.seconds/3600:5.1f} h  "
              f"aice_max={out['Si_ifrac'].max():.3f}  "
              f"sen={out['Faii_sen'].mean():7.2f} W/m2  "
              f"melth={out['Fioi_melth'].mean():7.2f} W/m2  "
              f"|tau|={np.hypot(out['Fioi_taux'], out['Fioi_tauy']).max():.3f}")
    print("done")


if __name__ == "__main__":
    main()
