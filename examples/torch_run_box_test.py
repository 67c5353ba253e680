#!/usr/bin/env python
"""Run the EVP box test of the PyTorch port and report simple
diagnostics: the velocity solve alone on the square box under its
analytic wind and currents, with the ice state held fixed.  The same
arguments and output as `examples/run_box_test.py`, plus --device.  The
quad box is raster-ordered, so its solve takes the raster loop
(`dynamics/cuda_raster.py`, one CUDA kernel per solve on the card); the
hex box takes the any-connectivity loop (`dynamics/cuda_unstructured.py`).

Usage:
  python examples/torch_run_box_test.py --nx 20 --hours 2 --device cpu
  python examples/torch_run_box_test.py --nx 80 --hours 12 --f32  # the card
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=20)
    ap.add_argument("--hours", type=float, default=2.0)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--hex", action="store_true", dest="hex_mesh")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from seaice_tpu_torch.config import box_test_config
    from seaice_tpu_torch.dynamics.evp import (
        build_dynamics_tensors, init_velocity_state, make_velocity_solver)
    from seaice_tpu_torch.mesh.structured import (detect_raster_quad,
                                                  raster_reorder)
    from seaice_tpu_torch.testcases import box
    from seaice_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64
    mesh = box.box_test_mesh(nx=args.nx, ny=args.nx, hex_mesh=args.hex_mesh)
    if not args.hex_mesh:
        mesh = raster_reorder(mesh)        # the raster loop's ordering
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    cfg = box_test_config(elastic_subcycles=args.subcycles)

    t0 = time.time()
    dyn = build_dynamics_tensors(mesh, cfg, dtype=dtype, device=device)
    print(f"init: {mesh.n_cells} cells, basis precompute "
          f"{time.time()-t0:.2f}s")

    dv = mesh.dv_edge
    step = make_velocity_solver(cfg, dyn, raster=detect_raster_quad(mesh),
                                min_dv_edge=float(np.min(dv[dv > 0])))
    area, vol, snow = (torch.as_tensor(np.asarray(a)).to(device=device,
                                                         dtype=dtype)
                       for a in box.box_initial_state(mesh))
    state = init_velocity_state(mesh, dtype=dtype, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n_steps = int(args.hours * 3600 / cfg.run.dt)
    t0 = time.time()
    for i in range(n_steps):
        forcing = box.box_forcing(mesh, i * cfg.run.dt, dtype=dtype,
                                  device=device)
        state, diags = step(state, forcing, area, vol, snow)
        if i == 0:
            sync()
            print(f"first step (incl. kernel build): {time.time()-t0:.2f}s")
            t0 = time.time()
    sync()
    elapsed = time.time() - t0
    per_step = elapsed / max(n_steps - 1, 1)

    u = state.u_velocity.cpu().numpy()
    v = state.v_velocity.cpu().numpy()
    speed = np.hypot(u, v)
    print(f"{n_steps} steps, {per_step*1e3:.1f} ms/step, "
          f"{mesh.n_cells * args.subcycles / per_step:.3g} "
          "cells*subcycles/s")
    print(f"max ice speed: {speed.max():.4f} m/s  "
          f"mean: {speed.mean():.4f} m/s  finite: {np.isfinite(u).all()}")
    assert np.isfinite(u).all() and speed.max() < 1.5
    print("box test OK")


if __name__ == "__main__":
    main()
