"""Driver entry points of the PyTorch port (the counterpart of
`__graft_entry__.py`, which drives the JAX package).

entry()             -> (step, args): one timestep of the flagship box
                       model (the EVP velocity solve of the box test,
                       the raster loop on the raster-ordered 32 x 32
                       box) at 8 elastic subcycles, float32, on the CUDA
                       card: call step(*args).
dryrun_multichip(n) -> ONE sharded full-physics step of
                       `ShardedSeaIceModel` with n blocks: all on the
                       one card, or, under a process group, spread over
                       the ranks (one card each) with the
                       interior/boundary overlap of the halo exchange.

Both ask for the card unless given device="cpu".

    python entry_torch.py                  # the card
    python entry_torch.py --device cpu --nx 8 --subcycles 2 --blocks 2
    # N ranks on N cards (NCCL), or on the CPU (gloo): the dry run only
    python -m torch.distributed.run --nproc-per-node=N entry_torch.py \
        --blocks N
    python -m torch.distributed.run --nproc-per-node=2 entry_torch.py \
        --device cpu --nx 8 --subcycles 2 --blocks 4
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _build(nx=32, ny=32, subcycles=8, device=None):
    import torch
    from seaice_tpu_torch.config import box_test_config
    from seaice_tpu_torch.mesh.structured import raster_reorder
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.testcases import box

    cfg = box_test_config(elastic_subcycles=subcycles)
    mesh = raster_reorder(box.box_test_mesh(nx, ny))
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=torch.float32, device=device)
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    state = model.init_state(area, vol, snow)
    forcing = box.box_forcing(mesh, t=0.0, dtype=torch.float32,
                              device=model.device)
    return model, state, forcing


def entry(device=None, nx=32, subcycles=8):
    """(step, (tensors, state, forcing)) of the nx x nx box model (32:
    the flagship size)."""
    model, state, forcing = _build(nx, nx, subcycles, device)
    return model.make_step(), (model.tensors, state, forcing)


def dryrun_multichip(n_blocks: int, device=None, nx=32, subcycles=10,
                     overlap=None):
    """ONE sharded full-physics step (mushy thermodynamics, dEdd
    shortwave, level-ice ponds, Rothrock strength, 5 categories, remap
    and ridging, ice age and first-year ice, 2 bulk aerosol species with
    their deposition, high-frequency coupling, the snow tracers with
    ITDrdg redistribution) of the nx x nx box (32 by default) cut into
    n_blocks blocks, `subcycles` elastic subcycles (10), float32.  Under
    an initialised process group the blocks are spread over the ranks
    with the interior/boundary overlap on, as the JAX package's
    `parallel/sharded.py::dryrun` runs them over its devices; without one
    every block is on the one device, without the overlap.  overlap: True
    or False sets the overlap either way.  Returns the rank's blocks'
    states."""
    import numpy as np
    import torch
    from seaice_tpu_torch.config import (AdvectionConfig, ColumnConfig,
                                         Config, RunConfig,
                                         VelocitySolverConfig)
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    from seaice_tpu_torch.parallel.sharded import full_physics_inputs
    from seaice_tpu_torch.testcases import box

    f32 = torch.float32
    cfg = Config(
        run=RunConfig(dt=1800.0, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=subcycles, rotate_cartesian_grid=False,
            include_metric_terms=False, geostrophic_surface_tilt=False),
        advection=AdvectionConfig(),
        column=ColumnConfig(ktherm=2, shortwave="dEdd",
                            pond_scheme="lvl", kstrength=1,
                            use_ice_age=True, use_first_year_ice=True,
                            n_aerosols=2, highfreq=True,
                            use_snow_tracers=True, snwredist="ITDrdg"))
    mesh = box.box_test_mesh(nx, nx)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    from seaice_tpu_torch.parallel.comm import process_group
    if overlap is None:
        overlap = process_group() is not None
    sm = ShardedSeaIceModel(mesh, cfg, n_blocks, dtype=f32, devices=device,
                            overlap=overlap)
    area, vol, snow, extra, atm, ocn, coszen = full_physics_inputs(
        mesh, cfg, f32, sm.device)
    state = [st.replace(tracers=dict(st.tracers, **e)) for st, e in zip(
        sm.init_state(area, vol, snow), sm.scatter_cell_tree(extra))]
    forcing = sm.scatter_forcing(
        lambda m: box.box_forcing(m, t=0.0, dtype=f32, device=sm.device))
    nc = mesh.n_cells
    out, _ = sm.make_step()(
        sm.tensors, sm.halo, state, forcing, sm.scatter_cell_tree(atm),
        sm.scatter_cell_tree(ocn), sm.scatter_cell_tree(coszen),
        day_of_year=265.0,
        lat=sm.scatter_cell_tree(np.full(nc, np.deg2rad(75.0))),
        faero_atm=sm.scatter_cell_tree(
            np.tile(np.array([1e-12, 5e-13]), (nc, 1))))
    for st in out:
        for k, t in st.tracers.items():
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"dryrun_multichip: {k} is not "
                                         "finite")
    return out


if __name__ == "__main__":
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--subcycles", type=int, default=8)
    args = ap.parse_args()
    # launched by torch.distributed.run: one process per card (NCCL), or
    # processes on the CPU (gloo); the dry run alone
    ranks = "LOCAL_RANK" in os.environ
    if ranks:
        import torch.distributed as dist
        if args.device == "cpu":
            dist.init_process_group("gloo")
        else:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group("nccl")
    try:
        if not ranks:
            fn, fn_args = entry(args.device, args.nx, args.subcycles)
            out, _ = fn(*fn_args)
            assert bool(torch.isfinite(out.velocity.u_velocity).all())
            print("entry() OK")
        dryrun_multichip(args.blocks, args.device, args.nx, args.subcycles)
        if not ranks or dist.get_rank() == 0:
            print("dryrun_multichip OK")
    finally:
        if ranks:
            dist.destroy_process_group()
