#!/usr/bin/env python
"""Global coupled demo of the PyTorch port: column thermodynamics + EVP
dynamics + upwind transport on a quasi-uniform icosahedral mesh with
idealized forcing (a zonal wind over polar-night caps).  The same
arguments and output as `examples/run_global.py`, plus --device.

Usage:
  python examples/torch_run_global.py --subdiv 4 --days 1         # the card
  python examples/torch_run_global.py --subdiv 3 --days 0.25 --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def polar_ice_state(model, polar, t_surface=-15.0, t_ice=-10.0,
                    t_snow=-12.0, concentration=0.95):
    """Ice of `concentration` spread over the categories in the `polar`
    cells (category-mid thicknesses, 5% snow), with uniform surface, ice
    and snow temperatures and the BL99 salinity profile."""
    import numpy as np
    import torch
    from seaice_tpu_torch.column.thermo_shared import (
        ice_enthalpy_from_temperature, melting_temperature,
        salinity_profile, snow_enthalpy_from_temperature)

    run = model.cfg.run
    nc, ncat = model.mesh.n_cells, run.n_categories
    ni, ns = run.n_ice_layers, run.n_snow_layers
    dt, dev = model.dtype, model.device
    h = model.column.hin_max
    mids = 0.5 * (h[:-1] + np.minimum(h[1:], 10.0))
    area = np.where(polar[:, None], concentration / ncat, 0.0) * \
        np.ones((1, ncat))
    state = model.init_state(area, area * mids, area * 0.05)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device=dev,
                                                             dtype=dt)

    has = t(area[..., None] > 0)
    S = t(np.tile(salinity_profile(ni), (nc, ncat, 1)))
    tr = dict(state.tracers)
    tr["surfaceTemperature"] = t(np.where(area > 0, t_surface, 0.0))
    tr["iceEnthalpy"] = ice_enthalpy_from_temperature(
        t_ice * has * torch.ones_like(S), melting_temperature(S)) * has
    tr["iceSalinity"] = S * has
    tr["snowEnthalpy"] = snow_enthalpy_from_temperature(
        t(np.full((nc, ncat, ns), t_snow))) * has
    return state.replace(tracers=tr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=4)
    ap.add_argument("--days", type=float, default=1.0)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from seaice_tpu_torch.config import (AdvectionConfig, AdvectionType,
                                         ColumnConfig, Config, RunConfig,
                                         VelocitySolverConfig)
    from seaice_tpu_torch.column import (AtmosForcing, OceanForcing,
                                         slab_ocean_frzmlt)
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing
    from seaice_tpu_torch.mesh import (icosahedral_mesh,
                                       latlon_vector_rotation_forward)
    from seaice_tpu_torch.model import SeaIceModel

    dtype = torch.float64 if args.f64 else torch.float32
    t0 = time.perf_counter()
    mesh = icosahedral_mesh(args.subdiv)
    print(f"mesh: {mesh.n_cells} cells "
          f"(~{np.sqrt(mesh.area_cell.mean())/1e3:.0f} km), "
          f"built in {time.perf_counter()-t0:.1f}s")

    cfg = Config(
        run=RunConfig(dt=1800.0, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=args.subcycles,
            rotate_cartesian_grid=True, include_metric_terms=True,
            geostrophic_surface_tilt=False),
        advection=AdvectionConfig(advection_type=AdvectionType.UPWIND),
        column=ColumnConfig())
    t0 = time.perf_counter()
    model = SeaIceModel(mesh, cfg, dtype=dtype, device=args.device)
    dev = model.device
    print(f"tensors built in {time.perf_counter()-t0:.1f}s")

    # polar ice caps across the thinner categories
    nc = mesh.n_cells
    polar = np.abs(mesh.lat_cell) > np.deg2rad(60.0)
    state = polar_ice_state(model, polar)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device=dev,
                                                             dtype=dtype)

    # idealized forcing: zonal wind + polar-night atmosphere
    u_rot, v_rot = latlon_vector_rotation_forward(
        6.0 * np.cos(mesh.lat_cell), np.zeros(nc), mesh.x_cell,
        mesh.y_cell, mesh.z_cell)
    z = t(np.zeros(nc))
    forcing = DynamicsForcing(
        u_air_velocity=t(u_rot), v_air_velocity=t(v_rot),
        air_density=t(np.full(nc, 1.3)),
        u_ocean_velocity=z, v_ocean_velocity=z,
        sea_surface_tilt_u=z, sea_surface_tilt_v=z, land_ice_mask=z)
    one = t(np.ones(nc))
    atm = AtmosForcing(
        air_temperature=t(np.where(polar, 250.0, 280.0)),
        specific_humidity=0.0005 * one,
        u_air=forcing.u_air_velocity, v_air=forcing.v_air_velocity,
        longwave_down=t(np.where(polar, 170.0, 320.0)),
        sw_vis_dir=10.0 * one, sw_vis_dif=10.0 * one,
        sw_ir_dir=8.0 * one, sw_ir_dif=8.0 * one,
        rain_rate=0.0 * one, snow_rate=1e-5 * one,
        air_density=1.3 * one, air_level_height=10.0 * one)
    sst = t(np.where(polar, -1.7, 10.0))
    Tf = -1.8 * one
    ocn = OceanForcing(
        sst=sst, sss=34.0 * one, freezing_temperature=Tf,
        frzmlt=slab_ocean_frzmlt(sst, Tf, 20.0 * one, cfg.run.dt),
        mixed_layer_depth=20.0 * one)

    step = model.make_step()
    s, _ = step(model.tensors, state, forcing, atm, ocn)
    float(s.velocity.u_velocity.abs().max())
    print("first step (incl. kernel build) in",
          round(time.perf_counter() - t0, 1), "s")

    n = max(int(args.days * 86400 / cfg.run.dt), 1)
    t0 = time.perf_counter()
    for _ in range(n):
        s, diags = step(model.tensors, s, forcing, atm, ocn)
    umax = float(s.velocity.u_velocity.abs().max())
    wall = time.perf_counter() - t0
    a = s.tracers["iceAreaCategory"].sum(-1).cpu().numpy()
    v = s.tracers["iceVolumeCategory"].sum(-1).cpu().numpy()
    fx = diags["column_fluxes"]
    print(f"{n} steps ({args.days} days) in {wall:.1f}s "
          f"({wall/n*1e3:.1f} ms/step; "
          f"{mesh.n_cells*args.subcycles*n/wall/1e6:.1f} "
          f"Mcell-subcyc/s)")
    print(f"max|u| = {umax:.3f} m/s, aice in [{a.min():.3f}, "
          f"{a.max():.3f}], mean polar h = "
          f"{v[polar].sum()/max(a[polar].sum(), 1e-9):.2f} m")
    print(f"congel total = {float(fx.congel.sum()):.3e} m, "
          f"frazil = {float(fx.frazil.sum()):.3e} m")
    assert np.isfinite(a).all() and umax < 1.5
    print("global run OK")


if __name__ == "__main__":
    main()
