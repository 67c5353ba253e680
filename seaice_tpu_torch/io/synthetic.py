"""Synthetic forcing for the global runs, in memory or as files:
CORE-layout 6-hourly and monthly atmosphere files and an NCAR-layout
monthly ocean file for a mesh, written with plain scipy netcdf calls
(not with the port's own writers), so that the file-driven run reads its
forcing through the same readers as it would read a real data set's
(`io/forcing_reader.py`).

The fields are seasonal and latitude-dependent: air temperature and
humidity over the year (16 sample times, cyclic), a zonal wind with a
travelling wave, cloud fraction and rainfall per month, and a polar
sea surface at -1.7 C."""

from __future__ import annotations

import os

import numpy as np

from ..mesh.rotation import latlon_vector_rotation_forward


def six_hourly_atmosphere(mesh, n_samples=16):
    """Seasonal, latitude-dependent air temperature (K), specific
    humidity and a zonal wind with a travelling wave (rotated to the
    mesh's Cartesian components) at n_samples times spread over the
    year: (times [n], {name: [n, nCells]}) under the CORE 6-hourly
    names."""
    nc = mesh.n_cells
    lat, lon = mesh.lat_cell, mesh.lon_cell
    times = np.linspace(0.0, 365 * 86400.0, n_samples, endpoint=False)
    t_air, q, u_wind, v_wind = (np.zeros((n_samples, nc))
                                for _ in range(4))
    for i, tsec in enumerate(times):
        season = np.cos(2 * np.pi * (tsec / (365 * 86400.0) - 14 / 365))
        t_air[i] = 288.0 - 45.0 * np.sin(np.abs(lat)) ** 2 \
            - 12.0 * season * np.sin(lat)
        q[i] = np.clip(5e-3 * np.exp((t_air[i] - 288.0) / 12.0),
                       1e-4, 2e-2)
        u_t = 6.0 * np.cos(lat) + 2.0 * np.sin(
            2 * np.pi * tsec / (10 * 86400.0) + lon)
        v_t = 1.5 * np.sin(2 * lon + 2 * np.pi * tsec / (5 * 86400.0))
        u_wind[i], v_wind[i] = latlon_vector_rotation_forward(
            u_t, v_t, mesh.x_cell, mesh.y_cell, mesh.z_cell)
    return times, {"airTemperature": t_air, "airSpecificHumidity": q,
                   "uAirVelocity": u_wind, "vAirVelocity": v_wind}


def cloud_fraction(mesh):
    """Cloud fraction by latitude, [nCells]."""
    return 0.5 + 0.3 * np.sin(np.abs(mesh.lat_cell))


def polar_sst(mesh, polar_latitude=65.0):
    """Sea surface temperature (C): -1.7 poleward of polar_latitude,
    warming towards the equator elsewhere, [nCells]."""
    lat = mesh.lat_cell
    return np.where(np.abs(lat) > np.deg2rad(polar_latitude), -1.7,
                    8.0 + 14.0 * np.cos(lat) ** 2)


def write_forcing_files(outdir, mesh):
    """Write `core_sixhourly.nc`, `core_monthly.nc` and `ocean.nc` for
    `mesh` into outdir; returns their three paths."""
    from scipy.io import netcdf_file

    nc = mesh.n_cells

    def write(path, times, fields):
        f = netcdf_file(path, "w")
        f.createDimension("Time", len(times))
        f.createDimension("nCells", nc)
        v = f.createVariable("xtime_seconds", "d", ("Time",))
        v[:] = times
        for k, a in fields.items():
            v = f.createVariable(k, "d", ("Time", "nCells"))
            v[:] = a
        f.close()

    paths = [os.path.join(outdir, n) for n in
             ("core_sixhourly.nc", "core_monthly.nc", "ocean.nc")]
    write(paths[0], *six_hourly_atmosphere(mesh))
    tm = (np.arange(12) + 0.5) * (365.0 * 86400.0 / 12)
    write(paths[1], tm, {
        "cloudFraction": np.tile(cloud_fraction(mesh)[None, :], (12, 1)),
        "rainfallRate": np.full((12, nc), 2e-6)})
    write(paths[2], tm, {
        "seaSurfaceTemperature": np.tile(polar_sst(mesh)[None, :], (12, 1)),
        "seaSurfaceSalinity": np.full((12, nc), 34.0),
        "uOceanVelocity": np.zeros((12, nc)),
        "vOceanVelocity": np.zeros((12, nc)),
        "oceanMixedLayerDepth": np.full((12, nc), 20.0)})
    return paths
