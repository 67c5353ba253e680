"""The cells' inputs, made from the traffic file and the seed: the polar
caps of ice (the initial state) and the analytic wind.

Every seeded quantity is a smooth function of a cell's position on the
sphere (a few Fourier modes with seeded wave vectors and phases), never of
its index, so the program's mesh and the reference's, whose cells may be
numbered differently, receive the same field.  Every seed gives the same
caps, the same mean thickness and the same wind speeds: the seed moves
the pattern, not the amount of work.

The thermodynamic profiles are Icepack's (CICE column package): the
category boundaries of `kcatbound = 0`, Bitz and Lipscomb's salinity
profile and the enthalpies of brine-pocket ice and of snow.

A mesh here is the program's (`x_cell`, `y_cell`, `z_cell`, `lat_cell`,
`lon_cell`) or the reference's (`cell_xyz`, `lat_cell`, `lon_cell`)."""

from __future__ import annotations

import numpy as np

RHOI, RHOS = 917.0, 330.0
CP_ICE, CP_OCN = 2106.0, 4218.0
LFRESH = 2.835e6 - 2.501e6
DEPRESST = 0.054
SALTMAX, NSAL, MSAL, MIN_SALIN = 3.2, 0.407, 0.573, 0.1


def category_boundaries(n_cat: int) -> np.ndarray:
    """The thickness categories' bounds (Icepack, kcatbound = 0)."""
    h = np.zeros(n_cat + 1)
    c1 = 3.0 / n_cat
    for n in range(1, n_cat + 1):
        x1 = (n - 1) / n_cat
        h[n] = h[n - 1] + c1 + 15.0 * c1 * (1.0 + np.tanh(3.0 * (x1 - 1.0)))
    return h


def salinity_profile(n_ice: int) -> np.ndarray:
    """Bitz and Lipscomb's (1999) salinity of each ice layer (ppt)."""
    zn = (np.arange(1, n_ice + 1) - 0.5) / n_ice
    s = 0.5 * SALTMAX * (1.0 - np.cos(np.pi * zn ** (NSAL / (MSAL + zn))))
    return np.maximum(s, MIN_SALIN)


def ice_enthalpy(t, salinity):
    """Enthalpy (J m-3) of brine-pocket ice at t (C) and salinity."""
    tm = -DEPRESST * salinity
    return -RHOI * (CP_ICE * (tm - t) + LFRESH * (1.0 - tm / t) -
                    CP_OCN * tm)


def snow_enthalpy(t):
    return -RHOS * (LFRESH - CP_ICE * t)


def cell_xyz(mesh) -> np.ndarray:
    if hasattr(mesh, "cell_xyz"):
        return np.asarray(mesh.cell_xyz)
    return np.stack([mesh.x_cell, mesh.y_cell, mesh.z_cell], axis=1)


def east_north(p):
    """Unit east and north vectors [n, 3] at points p [n, 3]."""
    r = p / np.linalg.norm(p, axis=1, keepdims=True)
    e = np.cross(np.array([0.0, 0.0, 1.0]), r)
    e /= np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-300)
    return e, np.cross(r, e)


def to_rotated_grid(u, v, xyz):
    """Vector components (east, north) at points xyz -> (east, north) of
    the rotated grid, whose pole (0, 0, 1) is turned to (-1, 0, 0)."""
    def rot(a):
        return np.stack([-a[:, 2], a[:, 1], a[:, 0]], 1)

    e, n = east_north(xyz)
    vec = rot(u[:, None] * e + v[:, None] * n)
    er, nr = east_north(rot(xyz))
    return (vec * er).sum(1), (vec * nr).sum(1)


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named use of the seed (any non-negative
    integer, of any size)."""
    tag = int.from_bytes(stream.encode(), "little")
    return np.random.default_rng([int(seed) % (1 << 64), tag])


def unit_xyz(mesh) -> np.ndarray:
    xyz = cell_xyz(mesh)
    return xyz / np.linalg.norm(xyz, axis=1, keepdims=True)


def smooth_jitter(xyz: np.ndarray, rng: np.random.Generator, amplitude,
                  n_modes: int) -> np.ndarray:
    """1 + a field of standard deviation `amplitude`, smooth on the sphere
    (wavelengths of 2,000 to 10,000 km), clipped to 1 +- 2 amplitude."""
    k = rng.normal(size=(n_modes, 3))
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    k *= rng.uniform(4.0, 20.0, size=(n_modes, 1))
    phase = rng.uniform(0.0, 2 * np.pi, size=n_modes)
    f = np.sin(xyz @ k.T + phase).sum(1) * np.sqrt(2.0 / n_modes)
    return 1.0 + amplitude * np.clip(f, -2.0, 2.0)


def caps_state(mesh, n_cat, n_ice, n_snow, traffic, seed):
    """The initial tracers of the polar caps as float64 numpy arrays:
    iceAreaCategory, iceVolumeCategory, snowVolumeCategory,
    surfaceTemperature, iceEnthalpy, iceSalinity, snowEnthalpy."""
    xyz = unit_xyz(mesh)
    nc = len(xyz)
    rng = rng_for(seed, "caps")
    polar = np.abs(mesh.lat_cell) > np.deg2rad(traffic["cap_latitude_deg"])
    h = category_boundaries(n_cat)
    mids = 0.5 * (h[:-1] + np.minimum(h[1:], 10.0))
    jh = smooth_jitter(xyz, rng, traffic["thickness_jitter"],
                       traffic["jitter_modes"])
    js = smooth_jitter(xyz, rng, traffic["snow_jitter"],
                       traffic["jitter_modes"])
    area = np.where(polar[:, None], traffic["concentration"] / n_cat, 0.0) \
        * np.ones((1, n_cat))
    has = area > 0
    vol = area * mids[None, :] * jh[:, None]
    snow = area * traffic["snow_depth_m"] * js[:, None]

    S = np.tile(salinity_profile(n_ice), (nc, n_cat, 1))
    qi = ice_enthalpy(traffic["ice_temperature_c"], S)
    qs = np.full((nc, n_cat, n_snow),
                 snow_enthalpy(traffic["snow_temperature_c"]))
    out = {
        "iceAreaCategory": area,
        "iceVolumeCategory": vol,
        "snowVolumeCategory": snow,
        "surfaceTemperature": np.where(
            has, traffic["surface_temperature_c"], 0.0),
        "iceEnthalpy": qi * has[..., None],
        "iceSalinity": S * has[..., None],
        "snowEnthalpy": qs * has[..., None],
    }
    return out


def analytic_wind(mesh, traffic, seed):
    """The analytic wind of the dynamical-core cells, its travelling
    pattern shifted in longitude by the seed: (u, v) [nCells] east and
    north in the rotated grid."""
    rng = rng_for(seed, "wind")
    p1, p2 = rng.uniform(0.0, 2 * np.pi, size=2)
    lat, lon = mesh.lat_cell, mesh.lon_cell
    s = traffic.get("wind_scale", 1.0)
    u_t = s * (6.0 * np.cos(lat) + 2.0 * np.sin(lon + p1))
    v_t = s * 1.5 * np.sin(2 * lon + p2)
    return to_rotated_grid(u_t, v_t, cell_xyz(mesh))


def start_seconds(traffic, dt, seed) -> float:
    """The clock's start, seconds since the start of the year: the
    traffic's first day, moved on by a seeded whole number of steps under
    `start_shift_max_s` (the forcing's phase against the run, the time
    of day of the sun)."""
    n = int(traffic.get("start_shift_max_s", 0.0) // dt)
    k = int(rng_for(seed, "start").integers(0, n + 1))
    return (traffic["start_day_of_year"] - 1) * 86400.0 + k * dt
