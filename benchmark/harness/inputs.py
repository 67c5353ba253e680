"""The cells' inputs, made from the traffic file and the seed: the polar
caps of ice (the initial state), the analytic wind and, for a cell whose
column is on, the column's atmosphere, ocean and sun.

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

import math

import numpy as np
import torch

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


# the fields of the program's AtmosForcing and OceanForcing
# (`seaice_tpu_torch/column/driver.py`), by name
ATMOS = ("air_temperature", "specific_humidity", "u_air", "v_air",
         "longwave_down", "sw_vis_dir", "sw_vis_dif", "sw_ir_dir",
         "sw_ir_dif", "rain_rate", "snow_rate", "air_density",
         "air_level_height")
OCEAN = ("sst", "sss", "freezing_temperature", "frzmlt",
         "mixed_layer_depth")
# CICE's fixed split of the downward shortwave into its four bands
SW_SHARES = {"sw_vis_dir": 0.28, "sw_vis_dif": 0.24, "sw_ir_dir": 0.31,
             "sw_ir_dif": 0.17}
SUN = ("coszen",) + tuple(SW_SHARES)
SOLAR_CONSTANT = 1361.0        # W m-2 (Kopp and Lean 2011)
AIR_DENSITY = 1.3              # kg m-3, as the dynamics' forcing has it
SECONDS_PER_DAY = 86400.0


def cap_weight(lat, traffic) -> np.ndarray:
    """1 poleward of the caps' edge, 0 equatorward, a smooth step of
    the column forcing's `edge_width_deg` in |lat|."""
    cf = traffic["column_forcing"]
    x = (np.abs(lat) - np.deg2rad(traffic["cap_latitude_deg"])) / \
        np.deg2rad(cf["edge_width_deg"])
    return 0.5 * (1.0 + np.tanh(x))


def air_temperature_c(lat, traffic) -> np.ndarray:
    """Linear in sin|lat| from the caps' edge to the pole, carried as far
    equatorward of the edge again and constant beyond."""
    cf = traffic["column_forcing"]
    s0 = np.sin(np.deg2rad(traffic["cap_latitude_deg"]))
    s = np.maximum((np.sin(np.abs(lat)) - s0) / (1.0 - s0), -1.0)
    t_edge = cf["air_temperature_edge_c"]
    return t_edge + (cf["air_temperature_pole_c"] - t_edge) * s


def sun(lat, lon, seconds, traffic) -> dict:
    """The cosine of the solar zenith angle, clipped at 0 (night), and
    the downward shortwave of each band (W m-2), {name: float64 tensor
    [n_times, n_cells]}, at `seconds` (seconds since the start of the
    year, UTC; [n_times]) over cells at lat and lon (radians; float64
    tensors [n_cells], any device).  The declination is Cooper's (1969),
    23.44 sin(2 pi (284 + day) / 365) degrees, the distance factor
    1 + 0.033 cos(2 pi day / 365) (Duffie and Beckman), the hour angle
    the time of day from local noon at longitude lon (no equation of
    time).  The shortwave is the solar constant through the column
    forcing's `shortwave_transmissivity`, split into the bands by
    `SW_SHARES`."""
    t = torch.as_tensor(seconds, dtype=torch.float64,
                        device=lat.device).reshape(-1, 1)
    day = torch.floor(t / SECONDS_PER_DAY) + 1.0
    decl = math.radians(23.44) * torch.sin(2 * math.pi * (284.0 + day) /
                                           365.0)
    eccf = 1.0 + 0.033 * torch.cos(2 * math.pi * day / 365.0)
    hour = 2 * math.pi * torch.remainder(t, SECONDS_PER_DAY) / \
        SECONDS_PER_DAY - math.pi + lon[None, :]
    cz = (torch.sin(lat)[None, :] * torch.sin(decl) +
          torch.cos(lat)[None, :] * torch.cos(decl) * torch.cos(hour))
    cz = cz.clamp(min=0.0)
    total = SOLAR_CONSTANT * eccf * cz * \
        traffic["column_forcing"]["shortwave_transmissivity"]
    out = {"coszen": cz}
    out.update({k: share * total for k, share in SW_SHARES.items()})
    return out


def column_forcing(mesh, traffic, seed, seconds=None) -> dict:
    """The column's forcing from the traffic's "column_forcing" group, as
    float64 numpy arrays [nCells] named as the program's AtmosForcing and
    OceanForcing fields (units there): air temperature linear in sin|lat|
    from the caps' edge to the pole; humidity, longwave, rain and snow
    uniform; the analytic wind and its air density; the ocean at its
    freezing temperature under the caps, at `sst_open_c` equatorward, and
    its freezing potential `frzmlt_cap_w_m2` under the caps,
    `frzmlt_open_w_m2` (melting, < 0) equatorward; salinity and mixed
    layer uniform.  The seed jitters the air temperature (additively, by
    `air_temperature_jitter_c`) and humidity, longwave, rain and snow (by
    the share `jitter`) with smooth fields.  The shortwave is the sun's
    at `seconds` (default: midnight of the traffic's first day)."""
    cf = traffic["column_forcing"]
    xyz = unit_xyz(mesh)
    lat, lon = np.asarray(mesh.lat_cell), np.asarray(mesh.lon_cell)
    rng = rng_for(seed, "column")
    modes = traffic["jitter_modes"]
    w = cap_weight(lat, traffic)
    one = np.ones(len(xyz))

    def jit():
        return smooth_jitter(xyz, rng, cf["jitter"], modes)

    t_air = air_temperature_c(lat, traffic) + (smooth_jitter(
        xyz, rng, cf["air_temperature_jitter_c"], modes) - 1.0)
    uw, vw = analytic_wind(mesh, traffic, seed)
    out = {
        "air_temperature": t_air + 273.15,
        "specific_humidity": cf["specific_humidity"] * jit(),
        "u_air": uw, "v_air": vw,
        "longwave_down": cf["longwave_down_w_m2"] * jit(),
        "rain_rate": cf["rain_rate_kg_m2_s"] * jit(),
        "snow_rate": cf["snow_rate_kg_m2_s"] * jit(),
        "air_density": AIR_DENSITY * one,
        "air_level_height": cf["air_level_height_m"] * one,
    }
    if seconds is None:
        seconds = (traffic["start_day_of_year"] - 1) * SECONDS_PER_DAY
    s = sun(torch.as_tensor(lat), torch.as_tensor(lon), [seconds], traffic)
    out.update({k: s[k][0].numpy() for k in SW_SHARES})
    tf = cf["freezing_temperature_c"]
    out.update({
        "sst": tf + (cf["sst_open_c"] - tf) * (1.0 - w),
        "sss": cf["sss_ppt"] * one,
        "freezing_temperature": tf * one,
        "frzmlt": cf["frzmlt_cap_w_m2"] * w +
        cf["frzmlt_open_w_m2"] * (1.0 - w),
        "mixed_layer_depth": cf["mixed_layer_depth_m"] * one,
    })
    return {k: out[k] for k in ATMOS + OCEAN}


def steps_per_day(dt) -> int:
    n = SECONDS_PER_DAY / dt
    if n != int(n):
        raise ValueError(f"dt {dt} s does not divide a day")
    return int(n)


class ColumnInputs:
    """The column forcing of one side, on its own mesh: the fields that
    do not follow the sun (`column_forcing`), and the sun of any step.
    The sun repeats the run's first simulated day: step n (from the
    clock's start) has the sun of `start + (n mod steps a day) x dt`, so
    one day of steps, tabled once at set-up, serves a window of any
    length.  The calendar day the model is given follows the clock."""

    def __init__(self, mesh, traffic, seed, dt, start):
        self.traffic = traffic
        self.dt, self.start = float(dt), float(start)
        self.per_day = steps_per_day(dt)
        self.lat = np.asarray(mesh.lat_cell, np.float64)
        self.lon = np.asarray(mesh.lon_cell, np.float64)
        self.fields = column_forcing(mesh, traffic, seed, self.start)

    def sun_seconds(self, n: int) -> float:
        return self.start + (n % self.per_day) * self.dt

    def day_of_year(self, n: int) -> int:
        return int((self.start + n * self.dt) // SECONDS_PER_DAY) + 1

    def step_of(self, seconds: float) -> int:
        """The step whose start the clock reads `seconds`."""
        return int(round((seconds - self.start) / self.dt))

    def sun_table(self, device) -> dict:
        """{name: float64 tensor [steps a day, nCells]} on device, the
        sun of each step of the first day."""
        lat = torch.as_tensor(self.lat, device=device)
        lon = torch.as_tensor(self.lon, device=device)
        rows = [sun(lat, lon, [self.sun_seconds(i)], self.traffic)
                for i in range(self.per_day)]
        return {k: torch.cat([r[k] for r in rows]) for k in SUN}

    def at(self, n: int) -> dict:
        """The forcing of step n, float64 numpy: every field, with the
        sun's (and "coszen") at that step."""
        s = sun(torch.as_tensor(self.lat), torch.as_tensor(self.lon),
                [self.sun_seconds(n)], self.traffic)
        out = dict(self.fields)
        out.update({k: s[k][0].numpy() for k in SUN})
        return out
