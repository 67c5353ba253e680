"""Solar zenith angle for the radiation schemes.

Port of the JAX package's `column/orbital.py`, its stand-in for the
reference's orbital machinery (`ice_orbital.F90` wrapping shr_orb_mod:
Berger 1978 orbital parameters -> declination + eccentricity factor ->
cosine zenith, used by compute_coszen for the dEdd shortwave).  The
declination and Earth-sun distance factor come from the Spencer (1971)
Fourier series — within ~0.01 rad of the Berger series for the modern
epoch — so the whole computation is a handful of trig ops.  Arguments
may be tensors or Python numbers (numbers become float64 tensors).
"""

from __future__ import annotations

import math

import torch

SECONDS_PER_DAY = 86400.0


def _tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(
        x, dtype=torch.float64)


def solar_declination(day_of_year):
    """Solar declination delta (radians) and inverse-square distance
    factor (Spencer 1971)."""
    g = 2.0 * math.pi * (_tensor(day_of_year) - 1.0) / 365.0
    decl = (0.006918 - 0.399912 * torch.cos(g) + 0.070257 * torch.sin(g)
            - 0.006758 * torch.cos(2 * g) + 0.000907 * torch.sin(2 * g)
            - 0.002697 * torch.cos(3 * g) + 0.001480 * torch.sin(3 * g))
    eccf = (1.000110 + 0.034221 * torch.cos(g) + 0.001280 * torch.sin(g)
            + 0.000719 * torch.cos(2 * g) + 0.000077 * torch.sin(2 * g))
    return decl, eccf


def compute_coszen(lat, lon, day_of_year, seconds_today):
    """Cosine of the solar zenith angle, clipped at 0 (night), as the
    dEdd shortwave expects (reference compute_coszen,
    ice_orbital.F90 / shr_orb_decl use in mpas_seaice_column.F).

    lat/lon radians (tensors or numbers); day_of_year 1-based;
    seconds_today UTC seconds since midnight. Returns (coszen,
    eccentricity_factor).
    """
    decl, eccf = solar_declination(day_of_year)
    lat, lon = _tensor(lat), _tensor(lon)
    hour_angle = (2.0 * math.pi * _tensor(seconds_today) /
                  SECONDS_PER_DAY - math.pi) + lon
    cosz = (torch.sin(lat) * torch.sin(decl) +
            torch.cos(lat) * torch.cos(decl) * torch.cos(hour_angle))
    return cosz.clamp(min=0.0), eccf
