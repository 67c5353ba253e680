"""What the reference's column phases share: Icepack's constants, the
column's tracer tree, the mushy-layer relations (Turner, Hunke and Bitz
2013; Icepack `ice_mushy_physics.F90`), the thickness categories and the
Bitz and Lipscomb salinity profile (`ice_colpkg.F90`), and the check of
the options that the column phases implement.

The column state is the flat state's tracers: [nc, ncat] per category,
[nc, ncat, nlayers] per layer, the ice and snow volumes as volumes per
cell area."""

from __future__ import annotations

import math

import numpy as np
import torch

# Icepack's physical constants (ice_constants_colpkg.F90)
RHOI, RHOS, RHOW, RHOFRESH = 917.0, 330.0, 1026.0, 1000.0
CP_AIR, CP_ICE, CP_OCN = 1005.0, 2106.0, 4218.0
LSUB, LVAP = 2.835e6, 2.501e6
LFRESH = LSUB - LVAP
DEPRESST = 0.054
EMISSIVITY, STEFAN_BOLTZMANN = 0.95, 567.0e-10
TFFRESH = 273.15
GRAVIT, VONKAR, ZVIR = 9.80616, 0.4, 0.606
ZREF, ICERUF = 10.0, 0.0005
QQQICE, TTTICE = 11637800.0, 5897.8
KICE, KSNO = 2.03, 0.30
HS_MIN = 1.0e-4
HFRAZILMIN = 0.05
ICE_REF_SALINITY = 4.0
PUNY = 1.0e-11
CPRHO = CP_OCN * RHOW
VISCOSITY_DYN = 1.79e-3
SALTMAX, NSAL, MSAL, MIN_SALIN = 3.2, 0.407, 0.573, 0.1

# the Registry's defaults of the tunables the column reads
CONGELATION_PHI = 0.85          # config_congelation_ice_porosity
RA_CRIT = 10.0                  # config_rapid_model_critical_Ra
CHANNEL_RADIUS = 0.5e-3         # config_rapid_mode_channel_radius (m)
ASPECT_RATIO = 1.0              # config_rapid_mode_aspect_ratio
SLOW_STRENGTH = -5.0e-8         # config_slow_mode_drainage_strength
SLOW_PHI_CRIT = 0.05            # config_slow_mode_critical_porosity
USTAR_MIN = 0.0005              # config_min_friction_velocity (m/s)
CF_RIDGE = 17.0                 # config_ratio_ridging_work_to_PE
KALG = 0.6                      # config_algae_absorption_coefficient
HS1_POND = 0.03                 # config_snow_on_pond_ice_tapering_...
RFRACMIN, RFRACMAX = 0.15, 0.85
PNDASPECT = 0.8
HI_MIN_POND = 0.01
MU_RDG = 4.0

# the column's tracer tree, from the Registry's tracer hierarchy as the
# program carries it: (name, parent, stored as a product with its
# parent).  Departure: the ice age rides on the ice area (Icepack's
# trcr_depend puts it on the ice volume), as in the program.
TREE = (("iceAreaCategory", None, False),
        ("iceVolumeCategory", "iceAreaCategory", True),
        ("snowVolumeCategory", "iceAreaCategory", True),
        ("surfaceTemperature", "iceAreaCategory", False),
        ("iceEnthalpy", "iceVolumeCategory", False),
        ("iceSalinity", "iceVolumeCategory", False),
        ("snowEnthalpy", "snowVolumeCategory", False),
        ("iceAge", "iceAreaCategory", False),
        ("firstYearIceArea", "iceAreaCategory", False),
        ("levelIceArea", "iceAreaCategory", False),
        ("levelIceVolume", "iceVolumeCategory", False),
        ("pondArea", "levelIceArea", False),
        ("pondDepth", "pondArea", False),
        ("pondLidThickness", "pondArea", False))
TRACERS = tuple(n for n, _, _ in TREE)
# how the ITD, the new ice and ridging conserve each tracer: as area x
# tracer, ice volume x tracer or snow volume x tracer (the program's
# first-order grouping: a pond tracer moves with its category's area)
AREA_TRACERS = ("surfaceTemperature", "iceAge", "firstYearIceArea",
                "levelIceArea", "pondArea", "pondDepth", "pondLidThickness")
ICE_TRACERS = ("iceEnthalpy", "iceSalinity", "levelIceVolume")
SNOW_TRACERS = ("snowEnthalpy",)

# the options the column phases implement, as the configuration file's
# "column" group states them; every other option is the program's default
IMPLEMENTED = {"use_column_package": True, "ktherm": 2, "shortwave": "dEdd",
               "pond_scheme": "lvl", "use_level_ice": True,
               "use_ice_age": True, "use_first_year_ice": True,
               "kstrength": 1, "krdg_partic": 1, "krdg_redist": 1,
               "kitd": 1}


def check_column(conf: dict):
    """Raises NotImplementedError naming an option of the configuration
    that the column phases do not implement."""
    col = conf.get("column", {})
    for k, v in col.items():
        if k not in IMPLEMENTED:
            raise NotImplementedError(
                f"the reference's column implements no column.{k} "
                f"(only {sorted(IMPLEMENTED)})")
        if v != IMPLEMENTED[k]:
            raise NotImplementedError(
                f"the reference's column implements column.{k} = "
                f"{IMPLEMENTED[k]!r}, not {v!r}")
    missing = set(IMPLEMENTED) - set(col)
    if missing:
        raise NotImplementedError(
            f"the reference's column needs column.{sorted(missing)[0]} = "
            f"{IMPLEMENTED[sorted(missing)[0]]!r} stated")
    if conf.get("tracer_tree") != "column":
        raise NotImplementedError(
            "the reference's column implements tracer_tree = 'column', "
            f"not {conf.get('tracer_tree')!r}")
    if conf.get("velocity", {}).get("dynamics_subcycle_number", 1) != 1:
        raise NotImplementedError(
            "the reference's column implements one dynamics subcycle")


def category_bounds(ncat: int) -> list:
    """hin_max[0..ncat] (Icepack kcatbound = 0, kitd = 1), as floats."""
    h = [0.0]
    c1 = 3.0 / ncat
    for n in range(1, ncat + 1):
        x1 = (n - 1) / ncat
        h.append(h[-1] + c1 + 15.0 * c1 * (1.0 + math.tanh(3.0 * (x1 - 1.0))))
    return h


def bl99_salinity(ni: int) -> np.ndarray:
    """Bitz and Lipscomb's (1999) salinity of each ice layer (ppt)."""
    zn = (np.arange(1, ni + 1) - 0.5) / ni
    s = 0.5 * SALTMAX * (1.0 - np.cos(np.pi * zn ** (NSAL / (MSAL + zn))))
    return np.maximum(s, MIN_SALIN)


# -- mushy-layer relations (Turner et al. 2013, eqs. 13-20) -------------------

CW = CP_OCN * RHOW          # brine volumetric heat capacity
CI = CP_ICE * RHOI          # ice volumetric heat capacity
LI = LFRESH * RHOI          # ice volumetric latent heat
# the two branches of the liquidus, T = S / (a + b S) + c, broken at TB
_AZ = (-18.48, -10.3085)
_BZ = (0.0, 62.4)
TB = -7.6362968855167352
SB = 123.66702800276086


def brine_salinity(T):
    """The liquidus' brine salinity (ppt) at temperature T (C); 0 above
    0 C."""
    out = torch.zeros_like(T)
    for i, warm in ((0, T > TB), (1, T <= TB)):
        az, bz = _AZ[i], _BZ[i]
        s = (T + bz / az) / (T / 1000.0 + (1.0 + bz / 1000.0) / az)
        out = torch.where(warm, s, out)
    return torch.where(T <= 0.0, out, 0.0)


def liquidus_temperature(S):
    """The liquidus' temperature (C) of brine of salinity S."""
    t = []
    for i in (0, 1):
        az, bz = _AZ[i], _BZ[i]
        t.append(S / (az - az / 1000.0 * S) - bz / az)
    return torch.where(S <= SB, t[0], t[1])


def liquid_fraction(T, S):
    return S / torch.maximum(brine_salinity(T).clamp(min=PUNY), S)


def enthalpy_fixed_phi(T, phi):
    """The mush's enthalpy (J m-3) at temperature T and liquid fraction
    phi."""
    return phi * (CW - CI) * T + CI * T - (1.0 - phi) * LI


def enthalpy_mush(T, S):
    return enthalpy_fixed_phi(T, liquid_fraction(T, S))


def enthalpy_of_melting(S):
    return CW * liquidus_temperature(S)


def temperature_mush(q, S):
    """The temperature of mush of enthalpy q and bulk salinity S: the root
    of the quadratic that q(T, S) is on each branch of the liquidus, or
    q / cw where the mush has melted."""
    ts = []
    for i in (0, 1):
        az, bz = _AZ[i], _BZ[i]
        ap, bp = az / 1000.0, bz / 1000.0
        a = ap * (CW - CI) * S + CI * az
        b = ((1.0 + bp) * (CW - CI) + LI * ap) * S - az * q + \
            CI * bz - LI * az
        c = LI * (1.0 + bp) * S - bz * q - LI * bz
        ts.append((-b + torch.sqrt((b * b - 4.0 * a * c).clamp(min=PUNY)))
                  / (2.0 * a))
    az, bz = _AZ[0], _BZ[0]
    qb = ((1.0 + az / 1000.0 * TB + bz / 1000.0) / (az * TB + bz)) * \
        ((CW - CI) * TB + LI) * S + CI * TB - LI
    t = torch.where(q > qb, ts[0], ts[1])
    q_liq = torch.where(S < SB, -1000.0 * CW * S / (az * (-1000.0 + S)) -
                        bz * CW / az,
                        -1000.0 * CW * S / (_AZ[1] * (-1000.0 + S)) -
                        _BZ[1] * CW / _AZ[1])
    return torch.where(q > q_liq, q / CW, t)


def brine_density(S):
    return 1000.3 + 0.78237 * S + 2.8008e-4 * S * S


def mush_conductivity(q, S):
    phi = liquid_fraction(temperature_mush(q, S), S)
    return 2.3 * (1.0 - phi) + 0.5375 * phi


def snow_enthalpy(T):
    return -RHOS * (LFRESH - CP_ICE * T)


def snow_temperature(q):
    return (LFRESH + q / RHOS) / CP_ICE


def per_area(x, a):
    """x / a where a > puny, else 0."""
    ok = a > PUNY
    return torch.where(ok, x / torch.where(ok, a, 1.0), 0.0)
