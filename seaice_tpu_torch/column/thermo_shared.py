"""Enthalpy/temperature relations and surface fluxes shared across the
thermodynamics schemes (reference `ice_therm_shared.F90` and the BL99
salinity profile from `ice_colpkg.F90:333-414`).

Enthalpy convention (BL99, brine-inclusive):
  ice:  q = -rhoi [ cp_ice (Tmlt - T) + Lfresh (1 - Tmlt/T) - cp_ocn Tmlt ]
  snow: q = -rhos [ Lfresh - cp_ice T ]
with Tmlt = -depressT * S. All temperatures in deg C, q in J/m^3.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as c


def salinity_profile(n_ice_layers: int) -> np.ndarray:
    """BL99 fixed vertical salinity profile (reference
    colpkg_init_thermo, ice_colpkg.F90:333-386)."""
    k = np.arange(1, n_ice_layers + 1)
    zn = (k - 0.5) / n_ice_layers
    s = (c.SALTMAX / 2.0) * (1.0 - np.cos(np.pi * zn **
                                          (c.NSAL / (c.MSAL + zn))))
    return np.maximum(s, c.MIN_SALIN)


def melting_temperature(salinity):
    return -c.DEPRESST * salinity


def ice_enthalpy_from_temperature(T, Tmlt):
    """q(T) for brine-inclusive sea ice (T < 0)."""
    return -c.RHOI * (c.CP_ICE * (Tmlt - T) +
                      c.LFRESH * (1.0 - Tmlt / T.clamp(max=-c.PUNY)) -
                      c.CP_OCN * Tmlt)


def ice_temperature_from_enthalpy(q, Tmlt):
    """Invert q(T): aT^2 + bT + c0 = 0 with the physical (negative) root
    (reference calculate_Tin_from_qin, ice_therm_shared.F90)."""
    a = c.CP_ICE
    b = (c.CP_OCN - c.CP_ICE) * Tmlt - q / c.RHOI - c.LFRESH
    c0 = c.LFRESH * Tmlt
    disc = torch.sqrt((b * b - 4.0 * a * c0).clamp(min=0.0))
    T = -(b + disc) / (2.0 * a)
    return T.clamp(max=-c.PUNY)


def snow_enthalpy_from_temperature(T):
    return -c.RHOS * (c.LFRESH - c.CP_ICE * T)


def init_thermo_tracers(tracers, n_ice_layers, n_snow_layers, dtype,
                        surface_temperature=-1.0,
                        bottom_temperature=-1.8):
    """Fill physical enthalpy/salinity/surface-temperature profiles for
    cells that carry ice (the colpkg_init_trcr analog, reference
    `ice_colpkg.F90` init_trcr via seaice_init `mpas_seaice_initialize.F`):
    a linear temperature profile from the (capped-below-melting) surface
    temperature to the ocean freezing point, the BL99 fixed salinity
    profile, and consistent snow enthalpy.  Ice-free cells get zeros.
    Entries already set to something non-zero are left untouched, so
    callers that build their own profiles (tests, benches) are not
    overridden."""
    tr = dict(tracers)
    if "iceEnthalpy" not in tr:
        return tr
    area = tr["iceAreaCategory"]
    dev = area.device
    has = area > 0
    ni, ns = n_ice_layers, n_snow_layers
    already = bool(tr["iceEnthalpy"].abs().max() > 0)
    if "iceSalinity" in tr:
        already = already or bool(tr["iceSalinity"].abs().max() > 0)
    if already:
        return tr
    sal = torch.as_tensor(salinity_profile(ni)).to(
        device=dev, dtype=dtype).expand(area.shape + (ni,))
    tsfc = torch.where(
        has, tr["surfaceTemperature"].clamp(max=surface_temperature), 0.0)
    tr["surfaceTemperature"] = tsfc
    frac = (torch.arange(ni, dtype=dtype, device=dev) + 0.5) / ni
    Tprof = tsfc[..., None] * (1.0 - frac) + bottom_temperature * frac
    Tmlt = melting_temperature(sal)
    Tprof = torch.minimum(Tprof, Tmlt)
    tr["iceEnthalpy"] = torch.where(
        has[..., None], ice_enthalpy_from_temperature(Tprof, Tmlt), 0.0)
    if "iceSalinity" in tr:
        tr["iceSalinity"] = torch.where(has[..., None], sal, 0.0)
    if "snowEnthalpy" in tr:
        qs = snow_enthalpy_from_temperature(tsfc)[..., None]
        tr["snowEnthalpy"] = torch.where(
            has[..., None], qs.expand(area.shape + (ns,)), 0.0)
    return tr


def snow_temperature_from_enthalpy(q):
    return (c.LFRESH + q / c.RHOS) / c.CP_ICE


def surface_heat_flux(Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef):
    """Net surface flux (excluding conduction) and components
    (reference surface_heat_flux, ice_therm_shared.F90).
    Returns (flwout, fsens, flat, fsurf)."""
    TsfK = Tsf + c.TFFRESH
    qsat = c.QQQICE * torch.exp(-c.TTTICE / TsfK)
    Qsfc = qsat / rhoa
    flwdabs = c.EMISSIVITY * flw
    flwout = -c.EMISSIVITY * c.STEFAN_BOLTZMANN * TsfK ** 4
    fsens = shcoef * (potT - TsfK)
    flat = lhcoef * (Qa - Qsfc)
    fsurf = fswsfc + flwdabs + flwout + fsens + flat
    return flwout, fsens, flat, fsurf


def dsurface_heat_flux_dTsf(Tsf, rhoa, shcoef, lhcoef):
    """d(fluxes)/dTsf (reference dsurface_heat_flux_dTsf).
    Returns (dflwout, dfsens, dflat, dfsurf)."""
    TsfK = Tsf + c.TFFRESH
    dQsfc = c.QQQICE * torch.exp(-c.TTTICE / TsfK) * c.TTTICE / \
        (TsfK ** 2 * rhoa)
    dflwout = -4.0 * c.EMISSIVITY * c.STEFAN_BOLTZMANN * TsfK ** 3
    dfsens = -shcoef
    dflat = -lhcoef * dQsfc
    dfsurf = dflwout + dfsens + dflat
    return dflwout, dfsens, dflat, dfsurf


def sea_freezing_temperature(sss, tfrz_option: str = "minus1p8"):
    """Ocean freezing temperature Tf(SSS) (reference
    colpkg_sea_freezing_temperature, ice_colpkg.F90:1664-1686):
    'minus1p8' -> constant -1.8 C; 'linear_salt' -> -depressT * sss;
    'mushy' -> the mushy liquidus (consistent with ktherm=2)."""
    if tfrz_option == "mushy":
        from .mushy import liquidus_temperature
        return liquidus_temperature(sss)
    if tfrz_option == "linear_salt":
        return -c.DEPRESST * sss
    sss = torch.as_tensor(sss)
    return torch.full_like(sss, c.TOCNFRZ, dtype=sss.dtype
                           if sss.is_floating_point() else torch.float64)
