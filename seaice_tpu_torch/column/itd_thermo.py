"""ITD thermodynamics (therm2 pieces): frazil new-ice formation and
lateral melt (reference `ice_therm_itd.F90`: add_new_ice :1027-1523,
lateral_melt :848-1005).  Port of the JAX package's
`column/itd_thermo.py`; vectorized over cells.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from . import constants as c
from .itd import set_cat


class NewIceResult(NamedTuple):
    aicen: torch.Tensor
    vicen: torch.Tensor
    area_tracers: Dict[str, torch.Tensor]
    ice_tracers: Dict[str, torch.Tensor]
    frazil: torch.Tensor       # frazil growth this step (m)
    dfresh: torch.Tensor       # freshwater flux change (kg/m^2/s)
    dfsalt: torch.Tensor       # salt flux change (kg/m^2/s)


def add_new_ice(dt, hin_max, aicen, vicen,
                area_tracers: Dict[str, torch.Tensor],
                ice_tracers: Dict[str, torch.Tensor],
                frzmlt, Tf, salin_profile: torch.Tensor,
                dilute_ponds: bool = False) -> NewIceResult:
    """Frazil ice formation in open water (reference add_new_ice,
    BL99 branch). salin_profile: [nIceLayers] fixed salinity profile,
    a tensor of the state's dtype and device.

    Tracer updates for new ice follow the reference: new ice is level
    (levelIceArea/Volume mix toward 1), first-year (firstYearIceArea
    toward 1), age 0 (iceAge diluted); pond tracers are diluted when
    they ride directly on the ice area (cesm/topo schemes,
    dilute_ponds=True) and untouched for level-ice ponds."""
    ncat = aicen.shape[-1]
    puny = c.PUNY

    aice = aicen.sum(-1)
    aice0 = (1.0 - aice).clamp(min=0.0)
    hi0max = float(hin_max[1]) * 0.9 if ncat > 1 else 1.0e8

    qi0new = -c.RHOI * c.LFRESH
    fnew = frzmlt.clamp(min=0.0)
    vi0new = -fnew * dt / qi0new
    frazil = vi0new

    # ocean fluxes from new ice formation (:update_ocn_f branch,
    # standalone always updates)
    dfresh = -c.RHOI * vi0new / dt
    dfsalt = c.ICE_REF_SALINITY * 1e-3 * dfresh

    # partition: new ice in open water vs spread under existing ice
    has_open = aice0 > puny
    hi0new = (vi0new / aice0.clamp(min=puny)).clamp(min=c.HFRAZILMIN)
    too_thick = (hi0new > hi0max) & (aice0 + puny < 1.0)
    hi0new = torch.where(too_thick, hi0max, hi0new)
    ai0new = torch.where(
        has_open,
        torch.where(too_thick, aice0, vi0new / hi0new.clamp(min=puny)),
        0.0)
    ai0new = torch.where(vi0new > 0.0, ai0new, 0.0)
    vsurp_tot = torch.where(
        has_open & too_thick, vi0new - ai0new * hi0new,
        torch.where(has_open, 0.0, vi0new))
    vsurp_tot = torch.where(vi0new > 0.0, vsurp_tot, 0.0)
    hsurp = vsurp_tot / aice.clamp(min=puny)
    hsurp = torch.where(aice > puny, hsurp, 0.0)
    vi0new_cat1 = torch.where(has_open, vi0new - vsurp_tot, 0.0)
    vi0new_cat1 = vi0new_cat1.clamp(min=0.0)

    # spread hsurp under all categories, mixing enthalpy/salinity
    new_it = dict(ice_tracers)
    sprof = salin_profile
    vsurp_n = hsurp[..., None] * aicen          # [*B, ncat]
    vtmp = vicen + vsurp_n
    if "iceEnthalpy" in new_it:
        q = new_it["iceEnthalpy"]
        mixed = (q * vicen[..., None] + qi0new * vsurp_n[..., None]) \
            / vtmp[..., None].clamp(min=puny)
        new_it["iceEnthalpy"] = torch.where(vtmp[..., None] > 0.0, mixed, q)
    if "iceSalinity" in new_it:
        s = new_it["iceSalinity"]
        sp = sprof.expand(s.shape)
        mixed = (s * vicen[..., None] + sp * vsurp_n[..., None]) \
            / vtmp[..., None].clamp(min=puny)
        new_it["iceSalinity"] = torch.where(vtmp[..., None] > 0.0, mixed, s)
    if "levelIceVolume" in new_it:
        # new frazil volume is all level ice
        vl = new_it["levelIceVolume"]
        mixed = (vl * vicen + vsurp_n) / vtmp.clamp(min=puny)
        new_it["levelIceVolume"] = torch.where(vtmp > 0.0, mixed, vl)
    vicen = vtmp

    # add category-1 new ice
    area1 = aicen[..., 0]
    vice1 = vicen[..., 0]
    a1 = area1 + ai0new
    v1 = vice1 + vi0new_cat1
    aicen = set_cat(aicen, 0, a1)
    vicen = set_cat(vicen, 0, v1)
    new_at = dict(area_tracers)
    if "surfaceTemperature" in new_at:
        t = new_at["surfaceTemperature"]
        t1 = (t[..., 0] * area1 + Tf * ai0new) / a1.clamp(min=puny)
        t1 = t1.clamp(max=0.0)
        new_at["surfaceTemperature"] = set_cat(
            t, 0, torch.where(a1 > puny, t1, t[..., 0]))

    def set_cat1_layers(t, value):
        y = t.clone()
        y[..., 0, :] = value
        return y

    if "iceEnthalpy" in new_it:
        q = new_it["iceEnthalpy"]
        q1 = (q[..., 0, :] * vice1[..., None] +
              qi0new * vi0new_cat1[..., None]) / \
            v1[..., None].clamp(min=puny)
        new_it["iceEnthalpy"] = set_cat1_layers(
            q, torch.where(v1[..., None] > puny, q1, q[..., 0, :]))
    if "iceSalinity" in new_it:
        s = new_it["iceSalinity"]
        sp = sprof.expand(s[..., 0, :].shape)
        s1 = (s[..., 0, :] * vice1[..., None] +
              sp * vi0new_cat1[..., None]) / \
            v1[..., None].clamp(min=puny)
        new_it["iceSalinity"] = set_cat1_layers(
            s, torch.where(v1[..., None] > puny, s1, s[..., 0, :]))

    def mix_area_cat1(name, new_value):
        if name not in new_at:
            return
        t = new_at[name]
        t1 = (t[..., 0] * area1 + new_value * ai0new) / a1.clamp(min=puny)
        new_at[name] = set_cat(t, 0, torch.where(a1 > puny, t1, t[..., 0]))

    mix_area_cat1("iceAge", 0.0)               # new ice has age 0
    mix_area_cat1("firstYearIceArea", 1.0)     # ... is first-year
    mix_area_cat1("levelIceArea", 1.0)         # ... is level
    if dilute_ponds:
        for name in ("pondArea", "pondDepth", "pondLidThickness"):
            mix_area_cat1(name, 0.0)
    if "levelIceVolume" in new_it:
        vl = new_it["levelIceVolume"]
        vl1 = (vl[..., 0] * vice1 + vi0new_cat1) / v1.clamp(min=puny)
        new_it["levelIceVolume"] = set_cat(
            vl, 0, torch.where(v1 > puny, vl1, vl[..., 0]))

    return NewIceResult(aicen=aicen, vicen=vicen,
                        area_tracers=new_at, ice_tracers=new_it,
                        frazil=frazil, dfresh=dfresh, dfsalt=dfsalt)


class LateralMeltResult(NamedTuple):
    aicen: torch.Tensor
    vicen: torch.Tensor
    vsnon: torch.Tensor
    meltl: torch.Tensor        # lateral melt volume (m)
    dfresh: torch.Tensor       # kg/m^2/s
    dfsalt: torch.Tensor
    dfhocn: torch.Tensor       # W/m^2 (negative: ocean loses heat)


def lateral_melt(dt, aicen, vicen, vsnon,
                 ice_enthalpy, snow_enthalpy, rside) -> LateralMeltResult:
    """Melt a fraction rside of every category laterally
    (reference lateral_melt, ice_therm_itd.F90:848-1005)."""
    r = rside[..., None]
    dfresh = ((c.RHOS * vsnon + c.RHOI * vicen) * r).sum(-1) / dt
    dfsalt = (c.RHOI * vicen * r).sum(-1) * \
        c.ICE_REF_SALINITY * 1e-3 / dt
    meltl = (vicen * r).sum(-1)
    aicen_n = aicen * (1.0 - r)
    vicen_n = vicen * (1.0 - r)
    vsnon_n = vsnon * (1.0 - r)
    # heat needed to melt the removed ice/snow comes from the ocean
    # (note the reference uses post-melt volumes in the flux; :960-973)
    dfhocn = (ice_enthalpy.mean(-1) * r * vicen_n).sum(-1) / dt \
        + (snow_enthalpy.mean(-1) * r * vsnon_n).sum(-1) / dt
    return LateralMeltResult(aicen=aicen_n, vicen=vicen_n, vsnon=vsnon_n,
                             meltl=meltl, dfresh=dfresh, dfsalt=dfsalt,
                             dfhocn=dfhocn)
