"""The reference's column thermodynamics before the dynamics, as
MPAS-Seaice's column package steps them (Icepack colpkg_step_therm1 and
therm2), for the standard physics: the delta-Eddington shortwave
(`column_shortwave.py`), the atmospheric boundary layer, the ice age and
first-year ice, the ocean's bottom and lateral heat, the mushy-layer
vertical thermodynamics (`column_vertical.py`), the level-ice melt ponds
(Hunke et al. 2013; `ice_meltpond_lvl.F90`), new ice, lateral melt and
the linear remapping of the thickness distribution (`column_itd.py`).
A phase of `model.Reference`; its forcing is the program's
(`Reference.column_forcing`).

Departures from the published description, as in the program:
  * the shortwave is computed at the start of the step from the state
    and the step's sun;
  * under a refrozen lid the pond's optical share is tapered by the
    category's snow depth (Icepack tapers by the snow on the pond);
  * a pond's lid grows by the Stefan law from the air temperature and
    melts by the surface's net flux; level-ice ponds do not flush
    through mushy ice (the mushy solve drains them)."""

from __future__ import annotations

import torch

from . import column_itd, column_shortwave, column_vertical
from .column import (AREA_TRACERS, HI_MIN_POND, ICE_TRACERS, KICE, LFRESH,
                     PNDASPECT, PUNY, RFRACMAX, RFRACMIN, RHOFRESH, RHOI,
                     RHOS, RHOW, SNOW_TRACERS, TFFRESH, HS1_POND,
                     bl99_salinity, category_bounds, check_column)

CLAIMS = ("column",)
NEW = {"iceAge": 0.0, "firstYearIceArea": 0.0, "levelIceArea": 1.0,
       "levelIceVolume": 1.0, "pondArea": 0.0, "pondDepth": 0.0,
       "pondLidThickness": 0.0}


def check_config(conf: dict):
    check_column(conf)


def build(ref, conf: dict):
    run = conf["run"]
    ref.ncat = int(run["n_categories"])
    ref.ni, ref.ns = int(run["n_ice_layers"]), int(run["n_snow_layers"])
    ref.hin_max = category_bounds(ref.ncat)
    ref.salin = torch.as_tensor(bl99_salinity(ref.ni)).to(
        device=ref.device, dtype=ref.dtype)


def init_state(ref, state: dict) -> dict:
    """The column's tracers of the initial state, as the program's model
    makes them before the caps are laid on: all ice level, first-year
    ice and the age 0, no ponds."""
    a = state["tracers.iceAreaCategory"]
    out = dict(state)
    for k, v in NEW.items():
        out[f"tracers.{k}"] = torch.full_like(a, v)
    return out


def level_ponds(dt, rfrac, meltt, melts, rain, Tair, fsurf, dsnow, aicen,
                vicen, vsnon, alvl, apnd, hpnd, ipnd):
    """The level ice's melt ponds of each category (Icepack
    compute_ponds_lvl, frzpnd = 'hlid'): the retained share of the melt
    and rain fills them, a lid refreezes or melts, their area and depth
    keep the aspect PNDASPECT, and no pond stands above the waterline.
    apnd: the ponds' share of the level ice; hpnd: their depth; ipnd:
    the lid.  Returns the new (apnd, hpnd, ipnd)."""
    has = aicen * alvl > PUNY ** 2
    a1 = torch.where(aicen > PUNY, aicen, 1.0)
    hi = torch.where(aicen > PUNY, vicen / a1, 0.0)
    hs = torch.where(aicen > PUNY, vsnon / a1, 0.0)
    act = has & (hi >= HI_MIN_POND)
    vol = hpnd * aicen * alvl * apnd
    ap = apnd * alvl
    dv = torch.where(act, rfrac / RHOFRESH * (meltt * RHOI + melts * RHOS +
                                             rain * dt) * aicen, 0.0)
    freezing = dv == 0.0
    Ts = Tair - TFFRESH
    bdt = (-2.0 * Ts * KICE * dt / (RHOI * LFRESH)).clamp(min=0.0)
    grow = torch.where(ipnd > 0.5 * torch.sqrt(bdt),
                       0.5 * bdt / ipnd.clamp(min=PUNY), 0.5 * torch.sqrt(bdt))
    grow = torch.where(Ts < 0.0,
                       torch.minimum(grow, hpnd * RHOFRESH / RHOI), 0.0)
    melt = -torch.minimum((fsurf * dt / (RHOI * LFRESH)).clamp(min=0.0), ipnd)
    dlid = torch.where(freezing, grow, melt)
    lid = torch.where(act, (ipnd + dlid).clamp(min=0.0), ipnd)
    dv = dv - torch.where(act, dlid * (ap * aicen) * RHOI / RHOFRESH, 0.0)
    vol = vol + dv
    ap = torch.where(vol <= 0.0, 0.0, ap)
    vol = vol.clamp(min=0.0)
    had = ap * aicen > PUNY
    ap_old = torch.minimum((ap + 0.5 * dv / (PNDASPECT * ap.clamp(min=PUNY) *
                                             a1)).clamp(min=0.0), alvl)
    hp_old = torch.where(ap_old > PUNY, vol / (ap_old.clamp(min=PUNY) * a1),
                         0.0)
    fresh = alvl * aicen > 10.0 * PUNY
    ap_new = torch.minimum(torch.sqrt(vol / (PNDASPECT * a1)), alvl)
    ap = torch.where(had, ap_old, torch.where(fresh, ap_new, 0.0)).clamp(
        min=0.0)
    hp = torch.where(had, hp_old, torch.where(fresh, PNDASPECT * ap_new, 0.0))
    hp = torch.minimum(hp, ((RHOW - RHOI) * hi - RHOS * hs) /
                       RHOFRESH).clamp(min=0.0)
    ap = ap * aicen
    empty = hp * ap <= 0.0
    ap = torch.where(empty | ~act, 0.0, ap)
    hp = torch.where(empty | ~act, 0.0, hp)
    lid = torch.where(act & empty, 0.0, lid)
    lid = torch.where(has & (hi < HI_MIN_POND), 0.0, lid)
    return (torch.where(has, ap / (aicen * alvl).clamp(min=PUNY ** 2), apnd),
            torch.where(has, hp, hpnd), torch.where(has, lid, ipnd))


def step(ref, state: dict) -> dict:
    tr, _ = thermo(ref, {k[8:]: v for k, v in state.items()
                         if k.startswith("tracers.")},
                   ref.column_forcing(state))
    out = dict(state)
    out.update({f"tracers.{k}": v for k, v in tr.items()})
    return out


def thermo(ref, tr: dict, f: dict, trace=None):
    """The step's column thermodynamics of the tracers `tr` under the
    forcing `f` (`Reference.column_forcing`'s fields), with ref's dt,
    layers, category bounds and salinity profile.  Returns (the new
    tracers, the categories whose Picard solve did not converge); trace:
    as `column_vertical.heat_solve`'s."""
    dt = ref.dt
    aicen, vicen, vsnon = (tr["iceAreaCategory"], tr["iceVolumeCategory"],
                           tr["snowVolumeCategory"])
    at = {k: tr[k] for k in AREA_TRACERS}
    it = {k: tr[k] for k in ICE_TRACERS}
    st = {k: tr[k] for k in SNOW_TRACERS}
    ni, ns = ref.ni, ref.ns

    def cat(x):
        return x[:, None].expand_as(aicen)

    # the shortwave from the state at the step's start
    a_ok = aicen > 1e-11
    hs_cat = torch.where(a_ok, vsnon / torch.where(a_ok, aicen, 1.0), 0.0)
    fpond = at["pondArea"] * at["levelIceArea"]
    fpond = torch.where(at["pondLidThickness"] > 1e-11,
                        (1.0 - (hs_cat / HS1_POND).clamp(max=1.0)) * fpond,
                        fpond)
    sw = column_shortwave.shortwave(
        aicen, vicen, vsnon, at["surfaceTemperature"], f["coszen"],
        {k: f[k] for k in ("sw_vis_dir", "sw_vis_dif", "sw_ir_dir",
                           "sw_ir_dif")}, fpond, at["pondDepth"], ni, ns)
    wind = torch.sqrt(f["u_air"] ** 2 + f["v_air"] ** 2)
    shcoef, lhcoef = column_vertical.boundary_layer(
        at["surfaceTemperature"], cat(f["air_temperature"]), cat(wind),
        cat(f["air_level_height"]), cat(f["specific_humidity"]),
        cat(f["air_density"]))

    # ice age and first-year ice
    at["iceAge"] = torch.where(vicen > PUNY, at["iceAge"] + dt, 0.0)
    doy = f["day_of_year"]
    reset = torch.where(f["lat"] >= 0.0, torch.full_like(f["lat"], doy == 265),
                        torch.full_like(f["lat"], doy == 81)) > 0
    at["firstYearIceArea"] = torch.where(
        reset[:, None], 0.0, at["firstYearIceArea"]).clamp(0.0, 1.0)

    # the ocean's heat
    aice = aicen.sum(-1)
    etot = ((vicen.clamp(min=0.0) / ni)[..., None] *
            it["iceEnthalpy"]).sum((-2, -1)) + \
        ((vsnon.clamp(min=0.0) / ns)[..., None] * st["snowEnthalpy"]).sum(
            (-2, -1))
    Tf = f["freezing_temperature"]
    fbot, rside = column_vertical.bottom_lateral(dt, aice, f["frzmlt"],
                                                 f["sst"], Tf, etot)

    # the vertical thermodynamics of every category
    apond = at["pondArea"] * at["levelIceArea"]
    tv = column_vertical.vertical(
        dt, aicen, vicen, vsnon, at["surfaceTemperature"],
        it["iceEnthalpy"], st["snowEnthalpy"], it["iceSalinity"],
        (cat(f["air_temperature"]), cat(f["specific_humidity"]),
         cat(f["air_density"]), cat(f["longwave_down"])),
        cat(f["snow_rate"]), torch.where(aicen > PUNY, fbot[:, None], 0.0),
        cat(Tf), cat(f["sss"]), sw, shcoef, lhcoef, apond, at["pondDepth"],
        trace=trace)
    vicen2, vsnon2 = tv["hin"] * aicen, tv["hsn"] * aicen
    at["surfaceTemperature"] = tv["Tsf"]
    it["iceEnthalpy"], it["iceSalinity"] = tv["zqin"], tv["zSin"]
    st["snowEnthalpy"] = tv["zqsn"]
    at["pondDepth"] = tv["hpond"]

    # the level ice's ponds
    at["pondArea"], at["pondDepth"], at["pondLidThickness"] = level_ponds(
        dt, RFRACMIN + (RFRACMAX - RFRACMIN) * aicen, tv["meltt"],
        tv["melts"], cat(f["rain_rate"]), cat(f["air_temperature"]),
        tv["fsurf"], tv["dsnow"], aicen, vicen2, vsnon2, at["levelIceArea"],
        at["pondArea"], at["pondDepth"], at["pondLidThickness"])

    # new ice, lateral melt, the remap between categories
    a2, v2, at, it = column_itd.new_ice(dt, ref.hin_max, aicen, vicen2, at,
                                        it, f["frzmlt"], Tf, ref.salin)
    r = rside[:, None]
    a2, v2, vs2 = a2 * (1.0 - r), v2 * (1.0 - r), vsnon2 * (1.0 - r)
    a2, v2, vs2, at, it, st = column_itd.linear_remap(
        ref.hin_max, aicen, vicen, a2, v2, vs2, at, it, st)
    a2, v2, vs2, at, it, st = column_itd.cleanup(a2, v2, vs2, at, it, st)
    out = {"iceAreaCategory": a2, "iceVolumeCategory": v2,
           "snowVolumeCategory": vs2, **at, **it, **st}
    return out, tv["unconverged"]
