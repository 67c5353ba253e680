"""Advanced snow physics: grain metamorphism, liquid drainage, wind
effects (reference `ice_snow.F90`).

Port of the JAX package's `column/snow.py`, vectorized over
[*B, nCat, nSnowLayers]:
  * wet metamorphism (exact reference formula, snow_wet_metamorph :844),
  * dry (temperature-gradient) metamorphism with the reference's
    best-fit power law; the SNICAR (tau, kappa, drdt0) aging parameters
    are arguments with parametric defaults, as in the JAX package,
  * meltwater drainage through the snowpack (drain_snow :885, irreducible
    saturation S_r),
  * bulk wind loss of new snowfall to leads and wind compaction of the
    effective snow density (snow_redist '30percent'/bulk pieces :119),
  * effective snow density from the ice/liquid mass tracers
    (snow_effective_density :34),
  * wind redistribution of snow across the thickness distribution
    (snow_redist :119-593; schemes 'bulk', 'ITDsd', 'ITDrdg').
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import constants as c
from .vertical import adjust_enthalpy

S_WET = 4.22e5       # wet metamorphism rate constant (um^3/s-ish)
S_R = 0.033          # irreducible liquid saturation
RSNW_FALL = 54.526   # fresh snow grain radius (1e-6 m; SNICAR)
RSNW_TMAX = 1500.0   # max dry-metamorphism radius (1e-6 m)
# parametric stand-ins for the SNICAR aging table at typical polar
# conditions (tau [hr], kappa, drdt0 [um/hr])
TAU_DEFAULT = 8.7e4
KAPPA_DEFAULT = 0.56
DRDT0_DEFAULT = 1.1
RHOS_MAX = 450.0     # max compacted snow density (kg/m^3)
WIND_MIN = 10.0      # minimum wind for compaction (m/s)
DRHOS_DWIND = 27.3   # compaction factor (kg s/m^4)
SNOW_LOSS_FRAC = 0.3  # '30percent' scheme: snowfall fraction lost/blown


def _tunables(tun):
    if tun is None:
        from .tuning import DEFAULT
        return DEFAULT
    return tun


def snow_wet_metamorph(dt, rsnw, smice, smliq):
    """Grain growth from liquid water (reference snow_wet_metamorph):
    dr = S_wet * fliq^3 * dt / (4 pi r^2), fliq in percent (capped 10%)."""
    tot = smice + smliq
    ok = (tot > 0.0) & (rsnw > 0.0)
    fliq = torch.where(ok, (smliq / tot.clamp(min=c.PUNY)).clamp(max=0.1)
                       * 100.0, 0.0)
    return torch.where(ok, S_WET * fliq ** 3 * dt /
                       (4.0 * c.PI * rsnw.clamp(min=c.PUNY) ** 2), 0.0)


def snow_dry_metamorph(dt, rsnw, zqsn, Tsfc, zTin1, hsn, hin,
                       tun=None,
                       tau=TAU_DEFAULT, kappa=KAPPA_DEFAULT,
                       drdt0=DRDT0_DEFAULT):
    """Temperature-gradient grain growth (reference snow_dry_metamorph):
    dr/dt = drdt0 * (tau / (dr_fresh + tau))^(1/kappa), with the aging
    parameters (from the SNICAR table in the reference) as inputs.  The
    temperature gradient (zqsn, Tsfc, zTin1, hsn, hin) feeds the table
    lookup only, which the parametric defaults stand in for, so it is
    not computed."""
    tun = _tunables(tun)
    dr_fresh = (rsnw - tun.fallen_snow_radius).clamp(min=0.0)
    drdt = drdt0 * (tau / (dr_fresh + tau)) ** (1.0 / kappa)
    return drdt * (dt / 3600.0)


def update_snow_radius(dt, rsnw, aicen, vicen, vsnon, zqsn, Tsfc, zTin1,
                       smice, smliq, tun=None):
    """Combined metamorphism update (reference update_snow_radius).
    rsnw [*B, nCat, ns]; returns (rsnw, smice, smliq)."""
    tun = _tunables(tun)
    has = (vsnon > c.PUNY) & (vicen > c.PUNY)
    safe_a = torch.where(aicen > c.PUNY, aicen, 1.0)
    hsn = torch.where(aicen > c.PUNY, vsnon / safe_a, 0.0)
    hin = torch.where(aicen > c.PUNY, vicen / safe_a, 0.0)
    dr_dry = snow_dry_metamorph(dt, rsnw, zqsn, Tsfc, zTin1, hsn, hin,
                                tun=tun)
    dr_wet = snow_wet_metamorph(dt, rsnw, smice, smliq)
    r_new = (rsnw + dr_dry + dr_wet).clamp(max=tun.max_dry_snow_radius)
    h = has[..., None]
    r_out = torch.where(h, r_new,
                        rsnw.clamp(tun.fallen_snow_radius,
                                   tun.max_dry_snow_radius))
    smice_out = torch.where(h, smice, c.RHOS)
    smliq_out = torch.where(h, smliq, 0.0)
    return r_out, smice_out, smliq_out


def drain_snow(dt, vsnon, aicen, smice, smliq):
    """Vertical meltwater percolation with irreducible saturation
    (reference drain_snow :885). smice/smliq [*B, nCat, ns] (kg/m^3).
    Returns (smliq, meltsliq [*B, nCat] liquid leaving the base,
    kg/m^2)."""
    ns = smliq.shape[-1]
    safe_a = torch.where(aicen > c.PUNY, aicen, 1.0)
    hsn = torch.where(aicen > c.PUNY, vsnon / safe_a, 0.0)
    hslyr = (hsn / ns).clamp(min=c.PUNY)
    active = hsn > c.PUNY

    out_layers = []
    dlin = torch.zeros_like(smliq[..., 0])
    for k in range(ns):
        sl = smliq[..., k] + dlin / hslyr
        phi_ice = (smice[..., k] / c.RHOI).clamp(max=1.0)
        phi_liq = sl / c.RHOFRESH
        w_drain = ((phi_liq - S_R * (1.0 - phi_ice)) / dt *
                   c.RHOFRESH * hslyr).clamp(min=0.0)
        dlout = w_drain * dt
        sl = sl - dlout / hslyr
        out_layers.append(torch.where(active, sl, smliq[..., k]))
        dlin = dlout
    meltsliq = torch.where(active, dlin, 0.0)
    return torch.stack(out_layers, -1), meltsliq


def wind_snow_loss(wind, snow_rate, tun=None):
    """Bulk '30percent' scheme: a fraction of snowfall is blown into
    leads at high wind (reference snow_redist bulk branch). Returns
    (retained snowfall rate, loss rate), both [*B]."""
    tun = _tunables(tun)
    wmin = tun.minimum_wind_compaction
    gamma = ((wind - wmin) / wmin).clamp(0.0, 1.0)
    loss = SNOW_LOSS_FRAC * gamma * snow_rate
    return snow_rate - loss, loss


def wind_compaction(dt, wind, rhos_eff, tun=None):
    """Wind compaction of the near-surface snow density (reference
    snow_redist: drhos/dt = drhosdwind * (wind - windmin), capped)."""
    tun = _tunables(tun)
    # reference ice_snow.F90:79: densities below rhosmin (100 kg/m^3)
    # reset to the new-snow density
    rhos_eff = torch.where(rhos_eff < 100.0, tun.new_snow_density,
                           rhos_eff)
    drho = torch.where(wind > tun.minimum_wind_compaction,
                       tun.wind_compaction_factor *
                       (wind - tun.minimum_wind_compaction) *
                       dt / 86400.0, 0.0)
    return (rhos_eff + drho).clamp(max=tun.max_snow_density)


def snow_effective_density(smice, smliq):
    """Effective snow density from the mass tracers (reference
    snow_effective_density :34)."""
    return smice + smliq


class SnowRedistResult(NamedTuple):
    vsnon: torch.Tensor         # [*B, nCat] snow volume after transport
    zqsn: torch.Tensor          # [*B, nCat, ns] snow enthalpy
    rhos_cmpn: torch.Tensor     # [*B, nCat, ns] compacted density
    fresh: torch.Tensor         # [*B] freshwater rate to ocean (kg/m^2/s)
    fhocn: torch.Tensor         # [*B] heat rate to ocean (W/m^2)
    fsloss: torch.Tensor        # [*B] snow blown into leads (kg/m^2/s)


def snow_redistribution(dt, wind, fsnow, aicen, vicen, vsnon, zqsn,
                        rhos_cmpn, scheme: str = "ITDsd",
                        alvl=None, vlvl=None, tun=None):
    """Wind redistribution of snow across the thickness distribution
    (reference snow_redist, ice_snow.F90:119-593): wind suspends snow
    (up to the seasonal-wind compaction threshold of the top-layer
    density), a fraction `flost` of the suspended mass blows into
    leads scaled by the ITD standard deviation, and the rest
    redeposits: uniformly over categories ('ITDsd') or preferentially
    onto ridged ice ('ITDrdg', using the level-ice tracers with the
    30% rule snwlvlfac).  Erosion takes layers top-down; redeposited
    energy is spread over the affected layers and the layer stack is
    conservatively regridded to equal thickness (adjust_enthalpy).

    All-category arrays [*B, nCat], layered [*B, nCat, ns]; wind/fsnow
    [*B].  Returns SnowRedistResult with ocean fluxes as rates."""
    f = zqsn.dtype
    ns = zqsn.shape[-1]
    tun = _tunables(tun)
    GAMMA = 1.0e-5
    REFSD = 1.0
    SNWLVLFAC = 0.3               # ice_constants_colpkg.F90:119
    rhos = c.RHOS
    Lf = c.LFRESH
    rdg = scheme == "ITDrdg" and alvl is not None and vlvl is not None

    a_ok = aicen > c.PUNY
    safe_a = torch.where(a_ok, aicen, 1.0)
    hin = torch.where(a_ok, vicen / safe_a, 0.0)
    hsn = torch.where(a_ok, vsnon / safe_a, 0.0)
    suma = aicen.sum(-1)
    sumv = vicen.sum(-1)

    vsn_init = vsnon
    e_init = (vsnon[..., None] * zqsn / ns).sum((-2, -1))

    # positive-definite enthalpy workspace (:268-271)
    zq = (zqsn + Lf * rhos).clamp(max=0.0)

    # ITD standard deviation + ITDrdg redeposition weights (:276-301)
    if rdg:
        ardg = 1.0 - alvl
        al = alvl * aicen
        ar = ardg * aicen
        hlvl = torch.where(al > c.PUNY, vicen * vlvl /
                           torch.where(al > c.PUNY, al, 1.0), 0.0)
        hrdg = torch.where(ar > c.PUNY, vicen * (1.0 - vlvl) /
                           torch.where(ar > c.PUNY, ar, 1.0), 0.0)
        work = (al * (hlvl - sumv[..., None]) ** 2 +
                ar * (hrdg - sumv[..., None]) ** 2).sum(-1)
        sfac = torch.where(
            ardg > 0.0,
            (alvl / torch.where(ardg > 0.0, ardg, 1.0)).clamp(
                max=SNWLVLFAC), SNWLVLFAC)
        asnw_lvl = (al - sfac * ar).sum(-1) / suma.clamp(min=c.PUNY)
    else:
        work = (aicen * (hin - sumv[..., None]) ** 2).sum(-1)
    itdsd = torch.sqrt(work.clamp(min=0.0))

    # lead losses (:306-310)
    flost = (1.0 - suma) * torch.exp(-itdsd / REFSD)
    alost = 1.0 - suma * (1.0 - flost)

    # suspended mass (:316-325): seasonal wind threshold from the
    # top-layer compacted density
    vseas = ((rhos_cmpn[..., 0] - 44.6) / 174.0).clamp(min=0.0)
    msusp_n = aicen * GAMMA * dt * \
        (wind[..., None] - vseas).clamp(min=0.0) * \
        (tun.max_snow_density - rhos_cmpn[..., 0]) / \
        (tun.max_snow_density * itdsd.clamp(min=c.PUNY)[..., None])
    msusp = torch.where(itdsd > c.PUNY, msusp_n.sum(-1), 0.0)

    # erosion top-down (:331-356): layer k erodes
    # clip(m_er/(rhos a) - k hsn/ns, 0, hsn/ns)
    m_er = torch.where(a_ok, torch.minimum(msusp[..., None], rhos * vsnon),
                       0.0)
    hslyr0 = hsn / ns
    kidx = torch.arange(ns, dtype=f, device=zqsn.device)
    dh_er = torch.minimum(
        ((m_er / (rhos * safe_a))[..., None] -
         kidx * hslyr0[..., None]).clamp(min=0.0), hslyr0[..., None])
    dh_er = torch.where(a_ok[..., None], dh_er, 0.0)
    hsn_new = hsn - dh_er.sum(-1)
    e_er = (dh_er * zq * aicen[..., None]).sum(-1)     # [*B, nCat]
    msnw_susp = (rhos * aicen * dh_er.sum(-1)).sum(-1)  # [*B]
    esnw_susp = e_er.sum(-1)
    klyr = (dh_er > 0.0).sum(-1).clamp(min=1).to(f)    # [*B, nCat]

    # redeposition weights (:362-369)
    if rdg:
        w_n = aicen * (1.0 - flost)[..., None] * \
            (ardg * (1.0 + sfac) + asnw_lvl[..., None])
    else:
        w_n = aicen * (1.0 - flost)[..., None]
    m_redep = msnw_susp[..., None] * w_n
    e_redeptmp = esnw_susp[..., None] * w_n
    dhsn = torch.where(a_ok, m_redep / (rhos * safe_a), 0.0)
    vsn_new = (hsn_new + dhsn) * aicen
    redep = a_ok & (dhsn.abs() > 0.0)

    # spread redeposited energy over the affected layers (:381-400)
    de = e_redeptmp / klyr
    in_klyr = kidx < klyr[..., None]
    safe_v = vsn_new.clamp(min=c.PUNY)
    zq_mix = torch.where(
        (redep & (vsn_new > c.PUNY))[..., None] & in_klyr,
        (aicen[..., None] * hsn_new[..., None] * zq + de[..., None]) /
        safe_v[..., None], zq)
    sumq = (zq_mix.clamp(min=0.0) * in_klyr).sum(-1)
    zq_mix = torch.where(in_klyr, zq_mix.clamp(max=0.0), zq_mix)
    last = kidx == (klyr - 1)[..., None]
    zq_mix = torch.where(last & redep[..., None],
                         (zq_mix + sumq[..., None]).clamp(max=0.0), zq_mix)

    # conservative regrid to equal layers (:403-427)
    if ns > 1:
        dz_old = hslyr0[..., None] * torch.ones_like(zq) + \
            torch.where(in_klyr, (dhsn / klyr)[..., None], 0.0)
        h_tot = hsn_new + dhsn
        zq_rg = adjust_enthalpy(dz_old, h_tot / ns, h_tot, zq_mix)
        zq_mix = torch.where(redep[..., None], zq_rg, zq_mix)
    zq_out = zq_mix - Lf * rhos

    # suspended snow lost in leads (:433-436)
    mlost = msnw_susp * alost
    fsloss = mlost / dt

    # mass conservation fixups (:442-458)
    tmp1 = vsn_init.sum(-1)
    tmp2 = vsn_new.sum(-1)
    scale = torch.where(tmp2 > tmp1, tmp1 / tmp2.clamp(min=c.PUNY), 1.0)
    vsn_out = vsn_new * scale[..., None]
    tmp2b = tmp2 * scale
    fresh = rhos * (tmp1 - tmp2b).clamp(min=0.0) / dt

    # energy to the ocean = column energy deficit (:516-521)
    e_final = (vsn_out[..., None] * zq_out / ns).sum((-2, -1))
    fhocn = (e_init - e_final) / dt

    # wind compaction of freshly fallen snow (:570-589)
    drhos = tun.wind_compaction_factor * \
        (wind - tun.minimum_wind_compaction).clamp(min=0.0)
    hslab = torch.where(
        fsnow[..., None] > 0.0,
        torch.minimum((fsnow * dt)[..., None] / (rhos + drhos[..., None]),
                      (hsn_new + dhsn) - hsn).clamp(min=0.0),
        0.0)
    hslyr_n = ((hsn_new + dhsn) / ns).clamp(min=c.PUNY)
    frac = torch.minimum(
        (hslab[..., None] - hslyr_n[..., None] * kidx).clamp(min=0.0),
        hslyr_n[..., None]) / hslyr_n[..., None]
    rhos_out = torch.where((vsn_out > c.PUNY)[..., None],
                           rhos_cmpn + drhos[..., None, None] * frac,
                           rhos_cmpn).clamp(max=tun.max_snow_density)

    return SnowRedistResult(vsnon=vsn_out, zqsn=zq_out,
                            rhos_cmpn=rhos_out, fresh=fresh,
                            fhocn=fhocn, fsloss=fsloss)
