"""Level-ice melt ponds and the simple age / first-year-ice tracers.

Port of the JAX package's `column/ponds.py`, which re-designs
`ice_meltpond_lvl.F90` (compute_ponds_lvl :34-281, brine_permeability
:287-340), `ice_age.F90` and `ice_firstyear.F90`; the reference's
per-cell branch ladders become masked dense selects over [*B, nCat].
The CESM and topographic pond schemes are not ported (`ColumnPhysics`
raises for them, ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch

from . import constants as c
from .thermo_shared import ice_temperature_from_enthalpy

PNDASPECT = 0.8      # pond depth / pond fraction ratio (namelist default)
HI_MIN_POND = 0.01


def increment_age(dt, iage, vicen):
    """Ice age tracer: existing ice ages by dt (reference ice_age.F90
    increment_age)."""
    return torch.where(vicen > c.PUNY, iage + dt, 0.0)


def update_first_year_area(day_of_year, fy_area, aicen,
                           lat_sign_positive=True):
    """First-year ice resets to zero at the autumn equinox per
    hemisphere (reference ice_firstyear.F90 update_FYarea: day 265
    north, day 81 south)."""
    reset_day = 265 if lat_sign_positive else 81
    reset = day_of_year == reset_day
    fy = torch.where(torch.as_tensor(reset), 0.0, fy_area)
    return fy.clamp(0.0, 1.0)


def brine_permeability(qicen, sicen):
    """Minimum-liquid-fraction permeability of the ice column
    (reference brine_permeability, ice_meltpond_lvl.F90:287-340):
    phi_k = S_k / Sbr(T_k) with Sbr from Notz eq. 3.6, layers with
    phi < 0.05 impermeable; perm = 3e-8 * min_k(phi)^3.

    qicen, sicen: [*B, nCat, ni]. Returns perm [*B, nCat]."""
    Tmlt = -sicen * c.DEPRESST
    Tin = ice_temperature_from_enthalpy(qicen, Tmlt)
    Sbr = 1.0 / (1.0e-3 - c.DEPRESST / Tin)      # Tin <= -PUNY
    phi = sicen / Sbr
    phi = torch.where(phi < 0.05, 0.0, phi)
    return 3.0e-8 * phi.min(-1).values ** 3


def compute_ponds_lvl(dt, rfrac, meltt, melts, frain, Tair, fsurfn,
                      dhs, aicen, vicen, vsnon, qicen, sicen,
                      Tsfcn, alvl, apnd, hpnd, ipnd,
                      pndaspect: float = PNDASPECT,
                      hi_min: float = HI_MIN_POND,
                      dpscale: float = 1.0e-3,
                      frzpnd: str = "hlid",
                      ktherm: int = 1,
                      meltsliq=None):
    """Level-ice melt ponds (reference compute_ponds_lvl,
    ice_meltpond_lvl.F90:34-281). Ponds collect the retained fraction
    of top/snow melt and rain on the LEVEL fraction of each category;
    refreezing either contracts the pond (frzpnd='cesm') or grows a
    refrozen ice lid by a Stefan law (frzpnd='hlid', tracer ipnd);
    for ktherm != 2 ponds also flush through the ice with a Darcy law
    using the minimum brine liquid fraction permeability.

    All per-category fields [*B, nCat]; qicen/sicen [*B, nCat, ni];
    Tair (K), fsurfn (W/m^2), dhs (m, snow-depth difference over pond
    ice) as in the reference interface. apnd is the pond fraction of
    LEVEL ice area, hpnd the depth (m), ipnd the lid thickness (m).

    Returns (apnd, hpnd, ipnd, ffrac) with ffrac the fraction of
    fsurfn over ponds used to melt the lid."""
    puny = c.PUNY
    Td, rexp = 2.0, 0.01

    has = (aicen * alvl) > puny ** 2
    safe_a = torch.where(aicen > puny, aicen, 1.0)
    hi = torch.where(aicen > puny, vicen / safe_a, 0.0)
    hs = torch.where(aicen > puny, vsnon / safe_a, 0.0)
    thick = hi >= hi_min
    act = has & thick                      # ponds evolve here

    volpn = hpnd * aicen * alvl * apnd
    apondn = apnd * alvl                   # pond fraction of ice area

    # meltwater source (:158-166); with use_smliq_pnd the drained
    # snow-liquid mass replaces snow melt + rain
    # (ice_meltpond_lvl.F90:45,158)
    if meltsliq is None:
        src = meltt * c.RHOI + melts * c.RHOS + frain * dt
    else:
        src = meltt * c.RHOI + meltsliq
    dvn = torch.where(act, (rfrac / c.RHOFRESH) * src * aicen, 0.0)

    ffrac = torch.zeros_like(aicen)
    hlid = ipnd
    if frzpnd == "cesm":
        Tp = c.TIMELT - Td
        dTs = (Tp - Tsfcn).clamp(min=0.0)
        dvn = dvn - volpn * (1.0 - torch.exp(rexp * dTs / Tp))
    else:   # 'hlid' Stefan refreezing (:175-203)
        freezing = dvn == 0.0
        Ts = Tair - c.TFFRESH
        bdt = -2.0 * Ts * c.KICE * dt / (c.RHOI * c.LFRESH)
        bdt = bdt.clamp(min=0.0)
        dhlid_new = 0.5 * torch.sqrt(bdt)            # open-water growth
        dhlid_old = 0.5 * bdt / hlid.clamp(min=puny)
        dhlid_frz = torch.where(hlid > dhlid_new, dhlid_old, dhlid_new)
        dhlid_frz = torch.minimum(dhlid_frz, hpnd * c.RHOFRESH / c.RHOI)
        dhlid_frz = torch.where(Ts < 0.0, dhlid_frz, 0.0)
        # melting branch: lid melts back with the surface flux
        dhlid_mlt = -torch.minimum(
            (fsurfn * dt / (c.RHOI * c.LFRESH)).clamp(min=0.0), hlid)
        snow_free = (hs - dhs) < puny
        ffrac_mlt = torch.where(
            fsurfn > puny,
            (-dhlid_mlt * c.RHOI * c.LFRESH /
             (dt * fsurfn.clamp(min=puny))).clamp(max=1.0), 1.0)
        ffrac = torch.where(act & ~freezing & snow_free, ffrac_mlt, 0.0)
        dhlid = torch.where(freezing, dhlid_frz, dhlid_mlt)
        hlid = torch.where(act, (hlid + dhlid).clamp(min=0.0), hlid)
        alid = apondn * aicen
        dvn = dvn - torch.where(act, dhlid * alid * c.RHOI / c.RHOFRESH,
                                0.0)

    volpn = volpn + dvn
    apondn = torch.where(volpn <= 0.0, 0.0, apondn)
    volpn = volpn.clamp(min=0.0)

    # pond geometry update (:215-229)
    existing = apondn * aicen > puny
    ap_ex = torch.minimum(
        (apondn + 0.5 * dvn / (pndaspect * apondn.clamp(min=puny) *
                               safe_a)).clamp(min=0.0), alvl)
    hp_ex = torch.where(ap_ex > puny,
                        volpn / (ap_ex.clamp(min=puny) * safe_a), 0.0)
    newpond = alvl * aicen > 10.0 * puny
    ap_new = torch.minimum(torch.sqrt(volpn / (pndaspect * safe_a)), alvl)
    hp_new = pndaspect * ap_new
    apondn = torch.where(existing, ap_ex, torch.where(newpond, ap_new, 0.0))
    hpondn = torch.where(existing, hp_ex, torch.where(newpond, hp_new, 0.0))
    apondn = apondn.clamp(min=0.0)

    # nonnegative freeboard (:233)
    hpondn = torch.minimum(
        hpondn, ((c.RHOW - c.RHOI) * hi - c.RHOS * hs) / c.RHOFRESH)
    hpondn = hpondn.clamp(min=0.0)
    apondn = apondn * aicen                 # fraction of grid cell
    volpn = hpondn * apondn
    empty = volpn <= 0.0
    apondn = torch.where(empty, 0.0, apondn)
    hpondn = torch.where(empty, 0.0, hpondn)
    hlid = torch.where(act & empty, 0.0, hlid)

    # Darcy flushing (:252-267); mushy thermo drains internally
    if ktherm != 2 and dpscale > puny:
        draft = (c.RHOS * hs + c.RHOI * hi) / c.RHOW + hpondn
        deltah = (hpondn + hi - draft).clamp(min=0.0)
        head = c.GRAVIT * c.RHOW * deltah
        perm = brine_permeability(qicen, sicen)
        drain = perm * head * dt / \
            (c.VISCOSITY_DYN * hi.clamp(min=puny)) * dpscale
        deltah = torch.minimum(drain, hpondn)
        dvn_dr = -deltah * apondn
        do_drain = act & (hpondn > 0.0)
        volpn = torch.where(do_drain, volpn + dvn_dr, volpn)
        ap_dr = torch.minimum(
            (apondn + 0.5 * dvn_dr / (pndaspect * apondn.clamp(min=puny))
             ).clamp(min=0.0), alvl * aicen)
        hp_dr = torch.where(ap_dr > puny,
                            volpn / ap_dr.clamp(min=puny), 0.0)
        apondn = torch.where(do_drain, ap_dr, apondn)
        hpondn = torch.where(do_drain, hp_dr, hpondn)

    # thin ice sheds its ponds entirely (:138-147)
    apondn = torch.where(act, apondn, 0.0)
    hpondn = torch.where(act, hpondn, 0.0)
    hlid = torch.where(has & ~thick, 0.0, hlid)

    # reload tracers (:275-277); untouched outside active cells
    denom = (aicen * alvl).clamp(min=puny ** 2)
    apnd_new = torch.where(has, apondn / denom, apnd)
    hpnd_new = torch.where(has, hpondn, hpnd)
    ipnd_new = torch.where(has, hlid, ipnd) if frzpnd != "cesm" else ipnd
    return apnd_new, hpnd_new, ipnd_new, ffrac
