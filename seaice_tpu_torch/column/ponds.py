"""Melt ponds (CESM, level-ice and topographic schemes) and the simple
age / first-year-ice tracers.

Port of the JAX package's `column/ponds.py`, which re-designs
`ice_meltpond_cesm.F90` (compute_ponds_cesm), `ice_meltpond_lvl.F90`
(compute_ponds_lvl :34-281, brine_permeability :287-340),
`ice_meltpond_topo.F90` (compute_ponds_topo :39-296, pond_area
:302-589, permeability_phi :756-860), `ice_age.F90` and
`ice_firstyear.F90`; the reference's per-cell branch ladders become
masked dense selects over [*B, nCat], and the topographic scheme's
sorted fill becomes one solve over the breakpoints of its fill curve.
"""

from __future__ import annotations

import torch

from . import constants as c
from .thermo_shared import ice_temperature_from_enthalpy

PNDASPECT = 0.8      # pond depth / pond fraction ratio (namelist default)
HI_MIN_POND = 0.01
TD = 2.0             # freeze-up temperature difference (C)
REXP = 0.01          # pond contraction scaling
DPTHHI = 0.9         # max pond depth / ice thickness


def compute_ponds_cesm(dt, rfrac, meltt, melts, frain,
                       aicen, vicen, vsnon, Tsfcn, apnd, hpnd,
                       pndaspect: float = PNDASPECT,
                       meltsliq=None):
    """CESM melt ponds: retained meltwater volume grows ponds, cold
    surfaces contract them (reference compute_ponds_cesm,
    ice_meltpond_cesm.F90). All inputs [*B, nCat]; apnd is the pond
    fraction OF ICE AREA, hpnd the pond depth (m).

    meltsliq (kg/m^2): when given (use_smliq_pnd,
    config_use_snow_liquid_ponds), the drained snow-liquid mass
    replaces the snow-melt + rain pond source
    (ice_meltpond_cesm.F90:112-124).
    Returns (apnd, hpnd)."""
    has = aicen > c.PUNY
    safe_a = torch.where(has, aicen, 1.0)
    hi = torch.where(has, vicen / safe_a, 0.0)

    volpn = hpnd * apnd * aicen
    if meltsliq is None:
        src = meltt * c.RHOI + melts * c.RHOS + frain * dt
    else:
        src = meltt * c.RHOI + meltsliq
    volpn = volpn + (rfrac / c.RHOFRESH) * src * aicen
    Tp = c.TIMELT - TD
    dTs = (Tp - Tsfcn).clamp(min=0.0)
    volpn = (volpn * torch.exp(REXP * dTs / Tp)).clamp(min=0.0)
    apondn = torch.sqrt(volpn / (pndaspect * safe_a)).clamp(max=1.0)
    hpondn = pndaspect * apondn
    apondn = apondn * aicen
    hpondn = torch.minimum(hpondn, DPTHHI * hi)

    thick_enough = has & (hi >= HI_MIN_POND)
    apnd_new = torch.where(thick_enough, apondn / safe_a, 0.0)
    hpnd_new = torch.where(thick_enough, hpondn, 0.0)
    return apnd_new, hpnd_new


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


# -- topographic melt ponds (reference ice_meltpond_topo.F90) ---------------

TD_TOPO = 0.15       # pond freezing-point depression (C; reference p15)
HICEMIN_TOPO = 0.1   # min mean ice thickness with topo ponds (m)
MIN_VOLP = 1.0e-4    # min pond volume (m)


def permeability_phi_topo(qicen, sicen):
    """Column permeability for topo ponds (reference permeability_phi,
    ice_meltpond_topo.F90:756-860): brine salinity from Assur 1958 for
    cold columns (max T <= -2 C) else Notz 2005 eq. 3.2; no
    impermeable-layer cutoff. [*B, nCat, ni] -> [*B, nCat]."""
    Tmlt = -sicen * c.DEPRESST
    T = ice_temperature_from_enthalpy(qicen, Tmlt)
    cold = T.amax(-1) <= -2.0
    sbr_assur = -1.2 - 21.8 * T - 0.919 * T ** 2 - 0.01878 * T ** 3
    sbr_notz = -17.6 * T - 0.389 * T ** 2 - 0.00362 * T ** 3
    Sbr = torch.where(cold[..., None], sbr_assur, sbr_notz)
    phi = sicen / Sbr.clamp(min=1.0e-10)
    return 3.0e-8 * phi.amin(-1) ** 3


def _topo_fill_height(volp, ra, asnon, hsnon, z, z_cap):
    """Invert the hydrostatic fill curve V(h) for the water surface
    height h above the thinnest category's reference line.

    The reference builds this cumulatively per level with a bubble
    sort over snow heights (pond_area :442-497, calc_hpond :593-750);
    here V(h) = sum_n ra_n relu(h - z_n)
              - (rhos/rhow) sum_n as_n clamp(h - z_n, 0, hs_n)
    is the same piecewise-linear curve, evaluated at every breakpoint
    at once and solved in the bracketing segment: no sort, no
    sequential scan. volp must already be capped at V(z_cap)."""
    puny = c.PUNY
    snow_f = c.RHOS / c.RHOW
    inf = float("inf")

    def vol_at(h):          # h [*B, K]
        dz = h[..., None] - z[..., None, :]          # [*B, K, ncat]
        v = (ra[..., None, :] * dz.clamp(min=0.0)).sum(-1)
        v = v - snow_f * (asnon[..., None, :] * torch.minimum(
            dz.clamp(min=0.0), hsnon[..., None, :])).sum(-1)
        return v

    bp = torch.cat([z, z + hsnon, z_cap[..., None]], dim=-1)
    vb = vol_at(bp)                                   # [*B, K]
    # highest breakpoint with V(b) <= volp
    ok = vb <= volp[..., None] + puny
    b_lo = torch.where(ok, bp, -inf).amax(-1)
    v_lo = torch.where(ok, vb, -inf).amax(-1)
    # local slope just above b_lo
    above = b_lo[..., None] >= z - puny
    in_snow = above & (b_lo[..., None] < z + hsnon - puny)
    slope = (ra * above).sum(-1) - snow_f * (asnon * in_snow).sum(-1)
    h = b_lo + (volp - v_lo) / slope.clamp(min=puny)
    return torch.minimum(torch.where(volp > puny, h, -inf), z_cap)


def compute_ponds_topo(dt, aicen, vicen, vsnon, meltt, fsurf,
                       Tsfcn, qicen, sicen, apnd, hpnd, ipnd,
                       ktherm: int = 1):
    """Topographic melt ponds (reference compute_ponds_topo,
    ice_meltpond_topo.F90:39-296 + pond_area :302-589): all pond water
    in a cell sits in one hydrostatically-levelled reservoir spread
    over the ice-thickness topography (floors at 0.6 h_n), drains by
    Darcy flow where the ice is permeable, and exchanges with a
    floating refrozen lid per category (tracer ipnd).

    Per-category [*B, nCat] fields; meltt/fsurf are CELL means
    (surface meltwater m, surface heat flux W/m^2). Returns
    (apnd, hpnd, ipnd, dfpond, drain_ocean): dfpond the change in the
    pond freshwater reservoir (m), drain_ocean the water drained or
    shed to the ocean (m), both grid-cell means."""
    puny = c.PUNY
    ncat = aicen.shape[-1]
    snow_f = c.RHOS / c.RHOW
    rhoi_L = c.LFRESH * c.RHOI
    Tp = c.TIMELT - TD_TOPO
    inf = float("inf")

    aice = aicen.sum(-1)
    vice = vicen.sum(-1)
    vsno = vsnon.sum(-1)
    has_n = aicen > puny
    safe_a = torch.where(has_n, aicen, 1.0)
    hicen = torch.where(has_n, vicen / safe_a, 0.0)
    hsnon = torch.where(has_n, vsnon / safe_a, 0.0)

    # load pond state (grid-mean volumes; :139-148)
    volpn0 = hpnd * apnd * aicen
    volp = volpn0.sum(-1)
    vuin = ipnd * apnd * aicen
    dfpond = torch.zeros_like(volp)
    drain_ocean = torch.zeros_like(volp)

    hi_mean = torch.where(aice > puny, vice / aice.clamp(min=puny), 0.0)
    active = (aice > 0.01) & (hi_mean > HICEMIN_TOPO) & \
        (volp > MIN_VOLP * aice)

    # reduced area open to ponds (:415-418) and floor heights; the
    # thickest category keeps its whole area
    red = (-0.024 * hicen + 0.832).clamp(min=0.2)
    last = torch.arange(ncat, device=aicen.device) == ncat - 1
    ra = torch.where(has_n, torch.where(last, aicen, aicen * red), 0.0)
    asnon = ra
    alfan = 0.6 * hicen
    z = alfan - alfan[..., :1]
    # cap: floor of the highest occupied category holds no water above
    z_cap = torch.where(has_n, z, -inf).amax(-1)
    z_cap = torch.where(torch.isfinite(z_cap), z_cap, 0.0)

    def vol_at_scalar(h):
        dz = h[..., None] - z
        v = (ra * dz.clamp(min=0.0)).sum(-1)
        return v - snow_f * (asnon * torch.minimum(dz.clamp(min=0.0),
                                                   hsnon)).sum(-1)

    vmax = vol_at_scalar(z_cap)
    over = volp >= vmax
    drain0 = torch.where(active & over, volp - vmax + puny, 0.0)
    volp_f = volp - drain0
    gone = volp_f < puny
    drain0 = torch.where(active & gone, drain0 + volp_f, drain0)
    volp_f = torch.where(gone, 0.0, volp_f)
    drain_ocean = drain_ocean + drain0
    dfpond = dfpond - drain0

    h = _topo_fill_height(volp_f, ra, asnon, hsnon, z, z_cap)
    pond = (z < h[..., None] - puny) & active[..., None]
    apondn = torch.where(pond, ra, 0.0)
    hpondn = torch.where(pond, (h[..., None] - z).clamp(min=0.0), 0.0)

    # Darcy drainage through permeable categories (:504-543)
    if ktherm != 2:
        floe_w = (vsno * c.RHOS + c.RHOI * vice +
                  c.RHOW * volp_f) / aice.clamp(min=puny)
        hsl_rel = floe_w / c.RHOW - (
            (0.4 * hicen * aicen).sum(-1) / aice.clamp(min=puny) +
            alfan[..., 0])
        head = c.GRAVIT * c.RHOW * (h - hsl_rel).clamp(min=0.0)
        perm = permeability_phi_topo(qicen, sicen)
        perm = torch.where(has_n & (hicen > 0), perm, 0.0)
        dr_n = perm * apondn * head[..., None] * dt / \
            (c.VISCOSITY_DYN * hicen.clamp(min=puny))
        dr_n = torch.where(last, 0.0, dr_n)         # loop is 1..ncat-1
        drain1 = torch.where(active & (head > 0),
                             torch.minimum(dr_n.sum(-1), volp_f), 0.0)
        volp_f = (volp_f - drain1).clamp(min=0.0)
        gone = volp_f < puny
        drain1 = torch.where(active & gone, drain1 + volp_f, drain1)
        volp_f = torch.where(gone, 0.0, volp_f)
        drain_ocean = drain_ocean + drain1
        dfpond = dfpond - drain1
        h = _topo_fill_height(volp_f, ra, asnon, hsnon, z, z_cap)
        pond = (z < h[..., None] - puny) & active[..., None]
        apondn = torch.where(pond, ra, 0.0)
        hpondn = torch.where(pond, (h[..., None] - z).clamp(min=0.0), 0.0)

    # per-category pond volumes: geometric for the lower categories,
    # remainder in the top pond category (:550-581)
    volpn = apondn * hpondn - snow_f * asnon * torch.minimum(hsnon, hpondn)
    volpn = torch.where(pond, volpn.clamp(min=0.0), 0.0)
    idx = torch.arange(ncat, device=aicen.device)
    m_top = torch.where(pond, idx, -1).amax(-1)          # [*B]
    top = idx == m_top[..., None]
    lower_sum = (volpn * (~top)).sum(-1)
    rem = (volp_f - lower_sum).clamp(min=0.0)
    volpn = torch.where(top & pond, rem[..., None], volpn)
    hpondn = torch.where(apondn > puny,
                         volpn / apondn.clamp(min=puny), 0.0)
    apondn = torch.where(volpn > puny, apondn, 0.0)
    hpondn = torch.where(volpn > puny, hpondn, 0.0)
    volpn = torch.where(volpn > puny, volpn, 0.0)

    # inactive cells shed all pond water to the ocean (:261-266)
    shed = ~active & (volp > 0)
    dfpond = dfpond - torch.where(shed, volp, 0.0)
    drain_ocean = drain_ocean + torch.where(shed, volp, 0.0)
    act = active[..., None]
    volpn = torch.where(act, volpn, 0.0)
    apondn = torch.where(act, apondn, 0.0)
    hpondn = torch.where(act, hpondn, 0.0)
    vuin = torch.where(act, vuin, 0.0)

    # floating refrozen lid evolution, categories 1..ncat-1 (:188-259)
    not_last = ~last & act
    has_lid = vuin > puny
    melting = Tsfcn > Tp
    # lid melts with the surface meltwater flux
    dv_melt = torch.minimum(meltt[..., None] * apondn, vuin)
    do_melt = not_last & has_lid & melting & (dv_melt > puny)
    vuin = torch.where(do_melt, vuin - dv_melt, vuin)
    volpn = torch.where(do_melt, volpn + dv_melt, volpn)
    dfpond = dfpond + torch.where(do_melt, dv_melt, 0.0).sum(-1)
    # lid fully melted -> absorb the sliver into the pond
    sliver = do_melt & (vuin < puny) & (volpn > puny)
    volpn = torch.where(sliver, volpn + vuin, volpn)
    dfpond = dfpond + torch.where(sliver, vuin, 0.0).sum(-1)
    vuin = torch.where(sliver, 0.0, vuin)
    # existing lid grows by differential Stefan conduction
    dTice = (-Tsfcn - TD_TOPO).clamp(min=0.0)
    omega = c.KICE * dTice / rhoi_L
    hui = vuin / safe_a
    dHui = torch.sqrt(2.0 * omega * dt + hui ** 2) - hui
    dv_frz = torch.minimum(dHui * apondn, volpn)
    do_frz = not_last & has_lid & ~melting & (volpn > puny) & \
        (dv_frz > puny)
    vuin = torch.where(do_frz, vuin + dv_frz, vuin)
    volpn = torch.where(do_frz, volpn - dv_frz, volpn)
    dfpond = dfpond - torch.where(do_frz, dv_frz, 0.0).sum(-1)
    # new lid forms when the surface flux is negative
    dHui_new = (-fsurf[..., None] * dt / rhoi_L).clamp(min=0.0)
    dv_new = torch.minimum(dHui_new * apondn, volpn)
    do_new = not_last & ~has_lid & (dv_new > puny)
    vuin = torch.where(do_new, dv_new, vuin)
    volpn = torch.where(do_new, volpn - dv_new, volpn)
    dfpond = dfpond - torch.where(do_new, dv_new, 0.0).sum(-1)
    hpondn = torch.where(apondn > puny,
                         volpn / apondn.clamp(min=puny), hpondn)

    # drop lids with no liquid pond; reload tracers (:273-294)
    vuin = torch.where(has_n & (volpn < puny) & (vuin > puny), 0.0, vuin)
    ipnd_new = torch.where(apondn > puny,
                           vuin / apondn.clamp(min=puny), 0.0)
    apnd_new = torch.where(has_n, apondn / safe_a, 0.0)
    hpnd_new = torch.where(has_n, hpondn, 0.0)
    ipnd_new = torch.where(has_n, ipnd_new, 0.0)
    return apnd_new, hpnd_new, ipnd_new, dfpond, drain_ocean
