"""Vertical thermodynamics: growth/melt and the per-category driver.

Port of the JAX package's `column/vertical.py`, which re-designs
`thermo_vertical` (`ice_therm_vertical.F90:53-471`) and its stages:
`init_vertical_profile` (:652), `thickness_changes` (:1026), `freeboard`
(:1755), `adjust_enthalpy`, `frzmlt_bottom_lateral` (:482).  The
sequential consume-energy-through-layers loops are unrolled over the
static layer count, fully vectorized over the [nCells, nCategories]
batch.  The temperature solver is dispatched on `ktherm` as the
reference does (`ice_therm_vertical.F90:286-335`):

  * ktherm=0 — Semtner zero-layer (`ice_therm_0layer.F90`),
  * ktherm=1 — BL99 heat solve (`ice_therm_bl99.F90`),
  * ktherm=2 — mushy-layer Picard solve with gravity drainage, pond
    flushing and snow-ice flooding (`ice_therm_mushy.F90`:
    temperature_changes_salinity :35-341, flush_pond :3302,
    flood_ice :3342).

With prescribed surface fluxes (calc_Tsfc=False, ktherm 0 or 1) the
coupler's fluxes replace the surface balance.  `thickness_changes`
carries the reference's ktherm==2 branches (melt enthalpies relative to
enthalpy_of_melting, mushy bottom-growth enthalpy/salinity, internal
snow melt, no freeboard — flooding happens in flood_ice) and the
optional snow mass tracers smice/smliq + grain radius rsnw (tr_snow /
tr_rsnw paths of the reference).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import constants as c
from .bl99 import temperature_changes
from .thermo_shared import (ice_temperature_from_enthalpy,
                            snow_enthalpy_from_temperature,
                            snow_temperature_from_enthalpy)
from .zerolayer import ZeroLayerResult, zerolayer_temperature

QBOTMAX = -0.5 * c.RHOI * c.LFRESH


def frzmlt_bottom_lateral(dt, aice, frzmlt, sst, Tf, strocnxT, strocnyT,
                          etot, tun=None):
    """Ocean-ice bottom heat flux and lateral-melt fraction
    (reference frzmlt_bottom_lateral, ice_therm_vertical.F90:482-641).

    etot: total column energy sum over categories [B] (J/m^2, < 0).
    Returns (Tbot, fbot, rside)."""
    if tun is None:
        from .tuning import DEFAULT as tun
    floediam = 300.0
    floeshape = 0.66
    m1, m2 = 1.6e-6, 1.36

    can_melt = (aice > c.PUNY) & (frzmlt < 0.0)
    Tbot = Tf
    deltaT = (sst - Tbot).clamp(min=0.0)
    ustar = torch.sqrt(torch.sqrt(strocnxT ** 2 + strocnyT ** 2) / c.RHOW)
    ustar = ustar.clamp(min=tun.min_friction_velocity)
    cpchr = -c.CP_OCN * c.RHOW * 0.006
    fbot = cpchr * deltaT * ustar
    fbot = torch.maximum(fbot, frzmlt)
    fbot = torch.where(can_melt, fbot, 0.0)

    wlat = m1 * deltaT ** m2
    rside = wlat * dt * c.PI / (floeshape * floediam)
    rside = rside.clamp(0.0, 1.0)
    rside = torch.where(can_melt, rside, 0.0)

    # limit fbot and rside so that heat extracted <= frzmlt
    # (reference :600-630): fside = etot*rside/dt <= 0
    fside = etot * rside / dt
    xtmp = frzmlt / (fbot + fside).clamp(max=-c.PUNY)
    xtmp = xtmp.clamp(0.0, 1.0)
    fbot = fbot * xtmp
    rside = rside * xtmp
    return Tbot, fbot, rside


def adjust_enthalpy(dz_old, h_new_layer, h_total, q):
    """Conservative remap of layer quantity q from unequal layers dz_old
    to equal layers of thickness h_new_layer (reference adjust_enthalpy).
    dz_old, q: [*B, n]; h_new_layer, h_total: [*B]."""
    n = q.shape[-1]
    z1 = torch.cumsum(torch.cat(
        [torch.zeros_like(dz_old[..., :1]), dz_old], -1), -1)
    # new interfaces
    k = torch.arange(n + 1, dtype=q.dtype, device=q.device)
    z2 = h_new_layer[..., None] * k
    z2 = torch.cat([z2[..., :n], h_total[..., None]], -1)
    hq = []
    for k2 in range(n):
        top = z2[..., k2]
        bot = z2[..., k2 + 1]
        acc = 0.0
        for k1 in range(n):
            ov = (torch.minimum(z1[..., k1 + 1], bot) -
                  torch.maximum(z1[..., k1], top)).clamp(min=0.0)
            acc = acc + ov * q[..., k1]
        hq.append(acc)
    hq = torch.stack(hq, -1)
    return torch.where(h_new_layer[..., None] > c.PUNY,
                       hq / h_new_layer[..., None].clamp(min=c.PUNY), q)


class ThicknessResult(NamedTuple):
    hin: torch.Tensor
    hsn: torch.Tensor
    zqin: torch.Tensor
    zqsn: torch.Tensor
    zSin: torch.Tensor
    efinal: torch.Tensor
    fhocnn: torch.Tensor
    evapn: torch.Tensor
    meltt: torch.Tensor
    melts: torch.Tensor
    meltb: torch.Tensor
    congel: torch.Tensor
    snoice: torch.Tensor
    hsn_new: torch.Tensor
    dsnow: torch.Tensor
    meltsliq: torch.Tensor       # liquid leaving the snowpack (kg/m^2)
    smice: Optional[torch.Tensor]
    smliq: Optional[torch.Tensor]
    rsnw: Optional[torch.Tensor]


def _moved(dzs, mass, dhs):
    """Mass of a snow layer of thickness dzs moved with a thickness
    change dhs (zero for a vanished layer)."""
    return torch.where(dzs.abs() > c.PUNY,
                       mass / dzs.clamp(min=c.PUNY) * dhs, 0.0)


def thickness_changes(dt, hin, hsn, zqin, zqsn, zSin,
                      fbot, Tbot, flatn, fsurfn, fcondtopn, fcondbot,
                      fsnow, frain=None, ktherm: int = 1, sss=None,
                      smice=None, smliq=None, rsnw=None,
                      tun=None) -> ThicknessResult:
    """Growth and melt at the surfaces + layer re-gridding (reference
    thickness_changes, ice_therm_vertical.F90:1026-1744, including the
    ktherm==2 mushy branches and the tr_snow smice/smliq bookkeeping).

    smice/smliq: optional snow mass tracers [*B, ns] (kg/m^3).
    rsnw: optional snow grain radius [*B, ns] (um).
    """
    ni = zqin.shape[-1]
    ns = zqsn.shape[-1]
    hilyr = hin / ni
    hslyr = hsn / ns
    hslyr0 = hslyr
    if tun is None:
        from .tuning import DEFAULT as tun
    tr_snow = smice is not None
    dzi = [hilyr for _ in range(ni)]
    dzs = [hslyr for _ in range(ns)]
    zqin_l = [zqin[..., k] for k in range(ni)]
    zqsn_l = [zqsn[..., k] for k in range(ns)]
    zSin_l = [zSin[..., k] for k in range(ni)]
    if tr_snow:
        smicetot = [dzs[k] * smice[..., k] for k in range(ns)]
        smliqtot = [dzs[k] * smliq[..., k] for k in range(ns)]
    meltt = torch.zeros_like(hin)
    melts = torch.zeros_like(hin)
    meltb = torch.zeros_like(hin)
    emlt_atm = torch.zeros_like(hin)
    emlt_ocn = torch.zeros_like(hin)

    # melt enthalpies: qmlt = enthalpy_of_melting for mushy, else 0
    # (reference :1197-1206); qm = zqin - qmlt drives melt energetics
    if ktherm == 2:
        from .mushy import enthalpy_mush, enthalpy_of_melting
        qmlt_l = [enthalpy_of_melting(zSin_l[k]) for k in range(ni)]
    else:
        qmlt_l = [torch.zeros_like(hin) for _ in range(ni)]
    qm_l = [zqin_l[k] - qmlt_l[k] for k in range(ni)]

    # energy budgets (reference :1240-1255)
    wk1 = -flatn * dt
    esub = wk1.clamp(min=0.0)
    econ = wk1.clamp(max=0.0)
    wk1 = (fsurfn - fcondtopn) * dt
    etop_mlt = wk1.clamp(min=0.0)
    wk1 = (fcondbot - fbot) * dt
    ebot_mlt = wk1.clamp(min=0.0)
    ebot_gro = wk1.clamp(max=0.0)

    # condensation (:1257-1290)
    has_snow = hsn > c.PUNY
    dhs = torch.where(has_snow, econ / (zqsn_l[0] - c.RHOS * c.LVAP), 0.0)
    dhi = torch.where(has_snow, 0.0, econ / (qm_l[0] - c.RHOI * c.LVAP))
    emlt_atm = emlt_atm - torch.where(has_snow, 0.0, qmlt_l[0] * dhi)
    if tr_snow:
        smicetot[0] = smicetot[0] + dhs * c.RHOS
    dzs[0] = dzs[0] + dhs
    dzi[0] = dzi[0] + dhi
    evapn = dhs * c.RHOS + dhi * c.RHOI

    # bottom growth (:1292-1345)
    if ktherm == 2:
        qbotm = enthalpy_mush(Tbot, sss)
        qbotp = -c.LFRESH * c.RHOI * \
            (1.0 - tun.congelation_ice_porosity)
        qbot0 = qbotm - qbotp
        dhi = ebot_gro / qbotp
        hqtot = dzi[ni - 1] * zqin_l[ni - 1] + dhi * qbotm
        hstot = dzi[ni - 1] * zSin_l[ni - 1] + dhi * sss
        emlt_ocn = emlt_ocn - qbot0 * dhi
    else:
        Tmlts_b = -zSin_l[ni - 1] * c.DEPRESST
        qbot = -c.RHOI * (c.CP_ICE * (Tmlts_b - Tbot) +
                          c.LFRESH * (1.0 - Tmlts_b /
                                      Tbot.clamp(max=-c.PUNY)) -
                          c.CP_OCN * Tmlts_b)
        qbot = qbot.clamp(max=QBOTMAX)
        dhi = ebot_gro / qbot
        hqtot = dzi[ni - 1] * zqin_l[ni - 1] + dhi * qbot
        hstot = None
    grew = (dzi[ni - 1] + dhi) > c.PUNY
    dzi[ni - 1] = dzi[ni - 1] + dhi
    zqin_l[ni - 1] = torch.where(
        grew, hqtot / dzi[ni - 1].clamp(min=c.PUNY), zqin_l[ni - 1])
    if ktherm == 2:
        zSin_l[ni - 1] = torch.where(
            grew, hstot / dzi[ni - 1].clamp(min=c.PUNY), zSin_l[ni - 1])
        qmlt_l[ni - 1] = enthalpy_of_melting(zSin_l[ni - 1])
    qm_l[ni - 1] = zqin_l[ni - 1] - qmlt_l[ni - 1]
    congel = dhi

    # internal snow melt for mushy (zqsn above fresh melting; :1346-1358)
    if ktherm == 2:
        for k in range(ns):
            warm = zqsn_l[k] > -c.RHOS * c.LFRESH
            dhs = torch.where(
                warm,
                torch.maximum(-dzs[k],
                              -((zqsn_l[k] + c.RHOS * c.LFRESH) /
                                (c.RHOS * c.LFRESH)) * dzs[k]), 0.0)
            if tr_snow:
                moved = _moved(dzs[k], smicetot[k], dhs)
                smicetot[k] = (smicetot[k] + moved).clamp(min=0.0)
                smliqtot[k] = (smliqtot[k] - moved).clamp(min=0.0)
            dzs[k] = dzs[k] + dhs
            zqsn_l[k] = torch.where(warm, -c.RHOS * c.LFRESH, zqsn_l[k])
            melts = melts - dhs

    # snow: sublimation then top melt (:1360-1392)
    for k in range(ns):
        qsub = zqsn_l[k] - c.RHOS * c.LVAP
        dhs = torch.maximum(-dzs[k], esub / qsub)
        if tr_snow:
            smicetot[k] = (smicetot[k] +
                           _moved(dzs[k], smicetot[k], dhs)).clamp(min=0.0)
        dzs[k] = dzs[k] + dhs
        esub = (esub - dhs * qsub).clamp(min=0.0)
        evapn = evapn + dhs * c.RHOS
        dhs = torch.maximum(-dzs[k],
                            etop_mlt / zqsn_l[k].clamp(max=-c.PUNY))
        if tr_snow:
            moved = _moved(dzs[k], smicetot[k], dhs)
            smicetot[k] = (smicetot[k] + moved).clamp(min=0.0)
            smliqtot[k] = (smliqtot[k] - moved).clamp(min=0.0)
        dzs[k] = dzs[k] + dhs
        etop_mlt = (etop_mlt - dhs * zqsn_l[k]).clamp(min=0.0)
        melts = melts - dhs

    # ice: sublimation then top melt, top-down (:1394-1428)
    for k in range(ni):
        qsub = qm_l[k] - c.RHOI * c.LVAP
        dhi = torch.maximum(-dzi[k], esub / qsub)
        dzi[k] = dzi[k] + dhi
        esub = (esub - dhi * qsub).clamp(min=0.0)
        evapn = evapn + dhi * c.RHOI
        emlt_ocn = emlt_ocn - qmlt_l[k] * dhi
        neg_q = qm_l[k] < 0.0
        dhi = torch.where(neg_q,
                          torch.maximum(-dzi[k], etop_mlt /
                                        qm_l[k].clamp(max=-c.PUNY)),
                          -dzi[k])
        qm_eff = torch.where(neg_q, qm_l[k], 0.0)
        emlt_ocn = emlt_ocn - torch.maximum(zqin_l[k], qmlt_l[k]) * dhi
        dzi[k] = dzi[k] + dhi
        etop_mlt = (etop_mlt - dhi * qm_eff).clamp(min=0.0)
        meltt = meltt - dhi

    # ice: bottom melt, bottom-up (:1430-1450)
    for k in range(ni - 1, -1, -1):
        neg_q = qm_l[k] < 0.0
        dhi = torch.where(neg_q,
                          torch.maximum(-dzi[k], ebot_mlt /
                                        qm_l[k].clamp(max=-c.PUNY)),
                          -dzi[k])
        qm_eff = torch.where(neg_q, qm_l[k], 0.0)
        emlt_ocn = emlt_ocn - torch.maximum(zqin_l[k], qmlt_l[k]) * dhi
        dzi[k] = dzi[k] + dhi
        ebot_mlt = (ebot_mlt - dhi * qm_eff).clamp(min=0.0)
        meltb = meltb - dhi

    # snow: bottom melt after all ice gone (:1452-1468)
    for k in range(ns - 1, -1, -1):
        dhs = torch.maximum(-dzs[k],
                            ebot_mlt / zqsn_l[k].clamp(max=-c.PUNY))
        if tr_snow:
            moved = _moved(dzs[k], smicetot[k], dhs)
            smicetot[k] = (smicetot[k] + moved).clamp(min=0.0)
            smliqtot[k] = (smliqtot[k] - moved).clamp(min=0.0)
        dzs[k] = dzs[k] + dhs
        ebot_mlt = (ebot_mlt - dhs * zqsn_l[k]).clamp(min=0.0)
        melts = melts - dhs

    fhocnn = fbot + (esub + etop_mlt + ebot_mlt) / dt

    # new snowfall (:1481-1540)
    hsn_new = fsnow / c.RHOS * dt
    hstot_s = dzs[0] + hsn_new
    zq_new = -c.RHOS * c.LFRESH
    zqsn_l[0] = torch.where(
        hstot_s > 0.0,
        ((dzs[0] * zqsn_l[0] + hsn_new * zq_new) /
         hstot_s.clamp(min=c.PUNY)).clamp(max=-c.RHOS * c.LFRESH),
        zqsn_l[0])
    if rsnw is not None:
        # incorporate fresh snow in the top-layer grain radius
        # (reference add_new_snow_radius)
        rsnw_l = [rsnw[..., k] for k in range(ns)]
        rsnw_l[0] = torch.where(
            hstot_s > c.PUNY,
            (dzs[0] * rsnw_l[0] + hsn_new * tun.fallen_snow_radius) /
            hstot_s.clamp(min=c.PUNY), rsnw_l[0])
    if tr_snow:
        smicetot[0] = smicetot[0] + hsn_new * c.RHOS
        # rain adds to the top-layer liquid tracer (:1542)
        if frain is not None:
            smliqtot[0] = smliqtot[0] + frain * dt
    dzs[0] = torch.where(hstot_s > 0.0, hstot_s, dzs[0])

    hin = sum(dzi)
    hsn = sum(dzs)
    dsnow = hsn - ns * hslyr0

    # freeboard: convert snow to ice if below waterline (:1565,1780-1860);
    # mushy flooding is handled by flood_ice instead
    snoice = torch.zeros_like(hin)
    if ktherm != 2:
        wk1 = hsn - hin * (c.RHOW - c.RHOI) / c.RHOS
        below = (wk1 > c.PUNY) & (hsn > c.PUNY)
        dhsn_total = torch.where(
            below, torch.minimum(wk1 * c.RHOI / c.RHOW, hsn), 0.0)
        dhin = dhsn_total * c.RHOS / c.RHOI
        hqs = torch.zeros_like(hin)
        dhsn = dhsn_total
        act = dhin > c.PUNY
        for k in range(ns - 1, -1, -1):
            dhs = torch.where(act, torch.minimum(dhsn, dzs[k]), 0.0)
            if tr_snow:
                fracgone = torch.where(dzs[k].abs() > c.PUNY,
                                       dhs / dzs[k].clamp(min=c.PUNY), 0.0)
                smicetot[k] = (smicetot[k] * (1.0 - fracgone)).clamp(
                    min=0.0)
                smliqtot[k] = (smliqtot[k] * (1.0 - fracgone)).clamp(
                    min=0.0)
            hsn = hsn - dhs
            dsnow = dsnow - dhs
            dzs[k] = dzs[k] - dhs
            dhsn = (dhsn - dhs).clamp(min=0.0)
            hqs = hqs + dhs * zqsn_l[k]
        wk1 = dzi[0] + dhin
        hin = torch.where(act, hin + dhin, hin)
        zqin_l[0] = torch.where(
            act, (dzi[0] * zqin_l[0] + hqs) / wk1.clamp(min=c.PUNY),
            zqin_l[0])
        dzi[0] = torch.where(act, wk1, dzi[0])
        snoice = torch.where(act, dhin, 0.0)

    # snow mass tracers back to densities; collect liquid of vanished
    # layers as meltsliq (reference :1585-1600)
    meltsliq = torch.zeros_like(hin)
    if tr_snow:
        smice_l, smliq_l = [], []
        for k in range(ns):
            gone = dzs[k] <= c.PUNY
            meltsliq = meltsliq + torch.where(gone, smliqtot[k], 0.0)
            smice_l.append(torch.where(
                gone, 0.0, smicetot[k] / dzs[k].clamp(min=c.PUNY)))
            smliq_l.append(torch.where(
                gone, 0.0, smliqtot[k] / dzs[k].clamp(min=c.PUNY)))

    # re-grid to equal layers (:1620-1700)
    hin = hin.clamp(min=0.0)
    hsn = hsn.clamp(min=0.0)
    hilyr = hin / ni
    hslyr = hsn / ns
    dzi_a = torch.stack([d.clamp(min=0.0) for d in dzi], -1)
    dzs_a = torch.stack([d.clamp(min=0.0) for d in dzs], -1)
    zqin_a = torch.stack(zqin_l, -1)
    zqsn_a = torch.stack(zqsn_l, -1)
    zSin_a = torch.stack(zSin_l, -1)
    if ktherm == 0:
        # zero-heat-capacity ice: enthalpies pinned at the fresh values
        # (reference :1652-1656)
        zqin_a = torch.full_like(zqin_a, -c.RHOI * c.LFRESH)
        zqsn_a = torch.full_like(zqsn_a, -c.RHOS * c.LFRESH)
    else:
        zqin_a = adjust_enthalpy(dzi_a, hilyr, hin, zqin_a)
        if ktherm == 2:
            zSin_a = adjust_enthalpy(dzi_a, hilyr, hin, zSin_a)
        if ns > 1:
            zqsn_a = adjust_enthalpy(dzs_a, hslyr, hsn, zqsn_a)
    smice_out = smliq_out = rsnw_out = None
    regrid_snow = ns > 1 and ktherm != 0
    if rsnw is not None:
        rsnw_out = torch.stack(rsnw_l, -1)
        if regrid_snow:
            rsnw_out = adjust_enthalpy(dzs_a, hslyr, hsn, rsnw_out)
    if tr_snow:
        smice_out = torch.stack(smice_l, -1)
        smliq_out = torch.stack(smliq_l, -1)
        if regrid_snow:
            smice_out = adjust_enthalpy(dzs_a, hslyr, hsn, smice_out)
            smliq_out = adjust_enthalpy(dzs_a, hslyr, hsn, smliq_out)

    # remove very thin snow (ktherm=2; :1700-1720)
    if ktherm == 2:
        thin = hsn <= c.PUNY
        fhocnn = fhocnn + torch.where(
            thin, zqsn_a.sum(-1) * hsn / (ns * dt), 0.0)
        zqsn_a = torch.where(thin[..., None], -c.RHOS * c.LFRESH, zqsn_a)
        if tr_snow:
            # the reference books the ice mass of the removed snow here
            meltsliq = meltsliq + torch.where(thin, sum(smicetot), 0.0)
            smice_out = torch.where(thin[..., None], 0.0, smice_out)
            smliq_out = torch.where(thin[..., None], 0.0, smliq_out)
        hslyr = torch.where(thin, 0.0, hslyr)
        hsn = torch.where(thin, 0.0, hsn)

    efinal = -evapn * c.LVAP + \
        (hslyr[..., None] * zqsn_a).sum(-1) + \
        (hilyr[..., None] * zqin_a).sum(-1)
    evapn = evapn / dt
    if ktherm == 2:
        # melt water is not zero-enthalpy with mushy thermo (:1735-1742)
        fhocnn = fhocnn + emlt_ocn / dt
        efinal = efinal + emlt_atm

    return ThicknessResult(
        hin=hin, hsn=hsn, zqin=zqin_a, zqsn=zqsn_a, zSin=zSin_a,
        efinal=efinal, fhocnn=fhocnn, evapn=evapn, meltt=meltt,
        melts=melts, meltb=meltb, congel=congel, snoice=snoice,
        hsn_new=hsn_new, dsnow=dsnow, meltsliq=meltsliq,
        smice=smice_out, smliq=smliq_out, rsnw=rsnw_out)


class ThermoVerticalResult(NamedTuple):
    Tsf: torch.Tensor
    hin: torch.Tensor
    hsn: torch.Tensor
    zqin: torch.Tensor
    zqsn: torch.Tensor
    zSin: torch.Tensor
    fsensn: torch.Tensor
    flatn: torch.Tensor
    flwoutn: torch.Tensor
    fsurfn: torch.Tensor
    fcondtopn: torch.Tensor
    fhocnn: torch.Tensor
    freshn: torch.Tensor
    fsaltn: torch.Tensor
    evapn: torch.Tensor
    meltt: torch.Tensor
    melts: torch.Tensor
    meltb: torch.Tensor
    congel: torch.Tensor
    snoice: torch.Tensor
    converged: torch.Tensor
    dsnow: torch.Tensor
    hsn_new: torch.Tensor             # new snowfall depth this step (m)
    meltsliq: torch.Tensor
    hpond: Optional[torch.Tensor]     # updated pond depth (mushy flushing)
    smice: Optional[torch.Tensor] = None
    smliq: Optional[torch.Tensor] = None
    rsnw: Optional[torch.Tensor] = None
    iterations: int = 0               # the heat solver's iterations


LAMBDA_POND = 1.0 / (10.0 * 24.0 * 3600.0)
HPOND0 = 0.01


def flush_pond(dt, w, hpond, apond):
    """Drain melt ponds by mushy Darcy flushing + exponential decay
    (reference flush_pond, ice_therm_mushy.F90:3302-3338)."""
    act = (apond > 0.0) & (hpond > 0.0)
    h = hpond - w * dt / apond.clamp(min=c.PUNY)
    h = h.clamp(min=0.0)
    h = h - LAMBDA_POND * dt * (h + HPOND0)
    h = h.clamp(min=0.0)
    return torch.where(act, h, hpond)


def thermo_vertical(dt, aicen, vicen, vsnon, Tsf, zqin, zqsn, zSin,
                    flw, potT, Qa, rhoa, fsnow,
                    fbot, Tbot, fswsfc, fswint, Sswabs, Iswabs,
                    shcoef, lhcoef, *, ktherm: int = 1, sss=None,
                    frain=None, apond=None, hpond=None,
                    smice=None, smliq=None, rsnw=None, tun=None,
                    prescribed_sfc_fluxes=None) -> ThermoVerticalResult:
    """Per-category vertical thermodynamics driver (reference
    thermo_vertical, ice_therm_vertical.F90:53-471) with the ktherm
    dispatch of the reference (:286-335).

    All inputs [*B] or [*B, nLayers]; category masking (aicen > puny)
    must be applied by the caller; columns with no ice still produce
    finite no-op results.

    ktherm=2 extras: sss (required), apond/hpond (pond fraction of
    category area + depth, for flushing; optional), and the updated
    zSin/hpond are returned.  smice/smliq/rsnw: optional snow mass /
    grain-radius tracers, updated through the melt/regrid bookkeeping.

    prescribed_sfc_fluxes: calc_Tsfc=False coupled mode: a dict with
    'fsurf', 'fcondtop', 'flat', 'fsens' per-category fluxes from the
    atmosphere model (reference set_sfcflux,
    ice_flux_colpkg.F90:174-288, dispatched at
    ice_colpkg.F90:2196-2207).  The surface temperature is not
    re-solved; the thermo uses the know_Tsfc boundary condition.
    Unsupported for ktherm=2 (the reference hard-errors too,
    mpas_seaice_column.F:9259-9263).
    """
    ni = zqin.shape[-1]
    ns = zqsn.shape[-1]
    if ktherm == 2 and sss is None:
        raise ValueError("mushy thermodynamics (ktherm=2) requires sss")
    if prescribed_sfc_fluxes is not None and ktherm == 2:
        raise ValueError(
            "calc_Tsfc=False is incompatible with mushy thermodynamics "
            "(reference check_column_package_configs, "
            "mpas_seaice_column.F:9259-9263)")
    pf = prescribed_sfc_fluxes
    has = aicen > c.PUNY
    safe_a = torch.where(has, aicen, 1.0)
    hin = torch.where(has, vicen / safe_a, 0.1)
    hsn = torch.where(has, vsnon / safe_a, 0.0)
    hin0, hsn0 = hin, hsn          # worki/works (reference :276)
    hilyr = hin.clamp(min=c.PUNY) / ni
    hslyr = hsn / ns

    fadvocn = torch.zeros_like(Tsf)
    snoice_flood = torch.zeros_like(Tsf)
    hpond_out = hpond

    if ktherm == 2:
        from .mushy import (enthalpy_brine, liquid_fraction,
                            liquidus_brine_salinity, temperature_mush)
        from .mushy_solver import flood_ice, temperature_changes_mushy
        res = temperature_changes_mushy(
            dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
            fswsfc, fswint, Sswabs, Iswabs,
            hilyr, hslyr, zqin, zSin, zqsn, Tsf, Tbot,
            sss=sss, hpond=hpond, apond=apond, tun=tun)
        zqin2, zqsn2, zSin2 = res.zqin, res.zqsn, res.zSin
        fadvocn = res.fadvheat
        # pond flushing (reference :327)
        if hpond is not None:
            hpond_out = flush_pond(dt, res.w, hpond, apond)
        # snow-ice flooding (reference :330)
        phi = liquid_fraction(temperature_mush(zqin2, zSin2), zSin2)
        Sbr = liquidus_brine_salinity(res.zTin)
        fr = flood_ice(dt, hsn, hin.clamp(min=c.PUNY), hslyr, hilyr,
                       zqsn2, zqin2, zSin2, phi, Sbr, sss,
                       enthalpy_brine(Tbot))
        zqsn2, zqin2, zSin2 = fr.zqsn, fr.zqin, fr.zSin
        hilyr, hslyr = fr.hilyr, fr.hslyr
        snoice_flood = fr.snoice
        fadvocn = fadvocn - fr.eadded
    elif ktherm == 0:
        if pf is not None:
            # know_Tsfc zero-layer: fcondbot = fcondtop (reference
            # ice_therm_vertical.F90:355-365); all surface fluxes are
            # the coupler's
            res = ZeroLayerResult(
                Tsf=Tsf, fsensn=pf["fsens"], flatn=pf["flat"],
                flwoutn=torch.zeros_like(Tsf), fsurfn=pf["fsurf"],
                fcondtopn=pf["fcondtop"], fcondbot=pf["fcondtop"],
                converged=torch.ones(Tsf.shape, dtype=torch.bool,
                                     device=Tsf.device))
        else:
            res = zerolayer_temperature(
                dt, rhoa, flw, potT, Qa, shcoef, lhcoef, fswsfc,
                hilyr * ni, hslyr * ns, Tsf, Tbot)
        zqin2 = torch.full_like(zqin, -c.RHOI * c.LFRESH)
        zqsn2 = torch.full_like(zqsn, -c.RHOS * c.LFRESH)
        zSin2 = zSin
    else:
        # initial temperatures from enthalpies (init_vertical_profile)
        Tmlt = -zSin * c.DEPRESST
        zTin = ice_temperature_from_enthalpy(zqin, Tmlt)
        l_snow = hslyr > c.HS_MIN / ns
        zTsn = torch.where(l_snow[..., None],
                           snow_temperature_from_enthalpy(zqsn).clamp(
                               max=0.0), 0.0)
        zqsn0 = torch.where(l_snow[..., None], zqsn,
                            snow_enthalpy_from_temperature(0.0) *
                            torch.ones_like(zqsn))
        einit = (hilyr[..., None] * zqin).sum(-1) + \
            (hslyr[..., None] * zqsn0).sum(-1)
        res = temperature_changes(
            dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
            fswsfc, fswint, Sswabs, Iswabs,
            hilyr, hslyr, zqin, zTin, zqsn0, zTsn, zSin,
            Tsf, Tbot, einit,
            calc_tsfc=pf is None,
            fsurfn_f=None if pf is None else pf["fsurf"],
            fcondtopn_f=None if pf is None else pf["fcondtop"],
            flatn_f=None if pf is None else pf["flat"],
            fsensn_f=None if pf is None else pf["fsens"])
        zqin2, zqsn2, zSin2 = res.zqin, res.zqsn, zSin
    converged = res.converged

    th = thickness_changes(
        dt, hilyr * ni, hslyr * ns, zqin2, zqsn2, zSin2,
        fbot, Tbot, res.flatn, res.fsurfn, res.fcondtopn, res.fcondbot,
        fsnow, frain=frain, ktherm=ktherm, sss=sss,
        smice=smice, smliq=smliq, rsnw=rsnw, tun=tun)

    snoice_tot = th.snoice + snoice_flood

    # freshwater and salt fluxes to the ocean from the total thickness
    # change (reference :430-448: dhi = hin - worki,
    # dhs = hsn - works - hsn_new; evapn included)
    dhi = th.hin - hin0
    dhs = th.hsn - hsn0 - th.hsn_new
    freshn = torch.where(
        has, aicen * (th.evapn - (c.RHOI * dhi + c.RHOS * dhs) / dt), 0.0)
    fsaltn = torch.where(
        has, -aicen * c.RHOI * dhi * c.ICE_REF_SALINITY * 1e-3 / dt, 0.0)
    fhocnn = th.fhocnn + fadvocn

    def m(x):
        return torch.where(has, x, 0.0)

    def ml(x, default):
        return torch.where(has[..., None], x, default) \
            if x is not None else None

    return ThermoVerticalResult(
        Tsf=torch.where(has, res.Tsf, Tsf),
        hin=m(th.hin), hsn=m(th.hsn),
        zqin=torch.where(has[..., None], th.zqin, zqin),
        zqsn=torch.where(has[..., None], th.zqsn, zqsn),
        zSin=torch.where(has[..., None], th.zSin, zSin),
        fsensn=m(res.fsensn), flatn=m(res.flatn),
        flwoutn=m(res.flwoutn), fsurfn=m(res.fsurfn),
        fcondtopn=m(res.fcondtopn),
        fhocnn=m(fhocnn), freshn=freshn, fsaltn=fsaltn,
        evapn=m(th.evapn),
        meltt=m(th.meltt), melts=m(th.melts), meltb=m(th.meltb),
        congel=m(th.congel), snoice=m(snoice_tot),
        converged=converged | ~has,
        dsnow=m(th.dsnow), hsn_new=m(th.hsn_new),
        meltsliq=m(th.meltsliq),
        hpond=(torch.where(has, hpond_out, hpond)
               if hpond is not None else None),
        smice=ml(th.smice, smice), smliq=ml(th.smliq, smliq),
        rsnw=ml(th.rsnw, rsnw),
        iterations=res.iterations)


def thermo_vertical_noop(aicen, vicen, vsnon, tsfc, zqin, zqsn, zSin
                         ) -> ThermoVerticalResult:
    """Identity ThermoVerticalResult (config_use_column_vertical_
    thermodynamics=false: the timestep skips therm1; state passes
    through unchanged, all tendencies/fluxes zero)."""
    a_ok = aicen > c.PUNY
    safe = torch.where(a_ok, aicen, 1.0)
    z = torch.zeros_like(aicen)
    return ThermoVerticalResult(
        Tsf=tsfc,
        hin=torch.where(a_ok, vicen / safe, 0.0),
        hsn=torch.where(a_ok, vsnon / safe, 0.0),
        zqin=zqin, zqsn=zqsn, zSin=zSin,
        fsensn=z, flatn=z, flwoutn=z, fsurfn=z, fcondtopn=z,
        fhocnn=z, freshn=z, fsaltn=z, evapn=z,
        meltt=z, melts=z, meltb=z, congel=z, snoice=z,
        converged=torch.ones_like(aicen, dtype=torch.bool), dsnow=z,
        hsn_new=z, meltsliq=z, hpond=None)
