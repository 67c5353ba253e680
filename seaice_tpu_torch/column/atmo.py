"""Atmosphere-ice boundary layer: stability-iterated turbulent transfer
coefficients (reference `ice_atmo.F90` atmo_boundary_layer; Monin-Obukhov
with the CCSM3 stability functions).  Port of the JAX package's
`column/atmo.py`: the per-column iteration runs a fixed `natmiter` count
(reference default 5), vectorized over the batch; the high-frequency
coupling (ice-relative winds) and the Tsamados form drag
(`neutral_drag_coeffs`, whose neutral drag replaces the log-law one).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import constants as c

CP_WV = 1.81e3
CPVIR = CP_WV / c.CP_AIR - 1.0
ZTRF = 2.0          # reference height for temperature diagnostics (m)


def _psi_unstable(xqq):
    psimhu = torch.log((1.0 + xqq * (2.0 + xqq)) * (1.0 + xqq * xqq) /
                       8.0) - 2.0 * torch.arctan(xqq) + 0.5 * c.PI
    psixhu = 2.0 * torch.log((1.0 + xqq * xqq) / 2.0)
    return psimhu, psixhu


class AtmoResult(NamedTuple):
    shcoef: torch.Tensor
    lhcoef: torch.Tensor
    strx: torch.Tensor
    stry: torch.Tensor
    Tref: torch.Tensor
    Qref: torch.Tensor
    delt: torch.Tensor
    delq: torch.Tensor


def atmo_boundary_layer(Tsf, potT, uatm, vatm, wind, zlvl, Qa, rhoa,
                        natmiter: int = 5,
                        sfctype: str = "ice",
                        highfreq: bool = False,
                        uvel=None, vvel=None,
                        Cdn_atm=None) -> AtmoResult:
    """Transfer coefficients for sensible/latent heat + wind stress
    (reference atmo_boundary_layer, ice_atmo.F90). All inputs [*B].

    highfreq (with uvel/vvel): the Roberts et al. 2014 high-frequency
    coupling: wind speed and momentum flux use the ice-relative wind
    (reference :175-210, :305-318). Cdn_atm: a neutral drag from the
    Tsamados form-drag scheme replaces the log-law neutral coefficient
    (reference formdrag branch :211-216)."""
    if highfreq and uvel is None:
        raise ValueError("highfreq coupling needs uvel/vvel")
    if sfctype == "ice":
        qqq, TTT, Lheat = c.QQQICE, c.TTTICE, c.LSUB
        if highfreq:
            # reference umin = 0.5 m/s in the highfreq branch
            du = uatm - uvel
            dv = vatm - vvel
            vmag = torch.sqrt(du ** 2 + dv ** 2).clamp(min=0.5)
        else:
            vmag = wind.clamp(min=1.0)
        rdn0 = c.VONKAR / math.log(c.ZREF / c.ICERUF)
        if Cdn_atm is not None:
            rdn = torch.where(Cdn_atm > c.PUNY,
                              torch.sqrt(Cdn_atm.clamp(min=c.PUNY)), rdn0)
        else:
            rdn = torch.full_like(wind, rdn0)
    else:
        qqq, TTT, Lheat = c.QQQOCN, c.TTTOCN, c.LVAP
        vmag = wind.clamp(min=1.0)
        rdn = torch.sqrt(0.0027 / vmag + 0.000142 + 0.0000764 * vmag)

    TsfK = Tsf + c.TFFRESH
    qsat = qqq * torch.exp(-TTT / TsfK)
    ssq = qsat / rhoa
    thva = potT * (1.0 + c.ZVIR * Qa)
    delt = potT - TsfK
    delq = Qa - ssq
    alz = torch.log(zlvl / c.ZREF)
    cp = c.CP_AIR * (1.0 + CPVIR * ssq)
    al2 = math.log(c.ZREF / ZTRF)

    rhn = rdn
    ren = rdn
    ustar = rdn * vmag
    tstar = rhn * delt
    qstar = ren * delq

    rd = rdn
    rh = rhn
    re = ren
    psixh = torch.zeros_like(vmag)
    stable = torch.zeros_like(vmag)
    hol = torch.zeros_like(vmag)
    for _ in range(natmiter):
        hol = c.VONKAR * c.GRAVIT * zlvl * (
            tstar / thva + qstar / (1.0 / c.ZVIR + Qa)) / \
            (ustar ** 2).clamp(min=c.PUNY)
        hol = torch.sign(hol) * hol.abs().clamp(max=10.0)
        stable = 0.5 + 0.5 * torch.sign(hol)
        xqq = torch.sqrt((1.0 - 16.0 * hol).abs()).clamp(min=1.0)
        xqq = torch.sqrt(xqq)
        psimhs = -(0.7 * hol + 0.75 * (hol - 14.3) *
                   torch.exp(-0.35 * hol) + 10.7)
        psimhu, psixhu = _psi_unstable(xqq)
        psimh = psimhs * stable + (1.0 - stable) * psimhu
        psixh = psimhs * stable + (1.0 - stable) * psixhu
        rd = rdn / (1.0 + rdn / c.VONKAR * (alz - psimh))
        rh = rhn / (1.0 + rhn / c.VONKAR * (alz - psixh))
        re = ren / (1.0 + ren / c.VONKAR * (alz - psixh))
        ustar = rd * vmag
        tstar = rh * delt
        qstar = re * delq

    if highfreq and sfctype == "ice":
        # Roberts et al. 2014: stress from the ice-relative wind
        tau = rhoa * rd * rd
        dmag = torch.sqrt(du ** 2 + dv ** 2)
        strx = tau * dmag * du
        stry = tau * dmag * dv
    else:
        tau = rhoa * ustar * rd
        strx = tau * uatm
        stry = tau * vatm

    shcoef = rhoa * ustar * cp * rh + 1.0
    lhcoef = rhoa * ustar * Lheat * re

    # 2-m diagnostics (reference :declarations for Tref/Qref)
    hol2 = hol * ZTRF / zlvl
    xqq = torch.sqrt((1.0 - 16.0 * hol2).abs()).clamp(min=1.0)
    xqq = torch.sqrt(xqq)
    _, psixhu2 = _psi_unstable(xqq)
    psix2 = -5.0 * hol2 * stable + (1.0 - stable) * psixhu2
    fac = (rh / c.VONKAR) * (alz + al2 - psixh + psix2)
    Tref = potT - delt * fac - 0.01 * ZTRF
    fac = (re / c.VONKAR) * (alz + al2 - psixh + psix2)
    Qref = Qa - delq * fac

    return AtmoResult(shcoef=shcoef, lhcoef=lhcoef, strx=strx,
                      stry=stry, Tref=Tref, Qref=Qref,
                      delt=delt, delq=delq)


def atmo_constant_coefficients(Tsf, potT, uatm, vatm, wind, Qa, rhoa):
    """Constant-coefficient fallback (reference atmo_boundary_const):
    shcoef/lhcoef with fixed exchange coefficient 1.2e-3."""
    vmag = wind.clamp(min=1.0)
    tau = rhoa * 0.0012 * vmag
    strx = tau * uatm
    stry = tau * vatm
    shcoef = tau * c.CP_AIR
    lhcoef = tau * c.LSUB
    TsfK = Tsf + c.TFFRESH
    return AtmoResult(
        shcoef=shcoef, lhcoef=lhcoef, strx=strx, stry=stry,
        Tref=potT, Qref=Qa, delt=potT - TsfK,
        delq=Qa - c.QQQICE * torch.exp(-c.TTTICE / TsfK) / rhoa)


# -- form drag (Tsamados et al. 2014) ---------------------------------------

class FormDragResult(NamedTuple):
    Cdn_atm: torch.Tensor       # total ice-atm neutral drag
    Cdn_ocn: torch.Tensor       # total ice-ocn neutral drag
    Cdn_atm_skin: torch.Tensor
    Cdn_atm_floe: torch.Tensor
    Cdn_atm_pond: torch.Tensor
    Cdn_atm_rdg: torch.Tensor
    Cdn_ocn_skin: torch.Tensor
    Cdn_ocn_floe: torch.Tensor
    Cdn_ocn_keel: torch.Tensor
    hfreebd: torch.Tensor       # freeboard (m)
    hdraft: torch.Tensor        # draft (m)
    hridge: torch.Tensor        # sail height (m)
    distrdg: torch.Tensor       # distance between ridges (m)
    hkeel: torch.Tensor         # keel depth (m)
    lfloe: torch.Tensor         # floe length (m)
    dfloe: torch.Tensor         # distance between floes (m)


def neutral_drag_coeffs(apnd, hpnd, alvl, aicen, vicen, vsnon,
                        vlvl=None,
                        use_ponds: bool = True) -> FormDragResult:
    """Neutral form drag coefficients from the pack geometry
    (reference neutral_drag_coeffs, ice_atmo.F90:496-827; Tsamados
    et al. 2014): skin drag screened by sails/keels, sail (ridge) and
    keel drag from the ridged-ice geometry, floe-edge drag from the
    Lupkes 2012 floe-length closure, and pond-edge drag. All
    per-category inputs [*B, nCat]; returns grid-cell coefficients
    [*B]. The per-cell branch ladder becomes masked dense selects."""
    del hpnd
    puny = c.PUNY
    csw, csa = 0.002, 0.0005
    mrdg, mrdgo = 20.0, 10.0
    beta, Lmin, Lmax = 0.5, 8.0, 300.0
    cfa, cfw, cpa, cra, crw = 0.2, 0.2, 0.2, 0.2, 0.2
    sl = 22.0
    lpmin, lpmax = 2.26, 24.63
    tanar, tanak = 0.4, 0.4
    phir, phik = 0.8, 0.8
    hkoverhr, dkoverdr = 4.0, 1.0
    sHGB = 0.18
    alpha2, beta2 = 0.0, 0.75
    ocnruf = 0.000327
    camax, cwmax = 0.02, 0.06

    aice = aicen.sum(-1)
    vice = vicen.sum(-1)
    vsno = vsnon.sum(-1)
    has = aice > 0.001
    ai = torch.where(has, aice, 1.0)
    aii = 1.0 / ai

    # reference uses apnd(n)*aicen(n) directly (no alvl factor)
    apond = (apnd * aicen).sum(-1) if use_ponds else torch.zeros_like(aice)

    # draft and freeboard (Eq. 27-28, Stoessel 1993 snow correction)
    hdraft = (c.RHOI * vice + c.RHOS * vsno) * aii / c.RHOW
    hfreebd = (vice + vsno) * aii - hdraft
    hfreebd_corr = (hdraft * ai * (1.0 - c.RHOI / c.RHOW) +
                    (vsno - (vice - hdraft * ai) * c.RHOI / c.RHOS) *
                    (1.0 - c.RHOS / c.RHOW)) * aii
    hfreebd = torch.where(hdraft >= vice * aii, hfreebd_corr, hfreebd)

    # floe length / spacing (Eq. 13-14, Lupkes 2012)
    astar = 1.0 / (1.0 - (Lmin / Lmax) ** (1.0 / beta))
    lfloe = Lmin * (astar / (astar - ai).clamp(min=puny)) ** beta
    dfloe = lfloe * (1.0 / torch.sqrt(ai) - 1.0)

    # ridge/keel geometry from the ridged fraction (Eq. 25-26);
    # ridged volume uses the separate level-volume tracer vlvl
    # (reference: (1-vlvl(n))*vicen(n)), falling back to alvl
    ardg = ((1.0 - alvl) * aicen).sum(-1)
    vlvl_eff = alvl if vlvl is None else vlvl
    vrdg = ((1.0 - vlvl_eff) * vicen).sum(-1)
    has_rdg = has & (ardg > 0.001)
    safe_ardg = ardg.clamp(min=puny)
    hridge = vrdg / safe_ardg * 2.0 * \
        (alpha2 + beta2 * hkoverhr / dkoverdr * tanar / tanak) / \
        (phir * 1.0 + phik * tanar / tanak * hkoverhr ** 2 / dkoverdr)
    distrdg = 2.0 * hridge * ai / safe_ardg * \
        (alpha2 / tanar + beta2 / tanak * hkoverhr / dkoverdr)
    hkeel = hkoverhr * hridge
    dkeel = dkoverdr * distrdg
    hridge = torch.where(has_rdg, hridge, 0.0)
    distrdg = torch.where(has_rdg, distrdg, 0.0)
    hkeel = torch.where(has_rdg, hkeel, 0.0)
    dkeel = torch.where(has_rdg, dkeel, 0.0)

    log_zref_ice = math.log(c.ZREF / c.ICERUF)
    log_zref_ocn = math.log(c.ZREF / ocnruf)

    # skin drag screened by sails (Eq. 10 variant: sail height above
    # the mean freeboard)
    sail = (hridge - hfreebd).clamp(min=0.0)
    safe_dr = distrdg.clamp(min=puny)
    cd_a_skin = torch.where(
        has_rdg, (csa * (1.0 - mrdg * sail / safe_dr)).clamp(0.0, camax),
        csa * has.to(aice.dtype))

    # sail (ridge) drag (Eq. 9-10)
    sca = 1.0 - torch.exp(-sHGB * safe_dr / sail.clamp(min=puny))
    cd_a_rdg = torch.where(
        has_rdg & (sail > puny),
        (cra * 0.5 * sail / safe_dr * sca *
         (torch.log(sail.clamp(min=puny) / c.ICERUF) /
          log_zref_ice) ** 2).clamp(max=camax), 0.0)

    # keel drag + screened bottom skin drag (Eq. 11, 19)
    keel = (hkeel - hdraft).clamp(min=0.0)
    safe_dk = dkeel.clamp(min=puny)
    cd_o_skin = torch.where(
        has_rdg, (csw * (1.0 - mrdgo * keel / safe_dk)).clamp(0.0, cwmax),
        csw * has.to(aice.dtype))
    scw = 1.0 - torch.exp(-sHGB * safe_dk / keel.clamp(min=puny))
    cd_o_keel = torch.where(
        has_rdg & (keel > puny),
        (crw * 0.5 * keel / safe_dk * scw *
         (torch.log(keel.clamp(min=puny) / c.ICERUF) /
          log_zref_ice) ** 2).clamp(0.0, cwmax), 0.0)

    # floe edge drag, atm (Eq. 12) and ocean (Eq. 15)
    fb = hfreebd.clamp(min=puny)
    sca_f = 1.0 - torch.exp(-sl * beta * (1.0 - ai))
    cd_a_floe = torch.where(
        has & (hfreebd > puny),
        (cfa * 0.5 * (torch.log(fb / ocnruf) / log_zref_ocn) ** 2 *
         sca_f * hfreebd / lfloe).clamp(0.0, camax), 0.0)
    dr_ = hdraft.clamp(min=puny)
    cd_o_floe = torch.where(
        has & (hdraft > puny),
        (cfw * 0.5 * (torch.log(dr_ / ocnruf) / log_zref_ocn) ** 2 *
         sca_f * hdraft / lfloe).clamp(0.0, cwmax), 0.0)

    # pond edge drag (Eq. 16-17)
    lp = lpmin * (1.0 - apond) + lpmax * apond
    sca_p = apond.clamp(min=0.0) ** (1.0 / (c.ZREF * beta))
    cd_a_pond = torch.where(
        has & (hfreebd > puny),
        (cpa * 0.5 * sca_p * apond * hfreebd / lp *
         (torch.log(fb / ocnruf) / log_zref_ocn) ** 2).clamp(max=camax),
        0.0)

    cd_atm = torch.where(
        has, (cd_a_skin + cd_a_floe + cd_a_pond + cd_a_rdg).clamp(
            max=camax),
        (c.VONKAR / log_zref_ice) ** 2)
    cd_ocn = torch.where(
        has, (cd_o_skin + cd_o_floe + cd_o_keel).clamp(max=cwmax),
        c.DRAGIO)

    z = torch.zeros_like(aice)

    def mk(x):
        return torch.where(has, x, z)

    return FormDragResult(
        Cdn_atm=cd_atm, Cdn_ocn=cd_ocn,
        Cdn_atm_skin=mk(cd_a_skin), Cdn_atm_floe=cd_a_floe,
        Cdn_atm_pond=cd_a_pond, Cdn_atm_rdg=cd_a_rdg,
        Cdn_ocn_skin=mk(cd_o_skin), Cdn_ocn_floe=cd_o_floe,
        Cdn_ocn_keel=cd_o_keel,
        hfreebd=mk(hfreebd), hdraft=mk(hdraft), hridge=hridge,
        distrdg=distrdg, hkeel=hkeel, lfloe=mk(lfloe),
        dfloe=mk(dfloe))
