"""Atmosphere-ice boundary layer: stability-iterated turbulent transfer
coefficients (reference `ice_atmo.F90` atmo_boundary_layer; Monin-Obukhov
with the CCSM3 stability functions).  Port of the JAX package's
`column/atmo.py`: the per-column iteration runs a fixed `natmiter` count
(reference default 5), vectorized over the batch.

Not ported (`ColumnPhysics` raises for them, ROADMAP Queue 1 item 10):
the high-frequency coupling (ice-relative winds) and the Tsamados form
drag (`neutral_drag_coeffs`, whose neutral drag replaces the log-law
one).
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
                        sfctype: str = "ice") -> AtmoResult:
    """Transfer coefficients for sensible/latent heat + wind stress
    (reference atmo_boundary_layer, ice_atmo.F90). All inputs [*B]."""
    if sfctype == "ice":
        qqq, TTT, Lheat = c.QQQICE, c.TTTICE, c.LSUB
        vmag = wind.clamp(min=1.0)
        rdn = torch.full_like(wind, c.VONKAR / math.log(c.ZREF / c.ICERUF))
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
