"""Bitz & Lipscomb (1999) vertical heat solver, vectorized.

Port of the JAX package's `column/bl99.py`, which re-designs
`temperature_changes` (`ice_therm_bl99.F90:53-811`): the per-column
Newton-ish iteration with tridiagonal solves runs over all (cell,
category) columns at once, with per-column convergence masking
(converged columns freeze their values, so an iteration after a column
converged is an exact no-op for it).  The tridiagonal system (nslyr +
nilyr + 1 unknowns) is solved by an unrolled Thomas algorithm.

The loop runs on the host: it tests `converged.all()` every
`CONVERGENCE_CHECK_EVERY` iterations (one host sync each) and stops at
the latest after the iteration with niter == NITERMAX, as the reference's
`niter <= NITERMAX` loop condition does.

Batch convention: every field has an arbitrary leading batch shape B
(typically [nCells, nCategories]); layer fields are [*B, nLayers].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..diagnostics import count
from . import constants as c
from .thermo_shared import (dsurface_heat_flux_dTsf,
                            ice_enthalpy_from_temperature,
                            snow_enthalpy_from_temperature,
                            surface_heat_flux)

NITERMAX = 100
TSF_ERRMAX = 5.0e-4
# iterations between two tests of "every column converged" (each test is
# one host sync; the extra iterations are no-ops for converged columns)
CONVERGENCE_CHECK_EVERY = 2


def _build_kh(l_snow, hilyr, hslyr, zTin, zSin, ns, conduct="bl99"):
    """kh [*B, ns+ni+1]: index 0 = snow top, 1..ns-1 = snow interior,
    ns = snow/ice interface (or ice top), ns+1..ns+ni-1 = ice interior,
    ns+ni = ice bottom."""
    ni = zTin.shape[-1]
    if conduct == "mu71":
        kilyr = c.KICE + c.BETAK * zSin / zTin.clamp(max=-c.PUNY)
    else:
        kilyr = (2.11 - 0.011 * zTin +
                 0.09 * zSin / zTin.clamp(max=-c.PUNY)) * c.RHOI / 917.0
    kilyr = kilyr.clamp(min=c.KIMIN)

    hs = hslyr.clamp(min=c.PUNY)
    hi = hilyr.clamp(min=c.PUNY)
    rows = []
    # snow top
    rows.append(torch.where(l_snow, 2.0 * c.KSNO / hs, 0.0))
    # snow interior
    for k in range(1, ns):
        rows.append(torch.where(l_snow, c.KSNO / hs, 0.0))
    # snow/ice interface (or bare-ice top)
    k_int = 2.0 * c.KSNO * kilyr[..., 0] / (
        c.KSNO * hi + kilyr[..., 0] * hs)
    rows.append(torch.where(l_snow, k_int, 2.0 * kilyr[..., 0] / hi))
    # ice interior
    for k in range(1, ni):
        rows.append(2.0 * kilyr[..., k - 1] * kilyr[..., k] /
                    ((kilyr[..., k - 1] + kilyr[..., k]) * hi))
    # ice bottom
    rows.append(2.0 * kilyr[..., ni - 1] / hi)
    return torch.stack(rows, -1)


def _tridiag(sb, d, sp, rhs):
    """Batched Thomas algorithm; all [*B, n], unrolled over n."""
    n = d.shape[-1]
    wbeta = d[..., 0]
    x = [rhs[..., 0] / wbeta]
    gamma = []
    for k in range(1, n):
        g = sp[..., k - 1] / wbeta
        gamma.append(g)
        wbeta = d[..., k] - sb[..., k] * g
        x.append((rhs[..., k] - sb[..., k] * x[k - 1]) / wbeta)
    for k in range(n - 2, -1, -1):
        x[k] = x[k] - gamma[k] * x[k + 1]
    return torch.stack(x, -1)


def freeze_converged(converged, new, old):
    """new where the column has not converged yet, else old."""
    cexp = converged.reshape(converged.shape + (1,) *
                             (new.ndim - converged.ndim))
    return torch.where(cexp, old, new)


def run_until_converged(one_iteration, carry, converged_index: int,
                        nitermax: int = NITERMAX):
    """Run `carry = one_iteration(carry, niter)` for niter = 1, 2, ...
    until carry[converged_index] is all True (tested every
    CONVERGENCE_CHECK_EVERY iterations) or niter == nitermax has run.
    Returns (carry, iterations run)."""
    niter = 0
    while niter < nitermax:
        niter += 1
        carry = one_iteration(carry, niter)
        if (niter % CONVERGENCE_CHECK_EVERY == 0 or niter == nitermax) \
                and bool(carry[converged_index].all()):
            break
    count("column.picard_calls")
    count("column.picard_iterations", niter)
    return carry, niter


class ThermoSolveResult(NamedTuple):
    Tsf: torch.Tensor
    zTsn: torch.Tensor
    zTin: torch.Tensor
    zqsn: torch.Tensor
    zqin: torch.Tensor
    fsensn: torch.Tensor
    flatn: torch.Tensor
    flwoutn: torch.Tensor
    fsurfn: torch.Tensor
    fcondtopn: torch.Tensor
    fcondbot: torch.Tensor
    fswsfc: torch.Tensor
    fswint: torch.Tensor
    Sswabs: torch.Tensor
    Iswabs: torch.Tensor
    converged: torch.Tensor
    iterations: int = 0        # iterations the loop ran (host count)


def temperature_changes(dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
                        fswsfc, fswint, Sswabs, Iswabs,
                        hilyr, hslyr, zqin, zTin, zqsn, zTsn, zSin,
                        Tsf, Tbot, einit,
                        conduct: str = "bl99",
                        calc_tsfc: bool = True,
                        fsurfn_f=None, fcondtopn_f=None,
                        flatn_f=None, fsensn_f=None) -> ThermoSolveResult:
    """Solve for new temperatures/enthalpies in all columns at once.

    Shapes: scalars/fluxes [*B]; zq*/zT*/zS* [*B, nLayers]; all float.

    calc_tsfc=False is the coupled prescribed-surface-flux mode
    (reference `get_matrix_elements_know_Tsfc`,
    ice_therm_bl99.F90:1242-1447 + the `.not. calc_Tsfc` branches of
    `temperature_changes` :377-684): the surface temperature row drops
    out of the tridiagonal system, the prescribed downward conductive
    flux `fcondtopn_f` enters the top snow (or bare-ice) layer rhs
    directly, Tsf stays at its coupler-provided value, and convergence
    replaces the Tsf conditions (1,3,4) with the oscillating-zTin(1)
    check (condition 2b, :618-631).  fsurfn_f/flatn_f/fsensn_f are the
    coupler's turbulent/radiative fluxes (set_sfcflux,
    ice_flux_colpkg.F90:174-288) and flow through unchanged."""
    if not calc_tsfc and fcondtopn_f is None:
        raise ValueError("calc_tsfc=False requires prescribed "
                         "fcondtopn_f/fsurfn_f/flatn_f/fsensn_f")
    ns = zTsn.shape[-1]
    ni = zTin.shape[-1]
    dtype = Tsf.dtype

    l_snow = hslyr > c.HS_MIN / ns
    dt_rhoi_hlyr = dt / (c.RHOI * hilyr.clamp(min=c.PUNY))
    Tmlts = -zSin * c.DEPRESST
    Tin_init = zTin
    Tsn_init = zTsn
    etas_base = torch.where(
        l_snow, dt / (c.RHOS * c.CP_ICE * hslyr.clamp(min=c.PUNY)), 0.0)

    kh = _build_kh(l_snow, hilyr, hslyr, zTin, zSin, ns, conduct)

    # -- cap excessive absorbed shortwave (reference :537-594) --
    frac, dTemp = 0.9, 0.02
    Isw_new = []
    for k in range(ni):
        ci = c.CP_ICE - c.LFRESH * Tmlts[..., k] / (Tin_init[..., k] ** 2)
        cap = frac * (Tmlts[..., k] - Tin_init[..., k]) * ci / dt_rhoi_hlyr
        Isw_tmp = torch.where(Tin_init[..., k] <= Tmlts[..., k] - dTemp,
                              torch.minimum(Iswabs[..., k], cap), 0.0)
        Isw_tmp = torch.where(Isw_tmp < c.PUNY, 0.0, Isw_tmp)
        dswabs = torch.minimum(Iswabs[..., k] - Isw_tmp, fswint)
        fswsfc = fswsfc + dswabs
        fswint = fswint - dswabs
        Isw_new.append(Isw_tmp)
    Iswabs = torch.stack(Isw_new, -1)
    Ssw_new = []
    for k in range(ns):
        cap = -frac * Tsn_init[..., k] / etas_base.clamp(min=c.PUNY)
        Ssw_tmp = torch.where(l_snow & (Tsn_init[..., k] <= -dTemp),
                              torch.minimum(Sswabs[..., k], cap), 0.0)
        Ssw_tmp = torch.where(Ssw_tmp < c.PUNY, 0.0, Ssw_tmp)
        dswabs = torch.where(
            l_snow, torch.minimum(Sswabs[..., k] - Ssw_tmp, fswint), 0.0)
        fswsfc = fswsfc + dswabs
        fswint = fswint - dswabs
        Ssw_new.append(torch.where(l_snow, Ssw_tmp, Sswabs[..., k]))
    Sswabs = torch.stack(Ssw_new, -1)

    zeros = torch.zeros_like(Tsf)
    ones = torch.ones_like(Tsf)
    eps = torch.finfo(dtype).eps

    def one_iteration(carry, niter):
        (Tsf, zTsn, zTin, Tsn_start, Tin_start_i, kh, dTsf_prev,
         fsurfn_p, fcondtopn_p, fcondbot_p, zqsn_p, zqin_p,
         flw_p, fsens_p, flat_p, energy_ok_p, converged) = carry

        # specific heat from current + initial temps (energy-conserving)
        ci = c.CP_ICE - c.LFRESH * Tmlts / (
            zTin.clamp(max=-c.PUNY) * Tin_init.clamp(max=-c.PUNY))
        etai = dt_rhoi_hlyr[..., None] / ci       # [*B, ni]
        etas = etas_base

        if calc_tsfc:
            flwoutn, fsensn, flatn, fsurfn = surface_heat_flux(
                Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef)
            _, _, _, dfsurf_dT = dsurface_heat_flux_dTsf(
                Tsf, rhoa, shcoef, lhcoef)

            fcondtop0 = torch.where(
                l_snow, kh[..., 0] * (Tsf - zTsn[..., 0]),
                kh[..., ns] * (Tsf - zTin[..., 0]))
            Tsf = torch.where((Tsf >= 0.0) & (fsurfn < fcondtop0),
                              -c.PUNY, Tsf)
        else:
            # prescribed coupler fluxes; nothing depends on Tsf
            flwoutn = zeros
            fsensn = fsensn_f
            flatn = flatn_f
            fsurfn = fsurfn_f
            dfsurf_dT = zeros
        Tsf_start = Tsf
        l_cold = Tsf < 0.0

        # -- assemble tridiagonal matrix (reference :994-1447) --
        nmat = ns + ni + 1
        SB = [zeros] * nmat
        D = [ones] * nmat
        SP = [zeros] * nmat
        R = [zeros] * nmat

        # Tsf equation occupies row 0 (snow) or row ns (no snow)
        tsf_diag = dfsurf_dT - torch.where(l_snow, kh[..., 0], kh[..., ns])
        tsf_sp = torch.where(l_snow, kh[..., 0], kh[..., ns])
        tsf_rhs = dfsurf_dT * Tsf - fsurfn

        row0_is_tsf = l_snow & l_cold & calc_tsfc
        D[0] = torch.where(row0_is_tsf, tsf_diag, 1.0)
        SP[0] = torch.where(row0_is_tsf, tsf_sp, 0.0)
        R[0] = torch.where(row0_is_tsf, tsf_rhs, 0.0)

        # snow layer rows 1..ns
        for k in range(ns):
            r = k + 1
            kh_up = kh[..., k]
            kh_dn = kh[..., k + 1]
            diag_s = 1.0 + etas * (kh_up + kh_dn)
            if k == 0 and calc_tsfc:
                sb_cold = -etas * kh_up
                rhs_cold = Tsn_init[..., 0] + etas * Sswabs[..., 0]
                rhs_warm = Tsn_init[..., 0] + etas * kh_up * Tsf + \
                    etas * Sswabs[..., 0]
                sb = torch.where(l_cold, sb_cold, 0.0)
                rhs = torch.where(l_cold, rhs_cold, rhs_warm)
            elif k == 0:
                # know_Tsfc: the prescribed conductive flux is the top
                # boundary condition; no coupling through kh[0]
                # (reference get_matrix_elements_know_Tsfc :1322-1330)
                sb = zeros
                diag_s = 1.0 + etas * kh_dn
                rhs = Tsn_init[..., 0] + etas * Sswabs[..., 0] + \
                    etas * fcondtopn_f
            else:
                sb = -etas * kh_up
                rhs = Tsn_init[..., k] + etas * Sswabs[..., k]
            SB[r] = torch.where(l_snow, sb, 0.0)
            D[r] = torch.where(l_snow, diag_s, 1.0)
            SP[r] = torch.where(l_snow, -etas * kh_dn, 0.0)
            R[r] = torch.where(l_snow, rhs, 0.0)

        # row ns doubles as the Tsf equation when there is no snow
        rowns_is_tsf = (~l_snow) & l_cold & calc_tsfc
        SB[ns] = torch.where(rowns_is_tsf, 0.0, SB[ns])
        D[ns] = torch.where(rowns_is_tsf, tsf_diag, D[ns])
        SP[ns] = torch.where(rowns_is_tsf, tsf_sp, SP[ns])
        R[ns] = torch.where(rowns_is_tsf, tsf_rhs, R[ns])

        # ice layer rows ns+1 .. ns+ni
        for k in range(ni):
            r = ns + 1 + k
            kh_up = kh[..., ns + k]
            kh_dn = kh[..., ns + k + 1]
            et = etai[..., k]
            diag_i = 1.0 + et * (kh_up + kh_dn)
            rhs = Tin_init[..., k] + et * Iswabs[..., k]
            sb = -et * kh_up
            sp = -et * kh_dn
            if k == 0 and calc_tsfc:
                # bare warm ice: Tsf is known (0), enters the rhs
                warm_bare = (~l_snow) & (~l_cold)
                sb = torch.where(warm_bare, 0.0, sb)
                rhs = torch.where(warm_bare, rhs + et * kh_up * Tsf, rhs)
            elif k == 0:
                # know_Tsfc bare ice: prescribed flux enters the top
                # ice layer directly (reference :1360-1374)
                bare = ~l_snow
                sb = torch.where(bare, 0.0, sb)
                diag_i = torch.where(bare, 1.0 + et * kh_dn, diag_i)
                rhs = torch.where(bare, rhs + et * fcondtopn_f, rhs)
            if k == ni - 1:
                sp = zeros
                rhs = rhs + et * kh_dn * Tbot
            SB[r], D[r], SP[r], R[r] = sb, diag_i, sp, rhs

        Tmat = _tridiag(torch.stack(SB, -1), torch.stack(D, -1),
                        torch.stack(SP, -1), torch.stack(R, -1))

        # -- convergence bookkeeping (reference :455-700) --
        conv = torch.ones_like(converged)
        avg_Tsf = zeros
        avg_Tsi = zeros
        if calc_tsfc:
            Tsf_new = torch.where(
                l_cold, torch.where(l_snow, Tmat[..., 0], Tmat[..., ns]),
                0.0)
            dTsf = Tsf_new - Tsf_start

            cond1 = Tsf_new > c.PUNY
            Tsf_new = torch.where(cond1, 0.0, Tsf_new)
            dTsf = torch.where(cond1, -Tsf_start, dTsf)
            avg_Tsi = torch.where(cond1, 1.0, avg_Tsi)
            conv = conv & ~cond1

            cond2 = ((niter > 1) & (Tsf_start <= -c.PUNY) &
                     (dTsf.abs() > c.PUNY) & (dTsf_prev.abs() > c.PUNY) &
                     (-dTsf / (dTsf_prev + c.PUNY * c.PUNY) > 0.5))
            avg_Tsf = torch.where(cond2, 1.0, avg_Tsf)
            avg_Tsi = torch.where(cond2, 1.0, avg_Tsi)
            dTsf = torch.where(cond2, 0.5 * dTsf, dTsf)
            conv = conv & ~cond2

            Tsf_new = Tsf_new + avg_Tsf * 0.5 * (Tsf_start - Tsf_new)
        else:
            # Tsf is the coupler's; it never moves
            Tsf_new = Tsf
            dTsf = zeros

        # snow temps / enthalpies
        zTsn_new = torch.where(l_snow[..., None], Tmat[..., 1:ns + 1], 0.0)
        zTsn_new = zTsn_new.clamp(max=0.0)
        zTsn_new = zTsn_new + avg_Tsi[..., None] * 0.5 * \
            (Tsn_start - zTsn_new)
        zqsn_new = snow_enthalpy_from_temperature(zTsn_new)
        enew = (hslyr[..., None] * zqsn_new).sum(-1)

        # ice temps, melting-point capping, enthalpies
        zTin_m = Tmat[..., ns + 1:]
        over = zTin_m > Tmlts - c.PUNY
        dTmat = torch.where(over, zTin_m - Tmlts, 0.0)
        dqmat = torch.where(
            over,
            c.RHOI * dTmat * (c.CP_ICE - c.LFRESH * Tmlts /
                              zTin_m.clamp(max=-c.PUNY) ** 2), 0.0)
        zTin_new = torch.where(over, Tmlts, zTin_m)
        if not calc_tsfc:
            # condition 2b (reference :618-631): oscillating zTin(1);
            # the dTsf_prev carry slot holds dTi1_prev in this mode
            dTi1 = zTin_new[..., 0] - Tin_start_i[..., 0]
            cond2b = ((niter > 1) & (dTi1.abs() > c.PUNY) &
                      (dTsf_prev.abs() > c.PUNY) &
                      (-dTi1 / (dTsf_prev + c.PUNY * c.PUNY) > 0.5))
            avg_Tsi = torch.where(cond2b, 1.0, avg_Tsi)
            dTi1 = torch.where(cond2b, 0.5 * dTi1, dTi1)
            conv = conv & ~cond2b
            dTsf = dTi1    # carried as dTsf_prev for the next iterate
        zTin_new = zTin_new + avg_Tsi[..., None] * 0.5 * \
            (Tin_start_i - zTin_new)
        zqin_new = ice_enthalpy_from_temperature(zTin_new, Tmlts)
        enew = enew + (hilyr[..., None] * zqin_new).sum(-1)
        einex = (hilyr[..., None] * dqmat).sum(-1)

        if calc_tsfc:
            cond3 = dTsf.abs() > TSF_ERRMAX
            conv = conv & ~cond3

            fsurfn = fsurfn + dTsf * dfsurf_dT
            fcondtopn = torch.where(
                l_snow, kh[..., 0] * (Tsf_new - zTsn_new[..., 0]),
                kh[..., ns] * (Tsf_new - zTin_new[..., 0]))
            cond4 = (Tsf_new >= 0.0) & (fsurfn < fcondtopn)
            conv = conv & ~cond4
        else:
            fcondtopn = fcondtopn_f

        fcondbot = kh[..., ns + ni] * (zTin_new[..., ni - 1] - Tbot) + \
            einex / dt
        ferr = ((enew - einit) / dt -
                (fcondtopn - fcondbot + fswint)).abs()
        # dtype-aware tolerance: enew/einit are ~1e8 J/m^2 column
        # enthalpies, so the f32 cancellation noise floor of
        # (enew-einit)/dt exceeds the reference's absolute FERRMAX
        # (1e-3 W/m^2) for thick cold columns and convergence becomes
        # unattainable; in f64 the dynamic term is ~1e-11 W/m^2 and
        # the reference tolerance is unchanged (bitwise no-op)
        ferr_tol = (4.0 * eps * torch.maximum(enew.abs(), einit.abs()) /
                    dt).clamp(min=0.9 * c.FERRMAX)
        cond5 = ferr > ferr_tol
        conv = conv & ~cond5

        # reduce conductivity where the matrix overshot the melting point
        denom = (fcondtopn - fcondbot).abs().clamp(min=c.PUNY)
        frac_kh = (0.5 * (1.0 - ferr / denom)).clamp(min=0.1)
        kh_cols = list(kh.unbind(-1))
        for k in range(ni):
            red = cond5 & over[..., k] & (dqmat[..., k] > 0.0)
            khb = torch.where(red, kh[..., ns + k + 1] * frac_kh,
                              kh[..., ns + k + 1])
            kh_cols[ns + k + 1] = khb
            kh_cols[ns + k] = torch.where(red, khb, kh_cols[ns + k])
        kh_new = torch.stack(kh_cols, -1)

        def sel(new, old):
            return freeze_converged(converged, new, old)

        return (sel(Tsf_new, Tsf), sel(zTsn_new, zTsn),
                sel(zTin_new, zTin), sel(zTsn_new, Tsn_start),
                sel(zTin_new, Tin_start_i), sel(kh_new, kh),
                sel(dTsf, dTsf_prev),
                sel(fsurfn, fsurfn_p), sel(fcondtopn, fcondtopn_p),
                sel(fcondbot, fcondbot_p),
                sel(zqsn_new, zqsn_p), sel(zqin_new, zqin_p),
                sel(flwoutn, flw_p), sel(fsensn, fsens_p),
                sel(flatn, flat_p),
                sel(~cond5, energy_ok_p),
                converged | conv)

    false = torch.zeros(Tsf.shape, dtype=torch.bool, device=Tsf.device)
    init = (Tsf, zTsn, zTin, Tsn_init, Tin_init, kh,
            zeros, zeros, zeros, zeros,
            torch.zeros_like(zqsn), torch.zeros_like(zqin),
            zeros, zeros, zeros, false, false)
    out, niter = run_until_converged(one_iteration, init, -1)
    (Tsf_f, zTsn_f, zTin_f, _, _, _, _, fsurf_f, fct_f, fcb_f,
     zqsn_f, zqin_f, flwout_f, fsens_f, flat_f, eok_f, conv_f) = out
    if dtype == torch.float32:
        # f32 acceptance at NITERMAX: the Tsf-oscillation conditions
        # (2, 3, 4) can chatter around TSF_ERRMAX=5e-4 K at the f32
        # tridiagonal noise floor; a column whose ENERGY closure
        # (condition 5) holds at the final iterate is physically
        # converged.  Exact no-op in f64 (the only precision the
        # reference runs).
        conv_f = conv_f | eok_f

    return ThermoSolveResult(
        Tsf=Tsf_f, zTsn=zTsn_f, zTin=zTin_f, zqsn=zqsn_f, zqin=zqin_f,
        fsensn=fsens_f, flatn=flat_f, flwoutn=flwout_f, fsurfn=fsurf_f,
        fcondtopn=fct_f, fcondbot=fcb_f,
        fswsfc=fswsfc, fswint=fswint, Sswabs=Sswabs, Iswabs=Iswabs,
        converged=conv_f, iterations=niter)
