"""Mushy-layer vertical heat solver (ktherm=2): batched Picard iteration.

Port of the JAX package's `column/mushy_solver.py`, which re-designs the
reference mushy temperature solve (`ice_therm_mushy.F90`: picard_solver
:1128-1406 with solve_heat_conduction :2110 and the matrix_elements_*
family :2345-2851): the liquid fraction phi is frozen at its
step-initial value for the WHOLE solve (as in the reference, where phi
is intent(in) throughout picard_solver); each Picard iteration re-solves
a tridiagonal system for the new temperatures (effective heat capacity
phi*(cw-ci)+ci, latent heat in the right-hand side) with re-linearized
surface fluxes — batched over all columns with per-column convergence
masking, like the BL99 solver, and with the same host loop
(`bl99.run_until_converged`).

Gravity drainage and flushing (reference explicit_flow_velocities
:3005-3176, flushing_velocity :3182-3298, solve_salinity :2855-2931):
the rapid-mode convective Darcy flow q and slow-mode desalination rate
dSdt are computed once per step from the Rayleigh number of the mush
(suffix min/sum scans replace the reference's bottom-up accumulation
loop), the flushing velocity w from the pond hydraulic head through
the harmonic-mean Golden-2007 permeability; q and w enter the Picard
heat matrix as advective brine-heat terms, and bulk salinity evolves
explicitly after convergence.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as c
from .bl99 import _tridiag, freeze_converged, run_until_converged
from .mushy import (conductivity_mush, density_brine, enthalpy_brine,
                    enthalpy_mush_liquid_fraction, liquid_fraction,
                    liquidus_brine_salinity, temperature_mush)
from .thermo_shared import (dsurface_heat_flux_dTsf,
                            snow_enthalpy_from_temperature,
                            snow_temperature_from_enthalpy,
                            surface_heat_flux)

NITERMAX = 100
DT_ERRMAX = 5.0e-4
_CW = c.CP_OCN * c.RHOW
_CI = c.CP_ICE * c.RHOI
_LI = c.LFRESH * c.RHOI

KAPPA_L = 8.824e-8         # heat diffusivity of liquid (m^2/s)
S_MIN = 0.01               # minimum bulk salinity (ppt)


def permeability_mush(phi):
    """Golden et al. 2007 hierarchical-model permeability (reference
    `permeability`, ice_therm_mushy.F90:2985-3001)."""
    return 3.0e-8 * (phi - 0.05).clamp(min=0.0) ** 3


def _from_below(x, op):
    """out[k] = op over x[k:] along the layer axis, accumulated from the
    bottom layer up (the reference's bottom-up loop; unrolled over the
    few layers, which a GPU scan kernel handles poorly)."""
    cols = list(x.unbind(-1))
    for k in range(len(cols) - 2, -1, -1):
        cols[k] = op(cols[k + 1], cols[k])
    return torch.stack(cols, -1)


def _reverse_cumsum(x):
    return _from_below(x, lambda below, here: below + here)


def _reverse_cummin(x):
    return _from_below(x, torch.minimum)


def _below(x, bottom):
    """x shifted up one layer, the value under the last layer `bottom`
    [*B]: result[k] = x[k+1]."""
    return torch.cat([x[..., 1:], bottom[..., None] *
                      torch.ones_like(x[..., :1])], -1)


def explicit_flow_velocities(dt, zSin, zTin, Tsf, Tbot, sss, qocn,
                             hilyr, hin, tun=None):
    """Rapid-mode Darcy flow q and slow-mode desalination rate dSdt
    (reference explicit_flow_velocities :3005-3176). The reference's
    bottom-up running accumulations (min permeability, harmonic-mean
    permeability, brine density sum from each layer to the ocean)
    become flipped cumulative scans over the layer axis.

    zSin/zTin [*B, ni]; the rest [*B]. Returns (q, dSdt, Sbr, qbr,
    phi) all [*B, ni]; q[k] is the upward interface flow under layer
    k."""
    if tun is None:
        from .tuning import DEFAULT as tun
    ni = zSin.shape[-1]
    Sbr = liquidus_brine_salinity(zTin)
    phi = liquid_fraction(zTin, zSin)
    qbr = enthalpy_brine(zTin)
    rho = density_brine(Sbr)
    rho_ocn = density_brine(sss)[..., None]
    ra_const = c.GRAVIT / (c.VISCOSITY_DYN * KAPPA_L)
    qlimit = (0.2 * hilyr / dt)[..., None]

    perm = permeability_mush(phi)

    perm_min = _reverse_cummin(perm)
    perm_harm = _reverse_cumsum(1.0 / perm.clamp(min=1.0e-30))
    rho_sum = _reverse_cumsum(rho)
    rho_pipe = 0.5 * (rho + torch.cat(
        [rho[..., :1], rho[..., :-1]], -1))          # rho(0)=rho(1)

    frac = torch.as_tensor((np.arange(ni) + 0.5) / ni).to(zSin)
    z = frac * hin[..., None]
    drho = (rho - rho_ocn).clamp(min=0.0)
    Ra = drho * (hin[..., None] - z) * perm_min * ra_const

    rn = torch.as_tensor(ni - np.arange(ni)).to(zSin)  # layers k..bottom
    L = rn * hilyr[..., None]
    dx2 = (L * 2.0 * tun.rapid_mode_aspect_ratio) ** 2
    Am = dx2 * rn / (c.VISCOSITY_DYN * perm_harm)
    Bm = -c.GRAVIT * rho_sum / rn
    Ap = np.pi * tun.rapid_mode_channel_radius ** 4 / \
        (8.0 * c.VISCOSITY_DYN)
    Bp = -rho_pipe * c.GRAVIT
    q = ((Am / dx2) * ((-Ap * Bp - Am * Bm) / (Am + Ap) + Bm)).clamp(
        min=1.0e-30)
    q = torch.minimum(q * (Ra - tun.rapid_mode_critical_ra).clamp(min=0.0)
                      / (Ra + c.PUNY), qlimit)

    dSdt = tun.slow_mode_drainage_strength * \
        (zSin - tun.slow_mode_critical_porosity * Sbr).clamp(min=0.0) * \
        (Tbot - Tsf).clamp(min=0.0)[..., None] / (hin[..., None] + 0.001)
    dSdt = torch.maximum(dSdt, -zSin * 0.5 / dt)

    # safety limiter: never drive salinity below zSin_min = 0.1
    Sbr_dn = _below(Sbr, sss)
    dS_guess = ((q * (Sbr_dn - Sbr)) / hilyr[..., None] + dSdt) * \
        dt * 10.0
    small = dS_guess.abs() < c.PUNY
    alpha = torch.where(small, 1.0,
                        (0.1 - zSin) / torch.where(small, 1.0, dS_guess))
    alpha = torch.where((alpha < 0.0) | (alpha > 1.0), 1.0, alpha)
    return q * alpha, dSdt * alpha, Sbr, qbr, phi


def flushing_velocity(dt, zTin, phi, hin, hsn, hilyr, hpond, apond):
    """Downward flushing Darcy velocity from the pond hydraulic head
    (reference flushing_velocity :3182-3298). All [*B]; phi/zTin
    [*B, ni]. Returns w >= 0 [*B]."""
    ni = phi.shape[-1]
    perm = permeability_mush(phi)
    phi_min = phi.min(-1).values
    ice_mass = ((phi * density_brine(liquidus_brine_salinity(zTin)) +
                 (1.0 - phi) * c.RHOI).sum(-1)) * hilyr
    perm_harm = ni / (1.0 / perm.clamp(min=1.0e-30)).sum(-1)
    hocn = (ice_mass + hpond * apond * c.RHOW + hsn * c.RHOS) / c.RHOW
    dhhead = (hin + hpond - hocn).clamp(min=0.0)
    w = perm_harm * c.RHOW * c.GRAVIT * \
        (dhhead / hin.clamp(min=c.PUNY)) / c.VISCOSITY_DYN
    w = torch.minimum(w, hpond * apond / dt)
    wlimit = (0.005 * phi_min * hilyr) / dt
    w = torch.where(w.abs() > c.PUNY,
                    w * (wlimit / w.abs().clamp(min=c.PUNY)).clamp(0.0,
                                                                   1.0),
                    0.0)
    return w.clamp(min=0.0)


def solve_salinity(dt, zSin, Sbr, Spond, sss, q, dSdt, w, hilyr):
    """Explicit bulk-salinity update from drainage + flushing
    (reference solve_salinity :2855-2931): upward Darcy flow advects
    brine salinity from below, flushing advects from above (pond
    water into the top layer), floored at S_min."""
    Sbr_dn = _below(Sbr, sss)
    Sbr_up = torch.cat([Spond[..., None] * torch.ones_like(Sbr[..., :1]),
                        Sbr[..., :-1]], -1)
    h = hilyr[..., None]
    dS = (q * (Sbr_dn - Sbr)) / h + dSdt + \
        (w[..., None] * (Sbr_up - Sbr)) / h
    return zSin + torch.maximum(S_MIN - zSin, dS * dt)


def drainage_heat_fluxes(q, w, qbr, qocn, qpond):
    """Advective heat to the ocean (reference picard_drainage_fluxes
    :1710-1746 + picard_flushing_fluxes :1750-1771)."""
    qbr_dn = _below(qbr, qocn)
    fadv = -(q * (qbr_dn - qbr)).sum(-1)
    return fadv + w * (qbr[..., -1] - qpond)


class MushySolveResult(NamedTuple):
    Tsf: torch.Tensor
    zTsn: torch.Tensor
    zTin: torch.Tensor
    zqsn: torch.Tensor
    zqin: torch.Tensor
    phi: torch.Tensor
    fsensn: torch.Tensor
    flatn: torch.Tensor
    flwoutn: torch.Tensor
    fsurfn: torch.Tensor
    fcondtopn: torch.Tensor
    fcondbot: torch.Tensor
    converged: torch.Tensor
    zSin: torch.Tensor        # bulk salinity after drainage (ppt)
    fadvheat: torch.Tensor    # advective heat to ocean (W/m^2)
    w: torch.Tensor           # flushing Darcy velocity (m/s)
    iterations: int = 0       # Picard iterations the loop ran


def _intercell(hilyr, hslyr, km, ks, l_snow, ns, ni):
    """Grid-point distances dxp and interface conductivities kcstar
    (reference calc_intercell_thickness/_conductivity). All [*B, ...]."""
    zero = torch.zeros_like(hilyr)
    # snow-present layout
    dxp_s = [hslyr / 2.0] + [hslyr] * (ns - 1) + \
        [(hilyr + hslyr) / 2.0] + [hilyr] * (ni - 1) + [hilyr / 2.0]
    kc_s = [ks[..., 0]]
    for k in range(1, ns):
        kc_s.append(2.0 * ks[..., k] * ks[..., k - 1] /
                    (ks[..., k] + ks[..., k - 1]))
    fe = hilyr / (hilyr + hslyr).clamp(min=c.PUNY)
    kc_s.append(1.0 / ((1.0 - fe) / ks[..., ns - 1].clamp(min=c.PUNY)
                       + fe / km[..., 0].clamp(min=c.PUNY)))
    for k in range(1, ni):
        kc_s.append(2.0 * km[..., k] * km[..., k - 1] /
                    (km[..., k] + km[..., k - 1]))
    kc_s.append(km[..., ni - 1])
    # no-snow layout: shift ice to the front, zero-pad the tail
    dxp_n = [hilyr / 2.0] + [hilyr] * (ni - 1) + [hilyr / 2.0] + \
        [zero] * ns
    kc_n = [km[..., 0]]
    for k in range(1, ni):
        kc_n.append(2.0 * km[..., k] * km[..., k - 1] /
                    (km[..., k] + km[..., k - 1]))
    kc_n.append(km[..., ni - 1])
    kc_n += [zero] * ns

    rows = [torch.where(l_snow, dxp_s[i], dxp_n[i])
            for i in range(ns + ni + 1)]
    krow = [torch.where(l_snow, kc_s[i], kc_n[i])
            for i in range(ns + ni + 1)]
    return torch.stack(rows, -1), torch.stack(krow, -1)


def temperature_changes_mushy(dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
                              fswsfc, fswint, Sswabs, Iswabs,
                              hilyr, hslyr, zqin, zSin, zqsn,
                              Tsf, Tbot, sss=None, hpond=None,
                              apond=None,
                              tun=None) -> MushySolveResult:
    """Solve the mushy heat equation in all columns at once.

    Shapes as in bl99.temperature_changes. With sss given, gravity
    drainage (rapid q + slow dSdt) and — with hpond/apond — pond
    flushing w are active: q and w advect brine heat through the
    Picard matrix and bulk salinity evolves explicitly after
    convergence (reference temperature_changes_salinity :35-341).
    With sss=None the q = w = 0 fixed-salinity configuration runs."""
    ns = zqsn.shape[-1]
    ni = zqin.shape[-1]

    l_snow = hslyr > c.HS_MIN / ns
    zTin = temperature_mush(zqin, zSin)
    phi = liquid_fraction(zTin, zSin)
    zTsn = torch.where(l_snow[..., None],
                       snow_temperature_from_enthalpy(zqsn).clamp(max=0.0),
                       0.0)
    zqsn0 = torch.where(l_snow[..., None], zqsn,
                        snow_enthalpy_from_temperature(0.0) *
                        torch.ones_like(zqsn))
    km = conductivity_mush(zqin, zSin)
    ks = torch.full_like(zqsn, c.KSNO)
    dxp, kc = _intercell(hilyr.clamp(min=c.PUNY), hslyr, km, ks,
                         l_snow, ns, ni)

    zqin0 = zqin
    hil = hilyr.clamp(min=c.PUNY)
    hsl = hslyr
    einit = (hil[..., None] * zqin).sum(-1) + \
        torch.where(l_snow, (hsl[..., None] * zqsn0).sum(-1), 0.0)
    zeros = torch.zeros_like(Tsf)
    ones = torch.ones_like(Tsf)

    # drainage velocities, held fixed through the Picard iteration
    # (reference temperature_changes_salinity :210-224)
    hin = hil * ni
    qocn = enthalpy_brine(Tbot)
    qpond = torch.zeros_like(Tsf)      # enthalpy_brine(0 C)
    Spond = torch.zeros_like(Tsf)
    if sss is not None:
        q, dSdt, _, _, _ = explicit_flow_velocities(
            dt, zSin, zTin, Tsf, Tbot, sss, qocn, hil, hin, tun=tun)
        if hpond is not None:
            hsn = torch.where(l_snow, hsl * ns, 0.0)
            w = flushing_velocity(dt, zTin, phi, hin, hsn, hil,
                                  hpond, apond)
        else:
            w = zeros
    else:
        q = torch.zeros_like(zqin)
        dSdt = torch.zeros_like(zqin)
        w = zeros
    eps = torch.finfo(Tsf.dtype).eps

    def one_iteration(carry, niter):
        # *_pp are the k-2 iterates (for the oscillation detector); the
        # unsuffixed values are the k-1 iterates
        (Tsf, zTsn, zTin, phi, Tsf_pp, zTsn_pp, zTin_pp,
         fsurf_p, fct_p, fcb_p, flw_p, fsn_p, flt_p,
         converged) = carry

        flwoutn, fsensn, flatn, fsurfn = surface_heat_flux(
            Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef)
        _, _, _, dfsurf_dT = dsurface_heat_flux_dTsf(
            Tsf, rhoa, shcoef, lhcoef)
        l_cold = Tsf < 0.0

        # assemble the fixed-size tridiagonal (reference
        # matrix_elements_*): row 0 = Tsf (snow), rows 1..ns snow,
        # row ns doubles as Tsf for bare ice, rows ns+1..ns+ni ice.
        nmat = ns + ni + 1
        SB = [zeros] * nmat
        D = [ones] * nmat
        SP = [zeros] * nmat
        R = [zeros] * nmat

        k0 = kc[..., 0] / dxp[..., 0]
        tsf_diag = dfsurf_dT - k0
        tsf_sp = k0
        tsf_rhs = dfsurf_dT * Tsf - fsurfn

        row0_is_tsf = l_snow & l_cold
        D[0] = torch.where(row0_is_tsf, tsf_diag, 1.0)
        SP[0] = torch.where(row0_is_tsf, tsf_sp, 0.0)
        R[0] = torch.where(row0_is_tsf, tsf_rhs, 0.0)

        # snow rows (heat capacity rhos*cp_ice; reference
        # matrix_elements_snow_*)
        rcs = c.RHOS * c.CP_ICE
        for k in range(ns):
            r = k + 1
            kup = kc[..., k] / dxp[..., k]
            kdn = kc[..., k + 1] / dxp[..., k + 1]
            diag = (rcs / dt) * hsl + kup + kdn
            # rhos*ci*T_old = q_s0 + rhos*Lfresh (snow enthalpy relation)
            rhs = ((zqsn0[..., k] + c.RHOS * c.LFRESH) / dt) * hsl + \
                Sswabs[..., k]
            sb = -kup
            if k == 0:
                # melting surface: Tsf = 0 contributes nothing to rhs
                sb = torch.where(l_cold, -kup, 0.0)
            SB[r] = torch.where(l_snow, sb, 0.0)
            D[r] = torch.where(l_snow, diag, 1.0)
            SP[r] = torch.where(l_snow, -kdn, 0.0)
            R[r] = torch.where(l_snow, rhs, 0.0)

        rowns_is_tsf = (~l_snow) & l_cold
        D[ns] = torch.where(rowns_is_tsf, tsf_diag, D[ns])
        SP[ns] = torch.where(rowns_is_tsf, tsf_sp, SP[ns])
        R[ns] = torch.where(rowns_is_tsf, tsf_rhs, R[ns])
        SB[ns] = torch.where(rowns_is_tsf, 0.0, SB[ns])

        # ice rows: interface index in the snow layout is k+ns; in the
        # bare layout it is k. Select per column.
        for k in range(ni):
            r = ns + 1 + k
            i_s = k + ns          # snow-present interface index
            i_n = k               # bare-ice interface index
            kup = torch.where(l_snow, kc[..., i_s] / dxp[..., i_s],
                              kc[..., i_n] /
                              dxp[..., i_n].clamp(min=c.PUNY))
            kdn = torch.where(l_snow,
                              kc[..., i_s + 1] / dxp[..., i_s + 1],
                              kc[..., i_n + 1] /
                              dxp[..., i_n + 1].clamp(min=c.PUNY))
            ceff = (phi[..., k] * (_CW - _CI) + _CI) / dt * hil
            # advective brine-heat coupling (reference
            # matrix_elements_* :2520-2560: upward Darcy q from below,
            # downward flushing w from above, brine heat capacity cw)
            diag = ceff + kup + kdn + (q[..., k] + w) * _CW
            rhs = (((1.0 - phi[..., k]) * _LI + zqin0[..., k]) / dt) * \
                hil + Iswabs[..., k]
            sb = -kup
            sp = -kdn - q[..., k] * _CW
            if k == 0:
                # bare melting surface: Tsf = 0 enters the rhs;
                # flushing brings pond water into the top ice layer
                warm_bare = (~l_snow) & (~l_cold)
                sb = torch.where(warm_bare, 0.0, sb)
                rhs = rhs + w * qpond
            else:
                sb = sb - w * _CW
            if k == ni - 1:
                sp = zeros
                rhs = rhs + kdn * Tbot + q[..., k] * qocn
            SB[r], D[r], SP[r], R[r] = sb, diag, sp, rhs

        Tmat = _tridiag(torch.stack(SB, -1), torch.stack(D, -1),
                        torch.stack(SP, -1), torch.stack(R, -1))

        Tsf_new = torch.where(
            l_cold, torch.where(l_snow, Tmat[..., 0], Tmat[..., ns]), 0.0)
        # two-stage switch (reference two_stage_solver_*): a cold solve
        # ending above melt restarts as a melting surface
        went_melt = Tsf_new > 0.0
        Tsf_new = Tsf_new.clamp(max=0.0)
        zTsn_new = torch.where(l_snow[..., None],
                               Tmat[..., 1:ns + 1].clamp(max=0.0), 0.0)
        zTin_new = Tmat[..., ns + 1:]

        # phi stays FROZEN at its step-initial value through the whole
        # Picard iteration, exactly like the reference (phi is
        # intent(in) everywhere inside picard_solver :1128-1406 and
        # picard_final :1923 rebuilds the enthalpy with it)
        phi_new = phi

        # convergence: temperature change + energy closure (reference
        # check_picard_convergence)
        dT = torch.maximum(
            (Tsf_new - Tsf).abs(),
            torch.maximum((zTsn_new - zTsn).abs().max(-1).values,
                          (zTin_new - zTin).abs().max(-1).values))
        zqin_new = enthalpy_mush_liquid_fraction(zTin_new, phi)
        zqsn_new = snow_enthalpy_from_temperature(zTsn_new)
        efinal = (hil[..., None] * zqin_new).sum(-1) + \
            torch.where(l_snow, (hsl[..., None] * zqsn_new).sum(-1), 0.0)
        fcondtop = torch.where(
            l_snow, k0 * (Tsf_new - zTsn_new[..., 0]),
            kc[..., 0] / dxp[..., 0].clamp(min=c.PUNY) *
            (Tsf_new - zTin_new[..., 0]))
        fcondbot = 2.0 * km[..., ni - 1] * (zTin_new[..., ni - 1] -
                                            Tbot) / hil
        fadv = drainage_heat_fluxes(q, w, enthalpy_brine(zTin_new),
                                    qocn, qpond)
        ferr = ((efinal - einit) / dt -
                (fcondtop - fcondbot + fswint - fadv)).abs()
        # dtype-aware energy tolerance (see bl99.py: in f32 the
        # cancellation noise of (efinal-einit)/dt can exceed the
        # absolute FERRMAX; exact no-op in f64)
        ferr_tol = (4.0 * eps * torch.maximum(efinal.abs(), einit.abs()) /
                    dt).clamp(min=0.9 * c.FERRMAX)
        conv = (dT < DT_ERRMAX) & (ferr < ferr_tol) & ~went_melt

        fsurfn_out = fsurfn + (Tsf_new - Tsf) * dfsurf_dT

        def sel(new, old):
            return freeze_converged(converged, new, old)

        return (sel(Tsf_new, Tsf), sel(zTsn_new, zTsn),
                sel(zTin_new, zTin), sel(phi_new, phi),
                sel(Tsf, Tsf_pp), sel(zTsn, zTsn_pp),
                sel(zTin, zTin_pp),
                sel(fsurfn_out, fsurf_p), sel(fcondtop, fct_p),
                sel(fcondbot, fcb_p),
                sel(flwoutn, flw_p), sel(fsensn, fsn_p),
                sel(flatn, flt_p),
                converged | conv)

    false = torch.zeros(Tsf.shape, dtype=torch.bool, device=Tsf.device)
    init = (Tsf, zTsn, zTin, phi, Tsf, zTsn, zTin,
            zeros, zeros, zeros, zeros, zeros, zeros, false)
    out, niter = run_until_converged(one_iteration, init, -1)
    (Tsf_f, zTsn_f, zTin_f, phi_f, _, _, _, fsurf_f, fct_f, fcb_f,
     flwout_f, fsens_f, flat_f, conv_f) = out

    zqin_f = enthalpy_mush_liquid_fraction(zTin_f, phi_f)
    zqsn_f = snow_enthalpy_from_temperature(zTsn_f)
    # explicit salinity evolution after the heat solve (reference
    # picard_solver :1361 -> solve_salinity); the enthalpy keeps the
    # pre-drainage salinity, exactly as the reference's zqin does
    fadv_f = drainage_heat_fluxes(q, w, enthalpy_brine(zTin_f),
                                  qocn, qpond)
    if sss is not None:
        zSin_f = solve_salinity(dt, zSin,
                                liquidus_brine_salinity(zTin_f),
                                Spond, sss, q, dSdt, w, hil)
    else:
        zSin_f = zSin
    return MushySolveResult(
        Tsf=Tsf_f, zTsn=zTsn_f, zTin=zTin_f, zqsn=zqsn_f, zqin=zqin_f,
        phi=phi_f, fsensn=fsens_f, flatn=flat_f, flwoutn=flwout_f,
        fsurfn=fsurf_f, fcondtopn=fct_f, fcondbot=fcb_f,
        converged=conv_f, zSin=zSin_f, fadvheat=fadv_f, w=w,
        iterations=niter)


# -- snow-ice formation (flooding) ------------------------------------------

class FloodResult(NamedTuple):
    zqsn: torch.Tensor      # regridded snow enthalpy [*B, ns]
    zqin: torch.Tensor      # regridded ice enthalpy [*B, ni]
    zSin: torch.Tensor      # regridded bulk salinity [*B, ni]
    phi: torch.Tensor       # regridded liquid fraction [*B, ni]
    hilyr: torch.Tensor     # new ice layer thickness [*B]
    hslyr: torch.Tensor     # new snow layer thickness [*B]
    snoice: torch.Tensor    # snow-ice formed (m) [*B]
    eadded: torch.Tensor    # ocean energy used (W/m^2) [*B]
    wadded: torch.Tensor    # ocean water mass used (kg/m^2/s) [*B]
    sadded: torch.Tensor    # ocean salt used (kg/m^2/s) [*B]


def _overlap_regrid(trc, hlyr1, hlyr2, shift):
    """Conservative overlap regrid of equal-thickness layers: new cell
    k2 = [k2 h2, (k2+1) h2), old cell k1 = [k1 h1 + shift, ...). The
    reference's double loop (update_vertical_tracers_* :3562-3703)
    becomes one dense [new, old] overlap matrix contraction."""
    nl = trc.shape[-1]
    k = torch.arange(nl, dtype=trc.dtype, device=trc.device)
    z2a = k * hlyr2[..., None]
    z2b = (k + 1.0) * hlyr2[..., None]
    z1a = k * hlyr1[..., None] + shift[..., None]
    z1b = (k + 1.0) * hlyr1[..., None] + shift[..., None]
    ov = (torch.minimum(z1b[..., None, :], z2b[..., :, None]) -
          torch.maximum(z1a[..., None, :], z2a[..., :, None])).clamp(
              min=0.0)
    return (ov * trc[..., None, :]).sum(-1)


def update_vertical_tracers_snow(trc, hlyr1, hlyr2):
    """Regrid snow layers after snow-ice loss (reference :3562-3624)."""
    return _overlap_regrid(trc, hlyr1, hlyr2, torch.zeros_like(hlyr1)) / \
        hlyr2.clamp(min=c.PUNY)[..., None]


def update_vertical_tracers_ice(trc, hlyr1, hlyr2, h1, h2, trc0):
    """Regrid ice layers with a new snow-ice band [0, h2-h1) of value
    trc0 on top (reference :3628-3703)."""
    nl = trc.shape[-1]
    out = _overlap_regrid(trc, hlyr1, hlyr2, (h2 - h1))
    k = torch.arange(nl, dtype=trc.dtype, device=trc.device)
    z2a = k * hlyr2[..., None]
    z2b = (k + 1.0) * hlyr2[..., None]
    ov0 = (torch.minimum((h2 - h1)[..., None], z2b) -
           z2a.clamp(min=0.0)).clamp(min=0.0)
    out = out + ov0 * trc0[..., None]
    return out / hlyr2.clamp(min=c.PUNY)[..., None]


def enthalpy_snow_snowice(dh, hsn, zqsn):
    """Mean enthalpy of the snow converted to snow ice — the bottom
    dh of the snow pack (reference enthalpy_snow_snowice :3516-3558:
    full bottom layers plus the partially-converted one)."""
    ns = zqsn.shape[-1]
    safe_h = hsn.clamp(min=c.PUNY)
    rnlyr = (dh / safe_h) * ns
    nlyr = torch.floor(rnlyr).clamp(max=float(ns - 1))
    k = torch.arange(ns, dtype=zqsn.dtype, device=zqsn.device)
    full = k >= (ns - nlyr[..., None])          # bottom nlyr layers
    safe_rn = rnlyr.clamp(min=c.PUNY)
    q = torch.where(full, zqsn, 0.0).sum(-1) / safe_rn
    part = (k == (ns - 1.0 - nlyr[..., None]))
    q = q + ((rnlyr - nlyr) / safe_rn) * \
        torch.where(part, zqsn, 0.0).sum(-1)
    return torch.where((hsn > c.PUNY) & (dh > 0.0), q, 0.0)


def flood_ice(dt, hsn, hin, hslyr, hilyr, zqsn, zqin, zSin, phi,
              Sbr, sss, qocn) -> FloodResult:
    """Snow-ice formation when the snow load pushes the surface below
    sea level (reference flood_ice, ice_therm_mushy.F90:3342-3512):
    the flooded snow becomes mush with liquid fraction 1 - rhos/rhoi
    filled with ocean brine, layers regrid conservatively, and the
    ocean water/energy/salt used are returned for the coupler budget
    (fadvheat -= eadded in the reference)."""
    puny = c.PUNY
    rho_ocn = density_brine(sss)
    ice_density = torch.minimum(
        phi * density_brine(Sbr) + (1.0 - phi) * c.RHOI,
        rho_ocn[..., None])
    ice_mass = ice_density.sum(-1) * hilyr
    snow_mass = c.RHOS * hsn
    freeboard_density = (ice_mass + snow_mass - hin * rho_ocn).clamp(
        min=0.0)
    flooded = (hsn > puny) & (freeboard_density > 0.0)

    phi_si = 1.0 - c.RHOS / c.RHOI
    rho_si = phi_si * rho_ocn + (1.0 - phi_si) * c.RHOI
    dh = freeboard_density / (rho_ocn - rho_si + c.RHOS).clamp(min=puny)
    dh = torch.where(flooded, torch.minimum(dh.clamp(min=0.0), hsn), 0.0)

    qsn_si = enthalpy_snow_snowice(dh, hsn, zqsn)
    ni = zqin.shape[-1]
    ns = zqsn.shape[-1]
    hin2 = hin + dh
    hsn2 = hsn - dh
    hilyr2 = hin2 / ni
    hslyr2 = hsn2 / ns

    zSin_si = phi_si * sss
    zqin_si = phi_si * qocn + qsn_si

    zqsn2 = update_vertical_tracers_snow(zqsn, hslyr, hslyr2)
    zqin2 = update_vertical_tracers_ice(zqin, hilyr, hilyr2, hin,
                                        hin2, zqin_si)
    zSin2 = update_vertical_tracers_ice(zSin, hilyr, hilyr2, hin,
                                        hin2, zSin_si *
                                        torch.ones_like(sss))
    phi2 = update_vertical_tracers_ice(phi, hilyr, hilyr2, hin, hin2,
                                       phi_si * torch.ones_like(sss))

    fl = flooded[..., None]
    hadded = dh * phi_si / dt
    wadded = hadded * c.RHOI
    return FloodResult(
        zqsn=torch.where(fl, zqsn2, zqsn),
        zqin=torch.where(fl, zqin2, zqin),
        zSin=torch.where(fl, zSin2, zSin),
        phi=torch.where(fl, phi2, phi),
        hilyr=torch.where(flooded, hilyr2, hilyr),
        hslyr=torch.where(flooded, hslyr2, hslyr),
        snoice=dh,
        eadded=torch.where(flooded, hadded * qocn, 0.0),
        wadded=torch.where(flooded, wadded, 0.0),
        sadded=torch.where(flooded,
                           wadded * c.ICE_REF_SALINITY * 1.0e-3, 0.0))
