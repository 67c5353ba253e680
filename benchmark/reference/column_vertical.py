"""The reference's vertical thermodynamics of one category's column:
the atmospheric boundary layer (Icepack `ice_atmo.F90`), the ocean's
bottom and lateral heat (`frzmlt_bottom_lateral`), the mushy-layer heat
solve with gravity drainage and pond flushing (Turner, Hunke and Bitz
2013; `ice_therm_mushy.F90`), snow-ice flooding, and the growth and melt
at the surfaces with the layers regridded (`ice_therm_vertical.F90`).

Each function runs over every column at once, [nc, ncat] (and a layer
axis), with masks where Icepack branches.

Departures from the published description, as in the program:
  * the Picard solve keeps the liquid fraction of the step's start and
    meets the two-stage surface (cold, then melting) in one loop: an
    iterate whose surface goes above 0 C restarts as a melting surface;
    a column converges when the largest change of temperature is under
    5e-4 C, the energy closure under max(0.9e-3 W m-2, four roundings of
    the column's energy a step) and the surface stayed in its stage; it
    runs at most 100 iterations, and a converged column keeps the
    iterate at which it converged;
  * the snow layer's conductivity is the fresh snow's, 0.30 W m-1 K-1;
  * the bottom growth takes the congelation ice's porosity 0.85 and the
    enthalpy of mush at the ocean's freezing temperature and salinity."""

from __future__ import annotations

import math

import torch

from .column import (CI, CONGELATION_PHI, CP_AIR, CP_ICE, CP_OCN, CW,
                     EMISSIVITY, GRAVIT, ICERUF, KSNO, LI,
                     LFRESH, LSUB, LVAP, PUNY, QQQICE, RHOI, RHOS, RHOW,
                     STEFAN_BOLTZMANN, TFFRESH, TTTICE, VISCOSITY_DYN,
                     VONKAR, ZREF, ZVIR, ASPECT_RATIO, CHANNEL_RADIUS,
                     RA_CRIT, SLOW_PHI_CRIT, SLOW_STRENGTH, USTAR_MIN,
                     brine_density, brine_salinity, enthalpy_fixed_phi,
                     enthalpy_mush, enthalpy_of_melting, liquid_fraction,
                     mush_conductivity, snow_enthalpy, snow_temperature,
                     temperature_mush)

NITERMAX = 100
DT_ERRMAX = 5.0e-4
FERRMAX = 1.0e-3
KAPPA_BRINE = 8.824e-8        # heat diffusivity of brine (m2 s-1)
S_MIN = 0.01
LAMBDA_POND = 1.0 / (10.0 * 24.0 * 3600.0)
HPOND0 = 0.01


def boundary_layer(tsfc, potT, wind, zlvl, Qa, rhoa, natmiter=5):
    """(shcoef, lhcoef): the sensible and latent transfer coefficients
    over ice, Monin-Obukhov iterated natmiter times with the CCSM3
    stability functions (Icepack atmo_boundary_layer)."""
    vmag = wind.clamp(min=1.0)
    rdn = VONKAR / math.log(ZREF / ICERUF)
    TsK = tsfc + TFFRESH
    ssq = QQQICE * torch.exp(-TTTICE / TsK) / rhoa
    thva = potT * (1.0 + ZVIR * Qa)
    delt = potT - TsK
    delq = Qa - ssq
    alz = torch.log(zlvl / ZREF)
    cp = CP_AIR * (1.0 + (1.81e3 / CP_AIR - 1.0) * ssq)
    rd = rh = re = rdn
    ustar, tstar, qstar = rdn * vmag, rdn * delt, rdn * delq
    for _ in range(natmiter):
        hol = VONKAR * GRAVIT * zlvl * (tstar / thva + qstar /
                                        (1.0 / ZVIR + Qa)) / \
            (ustar ** 2).clamp(min=PUNY)
        hol = torch.sign(hol) * hol.abs().clamp(max=10.0)
        stable = 0.5 + 0.5 * torch.sign(hol)
        x = torch.sqrt(torch.sqrt((1.0 - 16.0 * hol).abs()).clamp(min=1.0))
        psi_s = -(0.7 * hol + 0.75 * (hol - 14.3) * torch.exp(-0.35 * hol) +
                  10.7)
        psim_u = torch.log((1.0 + x * (2.0 + x)) * (1.0 + x * x) / 8.0) - \
            2.0 * torch.arctan(x) + 0.5 * math.pi
        psix_u = 2.0 * torch.log((1.0 + x * x) / 2.0)
        psim = psi_s * stable + (1.0 - stable) * psim_u
        psix = psi_s * stable + (1.0 - stable) * psix_u
        rd = rdn / (1.0 + rdn / VONKAR * (alz - psim))
        rh = rdn / (1.0 + rdn / VONKAR * (alz - psix))
        re = rdn / (1.0 + rdn / VONKAR * (alz - psix))
        ustar, tstar, qstar = rd * vmag, rh * delt, re * delq
    return rhoa * ustar * cp * rh + 1.0, rhoa * ustar * LSUB * re


def bottom_lateral(dt, aice, frzmlt, sst, Tf, etot):
    """(fbot, rside): the ocean's heat flux into the ice's base (W m-2,
    < 0 melts) and the share melted laterally, limited together to the
    ocean's melting potential (Icepack frzmlt_bottom_lateral; no ocean
    stress: u* at its minimum)."""
    melt = (aice > PUNY) & (frzmlt < 0.0)
    dT = (sst - Tf).clamp(min=0.0)
    fbot = torch.maximum(-CP_OCN * RHOW * 0.006 * dT * USTAR_MIN, frzmlt)
    fbot = torch.where(melt, fbot, 0.0)
    rside = (1.6e-6 * dT ** 1.36 * dt * math.pi / (0.66 * 300.0)).clamp(0, 1)
    rside = torch.where(melt, rside, 0.0)
    share = (frzmlt / (fbot + etot * rside / dt).clamp(max=-PUNY)).clamp(0, 1)
    return fbot * share, rside * share


def surface_fluxes(Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef):
    """(flwout, fsens, flat, fsurf, dfsurf/dTsf) at surface temperature
    Tsf (C)."""
    TsK = Tsf + TFFRESH
    qsat = QQQICE * torch.exp(-TTTICE / TsK)
    flwout = -EMISSIVITY * STEFAN_BOLTZMANN * TsK ** 4
    fsens = shcoef * (potT - TsK)
    flat = lhcoef * (Qa - qsat / rhoa)
    fsurf = fswsfc + EMISSIVITY * flw + flwout + fsens + flat
    dq = qsat * TTTICE / (TsK ** 2 * rhoa)
    dfsurf = -4.0 * EMISSIVITY * STEFAN_BOLTZMANN * TsK ** 3 - shcoef - \
        lhcoef * dq
    return flwout, fsens, flat, fsurf, dfsurf


def from_below(x, op):
    """op accumulated over the layers from the bottom up."""
    cols = list(x.unbind(-1))
    for k in range(len(cols) - 2, -1, -1):
        cols[k] = op(cols[k + 1], cols[k])
    return torch.stack(cols, -1)


def shift_up(x, bottom):
    """x[k + 1] at layer k, `bottom` under the last layer."""
    return torch.cat([x[..., 1:], bottom[..., None]], -1)


def permeability(phi):
    """Golden et al. (2007)."""
    return 3.0e-8 * (phi - 0.05).clamp(min=0.0) ** 3


def drainage(dt, S, T, Tsf, Tbot, sss, hilyr):
    """(q, dSdt): the rapid mode's upward Darcy flow under each layer
    (m s-1) and the slow mode's desalination (ppt s-1), from the mush's
    Rayleigh number (Icepack explicit_flow_velocities)."""
    ni = S.shape[-1]
    hin = hilyr * ni
    Sbr = brine_salinity(T)
    phi = liquid_fraction(T, S)
    rho = brine_density(Sbr)
    perm = permeability(phi)
    perm_min = from_below(perm, torch.minimum)
    perm_harm = from_below(1.0 / perm.clamp(min=1.0e-30),
                           lambda a, b: a + b)
    rho_sum = from_below(rho, lambda a, b: a + b)
    rho_pipe = 0.5 * (rho + torch.cat([rho[..., :1], rho[..., :-1]], -1))
    z = torch.tensor([(k + 0.5) / ni for k in range(ni)], dtype=S.dtype,
                     device=S.device) * hin[..., None]
    Ra = (rho - brine_density(sss)[..., None]).clamp(min=0.0) * \
        (hin[..., None] - z) * perm_min * GRAVIT / (VISCOSITY_DYN *
                                                    KAPPA_BRINE)
    rn = torch.tensor([float(ni - k) for k in range(ni)], dtype=S.dtype,
                      device=S.device)
    L = rn * hilyr[..., None]
    dx2 = (L * 2.0 * ASPECT_RATIO) ** 2
    Am = dx2 * rn / (VISCOSITY_DYN * perm_harm)
    Bm = -GRAVIT * rho_sum / rn
    Ap = math.pi * CHANNEL_RADIUS ** 4 / (8.0 * VISCOSITY_DYN)
    Bp = -rho_pipe * GRAVIT
    q = ((Am / dx2) * ((-Ap * Bp - Am * Bm) / (Am + Ap) + Bm)).clamp(
        min=1.0e-30)
    q = torch.minimum(q * (Ra - RA_CRIT).clamp(min=0.0) / (Ra + PUNY),
                      (0.2 * hilyr / dt)[..., None])
    dSdt = SLOW_STRENGTH * (S - SLOW_PHI_CRIT * Sbr).clamp(min=0.0) * \
        (Tbot - Tsf).clamp(min=0.0)[..., None] / (hin[..., None] + 0.001)
    dSdt = torch.maximum(dSdt, -S * 0.5 / dt)
    # never below 0.1 ppt in ten steps
    guess = ((q * (shift_up(Sbr, sss) - Sbr)) / hilyr[..., None] + dSdt) * \
        dt * 10.0
    small = guess.abs() < PUNY
    alpha = torch.where(small, 1.0,
                        (0.1 - S) / torch.where(small, 1.0, guess))
    alpha = torch.where((alpha < 0.0) | (alpha > 1.0), 1.0, alpha)
    return q * alpha, dSdt * alpha


def flushing(dt, T, phi, hin, hsn, hilyr, hpond, apond):
    """The ponds' downward Darcy flow through the ice (m s-1; Icepack
    flushing_velocity)."""
    ni = phi.shape[-1]
    perm_harm = ni / (1.0 / permeability(phi).clamp(min=1.0e-30)).sum(-1)
    mass = (phi * brine_density(brine_salinity(T)) +
            (1.0 - phi) * RHOI).sum(-1) * hilyr
    hocn = (mass + hpond * apond * RHOW + hsn * RHOS) / RHOW
    head = (hin + hpond - hocn).clamp(min=0.0)
    w = perm_harm * RHOW * GRAVIT * (head / hin.clamp(min=PUNY)) / \
        VISCOSITY_DYN
    w = torch.minimum(w, hpond * apond / dt)
    wlim = 0.005 * phi.min(-1).values * hilyr / dt
    w = torch.where(w.abs() > PUNY,
                    w * (wlim / w.abs().clamp(min=PUNY)).clamp(0.0, 1.0), 0.0)
    return w.clamp(min=0.0)


def tridiagonal(sb, d, sp, r):
    """Thomas' algorithm over the last axis."""
    n = d.shape[-1]
    beta = d[..., 0]
    x = [r[..., 0] / beta]
    gam = []
    for k in range(1, n):
        gam.append(sp[..., k - 1] / beta)
        beta = d[..., k] - sb[..., k] * gam[-1]
        x.append((r[..., k] - sb[..., k] * x[k - 1]) / beta)
    for k in range(n - 2, -1, -1):
        x[k] = x[k] - gam[k] * x[k + 1]
    return torch.stack(x, -1)


def heat_solve(dt, air, sw, shcoef, lhcoef, hilyr, hslyr, zqin, zSin, zqsn,
               Tsf, Tbot, sss, hpond, apond, nitermax=NITERMAX, trace=None):
    """The mushy heat solve of every column: a Picard iteration of the
    implicit conduction with the brine's advection, the liquid fraction
    held, then the salinity's explicit step.  air: potT, Qa, rhoa, flw
    per column; sw: fswsfc, fswint, Sswabs, Iswabs.  trace: a list that
    takes each iteration's convergence terms (dT, ferr, tol, to_melt,
    Tsf).  Returns a dict."""
    ns, ni = zqsn.shape[-1], zqin.shape[-1]
    snow = hslyr > 1.0e-4 / ns
    hil = hilyr.clamp(min=PUNY)
    zTin = temperature_mush(zqin, zSin)
    phi = liquid_fraction(zTin, zSin)
    zTsn = torch.where(snow[..., None],
                       snow_temperature(zqsn).clamp(max=0.0), 0.0)
    zqsn0 = torch.where(snow[..., None], zqsn, snow_enthalpy(0.0) +
                        torch.zeros_like(zqsn))
    km = mush_conductivity(zqin, zSin)
    zero = torch.zeros_like(hil)

    def hmean(a, b):
        return 2.0 * a * b / (a + b)

    # grid distances and interface conductivities: snow over ice, or ice
    # alone (padded)
    dx_s = [hslyr / 2.0] + [hslyr] * (ns - 1) + [(hil + hslyr) / 2.0] + \
        [hil] * (ni - 1) + [hil / 2.0]
    fe = hil / (hil + hslyr).clamp(min=PUNY)
    kc_s = [zero + KSNO] + [zero + KSNO] * (ns - 1) + \
        [1.0 / ((1.0 - fe) / KSNO + fe / km[..., 0].clamp(min=PUNY))] + \
        [hmean(km[..., k], km[..., k - 1]) for k in range(1, ni)] + \
        [km[..., ni - 1]]
    dx_b = [hil / 2.0] + [hil] * (ni - 1) + [hil / 2.0] + [zero] * ns
    kc_b = [km[..., 0]] + [hmean(km[..., k], km[..., k - 1])
                           for k in range(1, ni)] + [km[..., ni - 1]] + \
        [zero] * ns
    dxp = torch.stack([torch.where(snow, a, b) for a, b in zip(dx_s, dx_b)],
                      -1)
    kc = torch.stack([torch.where(snow, a, b) for a, b in zip(kc_s, kc_b)],
                     -1)
    einit = (hil[..., None] * zqin).sum(-1) + \
        torch.where(snow, (hslyr[..., None] * zqsn0).sum(-1), 0.0)

    qocn = CW * Tbot
    q, dSdt = drainage(dt, zSin, zTin, Tsf, Tbot, sss, hil)
    if hpond is not None:
        w = flushing(dt, zTin, phi, hil * ni,
                     torch.where(snow, hslyr * ns, 0.0), hil, hpond, apond)
    else:
        w = zero
    eps = torch.finfo(Tsf.dtype).eps

    def advected(zT):
        qbr = CW * zT
        return -(q * (shift_up(qbr, qocn) - qbr)).sum(-1) + w * qbr[..., -1]

    potT, Qa, rhoa, flw = air
    k_top = kc[..., 0] / dxp[..., 0]
    n = ns + ni + 1
    state = {"Tsf": Tsf, "zTsn": zTsn, "zTin": zTin,
             "fsurf": zero, "fct": zero, "fcb": zero, "flwout": zero,
             "fsens": zero, "flat": zero}
    done = torch.zeros_like(snow)
    it = 0
    while it < nitermax:
        it += 1
        Ts = state["Tsf"]
        flwout, fsens, flat, fsurf, dfs = surface_fluxes(
            Ts, sw["fswsfc"], rhoa, flw, potT, Qa, shcoef, lhcoef)
        cold = Ts < 0.0
        sb, d, sp, r = ([zero] * n, [zero + 1.0] * n, [zero] * n,
                        [zero] * n)
        # the surface row: row 0 over snow, row ns over bare ice
        t_diag, t_sp, t_r = dfs - k_top, k_top, dfs * Ts - fsurf
        on = snow & cold
        d[0], sp[0], r[0] = (torch.where(on, t_diag, 1.0),
                             torch.where(on, t_sp, 0.0),
                             torch.where(on, t_r, 0.0))
        for k in range(ns):
            up = kc[..., k] / dxp[..., k]
            dn = kc[..., k + 1] / dxp[..., k + 1]
            sbk = torch.where(cold, -up, 0.0) if k == 0 else -up
            sb[k + 1] = torch.where(snow, sbk, 0.0)
            d[k + 1] = torch.where(snow, RHOS * CP_ICE / dt * hslyr + up + dn,
                                   1.0)
            sp[k + 1] = torch.where(snow, -dn, 0.0)
            r[k + 1] = torch.where(snow, (zqsn0[..., k] + RHOS * LFRESH) /
                                   dt * hslyr + sw["Sswabs"][..., k], 0.0)
        on = ~snow & cold
        d[ns] = torch.where(on, t_diag, d[ns])
        sp[ns] = torch.where(on, t_sp, sp[ns])
        r[ns] = torch.where(on, t_r, r[ns])
        sb[ns] = torch.where(on, 0.0, sb[ns])
        for k in range(ni):
            i_s, i_b = k + ns, k
            up = torch.where(snow, kc[..., i_s] / dxp[..., i_s],
                             kc[..., i_b] / dxp[..., i_b].clamp(min=PUNY))
            dn = torch.where(snow, kc[..., i_s + 1] / dxp[..., i_s + 1],
                             kc[..., i_b + 1] /
                             dxp[..., i_b + 1].clamp(min=PUNY))
            row = ns + 1 + k
            heat = (phi[..., k] * (CW - CI) + CI) / dt * hil
            d[row] = heat + up + dn + (q[..., k] + w) * CW
            r[row] = ((1.0 - phi[..., k]) * LI + zqin[..., k]) / dt * hil + \
                sw["Iswabs"][..., k]
            sb[row] = -up
            sp[row] = -dn - q[..., k] * CW
            if k == 0:
                sb[row] = torch.where(~snow & ~cold, 0.0, sb[row])
            else:
                sb[row] = sb[row] - w * CW
            if k == ni - 1:
                sp[row] = zero
                r[row] = r[row] + dn * Tbot + q[..., k] * qocn
        T = tridiagonal(*(torch.stack(x, -1) for x in (sb, d, sp, r)))
        Tsf_n = torch.where(cold, torch.where(snow, T[..., 0], T[..., ns]),
                            0.0)
        to_melt = Tsf_n > 0.0
        Tsf_n = Tsf_n.clamp(max=0.0)
        zTsn_n = torch.where(snow[..., None], T[..., 1:ns + 1].clamp(max=0.0),
                             0.0)
        zTin_n = T[..., ns + 1:]
        dT = torch.maximum((Tsf_n - Ts).abs(), torch.maximum(
            (zTsn_n - state["zTsn"]).abs().max(-1).values,
            (zTin_n - state["zTin"]).abs().max(-1).values))
        efinal = (hil[..., None] * enthalpy_fixed_phi(zTin_n, phi)).sum(-1) + \
            torch.where(snow, (hslyr[..., None] *
                               snow_enthalpy(zTsn_n)).sum(-1), 0.0)
        fct = torch.where(snow, k_top * (Tsf_n - zTsn_n[..., 0]),
                          kc[..., 0] / dxp[..., 0].clamp(min=PUNY) *
                          (Tsf_n - zTin_n[..., 0]))
        fcb = 2.0 * km[..., ni - 1] * (zTin_n[..., ni - 1] - Tbot) / hil
        ferr = ((efinal - einit) / dt -
                (fct - fcb + sw["fswint"] - advected(zTin_n))).abs()
        tol = (4.0 * eps * torch.maximum(efinal.abs(), einit.abs()) /
               dt).clamp(min=0.9 * FERRMAX)
        ok = (dT < DT_ERRMAX) & (ferr < tol) & ~to_melt
        if trace is not None:
            trace.append({"dT": dT, "ferr": ferr, "tol": tol,
                          "to_melt": to_melt, "Tsf": Tsf_n})
        new = {"Tsf": Tsf_n, "zTsn": zTsn_n, "zTin": zTin_n,
               "fsurf": fsurf + (Tsf_n - Ts) * dfs, "fct": fct, "fcb": fcb,
               "flwout": flwout, "fsens": fsens, "flat": flat}
        for key, v in new.items():
            keep = done if v.ndim == done.ndim else done[..., None]
            state[key] = torch.where(keep, state[key], v)
        done = done | ok
        if it % 2 == 0 and bool(done.all()):
            break
    zTin = state["zTin"]
    Sbr = brine_salinity(zTin)
    dS = (q * (shift_up(Sbr, sss) - Sbr)) / hil[..., None] + dSdt + \
        (w[..., None] * (torch.cat([torch.zeros_like(Sbr[..., :1]),
                                    Sbr[..., :-1]], -1) - Sbr)) / \
        hil[..., None]
    state.update(
        zqin=enthalpy_fixed_phi(zTin, phi), zqsn=snow_enthalpy(state["zTsn"]),
        zSin=zSin + torch.maximum(S_MIN - zSin, dS * dt),
        fadv=advected(zTin), w=w, converged=done, iterations=it)
    return state


def regrid(dz, h_layer, h_total, x):
    """Layer means x over layers of thickness dz [..., n] carried onto n
    equal layers of h_layer (the last ending at h_total), conserving
    x dz."""
    n = x.shape[-1]
    z1 = torch.cumsum(torch.cat([torch.zeros_like(dz[..., :1]), dz], -1), -1)
    z2 = torch.stack([h_layer * k for k in range(n)] + [h_total], -1)
    hx = []
    for k2 in range(n):
        acc = 0.0
        for k1 in range(n):
            ov = (torch.minimum(z1[..., k1 + 1], z2[..., k2 + 1]) -
                  torch.maximum(z1[..., k1], z2[..., k2])).clamp(min=0.0)
            acc = acc + ov * x[..., k1]
        hx.append(acc)
    hx = torch.stack(hx, -1)
    return torch.where(h_layer[..., None] > PUNY,
                       hx / h_layer[..., None].clamp(min=PUNY), x)


def overlap_regrid(x, h1, h2, shift):
    """Equal layers of h1, moved down by `shift`, onto equal layers of h2:
    the overlap-weighted sums."""
    n = x.shape[-1]
    k = torch.arange(n, dtype=x.dtype, device=x.device)
    a2, b2 = k * h2[..., None], (k + 1.0) * h2[..., None]
    a1 = k * h1[..., None] + shift[..., None]
    b1 = (k + 1.0) * h1[..., None] + shift[..., None]
    ov = (torch.minimum(b1[..., None, :], b2[..., :, None]) -
          torch.maximum(a1[..., None, :], a2[..., :, None])).clamp(min=0.0)
    return (ov * x[..., None, :]).sum(-1)


def flood(dt, hsn, hin, hslyr, hilyr, zqsn, zqin, zSin, phi, Sbr, sss,
          qocn):
    """Snow-ice: where the snow pushes the ice's surface under the sea,
    the flooded snow becomes mush of liquid fraction 1 - rhos / rhoi
    filled with sea water, and the layers are regridded (Icepack
    flood_ice).  Returns (zqsn, zqin, zSin, hilyr, hslyr, snoice,
    eadded)."""
    ns, ni = zqsn.shape[-1], zqin.shape[-1]
    rho_ocn = brine_density(sss)
    dens = torch.minimum(phi * brine_density(Sbr) + (1.0 - phi) * RHOI,
                         rho_ocn[..., None])
    excess = (dens.sum(-1) * hilyr + RHOS * hsn - hin * rho_ocn).clamp(
        min=0.0)
    flooded = (hsn > PUNY) & (excess > 0.0)
    phi_si = 1.0 - RHOS / RHOI
    rho_si = phi_si * rho_ocn + (1.0 - phi_si) * RHOI
    dh = excess / (rho_ocn - rho_si + RHOS).clamp(min=PUNY)
    dh = torch.where(flooded, torch.minimum(dh.clamp(min=0.0), hsn), 0.0)
    # the enthalpy of the bottom dh of the snow
    rn = dh / hsn.clamp(min=PUNY) * ns
    nl = torch.floor(rn).clamp(max=float(ns - 1))
    k = torch.arange(ns, dtype=zqsn.dtype, device=zqsn.device)
    rs = rn.clamp(min=PUNY)
    q_si = torch.where(k >= ns - nl[..., None], zqsn, 0.0).sum(-1) / rs + \
        ((rn - nl) / rs) * torch.where(k == ns - 1.0 - nl[..., None], zqsn,
                                       0.0).sum(-1)
    q_si = torch.where((hsn > PUNY) & (dh > 0.0), q_si, 0.0)
    hin2, hsn2 = hin + dh, hsn - dh
    hil2, hsl2 = hin2 / ni, hsn2 / ns

    added = hin2 - hin

    def ice(x, top):
        out = overlap_regrid(x, hilyr, hil2, added)
        kk = torch.arange(ni, dtype=x.dtype, device=x.device)
        a2, b2 = kk * hil2[..., None], (kk + 1.0) * hil2[..., None]
        ov = (torch.minimum(added[..., None], b2) - a2.clamp(min=0.0)).clamp(
            min=0.0)
        return (out + ov * top[..., None]) / hil2.clamp(min=PUNY)[..., None]

    f = flooded[..., None]
    zqsn2 = overlap_regrid(zqsn, hslyr, hsl2, torch.zeros_like(hslyr)) / \
        hsl2.clamp(min=PUNY)[..., None]
    zqin2 = ice(zqin, phi_si * qocn + q_si)
    zSin2 = ice(zSin, phi_si * sss)
    return (torch.where(f, zqsn2, zqsn), torch.where(f, zqin2, zqin),
            torch.where(f, zSin2, zSin), torch.where(flooded, hil2, hilyr),
            torch.where(flooded, hsl2, hslyr), dh,
            torch.where(flooded, dh * phi_si / dt * qocn, 0.0))


def growth_and_melt(dt, hin, hsn, zqin, zqsn, zSin, fbot, Tbot, sss, flat,
                    fsurf, fcondtop, fcondbot, fsnow):
    """Condensation, bottom growth, snow and ice sublimation and melt at
    the top and bottom, snowfall, and the regrid to equal layers
    (Icepack thickness_changes, mushy branches).  Returns a dict."""
    ni, ns = zqin.shape[-1], zqsn.shape[-1]
    hslyr0 = hsn / ns
    dzi = [hin / ni] * ni
    dzs = [hsn / ns] * ns
    qi = list(zqin.unbind(-1))
    qs = list(zqsn.unbind(-1))
    Si = list(zSin.unbind(-1))
    qmlt = [enthalpy_of_melting(s) for s in Si]
    qm = [q - m for q, m in zip(qi, qmlt)]
    zero = torch.zeros_like(hin)
    meltt = melts = meltb = emlt_atm = emlt_ocn = zero
    esub = (-flat * dt).clamp(min=0.0)
    econ = (-flat * dt).clamp(max=0.0)
    etop = ((fsurf - fcondtop) * dt).clamp(min=0.0)
    ebot = ((fcondbot - fbot) * dt).clamp(min=0.0)
    egro = ((fcondbot - fbot) * dt).clamp(max=0.0)

    snowy = hsn > PUNY
    dhs = torch.where(snowy, econ / (qs[0] - RHOS * LVAP), 0.0)
    dhi = torch.where(snowy, 0.0, econ / (qm[0] - RHOI * LVAP))
    emlt_atm = emlt_atm - torch.where(snowy, 0.0, qmlt[0] * dhi)
    dzs[0] = dzs[0] + dhs
    dzi[0] = dzi[0] + dhi
    evap = dhs * RHOS + dhi * RHOI

    # congelation: mush of the ocean's freezing point and salinity, of
    # porosity CONGELATION_PHI
    q_new = enthalpy_mush(Tbot, sss)
    q_latent = -LFRESH * RHOI * (1.0 - CONGELATION_PHI)
    dhi = egro / q_latent
    hq = dzi[-1] * qi[-1] + dhi * q_new
    hs = dzi[-1] * Si[-1] + dhi * sss
    emlt_ocn = emlt_ocn - (q_new - q_latent) * dhi
    grew = (dzi[-1] + dhi) > PUNY
    dzi[-1] = dzi[-1] + dhi
    qi[-1] = torch.where(grew, hq / dzi[-1].clamp(min=PUNY), qi[-1])
    Si[-1] = torch.where(grew, hs / dzi[-1].clamp(min=PUNY), Si[-1])
    qmlt[-1] = enthalpy_of_melting(Si[-1])
    qm[-1] = qi[-1] - qmlt[-1]
    congel = dhi

    fresh_snow = -RHOS * LFRESH
    for k in range(ns):           # snow above its melting point melts
        warm = qs[k] > fresh_snow
        dhs = torch.where(warm, torch.maximum(
            -dzs[k], -((qs[k] - fresh_snow) / (RHOS * LFRESH)) * dzs[k]),
            0.0)
        dzs[k] = dzs[k] + dhs
        qs[k] = torch.where(warm, fresh_snow, qs[k])
        melts = melts - dhs
    for k in range(ns):
        qsub = qs[k] - RHOS * LVAP
        dhs = torch.maximum(-dzs[k], esub / qsub)
        dzs[k] = dzs[k] + dhs
        esub = (esub - dhs * qsub).clamp(min=0.0)
        evap = evap + dhs * RHOS
        dhs = torch.maximum(-dzs[k], etop / qs[k].clamp(max=-PUNY))
        dzs[k] = dzs[k] + dhs
        etop = (etop - dhs * qs[k]).clamp(min=0.0)
        melts = melts - dhs
    for k in range(ni):
        qsub = qm[k] - RHOI * LVAP
        dhi = torch.maximum(-dzi[k], esub / qsub)
        dzi[k] = dzi[k] + dhi
        esub = (esub - dhi * qsub).clamp(min=0.0)
        evap = evap + dhi * RHOI
        emlt_ocn = emlt_ocn - qmlt[k] * dhi
        frozen = qm[k] < 0.0
        dhi = torch.where(frozen, torch.maximum(
            -dzi[k], etop / qm[k].clamp(max=-PUNY)), -dzi[k])
        emlt_ocn = emlt_ocn - torch.maximum(qi[k], qmlt[k]) * dhi
        dzi[k] = dzi[k] + dhi
        etop = (etop - dhi * torch.where(frozen, qm[k], 0.0)).clamp(min=0.0)
        meltt = meltt - dhi
    for k in range(ni - 1, -1, -1):
        frozen = qm[k] < 0.0
        dhi = torch.where(frozen, torch.maximum(
            -dzi[k], ebot / qm[k].clamp(max=-PUNY)), -dzi[k])
        emlt_ocn = emlt_ocn - torch.maximum(qi[k], qmlt[k]) * dhi
        dzi[k] = dzi[k] + dhi
        ebot = (ebot - dhi * torch.where(frozen, qm[k], 0.0)).clamp(min=0.0)
        meltb = meltb - dhi
    for k in range(ns - 1, -1, -1):
        dhs = torch.maximum(-dzs[k], ebot / qs[k].clamp(max=-PUNY))
        dzs[k] = dzs[k] + dhs
        ebot = (ebot - dhs * qs[k]).clamp(min=0.0)
        melts = melts - dhs
    fhocn = fbot + (esub + etop + ebot) / dt

    hsn_new = fsnow / RHOS * dt
    tot = dzs[0] + hsn_new
    qs[0] = torch.where(tot > 0.0, ((dzs[0] * qs[0] + hsn_new * fresh_snow) /
                                    tot.clamp(min=PUNY)).clamp(max=fresh_snow),
                        qs[0])
    dzs[0] = torch.where(tot > 0.0, tot, dzs[0])
    hin = sum(dzi).clamp(min=0.0)
    hsn_sum = sum(dzs)
    dsnow = hsn_sum - ns * hslyr0
    hsn = hsn_sum.clamp(min=0.0)
    hilyr, hslyr = hin / ni, hsn / ns
    dzi_a = torch.stack([d.clamp(min=0.0) for d in dzi], -1)
    zqin = regrid(dzi_a, hilyr, hin, torch.stack(qi, -1))
    zSin = regrid(dzi_a, hilyr, hin, torch.stack(Si, -1))
    zqsn = torch.stack(qs, -1)
    if ns > 1:
        zqsn = regrid(torch.stack([d.clamp(min=0.0) for d in dzs], -1),
                      hslyr, hsn, zqsn)
    thin = hsn <= PUNY
    fhocn = fhocn + torch.where(thin, zqsn.sum(-1) * hsn / (ns * dt), 0.0)
    zqsn = torch.where(thin[..., None], fresh_snow, zqsn)
    hsn = torch.where(thin, 0.0, hsn)
    return {"hin": hin, "hsn": hsn, "zqin": zqin, "zqsn": zqsn,
            "zSin": zSin, "fhocn": fhocn + emlt_ocn / dt, "evap": evap / dt,
            "meltt": meltt, "melts": melts, "meltb": meltb,
            "congel": congel, "dsnow": dsnow, "hsn_new": hsn_new}


def vertical(dt, aicen, vicen, vsnon, tsfc, zqin, zqsn, zSin, air, fsnow,
             fbot, Tbot, sss, sw, shcoef, lhcoef, apond, hpond,
             nitermax=NITERMAX, trace=None) -> dict:
    """The vertical thermodynamics of every category (Icepack
    thermo_vertical, mushy): the heat solve, the ponds' flushing,
    flooding, then growth and melt.  Returns the new thickness, snow
    depth, profiles, surface temperature, pond depth and the melt and
    flux terms the ponds need."""
    ni, ns = zqin.shape[-1], zqsn.shape[-1]
    has = aicen > PUNY
    a1 = torch.where(has, aicen, 1.0)
    hin = torch.where(has, vicen / a1, 0.1)
    hsn = torch.where(has, vsnon / a1, 0.0)
    hilyr, hslyr = hin.clamp(min=PUNY) / ni, hsn / ns
    res = heat_solve(dt, air, sw, shcoef, lhcoef, hilyr, hslyr, zqin, zSin,
                     zqsn, tsfc, Tbot, sss, hpond, apond, nitermax, trace)
    on = (apond > 0.0) & (hpond > 0.0)
    h = (hpond - res["w"] * dt / apond.clamp(min=PUNY)).clamp(min=0.0)
    h = (h - LAMBDA_POND * dt * (h + HPOND0)).clamp(min=0.0)
    hpond_new = torch.where(on, h, hpond)
    zqin2, zSin2 = res["zqin"], res["zSin"]
    phi = liquid_fraction(temperature_mush(zqin2, zSin2), zSin2)
    zqsn2, zqin2, zSin2, hilyr, hslyr, snoice, eadded = flood(
        dt, hsn, hin.clamp(min=PUNY), hslyr, hilyr, res["zqsn"], zqin2,
        zSin2, phi, brine_salinity(res["zTin"]), sss, CW * Tbot)
    th = growth_and_melt(dt, hilyr * ni, hslyr * ns, zqin2, zqsn2, zSin2,
                         fbot, Tbot, sss, res["flat"], res["fsurf"],
                         res["fct"], res["fcb"], fsnow)
    lay = has[..., None]
    return {"Tsf": torch.where(has, res["Tsf"], tsfc),
            "hin": torch.where(has, th["hin"], 0.0),
            "hsn": torch.where(has, th["hsn"], 0.0),
            "zqin": torch.where(lay, th["zqin"], zqin),
            "zqsn": torch.where(lay, th["zqsn"], zqsn),
            "zSin": torch.where(lay, th["zSin"], zSin),
            "hpond": torch.where(has, hpond_new, hpond),
            "fsurf": torch.where(has, res["fsurf"], 0.0),
            "meltt": torch.where(has, th["meltt"], 0.0),
            "melts": torch.where(has, th["melts"], 0.0),
            "dsnow": torch.where(has, th["dsnow"], 0.0),
            "unconverged": ~res["converged"] & has,
            "iterations": res["iterations"]}
