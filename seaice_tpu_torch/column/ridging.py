"""Mechanical redistribution (ridging).

Port of the JAX package's `column/ridging.py`, which re-designs
`ice_mechred.F90` (`ridge_ice` :80-597, `ridge_prep` :640, `ridge_itd`
:741, `ridge_shift` :1030): the per-cell ridging iteration becomes a
fixed-count masked loop over all cells, with the category loops
unrolled (static ncat).

Scheme constants (reference ice_mechred.F90:52-61): Cs=0.25,
fsnowrdg=0.5, Gstar=0.15, astar=0.05, maxraft=1, Hstar=25.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from . import constants as c
from .itd import add_cat, conserved_tracers, recover_tracers

CS = 0.25          # shear energy fraction contributing to ridging
FSNOWRDG = 0.5     # snow fraction surviving ridging
GSTAR = 0.15
ASTAR = 0.05
MAXRAFT = 1.0
HSTAR = 25.0
NITER_RIDGE = 3    # fixed iteration count (reference iterates <=20,
                   # converging in 1-2 typical)

# Tracers destroyed by ridging: the donor loses them but the new ridge
# receives none (reference ridge_shift, ice_mechred.F90:1488-1498 --
# "Tracers associated with level ice ... are not transferred. We assume
# that all pond water is lost from ridging ice.")
NO_TRANSFER_TRACERS = frozenset({
    "levelIceArea", "levelIceVolume",
    "pondArea", "pondDepth", "pondLidThickness"})


def ridge_shift_coeffs(aicen, vicen, aice0, hin_max,
                       krdg_partic: int = 1, krdg_redist: int = 1,
                       mu_rdg: float = 4.0):
    """Participation and redistribution coefficients (reference
    ridge_itd, ice_mechred.F90:741-1012).

    Returns (apartic [*B, ncat+1] with slot 0 = open water,
    hrmin, hrexp [*B, ncat], krdg [*B, ncat], aksum [*B])."""
    ncat = aicen.shape[-1]
    puny = c.PUNY
    # cumulative area distribution G (open water first)
    gs = [torch.zeros_like(aice0), torch.where(aice0 > puny, aice0, 0.0)]
    for n in range(ncat):
        gs.append(gs[-1] + torch.where(aicen[..., n] > puny,
                                       aicen[..., n], 0.0))
    total = gs[-1].clamp(min=puny)
    gs = [g / total for g in gs]

    apartic = []
    if krdg_partic == 0:      # Thorndike et al. 1975
        gstari = 1.0 / GSTAR
        for n in range(ncat + 1):
            g0, g1 = gs[n], gs[n + 1]
            a_full = gstari * (g1 - g0) * (2.0 - gstari * (g0 + g1))
            a_part = gstari * (GSTAR - g0) * (2.0 - gstari *
                                              (GSTAR + g0))
            a = torch.where(g1 < GSTAR, a_full,
                            torch.where(g0 < GSTAR, a_part, 0.0))
            apartic.append(a.clamp(min=0.0))
    else:                     # exponential (Lipscomb et al. 2007)
        astari = 1.0 / ASTAR
        norm = float(1.0 / (1.0 - np.exp(-astari)))
        e = [torch.exp(-g * astari) * norm for g in gs]
        for n in range(ncat + 1):
            apartic.append((e[n] - e[n + 1]).clamp(min=0.0))
    apartic = torch.stack(apartic, -1)     # [*B, ncat+1]

    has = aicen > puny
    hi = torch.where(has, vicen / torch.where(has, aicen, 1.0), puny)
    hi = hi.clamp(min=puny)
    hrmin = torch.where(has, torch.minimum(2.0 * hi, hi + MAXRAFT), 0.0)
    if krdg_redist == 0:
        hrmax = torch.where(has, torch.maximum(
            2.0 * torch.sqrt(HSTAR * hi), hrmin + puny), 0.0)
        hrexp = hrmax          # reuse slot: hrmax for Hibler 1980
        krdg = torch.where(has, 0.5 * (hrmin + hrmax) / hi, 1.0)
    else:
        hrexp = torch.where(has, mu_rdg * torch.sqrt(hi), 0.0)
        krdg = torch.where(has, (hrmin + hrexp) / hi, 1.0)

    aksum = apartic[..., 0] + (
        apartic[..., 1:] * (1.0 - 1.0 / krdg)).sum(-1)
    return apartic, hrmin, hrexp, krdg, aksum


def ridge_bounds(hin_max, dtype, device):
    """The receiver categories' (lower, upper) thickness bounds of
    `ridge_ice`, the top one 1e8 (reference ridge_prep), as tensors."""
    hmax = [float(h) for h in hin_max]
    hmax[-1] = 1.0e8
    return (torch.tensor(hmax[:-1], dtype=dtype, device=device),
            torch.tensor(hmax[1:], dtype=dtype, device=device))


class RidgeResult(NamedTuple):
    aicen: torch.Tensor
    vicen: torch.Tensor
    vsnon: torch.Tensor
    aice0: torch.Tensor
    area_tracers: Dict[str, torch.Tensor]
    ice_tracers: Dict[str, torch.Tensor]
    snow_tracers: Dict[str, torch.Tensor]
    dardg1dt: torch.Tensor     # area ridged / s
    dardg2dt: torch.Tensor     # new ridge area / s
    dvirdgdt: torch.Tensor     # volume ridged / s
    opening: torch.Tensor      # opening rate / s
    msnow_mlt: torch.Tensor    # snow mass to ocean (kg/m^2)
    esnow_mlt: torch.Tensor    # snow energy to ocean (J/m^2)


def ridge_ice(dt, hin_max, rdg_conv, rdg_shear,
              aicen, vicen, vsnon,
              area_tracers: Dict[str, torch.Tensor],
              ice_tracers: Dict[str, torch.Tensor],
              snow_tracers: Dict[str, torch.Tensor],
              krdg_partic: int = 1, krdg_redist: int = 1,
              mu_rdg: float = 4.0, bounds=None) -> RidgeResult:
    """Ridging driver (reference ridge_ice, ice_mechred.F90:80-597).

    bounds: optional (lower, upper) receiver-category bounds as tensors
    of the state's dtype on its device, from `ridge_bounds` (made here
    when None: a host-to-device copy, which a caller stepping many times
    makes once)."""
    ncat = aicen.shape[-1]
    puny = c.PUNY
    aice0 = (1.0 - aicen.sum(-1)).clamp(min=0.0)

    groups = (area_tracers, ice_tracers, snow_tracers)
    stores = [conserved_tracers(trc, base)
              for trc, base in zip(groups, (aicen, vicen, vsnon))]
    lo, hi = ridge_bounds(hin_max, aicen.dtype, aicen.device) \
        if bounds is None else bounds

    def cat_n(x, n):
        """category n of a tracer: [*B] or [*B, nLayers]."""
        return x[..., n, :] if x.ndim == aicen.ndim + 1 else x[..., n]

    def per_cat(amount, t):
        """amount [*B, ncat] times a category's tracer t ([*B] or
        [*B, nLayers]) for every receiver category."""
        if t.ndim == amount.ndim - 1:
            return amount * t[..., None]
        return amount[..., None] * t[..., None, :]

    # net closing rate (ridge_prep :640-722)
    asum = aice0 + aicen.sum(-1)
    closing_net = CS * rdg_shear + rdg_conv
    divu_adv = (1.0 - asum) / dt
    closing_net = torch.where(divu_adv < 0.0,
                              torch.maximum(closing_net, -divu_adv),
                              closing_net)
    opning = closing_net + divu_adv

    ardg1 = torch.zeros_like(aice0)
    ardg2 = torch.zeros_like(aice0)
    virdg = torch.zeros_like(aice0)
    aopen = torch.zeros_like(aice0)
    msnow_mlt = torch.zeros_like(aice0)
    esnow_mlt = torch.zeros_like(aice0)

    for _ in range(NITER_RIDGE):
        apartic, hrmin, hrexp, krdg, aksum = ridge_shift_coeffs(
            aicen, vicen, aice0, hin_max, krdg_partic, krdg_redist, mu_rdg)

        closing_gross = closing_net / aksum.clamp(min=puny)
        # don't remove more than exists (ridge_shift :1160-1190)
        wk = apartic[..., 0] * closing_gross * dt
        tmpfac = torch.where(wk > aice0, aice0 / wk.clamp(min=puny), 1.0)
        closing_gross = closing_gross * tmpfac
        opning_l = opning * tmpfac
        for n in range(ncat):
            wk = apartic[..., n + 1] * closing_gross * dt
            a_n = aicen[..., n]
            need = (a_n > puny) & (apartic[..., n + 1] > 0.0) & (wk > a_n)
            tmpfac = torch.where(need, a_n / wk.clamp(min=puny), 1.0)
            closing_gross = closing_gross * tmpfac
            opning_l = opning_l * tmpfac

        aice0 = (aice0 - apartic[..., 0] * closing_gross * dt +
                 opning_l * dt).clamp(min=0.0)
        aopen = aopen + opning_l * dt

        # per-donor-category shift; the state at the iteration's start
        # (aicen, vicen, vsnon, the tracer means) sets the amounts, the
        # working copies (a, v, vs, the stores) take them
        a, v, vs = aicen, vicen, vsnon
        for n in range(ncat):
            act = ((aicen[..., n] > puny) &
                   (apartic[..., n + 1] > 0.0) & (closing_gross > 0.0))
            ardg1n = torch.where(
                act, torch.minimum(aicen[..., n],
                                   apartic[..., n + 1] * closing_gross *
                                   dt), 0.0)
            ardg2n = ardg1n / krdg[..., n].clamp(min=puny)
            afrac = ardg1n / aicen[..., n].clamp(min=puny)
            virdgn = vicen[..., n] * afrac
            vsrdgn = vsnon[..., n] * afrac
            a = add_cat(a, n, -ardg1n)
            v = add_cat(v, n, -virdgn)
            vs = add_cat(vs, n, -vsrdgn)
            ardg1 = ardg1 + ardg1n
            ardg2 = ardg2 + ardg2n
            virdg = virdg + virdgn
            msnow_mlt = msnow_mlt + c.RHOS * vsrdgn * (1.0 - FSNOWRDG)
            if "snowEnthalpy" in snow_tracers:
                qs = snow_tracers["snowEnthalpy"]
                esnow_mlt = esnow_mlt + (
                    vsrdgn * qs[..., n, :].mean(-1) * (1.0 - FSNOWRDG))

            # remove tracer quantities from the donor category
            for store, trc, amount in zip(stores, groups,
                                          (ardg1n, virdgn, vsrdgn)):
                for k2 in store:
                    t = cat_n(trc[k2], n)
                    amt = amount if t.ndim == amount.ndim else \
                        amount[..., None]
                    store[k2] = add_cat(store[k2], n, -amt * t,
                                        t.ndim > amount.ndim)

            # distribute the new ridge over the receiver categories, all
            # of them at once on the category axis
            if krdg_redist == 0:
                hr0, hr1 = hrmin[..., n, None], hrexp[..., n, None]
                dhr = (hr1 - hr0).clamp(min=puny)
                dhr2 = (hr1 ** 2 - hr0 ** 2).clamp(min=puny)
                hL = torch.maximum(hr0, lo)
                hR = torch.minimum(hr1, hi)
                ok = (hr0 < hi) & (hr1 > lo)
                farea = torch.where(ok, (hR - hL) / dhr, 0.0)
                fvol = torch.where(ok, (hR ** 2 - hL ** 2) / dhr2, 0.0)
            else:
                hi1 = hrmin[..., n, None]
                hexp = hrexp[..., n, None].clamp(min=puny)
                hL = torch.maximum(hi1, lo)
                expL = torch.exp(-(hL - hi1) / hexp)
                # every receiver but the top one: the part between its
                # bounds; the top one takes the tail
                hR = hi[:-1]
                ok = hi1 < hR
                expR = torch.exp(-(hR - hi1) / hexp)
                farea = torch.cat([
                    torch.where(ok, expL[..., :-1] - expR, 0.0),
                    expL[..., -1:]], -1)
                fvol = torch.cat([
                    torch.where(ok, ((hL[..., :-1] + hexp) *
                                     expL[..., :-1] - (hR + hexp) * expR) /
                                (hi1 + hexp).clamp(min=puny), 0.0),
                    (hL[..., -1:] + hexp) * expL[..., -1:] /
                    (hi1 + hexp).clamp(min=puny)], -1)
            farea = torch.where(act[..., None], farea, 0.0)
            fvol = torch.where(act[..., None], fvol, 0.0)
            a = a + farea * ardg2n[..., None]
            v = v + fvol * virdgn[..., None]
            vs = vs + fvol * vsrdgn[..., None] * FSNOWRDG
            for store, trc, amount, skip in zip(
                    stores, groups,
                    (farea * ardg2n[..., None], fvol * virdgn[..., None],
                     fvol * vsrdgn[..., None] * FSNOWRDG),
                    (True, True, False)):
                for k2 in store:
                    if skip and k2 in NO_TRANSFER_TRACERS:
                        continue
                    store[k2] = store[k2] + per_cat(amount,
                                                    cat_n(trc[k2], n))

        aicen, vicen, vsnon = a, v, vs
        # recover tracer means for the next iteration.  Divide wherever
        # the base is POSITIVE (not just > puny): a receiver category
        # can hold a sub-puny sliver of snow whose enthalpy must stay
        # physical — zeroing it leaves vsnon > 0 with qs = 0 ("snow"
        # above the melting point) and the thermo solver cannot close
        # that column's energy budget (matches itd.py recover).
        area_tracers, ice_tracers, snow_tracers = groups = tuple(
            recover_tracers(store, base)
            for store, base in zip(stores, (aicen, vicen, vsnon)))

        # iterate if the total area still deviates from 1
        asum = aice0 + aicen.sum(-1)
        closing_net = torch.where((asum - 1.0).abs() > puny,
                                  (1.0 - asum) / dt, 0.0)
        opning = torch.zeros_like(opning)

    return RidgeResult(
        aicen=aicen, vicen=vicen, vsnon=vsnon, aice0=aice0,
        area_tracers=area_tracers, ice_tracers=ice_tracers,
        snow_tracers=snow_tracers,
        dardg1dt=ardg1 / dt, dardg2dt=ardg2 / dt, dvirdgdt=virdg / dt,
        opening=aopen / dt,
        msnow_mlt=msnow_mlt, esnow_mlt=esnow_mlt)
