"""Ice thickness distribution: category bounds, aggregation, linear
remapping between categories, small-ice cleanup, and ice strength.

Port of the JAX package's `column/itd.py`, which re-designs `ice_itd.F90`
(aggregation/shift/cleanup) and `linear_itd`/`fit_line`
(`ice_therm_itd.F90:69-760`, Lipscomb 2001 linear remapping): the
per-cell category-shift logic becomes masked dense updates unrolled over
the static category count, vectorized over all cells.

State convention here: aicen, vicen, vsnon [*B, nCat]; layered tracers
[*B, nCat, nLayers]; surface temperature [*B, nCat].  `hin_max` is a
sequence of Python floats (the category bounds are scalars in every
expression, so they never change a tensor's dtype).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import constants as c

P333 = 1.0 / 3.0
P666 = 2.0 / 3.0
HI_MIN = 0.01


def category_boundaries(ncat: int, kcatbound: int = 0,
                        kitd: int = 1) -> np.ndarray:
    """hin_max[0..ncat] (reference colpkg_init_itd,
    ice_colpkg.F90:85-240)."""
    h = np.zeros(ncat + 1)
    if kcatbound == -1:
        h[1:] = 100.0
        return h
    if kcatbound == 0:
        if kitd == 1:
            cc1 = 3.0 / ncat
            cc2 = 15.0 * cc1
            cc3 = 3.0
            h[0] = 0.0
        else:
            cc1 = max(1.1 / ncat, HI_MIN)
            cc2 = 25.0 * cc1
            cc3 = 2.25
            h[0] = HI_MIN
        for n in range(1, ncat + 1):
            x1 = (n - 1) / ncat
            h[n] = h[n - 1] + cc1 + cc2 * (1.0 + np.tanh(cc3 * (x1 - 1.0)))
        return h
    if kcatbound == 1:
        d1 = 3.0 / ncat
        d2 = 0.5 / ncat
        for n in range(1, ncat + 1):
            h[n] = n * (d1 + (n - 1) * d2)
        return h
    if kcatbound == 2 and ncat == 5:       # WMO standard
        h[1:] = [0.30, 0.70, 1.20, 2.00, 999.0]
        return h
    raise NotImplementedError(f"kcatbound={kcatbound}, ncat={ncat}")


def aggregate_area(aicen):
    """aice, aice0 (reference aggregate_area, ice_itd.F90:53-81)."""
    aice = aicen.sum(-1)
    return aice, (1.0 - aice).clamp(min=0.0)


def aggregate_state(aicen, vicen, vsnon):
    return aicen.sum(-1), vicen.sum(-1), vsnon.sum(-1)


def set_cat(x, n, value):
    """x with category n (axis 1 of [*B, nCat(, nLayers)] counted from
    the batch) replaced: a new tensor, the caller's is left alone."""
    y = x.clone()
    y[..., n] = value
    return y


def add_cat(x, n, amount, layered=False):
    """x with `amount` added to category n; `layered` for
    [*B, nCat, nLayers] tensors.  A new tensor."""
    y = x.clone()
    if layered:
        y[..., n, :] += amount
    else:
        y[..., n] += amount
    return y


def recover_tracers(store, base):
    """Tracer means from conserved products: store / base where the
    base is positive, else 0 (colpkg_compute_tracers analog)."""
    out = {}
    for k, v in store.items():
        b = base if v.ndim == base.ndim else base[..., None]
        out[k] = torch.where(b > 0.0, v / torch.where(b == 0, 1.0, b), 0.0)
    return out


def conserved_tracers(trc, base):
    """Conserved products tracer * base (layered tracers broadcast the
    base over the layer axis)."""
    return {k: v * (base if v.ndim == base.ndim else base[..., None])
            for k, v in trc.items()}


def _fit_line(aicen, hice, hbL, hbR):
    """Linear g(h) fit over a category (reference fit_line,
    ice_therm_itd.F90:697-760). Returns (g0, g1, hL, hR)."""
    ok = (aicen > c.PUNY) & (hbR - hbL > c.PUNY)
    hL = hbL
    hR = hbR
    h13 = P333 * (2.0 * hL + hR)
    h23 = P333 * (hL + 2.0 * hR)
    hR = torch.where(hice < h13, 3.0 * hice - 2.0 * hL, hR)
    hL = torch.where(hice > h23, 3.0 * hice - 2.0 * hR, hL)
    dhr = 1.0 / (hR - hL).clamp(min=c.PUNY)
    wk1 = 6.0 * aicen * dhr
    wk2 = (hice - hL) * dhr
    g0 = torch.where(ok, wk1 * (P666 - wk2), 0.0)
    g1 = torch.where(ok, 2.0 * dhr * wk1 * (wk2 - 0.5), 0.0)
    hL = torch.where(ok, hL, 0.0)
    hR = torch.where(ok, hR, 0.0)
    return g0, g1, hL, hR


def linear_itd_remap(hin_max, aicen_init, vicen_init,
                     aicen, vicen, vsnon,
                     area_tracers: Dict[str, torch.Tensor],
                     ice_tracers: Dict[str, torch.Tensor],
                     snow_tracers: Dict[str, torch.Tensor]):
    """Remap the ITD after vertical thermo growth/melt
    (reference linear_itd, ice_therm_itd.F90:69-685).

    aicen_init/vicen_init: state before vertical thermo.
    area/ice/snow_tracers: dicts of per-category tracers keyed by name,
    conserved as a*T, v*T, vs*T respectively. Layered tracers have a
    trailing layer axis. Returns updated (aicen, vicen, vsnon, tracers...).
    """
    hin_max = [float(h) for h in hin_max]
    ncat = aicen.shape[-1]
    puny = c.PUNY

    def cat(x, n):
        return x[..., n]

    has_i = aicen_init > puny
    hicen_init = torch.where(has_i, vicen_init /
                             torch.where(has_i, aicen_init, 1.0), 0.0)
    has = aicen > puny
    hicen = torch.where(has, vicen / torch.where(has, aicen, 1.0), 0.0)
    dhicen = torch.where(has, hicen - hicen_init, 0.0)

    # new boundary positions hbnew[n], n = 1..ncat-1 (:229-262)
    hbnew = [torch.full(aicen.shape[:-1], hin_max[0], dtype=aicen.dtype,
                        device=aicen.device)]
    remap_flag = torch.ones(aicen.shape[:-1], dtype=torch.bool,
                            device=aicen.device)
    for n in range(ncat - 1):
        hi_n = cat(hicen_init, n)
        hi_n1 = cat(hicen_init, n + 1)
        both = (hi_n > puny) & (hi_n1 > puny)
        only_n = (hi_n > puny) & ~both
        only_n1 = (hi_n1 > puny) & ~both
        slope = (cat(dhicen, n + 1) - cat(dhicen, n)) / \
            torch.where(both, hi_n1 - hi_n, 1.0)
        hb = torch.where(
            both,
            hin_max[n + 1] + cat(dhicen, n) + slope * (hin_max[n + 1] -
                                                       hi_n),
            torch.where(only_n, hin_max[n + 1] + cat(dhicen, n),
                        torch.where(only_n1,
                                    hin_max[n + 1] + cat(dhicen, n + 1),
                                    hin_max[n + 1])))
        # consistency checks: violations disable remapping this step
        remap_flag = remap_flag & ~(
            (cat(aicen, n) > puny) & (cat(hicen, n) >= hb))
        remap_flag = remap_flag & ~(
            (cat(aicen, n + 1) > puny) & (cat(hicen, n + 1) <= hb))
        remap_flag = remap_flag & (hb <= hin_max[n + 2])
        remap_flag = remap_flag & (hb >= hin_max[n])
        hbnew.append(hb)
    hb_top = torch.where(cat(aicen, ncat - 1) > puny,
                         3.0 * cat(hicen, ncat - 1) - 2.0 * hbnew[ncat - 1],
                         hin_max[ncat])
    hbnew.append(hb_top.clamp(min=hin_max[ncat - 1]))

    # thin-end adjustment of category 1 (:400-425)
    g0, g1, hL, hR = _fit_line(cat(aicen, 0), cat(hicen_init, 0),
                               hbnew[0], torch.full_like(hbnew[0],
                                                         hin_max[1]))
    a1 = cat(aicen, 0)
    h1 = cat(hicen, 0)
    dh0 = cat(dhicen, 0)
    shrink = (a1 > puny) & (dh0 < 0.0) & remap_flag
    dh0m = (-dh0).clamp(max=hin_max[1])
    etamax = torch.minimum(dh0m, hR) - hL
    pos = shrink & (etamax > 0.0)
    x1 = etamax
    x2 = 0.5 * etamax * etamax
    da0 = g1 * x2 + g0 * x1
    damax = a1 * (1.0 - h1 / torch.where(cat(hicen_init, 0) > 0,
                                         cat(hicen_init, 0), 1.0))
    da0 = torch.where(pos, torch.minimum(da0, damax.clamp(min=0.0)), 0.0)
    h1_new = torch.where(pos, h1 * a1 / (a1 - da0).clamp(min=puny), h1)
    a1_new = torch.where(pos, a1 - da0, a1)
    aicen = set_cat(aicen, 0, a1_new)
    hicen = set_cat(hicen, 0, h1_new)
    grow0 = (a1 > puny) & (dh0 >= 0.0)
    hbnew[0] = torch.where(grow0 & remap_flag,
                           dh0.clamp(max=hin_max[1]), hbnew[0])

    # fit g(h) in every category with the new boundaries (:427-434)
    G0, G1, HL, HR = [], [], [], []
    for n in range(ncat):
        g0, g1, hL, hR = _fit_line(cat(aicen, n), cat(hicen, n),
                                   hbnew[n], hbnew[n + 1])
        G0.append(g0)
        G1.append(g1)
        HL.append(hL)
        HR.append(hR)

    # transfers across each boundary (:436-476)
    donor_is_n = []
    daice = []
    dvice = []
    for n in range(ncat - 1):
        from_n = hbnew[n + 1] > hin_max[n + 1]
        etamin = torch.where(from_n,
                             HL[n].clamp(min=hin_max[n + 1]) - HL[n], 0.0)
        etamax = torch.where(from_n,
                             torch.minimum(hbnew[n + 1], HR[n]) - HL[n],
                             HR[n + 1].clamp(max=hin_max[n + 1]) -
                             HL[n + 1])
        g0d = torch.where(from_n, G0[n], G0[n + 1])
        g1d = torch.where(from_n, G1[n], G1[n + 1])
        hLd = torch.where(from_n, HL[n], HL[n + 1])
        ok = (etamax > etamin) & remap_flag
        x1 = etamax - etamin
        x2 = 0.5 * (etamax ** 2 - etamin ** 2)
        x3 = P333 * (etamax ** 3 - etamin ** 3)
        da = torch.where(ok, g1d * x2 + g0d * x1, 0.0)
        dv = torch.where(ok, g1d * x3 + g0d * x2 + da * hLd, 0.0)
        a_d = torch.where(from_n, cat(aicen, n), cat(aicen, n + 1))
        v_d = torch.where(from_n, cat(vicen, n), cat(vicen, n + 1))
        zero = (da < a_d * puny) | (dv < v_d * puny)
        da = torch.where(zero, 0.0, da)
        dv = torch.where(zero, 0.0, dv)
        all_of_it = (da > a_d * (1.0 - puny)) | (dv > v_d * (1.0 - puny))
        da = torch.where(all_of_it & ~zero, a_d, da)
        dv = torch.where(all_of_it & ~zero, v_d, dv)
        donor_is_n.append(from_n)
        daice.append(da)
        dvice.append(dv)

    # shift ice + tracers between categories (ice_itd.F90 shift_ice
    # :347-665), with the snow-enthalpy offset trick (+rhos*Lfresh) so
    # the transferred quantity is sign-definite
    snow_off = {k: v + c.RHOS * c.LFRESH if k == "snowEnthalpy" else v
                for k, v in snow_tracers.items()}

    at = conserved_tracers(area_tracers, aicen)
    it_ = conserved_tracers(ice_tracers, vicen)
    st = conserved_tracers(snow_off, vsnon)

    def shift(x, n, amount):
        x = add_cat(x, n, -amount)
        return add_cat(x, n + 1, amount)

    def shift_tracers(trc, n, from_n, frac_from_n, frac_from_n1):
        out = {}
        for k, x in trc.items():
            layered = x.ndim == from_n.ndim + 2
            if layered:
                amt = torch.where(from_n[..., None],
                                  x[..., n, :] * frac_from_n[..., None],
                                  -(x[..., n + 1, :] *
                                    frac_from_n1[..., None]))
            else:
                amt = torch.where(from_n, x[..., n] * frac_from_n,
                                  -(x[..., n + 1] * frac_from_n1))
            x = add_cat(x, n, -amt, layered)
            out[k] = add_cat(x, n + 1, amt, layered)
        return out

    for n in range(ncat - 1):
        from_n = donor_is_n[n]
        da = daice[n]
        dv = dvice[n]
        a_d = torch.where(from_n, cat(aicen, n), cat(aicen, n + 1))
        vs_d = torch.where(from_n, cat(vsnon, n), cat(vsnon, n + 1))
        worka = da / a_d.clamp(min=puny)
        workb = dv / torch.where(from_n, cat(vicen, n),
                                 cat(vicen, n + 1)).clamp(min=puny)
        dvs = vs_d * worka

        aicen = shift(aicen, n, torch.where(from_n, da, -da))
        vicen = shift(vicen, n, torch.where(from_n, dv, -dv))
        vsnon = shift(vsnon, n, torch.where(from_n, dvs, -dvs))

        wa_n = torch.where(from_n, worka, 0.0)
        wa_n1 = torch.where(from_n, 0.0, worka)
        wv_n = torch.where(from_n, workb, 0.0)
        wv_n1 = torch.where(from_n, 0.0, workb)
        at = shift_tracers(at, n, from_n, wa_n, wa_n1)
        it_ = shift_tracers(it_, n, from_n, wv_n, wv_n1)
        st = shift_tracers(st, n, from_n, wa_n, wa_n1)  # snow moves
        # with the area fraction

    area_tracers = recover_tracers(at, aicen)
    ice_tracers = recover_tracers(it_, vicen)
    snow_tracers = recover_tracers(st, vsnon)
    snow_tracers = {
        k: (v - c.RHOS * c.LFRESH if k == "snowEnthalpy" else v)
        for k, v in snow_tracers.items()}
    # snowEnthalpy of empty categories must stay 0, not -rhos*Lfresh
    if "snowEnthalpy" in snow_tracers:
        se = snow_tracers["snowEnthalpy"]
        snow_tracers["snowEnthalpy"] = torch.where(
            vsnon[..., None] > 0.0, se, 0.0)

    # enforce hi_min on category 1 (:496-508)
    a1 = cat(aicen, 0)
    h1 = torch.where(a1 > puny, cat(vicen, 0) / a1.clamp(min=puny), 0.0)
    thin = (a1 > puny) & (h1 < HI_MIN) & (h1 > 0.0)
    da0 = torch.where(thin, a1 * (1.0 - h1 / HI_MIN), 0.0)
    aicen = add_cat(aicen, 0, -da0)

    return aicen, vicen, vsnon, area_tracers, ice_tracers, snow_tracers


def cleanup_small_ice(aicen, vicen, vsnon, area_tracers, ice_tracers,
                      snow_tracers):
    """Zap categories with negligible area/volume, returning the melt
    water/heat implicitly to the ocean (simplified zap_small_areas,
    reference ice_itd.F90:1029-1336). Returns updated state plus the
    zapped (dfresh, dfhocn) per-cell fluxes' raw sums (kg/m^2, J/m^2)."""
    small = (aicen < c.PUNY) | (vicen < c.PUNY * 1e-3)
    dfresh = ((c.RHOI * vicen + c.RHOS * vsnon) * small).sum(-1)
    e_ice = ice_tracers.get("iceEnthalpy")
    dheat = torch.zeros_like(dfresh)
    if e_ice is not None:
        dheat = ((e_ice.mean(-1) * vicen) * small).sum(-1)

    def zap(x):
        return torch.where(small, 0.0, x)

    def zap_tr(trc):
        return {k: torch.where(small[..., None] if v.ndim > small.ndim
                               else small, 0.0, v)
                for k, v in trc.items()}

    return (zap(aicen), zap(vicen), zap(vsnon), zap_tr(area_tracers),
            zap_tr(ice_tracers), zap_tr(snow_tracers), dfresh, dheat)


def ice_strength_hibler(aice, vice):
    """P = P* h exp(-C(1-a)) (Hibler 1979; reference ice_mechred.F90
    kstrength=0)."""
    return 2.75e4 * vice * torch.exp(-20.0 * (1.0 - aice))


def ice_strength_rothrock(aicen, vicen, aice, aice0, hin_max,
                          Cf: float = 17.0, krdg_partic: int = 1,
                          krdg_redist: int = 1, mu_rdg: float = 4.0):
    """Energetics-based strength (Rothrock 1975; reference
    colpkg_ice_strength, ice_colpkg.F90:3548-3598): potential-energy
    change of the ridging distribution, strength =
    Cf*Cp*sum_n apartic(n)*(-hi^2 + h2rdg/krdg) / aksum."""
    from .ridging import ridge_shift_coeffs
    Cp = 0.5 * c.GRAVIT * (c.RHOW - c.RHOI) * c.RHOI / c.RHOW
    apartic, hrmin, hrexp, krdg, aksum = ridge_shift_coeffs(
        aicen, vicen, aice0, hin_max, krdg_partic, krdg_redist, mu_rdg)
    ncat = aicen.shape[-1]
    strength = torch.zeros_like(aice)
    for n in range(ncat):
        has = aicen[..., n] > c.PUNY
        hi = torch.where(has, vicen[..., n] /
                         aicen[..., n].clamp(min=c.PUNY), 0.0)
        if krdg_redist == 0:    # Hibler 1980: hrexp slot holds hrmax
            hrmax = hrexp[..., n]
            h2rdg = (hrmax ** 3 - hrmin[..., n] ** 3) / \
                (3.0 * (hrmax - hrmin[..., n]).clamp(min=c.PUNY))
        else:                   # exponential (Lipscomb et al. 2007)
            h2rdg = hrmin[..., n] ** 2 + 2.0 * hrmin[..., n] * \
                hrexp[..., n] + 2.0 * hrexp[..., n] ** 2
        strength = strength + torch.where(
            has & (apartic[..., n + 1] > 0.0),
            apartic[..., n + 1] * (-hi ** 2 + h2rdg /
                                   krdg[..., n].clamp(min=c.PUNY)), 0.0)
    return Cp * Cf * strength.clamp(min=0.0) / aksum.clamp(min=c.PUNY)
