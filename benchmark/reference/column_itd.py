"""The reference's ice thickness distribution: new ice in open water,
lateral melt, the linear remapping of the distribution after growth and
melt (Lipscomb 2001; Icepack `ice_therm_itd.F90`), the removal of
negligible categories (`ice_itd.F90`), and the mechanical redistribution
with exponential participation and redistribution and Rothrock's (1975)
strength (Lipscomb et al. 2007; `ice_mechred.F90`).

Tracers are dicts {name: [nc, ncat] or [nc, ncat, nl]} in three groups,
conserved as area x tracer, ice volume x tracer and snow volume x
tracer.

Departures from the published description, as in the program:
  * new ice takes the enthalpy of fresh ice at its melting point and the
    Bitz and Lipscomb salinity profile; what open water cannot hold is
    spread under every category;
  * ridging runs 3 passes; a pond or level-ice tracer of ridged ice is
    lost, not carried into the ridge;
  * a category is removed where its area is under 1e-11 or its volume
    under 1e-14."""

from __future__ import annotations

import math

import torch

from .column import HFRAZILMIN, LFRESH, MU_RDG, PUNY, RHOI, RHOS, RHOW, \
    GRAVIT, CF_RIDGE

HI_MIN = 0.01
CS, FSNOWRDG, ASTAR, MAXRAFT = 0.25, 0.5, 0.05, 1.0
RIDGE_PASSES = 3
NOT_RIDGED = ("levelIceArea", "levelIceVolume", "pondArea", "pondDepth",
              "pondLidThickness")


def _b(base, x):
    """base broadcast over x's layer axis."""
    return base if x.ndim == base.ndim else base[..., None]


def products(tracers, base):
    return {k: v * _b(base, v) for k, v in tracers.items()}


def means(stores, base):
    out = {}
    for k, v in stores.items():
        b = _b(base, v)
        out[k] = torch.where(b > 0.0, v / torch.where(b == 0, 1.0, b), 0.0)
    return out


def _set(x, n, value):
    y = x.clone()
    y[..., n] = value
    return y


def _add(x, n, amount, layered=False):
    y = x.clone()
    if layered:
        y[..., n, :] += amount
    else:
        y[..., n] += amount
    return y


def new_ice(dt, hin_max, aicen, vicen, at, it, frzmlt, Tf, salin):
    """Frazil ice from the ocean's freezing potential: into the open
    water at 5 cm or more (at most 0.9 of category 1's upper bound), the
    rest spread under every category (Icepack add_new_ice).  Returns
    (aicen, vicen, area tracers, ice tracers)."""
    aice = aicen.sum(-1)
    aice0 = (1.0 - aice).clamp(min=0.0)
    hmax = hin_max[1] * 0.9
    q_new = -RHOI * LFRESH
    v_new = -frzmlt.clamp(min=0.0) * dt / q_new
    open_ = aice0 > PUNY
    h_new = (v_new / aice0.clamp(min=PUNY)).clamp(min=HFRAZILMIN)
    thick = (h_new > hmax) & (aice0 + PUNY < 1.0)
    h_new = torch.where(thick, hmax, h_new)
    a_new = torch.where(open_, torch.where(thick, aice0,
                                           v_new / h_new.clamp(min=PUNY)), 0.0)
    a_new = torch.where(v_new > 0.0, a_new, 0.0)
    surplus = torch.where(open_ & thick, v_new - a_new * h_new,
                          torch.where(open_, 0.0, v_new))
    surplus = torch.where(v_new > 0.0, surplus, 0.0)
    h_under = torch.where(aice > PUNY, surplus / aice.clamp(min=PUNY), 0.0)
    v1_new = torch.where(open_, v_new - surplus, 0.0).clamp(min=0.0)

    it = dict(it)
    under = h_under[..., None] * aicen
    vt = vicen + under
    pos = vt > 0.0
    q = it["iceEnthalpy"]
    it["iceEnthalpy"] = torch.where(
        pos[..., None], (q * vicen[..., None] + q_new * under[..., None]) /
        vt[..., None].clamp(min=PUNY), q)
    s = it["iceSalinity"]
    it["iceSalinity"] = torch.where(
        pos[..., None], (s * vicen[..., None] + salin.expand(s.shape) *
                         under[..., None]) / vt[..., None].clamp(min=PUNY), s)
    vl = it["levelIceVolume"]
    it["levelIceVolume"] = torch.where(pos, (vl * vicen + under) /
                                       vt.clamp(min=PUNY), vl)
    vicen = vt

    a0, v0 = aicen[..., 0], vicen[..., 0]
    a1, v1 = a0 + a_new, v0 + v1_new
    aicen, vicen = _set(aicen, 0, a1), _set(vicen, 0, v1)
    at = dict(at)
    t = at["surfaceTemperature"]
    t1 = ((t[..., 0] * a0 + Tf * a_new) / a1.clamp(min=PUNY)).clamp(max=0.0)
    at["surfaceTemperature"] = _set(t, 0, torch.where(a1 > PUNY, t1,
                                                      t[..., 0]))
    for name, value in (("iceAge", 0.0), ("firstYearIceArea", 1.0),
                        ("levelIceArea", 1.0)):
        t = at[name]
        t1 = (t[..., 0] * a0 + value * a_new) / a1.clamp(min=PUNY)
        at[name] = _set(t, 0, torch.where(a1 > PUNY, t1, t[..., 0]))
    for name, value in (("iceEnthalpy", q_new), ("iceSalinity", salin)):
        x = it[name]
        x1 = (x[..., 0, :] * v0[..., None] + value * v1_new[..., None]) / \
            v1[..., None].clamp(min=PUNY)
        y = x.clone()
        y[..., 0, :] = torch.where(v1[..., None] > PUNY, x1, x[..., 0, :])
        it[name] = y
    vl = it["levelIceVolume"]
    it["levelIceVolume"] = _set(vl, 0, torch.where(
        v1 > PUNY, (vl[..., 0] * v0 + v1_new) / v1.clamp(min=PUNY),
        vl[..., 0]))
    return aicen, vicen, at, it


def fit_line(a, h, hL, hR):
    """The linear g(h) over [hL, hR] of category area a and mean h,
    narrowed where h lies in the outer thirds (Lipscomb 2001).  Returns
    (g0, g1, hL, hR)."""
    ok = (a > PUNY) & (hR - hL > PUNY)
    h13 = (2.0 * hL + hR) / 3.0
    h23 = (hL + 2.0 * hR) / 3.0
    hR2 = torch.where(h < h13, 3.0 * h - 2.0 * hL, hR)
    hL2 = torch.where(h > h23, 3.0 * h - 2.0 * hR2, hL)
    d = 1.0 / (hR2 - hL2).clamp(min=PUNY)
    w1 = 6.0 * a * d
    w2 = (h - hL2) * d
    return (torch.where(ok, w1 * (2.0 / 3.0 - w2), 0.0),
            torch.where(ok, 2.0 * d * w1 * (w2 - 0.5), 0.0),
            torch.where(ok, hL2, 0.0), torch.where(ok, hR2, 0.0))


def linear_remap(hin_max, a_init, v_init, aicen, vicen, vsnon, at, it, st):
    """Moves ice between categories after growth and melt: each boundary
    moves with the thickness change interpolated to it, the distribution
    is linear in each category, and what crosses a category's bounds
    goes to its neighbour with its tracers (Lipscomb 2001).  Returns
    (aicen, vicen, vsnon, at, it, st)."""
    ncat = aicen.shape[-1]
    h0 = torch.where(a_init > PUNY, v_init / torch.where(a_init > PUNY,
                                                         a_init, 1.0), 0.0)
    has = aicen > PUNY
    h = torch.where(has, vicen / torch.where(has, aicen, 1.0), 0.0)
    dh = torch.where(has, h - h0, 0.0)
    full = torch.full_like(aicen[..., 0], hin_max[0])
    hb = [full]
    ok = torch.ones_like(aicen[..., 0], dtype=torch.bool)
    for n in range(ncat - 1):
        a, b = h0[..., n], h0[..., n + 1]
        both = (a > PUNY) & (b > PUNY)
        slope = (dh[..., n + 1] - dh[..., n]) / torch.where(both, b - a, 1.0)
        x = torch.where(both, hin_max[n + 1] + dh[..., n] + slope *
                        (hin_max[n + 1] - a),
                        torch.where((a > PUNY) & ~both,
                                    hin_max[n + 1] + dh[..., n],
                                    torch.where((b > PUNY) & ~both,
                                                hin_max[n + 1] +
                                                dh[..., n + 1],
                                                hin_max[n + 1])))
        ok = ok & ~((aicen[..., n] > PUNY) & (h[..., n] >= x)) & \
            ~((aicen[..., n + 1] > PUNY) & (h[..., n + 1] <= x)) & \
            (x <= hin_max[n + 2]) & (x >= hin_max[n])
        hb.append(x)
    top = torch.where(aicen[..., -1] > PUNY, 3.0 * h[..., -1] - 2.0 * hb[-1],
                      hin_max[ncat])
    hb.append(top.clamp(min=hin_max[ncat - 1]))

    # category 1's thin end melting back
    g0, g1, hL, hR = fit_line(aicen[..., 0], h0[..., 0], hb[0],
                              torch.full_like(hb[0], hin_max[1]))
    a1, h1, d1 = aicen[..., 0], h[..., 0], dh[..., 0]
    eta = torch.minimum((-d1).clamp(max=hin_max[1]), hR) - hL
    lose = (a1 > PUNY) & (d1 < 0.0) & ok & (eta > 0.0)
    da = g1 * 0.5 * eta * eta + g0 * eta
    da_max = a1 * (1.0 - h1 / torch.where(h0[..., 0] > 0, h0[..., 0], 1.0))
    da = torch.where(lose, torch.minimum(da, da_max.clamp(min=0.0)), 0.0)
    h = _set(h, 0, torch.where(lose, h1 * a1 / (a1 - da).clamp(min=PUNY), h1))
    aicen = _set(aicen, 0, torch.where(lose, a1 - da, a1))
    hb[0] = torch.where((a1 > PUNY) & (d1 >= 0.0) & ok,
                        d1.clamp(max=hin_max[1]), hb[0])

    fits = [fit_line(aicen[..., n], h[..., n], hb[n], hb[n + 1])
            for n in range(ncat)]
    st = {k: v + RHOS * LFRESH if k == "snowEnthalpy" else v
          for k, v in st.items()}
    P = [products(at, aicen), products(it, vicen), products(st, vsnon)]
    moves = []
    for n in range(ncat - 1):
        up = hb[n + 1] > hin_max[n + 1]       # ice goes from n to n + 1
        g0n, g1n, hLn, hRn = fits[n]
        g0m, g1m, hLm, hRm = fits[n + 1]
        lo = torch.where(up, hLn.clamp(min=hin_max[n + 1]) - hLn, 0.0)
        hi = torch.where(up, torch.minimum(hb[n + 1], hRn) - hLn,
                         hRm.clamp(max=hin_max[n + 1]) - hLm)
        g0 = torch.where(up, g0n, g0m)
        g1 = torch.where(up, g1n, g1m)
        hl = torch.where(up, hLn, hLm)
        go = (hi > lo) & ok
        x1, x2 = hi - lo, 0.5 * (hi ** 2 - lo ** 2)
        x3 = (hi ** 3 - lo ** 3) / 3.0
        da = torch.where(go, g1 * x2 + g0 * x1, 0.0)
        dv = torch.where(go, g1 * x3 + g0 * x2 + da * hl, 0.0)
        a_d = torch.where(up, aicen[..., n], aicen[..., n + 1])
        v_d = torch.where(up, vicen[..., n], vicen[..., n + 1])
        nil = (da < a_d * PUNY) | (dv < v_d * PUNY)
        da, dv = torch.where(nil, 0.0, da), torch.where(nil, 0.0, dv)
        all_ = ((da > a_d * (1.0 - PUNY)) | (dv > v_d * (1.0 - PUNY))) & ~nil
        moves.append((up, torch.where(all_, a_d, da),
                      torch.where(all_, v_d, dv)))
    for n, (up, da, dv) in enumerate(moves):
        # the donor as the boundaries below have left it
        a_d = torch.where(up, aicen[..., n], aicen[..., n + 1])
        v_d = torch.where(up, vicen[..., n], vicen[..., n + 1])
        fa = da / a_d.clamp(min=PUNY)
        fv = dv / v_d.clamp(min=PUNY)
        vs_d = torch.where(up, vsnon[..., n], vsnon[..., n + 1])
        sgn = torch.where(up, 1.0, -1.0)
        aicen = _add(_add(aicen, n, -sgn * da), n + 1, sgn * da)
        vicen = _add(_add(vicen, n, -sgn * dv), n + 1, sgn * dv)
        dvs = vs_d * fa
        vsnon = _add(_add(vsnon, n, -sgn * dvs), n + 1, sgn * dvs)
        for group, frac in zip(P, (fa, fv, fa)):
            for k, x in group.items():
                lay = x.ndim == aicen.ndim + 1
                xn = x[..., n, :] if lay else x[..., n]
                xm = x[..., n + 1, :] if lay else x[..., n + 1]
                f = _b(frac, xn)
                amt = torch.where(_b(up, xn), xn * f, -(xm * f))
                group[k] = _add(_add(x, n, -amt, lay), n + 1, amt, lay)
    at, it, st = (means(g, b) for g, b in zip(P, (aicen, vicen, vsnon)))
    qs = st["snowEnthalpy"] - RHOS * LFRESH
    st["snowEnthalpy"] = torch.where(vsnon[..., None] > 0.0, qs, 0.0)

    a1 = aicen[..., 0]
    h1 = torch.where(a1 > PUNY, vicen[..., 0] / a1.clamp(min=PUNY), 0.0)
    thin = (a1 > PUNY) & (h1 < HI_MIN) & (h1 > 0.0)
    aicen = _add(aicen, 0, -torch.where(thin, a1 * (1.0 - h1 / HI_MIN), 0.0))
    return aicen, vicen, vsnon, at, it, st


def cleanup(aicen, vicen, vsnon, at, it, st):
    """Categories of area under 1e-11 or volume under 1e-14 removed with
    their tracers."""
    small = (aicen < PUNY) | (vicen < PUNY * 1e-3)

    def zap(d):
        return {k: torch.where(_b(small, v), 0.0, v) for k, v in d.items()}

    z = torch.where(small, 0.0, aicen), torch.where(small, 0.0, vicen), \
        torch.where(small, 0.0, vsnon)
    return z + (zap(at), zap(it), zap(st))


def participation(aicen, vicen, aice0):
    """(apartic [nc, ncat + 1] with open water first, hrmin, hrexp, krdg
    [nc, ncat], aksum [nc]): the exponential participation of each
    category in ridging and the exponential ridge of each (Lipscomb et
    al. 2007)."""
    ncat = aicen.shape[-1]
    G = [torch.zeros_like(aice0), torch.where(aice0 > PUNY, aice0, 0.0)]
    for n in range(ncat):
        G.append(G[-1] + torch.where(aicen[..., n] > PUNY, aicen[..., n],
                                     0.0))
    tot = G[-1].clamp(min=PUNY)
    norm = 1.0 / (1.0 - math.exp(-1.0 / ASTAR))
    e = [torch.exp(-(g / tot) / ASTAR) * norm for g in G]
    ap = torch.stack([(e[n] - e[n + 1]).clamp(min=0.0)
                      for n in range(ncat + 1)], -1)
    has = aicen > PUNY
    hi = torch.where(has, vicen / torch.where(has, aicen, 1.0), PUNY).clamp(
        min=PUNY)
    hrmin = torch.where(has, torch.minimum(2.0 * hi, hi + MAXRAFT), 0.0)
    hrexp = torch.where(has, MU_RDG * torch.sqrt(hi), 0.0)
    krdg = torch.where(has, (hrmin + hrexp) / hi, 1.0)
    aksum = ap[..., 0] + (ap[..., 1:] * (1.0 - 1.0 / krdg)).sum(-1)
    return ap, hrmin, hrexp, krdg, aksum


def rothrock_strength(aicen, vicen):
    """Rothrock's (1975) strength (N m-1): Cf times the potential energy
    that ridging at a unit closing rate gains, with the exponential
    participation and ridges."""
    aice0 = (1.0 - aicen.sum(-1)).clamp(min=0.0)
    ap, hrmin, hrexp, krdg, aksum = participation(aicen, vicen, aice0)
    Cp = 0.5 * GRAVIT * (RHOW - RHOI) * RHOI / RHOW
    s = torch.zeros_like(aice0)
    for n in range(aicen.shape[-1]):
        has = aicen[..., n] > PUNY
        hi = torch.where(has, vicen[..., n] / aicen[..., n].clamp(min=PUNY),
                         0.0)
        h2 = hrmin[..., n] ** 2 + 2.0 * hrmin[..., n] * hrexp[..., n] + \
            2.0 * hrexp[..., n] ** 2
        s = s + torch.where(has & (ap[..., n + 1] > 0.0), ap[..., n + 1] *
                            (-hi ** 2 + h2 / krdg[..., n].clamp(min=PUNY)),
                            0.0)
    return Cp * CF_RIDGE * s.clamp(min=0.0) / aksum.clamp(min=PUNY)


def ridge(dt, hin_max, conv, shear, aicen, vicen, vsnon, at, it, st):
    """Mechanical redistribution under the net closing rate CS x shear +
    convergence (1/s): participating ice of each category is ridged into
    the categories its exponential ridge spans, open water closes, and
    the total area returns to 1 over RIDGE_PASSES passes.  Returns
    (aicen, vicen, vsnon, at, it, st)."""
    ncat = aicen.shape[-1]
    aice0 = (1.0 - aicen.sum(-1)).clamp(min=0.0)
    groups = [at, it, st]
    stores = [products(g, b) for g, b in zip(groups, (aicen, vicen, vsnon))]
    lo = torch.tensor(hin_max[:-1], dtype=aicen.dtype, device=aicen.device)
    hi_b = torch.tensor(hin_max[1:-1] + [1.0e8], dtype=aicen.dtype,
                        device=aicen.device)
    asum = aice0 + aicen.sum(-1)
    closing = CS * shear + conv
    divu = (1.0 - asum) / dt
    closing = torch.where(divu < 0.0, torch.maximum(closing, -divu), closing)
    opening = closing + divu
    for _ in range(RIDGE_PASSES):
        ap, hrmin, hrexp, krdg, aksum = participation(aicen, vicen, aice0)
        gross = closing / aksum.clamp(min=PUNY)
        w = ap[..., 0] * gross * dt
        f = torch.where(w > aice0, aice0 / w.clamp(min=PUNY), 1.0)
        gross, op = gross * f, opening * f
        for n in range(ncat):
            w = ap[..., n + 1] * gross * dt
            a = aicen[..., n]
            f = torch.where((a > PUNY) & (ap[..., n + 1] > 0.0) & (w > a),
                            a / w.clamp(min=PUNY), 1.0)
            gross, op = gross * f, op * f
        aice0 = (aice0 - ap[..., 0] * gross * dt + op * dt).clamp(min=0.0)
        a_new, v_new, vs_new = aicen, vicen, vsnon
        for n in range(ncat):
            act = (aicen[..., n] > PUNY) & (ap[..., n + 1] > 0.0) & \
                (gross > 0.0)
            ar1 = torch.where(act, torch.minimum(
                aicen[..., n], ap[..., n + 1] * gross * dt), 0.0)
            ar2 = ar1 / krdg[..., n].clamp(min=PUNY)
            share = ar1 / aicen[..., n].clamp(min=PUNY)
            vr = vicen[..., n] * share
            vsr = vsnon[..., n] * share
            a_new = _add(a_new, n, -ar1)
            v_new = _add(v_new, n, -vr)
            vs_new = _add(vs_new, n, -vsr)
            for store, g, amount in zip(stores, groups, (ar1, vr, vsr)):
                for k in store:
                    t = g[k][..., n, :] if g[k].ndim > aicen.ndim else \
                        g[k][..., n]
                    store[k] = _add(store[k], n, -_b(amount, t) * t,
                                    t.ndim > amount.ndim)
            # the ridge's share in each category: the exponential ridge
            # from hrmin with e-folding hrexp, cut at the bounds
            h1 = hrmin[..., n, None]
            he = hrexp[..., n, None].clamp(min=PUNY)
            hL = torch.maximum(h1, lo)
            eL = torch.exp(-(hL - h1) / he)
            hR = hi_b[:-1]
            inside = h1 < hR
            eR = torch.exp(-(hR - h1) / he)
            farea = torch.cat([torch.where(inside, eL[..., :-1] - eR, 0.0),
                               eL[..., -1:]], -1)
            fvol = torch.cat([torch.where(inside, ((hL[..., :-1] + he) *
                                                   eL[..., :-1] - (hR + he) *
                                                   eR) /
                                          (h1 + he).clamp(min=PUNY), 0.0),
                              (hL[..., -1:] + he) * eL[..., -1:] /
                              (h1 + he).clamp(min=PUNY)], -1)
            farea = torch.where(act[..., None], farea, 0.0)
            fvol = torch.where(act[..., None], fvol, 0.0)
            a_new = a_new + farea * ar2[..., None]
            v_new = v_new + fvol * vr[..., None]
            vs_new = vs_new + fvol * vsr[..., None] * FSNOWRDG
            for store, g, amount, skip in zip(
                    stores, groups,
                    (farea * ar2[..., None], fvol * vr[..., None],
                     fvol * vsr[..., None] * FSNOWRDG), (True, True, False)):
                for k in store:
                    if skip and k in NOT_RIDGED:
                        continue
                    t = g[k][..., n, :] if g[k].ndim > aicen.ndim else \
                        g[k][..., n]
                    store[k] = store[k] + (amount * t[..., None]
                                           if t.ndim == amount.ndim - 1 else
                                           amount[..., None] *
                                           t[..., None, :])
        aicen, vicen, vsnon = a_new, v_new, vs_new
        groups = [means(s, b) for s, b in zip(stores, (aicen, vicen, vsnon))]
        asum = aice0 + aicen.sum(-1)
        closing = torch.where((asum - 1.0).abs() > PUNY, (1.0 - asum) / dt,
                              0.0)
        opening = torch.zeros_like(opening)
    return (aicen, vicen, vsnon) + tuple(groups)
