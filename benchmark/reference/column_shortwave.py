"""The reference's delta-Eddington shortwave (Briegleb and Light 2007;
Icepack `ice_shortwave.F90`): a two-stream delta-Eddington solution
through each category's snow and ice in three bands (visible and two
near-infrared), the layers joined by the adding method, with a Fresnel
interface for the refraction into the ice.

The inherent optical properties are Icepack's published tables (the
snow's by grain radius; the sea ice's surface scattering layer, drained
layer and interior; pond water) at the Registry's tuning (R_ice = R_pnd =
0, R_snw = 1.5, no aerosols).  The snow grain radius is the parametric
one of `set_snow` (no grain-radius tracer).

Departures from the published description, as in the program:
  * the Fresnel layer is the ice's drained layer, whose optical depth is
    scaled by 0.25 / nilyr;
  * with snow (hs >= 1e-4 m) a category is all snow-covered or, with a
    pond deeper than 5 mm, ponded on the pond's share (hs0 = 0);
  * the diffuse reflectance and transmittance of a layer are the 8-point
    Gaussian means over the angle of incidence;
  * with snow, the snow's surface scattering layer is the surface and the
    rest of the snow goes to Sswabs; bare or ponded, everything above the
    ice's drained layer is the surface;
  * the ponded column's interior takes no algal absorption."""

from __future__ import annotations

import numpy as np
import torch

from .column import KALG, PUNY, RHOI, RHOS

RSNW = [5.0, 7.0, 10.0, 15.0, 20.0, 30.0, 40.0, 50.0, 65.0, 80.0, 100.0,
        120.0, 140.0, 170.0, 200.0, 240.0, 290.0, 350.0, 420.0, 500.0,
        570.0, 660.0, 760.0, 870.0, 1000.0, 1100.0, 1250.0, 1400.0,
        1600.0, 1800.0, 2000.0, 2500.0]
# the snow's extinction efficiency, single-scattering albedo and
# asymmetry, [radius, band]
QS = [2.131798, 2.187756, 2.267358, 2.104499, 2.148345, 2.236078, 2.08158, 2.116885, 2.175067, 2.062595, 2.088937, 2.130242, 2.051403, 2.072422, 2.10661, 2.039223, 2.055389, 2.080586, 2.032383, 2.045751, 2.066394, 2.02792, 2.039388, 2.057224, 2.023444, 2.033137, 2.048055, 2.020412, 2.02884, 2.041874, 2.017608, 2.024863, 2.036046, 2.015592, 2.022021, 2.031954, 2.014083, 2.019887, 2.028853, 2.012368, 2.017471, 2.025353, 2.011092, 2.015675, 2.022759, 2.009837, 2.013897, 2.020168, 2.008668, 2.012252, 2.017781, 2.007627, 2.010813, 2.015678, 2.006764, 2.009577, 2.01388, 2.006037, 2.00852, 2.012382, 2.005528, 2.007807, 2.011307, 2.005025, 2.007079, 2.01028, 2.004562, 2.00644, 2.009333, 2.004155, 2.005898, 2.008523, 2.003794, 2.005379, 2.007795, 2.003555, 2.005041, 2.007329, 2.003264, 2.004624, 2.006729, 2.003037, 2.004291, 2.00623, 2.002776, 2.003929, 2.0057, 2.00259, 2.003627, 2.005276, 2.002395, 2.003391, 2.004904, 2.002071, 2.002922, 2.004241]  # noqa: E501
WS = [0.9999994, 0.9999673, 0.9954589, 0.9999992, 0.9999547, 0.9938576, 0.999999, 0.9999382, 0.9917989, 0.9999985, 0.9999123, 0.9889724, 0.9999979, 0.9998844, 0.986619, 0.999997, 0.9998317, 0.9823021, 0.999996, 0.99978, 0.9785269, 0.9999951, 0.9997288, 0.9751601, 0.9999936, 0.9996531, 0.9706974, 0.9999922, 0.9995783, 0.9667577, 0.9999903, 0.9994798, 0.9621007, 0.9999885, 0.9993825, 0.9579541, 0.9999866, 0.9992862, 0.9541924, 0.9999838, 0.9991434, 0.9490959, 0.999981, 0.9990025, 0.944494, 0.9999772, 0.9988171, 0.9389141, 0.9999726, 0.998589, 0.9325819, 0.999967, 0.9983199, 0.9256405, 0.9999605, 0.9980117, 0.9181533, 0.999953, 0.9976663, 0.910154, 0.9999465, 0.9973693, 0.9035031, 0.9999382, 0.9969939, 0.8953134, 0.9999289, 0.9965848, 0.8865789, 0.9999188, 0.9961434, 0.877335, 0.9999068, 0.9956323, 0.8668233, 0.9998975, 0.9952464, 0.858999, 0.9998837, 0.9946782, 0.8476493, 0.9998699, 0.9941218, 0.8367318, 0.9998515, 0.9933966, 0.8227881, 0.9998332, 0.9926888, 0.8095131, 0.9998148, 0.9919968, 0.796862, 0.9997691, 0.9903277, 0.7677887]  # noqa: E501
GS = [0.859913, 0.848003, 0.824415, 0.86713, 0.85815, 0.848445, 0.873381, 0.867221, 0.861714, 0.878368, 0.874879, 0.874036, 0.881462, 0.879661, 0.881299, 0.884361, 0.883903, 0.890184, 0.885937, 0.886256, 0.895393, 0.886931, 0.887769, 0.899072, 0.887894, 0.889255, 0.903285, 0.888515, 0.890236, 0.906588, 0.889073, 0.891127, 0.910152, 0.889452, 0.89175, 0.9131, 0.88973, 0.892213, 0.915621, 0.890026, 0.892723, 0.918831, 0.890238, 0.893099, 0.92154, 0.890441, 0.893474, 0.924581, 0.890618, 0.893816, 0.927701, 0.890762, 0.894123, 0.930737, 0.890881, 0.894397, 0.933568, 0.890975, 0.894645, 0.936148, 0.891035, 0.894822, 0.937989, 0.891097, 0.89502, 0.939949, 0.891147, 0.895212, 0.941727, 0.891189, 0.895399, 0.943339, 0.891225, 0.895601, 0.944915, 0.891248, 0.895745, 0.94595, 0.891277, 0.895951, 0.947288, 0.891299, 0.896142, 0.948438, 0.891323, 0.896388, 0.949762, 0.89134, 0.896623, 0.950916, 0.891356, 0.896851, 0.951945, 0.891386, 0.897399, 0.954156]  # noqa: E501

# sea ice (surface scattering layer, drained layer, interior), ponded ice
# and pond water: extinction (1/m), single-scattering albedo, asymmetry
ICE = {"ssl": ([1000.1, 1003.7, 7042.0], [0.9999, 0.9963, 0.9088]),
       "dl": ([100.2, 107.7, 1309.0], [0.9980, 0.9287, 0.0305]),
       "int": ([20.2, 27.7, 1445.0], [0.9901, 0.7223, 0.0277]),
       "p_ssl": ([70.2, 77.7, 1309.0], [0.9972, 0.9009, 0.0305]),
       "p_int": ([20.2, 27.7, 1445.0], [0.9901, 0.7223, 0.0277])}
G_ICE = 0.94
K_WATER = [0.20, 12.0, 729.0]
HS_SSL, HI_SSL = 0.040, 0.050
REFINDX = 1.310
R_DIF_ABOVE, R_DIF_BELOW = 0.063, 0.455
EXP_MIN = 1e-20
ALBOCN = 0.006
HP0, HPMIN = 0.200, 0.005
HS_MIN_SW = 1.0e-4
GAUSS_MU = [0.9894009, 0.9445750, 0.8656312, 0.7554044, 0.6178762,
            0.4580168, 0.2816036, 0.0950125]
GAUSS_W = [0.0271525, 0.0622535, 0.0951585, 0.1246290, 0.1495960,
           0.1691565, 0.1826034, 0.1894506]
R_SNW, DT_MLT, RSNW_MLT = 1.5, 1.5, 1500.0


def tuned(k, w, R=0.0, f=0.15):
    """Icepack's scattering tuning of (extinction, albedo) at R."""
    sig = max(k * w * (1.0 + f * R), 0.0)
    kt = sig + k * (1.0 - w)
    return kt, sig / kt


def snow_optics(r, band):
    """(Q, w, g) of snow of grain radius r (um), linear in r between the
    table's radii."""
    tab = torch.tensor(RSNW, dtype=r.dtype, device=r.device)
    r = r.clamp(RSNW[0], RSNW[-1])
    i = (torch.searchsorted(tab, r.contiguous()) - 1).clamp(0, len(RSNW) - 2)
    t = (r - tab[i]) / (tab[i + 1] - tab[i]).clamp(min=1e-12)
    out = []
    for table in (QS, WS, GS):
        col = torch.tensor(table[band::3], dtype=r.dtype, device=r.device)
        out.append((1.0 - t) * col[i] + t * col[i + 1])
    return out


def layer_terms(tau, w, g, mu):
    """Delta-scaled direct reflectance, transmittance and their diffuse
    (Gaussian) means, and the direct beam's transmission, of each layer
    (all [..., K])."""
    f = g * g
    ts = (1.0 - w * f) * tau
    ws = (1.0 - f) * w / (1.0 - w * f)
    gs = (g - f) / (1.0 - f)
    lm = torch.sqrt(3.0 * (1.0 - ws) * (1.0 - ws * gs))
    ue = 1.5 * (1.0 - ws * gs) / lm.clamp(min=1e-12)
    ext = torch.exp(-lm * ts).clamp(min=EXP_MIN)
    ne = (ue + 1.0) ** 2 / ext - (ue - 1.0) ** 2 * ext
    R = (ue * ue - 1.0) * (1.0 / ext - ext) / ne
    T = 4.0 * ue / ne

    def coeffs(m):
        den = 1.0 - lm * lm * m * m
        den = torch.where(den.abs() < 1e-9, torch.sign(den) * 1e-9 + 1e-12,
                          den)
        a = 0.75 * ws * m * (1.0 + gs * (1.0 - ws)) / den
        b = 0.5 * ws * (1.0 + 3.0 * gs * (1.0 - ws) * m * m) / den
        return a + b, a - b

    trn = torch.exp(-ts / mu).clamp(min=EXP_MIN)
    p, m_ = coeffs(mu)
    rdir = p * R + m_ * (T * trn - 1.0)
    tdir = p * T + (m_ * R - p + 1.0) * trn
    sw = sr = st = 0.0
    for mu_g, w_g in zip(GAUSS_MU, GAUSS_W):
        tr_g = torch.exp(-ts / mu_g).clamp(min=EXP_MIN)
        p, m_ = coeffs(mu_g)
        sw = sw + mu_g * w_g
        sr = sr + mu_g * (p * R + m_ * T * tr_g - m_) * w_g
        st = st + mu_g * (p * T + m_ * R * tr_g - p * tr_g + tr_g) * w_g
    return rdir, tdir, sr / sw, st / sw, trn


def column_fluxes(tau, w, g, coszen, fresnel):
    """The net downward flux at every interface [..., K + 1] for a unit
    direct and a unit diffuse beam, over layers (tau, w, g) [..., K] with
    the Fresnel interface at the top of layer `fresnel`."""
    K = tau.shape[-1]
    mu0 = coszen.clamp(min=0.01)
    mu_n = torch.sqrt(1.0 - (1.0 - mu0 ** 2) / REFINDX ** 2)
    below = torch.arange(K, device=tau.device) >= fresnel
    mu = torch.where(below, mu_n[..., None], mu0[..., None])
    rdir, tdir, rdf, tdf, trn = (list(x.unbind(-1))
                                 for x in layer_terms(tau, w, g, mu))
    rdf_b, tdf_b = list(rdf), list(tdf)
    k = fresnel
    r1 = (mu0 - REFINDX * mu_n) / (mu0 + REFINDX * mu_n)
    r2 = (REFINDX * mu0 - mu_n) / (REFINDX * mu0 + mu_n)
    t1 = 2.0 * mu0 / (mu0 + REFINDX * mu_n)
    t2 = 2.0 * mu0 / (REFINDX * mu0 + mu_n)
    Rf = 0.5 * (r1 * r1 + r2 * r2)
    Tf = 0.5 * (t1 * t1 + t2 * t2) * REFINDX * mu_n / mu0
    Ta, Tb = 1.0 - R_DIF_ABOVE, 1.0 - R_DIF_BELOW
    inner = 1.0 / (1.0 - R_DIF_BELOW * rdf[k])
    rd, td, rf, tf = rdir[k], tdir[k], rdf[k], tdf[k]
    tdir[k] = Tf * td + Tf * rd * R_DIF_BELOW * inner * tf
    rdir[k] = Rf + Tf * rd * inner * Tb
    rdf_b[k] = rf + tf * R_DIF_BELOW * inner * tf
    rdf[k] = R_DIF_ABOVE + Ta * rf * inner * Tb
    tdf[k] = tf * inner * Ta
    tdf_b[k] = tf * inner * Tb
    trn[k] = Tf * trn[k]

    one = torch.ones_like(mu0)
    t_dir, t_tot, t_dif, r_dn = [one], [one], [one], [torch.zeros_like(mu0)]
    for k in range(K):
        m = 1.0 / (1.0 - r_dn[k] * rdf[k])
        t_tot.append(t_dir[k] * tdir[k] + (t_tot[k] - t_dir[k] +
                                           t_dir[k] * rdir[k] * r_dn[k])
                     * m * tdf[k])
        t_dir.append(t_dir[k] * trn[k])
        r_dn.append(rdf_b[k] + tdf_b[k] * r_dn[k] * m * tdf[k])
        t_dif.append(t_dif[k] * m * tdf[k])
    r_up_dir = [None] * (K + 1)
    r_up_dif = [None] * (K + 1)
    r_up_dir[K] = ALBOCN * one
    r_up_dif[K] = ALBOCN * one
    for k in range(K - 1, -1, -1):
        m = 1.0 / (1.0 - rdf_b[k] * r_up_dif[k + 1])
        r_up_dir[k] = rdir[k] + (trn[k] * r_up_dir[k + 1] +
                                 (tdir[k] - trn[k]) * r_up_dif[k + 1]) * \
            m * tdf_b[k]
        r_up_dif[k] = rdf[k] + tdf[k] * r_up_dif[k + 1] * m * tdf_b[k]
    t_dir, t_tot, t_dif, r_dn, r_up_dir, r_up_dif = (
        torch.stack(x, -1) for x in (t_dir, t_tot, t_dif, r_dn, r_up_dir,
                                     r_up_dif))
    m = 1.0 / (1.0 - r_dn * r_up_dif)
    diffuse_part = (t_tot - t_dir + t_dir * r_up_dir * r_dn) * m
    net_dir = t_dir + diffuse_part - (t_dir * r_up_dir +
                                      diffuse_part * r_up_dif)
    net_dif = t_dif * m - t_dif * m * r_up_dif
    return net_dir, net_dif


def shortwave(aicen, vicen, vsnon, tsfc, coszen, sw, apond, hpond,
              ni: int, ns: int) -> dict:
    """The absorbed shortwave of each category: "fswsfc" at the surface,
    "fswint" inside, "fswthru" into the ocean [nc, ncat], "Sswabs" in the
    snow layers, "Iswabs" in the ice layers.  sw: the four bands' downward
    shortwave [nc]; apond: the ponds' share of the category's area (the
    level ice's ponds, tapered under snow on a lid); hpond: their
    depth."""
    has = aicen > PUNY
    hi = torch.where(has, vicen / torch.where(has, aicen, 1.0),
                     0.0).clamp(min=1e-4)
    hs = torch.where(has, vsnon / torch.where(has, aicen, 1.0), 0.0)
    snowy = hs >= HS_MIN_SW
    mu = coszen[:, None].expand_as(aicen)
    hp = hpond.clamp(min=0.0)
    fp = torch.where(hp >= HPMIN, apond.clamp(0.0, 1.0), 0.0)
    # the snow-covered and the bare shares see one column (hs0 = 0)
    f_snow = torch.minimum(snowy.to(aicen.dtype), 1.0 - fp)
    f_sb = f_snow + (1.0 - f_snow - fp).clamp(min=0.0)

    # the parametric grain radius (set_snow)
    r_nm = float(np.clip(500.0 - R_SNW * 250.0, 100.0, RSNW_MLT))
    fT = -((0.0 - tsfc) / DT_MLT - 1.0).clamp(max=0.0)
    r = (r_nm + (RSNW_MLT - r_nm) * fT).clamp(100.0, RSNW_MLT)

    frac_nir_dir = sw["sw_ir_dir"] / (sw["sw_ir_dir"] +
                                      sw["sw_ir_dif"]).clamp(min=PUNY)
    w2 = 0.67 + (0.78 - 0.67) * (1.0 - frac_nir_dir)
    bands = [(sw["sw_vis_dir"], sw["sw_vis_dif"]),
             (sw["sw_ir_dir"] * w2, sw["sw_ir_dif"] * w2),
             (sw["sw_ir_dir"] * (1.0 - w2), sw["sw_ir_dif"] * (1.0 - w2))]

    dzs = hs / ns
    ssl_s = (dzs / 2.0).clamp(max=HS_SSL)
    snow_dz = [ssl_s, dzs - ssl_s] + [dzs] * (ns - 1)
    dzi = hi / ni
    ssl_i = torch.minimum((hi / 30.0).clamp(max=HI_SSL), dzi / 2.0)
    dl_i = dzi - ssl_i
    fdl = 0.25 / ni
    K = ns + ni + 2
    top = ns + 2                     # the drained layer: the Fresnel one
    zero = torch.zeros_like(aicen)
    out = {"fswsfc": zero, "fswint": zero, "fswthru": zero,
           "Sswabs": torch.zeros(aicen.shape + (ns,), dtype=aicen.dtype,
                                 device=aicen.device),
           "Iswabs": torch.zeros(aicen.shape + (ni,), dtype=aicen.dtype,
                                 device=aicen.device)}

    def book(F, weight, snow):
        """Adds the absorption of net fluxes F [nc, ncat, K + 1] with
        weight; snow: where the snow's surface layer is the surface."""
        F_srf = torch.where(snow, F[..., 1], F[..., ns + 2])
        out["fswsfc"] = out["fswsfc"] + weight * (F[..., 0] - F_srf)
        out["fswint"] = out["fswint"] + weight * (F_srf - F[..., K])
        out["fswthru"] = out["fswthru"] + weight * F[..., K]
        S = torch.where(snow[..., None], F[..., 1:ns + 1] - F[..., 2:ns + 2],
                        0.0)
        out["Sswabs"] = out["Sswabs"] + weight[..., None] * S
        ice = F[..., ns + 3:K] - F[..., ns + 4:K + 1]
        first = torch.where(snow, F[..., ns + 1], F[..., ns + 2]) - \
            F[..., ns + 3]
        out["Iswabs"] = out["Iswabs"] + weight[..., None] * torch.cat(
            [first[..., None], ice], -1)

    for b in range(3):
        k_ssl, w_ssl = tuned(*(x[b] for x in ICE["ssl"]))
        k_dl, w_dl = tuned(*(x[b] for x in ICE["dl"]))
        k_int, w_int = tuned(*(x[b] for x in ICE["int"]))
        fdr, fdf = (x[:, None] for x in bands[b])

        # snow-covered or bare
        Q, ws, gs = snow_optics(r, b)
        ks = Q * (RHOS / RHOI) * 3.0 / (4.0 * r * 1e-6)
        tau = [torch.where(snowy, ks * dz, 0.0) for dz in snow_dz]
        w = [torch.where(snowy, ws, 0.0)] * (ns + 1)
        g = [torch.where(snowy, gs, 0.0)] * (ns + 1)
        tau += [k_ssl * ssl_i, k_dl * dl_i * fdl]
        w += [zero + w_ssl, zero + w_dl]
        g += [zero + G_ICE] * 2
        for k in range(ni - 1):
            if b == 0 and k == ni - 2:
                # the bottom layer's algae (Icepack's kalg x 0.5 m)
                kabs = k_int * (1.0 - w_int) + KALG * 0.5 / dzi
                sig = k_int * w_int
                tau.append((kabs + sig) * dzi)
                w.append(sig / (sig + kabs))
            else:
                tau.append(k_int * dzi)
                w.append(zero + w_int)
            g.append(zero + G_ICE)
        nd, nf = column_fluxes(torch.stack(tau, -1), torch.stack(w, -1),
                               torch.stack(g, -1), mu, top)
        book(nd * fdr[..., None] + nf * fdf[..., None], f_sb, snowy)

        # ponded
        kp_ssl, wp_ssl = tuned(*(x[b] for x in ICE["p_ssl"]), f=2.0)
        kp_int, wp_int = tuned(*(x[b] for x in ICE["p_int"]), f=2.0)
        tau = [K_WATER[b] * hp / (ns + 1)] * (ns + 1)
        w = [zero] * (ns + 1)
        g = [zero] * (ns + 1)
        blend = (hp / HP0).clamp(0.0, 1.0)
        deep = hp > HP0
        sig_s = k_ssl * w_ssl + (kp_ssl * wp_ssl - k_ssl * w_ssl) * blend
        ext_s = sig_s + kp_ssl * (1.0 - wp_ssl)
        sig_d = k_dl * w_dl * fdl + \
            (kp_int * wp_int - k_dl * w_dl * fdl) * blend
        ext_d = sig_d + kp_int * (1.0 - wp_int)
        tau += [torch.where(deep, kp_ssl * ssl_i, ext_s * ssl_i),
                torch.where(deep, kp_int * dl_i, ext_d * dl_i)]
        w += [torch.where(deep, wp_ssl, sig_s / ext_s.clamp(min=PUNY)),
              torch.where(deep, wp_int, sig_d / ext_d.clamp(min=PUNY))]
        g += [zero + G_ICE] * 2
        tau += [kp_int * dzi] * (ni - 1)
        w += [zero + wp_int] * (ni - 1)
        g += [zero + G_ICE] * (ni - 1)
        nd, nf = column_fluxes(torch.stack(tau, -1), torch.stack(w, -1),
                               torch.stack(g, -1), mu, 0)
        F = nd * fdr[..., None] + nf * fdf[..., None]
        book(F, fp, torch.zeros_like(snowy))

    out = {k: torch.where(has[..., None] if v.ndim > has.ndim else has,
                          v, 0.0) for k, v in out.items()}
    out["Sswabs"] = out["Sswabs"].clamp(min=0.0)
    out["Iswabs"] = out["Iswabs"].clamp(min=0.0)
    return out
