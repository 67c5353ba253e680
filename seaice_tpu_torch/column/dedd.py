"""Delta-Eddington multiple-scattering shortwave (dEdd).

Port of the JAX package's `column/dedd.py`, which re-designs the
reference delta-Eddington radiation (`ice_shortwave.F90`: shortwave_dEdd
:1187, compute_dEdd :1674, solution_dEdd :3140; Briegleb & Light 2007):
a two-stream delta-Eddington solution through the snow/ice column in
three spectral bands (visible, two near-IR), with the published inherent
optical properties — the 32-radius snow grain tables and the sea-ice
SSL/DL/interior constants — copied below.  Vectorized over [*B, nCat]
columns with the (static) layer stack unrolled.

Layer stack (snow-covered): snow SSL | snow body | ice SSL | ice DL |
(nilyr-1) ice interior; bare ice drops the snow rows. The Fresnel
discontinuity sits at the top of the ice SSL for air/snow surfaces
(refractive index 1.31), exactly as in solution_dEdd.

The snow-grain tables are gathered by tensor index, so they live on the
state's device in its dtype: `dedd_optics(dtype, device)` makes them
once (`ColumnPhysics` does so at construction) and `shortwave_dedd`
takes the result; every other table entry enters as a Python scalar.
The snow grain radius is the snow grain-radius tracer where the column
carries it, else the reference's parametric radius.  The aerosol optics
(the bulk tables and the modal black-carbon tables) are tensors too,
made by `aerosol_optics` and held by `ColumnPhysics`: bulk and modal
aerosol mass paths mix into the layer optics (`_mix_aerosol`,
`_mix_aerosol_modal`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as c

RSNW_TAB = np.array([5.0, 7.0, 10.0, 15.0, 20.0, 30.0, 40.0, 50.0, 65.0, 80.0, 100.0, 120.0, 140.0, 170.0, 200.0, 240.0, 290.0, 350.0, 420.0, 500.0, 570.0, 660.0, 760.0, 870.0, 1000.0, 1100.0, 1250.0, 1400.0, 1600.0, 1800.0, 2000.0, 2500.0])
QS_TAB = np.array([2.131798, 2.187756, 2.267358, 2.104499, 2.148345, 2.236078, 2.08158, 2.116885, 2.175067, 2.062595, 2.088937, 2.130242, 2.051403, 2.072422, 2.10661, 2.039223, 2.055389, 2.080586, 2.032383, 2.045751, 2.066394, 2.02792, 2.039388, 2.057224, 2.023444, 2.033137, 2.048055, 2.020412, 2.02884, 2.041874, 2.017608, 2.024863, 2.036046, 2.015592, 2.022021, 2.031954, 2.014083, 2.019887, 2.028853, 2.012368, 2.017471, 2.025353, 2.011092, 2.015675, 2.022759, 2.009837, 2.013897, 2.020168, 2.008668, 2.012252, 2.017781, 2.007627, 2.010813, 2.015678, 2.006764, 2.009577, 2.01388, 2.006037, 2.00852, 2.012382, 2.005528, 2.007807, 2.011307, 2.005025, 2.007079, 2.01028, 2.004562, 2.00644, 2.009333, 2.004155, 2.005898, 2.008523, 2.003794, 2.005379, 2.007795, 2.003555, 2.005041, 2.007329, 2.003264, 2.004624, 2.006729, 2.003037, 2.004291, 2.00623, 2.002776, 2.003929, 2.0057, 2.00259, 2.003627, 2.005276, 2.002395, 2.003391, 2.004904, 2.002071, 2.002922, 2.004241]).reshape(32, 3)
WS_TAB = np.array([0.9999994, 0.9999673, 0.9954589, 0.9999992, 0.9999547, 0.9938576, 0.999999, 0.9999382, 0.9917989, 0.9999985, 0.9999123, 0.9889724, 0.9999979, 0.9998844, 0.986619, 0.999997, 0.9998317, 0.9823021, 0.999996, 0.99978, 0.9785269, 0.9999951, 0.9997288, 0.9751601, 0.9999936, 0.9996531, 0.9706974, 0.9999922, 0.9995783, 0.9667577, 0.9999903, 0.9994798, 0.9621007, 0.9999885, 0.9993825, 0.9579541, 0.9999866, 0.9992862, 0.9541924, 0.9999838, 0.9991434, 0.9490959, 0.999981, 0.9990025, 0.944494, 0.9999772, 0.9988171, 0.9389141, 0.9999726, 0.998589, 0.9325819, 0.999967, 0.9983199, 0.9256405, 0.9999605, 0.9980117, 0.9181533, 0.999953, 0.9976663, 0.910154, 0.9999465, 0.9973693, 0.9035031, 0.9999382, 0.9969939, 0.8953134, 0.9999289, 0.9965848, 0.8865789, 0.9999188, 0.9961434, 0.877335, 0.9999068, 0.9956323, 0.8668233, 0.9998975, 0.9952464, 0.858999, 0.9998837, 0.9946782, 0.8476493, 0.9998699, 0.9941218, 0.8367318, 0.9998515, 0.9933966, 0.8227881, 0.9998332, 0.9926888, 0.8095131, 0.9998148, 0.9919968, 0.796862, 0.9997691, 0.9903277, 0.7677887]).reshape(32, 3)
GS_TAB = np.array([0.859913, 0.848003, 0.824415, 0.86713, 0.85815, 0.848445, 0.873381, 0.867221, 0.861714, 0.878368, 0.874879, 0.874036, 0.881462, 0.879661, 0.881299, 0.884361, 0.883903, 0.890184, 0.885937, 0.886256, 0.895393, 0.886931, 0.887769, 0.899072, 0.887894, 0.889255, 0.903285, 0.888515, 0.890236, 0.906588, 0.889073, 0.891127, 0.910152, 0.889452, 0.89175, 0.9131, 0.88973, 0.892213, 0.915621, 0.890026, 0.892723, 0.918831, 0.890238, 0.893099, 0.92154, 0.890441, 0.893474, 0.924581, 0.890618, 0.893816, 0.927701, 0.890762, 0.894123, 0.930737, 0.890881, 0.894397, 0.933568, 0.890975, 0.894645, 0.936148, 0.891035, 0.894822, 0.937989, 0.891097, 0.89502, 0.939949, 0.891147, 0.895212, 0.941727, 0.891189, 0.895399, 0.943339, 0.891225, 0.895601, 0.944915, 0.891248, 0.895745, 0.94595, 0.891277, 0.895951, 0.947288, 0.891299, 0.896142, 0.948438, 0.891323, 0.896388, 0.949762, 0.89134, 0.896623, 0.950916, 0.891356, 0.896851, 0.951945, 0.891386, 0.897399, 0.954156]).reshape(32, 3)


# sea-ice / pond / ocean-water IOPs per band (reference :2160-2200)
KI_SSL = np.array([1000.1, 1003.7, 7042.0])
WI_SSL = np.array([0.9999, 0.9963, 0.9088])
GI_SSL = np.array([0.94, 0.94, 0.94])
KI_DL = np.array([100.2, 107.7, 1309.0])
WI_DL = np.array([0.9980, 0.9287, 0.0305])
GI_DL = np.array([0.94, 0.94, 0.94])
KI_INT = np.array([20.2, 27.7, 1445.0])
WI_INT = np.array([0.9901, 0.7223, 0.0277])
GI_INT = np.array([0.94, 0.94, 0.94])
KW = np.array([0.20, 12.0, 729.0])      # pond water
WW = np.zeros(3)
GW = np.zeros(3)

HS_SSL = 0.040       # snow surface scattering layer (m)
HI_SSL = 0.050       # ice surface scattering layer (m)
REFINDX = 1.310      # sea ice refractive index
CP063 = 0.063        # diffuse Fresnel reflectivity from above
CP455 = 0.455        # diffuse Fresnel reflectivity from below
EXP_MIN = 1e-20
ALBOCN_DR = np.array([0.006, 0.006, 0.006])
ALBOCN_DF = np.array([0.006, 0.006, 0.006])

GAUSPT = np.array([0.9894009, 0.9445750, 0.8656312, 0.7554044,
                   0.6178762, 0.4580168, 0.2816036, 0.0950125])
GAUSWT = np.array([0.0271525, 0.0622535, 0.0951585, 0.1246290,
                   0.1495960, 0.1691565, 0.1826034, 0.1894506])


# ponded-ice IOPs (reference :2178-2186)
KI_P_SSL = np.array([70.2, 77.7, 1309.0])
WI_P_SSL = np.array([0.9972, 0.9009, 0.0305])
GI_P_SSL = np.array([0.94, 0.94, 0.94])
KI_P_INT = np.array([20.2, 27.7, 1445.0])
WI_P_INT = np.array([0.9901, 0.7223, 0.0277])
GI_P_INT = np.array([0.94, 0.94, 0.94])
# scattering-coefficient tuning fractions (reference :2203-2206)
FP_ICE, FM_ICE = 0.15, 0.15
FP_PND, FM_PND = 2.00, 0.50
HP0 = 0.200          # pond depth above which fully ponded optics
HPMIN = 0.005        # minimum radiatively active pond depth
HS_MIN_SW = 1.0e-4   # minimum snow depth for snow cover
KALG = 0.6           # bottom-algae absorption (1/m per 0.5 m layer;
                     # config_algae_absorption_coefficient,
                     # Registry.xml:1535 — the reference always adds a
                     # fixed kalg*0.5 m visible optical depth to the
                     # BOTTOM ice layer when dEdd_algae is off,
                     # ice_shortwave.F90:2386,2713-2716)


class DeddOptics(NamedTuple):
    """The snow-grain optics tables as tensors of one dtype/device."""
    rsnw: torch.Tensor      # [32] grain radii (um)
    qs: torch.Tensor        # [32, 3] extinction efficiency
    ws: torch.Tensor        # [32, 3] single-scattering albedo
    gs: torch.Tensor        # [32, 3] asymmetry parameter


def dedd_optics(dtype, device) -> DeddOptics:
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dtype)
    return DeddOptics(t(RSNW_TAB), t(QS_TAB), t(WS_TAB), t(GS_TAB))


def snow_iops(grain_radius, band: int, optics: DeddOptics):
    """Interpolate (Qs, ws, gs) from the 32-radius tables."""
    tab = optics.rsnw
    n = tab.shape[0]
    r = grain_radius.clamp(float(RSNW_TAB[0]), float(RSNW_TAB[-1]))
    idx = torch.searchsorted(tab, r.contiguous()) - 1
    idx = idx.clamp(0, n - 2)
    r0 = tab[idx]
    r1 = tab[idx + 1]
    w = (r - r0) / (r1 - r0).clamp(min=1e-12)

    def interp(table):
        t = table[:, band]
        return (1.0 - w) * t[idx] + w * t[idx + 1]

    return interp(optics.qs), interp(optics.ws), interp(optics.gs)


def _delta_scale(tau, w0, g):
    f = g * g
    ts = (1.0 - w0 * f) * tau
    ws = (1.0 - f) * w0 / (1.0 - w0 * f)
    gs = (g - f) / (1.0 - f)
    return ts, ws, gs


def _layer_coeffs(ts, ws, gs, mu0n):
    """Direct/diffuse reflect/transmit of one delta-scaled layer
    (reference solution_dEdd :3380-3440)."""
    lm = torch.sqrt(3.0 * (1.0 - ws) * (1.0 - ws * gs))
    ue = 1.5 * (1.0 - ws * gs) / lm.clamp(min=1e-12)
    extins = torch.exp(-lm * ts).clamp(min=EXP_MIN)
    ne = (ue + 1.0) ** 2 / extins - (ue - 1.0) ** 2 * extins
    rdif_a = (ue * ue - 1.0) * (1.0 / extins - extins) / ne
    tdif_a = 4.0 * ue / ne
    trnlay = torch.exp(-ts / mu0n).clamp(min=EXP_MIN)

    def _ag(mu):
        denom = 1.0 - lm * lm * mu * mu
        denom = torch.where(denom.abs() < 1e-9,
                            torch.sign(denom) * 1e-9 + 1e-12, denom)
        alp = 0.75 * ws * mu * (1.0 + gs * (1.0 - ws)) / denom
        gam = 0.5 * ws * (1.0 + 3.0 * gs * (1.0 - ws) * mu * mu) / denom
        return alp, gam

    alp, gam = _ag(mu0n)
    apg, amg = alp + gam, alp - gam
    rdir = apg * rdif_a + amg * (tdif_a * trnlay - 1.0)
    tdir = apg * tdif_a + (amg * rdif_a - apg + 1.0) * trnlay

    # diffuse coefficients by Gaussian integration over incidence angle
    R1, T1 = rdif_a, tdif_a
    swt = 0.0
    smr = 0.0
    smt = 0.0
    for ng in range(8):
        mu = float(GAUSPT[ng])
        gwt = float(GAUSWT[ng])
        swt = swt + mu * gwt
        trn = torch.exp(-ts / mu).clamp(min=EXP_MIN)
        alp, gam = _ag(mu)
        apg_, amg_ = alp + gam, alp - gam
        rdr = apg_ * R1 + amg_ * T1 * trn - amg_
        tdr = apg_ * T1 + amg_ * R1 * trn - apg_ * trn + trn
        smr = smr + mu * rdr * gwt
        smt = smt + mu * tdr * gwt
    rdif = smr / swt
    tdif = smt / swt
    return rdir, tdir, rdif, tdif, trnlay


def _fresnel(mu0, mu0n):
    R1 = (mu0 - REFINDX * mu0n) / (mu0 + REFINDX * mu0n)
    R2 = (REFINDX * mu0 - mu0n) / (REFINDX * mu0 + mu0n)
    T1 = 2.0 * mu0 / (mu0 + REFINDX * mu0n)
    T2 = 2.0 * mu0 / (REFINDX * mu0 + mu0n)
    Rf_dir = 0.5 * (R1 * R1 + R2 * R2)
    Tf_dir = 0.5 * (T1 * T1 + T2 * T2) * REFINDX * mu0n / mu0
    return Rf_dir, Tf_dir


def solve_dedd_column(taus, w0s, gs_list, coszen, kfrsnl: int,
                      albodr, albodf):
    """Two-stream delta-Eddington adding solution (reference
    solution_dEdd :3140-3610), static layer count, vectorized batch.

    taus/w0s/gs_list: lists (length K) of [*B] layer properties.
    kfrsnl: index of the Fresnel layer (ice SSL) or -1 (pond surface).
    Returns per-interface transmissions/reflectivities and the
    absorbed-per-layer fractions for unit direct and diffuse incident.

    The layers' own coefficients and the interfaces' fluxes are computed
    for all layers at once on a trailing layer axis (elementwise, so the
    numbers are those of a loop over the layers); only the adding
    recurrences run layer by layer."""
    K = len(taus)
    mu0 = coszen.clamp(min=0.01)
    mu0n_below = torch.sqrt(1.0 - (1.0 - mu0 ** 2) / REFINDX ** 2)
    n_above = K if kfrsnl < 0 else kfrsnl     # layers above the Fresnel one
    mu0n = torch.stack([mu0] * n_above + [mu0n_below] * (K - n_above), -1)
    ts, ws, gsc = _delta_scale(torch.stack(taus, -1), torch.stack(w0s, -1),
                               torch.stack(gs_list, -1))
    # the layers' coefficients in float64 whatever the state's dtype: the
    # particular solution's terms grow as 1 / (1 - lm^2 mu^2) near its
    # removable singularity at lm mu = 1 (a strongly absorbing layer, such
    # as the visible band's algal bottom layer, meets it at the first
    # Gaussian angle) and cancel to the O(1) coefficients, which float32
    # then holds to no digit: the absorbed shortwave of a layer came out
    # 3.6 times too large and its neighbours' zero, and the mushy solve's
    # energy closure could not close.  A no-op in float64.
    rdirs, tdirs, rdifas, tdifas, trnlays = (
        list(x.to(ts.dtype).unbind(-1)) for x in _layer_coeffs(
            ts.double(), ws.double(), gsc.double(), mu0n.double()))
    rdifbs, tdifbs = list(rdifas), list(tdifas)
    if kfrsnl >= 0:
        k = kfrsnl
        rdir, tdir, rdif, tdif = rdirs[k], tdirs[k], rdifas[k], tdifas[k]
        Rf_dir, Tf_dir = _fresnel(mu0, mu0n_below)
        Rf_dif_a, Tf_dif_a = CP063, 1.0 - CP063
        Rf_dif_b, Tf_dif_b = CP455, 1.0 - CP455
        rintfc = 1.0 / (1.0 - Rf_dif_b * rdif)
        tdirs[k] = Tf_dir * tdir + Tf_dir * rdir * Rf_dif_b * rintfc * tdif
        rdirs[k] = Rf_dir + Tf_dir * rdir * rintfc * Tf_dif_b
        rdifbs[k] = rdif + tdif * Rf_dif_b * rintfc * tdif
        rdifas[k] = Rf_dif_a + Tf_dif_a * rdif * rintfc * Tf_dif_b
        tdifas[k] = tdif * rintfc * Tf_dif_a
        tdifbs[k] = tdif * rintfc * Tf_dif_b
        trnlays[k] = Tf_dir * trnlays[k]

    trndir = [torch.ones_like(mu0)]
    trntdr = [torch.ones_like(mu0)]
    trndif = [torch.ones_like(mu0)]
    rdndif = [torch.zeros_like(mu0)]
    for k in range(K):
        rdir, tdir, rdif, tdif = rdirs[k], tdirs[k], rdifas[k], tdifas[k]
        refkm1 = 1.0 / (1.0 - rdndif[k] * rdif)
        tdrrdir = trndir[k] * rdir
        tdndif = trntdr[k] - trndir[k]
        trndir.append(trndir[k] * trnlays[k])
        trntdr.append(trndir[k] * tdir +
                      (tdndif + tdrrdir * rdndif[k]) * refkm1 * tdif)
        rdndif.append(rdifbs[k] + tdifbs[k] * rdndif[k] * refkm1 * tdif)
        trndif.append(trndif[k] * refkm1 * tdif)

    rupdir = [None] * (K + 1)
    rupdif = [None] * (K + 1)
    rupdir[K] = albodr * torch.ones_like(mu0)
    rupdif[K] = albodf * torch.ones_like(mu0)
    for k in range(K - 1, -1, -1):
        refkp1 = 1.0 / (1.0 - rdifbs[k] * rupdif[k + 1])
        rupdir[k] = rdirs[k] + (
            trnlays[k] * rupdir[k + 1] +
            (tdirs[k] - trnlays[k]) * rupdif[k + 1]) * refkp1 * tdifbs[k]
        rupdif[k] = rdifas[k] + tdifas[k] * rupdif[k + 1] * refkp1 * \
            tdifbs[k]

    # net downward fluxes at interfaces for unit direct / diffuse
    # incident (reference :2900-2960): fdirdn/up etc., every interface
    # at once on a trailing axis
    trndir, trntdr, trndif, rdndif, rupdir, rupdif = (
        torch.stack(x, -1) for x in (trndir, trntdr, trndif, rdndif,
                                     rupdir, rupdif))
    refk = 1.0 / (1.0 - rdndif * rupdif)
    fdirdn = trndir + (trntdr - trndir +
                       trndir * rupdir * rdndif) * refk
    fdirup = (trndir * rupdir +
              (trntdr - trndir +
               trndir * rupdir * rdndif) * refk * rupdif)
    fdifdn = trndif * refk
    fdifup = trndif * refk * rupdif
    net_dir = fdirdn - fdirup
    net_dif = fdifdn - fdifup
    return {
        "albedo_dr": rupdir[..., 0], "albedo_df": rupdif[..., 0],
        "abs_dir": list((net_dir[..., :-1] - net_dir[..., 1:]).unbind(-1)),
        "abs_dif": list((net_dif[..., :-1] - net_dif[..., 1:]).unbind(-1)),
        "net_dn_dir": list(net_dir.unbind(-1)),
        "net_dn_dif": list(net_dif.unbind(-1)),
        "trans_dr": net_dir[..., K], "trans_df": net_dif[..., K],
    }


def _tune_iops(k_mn, w_mn, R, fp, fm):
    """Scattering-coefficient tuning (reference :2303-2341)."""
    f = fp if R >= 0.0 else fm
    sigp = max(float(k_mn) * float(w_mn) * (1.0 + f * R), 0.0)
    k = sigp + float(k_mn) * (1.0 - float(w_mn))
    return k, sigp / k


# bulk aerosol optics per band x species (2 x black carbon, 4 x dust
# size bins): the standard CICE/Icepack 3-band tables the reference
# reads from its optics input file (aerosolMassExtinctionCrossSection
# etc., Registry.xml:3951; mixing code ice_shortwave.F90:2556-2650).
# Exact file tables replace them through `aerosol_optics` (or
# `ColumnPhysics.set_aerosol_optics`).
KAER_TAB = np.array([                     # mass extinction (m^2/kg)
    [11580.619, 25798.965, 196.498, 2665.859, 840.783, 387.512],
    [5535.418, 11536.039, 204.141, 2256.710, 1028.247, 414.688],
    [2793.797, 4688.242, 214.423, 820.360, 1163.033, 450.298]])
WAER_TAB = np.array([                     # single-scatter albedo
    [0.290, 0.517, 0.845, 0.899, 0.891, 0.780],
    [0.173, 0.416, 0.942, 0.969, 0.937, 0.709],
    [0.066, 0.213, 0.957, 0.974, 0.949, 0.730]])
GAER_TAB = np.array([                     # asymmetry parameter
    [0.354, 0.526, 0.832, 0.689, 0.702, 0.787],
    [0.198, 0.324, 0.783, 0.708, 0.661, 0.736],
    [0.089, 0.150, 0.744, 0.542, 0.720, 0.644]])

# -- modal aerosol optics (config_use_modal_aerosols) ------------------------
# BC optics binned by BC effective radius (10 bins) plus the
# within-grain absorption enhancement factor binned additionally by
# snow grain radius (8 bins): the SNICAR internal-mixing treatment
# (Flanner et al. 2012; reference mixing code
# ice_shortwave.F90:2390-2470 and :2556-2680, tables from the MPAS
# optics input stream modalMassExtinctionCrossSection /
# modalBCabsorptionParameter, Registry.xml:3954-3961).  The table data
# ships in the external optics file, so the defaults below are the JAX
# package's provisional ones: the 100 nm column reproduces the bulk BC
# optics, neighboring radius bins scale it smoothly, and the enhancement
# grows with snow grain radius in the Flanner 2012 range (1-2.2x).
_BC_BIN_SCALE = np.linspace(1.35, 0.45, 10)      # vs 100nm bin (idx 1)
KAER_BC_TAB = KAER_TAB[:, :1] * _BC_BIN_SCALE[None, :]
WAER_BC_TAB = np.clip(WAER_TAB[:, :1] *
                      np.linspace(0.8, 1.6, 10)[None, :], 0.0, 0.98)
GAER_BC_TAB = np.clip(GAER_TAB[:, :1] *
                      np.linspace(0.85, 1.45, 10)[None, :], 0.0, 0.95)
# bcenh[band, bc_bin, snow_grain_bin]
BCENH_TAB = (1.0 + 1.2 * (np.arange(1, 9) / 8.0) ** 0.5)[None, None, :] \
    * np.ones((3, 10, 1))

_K_BC_RADIUS = 1   # fixed 100 nm BC effective radius (ref: index 2)


class AerosolOptics(NamedTuple):
    """The aerosol optics of one dtype/device: the bulk tables as tensors
    [3, n_species]; the modal black carbon at its fixed radius bin as
    Python floats per band (extinction, single-scatter albedo,
    asymmetry) and its within-grain enhancement as a tensor [3, 8] over
    the snow-grain bins."""
    kaer: torch.Tensor
    waer: torch.Tensor
    gaer: torch.Tensor
    bc: tuple               # ((k, w, g) per band)
    bcenh: torch.Tensor


def aerosol_optics(dtype, device, kaer=KAER_TAB, waer=WAER_TAB,
                   gaer=GAER_TAB, kaer_bc=KAER_BC_TAB, waer_bc=WAER_BC_TAB,
                   gaer_bc=GAER_BC_TAB, bcenh=BCENH_TAB) -> AerosolOptics:
    """The aerosol optics tables in dtype on device: the bulk per-band
    tables (shape [3, n_species], the reference's set_aerosol_optics)
    and the modal BC tables ([3, 10] x3 and [3, 10, 8], its
    set_modal_aerosol_optics), the JAX package's defaults unless given
    (exact tables from an optics file)."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
            device=device, dtype=dtype)
    k = _K_BC_RADIUS
    bc = tuple((float(np.asarray(kaer_bc)[b, k]),
                float(np.asarray(waer_bc)[b, k]),
                float(np.asarray(gaer_bc)[b, k])) for b in range(3))
    return AerosolOptics(t(kaer), t(waer), t(gaer), bc,
                         t(np.asarray(bcenh)[:, k, :]))


def _snow_grain_bcenh_index(r_um):
    """Snow-grain-radius bin for the BC enhancement table, 0-based
    (reference ice_shortwave.F90:2395-2409: valid 25-1625 um; <125:
    round(r/50); <175: 2; else round(r/250 + 2); clipped 1..8)."""
    r = torch.as_tensor(r_um)
    idx = torch.where(
        r < 125.0, torch.round(r / 50.0),
        torch.where(r < 175.0, 2.0, torch.round(r / 250.0 + 2.0)))
    return idx.clamp(1.0, 8.0).to(torch.int64) - 1


def _mix(tau, w0, g, taer, waer, gaer):
    """Add an aerosol's (extinction, scattering, scattering x asymmetry)
    optical depths to one layer's (tau, w0, g)."""
    g_new = (g * w0 * tau + gaer) / (w0 * tau + waer).clamp(min=c.PUNY)
    w_new = (w0 * tau + waer) / (tau + taer).clamp(min=c.PUNY)
    return tau + taer, w_new, torch.where(taer > 0.0, g_new, g)


def _mix_aerosol(tau, w0, g, mp, band, aero: AerosolOptics):
    """Mix bulk-aerosol optics into one layer's (tau, w0, g)
    (reference ice_shortwave.F90:2556-2650): mp [*B, n_species] is the
    aerosol mass path in this layer (kg/m^2)."""
    n_sp = mp.shape[-1]
    k_t = aero.kaer[band, :n_sp]
    w_t = aero.waer[band, :n_sp]
    g_t = aero.gaer[band, :n_sp]
    return _mix(tau, w0, g, (mp * k_t).sum(-1), (mp * k_t * w_t).sum(-1),
                (mp * k_t * w_t * g_t).sum(-1))


def _mix_aerosol_modal(tau, w0, g, mp, band, kini, aero: AerosolOptics):
    """Modal-BC aerosol mixing for one layer (reference
    ice_shortwave.F90:2562-2597): species 0 = interstitial BC
    (radius-binned optics), species 1 = within-grain BC (extinction
    enhanced by bcenh for the layer's snow grain bin, scattering
    unenhanced), species >= 2 = dust via the bulk tables.
    kini: [*B(mp.shape[:-1])] int snow-grain bin (0-based); ice layers
    pass 7 (the largest bin)."""
    kb, wb, gb = aero.bc[band]
    enh = aero.bcenh[band][kini]
    # interstitial BC
    taer = mp[..., 0] * kb
    waer = mp[..., 0] * kb * wb
    gaer = mp[..., 0] * kb * wb * gb
    # within-grain BC: enhanced extinction, unenhanced scattering
    taer = taer + mp[..., 1] * kb * enh
    waer = waer + mp[..., 1] * kb * wb
    gaer = gaer + mp[..., 1] * kb * wb * gb
    n_sp = mp.shape[-1]
    if n_sp > 2:
        k_t = aero.kaer[band, 2:n_sp]
        w_t = aero.waer[band, 2:n_sp]
        g_t = aero.gaer[band, 2:n_sp]
        taer = taer + (mp[..., 2:] * k_t).sum(-1)
        waer = waer + (mp[..., 2:] * k_t * w_t).sum(-1)
        gaer = gaer + (mp[..., 2:] * k_t * w_t * g_t).sum(-1)
    return _mix(tau, w0, g, taer, waer, gaer)


def shortwave_dedd(aicen, vicen, vsnon, Tsfcn, coszen,
                   swvdr, swvdf, swidr, swidf,
                   n_ice_layers: int, n_snow_layers: int = 1,
                   apnd=None, hpnd=None, rsnw=None,
                   aero_mp_snow=None, aero_mp_ice=None,
                   R_ice: float = 0.0, R_pnd: float = 0.0,
                   R_snw: float = 1.5, dT_mlt: float = 1.5,
                   rsnw_mlt: float = 1500.0, hs0: float = 0.0,
                   kalg: float = KALG, modal_aero: bool = False,
                   optics: DeddOptics = None, aero: AerosolOptics = None):
    """Delta-Eddington albedos and absorbed-solar partition, with the
    ShortwaveResult interface of shortwave_ccsm3 (reference
    shortwave_dEdd :1187 + compute_dEdd :1674 assembly, run_dEdd
    surface-type fractions :940-1100).

    Layer geometry follows compute_dEdd exactly (:2280-2296): the snow
    SSL is carved out of the TOP snow layer (dzk0 = min(hs_ssl, dz/2)),
    the ice SSL out of the top ice layer, the DL is the remainder of
    the top ice layer with its optical depth scaled by fs = 0.25/nilyr
    (:2701), and the remaining ice layers are hi/nilyr.  Absorption
    booking follows the ksrf logic (:2965-3030): for snow-covered
    columns only the snow SSL is booked to the surface — snow-body
    absorption goes to Sswabs and ice SSL+DL absorption to Iswabs(1);
    for bare/ponded columns the rows above the ice DL go to the
    surface and the DL into Iswabs(1).

    apnd/hpnd: effective pond fraction of the category area (already
    scheme-adjusted by the caller, e.g. apnd*alvl for level-ice ponds)
    and pond depth; enables the ponded surface type (srftyp==2) with
    pond-water layers above ponded-ice IOPs and a Fresnel layer at the
    pond surface (kfrsnl=0), with the hpmin<=hp<=hp0 transition
    blending (:2873-2900).
    rsnw: per-snow-layer grain radius tracer [*B, nCat, ns]; default
    is the reference's Tsfc-dependent parametric radius (set_snow
    :3693-3711) with tuning R_snw.
    aero_mp_snow/aero_mp_ice: bulk aerosol mass paths
    [*B, nCat, n_species, 2] (kg/m^2; slot 0 = SSL pool, slot 1 =
    body pool, the reference's aero_mp groups of 4 :1417-1428) mixed
    into the snow/ice layer optics (:2556-2650); modal_aero: the modal
    BC treatment (`_mix_aerosol_modal`) in place of the bulk tables.
    optics, aero: from `dedd_optics` and `aerosol_optics` (made here
    when None).
    """
    from .shortwave import ShortwaveResult

    if optics is None:
        optics = dedd_optics(aicen.dtype, aicen.device)
    if aero is None and (aero_mp_snow is not None or
                         aero_mp_ice is not None):
        aero = aerosol_optics(aicen.dtype, aicen.device)
    ni, ns_l = n_ice_layers, n_snow_layers
    has = aicen > c.PUNY
    safe_a = torch.where(has, aicen, 1.0)
    hi = torch.where(has, vicen / safe_a, 0.0).clamp(min=1e-4)
    hs = torch.where(has, vsnon / safe_a, 0.0)
    l_snow = hs >= HS_MIN_SW

    mu = coszen.clamp(min=0.01)
    if mu.ndim == aicen.ndim - 1:
        mu = mu[..., None] * torch.ones_like(aicen)

    # surface-type fractions (run_dEdd :976-1080, set_snow :3679)
    fs = torch.where(l_snow, 1.0, torch.zeros_like(aicen))
    if hs0 > c.PUNY:
        fs = torch.where(l_snow, (hs / hs0).clamp(max=1.0), 0.0)
    if apnd is not None:
        hp = hpnd.clamp(min=0.0)
        fp = torch.where(hp >= HPMIN, apnd.clamp(0.0, 1.0), 0.0)
        fs = torch.minimum(fs, 1.0 - fp)
    else:
        hp = None
        fp = torch.zeros_like(aicen)
    fi = (1.0 - fs - fp).clamp(min=0.0)

    # snow grain radius per optical snow row (SSL + body use the top
    # layer's radius; deeper rows their own)
    if rsnw is not None:
        r_rows = [rsnw[..., 0].clamp(54.526, 1500.0)] * 2 + \
            [rsnw[..., k].clamp(54.526, 1500.0) for k in range(1, ns_l)]
    else:
        dTs = c.TIMELT - Tsfcn
        fT = -(dTs / dT_mlt - 1.0).clamp(max=0.0)
        rsnw_nm = float(np.clip(500.0 - R_snw * 250.0, 100.0, rsnw_mlt))
        r_par = (rsnw_nm + (rsnw_mlt - rsnw_nm) * fT).clamp(100.0,
                                                            rsnw_mlt)
        r_rows = [r_par] * (ns_l + 1)

    # band weights (reference :2252-2255)
    fnidr = swidr / (swidr + swidf).clamp(min=c.PUNY)
    w2 = 0.67 + (0.78 - 0.67) * (1.0 - fnidr)
    swdr_b = [swvdr, swidr * w2, swidr * (1.0 - w2)]
    swdf_b = [swvdf, swidf * w2, swidf * (1.0 - w2)]

    # layer thicknesses (compute_dEdd :2278-2296)
    dz_s = hs / ns_l
    dzs_rows = [(dz_s / 2.0).clamp(max=HS_SSL)]
    dzs_rows.append(dz_s - dzs_rows[0])
    for _ in range(ns_l - 1):
        dzs_rows.append(dz_s)
    dz_i = hi / ni
    dzi_ssl = torch.minimum((hi / 30.0).clamp(max=HI_SSL), dz_i / 2.0)
    dzi_dl = dz_i - dzi_ssl
    fs_dl = 0.25 / ni           # DL tau scaling (:2701)
    kfrsnl = ns_l + 2           # Fresnel at top of the ice DL (:3396)
    n_srf_rows = ns_l + 2       # rows above the DL (snow + ice SSL)
    K = ns_l + ni + 2

    def bsc(x):
        return x[..., None] * torch.ones_like(aicen) if \
            x.ndim == aicen.ndim - 1 else x

    def full(value):
        return torch.full_like(aicen, float(value))

    zero = torch.zeros_like(aicen)
    abs_srf = zero
    abs_int = zero
    Isw = [zero] * ni
    Ssw = [zero] * ns_l
    fswthru = zero
    alvdr = alvdf = alidr = alidf = zero

    for b in range(3):
        ki_ssl, wi_ssl = _tune_iops(KI_SSL[b], WI_SSL[b], R_ice,
                                    FP_ICE, FM_ICE)
        ki_dl, wi_dl = _tune_iops(KI_DL[b], WI_DL[b], R_ice,
                                  FP_ICE, FM_ICE)
        ki_int, wi_int = _tune_iops(KI_INT[b], WI_INT[b], R_ice,
                                    FP_ICE, FM_ICE)

        def sb_solve(snow_mask):
            """One snow/bare column solve: snow rows masked out for
            bare columns (snow_mask False)."""
            taus, w0s, gls = [], [], []
            for k in range(ns_l + 1):
                qs, ws_s, gs_s = snow_iops(r_rows[k], b, optics)
                ks = qs * (c.RHOS / c.RHOI) * 3.0 / \
                    (4.0 * r_rows[k] * 1e-6)
                taus.append(torch.where(snow_mask, ks * dzs_rows[k], 0.0))
                w0s.append(torch.where(snow_mask, ws_s, 0.0))
                gls.append(torch.where(snow_mask, gs_s, 0.0))
            taus += [ki_ssl * dzi_ssl, ki_dl * dzi_dl * fs_dl]
            w0s += [full(wi_ssl), full(wi_dl)]
            gls += [full(GI_SSL[b]), full(GI_DL[b])]
            for k in range(ni - 1):
                if b == 0 and k == ni - 2:
                    # bottom layer, visible band: algal absorption of
                    # optical depth kalg*0.5 m (:2713-2716)
                    kabs = ki_int * (1.0 - wi_int) + kalg * 0.5 / dz_i
                    sig = ki_int * wi_int
                    taus.append((kabs + sig) * dz_i)
                    w0s.append((sig / (sig + kabs)).expand(aicen.shape))
                    gls.append(full(GI_INT[b]))
                else:
                    taus.append(ki_int * dz_i)
                    w0s.append(full(wi_int))
                    gls.append(full(GI_INT[b]))

            # bulk aerosol mixing into the layer optics (:2556-2650):
            # snow SSL pool -> row 0, snow body /ns_l over the body
            # rows; ice SSL pool -> the ice SSL row, ice body /ni over
            # DL+interior
            if modal_aero:
                # per-row snow-grain bins for the within-grain BC
                # enhancement; ice rows use the largest bin
                # (reference :2410-2412)
                kini_rows = [_snow_grain_bcenh_index(r_rows[k])
                             for k in range(ns_l + 1)]
                kini_ice = torch.full(aicen.shape, 7, dtype=torch.int64,
                                      device=aicen.device)

                def mix(t, w, gg, mp, row):
                    kini = kini_rows[row] if row <= ns_l else kini_ice
                    return _mix_aerosol_modal(t, w, gg, mp, b, kini, aero)
            else:
                def mix(t, w, gg, mp, row):
                    return _mix_aerosol(t, w, gg, mp, b, aero)
            if aero_mp_snow is not None:
                mps = torch.where(snow_mask[..., None],
                                  aero_mp_snow[..., 0], 0.0)
                mpb = torch.where(snow_mask[..., None],
                                  aero_mp_snow[..., 1], 0.0) / ns_l
                taus[0], w0s[0], gls[0] = mix(
                    taus[0], w0s[0], gls[0], mps, 0)
                for k in range(1, ns_l + 1):
                    taus[k], w0s[k], gls[k] = mix(
                        taus[k], w0s[k], gls[k], mpb, k)
            if aero_mp_ice is not None:
                mpi_s = aero_mp_ice[..., 0]
                mpi_b = aero_mp_ice[..., 1] / ni
                k = ns_l + 1
                taus[k], w0s[k], gls[k] = mix(taus[k], w0s[k], gls[k],
                                              mpi_s, k)
                for k in range(ns_l + 2, K):
                    taus[k], w0s[k], gls[k] = mix(
                        taus[k], w0s[k], gls[k], mpi_b, k)

            sol = solve_dedd_column(taus, w0s, gls, mu, kfrsnl,
                                    float(ALBOCN_DR[b]),
                                    float(ALBOCN_DF[b]))
            fdr = bsc(swdr_b[b])
            fdf = bsc(swdf_b[b])

            # net downward flux at each interface
            F = [sol["net_dn_dir"][k] * fdr +
                 sol["net_dn_dif"][k] * fdf for k in range(K + 1)]

            # ksrf booking (:2952-3030): snow -> interface 1;
            # bare -> interface n_srf_rows
            F_ksrf = torch.where(snow_mask, F[1], F[n_srf_rows])
            sfc_b = F[0] - F_ksrf
            int_b = F_ksrf - F[K]
            thru_b = F[K]
            Sabs_b = [torch.where(snow_mask, F[k] - F[k + 1], 0.0)
                      for k in range(1, ns_l + 1)]
            # top ice layer: SSL+DL if snow-covered, DL only if bare
            Iabs_b = [torch.where(snow_mask,
                                  F[ns_l + 1] - F[ns_l + 3],
                                  F[ns_l + 2] - F[ns_l + 3])]
            for k in range(ni - 1):
                Iabs_b.append(F[ns_l + 3 + k] - F[ns_l + 4 + k])
            return sol, sfc_b, int_b, thru_b, Sabs_b, Iabs_b

        # with hs0=0 snow cover is all-or-nothing per category and one
        # solve covers both surface types (l_snow selects the stack);
        # with hs0>0 the snow-covered (fs) and bare (fi) fractions see
        # DIFFERENT columns (reference run_dEdd srftyp 0/1 splits)
        if hs0 > c.PUNY:
            parts = [(fs, sb_solve(l_snow)),
                     (fi, sb_solve(torch.zeros_like(l_snow)))]
        else:
            parts = [(fs + fi, sb_solve(l_snow))]
        a_dr = zero
        a_df = zero
        for w_sb, (sol, sfc_b, int_b, thru_b, Sabs_b, Iabs_b) in parts:
            abs_srf = abs_srf + w_sb * sfc_b
            abs_int = abs_int + w_sb * int_b
            fswthru = fswthru + w_sb * thru_b
            for k in range(ns_l):
                Ssw[k] = Ssw[k] + w_sb * Sabs_b[k]
            for k in range(ni):
                Isw[k] = Isw[k] + w_sb * Iabs_b[k]
            a_dr = a_dr + w_sb * sol["albedo_dr"]
            a_df = a_df + w_sb * sol["albedo_df"]

        # ponded surface type (srftyp==2)
        if apnd is not None:
            fdr = bsc(swdr_b[b])
            fdf = bsc(swdf_b[b])
            ki_p_ssl, wi_p_ssl = _tune_iops(KI_P_SSL[b], WI_P_SSL[b],
                                            R_pnd, FP_PND, FM_PND)
            ki_p_int, wi_p_int = _tune_iops(KI_P_INT[b], WI_P_INT[b],
                                            R_pnd, FP_PND, FM_PND)
            dz_p = hp / (ns_l + 1)
            taus_p = [float(KW[b]) * dz_p for _ in range(ns_l + 1)]
            w0s_p = [full(WW[b]) for _ in range(ns_l + 1)]
            gls_p = [full(GW[b]) for _ in range(ns_l + 1)]
            # thin-pond transition to bare-ice optics (:2873-2900)
            blend = (hp / HP0).clamp(0.0, 1.0)
            sig_ssl = ki_ssl * wi_ssl + \
                (ki_p_ssl * wi_p_ssl - ki_ssl * wi_ssl) * blend
            kext_ssl = sig_ssl + ki_p_ssl * (1.0 - wi_p_ssl)
            sig_dl = ki_dl * wi_dl * fs_dl + \
                (ki_p_int * wi_p_int - ki_dl * wi_dl * fs_dl) * blend
            kext_dl = sig_dl + ki_p_int * (1.0 - wi_p_int)
            fullp = hp > HP0
            tau_pssl = torch.where(fullp, ki_p_ssl * dzi_ssl,
                                   kext_ssl * dzi_ssl)
            w0_pssl = torch.where(fullp, wi_p_ssl, sig_ssl /
                                  kext_ssl.clamp(min=c.PUNY))
            tau_pdl = torch.where(fullp, ki_p_int * dzi_dl,
                                  kext_dl * dzi_dl)
            w0_pdl = torch.where(fullp, wi_p_int, sig_dl /
                                 kext_dl.clamp(min=c.PUNY))
            taus_p += [tau_pssl, tau_pdl]
            w0s_p += [w0_pssl, w0_pdl]
            gls_p += [full(GI_P_SSL[b]), full(GI_P_INT[b])]
            for k in range(ni - 1):
                taus_p.append(ki_p_int * dz_i)
                w0s_p.append(full(wi_p_int))
                gls_p.append(full(GI_P_INT[b]))

            sol_p = solve_dedd_column(taus_p, w0s_p, gls_p, mu, 0,
                                      float(ALBOCN_DR[b]),
                                      float(ALBOCN_DF[b]))
            Fp = [sol_p["net_dn_dir"][k] * fdr +
                  sol_p["net_dn_dif"][k] * fdf for k in range(K + 1)]
            abs_srf = abs_srf + fp * (Fp[0] - Fp[n_srf_rows])
            abs_int = abs_int + fp * (Fp[n_srf_rows] - Fp[K])
            fswthru = fswthru + fp * Fp[K]
            Isw[0] = Isw[0] + fp * (Fp[ns_l + 2] - Fp[ns_l + 3])
            for k in range(ni - 1):
                Isw[k + 1] = Isw[k + 1] + \
                    fp * (Fp[ns_l + 3 + k] - Fp[ns_l + 4 + k])
            a_dr = a_dr + fp * sol_p["albedo_dr"]
            a_df = a_df + fp * sol_p["albedo_df"]

        if b == 0:
            alvdr = alvdr + a_dr
            alvdf = alvdf + a_df
        else:
            alidr = alidr + a_dr * (bsc(w2) if b == 1 else 1.0 - bsc(w2))
            alidf = alidf + a_df * (bsc(w2) if b == 1 else 1.0 - bsc(w2))

    Iswabs = torch.stack(Isw, -1)
    Sswabs = torch.stack(Ssw, -1)

    def z(x):
        return torch.where(has, x, 0.0)

    return ShortwaveResult(
        alvdr=z(alvdr), alvdf=z(alvdf), alidr=z(alidr), alidf=z(alidf),
        fswsfc=z(abs_srf), fswint=z(abs_int), fswthru=z(fswthru),
        Iswabs=torch.where(has[..., None], Iswabs.clamp(min=0.0), 0.0),
        Sswabs=torch.where(has[..., None], Sswabs.clamp(min=0.0), 0.0),
        albin=z(alvdr), albsn=z(alvdf))
