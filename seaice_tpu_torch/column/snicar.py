"""SNICAR 5-band delta-Eddington shortwave (use_snicar).

Port of the JAX package's `column/snicar.py`, which re-designs
`compute_dEdd_5bd` (the reference's `ice_shortwave.F90:3955-5407`,
activated by config_use_snicar_ad): the snow-covered fraction of each
category is solved in FIVE spectral bands (visible + 4 near-IR) with
snow single-scattering properties (SSPs) from the SNICAR tables
(distinct for direct and diffuse incidents), while bare and ponded ice
reuse the 3-band machinery of `dedd.py`.

Band weights are the reference's exact constants (:4527-4539); the
5-band sea-ice SSL/DL/interior IOPs are the embedded parameters of the
reference (:4458-4482).  Snow SSPs come from the SNICAR optics file
(`snicar_optics_5bnd_snow_and_aerosols.nc`, the reference's pkgSnicar
input stream, Registry.xml:2111-2146) through `load_snicar_ssp`;
otherwise the JAX package's embedded geometric-optics fallback table
(Qext=2 mass extinction, band-resolved co-albedo growing as sqrt(r)).

The tables are data of the `ColumnPhysics` that runs the scheme, not
module globals: `snicar_tables(dtype, device, ssp)` makes them as
tensors of the state's dtype on its device; until exact 5-band aerosol
optics are installed (`ColumnPhysics.set_aerosol_optics_5bd`) the 3-band
aerosol tables are mapped onto the five bands.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import constants as c
from .dedd import (ALBOCN_DF, ALBOCN_DR, FM_ICE, FP_ICE, HI_SSL, HPMIN,
                   HS_MIN_SW, HS_SSL, KALG, AerosolOptics, DeddOptics,
                   _mix, _mix_aerosol, _tune_iops, aerosol_optics,
                   dedd_optics, shortwave_dedd, solve_dedd_column)

# 5-band -> 3-band aerosol-table mapping (vis; NIR split) used until
# exact 5-band aerosol optics (kaer_tab_5bd etc. from the SNICAR file)
# are installed
_AER_BAND3 = (0, 1, 1, 2, 2)

NSPINT_5BD = 5

# 5-band spectral weights (reference :4527-4539); band 1 is visible,
# bands 2-5 partition the NIR differently for direct/diffuse skies
WGHT_DRC = np.array([1.0, 0.49352158521175, 0.18099494230665,
                     0.12094898498813,
                     1.0 - (0.49352158521175 + 0.18099494230665 +
                            0.12094898498813)])
WGHT_DFS = np.array([1.0, 0.58581507618433, 0.20156903770812,
                     0.10917889346386,
                     1.0 - (0.58581507618433 + 0.20156903770812 +
                            0.10917889346386)])

# 5-band sea ice IOPs (reference :4458-4482)
KI_SSL_5 = np.array([1000.1, 1003.7, 1003.7, 7042.0, 7042.0])
WI_SSL_5 = np.array([0.9999, 0.9963, 0.9963, 0.9088, 0.9088])
GI_SSL_5 = np.full(5, 0.94)
KI_DL_5 = np.array([100.2, 107.7, 107.7, 1309.0, 1309.0])
WI_DL_5 = np.array([0.9980, 0.9287, 0.9287, 0.0305, 0.0305])
GI_DL_5 = np.full(5, 0.94)
KI_INT_5 = np.array([20.2, 27.7, 27.7, 1445.0, 1445.0])
WI_INT_5 = np.array([0.9901, 0.7223, 0.7223, 0.0277, 0.0277])
GI_INT_5 = np.full(5, 0.94)

RSNW_SNICAR_MIN = 30.0
RSNW_SNICAR_MAX = 1629.0


class SnicarSSP(NamedTuple):
    """Snow single-scattering properties vs grain radius, per band and
    sky type (numpy).  radii [nR]; ext (mass extinction, m^2/kg), ssa,
    asm: [2(sky: drc,dfs), 5, nR]."""
    radii: np.ndarray
    ext: np.ndarray
    ssa: np.ndarray
    asm_: np.ndarray


def _fallback_ssp() -> SnicarSSP:
    """Embedded geometric-optics fallback SSP table (used when the
    SNICAR optics NetCDF is not provided).  Mass extinction from
    Qext=2 spheres; band co-albedo grows ~sqrt(r) with per-band
    magnitudes matching SNICAR's published behavior (Flanner & Zender
    2006); diffuse sky slightly more absorptive in the NIR."""
    radii = np.array([30.0, 50.0, 100.0, 200.0, 400.0, 800.0, 1200.0,
                      RSNW_SNICAR_MAX])
    r_m = radii * 1e-6
    ext = 3.0 * 2.0 / (4.0 * 917.0 * r_m)          # [nR] m^2/kg
    ext = np.tile(ext, (2, NSPINT_5BD, 1))
    co_alb = np.array([5.0e-6, 1.0e-4, 6.0e-4, 6.0e-3, 3.0e-2])
    sq = np.sqrt(radii)[None, :]
    ssa_drc = np.clip(1.0 - co_alb[:, None] * sq, 0.45, 1.0 - 1e-7)
    ssa_dfs = np.clip(1.0 - 1.12 * co_alb[:, None] * sq, 0.45,
                      1.0 - 1e-7)
    ssa = np.stack([ssa_drc, ssa_dfs])
    g0 = 0.885 + 0.012 * np.arange(NSPINT_5BD)[:, None] / 4.0
    asm_ = np.clip(g0 + 0.01 * np.log10(radii / 100.0)[None, :],
                   0.84, 0.96)
    asm_ = np.stack([asm_, asm_ + 0.002])
    return SnicarSSP(radii=radii, ext=ext, ssa=ssa, asm_=asm_)


def load_snicar_ssp(path: str) -> SnicarSSP:
    """Read the reference's SNICAR optics NetCDF
    (snicar_optics_5bnd_snow_and_aerosols.nc: ss_alb_ice_drc/dfs,
    asm_prm_ice_drc/dfs, ext_cff_mss_ice_drc/dfs over 1471 radii from
    30 um in 1 um steps) with scipy."""
    from scipy.io import netcdf_file
    with netcdf_file(path, mmap=False) as ds:
        def v(name):
            return np.array(ds.variables[name][:], np.float64)

        ext = np.stack([v("ext_cff_mss_ice_drc"), v("ext_cff_mss_ice_dfs")])
        ssa = np.stack([v("ss_alb_ice_drc"), v("ss_alb_ice_dfs")])
        asm_ = np.stack([v("asm_prm_ice_drc"), v("asm_prm_ice_dfs")])
    n_r = ext.shape[-1]
    radii = np.arange(RSNW_SNICAR_MIN, RSNW_SNICAR_MIN + n_r)
    return SnicarSSP(radii=radii, ext=ext, ssa=ssa, asm_=asm_)


class SnicarTables(NamedTuple):
    """The SNICAR tables of one dtype/device: the snow SSPs (radii [nR]
    with its ends r_lo, r_hi as Python floats, ext/ssa/asm [2, 5, nR])
    and the exact 5-band aerosol optics (kaer, waer, gaer [5,
    n_species]) or None."""
    radii: torch.Tensor
    r_lo: float
    r_hi: float
    ext: torch.Tensor
    ssa: torch.Tensor
    asm_: torch.Tensor
    aer5: Optional[tuple] = None


def snicar_tables(dtype, device,
                  ssp: Optional[SnicarSSP] = None) -> SnicarTables:
    """The snow SSP table `ssp` (the embedded fallback when None) as
    tensors in dtype on device, without 5-band aerosol optics (the 3-band
    tables mapped onto the five bands; `ColumnPhysics.
    set_aerosol_optics_5bd` installs exact ones)."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
            device=device, dtype=dtype)
    ssp = ssp if ssp is not None else _fallback_ssp()
    return SnicarTables(t(ssp.radii), float(ssp.radii[0]),
                        float(ssp.radii[-1]), t(ssp.ext), t(ssp.ssa),
                        t(ssp.asm_))


def _mix_aerosol_5bd(tau, w0, g, mp, band, tables: SnicarTables,
                     aero: AerosolOptics):
    """5-band aerosol mixing: the exact tables when installed, else the
    3-band tables mapped onto the 5 bands."""
    if tables.aer5 is None:
        return _mix_aerosol(tau, w0, g, mp, _AER_BAND3[band], aero)
    kaer, waer, gaer = tables.aer5
    n_sp = mp.shape[-1]
    k_t = kaer[band, :n_sp]
    w_t = waer[band, :n_sp]
    g_t = gaer[band, :n_sp]
    return _mix(tau, w0, g, (mp * k_t).sum(-1), (mp * k_t * w_t).sum(-1),
                (mp * k_t * w_t * g_t).sum(-1))


def snow_ssp(grain_radius, band: int, sky: int, tables: SnicarTables):
    """Interpolated (ext, ssa, asm) for a grain-radius array."""
    rt = tables.radii
    n = rt.shape[0]
    r = grain_radius.clamp(tables.r_lo, tables.r_hi)
    idx = (torch.searchsorted(rt, r.contiguous()) - 1).clamp(0, n - 2)
    r0, r1 = rt[idx], rt[idx + 1]
    w = (r - r0) / (r1 - r0).clamp(min=1e-12)

    def interp(tab):
        a = tab[sky, band]
        return (1.0 - w) * a[idx] + w * a[idx + 1]

    return interp(tables.ext), interp(tables.ssa), interp(tables.asm_)


def shortwave_snicar(aicen, vicen, vsnon, Tsfcn, coszen,
                     swvdr, swvdf, swidr, swidf,
                     n_ice_layers: int, n_snow_layers: int = 1,
                     apnd=None, hpnd=None, rsnw=None,
                     aero_mp_snow=None, aero_mp_ice=None,
                     R_ice: float = 0.0, R_pnd: float = 0.0,
                     rhos_eff=None, tables: SnicarTables = None,
                     optics: DeddOptics = None,
                     aero: AerosolOptics = None):
    """5-band SNICAR shortwave for the snow-covered fraction, blended
    with the 3-band dEdd solution for bare/ponded ice (the reference's
    run_dEdd dispatch: compute_dEdd_5bd for fs, compute_dEdd for
    fi/fp).  Interface of shortwave_dedd.
    rhos_eff: optional effective snow density [*B, nCat, ns]
    (snow mass tracers); default rhos.  tables, optics, aero: from
    `snicar_tables`, `dedd_optics` and `aerosol_optics` (made here when
    None)."""
    from .shortwave import ShortwaveResult

    dtype, dev = aicen.dtype, aicen.device
    if tables is None:
        tables = snicar_tables(dtype, dev)
    if optics is None:
        optics = dedd_optics(dtype, dev)
    if aero is None and (aero_mp_snow is not None or
                         aero_mp_ice is not None):
        aero = aerosol_optics(dtype, dev)
    ni, ns_l = n_ice_layers, n_snow_layers
    has = aicen > c.PUNY
    safe_a = torch.where(has, aicen, 1.0)
    hi = torch.where(has, vicen / safe_a, 0.0).clamp(min=1e-4)
    hs = torch.where(has, vsnon / safe_a, 0.0)
    l_snow = hs >= HS_MIN_SW

    mu = coszen.clamp(min=0.01)
    if mu.ndim == aicen.ndim - 1:
        mu = mu[..., None] * torch.ones_like(aicen)

    fs = torch.where(l_snow, 1.0, torch.zeros_like(aicen))
    if apnd is not None:
        hp = hpnd.clamp(min=0.0)
        fp = torch.where(hp >= HPMIN, apnd.clamp(0.0, 1.0), 0.0)
        fs = torch.minimum(fs, 1.0 - fp)

    # bare/pond fractions via the 3-band solver with the snow rows
    # suppressed (vsnon -> 0): base = (1-fp)*bare + fp*pond.  The final
    # blend replaces fs of the bare part with the 5-band snow solution:
    #   final = base + fs * (snow5 - bare3)
    no_snow = torch.zeros_like(vsnon)
    common = dict(aero_mp_ice=aero_mp_ice, R_ice=R_ice, R_pnd=R_pnd,
                  optics=optics, aero=aero)
    base = shortwave_dedd(aicen, vicen, no_snow, Tsfcn, coszen, swvdr,
                          swvdf, swidr, swidf, ni, ns_l, apnd=apnd,
                          hpnd=hpnd, **common)
    bare3 = shortwave_dedd(aicen, vicen, no_snow, Tsfcn, coszen, swvdr,
                           swvdf, swidr, swidf, ni, ns_l, **common) \
        if apnd is not None else base

    # snow grain radius rows (tracer, else the SNICAR fresh radius)
    if rsnw is not None:
        r_rows = [rsnw[..., 0].clamp(RSNW_SNICAR_MIN, RSNW_SNICAR_MAX)] * 2 \
            + [rsnw[..., k].clamp(RSNW_SNICAR_MIN, RSNW_SNICAR_MAX)
               for k in range(1, ns_l)]
    else:
        r_rows = [torch.full_like(aicen, 100.0)] * (ns_l + 1)
    rhos_rows = [torch.full_like(aicen, c.RHOS)] * (ns_l + 1)
    if rhos_eff is not None:
        rhos_rows = [rhos_eff[..., 0]] * 2 + \
            [rhos_eff[..., k] for k in range(1, ns_l)]

    # layer thicknesses (same geometry as compute_dEdd)
    dz_s = hs / ns_l
    dzs_rows = [(dz_s / 2.0).clamp(max=HS_SSL)]
    dzs_rows.append(dz_s - dzs_rows[0])
    for _ in range(ns_l - 1):
        dzs_rows.append(dz_s)
    dz_i = hi / ni
    dzi_ssl = torch.minimum((hi / 30.0).clamp(max=HI_SSL), dz_i / 2.0)
    dzi_dl = dz_i - dzi_ssl
    fs_dl = 0.25 / ni
    kfrsnl = ns_l + 2
    K = ns_l + ni + 2

    def bsc(x):
        return x[..., None] * torch.ones_like(aicen) if \
            x.ndim == aicen.ndim - 1 else x

    def full(value):
        return torch.full_like(aicen, float(value))

    # per-band incident fluxes (visible band carries all the visible,
    # NIR bands split swidr/swidf with sky-specific weights)
    sw_b_dr = [bsc(swvdr)] + [bsc(swidr) * float(WGHT_DRC[b])
                              for b in range(1, 5)]
    sw_b_df = [bsc(swvdf)] + [bsc(swidf) * float(WGHT_DFS[b])
                              for b in range(1, 5)]

    zero = torch.zeros_like(aicen)
    abs_srf = zero
    abs_int = zero
    Isw = [zero] * ni
    Ssw = [zero] * ns_l
    fswthru = zero
    alvdr = alvdf = alidr = alidf = zero

    for b in range(NSPINT_5BD):
        ki_ssl, wi_ssl = _tune_iops(KI_SSL_5[b], WI_SSL_5[b], R_ice,
                                    FP_ICE, FM_ICE)
        ki_dl, wi_dl = _tune_iops(KI_DL_5[b], WI_DL_5[b], R_ice,
                                  FP_ICE, FM_ICE)
        ki_int, wi_int = _tune_iops(KI_INT_5[b], WI_INT_5[b], R_ice,
                                    FP_ICE, FM_ICE)
        for sky, fdr_b, fdf_b in ((0, sw_b_dr[b], zero),
                                  (1, zero, sw_b_df[b])):
            taus, w0s, gls = [], [], []
            for k in range(ns_l + 1):
                ks, ws_s, gs_s = snow_ssp(r_rows[k], b, sky, tables)
                taus.append(torch.where(
                    l_snow, ks * rhos_rows[k] * dzs_rows[k], 0.0))
                w0s.append(torch.where(l_snow, ws_s, 0.0))
                gls.append(torch.where(l_snow, gs_s, 0.0))
            taus += [ki_ssl * dzi_ssl, ki_dl * dzi_dl * fs_dl]
            w0s += [full(wi_ssl), full(wi_dl)]
            gls += [full(GI_SSL_5[b]), full(GI_DL_5[b])]
            for k in range(ni - 1):
                if b == 0 and k == ni - 2:
                    # bottom-algae absorption, visible band (fixed
                    # kalg*0.5 m optical depth; see dedd.KALG)
                    kabs = ki_int * (1.0 - wi_int) + KALG * 0.5 / dz_i
                    sig = ki_int * wi_int
                    taus.append((kabs + sig) * dz_i)
                    w0s.append((sig / (sig + kabs)).expand(aicen.shape))
                    gls.append(full(GI_INT_5[b]))
                else:
                    taus.append(ki_int * dz_i)
                    w0s.append(full(wi_int))
                    gls.append(full(GI_INT_5[b]))

            # bulk aerosol mixing (reference compute_dEdd_5bd aerosol
            # sections)
            if aero_mp_snow is not None:
                mps = torch.where(l_snow[..., None],
                                  aero_mp_snow[..., 0], 0.0)
                mpb = torch.where(l_snow[..., None],
                                  aero_mp_snow[..., 1], 0.0) / ns_l
                taus[0], w0s[0], gls[0] = _mix_aerosol_5bd(
                    taus[0], w0s[0], gls[0], mps, b, tables, aero)
                for k in range(1, ns_l + 1):
                    taus[k], w0s[k], gls[k] = _mix_aerosol_5bd(
                        taus[k], w0s[k], gls[k], mpb, b, tables, aero)
            if aero_mp_ice is not None:
                mpi_s = aero_mp_ice[..., 0]
                mpi_b = aero_mp_ice[..., 1] / ni
                k = ns_l + 1
                taus[k], w0s[k], gls[k] = _mix_aerosol_5bd(
                    taus[k], w0s[k], gls[k], mpi_s, b, tables, aero)
                for k in range(ns_l + 2, K):
                    taus[k], w0s[k], gls[k] = _mix_aerosol_5bd(
                        taus[k], w0s[k], gls[k], mpi_b, b, tables, aero)

            sol = solve_dedd_column(taus, w0s, gls, mu, kfrsnl,
                                    float(ALBOCN_DR[min(b, 2)]),
                                    float(ALBOCN_DF[min(b, 2)]))
            F = [sol["net_dn_dir"][k] * fdr_b +
                 sol["net_dn_dif"][k] * fdf_b for k in range(K + 1)]
            # snow-covered booking: ksrf = 1 (snow SSL to surface,
            # snow body to Sswabs, ice SSL+DL to Iswabs(1))
            abs_srf = abs_srf + fs * (F[0] - F[1])
            abs_int = abs_int + fs * (F[1] - F[K])
            fswthru = fswthru + fs * F[K]
            for k in range(ns_l):
                Ssw[k] = Ssw[k] + fs * (F[k + 1] - F[k + 2])
            Isw[0] = Isw[0] + fs * (F[ns_l + 1] - F[ns_l + 3])
            for k in range(ni - 1):
                Isw[k + 1] = Isw[k + 1] + \
                    fs * (F[ns_l + 3 + k] - F[ns_l + 4 + k])
            a_sky = sol["albedo_dr"] if sky == 0 else sol["albedo_df"]
            if b == 0:
                if sky == 0:
                    alvdr = alvdr + fs * a_sky
                else:
                    alvdf = alvdf + fs * a_sky
            else:
                if sky == 0:
                    alidr = alidr + fs * a_sky * float(WGHT_DRC[b])
                else:
                    alidf = alidf + fs * a_sky * float(WGHT_DFS[b])

    Iswabs = torch.stack(Isw, -1)
    Sswabs = torch.stack(Ssw, -1)

    def z(x):
        return torch.where(has, x, 0.0)

    def blend(snow5_x, base_x, bare3_x, extra_axis=False):
        f = fs[..., None] if extra_axis else fs
        return snow5_x + base_x - f * bare3_x

    return ShortwaveResult(
        alvdr=z(blend(alvdr, base.alvdr, bare3.alvdr)),
        alvdf=z(blend(alvdf, base.alvdf, bare3.alvdf)),
        alidr=z(blend(alidr, base.alidr, bare3.alidr)),
        alidf=z(blend(alidf, base.alidf, bare3.alidf)),
        fswsfc=z(blend(abs_srf, base.fswsfc, bare3.fswsfc)),
        fswint=z(blend(abs_int, base.fswint, bare3.fswint)),
        fswthru=z(blend(fswthru, base.fswthru, bare3.fswthru)),
        Iswabs=torch.where(
            has[..., None],
            blend(Iswabs, base.Iswabs, bare3.Iswabs,
                  extra_axis=True).clamp(min=0.0), 0.0),
        Sswabs=torch.where(has[..., None], Sswabs.clamp(min=0.0), 0.0),
        albin=z(alvdr), albsn=z(alvdf))
