"""Brine height dynamics (tr_brine / hbrine).

Port of the JAX package's `column/brine.py`, its re-design of
`ice_brine.F90`: `preflushing_changes` (:46-130), `compute_microS_mushy`
(:139-324), `prepare_hbrine` (:328-448), `update_hbrine` (:463-581) and
`calculate_drho` (:843-945).  The brine-height tracer fbri = hbr/hin
tracks the brine surface relative to the ice bottom; its dynamics
(growth/melt forcing, Darcy relaxation toward sea level through the
permeable mush) feed the vertical salinity/bio transport diffusivities.
All per-cell scalar code is dense [*B, nCat] selects; the vertical bio
grid (nblyr layers) is a static dimension, its weights Python floats or
one small tensor made where the `ColumnPhysics` is built (`BrineGrid`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import constants as c

# reference ice_brine.F90:22-31
MAXHBR = 1.25
VISCOS = 2.1e-6
A1, A2, A3 = -21.4, -0.886, -0.012     # brine_sal(T) cubic
B1, B2 = 1000.0, 0.8                   # brine_rho(S) linear
# reference ice_zbgc_shared.F90:114-133
EXP_H = 3.0
K_O = 3.0e-8
THINS = 0.05
VISCOS_DYNAMIC = 2.2
DM_MOLECULAR = 1.0e-9
RA_C = 0.05
L_SK = 7.0                # skeletal scale length (m^-1; namelist l_sk)
RHOSI = 940.0             # reference ice_colpkg_shared.F90:459
MIN_SALIN = 0.1
DH_MIN = 0.001


def bio_grids(nblyr: int):
    """The nondimensional bio grids (reference colpkg_init_hbrine,
    ice_colpkg.F90:5825-5842): bgrid [nblyr+2] midpoints with
    boundary rows, igrid [nblyr+1] interfaces."""
    zspace = 1.0 / max(1, nblyr)
    bgrid = np.zeros(nblyr + 2)
    bgrid[-1] = 1.0
    for k in range(1, nblyr + 1):
        bgrid[k] = zspace * (k - 0.5)
    igrid = np.zeros(nblyr + 1)
    igrid[-1] = 1.0
    for k in range(1, nblyr):
        igrid[k] = 0.5 * (bgrid[k + 1] + bgrid[k])
    return bgrid, igrid


class BrineGrid(NamedTuple):
    """The static bio grid of nblyr layers: bgrid, igrid (numpy) and the
    interior rows' igrid spacing `dig` [nblyr] as a tensor in the
    column's dtype on its device (the mean ice density's weights)."""
    bgrid: np.ndarray
    igrid: np.ndarray
    dig: torch.Tensor


def brine_grid(nblyr: int, dtype, device) -> BrineGrid:
    bgrid, igrid = bio_grids(nblyr)
    dig = np.diff(np.concatenate([[0.0], igrid[1:]]))
    return BrineGrid(bgrid, igrid, torch.as_tensor(dig).to(
        device=device, dtype=dtype))


class PreflushResult(NamedTuple):
    hin: torch.Tensor
    hsn: torch.Tensor
    hin_old: torch.Tensor
    dhice: torch.Tensor
    dhbr_top: torch.Tensor
    dhbr_bot: torch.Tensor
    hbr_old: torch.Tensor


def preflushing_changes(aicen, vicen, vsnon, meltb, meltt, congel,
                        snoice, hice_old, fbri) -> PreflushResult:
    """Brine-surface forcing from this step's growth/melt
    (reference preflushing_changes :46-130)."""
    has = aicen > c.PUNY
    safe = torch.where(has, aicen, 1.0)
    hin = torch.where(has, vicen / safe, 0.0)
    hsn = torch.where(has, vsnon / safe, 0.0)
    hin_old = (hin + meltb + meltt - congel - snoice).clamp(min=0.0)
    dhice = hin_old - hice_old           # sublimation/condensation
    dhbr_top = meltt - snoice - dhice
    dhbr_bot = congel - meltb
    hbr_old = fbri * hice_old
    return PreflushResult(hin=hin, hsn=hsn, hin_old=hin_old,
                          dhice=dhice, dhbr_top=dhbr_top,
                          dhbr_bot=dhbr_bot, hbr_old=hbr_old)


def remap_profile_to_bgrid(profile, src_pts: np.ndarray,
                           dst_pts: np.ndarray, surface_value):
    """Map a CICE-grid vertical profile onto the bio grid by linear
    interpolation in normalized depth (reference remap_zbgc with equal
    heights).  profile [*B, nSrc]; returns [*B, nDst].  The weights come
    from the static grid points on the host, never from tensor data."""
    src = np.asarray(src_pts)
    dst = np.asarray(dst_pts)
    n_src = len(src)
    out = []
    for zd in dst:
        i1 = int(np.searchsorted(src, zd))
        if i1 == 0:
            # above the top source point: blend toward surface value
            w = float(zd / max(src[0], 1e-12))
            out.append((1.0 - w) * surface_value + w * profile[..., 0])
        elif i1 >= n_src:
            out.append(profile[..., n_src - 1])
        else:
            w = float((zd - src[i1 - 1]) /
                      max(src[i1] - src[i1 - 1], 1e-12))
            out.append((1.0 - w) * profile[..., i1 - 1] +
                       w * profile[..., i1])
    return torch.stack(out, -1)


class MicroSResult(NamedTuple):
    bSin: torch.Tensor        # [*B, nblyr+2] bulk salinity on bgrid
    bTin: torch.Tensor        # temperature on bgrid
    bphin: torch.Tensor       # porosity on bgrid
    brine_sal: torch.Tensor   # equilibrium brine salinity
    brine_rho: torch.Tensor   # brine density
    iphin: torch.Tensor       # [*B, nblyr+1] porosity on igrid
    iTin: torch.Tensor
    ibrine_sal: torch.Tensor
    ibrine_rho: torch.Tensor
    kperm: torch.Tensor       # [*B] harmonic average permeability
    bphi_min: torch.Tensor    # [*B] surface porosity
    sice_rho: torch.Tensor    # [*B] mean ice density
    iDin: torch.Tensor        # [*B, nblyr+1] diffusivity / h^2 (1/s)


def _set_last(x, value):
    """x with its last entry on the trailing axis set to value."""
    x = x.clone()
    x[..., -1] = value
    return x


def _prepare_hbrine(bSin, bTin, igrid, dig: Optional[torch.Tensor] = None):
    """Brine salinity/density/porosity/permeability from the bulk state
    (reference prepare_hbrine :328-448).  bSin/bTin [*B, nblyr+2]
    (rows 1..nblyr are interior; row 0 mirrors row 1; last row is the
    ocean); dig: `BrineGrid.dig` (made here when None)."""
    nblyr = bSin.shape[-1] - 2
    brine_sal = A1 * bTin + A2 * bTin ** 2 + A3 * bTin ** 3
    brine_rho = B1 + B2 * brine_sal
    bphin = (bSin * RHOSI /
             (brine_sal * brine_rho).clamp(min=c.PUNY)).clamp(c.PUNY, 1.0)
    # ocean row
    brine_rho = _set_last(brine_rho, c.RHOW)
    bphin = _set_last(bphin, 1.0)

    kin = K_O * bphin ** EXP_H                      # [*B, nblyr+2]
    # mean ice density over the interior rows, weighted by igrid spacing
    if dig is None:
        dig = torch.as_tensor(np.diff(np.concatenate(
            [[0.0], igrid[1:]]))).to(device=bSin.device, dtype=bSin.dtype)
    interior = bphin[..., 1:nblyr + 2]
    rho_rows = (c.RHOI * (1.0 - interior[..., :nblyr + 1]) +
                brine_rho[..., 1:nblyr + 2] * interior[..., :nblyr + 1])
    sice_rho = (rho_rows[..., :dig.shape[0]] * dig).sum(-1)

    # interface values (igrid-weighted means of adjacent rows)
    def iface(b):
        out = [b[..., 1]]
        for k in range(1, nblyr):
            igrp = float(igrid[k + 1] - igrid[k])
            igrm = float(igrid[k] - igrid[k - 1])
            rigr = float(1.0 / (igrid[k + 1] - igrid[k - 1]))
            out.append((b[..., k + 1] * igrp + b[..., k] * igrm) * rigr)
        out.append(b[..., nblyr])
        return torch.stack(out, -1)

    ibrine_sal = _set_last(iface(brine_sal), brine_sal[..., -1])
    ibrine_rho = _set_last(iface(brine_rho), brine_rho[..., -1])
    iTin = iface(bTin)
    iphin = iface(bphin).clamp(c.PUNY, 1.0)

    # harmonic mean permeability over interior layers 2..nblyr+1
    k_int = kin[..., 1:nblyr + 1]
    k_min = k_int.amin(-1)
    kperm = torch.where(
        k_min > 0.0,
        nblyr / (1.0 / k_int.clamp(min=1e-30)).sum(-1).clamp(min=c.PUNY),
        0.0)
    bphi_min = bphin[..., 0]
    return (brine_sal, brine_rho, bphin, iphin, iTin, ibrine_sal,
            ibrine_rho, kperm, bphi_min, sice_rho)


def _calculate_drho(brine_rho, ibrine_rho, bgrid, igrid):
    """Unstable brine density difference about each interface
    (reference calculate_drho :843-945): destabilizing density excess
    of the column above each interface relative to below, which drives
    gravity drainage."""
    nblyr = ibrine_rho.shape[-1] - 1
    ig = [float(v) for v in np.asarray(igrid)]
    bg = [float(v) for v in np.asarray(bgrid)]
    # rho_a[k]: mean brine density above igrid[k] (cumulative trapezoid)
    rho_a = [brine_rho[..., 1]]
    acc = brine_rho[..., 1] * bg[1] + \
        (ibrine_rho[..., 1] + brine_rho[..., 1]) * 0.5 * (ig[1] - bg[1])
    rho_a.append(acc / max(ig[1], 1e-12))
    for k in range(2, nblyr):
        acc = rho_a[-1] * ig[k - 1] + \
            (ibrine_rho[..., k - 1] + brine_rho[..., k]) * 0.5 * \
            (bg[k] - ig[k - 1]) + \
            (ibrine_rho[..., k] + brine_rho[..., k]) * 0.5 * \
            (ig[k] - bg[k])
        rho_a.append(acc / max(ig[k], 1e-12))
    acc = rho_a[-1] * ig[nblyr - 1] + \
        (ibrine_rho[..., nblyr - 1] + brine_rho[..., nblyr]) * 0.5 * \
        (bg[nblyr] - ig[nblyr - 1]) + \
        brine_rho[..., nblyr] * (ig[nblyr] - bg[nblyr])
    rho_a.append(acc / max(ig[nblyr], 1e-12))
    rho_a = torch.stack(rho_a[:nblyr + 1], -1)      # [*B, nblyr+1]

    # rho_2a[k]: mean density over twice the depth (reference mstop
    # logic: rho_a at 2k if inside the ice, else blend with ocean)
    rows = []
    for k in range(nblyr + 1):
        if k == 0:
            rows.append(rho_a[..., 0])
        else:
            m = 2 * k
            if m < nblyr + 1:
                rows.append(rho_a[..., m])
            else:
                rows.append((rho_a[..., nblyr] + c.RHOW *
                             (2.0 * ig[k] - 1.0)) * 0.5 /
                            max(ig[k], 1e-12))
    rho_2a = torch.stack(rows, -1)
    rho_b = torch.cat([brine_rho[..., 1:2], brine_rho[..., 1:nblyr + 1]],
                      -1)
    rho_2b = brine_rho[..., 1:nblyr + 2]
    return torch.maximum(
        rho_b - rho_2b,
        torch.maximum(2.0 * (rho_a - rho_2a),
                      2.0 * (brine_rho[..., :nblyr + 1] -
                             brine_rho[..., 1:nblyr + 2]) / nblyr
                      ).clamp(min=0.0))


def compute_micro_s_mushy(zqin, zSin, sss, sst, hbr_old, nblyr: int,
                          grid: Optional[BrineGrid] = None) -> MicroSResult:
    """Brine microstructure from the mushy thermodynamic state
    (reference compute_microS_mushy :139-324): remap S/q onto the bio
    grid, mushy T/phi relations, brine salinity/density, interface
    values, permeability and the gravity-drainage diffusivity iDin.
    grid: `brine_grid(nblyr, ...)` (made here when None)."""
    from .mushy import temperature_mush
    ni = zqin.shape[-1]
    if grid is None:
        grid = brine_grid(nblyr, zqin.dtype, zqin.device)
    bgrid, igrid = grid.bgrid, grid.igrid
    cgrid = np.array([(k - 0.5) / ni for k in range(1, ni + 1)])

    bS_int = remap_profile_to_bgrid(zSin, cgrid, bgrid[1:nblyr + 1],
                                    MIN_SALIN)
    bq_int = remap_profile_to_bgrid(zqin, cgrid, bgrid[1:nblyr + 1], 0.0)
    bS_int = bS_int.clamp(min=0.01)
    bq_int = bq_int.clamp(max=0.0)
    bT_int = temperature_mush(bq_int, bS_int)
    bSin = torch.cat([bS_int[..., :1], bS_int, sss[..., None]], -1)
    bTin = torch.cat([bT_int[..., :1], bT_int, sst[..., None]], -1)

    (brine_sal, brine_rho, bphin, iphin, iTin, ibrine_sal, ibrine_rho,
     kperm, bphi_min, sice_rho) = _prepare_hbrine(bSin, bTin, igrid,
                                                  grid.dig)

    drho = _calculate_drho(brine_rho, ibrine_rho, bgrid, igrid)
    ikin = K_O * iphin ** EXP_H
    hbr2 = hbr_old.clamp(min=c.PUNY)[..., None] ** 2
    iDin = iphin * DM_MOLECULAR / hbr2
    convect = (hbr_old >= RA_C)[..., None]
    iDin = iDin + torch.where(
        convect, L_SK * ikin * c.GRAVIT / VISCOS_DYNAMIC * drho / hbr2, 0.0)
    # top interface has no flux
    iDin = iDin.clone()
    iDin[..., 0] = 0.0

    return MicroSResult(
        bSin=bSin, bTin=bTin, bphin=bphin, brine_sal=brine_sal,
        brine_rho=brine_rho, iphin=iphin, iTin=iTin,
        ibrine_sal=ibrine_sal, ibrine_rho=ibrine_rho, kperm=kperm,
        bphi_min=bphi_min, sice_rho=sice_rho, iDin=iDin)


class HbrineResult(NamedTuple):
    hbr: torch.Tensor
    fbri: torch.Tensor
    darcy_v: torch.Tensor
    dhS_top: torch.Tensor
    dhS_bottom: torch.Tensor
    dh_direct: torch.Tensor   # surface flooding (<0) or runoff (>0)


def update_hbrine(dt, meltb, meltt, melts, hin, hsn, hin_old,
                  hbr_old, snoice, dhS_bottom, kperm, bphin_top,
                  aice0) -> HbrineResult:
    """Advance the brine height (reference update_hbrine :463-581):
    top/bottom forcing from melt/growth, then exponential Darcy
    relaxation of the brine surface toward sea level through the
    permeable column."""
    h_ocn = RHOSI / c.RHOW * hin + c.RHOS / c.RHOW * hsn
    thick = (hbr_old > THINS) & (hin_old > THINS) & (hin > THINS)

    # --- thick branch ---
    dhS_top_t = -torch.minimum(hin_old - hbr_old, meltt).clamp(
        min=0.0) * c.RHOI / c.RHOW
    dhS_top_t = dhS_top_t - melts.clamp(min=0.0) * c.RHOS / c.RHOW
    dhbr = dhS_bottom - dhS_top_t
    hbr_t = (hbr_old + dhbr).clamp(min=c.PUNY)
    hbrocn = hbr_t - h_ocn
    darcy_coeff = (kperm * c.GRAVIT /
                   (VISCOS * hbr_old.clamp(min=c.PUNY))).clamp(min=0.0)
    bphi = bphin_top.clamp(min=c.PUNY)
    decay = torch.exp(-darcy_coeff / bphi * dt)

    # brine above sea level: runoff + drainage
    above = (hbrocn > 0.0) & (hbr_t > THINS)
    dhrunoff = -dhS_top_t * aice0
    hbrocn_a = (hbrocn - dhrunoff).clamp(min=0.0)
    hbrocn_new_a = hbrocn_a * decay
    hbr_a = (h_ocn + hbrocn_new_a).clamp(min=THINS)
    hbrocn_new_a = hbr_a - h_ocn
    darcy_a = -torch.sign(hbrocn) * (hbrocn_a - hbrocn_new_a) / dt * bphi
    dhS_top_a = dhS_top_t - darcy_a * dt / bphi + dhrunoff

    # brine below sea level: flooding
    below = (hbrocn < 0.0) & (hbr_t > THINS)
    hbrocn_new_b = hbrocn * decay
    dhflood = (hbrocn_new_b - hbrocn).clamp(min=0.0) * aice0
    hbr_b = (h_ocn + hbrocn_new_b).clamp(min=THINS)
    darcy_b = -torch.sign(hbrocn) * \
        (hbrocn - hbrocn_new_b + dhflood) / dt * bphi
    dhS_top_b = dhS_top_t - darcy_b * dt / bphi - dhflood

    hbr_thick = torch.where(above, hbr_a, torch.where(below, hbr_b, hbr_t))
    darcy_thick = torch.where(above, darcy_a,
                              torch.where(below, darcy_b, 0.0))
    dhS_top_thick = torch.where(above, dhS_top_a,
                                torch.where(below, dhS_top_b, dhS_top_t))
    dh_direct = torch.where(above, dhrunoff,
                            torch.where(below, -dhflood, 0.0))

    # --- thin branch (:561-576) ---
    hbrmin = hin.clamp(max=THINS)
    hbr_thin = torch.maximum(hbrmin, hbr_old + dhS_bottom - dhS_top_t)
    dhbr_hin = hbr_thin - h_ocn
    hbr_thin = torch.where(
        dhbr_hin.abs() > DH_MIN,
        torch.maximum(hbrmin, h_ocn + torch.sign(dhbr_hin) * DH_MIN),
        hbr_thin)
    dhS_top_thin = hbr_old - hbr_thin + dhS_bottom

    hbr = torch.where(thick, hbr_thick, hbr_thin)
    darcy_v = torch.where(thick, darcy_thick, 0.0)
    dhS_top = torch.where(thick, dhS_top_thick, dhS_top_thin)
    dh_dir = torch.where(thick, dh_direct, 0.0)
    fbri = hbr / hin.clamp(min=c.PUNY)
    return HbrineResult(hbr=hbr, fbri=fbri, darcy_v=darcy_v,
                        dhS_top=dhS_top, dhS_bottom=dhS_bottom,
                        dh_direct=dh_dir)
