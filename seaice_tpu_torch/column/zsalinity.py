"""Prognostic vertical salinity (solve_zsal, ktherm=1 companion).

Port of the JAX package's `column/zsalinity.py`, its re-design of
`ice_zsalinity.F90` (`zsalinity` :38-182 -> `solve_zsalinity` :188-425
-> `solve_S_dt` :435-885): the bulk salinity on the bio grid evolves by
gravity drainage (the Rayleigh-number-gated convective diffusivity iDin
from `brine.py`), Darcy flushing, and exchange with the ocean at the
brine bottom; growth entrains ocean salt scaled by (1 - salt_loss).

One batched implicit advection-diffusion Thomas solve per sub-step over
[cells, categories], positivity by the min_salin floor with the clipped
salt booked into the ocean flux.  Sub-stepping is adaptive per column:
each column takes n_eff = ceil(dt * rate) sub-steps of dt/n_eff, capped
at N_SUBSTEPS_MAX; the loop always runs N_SUBSTEPS_MAX iterations with
finished columns frozen by a mask, so no count is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import constants as c
from .brine import MIN_SALIN
from .zbgc import _thomas

SALT_LOSS = 0.4          # fraction of ocean salt retained on growth
                         # (reference ice_colpkg_shared.F90:46)
N_SUBSTEPS_MAX = 8       # cap on adaptive sub-steps per coupling step


class ZsalResult(NamedTuple):
    bSin: torch.Tensor       # [*B, nblyr] bulk salinity on bio layers
    fzsal: torch.Tensor      # total salt flux to ocean (kg/m^2/s)
    fzsal_g: torch.Tensor    # gravity-drainage component alone
    zsal_tot: torch.Tensor   # total column salt (kg/m^2)


def solve_zsalinity(dt, bSin, iphin, iDin, darcy_v, hbr, hbr_old,
                    dh_bot, dh_top, sss, brine_sal_bottom) -> ZsalResult:
    """Advance the vertical bulk salinity (reference solve_zsalinity /
    solve_S_dt).

    bSin [*B, nblyr] bulk salinity (ppt) on the interior bio layers;
    iphin/iDin [*B, nblyr+1] on the interface grid; darcy_v [*B]
    (m/s); hbr/hbr_old [*B]; dh_bot/dh_top [*B] brine-boundary motion
    (+growth / -melt at the bottom; top melt <0); sss [*B];
    brine_sal_bottom [*B] equilibrium brine salinity at the bottom."""
    nblyr = bSin.shape[-1]
    dx = 1.0 / nblyr
    hbr_s = hbr.clamp(min=c.PUNY)

    # nondimensional velocities
    w = darcy_v / iphin[..., nblyr // 2].clamp(min=c.PUNY) / hbr_s
    growth_vel = dh_bot.clamp(min=0.0) / dt / hbr_s
    melt_vel = (-dh_bot).clamp(min=0.0) / dt / hbr_s

    # adaptive per-column sub-stepping: resolve the fastest local rate
    # (diffusion + advection + bottom exchange) at about one e-folding
    # per sub-step, capped at N_SUBSTEPS_MAX
    Dif_all = 0.5 * (iDin[..., :nblyr] + iDin[..., 1:nblyr + 1])
    rate = (Dif_all.amax(-1) / dx ** 2 + w.abs() / dx +
            2.0 * iDin[..., nblyr] / dx ** 2 +
            (growth_vel + melt_vel) / dx)
    n_eff = torch.ceil(dt * rate).clamp(1.0, float(N_SUBSTEPS_MAX))
    dts = dt / n_eff                       # per-column sub-step [*B]

    S = bSin
    fzsal = torch.zeros(bSin.shape[:-1], dtype=bSin.dtype,
                        device=bSin.device)
    fzsal_g = torch.zeros_like(fzsal)
    # ocean-entrained salinity on growth: (1-salt_loss) * ocean brine
    S_entrain = (1.0 - SALT_LOSS) * sss
    to_flux = dx * hbr_s * c.RHOI * 1.0e-3 / dt   # nondim -> kg/m^2/s
    wp = w.clamp(min=0.0)
    wm = (-w).clamp(min=0.0)
    ex_bot = 2.0 * iDin[..., nblyr] / dx ** 2

    # the tridiagonal rows do not change between sub-steps
    lo = torch.zeros_like(S)
    di = torch.ones_like(S)
    up = torch.zeros_like(S)
    src = torch.zeros_like(S)
    for k in range(nblyr):
        d_dn = Dif_all[..., k] / dx ** 2 if k < nblyr - 1 else 0.0
        d_up = Dif_all[..., k - 1] / dx ** 2 if k > 0 else 0.0
        a_dn = wm / dx if k < nblyr - 1 else 0.0
        a_up = wp / dx if k > 0 else 0.0
        diag = 1.0 + dts * (d_dn + d_up + a_dn + a_up)
        if k == nblyr - 1:
            # bottom: gravity-drainage exchange with the ocean +
            # growth entrainment + melt loss
            ex = ex_bot + wp / dx + growth_vel / dx + melt_vel / dx
            diag = diag + dts * ex
            src[..., k] = dts * ((ex_bot + wp / dx) * sss +
                                 growth_vel / dx * S_entrain)
        di[..., k] = diag
        if k > 0:
            lo[..., k] = -dts * (d_up + a_up)
        if k < nblyr - 1:
            up[..., k] = -dts * (d_dn + a_dn)

    for isub in range(N_SUBSTEPS_MAX):
        active = isub < n_eff              # [*B] bool
        S_new = _thomas(lo, di, up, S + src)
        # columns past their adaptive sub-step count are frozen
        S_new = torch.where(active[..., None], S_new, S)
        # salt budget: ocean flux from the change (kg/m^2/s); bulk
        # salinity S [ppt] * rho_si ~ g salt / m^3 * 1e-3
        dsalt = ((S_new - S) * dx).sum(-1) * hbr_s * \
            c.RHOI * 1.0e-3                  # kg/m^2 per substep
        fzsal = fzsal - dsalt / dt
        # gravity-drainage component alone (the implicit bottom
        # molecular-sublayer exchange evaluated at the new state)
        gd = torch.where(active, ex_bot * (S_new[..., -1] - sss) * dts, 0.0)
        fzsal_g = fzsal_g + gd * to_flux
        S = S_new

    # min_salin floor; clipped salt comes from the ocean
    S_f = S.clamp(min=MIN_SALIN)
    fzsal = fzsal - ((S_f - S) * dx).sum(-1) * hbr_s * \
        c.RHOI * 1.0e-3 / dt
    zsal_tot = (S_f * dx).sum(-1) * hbr_s * c.RHOI * 1.0e-3
    return ZsalResult(bSin=S_f, fzsal=fzsal, fzsal_g=fzsal_g,
                      zsal_tot=zsal_tot)
