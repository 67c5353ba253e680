"""Aerosol tracers in snow and ice (reference `ice_aerosol.F90`,
update_aerosol :29-440).

Port of the JAX package's `column/aerosol.py`.  Each aerosol species
carries four pools per category (the reference layout): snow surface
layer (ssl), snow interior, ice surface layer, ice interior (kg/m^2).
Deposition loads the snow ssl; melt at each surface moves aerosol along
with the melted thickness fraction, scaled by the species' scavenging
efficiency (kscav, reference values); bottom growth leaves pools
unchanged; pools riding on fully melted snow/ice flush to the ocean.
Vectorized over [*B, nCat, nAero, 4].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as c

# scavenging efficiencies per species class (reference kscavz /
# kscav for black carbon x2 and dust x4)
KSCAV_DEFAULT = np.array([0.03, 0.20, 0.02, 0.02, 0.01, 0.01])
HS_SSL = 0.04    # snow surface layer thickness (m; reference hs_ssl)
HI_SSL = 0.05    # ice surface layer thickness (m)

SNOW_SSL, SNOW_INT, ICE_SSL, ICE_INT = 0, 1, 2, 3


class AerosolResult(NamedTuple):
    aero: torch.Tensor       # [*B, nCat, nAero, 4]
    flux_ocn: torch.Tensor   # [*B, nAero] kg/m^2/s to the ocean


def update_aerosol(dt, aero, aicen, vicen, vsnon,
                   melts, meltt, meltb, congel, snoice, hsn_new,
                   faero_atm, kscav=None) -> AerosolResult:
    """One step of aerosol pool transfers (reference update_aerosol).

    aero [*B, nCat, nAero, 4] pools (kg/m^2, per unit ice area);
    melts/meltt/meltb/congel/snoice/hsn_new [*B, nCat] (m of
    snow/ice change this step); faero_atm [*B, nAero] deposition
    (kg/m^2/s, cell mean, distributed by category area); kscav: the
    scavenging efficiency per species, a tensor of aero's dtype on its
    device (`ColumnPhysics.kscav`; the reference's values by default)."""
    n_aero = aero.shape[-2]
    if kscav is None:
        kscav = torch.as_tensor(KSCAV_DEFAULT[:n_aero]).to(
            device=aero.device, dtype=aero.dtype)

    has = aicen > c.PUNY
    safe_a = torch.where(has, aicen, 1.0)
    hsn = torch.where(has, vsnon / safe_a, 0.0)
    hin = torch.where(has, vicen / safe_a, 0.0)
    a_w = aicen[..., None]
    pools = list(aero.unbind(-1))
    flux = torch.zeros(aero.shape[:-3] + (n_aero,), dtype=aero.dtype,
                       device=aero.device)

    def frac(d, h):
        return (d / h.clamp(min=c.PUNY)).clamp(0.0, 1.0)

    # deposition into the snow (or bare-ice) surface layer (:120-160)
    dep = faero_atm[..., None, :] * dt * \
        torch.ones_like(aicen)[..., None]            # [*B, nCat, nAero]
    to_snow = (hsn > c.PUNY)[..., None]
    pools[SNOW_SSL] = pools[SNOW_SSL] + torch.where(to_snow, dep, 0.0)
    pools[ICE_SSL] = pools[ICE_SSL] + torch.where(~to_snow, dep, 0.0)

    # snow melt: ssl depletes with the melted fraction of the ssl depth,
    # scavenged fraction leaves with meltwater (to the ice surface),
    # the rest migrates to the snow interior (:180-260 structure)
    f_melt_s = frac(melts, hsn.clamp(min=HS_SSL))[..., None]
    moved = pools[SNOW_SSL] * f_melt_s
    scav = moved * kscav
    pools[SNOW_SSL] = pools[SNOW_SSL] - moved
    pools[ICE_SSL] = pools[ICE_SSL] + scav
    pools[SNOW_INT] = pools[SNOW_INT] + (moved - scav)

    # ice top melt: ice ssl -> interior / ocean with scavenging
    f_melt_i = frac(meltt, hin.clamp(min=HI_SSL))[..., None]
    moved = pools[ICE_SSL] * f_melt_i
    scav = moved * kscav
    pools[ICE_SSL] = pools[ICE_SSL] - moved
    pools[ICE_INT] = pools[ICE_INT] + (moved - scav)
    flux = flux + (scav * a_w).sum(-2) / dt

    # bottom melt releases the proportional interior fraction (:300)
    f_bot = frac(meltb, hin)[..., None]
    released = pools[ICE_INT] * f_bot
    pools[ICE_INT] = pools[ICE_INT] - released
    flux = flux + (released * a_w).sum(-2) / dt

    # snow-ice formation moves snow interior aerosol into the ice ssl
    f_si = frac(snoice * c.RHOI / c.RHOS, hsn)[..., None]
    moved = pools[SNOW_INT] * f_si
    pools[SNOW_INT] = pools[SNOW_INT] - moved
    pools[ICE_SSL] = pools[ICE_SSL] + moved

    # pools on vanished snow/ice flush to the ocean
    for p, gone_mask in ((SNOW_SSL, hsn <= c.PUNY), (SNOW_INT, hsn <= c.PUNY),
                         (ICE_SSL, hin <= c.PUNY), (ICE_INT, hin <= c.PUNY)):
        gone = torch.where(gone_mask[..., None], pools[p], 0.0)
        pools[p] = pools[p] - gone
        flux = flux + (gone * a_w).sum(-2) / dt

    return AerosolResult(aero=torch.stack(pools, -1).clamp(min=0.0),
                         flux_ocn=flux)
