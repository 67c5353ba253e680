"""Skeletal-layer biogeochemistry (reference `ice_algae.F90` skl mode +
`ice_zbgc.F90` / `ice_zbgc_shared.F90`).

Port of the JAX package's `column/bgc.py`.  The skeletal (bottom ~3 cm)
layer carries algal nitrogen and nutrient (nitrate, silicate) pools per
category; growth is limited by light and nutrients (Liebig minimum,
reference algal_dyn skl branch), with linear mortality returning
nitrogen to the nutrient pool and exchange with the ocean mixed layer
through the molecular sublayer.  Vectorized over [*B, nCat].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import constants as c

SK_L = 0.03          # skeletal layer thickness (m; reference sk_l)
MU_MAX = 1.44        # max specific growth (1/day; reference mu_max)
GROW_TMAX = 0.063    # temperature growth factor (1/degC)
K_NO3 = 1.0          # nitrate half-saturation (mmol/m^3)
K_SIO3 = 4.0         # silicate half-saturation
ALPHA_LIGHT = 0.8    # initial slope light limitation (per W/m^2)
MORT = 0.05          # linear mortality (1/day)
EXCHANGE_VEL = 7.2e-6  # ice-ocean nutrient exchange velocity (m/s)
R_SI_N = 1.8         # silicate:nitrogen uptake ratio
CHLA_N = 2.1         # chl-a to nitrogen mass ratio (mg chl / mmol N)


class SklBgcState(NamedTuple):
    algalN: torch.Tensor     # algal nitrogen [*B, nCat] (mmol N/m^2)
    NO3: torch.Tensor        # skeletal nitrate (mmol/m^3)
    SiO3: torch.Tensor       # skeletal silicate (mmol/m^3)


class SklBgcResult(NamedTuple):
    state: SklBgcState
    primary_production: torch.Tensor   # mmol N/m^2/s (cell mean)
    nitrate_flux_ocean: torch.Tensor   # mmol/m^2/s (+ to ocean)
    chlorophyll: torch.Tensor          # mg chl/m^2 (cell mean)


def init_skl_bgc(shape, dtype=torch.float64, device=None,
                 no3_ocean: float = 5.0,
                 sio3_ocean: float = 10.0) -> SklBgcState:
    return SklBgcState(
        algalN=torch.full(shape, 0.16, dtype=dtype, device=device),
        NO3=torch.full(shape, no3_ocean, dtype=dtype, device=device),
        SiO3=torch.full(shape, sio3_ocean, dtype=dtype, device=device))


def step_skl_bgc(dt, state: SklBgcState, aicen, vicen,
                 sw_through_ice, bottom_temperature,
                 no3_ocean, sio3_ocean) -> SklBgcResult:
    """One BGC step (reference skl algal_dyn structure):
    growth = mu_max * f(T) * min(light, NO3, SiO3 limitation).
    no3_ocean / sio3_ocean: tensors [*B, nCat] or numbers."""
    has = (aicen > c.PUNY) & (vicen > c.PUNY)
    day = 86400.0

    par = sw_through_ice.clamp(min=0.0)
    light_lim = 1.0 - torch.exp(-ALPHA_LIGHT * par)
    no3_lim = state.NO3 / (K_NO3 + state.NO3)
    sio3_lim = state.SiO3 / (K_SIO3 + state.SiO3)
    lim = torch.minimum(light_lim, torch.minimum(no3_lim, sio3_lim))
    f_t = torch.exp(GROW_TMAX * bottom_temperature.clamp(max=0.0))
    mu = MU_MAX / day * f_t * lim                 # 1/s

    growth = torch.where(has, mu * state.algalN, 0.0)      # mmolN/m2/s
    mort = torch.where(has, MORT / day * state.algalN, 0.0)
    algalN = (state.algalN + dt * (growth - mort)).clamp(min=0.0)

    # nutrient drawdown in the skeletal layer (concentration basis)
    dNO3_bio = (growth - mort) / SK_L                      # mmol/m3/s
    dSiO3_bio = growth * R_SI_N / SK_L
    # ocean exchange through the molecular sublayer
    ex = EXCHANGE_VEL / SK_L
    NO3 = state.NO3 + dt * (-dNO3_bio + ex * (no3_ocean - state.NO3))
    SiO3 = state.SiO3 + dt * (-dSiO3_bio + ex * (sio3_ocean - state.SiO3))
    NO3 = torch.where(has, NO3.clamp(min=0.0), no3_ocean)
    SiO3 = torch.where(has, SiO3.clamp(min=0.0), sio3_ocean)
    algalN = torch.where(has, algalN, 0.0)

    pp = (growth * aicen).sum(-1)
    no3_flux = (ex * (state.NO3 - no3_ocean) * SK_L * aicen).sum(-1)
    chl = (algalN * CHLA_N * aicen).sum(-1)
    return SklBgcResult(
        state=SklBgcState(algalN=algalN, NO3=NO3, SiO3=SiO3),
        primary_production=pp, nitrate_flux_ocean=no3_flux,
        chlorophyll=chl)
