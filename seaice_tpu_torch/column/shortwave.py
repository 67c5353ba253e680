"""CCSM3 shortwave: thickness/temperature-dependent albedos and absorbed
solar partition (reference `ice_shortwave.F90`: shortwave_ccsm3 :74-258,
compute_albedos :264-394, absorbed_solar :496-662).  Port of the JAX
package's `column/shortwave.py`; vectorized over [*B, nCat] columns.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from . import constants as c

# namelist defaults (reference Registry.xml:1485-1503)
ALBICEV = 0.78      # visible ice albedo (h > ahmax)
ALBICEI = 0.36      # near-IR ice albedo
ALBSNOWV = 0.98     # cold snow albedo, visible
ALBSNOWI = 0.70     # cold snow albedo, near IR
AHMAX = 0.3         # thickness above which ice albedo is constant (m)
SNOWPATCH = 0.02
I0VIS = 0.70        # penetrating fraction of visible SW
KAPPAV = 1.4        # visible extinction coefficient in ice (1/m)
# broadband weights for diagnostics (ice_constants_colpkg.F90:92-95)
AWTVDR, AWTIDR, AWTVDF, AWTIDF = 0.00318, 0.00182, 0.63282, 0.36218

DT_MELT = 1.0
DALB_MLT = -0.075
DALB_MLTV = -0.1
DALB_MLTI = -0.15


class ShortwaveResult(NamedTuple):
    alvdr: torch.Tensor     # area-weighted albedos (vis/nir dr/df)
    alvdf: torch.Tensor
    alidr: torch.Tensor
    alidf: torch.Tensor
    fswsfc: torch.Tensor    # absorbed at surface (W/m^2)
    fswint: torch.Tensor    # absorbed in the interior
    fswthru: torch.Tensor   # transmitted to the ocean
    Iswabs: torch.Tensor    # absorbed per ice layer [*B, nCat, ni]
    Sswabs: torch.Tensor    # absorbed per snow layer (ccsm3: zero)
    albin: torch.Tensor     # bare-ice broadband albedo (diagnostic)
    albsn: torch.Tensor


def shortwave_ccsm3(aicen, vicen, vsnon, Tsfcn,
                    swvdr, swvdf, swidr, swidf,
                    n_ice_layers: int, n_snow_layers: int = 1,
                    albicev=ALBICEV, albicei=ALBICEI,
                    albsnowv=ALBSNOWV, albsnowi=ALBSNOWI,
                    ahmax=AHMAX) -> ShortwaveResult:
    """Albedos + absorbed-solar partition per category.

    aicen... [*B, nCat]; sw* [*B] broadcast over categories."""
    ni = n_ice_layers
    has = aicen > c.PUNY
    safe_a = torch.where(has, aicen, 1.0)
    hi = torch.where(has, vicen / safe_a, 0.0)
    hs = torch.where(has, vsnon / safe_a, 0.0)

    # -- albedos (compute_albedos :264-394) --
    fhtan = math.atan(ahmax * 4.0)
    fh = (torch.arctan(hi * 4.0) / fhtan).clamp(max=1.0)
    albo = c.ALBOCN * (1.0 - fh)
    alvdfni = albicev * fh + albo
    alidfni = albicei * fh + albo
    dTs = c.TIMELT - Tsfcn
    fT = (dTs / DT_MELT - 1.0).clamp(max=0.0)
    alvdfni = (alvdfni - DALB_MLT * fT).clamp(min=c.ALBOCN)
    alidfni = (alidfni - DALB_MLT * fT).clamp(min=c.ALBOCN)
    has_snow = hs > c.PUNY
    alvdfns = torch.where(has_snow, albsnowv - DALB_MLTV * fT, 0.0)
    alidfns = torch.where(has_snow, albsnowi - DALB_MLTI * fT, 0.0)
    alvdrni, alidrni = alvdfni, alidfni
    alvdrns, alidrns = alvdfns, alidfns
    asnow = torch.where(has_snow, hs / (hs + SNOWPATCH), 0.0)

    alvdf = alvdfni * (1.0 - asnow) + alvdfns * asnow
    alidf = alidfni * (1.0 - asnow) + alidfns * asnow
    alvdr = alvdrni * (1.0 - asnow) + alvdrns * asnow
    alidr = alidrni * (1.0 - asnow) + alidrns * asnow
    albin = (AWTVDR * alvdrni + AWTIDR * alidrni +
             AWTVDF * alvdfni + AWTIDF * alidfni)
    albsn = (AWTVDR * alvdrns + AWTIDR * alidrns +
             AWTVDF * alvdfns + AWTIDF * alidfns)

    # -- absorbed solar (absorbed_solar :496-662) --
    def bcast(sw):
        return sw[..., None] if sw.ndim == aicen.ndim - 1 else sw

    swvdr_b, swvdf_b = bcast(swvdr), bcast(swvdf)
    swidr_b, swidf_b = bcast(swidr), bcast(swidf)

    swabsv = (swvdr_b * ((1.0 - alvdrni) * (1.0 - asnow) +
                         (1.0 - alvdrns) * asnow) +
              swvdf_b * ((1.0 - alvdfni) * (1.0 - asnow) +
                         (1.0 - alvdfns) * asnow))
    swabsi = (swidr_b * ((1.0 - alidrni) * (1.0 - asnow) +
                         (1.0 - alidrns) * asnow) +
              swidf_b * ((1.0 - alidfni) * (1.0 - asnow) +
                         (1.0 - alidfns) * asnow))
    swabs = swabsv + swabsi
    fswpen = (swvdr_b * (1.0 - alvdrni) * (1.0 - asnow) +
              swvdf_b * (1.0 - alvdfni) * (1.0 - asnow)) * I0VIS
    fswsfc = swabs - fswpen

    hilyr = hi / ni
    Isw = []
    trantop = torch.ones_like(hi)
    tranbot = trantop
    for k in range(1, ni + 1):
        tranbot = torch.exp(-KAPPAV * hilyr * k)
        Isw.append(fswpen * (trantop - tranbot))
        trantop = tranbot
    Iswabs = torch.stack(Isw, -1)
    fswthru = fswpen * tranbot
    fswint = fswpen - fswthru

    def z(x):
        return torch.where(has, x, 0.0)

    return ShortwaveResult(
        alvdr=alvdr, alvdf=alvdf, alidr=alidr, alidf=alidf,
        fswsfc=z(fswsfc), fswint=z(fswint), fswthru=z(fswthru),
        Iswabs=torch.where(has[..., None], Iswabs, 0.0),
        Sswabs=torch.zeros(aicen.shape + (n_snow_layers,),
                           dtype=aicen.dtype, device=aicen.device),
        albin=albin, albsn=albsn)
