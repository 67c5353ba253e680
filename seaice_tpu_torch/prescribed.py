"""Prescribed (data) ice mode.

The port of the JAX package's `prescribed.py`, itself a re-design of
MPAS-Seaice `mpas_seaice_prescribed.F` (seaice_run_prescribed_ice
:128-320): impose observed ice coverage on the state each step, the CIME
`_MPASSI%PRES` compset behaviour.  The reference's per-cell branching
becomes masked dense updates, one category at a time; nothing here waits
for the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .column import constants as c
from .column.thermo_shared import (ice_enthalpy_from_temperature,
                                   melting_temperature, salinity_profile,
                                   snow_enthalpy_from_temperature)

COVERAGE_MIN = 1.0e-4


def prescribe_ice_state(tracers: Dict[str, torch.Tensor], ice_coverage,
                        lat_cell, sea_freezing_temperature,
                        hin_max: np.ndarray) -> Dict[str, torch.Tensor]:
    """Impose `ice_coverage` [nCells] on the category state.

    Northern hemisphere prescribed thickness 2 m, southern 1 m
    (reference :215-224); the matching thickness category receives all
    the area; other categories are zeroed.  Enthalpy and salinity
    profiles are initialized where previously unset.  hin_max: the
    category bounds (numpy, nCat + 1)."""
    tr = dict(tracers)
    aicen = tr["iceAreaCategory"]
    ncat = aicen.shape[-1]
    ni = tr["iceEnthalpy"].shape[-1]
    ns = tr["snowEnthalpy"].shape[-1]
    dtype, device = aicen.dtype, aicen.device

    cov = torch.where(ice_coverage < COVERAGE_MIN, 0.0,
                      ice_coverage).clamp(0.0, 1.0)
    has_cov = cov >= COVERAGE_MIN
    h_presc = torch.where(lat_cell >= 0.0, 2.0, torch.ones_like(cov))

    sprof = torch.as_tensor(salinity_profile(ni)).to(device=device,
                                                     dtype=dtype)
    tf = sea_freezing_temperature
    k = (torch.arange(ni, dtype=dtype, device=device) + 0.5) / ni

    new = {name: [] for name in (
        "iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory",
        "surfaceTemperature", "iceEnthalpy", "iceSalinity",
        "snowEnthalpy")}
    for n in range(ncat):
        in_cat = has_cov & (h_presc >= float(hin_max[n])) & \
            (h_presc < float(hin_max[n + 1]))
        a_old = aicen[..., n]
        hs_old = torch.where(
            a_old > 0.0, tr["snowVolumeCategory"][..., n] /
            torch.where(a_old > 0, a_old, 1.0), 0.0)
        a_new = torch.where(in_cat, cov, 0.0)
        v_new = torch.where(in_cat, h_presc * cov, 0.0)
        vs_new = torch.where(in_cat, hs_old * cov, 0.0)

        tsf_old = tr["surfaceTemperature"][..., n]
        tsf = torch.where(in_cat, torch.where(a_old < c.PUNY, tf, tsf_old),
                          tf)
        # initialize profiles where enthalpy was unset (reference
        # :230-250): linear temperature gradient surface -> freezing
        q_old = tr["iceEnthalpy"][..., n, :]
        unset = q_old.abs().sum(-1) < c.PUNY
        t_ice = tsf[..., None] + (tf - tsf)[..., None] * k
        q_init = ice_enthalpy_from_temperature(
            t_ice, melting_temperature(sprof))
        s_init = sprof.expand(q_old.shape)
        fresh = (in_cat & unset)[..., None]
        q_new = torch.where(fresh, q_init, q_old)
        s_new = torch.where(fresh, s_init, tr["iceSalinity"][..., n, :])
        qs_init = snow_enthalpy_from_temperature(tsf)[..., None] * \
            torch.ones((1,) * tsf.ndim + (ns,), dtype=dtype, device=device)
        qs_old = tr["snowEnthalpy"][..., n, :]
        qs_unset = qs_old.abs().sum(-1) < c.PUNY
        qs_new = torch.where((in_cat & qs_unset)[..., None], qs_init,
                             qs_old)
        out_cat = (~in_cat)[..., None]
        new["iceAreaCategory"].append(a_new)
        new["iceVolumeCategory"].append(v_new)
        new["snowVolumeCategory"].append(vs_new)
        new["surfaceTemperature"].append(tsf)
        new["iceEnthalpy"].append(torch.where(out_cat, 0.0, q_new))
        new["iceSalinity"].append(torch.where(out_cat, 0.0, s_new))
        new["snowEnthalpy"].append(torch.where(out_cat, 0.0, qs_new))

    for name in ("iceAreaCategory", "iceVolumeCategory",
                 "snowVolumeCategory", "surfaceTemperature"):
        tr[name] = torch.stack(new[name], dim=-1)
    for name in ("iceEnthalpy", "iceSalinity", "snowEnthalpy"):
        tr[name] = torch.stack(new[name], dim=-2)
    return tr
