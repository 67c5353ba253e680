"""Coupled-driver surface: import and export field dictionaries.

The port of the JAX package's `coupler.py`, a re-design of the reference
coupler caps (`driver_nuopc/ice_import_export.F90`: advertise :126-290,
`ice_import` :487, `ice_export` :975; MCT analog `driver/ice_comp_mct.F`):
a host-side field-dict API with the NUOPC standard names, so that an
external coupler (or a Python E3SM/CESM harness) can drive the model with
`import_state -> step -> export_state`.

The import fields are host numpy arrays: `import_state` casts them to the
model dtype and hands them to the device in ONE copy (pinned and
asynchronous to a card, `utils.containers.upload`); `export_state`
builds every export field on the device and fetches them in ONE copy.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import constants as c
from .column.driver import (AtmosForcing, ColumnFluxes, OceanForcing,
                            slab_ocean_frzmlt)
from .column.thermo_shared import sea_freezing_temperature
from .dynamics.evp import DynamicsForcing
from .mesh.core import vertex_to_cell
from .model import State
from .utils.containers import to_host, upload
from .utils.device import resolve_device

# NUOPC standard names advertised by the reference cap
IMPORT_FIELDS = (
    "So_t", "So_s", "So_u", "So_v", "So_dhdx", "So_dhdy", "Fioo_q",
    "Sa_z", "Sa_ptem", "Sa_tbot", "Sa_shum", "Sa_dens",
    "Faxa_swvdr", "Faxa_swvdf", "Faxa_swndr", "Faxa_swndf",
    "Faxa_lwdn", "Faxa_rain", "Faxa_snow", "Sa_u", "Sa_v")
EXPORT_FIELDS = (
    "Si_imask", "Si_ifrac", "Si_t", "Si_vice", "Si_vsno",
    "Si_avsdr", "Si_avsdf", "Si_anidr", "Si_anidf",
    "Faii_taux", "Faii_tauy", "Faii_lat", "Faii_sen", "Faii_lwup",
    "Faii_evap", "Fioi_melth", "Fioi_swpen", "Fioi_meltw",
    "Fioi_salt", "Fioi_taux", "Fioi_tauy")

# per-category atmosphere-computed surface fluxes, imported only in
# calc_Tsfc=False coupling (Registry.xml:3657-3660 atmos_coupling pool)
SFC_FLUX_IMPORT_FIELDS = (
    "surfaceHeatFluxCouple", "surfaceConductiveFluxCouple",
    "latentHeatFluxCouple", "sensibleHeatFluxCouple")

# the export fields taken from the interval's column fluxes
_FLUX_EXPORTS = (
    ("Faii_lat", "flat"), ("Faii_sen", "fsens"), ("Faii_lwup", "flwout"),
    ("Faii_evap", "evap"), ("Fioi_melth", "fhocn"),
    ("Fioi_swpen", "fswthru"), ("Fioi_meltw", "fresh"),
    ("Fioi_salt", "fsalt"), ("Si_avsdr", "albedo_vis_dir"),
    ("Si_avsdf", "albedo_vis_dif"), ("Si_anidr", "albedo_ir_dir"),
    ("Si_anidf", "albedo_ir_dif"))


def import_sfc_fluxes(fields: Dict[str, Any], dtype=torch.float64,
                      device=None):
    """calc_Tsfc=False imports: the atmosphere model's per-category
    surface fluxes ([nCells, nCategories] arrays, Registry
    surfaceHeatFluxCouple / surfaceConductiveFluxCouple /
    latentHeatFluxCouple / sensibleHeatFluxCouple) -> the column
    driver's sfc_fluxes dict (set_sfcflux analog,
    ice_flux_colpkg.F90:174-288), in one copy; the coupled drivers pass
    it to every substep's step."""
    missing = [k for k in SFC_FLUX_IMPORT_FIELDS if k not in fields]
    if missing:
        raise KeyError(
            f"calc_Tsfc=False coupling requires import fields "
            f"{missing} (per-category surface fluxes from the "
            f"atmosphere model)")
    t = upload([fields[k] for k in SFC_FLUX_IMPORT_FIELDS], dtype,
               resolve_device(device))
    return dict(zip(("fsurf", "fcondtop", "flat", "fsens"), t))


def import_state(fields: Dict[str, Any], dt: float, dtype=torch.float64,
                 tfrz_option: str = "minus1p8",
                 sst_in_kelvin: bool = False, device=None
                 ) -> Tuple[DynamicsForcing, AtmosForcing, OceanForcing]:
    """Translate coupler import fields (NUOPC names, [nCells] arrays)
    into the model forcing containers on `device` (None: the card)
    (reference ice_import :487).

    tfrz_option selects the sea freezing-temperature formula
    (colpkg_sea_freezing_temperature, ice_colpkg.F90:1664-1686).
    sst_in_kelvin: set when the driving coupler sends So_t in K (the
    NUOPC cap converts; declare the convention, don't guess)."""
    return import_with(fields, dt, dtype, tfrz_option, sst_in_kelvin,
                       device)[:3]


def import_with(fields: Dict[str, Any], dt: float, dtype, tfrz_option: str,
                sst_in_kelvin: bool, device, extra=()):
    """`import_state`, with further host arrays (`extra`: the clock's
    scalars, a coverage field) in the same copy to the device: returns
    (DynamicsForcing, AtmosForcing, OceanForcing, [extra tensors])."""
    names = [k for k in IMPORT_FIELDS if k in fields]
    views = upload([fields[k] for k in names] + list(extra), dtype,
                   resolve_device(device))
    got = dict(zip(names, views))

    def g(name, default=0.0):
        if name in got:
            return got[name]
        return torch.full_like(got["So_t"], default)

    sst = g("So_t")
    if sst_in_kelvin:
        sst = sst - c.FRESH_FREEZING_POINT
    sss = g("So_s", 34.0)
    tf = sea_freezing_temperature(sss, tfrz_option)
    frzmlt = g("Fioo_q")
    if "Fioo_q" not in fields:
        frzmlt = slab_ocean_frzmlt(sst, tf, 20.0 * torch.ones_like(sst), dt)

    dyn = DynamicsForcing(
        u_air_velocity=g("Sa_u"), v_air_velocity=g("Sa_v"),
        air_density=g("Sa_dens", 1.3),
        u_ocean_velocity=g("So_u"), v_ocean_velocity=g("So_v"),
        sea_surface_tilt_u=g("So_dhdx"), sea_surface_tilt_v=g("So_dhdy"),
        land_ice_mask=torch.zeros_like(sst))
    atm = AtmosForcing(
        air_temperature=g("Sa_ptem", 273.0),
        specific_humidity=g("Sa_shum", 1e-3),
        u_air=g("Sa_u"), v_air=g("Sa_v"),
        longwave_down=g("Faxa_lwdn", 250.0),
        sw_vis_dir=g("Faxa_swvdr"), sw_vis_dif=g("Faxa_swvdf"),
        sw_ir_dir=g("Faxa_swndr"), sw_ir_dif=g("Faxa_swndf"),
        rain_rate=g("Faxa_rain"), snow_rate=g("Faxa_snow"),
        air_density=g("Sa_dens", 1.3),
        air_level_height=g("Sa_z", 10.0))
    ocn = OceanForcing(
        sst=sst, sss=sss, freezing_temperature=tf, frzmlt=frzmlt,
        mixed_layer_depth=20.0 * torch.ones_like(sst))
    return dyn, atm, ocn, views[len(names):]


def export_fields(state: State, fluxes: ColumnFluxes = None,
                  diags: Dict[str, Any] = None,
                  mesh_tensors=None) -> Dict[str, torch.Tensor]:
    """The coupler export fields on the device (reference ice_export
    :975): fractions and states plus atmosphere- and ocean-side fluxes.

    mesh_tensors: when given, the vertex ocean stresses are interpolated
    to cell centers for the Fioi_tau* exports (reference
    seaice_interpolate_vertex_to_cell before export); without it they
    are exported under explicitly vertex-named keys."""
    tr = state.tracers
    aice = tr["iceAreaCategory"].sum(-1)
    out = {
        "Si_imask": (aice > 0).to(aice.dtype),
        "Si_ifrac": aice,
        "Si_vice": tr["iceVolumeCategory"].sum(-1),
        "Si_vsno": tr["snowVolumeCategory"].sum(-1),
    }
    if "surfaceTemperature" in tr:
        w = aice.clamp(min=1e-11)
        out["Si_t"] = (tr["iceAreaCategory"] * tr["surfaceTemperature"]
                       ).sum(-1) / w + c.FRESH_FREEZING_POINT
    if fluxes is not None:
        out.update({k: getattr(fluxes, f) for k, f in _FLUX_EXPORTS})
    if diags is not None and "ocean_stress_u" in diags:
        su, sv = diags["ocean_stress_u"], diags["ocean_stress_v"]
        if mesh_tensors is not None:
            out["Fioi_taux"] = vertex_to_cell(mesh_tensors, su)
            out["Fioi_tauy"] = vertex_to_cell(mesh_tensors, sv)
        else:
            out["Fioi_taux_vertex"] = su
            out["Fioi_tauy_vertex"] = sv
    return out


def export_state(state: State, fluxes: ColumnFluxes = None,
                 diags: Dict[str, Any] = None,
                 mesh_tensors=None) -> Dict[str, np.ndarray]:
    """The coupler export dict (reference ice_export :975) as host numpy,
    `export_fields` fetched in one copy; Si_imask as float64, as the
    JAX package's."""
    return host_exports(to_host(export_fields(state, fluxes, diags,
                                              mesh_tensors)))


def host_exports(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The fetched exports with Si_imask as float64 (the JAX package's
    `astype(float)`)."""
    if "Si_imask" in out:
        out["Si_imask"] = out["Si_imask"].astype(np.float64)
    return out
