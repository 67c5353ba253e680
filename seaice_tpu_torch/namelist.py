"""Run setup: the settings of a run outside the model `Config`, and the
initial state they select.

The port of two members of the JAX package's `namelist.py`: `RunSetup`
(the clock, initial-condition, forcing and mode settings of the
reference's namelist records that configure the runner rather than the
step) and `initial_state_from_setup`, the glue both file-driven runs
use.  The rest of that module (the Fortran-namelist parser, the Registry
option audit and `config_from_namelist`) is not ported yet: ROADMAP
Queue 1 item 11.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class NamelistError(ValueError):
    """Raised for unsupported run settings (the analog of the
    reference's config_error aborts, mpas_seaice_column.F:9100+)."""


@dataclasses.dataclass
class RunSetup:
    """Run-level settings outside the model `Config`: clock, initial
    condition, forcing and mode selection (reference nml_records
    seaice_model/initialize/forcing/use_sections members that configure
    the runner rather than the step)."""
    start_time: str = "2000-01-01_00:00:00"
    stop_time: str = "none"
    run_duration: str = "00-00-01_00:00:00"
    do_restart: bool = False
    restart_timestamp_name: str = "restart_timestamp"
    write_output_on_startup: bool = False
    full_abort_write: bool = True
    check_state: bool = False
    # initialization (testcases/ic.py)
    earth_radius: float = 6371229.0
    initial_condition_type: str = "cice_default"
    initial_ice_area: float = 1.0
    initial_ice_volume: float = 1.0
    initial_snow_volume: float = 0.0
    initial_latitude_north: float = 70.0
    initial_latitude_south: float = -60.0
    initial_velocity_type: str = "uniform"
    initial_uvelocity: float = 0.0
    initial_vvelocity: float = 0.0
    calculate_coriolis: bool = True
    # forcing (forcing/core.py + io/forcing_reader.py)
    use_forcing: bool = True
    atmospheric_forcing_type: str = "CORE"
    forcing_start_time: str = "2000-01-01_00:00:00"
    forcing_cycle_start: str = "2000-01-01_00:00:00"
    forcing_cycle_duration: str = "2-00-00_00:00:00"
    forcing_precipitation_units: str = "mm_per_sec"
    forcing_sst_type: str = "ncar"
    update_ocean_fluxes: bool = False
    use_data_icebergs: bool = False
    use_ocean_mixed_layer: bool = True
    # modes
    use_prescribed_ice: bool = False
    use_prescribed_ice_forcing: bool = False


def initial_state_from_setup(model, setup: RunSetup, **kwargs):
    """Build the initial `State` that `setup.initial_condition_type`
    selects (the analog of init_ice_state, reference
    `mpas_seaice_initialize.F:253`), using the idealized initial
    conditions of `testcases/ic.py`; kwargs go to `ic.cice_default`."""
    from .testcases import ic

    ncat = model.cfg.run.n_categories
    kind = setup.initial_condition_type

    def _one_cat(fn, *args, **kw):
        """Idealized ICs fill every category uniformly; for multi-
        category runs put the ice in category 1 (the reference's
        idealized states are single-category setups)."""
        area, vol, snow, extra = fn(*args, **kw)
        if ncat > 1:
            out = []
            for a in (area, vol, snow):
                z = np.zeros_like(a)
                z[:, 0] = a[:, 0]
                out.append(z)
            area, vol, snow = out
        return area, vol, snow, extra

    if kind == "cice_default":
        area, vol, snow, extra = ic.cice_default(
            model.mesh, ncat, model.cfg.run.n_ice_layers,
            model.cfg.run.n_snow_layers,
            lat_north=setup.initial_latitude_north,
            lat_south=setup.initial_latitude_south, **kwargs)
    elif kind in ("uniform", "uniform_ice"):
        area, vol, snow, extra = _one_cat(
            ic.uniform_ice, model.mesh, ncat, setup.initial_ice_area,
            setup.initial_ice_volume, setup.initial_snow_volume,
            lat_north=setup.initial_latitude_north,
            lat_south=setup.initial_latitude_south)
    elif kind == "uniform_interior":
        area, vol, snow, extra = _one_cat(
            ic.uniform_interior, model.mesh, ncat, setup.initial_ice_area,
            setup.initial_ice_volume, setup.initial_snow_volume)
    elif kind in ("circle", "circle_of_ice"):
        area, vol, snow, extra = _one_cat(
            ic.circle_ice, model.mesh, ncat, setup.initial_ice_area,
            setup.initial_ice_volume, setup.initial_snow_volume)
    elif kind in ("random", "random_coverage"):
        area, vol, snow, extra = ic.random_coverage(model.mesh, ncat)
    elif kind == "special":
        area, vol, snow, extra = ic.special_cells(
            model.mesh, n_categories=ncat, area=setup.initial_ice_area,
            volume=setup.initial_ice_volume)
    elif kind == "ridging":
        area, vol, snow, extra = ic.ridging_band(
            model.mesh, ncat, setup.initial_ice_volume)
    else:
        raise NamelistError(
            f"config_initial_condition_type {kind!r} not supported")
    state = model.init_state(area, vol, snow)
    tr = dict(state.tracers)
    for name, val in extra.items():
        if name in tr:
            tr[name] = torch.as_tensor(np.asarray(val, np.float64)).to(
                device=model.device, dtype=model.dtype)
    # idealized ICs without thermal profiles still need physical
    # enthalpy and salinity when the run has vertical thermodynamics
    # (the reference initializes them by colpkg_init_trcr for every IC
    # type); a no-op where the IC's `extra` gave the enthalpy
    if "iceEnthalpy" in tr:
        from .column.thermo_shared import init_thermo_tracers
        tr = init_thermo_tracers(tr, model.cfg.run.n_ice_layers,
                                 model.cfg.run.n_snow_layers, model.dtype)
    state = state.replace(tracers=tr)
    if setup.initial_velocity_type == "uniform" and (
            setup.initial_uvelocity or setup.initial_vvelocity):
        vel = state.velocity.replace(
            u_velocity=torch.full_like(state.velocity.u_velocity,
                                       setup.initial_uvelocity),
            v_velocity=torch.full_like(state.velocity.v_velocity,
                                       setup.initial_vvelocity))
        state = state.replace(velocity=vel)
    return state
