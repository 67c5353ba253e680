"""Runtime-tunable physics constants (reference Registry.xml namelist
options that the Fortran column package receives through
`ice_colpkg.F90:colpkg_init_parameters`).

Each field corresponds to one `config_*` option; defaults are the
reference Registry defaults.  The config's `ColumnConfig` carries
fields of the same names (`model.py::_col_tunables` builds a `Tunables`
from them), and `column/driver.ColumnPhysics` threads a `Tunables`
instance into the physics functions.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Tunables:
    # -- mushy-layer gravity drainage (Registry thermodynamics record;
    #    reference ice_therm_mushy.F90 explicit_flow_velocities) --
    rapid_mode_channel_radius: float = 0.5e-3   # config_rapid_mode_channel_radius (m)
    rapid_mode_critical_ra: float = 10.0        # config_rapid_model_critical_Ra
    rapid_mode_aspect_ratio: float = 1.0        # config_rapid_mode_aspect_ratio
    slow_mode_drainage_strength: float = -5.0e-8  # config_slow_mode_drainage_strength (m/s/K)
    slow_mode_critical_porosity: float = 0.05   # config_slow_mode_critical_porosity
    # liquid fraction of congelation ice (phi_i_mushy,
    # ice_colpkg_shared.F90:61)
    congelation_ice_porosity: float = 0.85      # config_congelation_ice_porosity

    # -- snow grain / compaction physics (Registry snow record;
    #    reference ice_snow.F90) --
    fallen_snow_radius: float = 54.4            # config_fallen_snow_radius (um)
    new_snow_density: float = 100.0             # config_new_snow_density (kg/m^3)
    max_snow_density: float = 450.0             # config_max_snow_density (kg/m^3)
    minimum_wind_compaction: float = 10.0       # config_minimum_wind_compaction (m/s)
    wind_compaction_factor: float = 27.3        # config_wind_compaction_factor (kg s/m^4)
    max_dry_snow_radius: float = 2800.0         # config_max_dry_snow_radius (um)

    # -- ridging energetics (Registry ridging record;
    #    reference ice_mechred.F90 Cf) --
    ratio_ridging_work_to_pe: float = 17.0      # config_ratio_ridging_work_to_PE

    # -- shortwave (Registry shortwave/meltponds records;
    #    reference ice_shortwave.F90 kalg / hs0 / hs1) --
    algae_absorption_coefficient: float = 0.6   # config_algae_absorption_coefficient (1/m)
    snow_to_ice_transition_depth: float = 0.0   # config_snow_to_ice_transition_depth (m, hs0)
    snow_on_pond_ice_tapering_parameter: float = 0.03  # config_snow_on_pond_ice_tapering_parameter (hs1)

    # -- ocean coupling (Registry ocean record) --
    min_friction_velocity: float = 0.0005       # config_min_friction_velocity (m/s)


DEFAULT = Tunables()
