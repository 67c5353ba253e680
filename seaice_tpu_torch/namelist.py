"""Namelist-driven configuration, the Registry option audit, and the
run setup.

The port of the JAX package's `namelist.py`.  The reference configures a
run from a Fortran namelist whose 316 options are declared in 25 records
of MPAS-Seaice `src/Registry.xml` (parsed by the build into
`namelist.seaice`; CIME layers `bld/build-namelist` on top).  This module
provides:

- `parse_namelist`: a Fortran-namelist reader (no external deps);
- `REGISTRY`: the audit mapping EVERY reference option to one of three
  dispositions, the JAX package's table but for one row
  (`config_use_skeletal_biochemistry`, supported here: the port's model
  step runs the skeletal scheme, which the JAX table calls unreachable,
  ROADMAP Queue 3 fault 9):
    * ``supported``   -- maps onto a `Config`/`RunSetup`/`ZbgcParams`
                        field (possibly with value conversion);
    * ``na``          -- by-design not applicable: the option configures
                        MPI/PIO/pool infrastructure that the array-native
                        architecture subsumes (accepted, ignored);
    * ``unsupported`` -- capability not implemented: accepted only at
                        its Registry default, hard error otherwise.
  Every ``supported`` option parses to the same `Config` as in the JAX
  package, and the port's models run every column option it sets.
- `config_from_namelist`: build `(Config, RunSetup)` from a namelist
  file/string/dict.  Unknown options are a hard error.
- `RunSetup` and `initial_state_from_setup`: the settings of a run
  outside the model `Config`, and the initial state they select.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .config import (AdvectionConfig, AdvectionType, ColumnConfig, Config,
                     ConstitutiveRelation, OceanStressType, RunConfig,
                     StrainScheme, StressDivergenceScheme, VariationalBasis,
                     VariationalDenominator, VelocitySolverConfig)


class NamelistError(ValueError):
    """Raised for unknown options, unsupported non-default values, or
    malformed namelist syntax (the analog of the reference's
    config_error aborts, mpas_seaice_column.F:9100+)."""


# -- Fortran namelist parsing -------------------------------------------------

_LOGICAL = {".true.": True, "true": True, "t": True,
            ".false.": False, "false": False, "f": False}


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith(("'", '"')) and tok.endswith(tok[0]) and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in _LOGICAL:
        return _LOGICAL[low]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        # Fortran double-precision exponents: 1.0d-3
        return float(low.replace("d", "e"))
    except ValueError:
        return tok


def parse_namelist(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse Fortran-namelist text into {record: {option: value}}."""
    records: Dict[str, Dict[str, Any]] = {}
    current: Optional[str] = None
    for raw in text.splitlines():
        line = raw.split("!", 1)[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            if current is not None:
                raise NamelistError(
                    f"record &{current} not closed before &{line[1:]}")
            current = line[1:].strip().lower()
            records.setdefault(current, {})
            continue
        if line in ("/", "&end", "$end"):
            current = None
            continue
        if current is None:
            raise NamelistError(f"assignment outside record: {line!r}")
        if "=" not in line:
            raise NamelistError(f"malformed namelist line: {line!r}")
        key, val = line.split("=", 1)
        val = val.rstrip(",").strip()
        records[current][key.strip().lower()] = _parse_value(val)
    if current is not None:
        raise NamelistError(f"record &{current} not closed at end of file")
    return records


# -- run-level settings not in Config -----------------------------------------

@dataclasses.dataclass
class RunSetup:
    """Run-level settings outside the model `Config`: clock, initial
    condition, forcing and mode selection (reference nml_records
    seaice_model/initialize/forcing/use_sections members that configure
    the runner rather than the step).  Consumed by
    `examples/torch_run_from_namelist.py` and `StandaloneRunner` assembly."""
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


# -- the audit table -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Opt:
    record: str
    name: str                   # without the config_ prefix
    disposition: str            # 'supported' | 'na' | 'unsupported'
    default: Any                # Registry default (parsed)
    target: Optional[str] = None          # dotted path for supported opts
    conv: Optional[Callable] = None       # value converter
    reason: str = ""            # why na / unsupported

    @property
    def full_name(self) -> str:
        return "config_" + self.name


def _enum(mapping: Dict[str, Any], what: str) -> Callable:
    def f(v):
        if v not in mapping:
            raise NamelistError(
                f"{what}: {v!r} not supported "
                f"(supported: {sorted(mapping)})")
        return mapping[v]
    return f


_TABLE: list = []


def _opt(record, name, default, target=None, conv=None,
         disposition=None, reason=""):
    if disposition is None:
        disposition = "supported" if target else "na"
    _TABLE.append(Opt(record, name, disposition, default, target, conv,
                      reason))


def _un(record, name, default, reason):
    _opt(record, name, default, disposition="unsupported", reason=reason)


def _na(record, name, default, reason):
    _opt(record, name, default, disposition="na", reason=reason)


# --- seaice_model -------------------------------------------------------------
_opt("seaice_model", "dt", 3600.0, "run.dt", float)
_opt("seaice_model", "calendar_type", "gregorian_noleap", "run.calendar",
     _enum({"gregorian_noleap": "noleap"}, "config_calendar_type"))
_opt("seaice_model", "start_time", "2000-01-01_00:00:00", "setup.start_time")
_opt("seaice_model", "stop_time", "none", "setup.stop_time")
_opt("seaice_model", "run_duration", "00-00-01_00:00:00",
     "setup.run_duration")
_un("seaice_model", "num_halos", 2,
    "parallel/partition.py builds 2-deep halos (matches the default); "
    "other depths are not implemented")

# --- io -----------------------------------------------------------------------
_na("io", "pio_num_iotasks", 0,
    "PIO does not exist; I/O parallelism is per-shard writers "
    "(io/parallel.py)")
_na("io", "pio_stride", 1, "see config_pio_num_iotasks")
_opt("io", "write_output_on_startup", False, "setup.write_output_on_startup")
_un("io", "test_case_diag", False,
    "testing-system diagnostic arrays are replaced by pytest suites")
_un("io", "test_case_diag_type", "none", "see config_test_case_diag")
_opt("io", "full_abort_write", True, "setup.full_abort_write")

# --- decomposition (all by-design N/A: parallel/partition.py) -------------------------
for nm, dv in [("block_decomp_file_prefix", "graphs/graph.info.part."),
               ("number_of_blocks", 0), ("explicit_proc_decomp", False),
               ("proc_decomp_file_prefix", "graphs/graph.info.part.")]:
    _na("decomposition", nm, dv,
        "Metis block decomposition is subsumed by parallel/partition.py "
        "Morton partitioning (blocks stepped in lockstep)")
_na("decomposition", "use_halo_exch", True,
    "halo exchange is always on (edge-colored rounds, parallel/sharded.py)")
_na("decomposition", "aggregate_halo_exch", False,
    "fields are always exchanged as one stacked buffer "
    "(parallel/sharded.py) — the aggregated mode is the only mode")
_na("decomposition", "reuse_halo_exch", False,
    "the step reuses its exchange buffers itself (parallel/sharded.py)")
_na("decomposition", "load_balance_timers", False,
    "the recorder's spans and counters (diagnostics.RECORDER) "
    "replace MPI barrier timers")

# --- restart -------------------------------------------------------------------
_opt("restart", "do_restart", False, "setup.do_restart")
_opt("restart", "restart_timestamp_name", "restart_timestamp",
     "setup.restart_timestamp_name")
for nm in ["do_restart_hbrine", "do_restart_zsalinity", "do_restart_bgc",
           "do_restart_snow_density", "do_restart_snow_grain_radius"]:
    _na("restart", nm, False,
        "checkpoints restore the full state pytree; per-package restart "
        "toggles are an artifact of Fortran pool allocation")

# --- dimensions ----------------------------------------------------------------
_opt("dimensions", "nCategories", 5, "run.n_categories", int)
_opt("dimensions", "nIceLayers", 7, "run.n_ice_layers", int)
_opt("dimensions", "nSnowLayers", 1, "run.n_snow_layers", int)

# --- initialize ----------------------------------------------------------------
_opt("initialize", "earth_radius", 6371229.0, "setup.earth_radius", float)
_opt("initialize", "initial_condition_type", "cice_default",
     "setup.initial_condition_type")
_opt("initialize", "initial_ice_area", 1.0, "setup.initial_ice_area", float)
_opt("initialize", "initial_ice_volume", 1.0, "setup.initial_ice_volume",
     float)
_opt("initialize", "initial_snow_volume", 0.0, "setup.initial_snow_volume",
     float)
_opt("initialize", "initial_latitude_north", 70.0,
     "setup.initial_latitude_north", float)
_opt("initialize", "initial_latitude_south", -60.0,
     "setup.initial_latitude_south", float)
_opt("initialize", "initial_velocity_type", "uniform",
     "setup.initial_velocity_type")
_opt("initialize", "initial_uvelocity", 0.0, "setup.initial_uvelocity",
     float)
_opt("initialize", "initial_vvelocity", 0.0, "setup.initial_vvelocity",
     float)
_opt("initialize", "calculate_coriolis", True, "setup.calculate_coriolis")

# --- use_sections ---------------------------------------------------------------
_opt("use_sections", "use_dynamics", True, "special.use_dynamics")
_opt("use_sections", "use_velocity_solver", True,
     "velocity.use_velocity_solver")
_opt("use_sections", "use_advection", True, "special.use_advection")
_opt("use_sections", "use_forcing", True, "setup.use_forcing")
_opt("use_sections", "use_column_package", True,
     "column.use_column_package")
_opt("use_sections", "use_prescribed_ice", False,
     "setup.use_prescribed_ice")
_opt("use_sections", "use_prescribed_ice_forcing", False,
     "setup.use_prescribed_ice_forcing")

# --- forcing ---------------------------------------------------------------------
_opt("forcing", "atmospheric_forcing_type", "CORE",
     "setup.atmospheric_forcing_type",
     _enum({"CORE": "CORE"}, "config_atmospheric_forcing_type"))
_opt("forcing", "forcing_start_time", "2000-01-01_00:00:00",
     "setup.forcing_start_time")
_opt("forcing", "forcing_cycle_start", "2000-01-01_00:00:00",
     "setup.forcing_cycle_start")
_opt("forcing", "forcing_cycle_duration", "2-00-00_00:00:00",
     "setup.forcing_cycle_duration")
_opt("forcing", "forcing_precipitation_units", "mm_per_sec",
     "setup.forcing_precipitation_units",
     _enum({"mm_per_sec": "mm_per_sec", "mm_per_month": "mm_per_month"},
           "config_forcing_precipitation_units"))
_opt("forcing", "forcing_sst_type", "ncar", "setup.forcing_sst_type",
     _enum({"ncar": "ncar"}, "config_forcing_sst_type"))
_opt("forcing", "update_ocean_fluxes", False, "setup.update_ocean_fluxes")
_opt("forcing", "include_pond_freshwater_feedback", False,
     "column.include_pond_freshwater_feedback")

# --- testing --------------------------------------------------------------------
_un("testing", "use_test_ice_shelf", False,
    "the ice-shelf testing mask is not implemented")
_un("testing", "testing_system_test", False,
    "reproducibility-breaking test arrays are replaced by the pytest "
    "invariance suites (tests/test_sharded.py, test_regression.py)")

# --- velocity_solver --------------------------------------------------------------
_opt("velocity_solver", "dynamics_subcycle_number", 1,
     "velocity.dynamics_subcycle_number", int)
_opt("velocity_solver", "rotate_cartesian_grid", True,
     "velocity.rotate_cartesian_grid")
_opt("velocity_solver", "include_metric_terms", True,
     "velocity.include_metric_terms")
_opt("velocity_solver", "elastic_subcycle_number", 120,
     "velocity.elastic_subcycle_number", int)
_opt("velocity_solver", "strain_scheme", "variational",
     "velocity.strain_scheme",
     _enum({"variational": StrainScheme.VARIATIONAL,
            "weak": StrainScheme.WEAK}, "config_strain_scheme"))
_opt("velocity_solver", "constitutive_relation_type", "evp",
     "velocity.constitutive_relation",
     _enum({"evp": ConstitutiveRelation.EVP,
            "revised_evp": ConstitutiveRelation.EVP_REVISED,
            "linear": ConstitutiveRelation.LINEAR,
            "none": ConstitutiveRelation.NONE},
           "config_constitutive_relation_type"))
_opt("velocity_solver", "stress_divergence_scheme", "variational",
     "velocity.stress_divergence_scheme",
     _enum({"variational": StressDivergenceScheme.VARIATIONAL,
            "weak": StressDivergenceScheme.WEAK},
           "config_stress_divergence_scheme"))
_opt("velocity_solver", "variational_basis", "wachspress",
     "velocity.variational_basis",
     _enum({"wachspress": VariationalBasis.WACHSPRESS,
            "pwl": VariationalBasis.PWL}, "config_variational_basis"))
_opt("velocity_solver", "variational_denominator_type", "original",
     "velocity.variational_denominator",
     _enum({"original": VariationalDenominator.ORIGINAL,
            "alternate": VariationalDenominator.ALTERNATE},
           "config_variational_denominator_type"))
_opt("velocity_solver", "wachspress_integration_type", "dunavant",
     "velocity.integration_type",
     _enum({"trapezoidal": "trapezoidal", "dunavant": "dunavant",
            "fekete": "fekete"}, "config_wachspress_integration_type"))
_opt("velocity_solver", "wachspress_integration_order", 8,
     "velocity.integration_order", int)
_opt("velocity_solver", "calc_velocity_masks", True,
     "velocity.calc_velocity_masks")
_opt("velocity_solver", "average_variational_strain", False,
     "velocity.average_variational_strains")
_opt("velocity_solver", "use_air_stress", True, "velocity.use_air_stress")
_opt("velocity_solver", "use_ocean_stress", True,
     "velocity.use_ocean_stress")
_opt("velocity_solver", "use_surface_tilt", True,
     "velocity.use_surface_tilt")
_opt("velocity_solver", "geostrophic_surface_tilt", True,
     "velocity.geostrophic_surface_tilt")
_opt("velocity_solver", "ocean_stress_type", "quadratic",
     "velocity.ocean_stress_type",
     _enum({"quadratic": OceanStressType.QUADRATIC,
            "linear": OceanStressType.LINEAR}, "config_ocean_stress_type"))
_un("velocity_solver", "use_special_boundaries_velocity", False,
    "special boundaries are configured programmatically "
    "(seaice_tpu_torch.special_boundaries), not via namelist")
_un("velocity_solver", "use_special_boundaries_velocity_masks", False,
    "see config_use_special_boundaries_velocity")

# --- advection --------------------------------------------------------------------
_opt("advection", "advection_type", "incremental_remap",
     "advection.advection_type",
     _enum({"incremental_remap": AdvectionType.INCREMENTAL_REMAP,
            "upwind": AdvectionType.UPWIND,
            "none": AdvectionType.NONE}, "config_advection_type"))
_opt("advection", "monotonic", True, "advection.monotonic")
_opt("advection", "conservation_check", False,
     "advection.conservation_check")
_opt("advection", "monotonicity_check", False,
     "advection.monotonicity_check")
_un("advection", "recover_tracer_means_check", False,
    "the reconstruction is validated by tests/test_remap.py convergence "
    "tests instead of a runtime self-check")

# --- column_package ----------------------------------------------------------------
_opt("column_package", "use_column_shortwave", True, "column.use_shortwave")
_opt("column_package", "use_column_vertical_thermodynamics", True,
     "column.use_vertical_thermodynamics")
_opt("column_package", "use_column_biogeochemistry", False,
     "column.use_biogeochemistry")
_opt("column_package", "use_column_itd_thermodynamics", True,
     "column.use_itd_thermodynamics")
_opt("column_package", "use_column_ridging", True, "column.use_ridging")
_opt("column_package", "use_column_snow_tracers", False,
     "column.use_snow_tracers")

# --- column_tracers ------------------------------------------------------------------
_opt("column_tracers", "use_ice_age", True, "column.use_ice_age")
_opt("column_tracers", "use_first_year_ice", True,
     "column.use_first_year_ice")
_opt("column_tracers", "use_level_ice", True, "column.use_level_ice")
_opt("column_tracers", "use_cesm_meltponds", False, "special.pond_cesm")
_opt("column_tracers", "use_level_meltponds", True, "special.pond_lvl")
_opt("column_tracers", "use_topo_meltponds", False, "special.pond_topo")
_opt("column_tracers", "use_aerosols", False, "special.use_aerosols")
_opt("column_tracers", "use_effective_snow_density", False,
     "special.use_effective_snow_density")
_opt("column_tracers", "use_snow_grain_radius", False,
     "special.use_snow_grain_radius")
_un("column_tracers", "use_special_boundaries_tracers", False,
    "see config_use_special_boundaries_velocity")

# --- biogeochemistry ------------------------------------------------------------------
_opt("biogeochemistry", "use_brine", False, "column.use_brine_height")
_opt("biogeochemistry", "use_vertical_zsalinity", False,
     "column.solve_zsalinity")
_opt("biogeochemistry", "use_vertical_biochemistry", False,
     "column.use_biogeochemistry")
_opt("biogeochemistry", "use_vertical_tracers", False,
     "column.use_biogeochemistry")
# the JAX table's one row the port differs in: its model step runs the
# skeletal scheme (column/bgc.py; ROADMAP Queue 3 fault 9)
_opt("biogeochemistry", "use_skeletal_biochemistry", False,
     "column.use_skeletal_biochemistry")
_un("biogeochemistry", "use_shortwave_bioabsorption", False,
    "bottom-algae absorption is built into the dEdd/SNICAR paths "
    "(column/dedd.py kalg band), not separately switchable")
_opt("biogeochemistry", "use_nitrate", False, "special.noop")
_opt("biogeochemistry", "use_carbon", False, "zbgc.use_C")
_opt("biogeochemistry", "use_chlorophyll", False, "special.noop")
_opt("biogeochemistry", "use_ammonium", False, "zbgc.use_Am")
_opt("biogeochemistry", "use_silicate", False, "zbgc.use_Sil")
_opt("biogeochemistry", "use_DMS", False, "zbgc.use_DMS")
_opt("biogeochemistry", "use_nonreactive", False, "zbgc.use_PON")
_opt("biogeochemistry", "use_humics", False, "zbgc.use_hum")
_opt("biogeochemistry", "use_DON", False, "zbgc.use_DON")
_opt("biogeochemistry", "use_iron", False, "zbgc.use_Fe")
_opt("biogeochemistry", "use_modal_aerosols", False,
     "column.use_modal_aerosols")
_opt("biogeochemistry", "use_zaerosols", False, "zbgc.use_zaero")
_opt("biogeochemistry", "skeletal_bgc_flux_type", "Jin2006",
     "special.skl_flux_type",
     _enum({"Jin2006": "Jin2006"}, "config_skeletal_bgc_flux_type"))
_un("biogeochemistry", "scale_initial_vertical_bgc", False,
    "initial bio profiles are set explicitly (testcases/ic.py)")
for nm, dv in [("biogrid_bottom_molecular_sublayer", 0.006),
               ("biogrid_top_molecular_sublayer", 0.006),
               ("bio_gravity_drainage_length_scale", 2.0),
               ("zsalinity_molecular_sublayer", 0.0),
               ("zsalinity_gravity_drainage_scale", 0.028),
               ("snow_porosity_at_ice_surface", -0.3)]:
    _un("biogeochemistry", nm, dv,
        "fixed internally in column/brine.py / zsalinity.py at the "
        "reference defaults; not yet a tunable")
_opt("biogeochemistry", "new_ice_fraction_biotracer", 1.0,
     "zbgc.initbio_frac", float)
_opt("biogeochemistry", "fraction_biotracer_in_frazil", 0.80,
     "zbgc.frazil_scav", float)

_SPECIES = ("diatoms", "small_plankton", "phaeocystis")
_PER_SPECIES = {
    # namelist family -> (ZbgcParams tuple field, registry defaults)
    "ratio_Si_to_N": ("R_Si2N", (1.80, 0.00, 0.00)),
    "ratio_S_to_N": ("R_S2N", (0.03, 0.03, 0.03)),
    "ratio_Fe_to_N": ("R_Fe2N", (0.023, 0.023, 0.7)),
    "ratio_C_to_N": ("R_C2N", (7.0, 7.0, 7.0)),
    "ratio_chla_to_N": ("R_chl2N", (2.1, 1.1, 0.84)),
    "chla_absorptivity_of": ("chlabs", (0.03, 0.01, 0.05)),
    "light_attenuation": ("alpha2max", (0.3, 0.2, 0.17)),
    "light_inhibition": ("beta2max", (0.001, 0.001, 0.04)),
    "maximum_growth_rate": ("mu_max", (1.44, 0.41, 0.63)),
    "temperature_growth": ("grow_Tdep", (0.063, 0.063, 0.063)),
    "grazed_fraction": ("fr_graze", (0.19, 0.19, 0.19)),
    "mortality": ("mort_pre", (0.007, 0.007, 0.007)),
    "temperature_mortality": ("mort_Tdep", (0.03, 0.03, 0.03)),
    "exudation": ("k_exude", (0.0, 0.0, 0.0)),
    "nitrate_saturation": ("K_Nit", (1.0, 1.0, 1.0)),
    "ammonium_saturation": ("K_Am", (0.3, 0.3, 0.3)),
    "silicate_saturation": ("K_Sil", (4.0, 0.0, 0.0)),
    "iron_saturation": ("K_Fe", (1.0, 0.2, 0.1)),
}
for fam, (field, defaults) in _PER_SPECIES.items():
    for i, sp in enumerate(_SPECIES):
        _opt("biogeochemistry", f"{fam}_{sp}", defaults[i],
             f"zbgc.{field}[{i}]", float)

for fam, defaults in [("ratio_Fe_to_C", (0.0033, 0.0033, 0.1)),
                      ("scales_absorption", (2.0, 4.0, 5.0))]:
    for i, sp in enumerate(_SPECIES):
        _un("biogeochemistry", f"{fam}_{sp}", defaults[i],
            "not used by the zBGC reaction network (Fe uptake is "
            "N-based; absorption scaling is fixed)")
for nm, dv in [("ratio_Fe_to_DON", 0.023),
               ("ratio_Fe_to_DOC_saccharids", 0.1),
               ("ratio_Fe_to_DOC_lipids", 0.033),
               ("ratio_Fe_to_dust", 0.035),
               ("solubility_of_Fe_in_dust", 0.005),
               ("fraction_spilled_to_DON", 0.6),
               ("fraction_exudation_to_saccharids", 1.0),
               ("fraction_exudation_to_lipids", 1.0)]:
    _un("biogeochemistry", nm, dv,
        "not a tunable of the zBGC network (column/zbgc.py documents "
        "the implemented reaction set)")
_MOBILITY = [("diatoms", 0.0), ("small_plankton", 0.0),
             ("phaeocystis", 0.0), ("nitrate", -1.0), ("ammonium", 0.0),
             ("silicate", -1.0), ("DMSPp", 0.5), ("DMSPd", 0.0),
             ("humics", 0.0), ("saccharids", 0.0), ("lipids", 0.0),
             ("inorganic_carbon", -1.0), ("proteins", 0.0),
             ("dissolved_iron", 0.0), ("particulate_iron", 0.5),
             ("black_carbon1", 0.0), ("black_carbon2", 0.0),
             ("dust1", 0.0), ("dust2", 0.0), ("dust3", 0.0),
             ("dust4", 0.0)]
for nm, dv in _MOBILITY:
    _opt("biogeochemistry", f"mobility_type_{nm}", dv,
         f"zbgc.mobility_type_{nm}", float)
_opt("biogeochemistry", "rapid_mobile_to_stationary_time", 3600.0,
     "zbgc.rapid_mobile_to_stationary_time", float)
_opt("biogeochemistry", "long_mobile_to_stationary_time", 604800.0,
     "zbgc.long_mobile_to_stationary_time", float)
for nm, dv, tgt in [
        ("respiration_fraction_of_growth", 0.05, "fr_resp"),
        ("maximum_brine_temperature", 0.0, "T_max"),
        ("salinity_dependence_of_growth", 1.0, "fsal"),
        ("minimum_optical_depth", 0.1, "op_dep_min"),
        ("slopped_grazing_fraction", 0.5, "fr_graze_s"),
        ("excreted_fraction", 0.5, "fr_graze_e"),
        ("fraction_mortality_to_ammonium", 0.9, "fr_mort2min"),
        ("fraction_iron_remineralized", 1.0, "fr_dFe"),
        ("nitrification_rate", 0.046, "k_nitrif"),
        ("desorption_loss_particulate_iron", 3065.0, "t_iron_conv"),
        ("maximum_loss_fraction", 0.9, "max_loss"),
        ("maximum_ratio_iron_to_saccharids", 0.2, "max_dfe_doc1"),
        ("respiration_loss_to_DMSPd", 0.9, "fr_resp_s"),
        ("DMSP_to_DMS_conversion_fraction", 0.7, "y_sk_DMS"),
        ("DMSP_to_DMS_conversion_time", 5.0, "t_sk_conv"),
        ("DMS_oxidation_time", 12.0, "t_sk_ox"),
        ("degredation_of_DON", 0.2, "kn_bac"),
        ("fraction_DON_ammonium", 1.0, "f_don_Am"),
        ("ratio_C_to_N_proteins", 5.0, "R_C2N_DON"),
        ("algal_maximum_velocity", 0.0000001, "algal_vel")]:
    _opt("biogeochemistry", nm, dv, f"zbgc.{tgt}", float)
_opt("biogeochemistry", "fraction_loss_to_saccharids", 0.5,
     "zbgc.f_doc[0]", float)
_opt("biogeochemistry", "fraction_loss_to_lipids", 0.5,
     "zbgc.f_doc[1]", float)
_opt("biogeochemistry", "remineralization_saccharids", 0.03,
     "zbgc.k_bac[0]", float)
_opt("biogeochemistry", "remineralization_lipids", 0.03,
     "zbgc.k_bac[1]", float)

# --- shortwave ----------------------------------------------------------------------
_opt("shortwave", "shortwave_type", "dEdd", "column.shortwave",
     _enum({"ccsm3": "ccsm3", "dEdd": "dEdd"}, "config_shortwave_type"))
_opt("shortwave", "albedo_type", "ccsm3", "special.albedo_type",
     _enum({"ccsm3": "ccsm3"}, "config_albedo_type"))
_opt("shortwave", "use_snicar_ad", False, "column.use_snicar")
_opt("shortwave", "visible_ice_albedo", 0.78, "column.albicev", float)
_opt("shortwave", "infrared_ice_albedo", 0.36, "column.albicei", float)
_opt("shortwave", "visible_snow_albedo", 0.98, "column.albsnowv", float)
_opt("shortwave", "infrared_snow_albedo", 0.70, "column.albsnowi", float)
_opt("shortwave", "variable_albedo_thickness_limit", 0.3, "column.ahmax",
     float)
_opt("shortwave", "ice_shortwave_tuning_parameter", 0.0, "column.r_ice",
     float)
_opt("shortwave", "pond_shortwave_tuning_parameter", 0.0, "column.r_pnd",
     float)
_opt("shortwave", "snow_shortwave_tuning_parameter", 1.5, "column.r_snw",
     float)
_opt("shortwave", "temp_change_snow_grain_radius_change", 1.5,
     "column.dt_mlt", float)
_opt("shortwave", "max_melting_snow_grain_radius", 1500.0,
     "column.rsnw_mlt", float)
_opt("shortwave", "algae_absorption_coefficient", 0.6,
     "column.algae_absorption_coefficient", float)

# --- snow ----------------------------------------------------------------------------
_opt("snow", "snow_redistribution_scheme", "none", "column.snwredist",
     _enum({"none": "none", "bulk": "bulk", "ITDsd": "ITDsd",
            "ITDrdg": "ITDrdg"}, "config_snow_redistribution_scheme"))
for nm, dv in [("fallen_snow_radius", 54.4),
               ("new_snow_density", 100.0),
               ("max_snow_density", 450.0),
               ("minimum_wind_compaction", 10.0),
               ("wind_compaction_factor", 27.3),
               ("max_dry_snow_radius", 2800.0)]:
    _opt("snow", nm, dv, "column." + nm, float)
_opt("snow", "use_snow_liquid_ponds", False,
     "column.use_snow_liquid_ponds")

# --- meltponds ---------------------------------------------------------------------------
_opt("meltponds", "snow_to_ice_transition_depth", 0.0,
     "column.snow_to_ice_transition_depth", float)
_opt("meltponds", "pond_refreezing_type", "hlid", "column.frzpnd",
     _enum({"hlid": "hlid", "cesm": "cesm"},
           "config_pond_refreezing_type"))
_opt("meltponds", "pond_flushing_timescale", 1.0e-3, "column.dpscale",
     float)
_opt("meltponds", "min_meltwater_retained_fraction", 0.15,
     "column.rfracmin", float)
_opt("meltponds", "max_meltwater_retained_fraction", 1.0,
     "column.rfracmax", float)
_opt("meltponds", "pond_depth_to_fraction_ratio", 0.8, "column.pndaspect",
     float)
_opt("meltponds", "snow_on_pond_ice_tapering_parameter", 0.03,
     "column.snow_on_pond_ice_tapering_parameter", float)
_opt("meltponds", "critical_pond_ice_thickness", 0.01,
     "column.hi_min_pond", float)

# --- thermodynamics ---------------------------------------------------------------------
_opt("thermodynamics", "thermodynamics_type", "mushy", "column.ktherm",
     _enum({"zero layer": 0, "BL99": 1, "mushy": 2},
           "config_thermodynamics_type"))
_opt("thermodynamics", "heat_conductivity_type", "bubbly",
     "special.conduct",
     _enum({"bubbly": "bubbly", "MU71": "MU71"},
           "config_heat_conductivity_type"))
for nm, dv, tgt in [
        ("rapid_mode_channel_radius", 0.5e-3,
         "rapid_mode_channel_radius"),
        ("rapid_model_critical_Ra", 10.0, "rapid_mode_critical_ra"),
        ("rapid_mode_aspect_ratio", 1.0, "rapid_mode_aspect_ratio"),
        ("slow_mode_drainage_strength", -5.0e-8,
         "slow_mode_drainage_strength"),
        ("slow_mode_critical_porosity", 0.05,
         "slow_mode_critical_porosity"),
        ("congelation_ice_porosity", 0.85,
         "congelation_ice_porosity")]:
    _opt("thermodynamics", nm, dv, "column." + tgt, float)

# --- itd ---------------------------------------------------------------------------------
_opt("itd", "itd_conversion_type", "linear remap", "column.kitd",
     _enum({"delta function": 0, "linear remap": 1},
           "config_itd_conversion_type"))
_opt("itd", "category_bounds_type", "original", "column.kcatbound",
     _enum({"single category": -1, "original": 0, "new": 1, "WMO": 2},
           "config_category_bounds_type"))

# --- ridging -------------------------------------------------------------------------------
_opt("ridging", "ice_strength_formulation", "Rothrock75",
     "column.kstrength",
     _enum({"Hibler79": 0, "Rothrock75": 1},
           "config_ice_strength_formulation"))
_opt("ridging", "ridging_participation_function", "exponential",
     "column.krdg_partic",
     _enum({"Thorndike75": 0, "exponential": 1},
           "config_ridging_participation_function"))
_opt("ridging", "ridging_redistribution_function", "exponential",
     "column.krdg_redist",
     _enum({"Hibler80": 0, "exponential": 1},
           "config_ridging_redistribution_function"))
_opt("ridging", "ridiging_efolding_scale", 3.0, "column.mu_rdg", float)
_opt("ridging", "ratio_ridging_work_to_PE", 17.0,
     "column.ratio_ridging_work_to_pe", float)

# --- atmosphere ---------------------------------------------------------------------------
_opt("atmosphere", "atmos_boundary_method", "ccsm3", "column.atmbndy",
     _enum({"ccsm3": "default", "constant": "constant"},
           "config_atmos_boundary_method"))
_un("atmosphere", "calc_surface_stresses", True,
    "surface stresses are always computed on the device")
_opt("atmosphere", "calc_surface_temperature", True,
     "column.calc_surface_temperature")
_opt("atmosphere", "use_form_drag", False, "column.use_form_drag")
_opt("atmosphere", "use_high_frequency_coupling", False, "column.highfreq")
_opt("atmosphere", "boundary_layer_iteration_number", 4, "column.natmiter",
     int)

# --- ocean ----------------------------------------------------------------------------------
_opt("ocean", "use_ocean_mixed_layer", True, "setup.use_ocean_mixed_layer")
_opt("ocean", "min_friction_velocity", 0.0005,
     "column.min_friction_velocity", float)
_opt("ocean", "ocean_heat_transfer_type", "constant",
     "special.ocean_heat_transfer",
     _enum({"constant": "constant"}, "config_ocean_heat_transfer_type"))
_opt("ocean", "sea_freezing_temperature_type", "mushy",
     "column.tfrz_option",
     _enum({"mushy": "mushy", "linear_salt": "linear_salt",
            "minus1p8": "minus1p8"},
           "config_sea_freezing_temperature_type"))
_un("ocean", "ocean_surface_type", "free",
    "only the free-surface tilt formulation is implemented")
_un("ocean", "couple_biogeochemistry_fields", False,
    "the coupled driver exports physical fluxes only; bgc ocean "
    "exchange happens inside the column step (column/zbgc.py)")
_opt("ocean", "use_data_icebergs", False, "setup.use_data_icebergs")

# --- diagnostics ------------------------------------------------------------------------------
_opt("diagnostics", "check_state", False, "setup.check_state")

# --- prescribed_ice (CIME shr_strdata stream plumbing) ------------------------------------------
for nm, dv in [("prescribed_ice_stream_year_first", -999),
               ("prescribed_ice_stream_year_last", -999),
               ("prescribed_ice_model_year_align", -999),
               ("prescribed_ice_stream_fldvarname", "ice_cov"),
               ("prescribed_ice_stream_fldfilename", "unset"),
               ("prescribed_ice_stream_meshfile", "unset"),
               ("prescribed_ice_stream_mapalgo", "unset"),
               ("prescribed_ice_stream_domtvarname", "time"),
               ("prescribed_ice_stream_domxvarname", "xc"),
               ("prescribed_ice_stream_domyvarname", "yc"),
               ("prescribed_ice_stream_domareaname", "area"),
               ("prescribed_ice_stream_dommaskname", "mask"),
               ("prescribed_ice_stream_domfilename", "unset"),
               ("prescribed_ice_stream_mapread", "NOT_SET"),
               ("prescribed_ice_stream_fill", False)]:
    _na("prescribed_ice", nm, dv,
        "CIME shr_strdata stream plumbing; prescribed ice is driven "
        "directly with coverage arrays/files (seaice_tpu_torch/prescribed.py)")


REGISTRY: Dict[str, Opt] = {o.full_name: o for o in _TABLE}
assert len(REGISTRY) == len(_TABLE), "duplicate option in audit table"
# Fortran namelists are case-insensitive
_REGISTRY_CI: Dict[str, Opt] = {k.lower(): v for k, v in REGISTRY.items()}


# -- building Config from parsed options ----------------------------------------

def _norm(v: Any) -> Any:
    """Normalize for default comparison (floats via float equality)."""
    if isinstance(v, float) or isinstance(v, int) and not isinstance(v, bool):
        try:
            return float(v)
        except (TypeError, ValueError):
            return v
    return v


def config_from_namelist(source, **overrides) -> Tuple[Config, RunSetup]:
    """Build `(Config, RunSetup)` from a namelist file path, namelist
    text, or a pre-parsed {record: {option: value}} dict.

    Unknown options hard-error; `unsupported` options hard-error when
    set to a non-default value; `na` options are accepted and ignored.
    `overrides` are applied to the RunSetup afterwards."""
    if isinstance(source, dict):
        records = source
    else:
        text = source
        if "\n" not in str(source) and not str(source).lstrip().startswith(
                "&"):
            with open(source) as f:
                text = f.read()
        records = parse_namelist(text)

    run_kw: Dict[str, Any] = {}
    vel_kw: Dict[str, Any] = {}
    adv_kw: Dict[str, Any] = {}
    col_kw: Dict[str, Any] = {}
    setup_kw: Dict[str, Any] = {}
    zbgc_kw: Dict[str, Any] = {}
    zbgc_touched = False
    special: Dict[str, Any] = {}

    for rec_name, opts in records.items():
        for key, value in opts.items():
            opt = _REGISTRY_CI.get(str(key).lower())
            if opt is None:
                raise NamelistError(f"unknown namelist option {key!r} "
                                    f"(record &{rec_name})")
            if opt.disposition == "na":
                continue
            if opt.disposition == "unsupported":
                if _norm(value) != _norm(opt.default):
                    raise NamelistError(
                        f"{key} = {value!r} is not supported "
                        f"(only the default {opt.default!r}): {opt.reason}")
                continue
            v = opt.conv(value) if opt.conv else value
            ns, _, field = opt.target.partition(".")
            if ns == "run":
                run_kw[field] = v
            elif ns == "velocity":
                vel_kw[field] = v
            elif ns == "advection":
                adv_kw[field] = v
            elif ns == "column":
                col_kw[field] = v
            elif ns == "setup":
                setup_kw[field] = v
            elif ns == "zbgc":
                zbgc_touched = True
                zbgc_kw[field] = v
            elif ns == "special":
                special[field] = v
            else:  # pragma: no cover
                raise AssertionError(f"bad target {opt.target}")

    # -- compound rules (reference core_interface package logic) --------
    ponds = [s for s in ("cesm", "lvl", "topo")
             if special.get(f"pond_{s}", False)]
    if len(ponds) > 1:
        raise NamelistError(
            "more than one melt pond scheme active "
            "(reference check, mpas_seaice_column.F:9193-9200)")
    if ponds:
        col_kw["pond_scheme"] = ponds[0]
    if special.get("use_aerosols", False):
        col_kw.setdefault("n_aerosols", 2)
    if special.get("use_effective_snow_density", False) or \
            special.get("use_snow_grain_radius", False):
        col_kw["use_snow_tracers"] = True
    if not special.get("use_advection", True):
        adv_kw["advection_type"] = AdvectionType.NONE
    if not special.get("use_dynamics", True):
        # gates velocity solve + advection + the dynamics column phase
        # (reference config_use_dynamics, Registry use_sections)
        vel_kw["use_velocity_solver"] = False
        adv_kw["advection_type"] = AdvectionType.NONE
        col_kw["use_ridging"] = False

    if zbgc_touched:
        from .column.zbgc import ZbgcParams
        # tuple-slot assignments (e.g. mu_max[0]) are collected per field
        plain = {k: v for k, v in zbgc_kw.items() if "[" not in k}
        slots: Dict[str, Dict[int, float]] = {}
        for k, v in zbgc_kw.items():
            m = re.match(r"(\w+)\[(\d+)\]$", k)
            if m:
                slots.setdefault(m.group(1), {})[int(m.group(2))] = v
        base = ZbgcParams(n_algae=col_kw.get("n_algae", 3))
        for fld, idx_map in slots.items():
            cur = list(getattr(base, fld))
            for i, v in idx_map.items():
                cur[i] = v
            plain[fld] = tuple(cur)
        col_kw["zbgc_params"] = dataclasses.replace(base, **plain)
        col_kw.setdefault("n_algae", base.n_algae)

    cfg = Config(
        run=RunConfig(**run_kw),
        velocity=VelocitySolverConfig(**vel_kw),
        advection=AdvectionConfig(**adv_kw),
        column=ColumnConfig(**col_kw))
    setup_kw.update(overrides)
    return cfg, RunSetup(**setup_kw)


# -- namelist-driven model assembly ----------------------------------------------

def _parse_duration(s: str) -> float:
    """MPAS duration 'YY-MM-DD_hh:mm:ss' (months rejected) or
    'DD_hh:mm:ss' or 'hh:mm:ss' -> seconds."""
    s = s.strip()
    days = 0.0
    if "_" in s:
        dpart, s = s.split("_", 1)
        fields = [int(x) for x in dpart.split("-")]
        while len(fields) < 3:
            fields.insert(0, 0)
        yy, mm, dd = fields
        if mm:
            raise NamelistError(
                f"month-valued run_duration not supported: {s!r}")
        days = yy * 365.0 + dd
    hh, mi, ss = (int(x) for x in s.split(":"))
    return days * 86400.0 + hh * 3600.0 + mi * 60.0 + ss


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


# -- audit report ---------------------------------------------------------------

def audit_rows():
    """(record, option, disposition, target-or-reason) rows for
    REGISTRY_AUDIT.md generation and the cross-check test."""
    for o in _TABLE:
        detail = o.target if o.disposition == "supported" else o.reason
        yield (o.record, o.full_name, o.disposition, detail, o.default)


def audit_summary() -> Dict[str, int]:
    out = {"supported": 0, "na": 0, "unsupported": 0}
    for o in _TABLE:
        out[o.disposition] += 1
    out["total"] = len(_TABLE)
    return out
