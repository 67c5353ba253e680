"""Concrete analysis members (the port of the JAX package's
`analysis/members.py`; reference `src/analysis_members/`).  Members
compute from the State on its device and return dicts of tensors (0-d
for scalars), fetched to the host when they write
(`utils.containers.to_host`); the conservation check returns the host
floats of `ConservationMonitor` and the load balance host counts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import constants as c
from ..column.thermo_shared import (ice_temperature_from_enthalpy,
                                    melting_temperature,
                                    snow_temperature_from_enthalpy)
from ..diagnostics import (ConservationMonitor, hemisphere_region_mask,
                           regional_statistics, total_budgets)
from .driver import AnalysisMember


def _cell_mean(x, aice):
    """x / aice where there is ice, else 0."""
    return torch.where(aice > c.PUNY, x / aice.clamp(min=c.PUNY), 0.0)


class HighFrequencyOutputMember(AnalysisMember):
    """Instantaneous key fields (reference
    mpas_seaice_high_frequency_output.F)."""

    name = "high_frequency_output"

    def compute(self, model, state, clock):
        tr = state.tracers
        return {
            "iceAreaCellHF": tr["iceAreaCategory"].sum(-1),
            "iceVolumeCellHF": tr["iceVolumeCategory"].sum(-1),
            "uVelocityHF": state.velocity.u_velocity.clone(),
            "vVelocityHF": state.velocity.v_velocity.clone(),
        }


class TemperaturesMember(AnalysisMember):
    """Layer temperatures from enthalpy/salinity tracers (reference
    mpas_seaice_temperatures.F)."""

    name = "temperatures"

    def compute(self, model, state, clock):
        tr = state.tracers
        out = {}
        if "iceEnthalpy" in tr and "iceSalinity" in tr:
            t_ice = ice_temperature_from_enthalpy(
                tr["iceEnthalpy"], melting_temperature(tr["iceSalinity"]))
            has = tr["iceVolumeCategory"][..., None] > c.PUNY
            out["iceTemperature"] = torch.where(has, t_ice, 0.0)
        if "snowEnthalpy" in tr:
            t_snow = snow_temperature_from_enthalpy(tr["snowEnthalpy"])
            has = tr["snowVolumeCategory"][..., None] > c.PUNY
            out["snowTemperature"] = torch.where(has, t_snow, 0.0)
        return out


class RegionalStatisticsMember(AnalysisMember):
    """Region-masked statistics (reference
    mpas_seaice_regional_statistics.F: ~30 quantities per region).
    Defaults to the hemisphere split of the reference's standard region
    file."""

    name = "regional_statistics"

    def __init__(self, region_mask=None, n_regions: int = None, **kw):
        super().__init__(**kw)
        self.region_mask = region_mask
        self.n_regions = n_regions

    def init(self, model, state):
        if self.region_mask is None:
            m = hemisphere_region_mask(model.mesh)
            self.n_regions = int(m.max()) + 1
        else:
            m = np.asarray(self.region_mask)
            if self.n_regions is None:
                self.n_regions = int(m.max()) + 1
        self.region_mask = torch.as_tensor(m.astype(np.int64)).to(
            model.device)

    def compute(self, model, state, clock):
        return regional_statistics(state, model.tensors.area_cell,
                                   self.region_mask, self.n_regions,
                                   mesh_t=model.tensors.mesh)


class ConservationCheckMember(AnalysisMember):
    """Global budget closure vs accumulated fluxes (reference
    mpas_seaice_conservation_check.F:282-496,1915+)."""

    name = "conservation_check"

    def __init__(self, **kw):
        super().__init__(**kw)
        self.monitor: Optional[ConservationMonitor] = None

    def init(self, model, state):
        self.monitor = ConservationMonitor(model.tensors.area_cell)
        self.monitor.reset(state)

    def accumulate(self, fluxes, dt):
        if self.monitor is not None:
            self.monitor.accumulate_fluxes(fluxes, dt)

    def compute(self, model, state, clock):
        errs = self.monitor.errors(state)
        out = dict(total_budgets(state, model.tensors.area_cell))
        out.update({f"closure_{k}": v for k, v in errs.items()})
        self.monitor.reset(state)
        return out


class IcePresenceMember(AnalysisMember):
    """Binary ice presence (reference mpas_seaice_ice_present.F)."""

    name = "ice_present"

    def compute(self, model, state, clock):
        a = state.tracers["iceAreaCategory"].sum(-1)
        return {"icePresent": (a > c.PUNY).to(a.dtype)}


class MaximumIcePresenceMember(AnalysisMember):
    """Running maximum of presence over the run (reference
    mpas_seaice_maximum_ice_presence.F)."""

    name = "maximum_ice_presence"

    def init(self, model, state):
        self._max = torch.zeros(model.mesh.n_cells, dtype=model.dtype,
                                device=model.device)

    def compute(self, model, state, clock):
        a = state.tracers["iceAreaCategory"].sum(-1)
        self._max = torch.maximum(self._max, (a > c.PUNY).to(a.dtype))
        return {"maximumIcePresence": self._max.clone()}


class AreaVariablesMember(AnalysisMember):
    """Derived area quantities (reference
    mpas_seaice_area_variables.F): open-water area, category areas."""

    name = "area_variables"

    def compute(self, model, state, clock):
        a = state.tracers["iceAreaCategory"]
        aice = a.sum(-1)
        return {"iceAreaCell": aice,
                "openWaterArea": (1.0 - aice).clamp(min=0.0),
                "iceAreaCategory": a.clone()}


class LoadBalanceMember(AnalysisMember):
    """Owned-cell counts per block (reference
    mpas_seaice_load_balance.F); trivial on one device.  Host counts."""

    name = "load_balance"

    def __init__(self, partition=None, **kw):
        super().__init__(**kw)
        self.partition = partition

    def compute(self, model, state, clock):
        if self.partition is None:
            return {"nCellsProc": np.array([model.mesh.n_cells])}
        counts = [int((b.cell_global[:b.n_cells_owned] >= 0).sum())
                  for b in self.partition.blocks]
        return {"nCellsProc": np.array(counts)}


class PointwiseStatsMember(AnalysisMember):
    """Field values at selected cells (reference
    mpas_seaice_pointwise_stats.F)."""

    name = "pointwise_stats"

    def __init__(self, cell_indices, **kw):
        super().__init__(**kw)
        self.cells = np.asarray(cell_indices)
        self._cells = None

    def init(self, model, state):
        self._cells = torch.as_tensor(self.cells.astype(np.int64)).to(
            model.device)

    def compute(self, model, state, clock):
        if self._cells is None:
            self.init(model, state)
        tr = state.tracers
        return {"iceAreaAtPoints":
                tr["iceAreaCategory"].sum(-1)[self._cells],
                "iceVolumeAtPoints":
                tr["iceVolumeCategory"].sum(-1)[self._cells]}


def extract_field(model, state, name: str) -> torch.Tensor:
    """Resolve any supported field name to a tensor: the analog of the
    reference time-series engine's registry-driven field lookup
    (mpas_seaice_time_series_stats.F templates over ANY registered
    field).  Supported names, in lookup order:

      1. velocity: 'uVelocity' / 'vVelocity' (vertex fields)
      2. any raw tracer name in state.tracers (native [nCells, nCat,
         (nLayers)] shape; reductions are elementwise over time)
      3. derived: 'iceThicknessCell', 'snowDepthCell', 'iceSpeed'
      4. any cell-mean aggregate of ColumnPhysics.aggregate
         ('iceAreaCell', 'iceVolumeCell', 'snowVolumeCell',
         'openWaterArea', 'surfaceTemperatureCell', 'iceAgeCell', ...)

    Unknown names raise ValueError: a misconfigured stats member must
    fail loudly, not silently drop the field."""
    if name == "uVelocity":
        return state.velocity.u_velocity
    if name == "vVelocity":
        return state.velocity.v_velocity
    tr = state.tracers
    if name in tr:
        return tr[name]
    aice = tr["iceAreaCategory"].sum(-1)
    if name == "iceThicknessCell":
        return _cell_mean(tr["iceVolumeCategory"].sum(-1), aice)
    if name == "snowDepthCell":
        return _cell_mean(tr["snowVolumeCategory"].sum(-1), aice)
    if name == "iceSpeed":
        u, v = state.velocity.u_velocity, state.velocity.v_velocity
        return torch.sqrt(u * u + v * v)
    if model is not None and getattr(model, "column", None) is not None:
        agg = model.column.aggregate(tr)
        if name in agg:
            return agg[name]
    else:
        # column package off: the basic aggregates directly
        basic = {
            "iceAreaCell": aice,
            "iceVolumeCell": tr["iceVolumeCategory"].sum(-1),
            "snowVolumeCell": tr["snowVolumeCategory"].sum(-1),
            "openWaterArea": (1.0 - aice).clamp(min=0.0),
        }
        if name in basic:
            return basic[name]
    raise ValueError(
        f"time_series_stats: unknown field {name!r} (not a tracer, "
        "velocity, aggregate, or derived field)")


class TimeSeriesStatsMember(AnalysisMember):
    """Windowed avg/min/max/sum-of-squares reductions over an ARBITRARY
    configured field list (reference mpas_seaice_time_series_stats.F +
    time_series_inc templates; the daily/monthly/climatology instances
    are separate members with different windows).  Fields resolve
    through `extract_field`; unknown names raise at the first
    accumulation.  The accumulators live on the device."""

    name = "time_series_stats"

    def __init__(self, fields=("iceAreaCell", "iceVolumeCell"),
                 operations=("avg", "min", "max", "sos"), **kw):
        super().__init__(**kw)
        self.fields = fields
        self.operations = operations
        self._acc: Dict[str, Any] = {}
        self._n = 0

    def _extract(self, state, model=None) -> Dict[str, Any]:
        return {name: extract_field(model, state, name)
                for name in self.fields}

    def precompute(self, model, state, clock):
        cur = self._extract(state, model)
        if not self._acc:
            for k, v in cur.items():
                self._acc[f"{k}_sum"] = v.clone()
                self._acc[f"{k}_min"] = v.clone()
                self._acc[f"{k}_max"] = v.clone()
                self._acc[f"{k}_sos"] = v * v
            self._n = 1
        else:
            for k, v in cur.items():
                self._acc[f"{k}_sum"] = self._acc[f"{k}_sum"] + v
                self._acc[f"{k}_min"] = torch.minimum(
                    self._acc[f"{k}_min"], v)
                self._acc[f"{k}_max"] = torch.maximum(
                    self._acc[f"{k}_max"], v)
                self._acc[f"{k}_sos"] = self._acc[f"{k}_sos"] + v * v
            self._n += 1

    def compute(self, model, state, clock):
        out = {}
        n = max(self._n, 1)
        for k in self.fields:
            if f"{k}_sum" not in self._acc:
                continue
            if "avg" in self.operations:
                out[f"{k}_avg"] = self._acc[f"{k}_sum"] / n
            if "min" in self.operations:
                out[f"{k}_min"] = self._acc[f"{k}_min"]
            if "max" in self.operations:
                out[f"{k}_max"] = self._acc[f"{k}_max"]
            if "sos" in self.operations:
                out[f"{k}_sos"] = self._acc[f"{k}_sos"]
        self._acc = {}
        self._n = 0
        return out


class RidgingDiagnosticsMember(AnalysisMember):
    """Ridging rates and level/ridged partition (reference
    mpas_seaice_ridging_diagnostics.F)."""

    name = "ridging_diagnostics"
    diag_keys = ("dardg1dt", "dardg2dt", "dvirdgdt", "opening")

    def compute(self, model, state, clock):
        tr = state.tracers
        out: Dict[str, Any] = {}
        a = tr["iceAreaCategory"]
        v = tr["iceVolumeCategory"]
        if "levelIceArea" in tr:
            alvl = (tr["levelIceArea"] * a).sum(-1)
            out["levelIceAreaCell"] = alvl
            out["ridgedIceAreaCell"] = a.sum(-1) - alvl
        if "levelIceVolume" in tr:
            vlvl = (tr["levelIceVolume"] * v).sum(-1)
            out["levelIceVolumeCell"] = vlvl
            out["ridgedIceVolumeCell"] = v.sum(-1) - vlvl
        d = self.last_diags or {}
        for k in self.diag_keys:
            if k in d:
                out[k] = d[k]
        return out


class PondDiagnosticsMember(AnalysisMember):
    """Pond area/depth/volume cell means (reference
    mpas_seaice_pond_diagnostics.F)."""

    name = "pond_diagnostics"

    def compute(self, model, state, clock):
        tr = state.tracers
        if "pondArea" not in tr:
            return {}
        a = tr["iceAreaCategory"]
        apnd = tr["pondArea"]
        if "levelIceArea" in tr and model.cfg.column.pond_scheme == "lvl":
            apnd = apnd * tr["levelIceArea"]
        pond_area = (apnd * a).sum(-1)
        pond_vol = (apnd * tr["pondDepth"] * a).sum(-1)
        out = {"pondAreaCell": pond_area, "pondVolumeCell": pond_vol,
               "pondDepthCell": _cell_mean(pond_vol, pond_area)}
        if "pondLidThickness" in tr:
            out["pondLidThicknessCell"] = (
                tr["pondLidThickness"] * apnd * a).sum(-1)
        return out


class GeographicalVectorsMember(AnalysisMember):
    """Velocities rotated to geographic eastward/northward components
    (reference mpas_seaice_geographical_vectors.F).  The rotation is
    linear in (u, v): its four coefficients per vertex come from the
    geometry once (`mesh.rotation`, float64), the product runs on the
    device."""

    name = "geographical_vectors"

    def init(self, model, state):
        from ..mesh.rotation import latlon_vector_rotation_reverse
        mesh = model.mesh
        self._coef = None
        if getattr(mesh, "lat_vertex", None) is not None and \
                getattr(mesh, "z_vertex", None) is not None:
            one, zero = np.ones(mesh.n_vertices), np.zeros(mesh.n_vertices)
            xyz = (mesh.x_vertex, mesh.y_vertex, mesh.z_vertex)
            cu = latlon_vector_rotation_reverse(one, zero, *xyz)
            cv = latlon_vector_rotation_reverse(zero, one, *xyz)
            self._coef = [torch.as_tensor(np.asarray(a, np.float64)).to(
                device=model.device, dtype=model.dtype)
                for a in (*cu, *cv)]

    def compute(self, model, state, clock):
        if not hasattr(self, "_coef"):
            self.init(model, state)
        u = state.velocity.u_velocity
        v = state.velocity.v_velocity
        if self._coef is None:      # planar mesh: already geographic
            return {"uVelocityGeo": u.clone(), "vVelocityGeo": v.clone()}
        ue_u, vn_u, ue_v, vn_v = self._coef
        return {"uVelocityGeo": u * ue_u + v * ue_v,
                "vVelocityGeo": u * vn_u + v * vn_v}


class MiscellaneousMember(AnalysisMember):
    """Derived per-cell quantities (reference
    mpas_seaice_miscellaneous.F): mean thickness, snow depth, surface
    temperature."""

    name = "miscellaneous"

    def compute(self, model, state, clock):
        tr = state.tracers
        a = tr["iceAreaCategory"]
        aice = a.sum(-1)
        out = {
            "iceThicknessCell": _cell_mean(tr["iceVolumeCategory"].sum(-1),
                                           aice),
            "snowDepthCell": _cell_mean(tr["snowVolumeCategory"].sum(-1),
                                        aice),
        }
        if "surfaceTemperature" in tr:
            out["surfaceTemperatureCell"] = _cell_mean(
                (tr["surfaceTemperature"] * a).sum(-1), aice)
        return out


class UnitConversionMember(AnalysisMember):
    """Standard-unit copies of key outputs (reference
    mpas_seaice_unit_conversion.F): velocity cm/s, concentration %,
    hemispheric totals in 1e6 km^2 / km^3."""

    name = "unit_conversion"

    def compute(self, model, state, clock):
        tr = state.tracers
        aice = tr["iceAreaCategory"].sum(-1)
        area_cell = model.tensors.area_cell
        return {
            "uVelocityCmPerS": state.velocity.u_velocity * 100.0,
            "vVelocityCmPerS": state.velocity.v_velocity * 100.0,
            "iceConcentrationPercent": aice * 100.0,
            "totalIceExtentMkm2": ((aice > 0.15) * area_cell).sum() / 1.0e12,
            "totalIceVolumeKm3": (tr["iceVolumeCategory"].sum(-1) *
                                  area_cell).sum() / 1.0e9,
        }


class IceShelvesMember(AnalysisMember):
    """Statistics under/near land-ice (reference
    mpas_seaice_ice_shelves.F): masked area/volume totals."""

    name = "ice_shelves"

    def __init__(self, land_ice_mask=None, **kw):
        super().__init__(**kw)
        self.land_ice_mask = land_ice_mask

    def init(self, model, state):
        m = self.land_ice_mask
        m = np.zeros(model.mesh.n_cells) if m is None else np.asarray(m)
        self.land_ice_mask = torch.as_tensor(m.astype(np.float64)).to(
            device=model.device, dtype=model.dtype)

    def compute(self, model, state, clock):
        m = self.land_ice_mask
        area_cell = model.tensors.area_cell
        aice = state.tracers["iceAreaCategory"].sum(-1)
        vice = state.tracers["iceVolumeCategory"].sum(-1)
        return {"iceAreaShelf": (aice * m * area_cell).sum(),
                "iceVolumeShelf": (vice * m * area_cell).sum()}


class ClimatologyStatsMember(TimeSeriesStatsMember):
    """Climatology instance of the time-series engine (reference
    time_series_stats climatology XML instance): accumulates per
    calendar month across years; compute returns the running monthly
    climatology means."""

    name = "time_series_stats_climatology"

    def __init__(self, **kw):
        kw.setdefault("compute_interval", 86400.0)
        super().__init__(**kw)
        self._monthly_sum: Dict[int, Dict[str, Any]] = {}
        self._monthly_n: Dict[int, int] = {}

    def precompute(self, model, state, clock):
        cur = self._extract(state, model)
        month = clock.month if hasattr(clock, "month") else (
            int(clock.day_of_year // 30.5) % 12 + 1)
        if month not in self._monthly_sum:
            self._monthly_sum[month] = {k: v.clone() for k, v in cur.items()}
            self._monthly_n[month] = 1
        else:
            sums = self._monthly_sum[month]
            for k, v in cur.items():
                sums[k] = sums[k] + v
            self._monthly_n[month] += 1

    def compute(self, model, state, clock):
        out = {}
        for month, sums in self._monthly_sum.items():
            n = max(self._monthly_n[month], 1)
            for k, v in sums.items():
                out[f"{k}_clim_m{month:02d}"] = v / n
        return out


def time_series_instances() -> List[AnalysisMember]:
    """The daily/monthly/climatology windowed instances (reference
    per-instance Registry XMLs of time_series_stats)."""
    daily = TimeSeriesStatsMember(compute_interval=86400.0)
    daily.name = "time_series_stats_daily"
    monthly = TimeSeriesStatsMember(compute_interval=30 * 86400.0)
    monthly.name = "time_series_stats_monthly"
    return [daily, monthly, ClimatologyStatsMember()]


def default_members(compute_interval: float = 86400.0
                    ) -> List[AnalysisMember]:
    """The full member roster (reference src/analysis_members/: 19
    registered members; deactivate_unneeded_fields is subsumed by the
    lazy state and TEMPLATE by the AnalysisMember base)."""
    return [
        HighFrequencyOutputMember(compute_interval),
        TemperaturesMember(compute_interval),
        RegionalStatisticsMember(compute_interval=compute_interval),
        ConservationCheckMember(compute_interval=compute_interval),
        IcePresenceMember(compute_interval),
        MaximumIcePresenceMember(compute_interval),
        AreaVariablesMember(compute_interval),
        LoadBalanceMember(compute_interval=compute_interval),
        RidgingDiagnosticsMember(compute_interval),
        PondDiagnosticsMember(compute_interval),
        GeographicalVectorsMember(compute_interval),
        MiscellaneousMember(compute_interval),
        UnitConversionMember(compute_interval),
        IceShelvesMember(compute_interval=compute_interval),
        PointwiseStatsMember([0], compute_interval=compute_interval),
        TimeSeriesStatsMember(compute_interval=compute_interval),
    ] + time_series_instances()
