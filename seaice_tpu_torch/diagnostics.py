"""Diagnostics: state sanity checks, conservation budgets, regional
statistics, and phase timers.

The port of the JAX package's `diagnostics.py`, the reference's
`mpas_seaice_diagnostics.F` (seaice_check_state :170, load-balance
timers :504) and its conservation_check / regional statistics analysis
members (`mpas_seaice_conservation_check.F:1915+`,
`mpas_seaice_regional_statistics.F`).  `check_state` returns 0-d
tensors on the state's device and makes no host sync; the host decides
in `error.py`.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import constants as c
from .model import State


# -- state sanity check (reference seaice_check_state) ------------------------

def check_state(state: State, max_velocity: float = 5.0,
                max_thickness: float = 50.0) -> Dict[str, Any]:
    """Scan prognostic fields for NaN/Inf and physically absurd values.
    Returns {"ok", and one flag per check}: 0-d bool tensors on the
    state's device (no host sync)."""
    a = state.tracers["iceAreaCategory"]
    v = state.tracers["iceVolumeCategory"]
    u = state.velocity.u_velocity
    w = state.velocity.v_velocity
    speed = torch.sqrt(u ** 2 + w ** 2)
    aice = a.sum(-1)
    has = a > c.PUNY
    thickness = torch.where(has, v / torch.where(has, a, 1.0), 0.0)
    checks = {
        "finite_area": torch.isfinite(a).all(),
        "finite_volume": torch.isfinite(v).all(),
        "finite_velocity": torch.isfinite(u).all() & torch.isfinite(w).all(),
        "area_bounds": (a >= -c.PUNY).all() & (aice <= 1.0 + 1e-6).all(),
        "volume_nonneg": (v >= -c.PUNY).all(),
        "velocity_bound": (speed <= max_velocity).all(),
        "thickness_bound": (thickness <= max_thickness).all(),
    }
    ok = torch.stack(list(checks.values())).all()
    checks["ok"] = ok
    return checks


# -- conservation budgets (conservation_check analysis member) ----------------

def total_budgets(state: State, area_cell) -> Dict[str, Any]:
    """Global extensive totals: ice area (m^2), ice/snow mass (kg),
    internal energy (J), salt (kg), the quantities the reference's
    conservation_check closes against coupler fluxes
    (compute_total_* at :1915+).  0-d tensors."""
    tr = state.tracers
    a = tr["iceAreaCategory"]
    v = tr["iceVolumeCategory"]
    vs = tr["snowVolumeCategory"]
    ac = area_cell[:, None]
    out = {
        "ice_area": (a * ac).sum(),
        "ice_mass": c.DENSITY_ICE * (v * ac).sum(),
        "snow_mass": c.DENSITY_SNOW * (vs * ac).sum(),
    }
    if "iceEnthalpy" in tr:
        ni = tr["iceEnthalpy"].shape[-1]
        out["ice_energy"] = ((v / ni)[..., None] * tr["iceEnthalpy"] *
                             ac[..., None]).sum()
    if "snowEnthalpy" in tr:
        ns = tr["snowEnthalpy"].shape[-1]
        out["snow_energy"] = ((vs / ns)[..., None] * tr["snowEnthalpy"] *
                              ac[..., None]).sum()
    if "iceSalinity" in tr:
        ni = tr["iceSalinity"].shape[-1]
        out["salt_mass"] = c.DENSITY_ICE * 1e-3 * (
            (v / ni)[..., None] * tr["iceSalinity"] * ac[..., None]).sum()
    return out


def _host_floats(d: Dict[str, Any]) -> Dict[str, float]:
    """{name: 0-d tensor} -> {name: float} in one device-to-host copy."""
    vals = torch.stack([torch.as_tensor(v) for v in d.values()])
    return dict(zip(d, vals.double().cpu().tolist()))


class ConservationMonitor:
    """Closes budget changes against accumulated boundary fluxes over a
    window (the conservation_check analysis member pattern)."""

    def __init__(self, area_cell):
        self.area_cell = area_cell
        self.reference: Optional[Dict[str, float]] = None
        self.accumulated: Dict[str, float] = {}

    def reset(self, state: State):
        self.reference = _host_floats(total_budgets(state, self.area_cell))
        self.accumulated = {"fresh": 0.0, "fhocn": 0.0, "fsalt": 0.0}

    def accumulate_fluxes(self, fluxes, dt: float):
        """fluxes: ColumnFluxes (per cell); integrates area-weighted."""
        ac = self.area_cell
        sums = _host_floats({k: (getattr(fluxes, k) * ac).sum()
                             for k in ("fresh", "fsalt", "fhocn")})
        for k, s in sums.items():
            self.accumulated[k] += s * dt

    def errors(self, state: State) -> Dict[str, float]:
        """Relative budget-closure errors since reset."""
        now = _host_floats(total_budgets(state, self.area_cell))
        d_mass = (now["ice_mass"] + now["snow_mass"] -
                  self.reference["ice_mass"] -
                  self.reference["snow_mass"])
        # fresh flux is water ADDED to the ocean = mass REMOVED from ice
        expected = -self.accumulated["fresh"]
        scale = max(abs(now["ice_mass"]), abs(expected), 1.0)
        out = {"mass_closure": abs(d_mass - expected) / scale}
        if "salt_mass" in now:
            d_salt = now["salt_mass"] - self.reference["salt_mass"]
            exp_salt = -self.accumulated["fsalt"]
            scale = max(abs(now["salt_mass"]), abs(exp_salt), 1.0)
            out["salt_closure"] = abs(d_salt - exp_salt) / scale
        return out


# -- regional statistics (regional_statistics member) -------------------------

def regional_statistics(state: State, area_cell, region_mask,
                        n_regions: int, mesh_t=None) -> Dict[str, Any]:
    """Per-region statistics by segment sums (reference
    mpas_seaice_regional_statistics.F, region-masked sums over ~30
    quantities): area/extent/volume totals, kinetic energy and RMS speed
    (needs mesh_t for the vertex->cell velocity interpolation), internal
    energy, salt, ponds, level/ridged partition, age/FY areas, and
    thickness mean/max.  region_mask: [nCells] integer tensor."""
    tr = state.tracers
    aicen = tr["iceAreaCategory"]
    vicen = tr["iceVolumeCategory"]
    vsnon = tr["snowVolumeCategory"]
    aice = aicen.sum(-1)
    vice = vicen.sum(-1)
    vsno = vsnon.sum(-1)
    region_mask = torch.as_tensor(region_mask, device=aice.device).long()

    def seg(x):
        return torch.zeros(n_regions, dtype=x.dtype, device=x.device
                           ).index_add_(0, region_mask, x)

    def segmax(x):
        return torch.full((n_regions,), -torch.inf, dtype=x.dtype,
                          device=x.device).scatter_reduce_(
                              0, region_mask, x, "amax")

    zero = torch.zeros_like(area_cell)
    a_tot = seg(aice * area_cell)
    v_tot = seg(vice * area_cell)
    out = {
        "total_ice_area": a_tot,
        "total_ice_extent": seg(torch.where(aice > 0.15, area_cell, zero)),
        "total_ice_volume": v_tot,
        "total_snow_volume": seg(vsno * area_cell),
        "total_open_water_area": seg((1.0 - aice).clamp(min=0.0) *
                                     area_cell),
        "average_ice_thickness": v_tot / a_tot.clamp(min=1.0),
        "max_ice_thickness": segmax(torch.where(
            aice > c.PUNY, vice / aice.clamp(min=c.PUNY), 0.0)),
    }
    # kinetic energy / RMS ice speed (the reference computes KE from the
    # cell-interpolated velocity and the ice+snow mass)
    if mesh_t is not None:
        from .mesh.core import vertex_to_cell
        uc = vertex_to_cell(mesh_t, state.velocity.u_velocity)
        vc = vertex_to_cell(mesh_t, state.velocity.v_velocity)
        sp2 = uc * uc + vc * vc
        mass = c.DENSITY_ICE * vice + c.DENSITY_SNOW * vsno
        out["total_kinetic_energy"] = seg(0.5 * mass * sp2 * area_cell)
        spd_w = seg(torch.sqrt(sp2) * aice * area_cell)
        out["rms_ice_speed"] = torch.sqrt(
            seg(sp2 * aice * area_cell) / a_tot.clamp(min=1.0))
        out["average_ice_speed"] = spd_w / a_tot.clamp(min=1.0)
    # internal energy / salt (energy and salt sums of the reference)
    if "iceEnthalpy" in tr:
        ni = tr["iceEnthalpy"].shape[-1]
        e = ((vicen / ni)[..., None] * tr["iceEnthalpy"]).sum((-2, -1))
        out["total_ice_energy"] = seg(e * area_cell)
    if "snowEnthalpy" in tr:
        ns = tr["snowEnthalpy"].shape[-1]
        e = ((vsnon / ns)[..., None] * tr["snowEnthalpy"]).sum((-2, -1))
        out["total_snow_energy"] = seg(e * area_cell)
    if "iceSalinity" in tr:
        ni = tr["iceSalinity"].shape[-1]
        s = ((vicen / ni)[..., None] * tr["iceSalinity"]).sum((-2, -1))
        out["total_salt_mass"] = seg(c.DENSITY_ICE * 1e-3 * s * area_cell)
    # ponds
    if "pondArea" in tr:
        apnd = tr["pondArea"]
        if "levelIceArea" in tr:
            apnd = apnd * tr["levelIceArea"]
        pa = (apnd * aicen).sum(-1)
        out["total_pond_area"] = seg(pa * area_cell)
        if "pondDepth" in tr:
            out["total_pond_volume"] = seg(
                (apnd * tr["pondDepth"] * aicen).sum(-1) * area_cell)
    # level / ridged partition
    if "levelIceArea" in tr:
        alvl = (tr["levelIceArea"] * aicen).sum(-1)
        out["total_level_ice_area"] = seg(alvl * area_cell)
        out["total_ridged_ice_area"] = seg((aice - alvl) * area_cell)
    if "levelIceVolume" in tr:
        vlvl = (tr["levelIceVolume"] * vicen).sum(-1)
        out["total_level_ice_volume"] = seg(vlvl * area_cell)
        out["total_ridged_ice_volume"] = seg((vice - vlvl) * area_cell)
    # age / first-year
    if "iceAge" in tr:
        aw = (tr["iceAge"] * aicen).sum(-1)
        out["average_ice_age"] = seg(aw * area_cell) / a_tot.clamp(min=1.0)
    if "firstYearIceArea" in tr:
        out["total_first_year_ice_area"] = seg(
            (tr["firstYearIceArea"] * aicen).sum(-1) * area_cell)
    if "brineHeight" in tr:
        out["average_brine_height"] = seg(
            (tr["brineHeight"] * aicen).sum(-1) * area_cell) / \
            a_tot.clamp(min=1.0)
    return out


def hemisphere_region_mask(mesh) -> np.ndarray:
    """Two-region mask: 0 = northern hemisphere, 1 = southern (the
    reference's standard region file splits hemispheres)."""
    lat = getattr(mesh, "lat_cell", None)
    if lat is None:
        return np.zeros(mesh.n_cells, np.int32)
    return (np.asarray(lat) < 0.0).astype(np.int32)


# -- phase timers -------------------------------------------------------------

def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimers:
    """Named wall-clock timers, the analog of the reference's
    hierarchical mpas_timer instrumentation
    (velocity_solver.F:579-669).  `time` reads the host clock only;
    `timed` synchronises the card after the call."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def time(self, name: str):
        timers = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                timers.totals[name] = timers.totals.get(name, 0.0) + dt
                timers.counts[name] = timers.counts.get(name, 0) + 1
                return False

        return _Ctx()

    def timed(self, name: str, fn, *args, **kwargs):
        with self.time(name):
            out = fn(*args, **kwargs)
            _sync()
        return out

    def report(self) -> str:
        lines = ["timer                          total(s)   calls  mean(ms)"]
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            n = self.counts[k]
            lines.append(f"{k:<30} {self.totals[k]:>8.3f} {n:>7d} "
                         f"{1000.0 * self.totals[k] / n:>9.2f}")
        return "\n".join(lines)
