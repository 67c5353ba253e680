"""Column-physics phase drivers.

Port of the JAX package's `column/driver.py`, which re-designs the
reference's MPAS <-> column adapter phase drivers (`mpas_seaice_column.F`:
predynamics :1038, dynamics :1139, postdynamics :1208) and the colpkg
step routines they call (`ice_colpkg.F90`: colpkg_step_therm1
:1789-2408, colpkg_step_therm2, colpkg_step_ridge, colpkg_step_snow
:3821, colpkg_ice_strength): instead of a loop over cells calling scalar
colpkg routines, each phase is one vectorized pass over
[nCells, nCategories] columns.

Scheme selectors mirror `ice_colpkg_shared.F90:20-150`.  The port runs
zero-layer, BL99 and mushy thermodynamics (`ktherm` 0, 1, 2), the
prescribed surface fluxes of calc_Tsfc=False (with ktherm 0 or 1), the
CCSM3, delta-Eddington and SNICAR shortwave (with the snow grain-radius
tracer), bulk and modal aerosols, Hibler and Rothrock strength, the
CESM, level-ice and topographic ponds (with the snow-liquid routing and
the pond freshwater feedback), ice age, first-year ice, the snow
tracers with their physics and the three snow redistribution schemes,
form drag, high-frequency coupling, ITD thermodynamics + ridging, and
the brine height with the vertical salinity and the skeletal or vertical
(z-layer) biogeochemistry, the z-layer aerosols among its tracers
(`step_biogeochemistry`, after the vertical thermodynamics as in the
reference's column_biogeochemistry).

Deviation from the reference phasing (as in the JAX package): shortwave
radiation is computed at the START of therm1 from the current forcing;
the post-dynamics phase runs snow physics and coupling-prep aggregation.

The numpy tables (category bounds, the BL99 salinity profile, the dEdd
snow optics, the aerosol optics, the SNICAR tables, the bio grid and the
zBGC parameters) are made once here in the state's dtype and on its
device, so an f32 step stays f32 and a step copies no table to the card:
the category bounds as Python floats, the rest as tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import constants as c
from .atmo import (atmo_boundary_layer, atmo_constant_coefficients,
                   neutral_drag_coeffs)
from .itd import (category_boundaries, cleanup_small_ice,
                  ice_strength_hibler, ice_strength_rothrock,
                  linear_itd_remap)
from .itd_thermo import add_new_ice, lateral_melt
from .ponds import increment_age
from .ridging import ridge_bounds, ridge_ice
from .shortwave import ShortwaveResult, shortwave_ccsm3
from .snow import (drain_snow, snow_effective_density,
                   snow_redistribution, update_snow_radius,
                   wind_compaction, wind_snow_loss)
from .thermo_shared import ice_temperature_from_enthalpy, salinity_profile
from .vertical import (frzmlt_bottom_lateral, thermo_vertical,
                       thermo_vertical_noop)
from ..utils.containers import tensor_dataclass
from ..utils.device import resolve_device


@tensor_dataclass
class AtmosForcing:
    """Cell-centered atmospheric state (reference atmos_coupling pool)."""
    air_temperature: Any       # K (potential temperature)
    specific_humidity: Any     # kg/kg
    u_air: Any                 # m/s
    v_air: Any
    longwave_down: Any         # W/m^2
    sw_vis_dir: Any            # W/m^2
    sw_vis_dif: Any
    sw_ir_dir: Any
    sw_ir_dif: Any
    rain_rate: Any             # kg/m^2/s
    snow_rate: Any             # kg/m^2/s
    air_density: Any           # kg/m^3
    air_level_height: Any      # m


@tensor_dataclass
class OceanForcing:
    """Cell-centered ocean state (reference ocean_coupling pool)."""
    sst: Any                   # deg C
    sss: Any                   # ppt
    freezing_temperature: Any  # deg C
    frzmlt: Any                # freezing/melting potential W/m^2
    mixed_layer_depth: Any     # m


@tensor_dataclass
class ColumnFluxes:
    """Aggregate cell fluxes for the coupler/diagnostics."""
    fresh: Any                 # freshwater to ocean (kg/m^2/s)
    fsalt: Any                 # salt to ocean (kg/m^2/s)
    fhocn: Any                 # heat to ocean (W/m^2)
    fswthru: Any               # SW through ice to ocean (W/m^2)
    evap: Any                  # evaporation (kg/m^2/s)
    fsens: Any                 # sensible heat (W/m^2)
    flat: Any                  # latent heat (W/m^2)
    flwout: Any                # outgoing longwave (W/m^2)
    congel: Any                # congelation growth (m)
    frazil: Any                # frazil growth (m)
    snoice: Any                # snow-ice growth (m)
    meltt: Any                 # top melt (m)
    meltb: Any                 # bottom melt (m)
    melts: Any                 # snow melt (m)
    meltl: Any                 # lateral melt (m)
    albedo_vis_dir: Any        # area-weighted albedos
    albedo_ir_dir: Any
    albedo_vis_dif: Any
    albedo_ir_dif: Any
    fpond: Any                 # freshwater into melt ponds (kg/m^2/s)
    faero_ocn: Any             # aerosol flux to ocean [*, nAero] or None
    Cdn_atm: Any               # neutral atm drag (form drag) or None
    Cdn_ocn: Any               # neutral ocn drag (form drag) or None
    bgc: Any                   # BGC diagnostics dict or None
    # per-cell warning masks (True = problem), the column warning
    # buffer analog (reference ice_warnings.F90 + the per-cell abort
    # dump, mpas_seaice_column.F:1872-1939); keys like
    # 'thermo_unconverged' with [*, nCat] bool arrays
    warnings: Any = None
    # iterations the vertical heat solver ran this step (a host count)
    thermo_iterations: int = 0


# Tracer classification: conserved-base groups used by the ITD remap,
# ridging and cleanup (CICE trcr_depend analog).  Area tracers are
# conserved as a*T, ice tracers as v*T, snow tracers as vs*T.  Chained
# weights (e.g. hpnd conserved as a*alvl*apnd*hpnd in the reference's
# nt_strata machinery) are approximated at first order by the direct
# base product, which is exact whenever the intermediate tracers shift
# with the same category fractions.
AREA_TRACER_NAMES = ("surfaceTemperature", "iceAge", "firstYearIceArea",
                     "levelIceArea", "pondArea", "pondDepth",
                     "pondLidThickness", "brineHeight")
ICE_TRACER_NAMES = ("iceEnthalpy", "iceSalinity", "levelIceVolume",
                    "iceScatteringAerosol", "iceBodyAerosol",
                    "bioTracers", "bioMobileFraction", "sklBgc",
                    "verticalSalinity")
SNOW_TRACER_NAMES = ("snowEnthalpy", "snowIceMass", "snowLiquidMass",
                     "snowGrainRadius", "snowScatteringAerosol",
                     "snowBodyAerosol")


def _split_tracers(tracers: Dict[str, Any]):
    aicen = tracers["iceAreaCategory"]
    vicen = tracers["iceVolumeCategory"]
    vsnon = tracers["snowVolumeCategory"]
    at = {k: tracers[k] for k in AREA_TRACER_NAMES if k in tracers}
    it_ = {k: tracers[k] for k in ICE_TRACER_NAMES if k in tracers}
    st = {k: tracers[k] for k in SNOW_TRACER_NAMES if k in tracers}
    return aicen, vicen, vsnon, at, it_, st


def _merge_tracers(tracers, aicen, vicen, vsnon, at, it_, st):
    out = dict(tracers)
    out["iceAreaCategory"] = aicen
    out["iceVolumeCategory"] = vicen
    out["snowVolumeCategory"] = vsnon
    for d in (at, it_, st):
        for k, v in d.items():
            out[k] = v
    return out


class ColumnPhysics:
    """Owns static column configuration (category bounds, salinity
    profile, scheme selectors, optics tables) and provides the phase
    functions.  dtype/device: those of the state it will step."""

    def __init__(self, n_categories: int, n_ice_layers: int,
                 n_snow_layers: int = 1, kcatbound: int = 0,
                 kitd: int = 1, krdg_partic: int = 1,
                 krdg_redist: int = 1, mu_rdg: float = 4.0,
                 natmiter: int = 5, atmbndy: str = "default",
                 use_shortwave: bool = True,
                 use_vertical_thermodynamics: bool = True,
                 use_itd_thermodynamics: bool = True,
                 shortwave: str = "ccsm3",
                 ktherm: int = 1, kstrength: int = 1,
                 pond_scheme: str = "none",
                 use_level_ice: Optional[bool] = None,
                 use_ice_age: bool = False,
                 use_first_year_ice: bool = False,
                 use_snow_tracers: bool = False,
                 snwredist: str = "none",
                 n_aerosols: int = 0,
                 use_form_drag: bool = False,
                 highfreq: bool = False,
                 tfrz_option: str = "minus1p8",
                 rfracmin: float = 0.15, rfracmax: float = 0.85,
                 pndaspect: float = 0.8, hi_min_pond: float = 0.01,
                 dpscale: float = 1.0e-3, frzpnd: str = "hlid",
                 use_snicar: bool = False,
                 use_brine_height: bool = False,
                 use_biogeochemistry: bool = False,
                 use_skeletal_bgc: bool = False,
                 n_algae: int = 1, n_bio_layers: int = 7,
                 solve_zsalinity: bool = False,
                 zbgc_params=None,
                 shortwave_tuning: Optional[Dict[str, float]] = None,
                 tunables=None,
                 calc_tsfc: bool = True,
                 use_snow_liquid_ponds: bool = False,
                 include_pond_freshwater_feedback: bool = False,
                 use_modal_aerosols: bool = False,
                 dtype=torch.float64, device=None):
        if ktherm not in (0, 1, 2):
            raise ValueError(f"unsupported ktherm={ktherm}")
        if not calc_tsfc and ktherm == 2:
            raise ValueError(
                "config_calc_surface_temperature=false is incompatible "
                "with mushy thermodynamics (reference "
                "check_column_package_configs, "
                "mpas_seaice_column.F:9259-9263)")
        if kstrength not in (0, 1):
            raise ValueError(f"unsupported kstrength={kstrength}")
        if pond_scheme not in ("none", "cesm", "lvl", "topo"):
            raise ValueError(f"unsupported pond scheme {pond_scheme!r}")
        if shortwave not in ("ccsm3", "dEdd"):
            raise ValueError(f"unsupported shortwave {shortwave!r}")
        if atmbndy not in ("default", "constant"):
            raise ValueError(f"unsupported atmbndy={atmbndy}")
        if snwredist not in ("none", "bulk", "ITDsd", "ITDrdg"):
            raise ValueError(f"unsupported snwredist={snwredist}")
        use_level_ice = (pond_scheme == "lvl" if use_level_ice is None
                         else use_level_ice)
        if pond_scheme == "lvl" and not use_level_ice:
            raise ValueError("level-ice ponds require level ice tracers")
        if use_snow_liquid_ponds and not use_snow_tracers:
            raise ValueError(
                "config_use_snow_liquid_ponds requires the snow "
                "mass/liquid tracers (config_use_effective_snow_"
                "density; reference config check, "
                "mpas_seaice_column.F:1915-1925)")
        if use_modal_aerosols and shortwave != "dEdd":
            raise ValueError(
                "config_use_modal_aerosols requires the dEdd "
                "shortwave (reference modal_aero treatment lives in "
                "shortwave_dEdd, ice_shortwave.F90:2390-2470)")
        if use_modal_aerosols and n_aerosols < 2:
            raise ValueError(
                "config_use_modal_aerosols needs >= 2 aerosol "
                "species (interstitial + within-grain BC)")
        if (zbgc_params is not None and
                getattr(zbgc_params, "use_zaero", False) and
                n_aerosols > 0):
            raise ValueError(
                "config_use_zaerosols and config_use_aerosols are "
                "mutually exclusive (reference config check: bulk and "
                "z-layer aerosols cannot both be active)")
        if use_skeletal_bgc and use_biogeochemistry:
            raise ValueError(
                "skeletal and vertical-layer biogeochemistry are "
                "mutually exclusive (reference dispatches one of "
                "skl_biogeochemistry / z_biogeochemistry)")
        self.ncat = n_categories
        self.ni = n_ice_layers
        self.ns = n_snow_layers
        self.dtype = dtype
        self.device = resolve_device(device)
        self.use_ice_age = use_ice_age
        self.use_first_year_ice = use_first_year_ice
        self.use_snow_tracers = use_snow_tracers
        self.use_snow_liquid_ponds = use_snow_liquid_ponds
        self.snwredist = snwredist
        self.n_aerosols = n_aerosols
        self.use_modal_aerosols = use_modal_aerosols
        self.use_snicar = use_snicar
        self.use_form_drag = use_form_drag
        self.highfreq = highfreq
        self.calc_tsfc = calc_tsfc
        self.hin_max = category_boundaries(n_categories, kcatbound, kitd)
        # the bounds as Python floats (scalars never promote a tensor)
        self.hin_max_f = [float(h) for h in self.hin_max]
        self.salin = torch.as_tensor(salinity_profile(n_ice_layers)).to(
            device=self.device, dtype=dtype)
        self.ridge_bounds = ridge_bounds(self.hin_max, dtype, self.device)
        self.krdg_partic = krdg_partic
        self.krdg_redist = krdg_redist
        self.mu_rdg = mu_rdg
        self.natmiter = natmiter
        self.atmbndy = atmbndy
        # Registry package switches (config_use_column_shortwave /
        # _vertical_thermodynamics / _itd_thermodynamics)
        self.use_shortwave = use_shortwave
        self.use_vertical_thermodynamics = use_vertical_thermodynamics
        self.use_itd_thermodynamics = use_itd_thermodynamics
        self.shortwave = shortwave
        self.ktherm = ktherm
        self.kstrength = kstrength
        self.pond_scheme = pond_scheme
        self.use_level_ice = use_level_ice
        self.tfrz_option = tfrz_option
        self.rfracmin = rfracmin
        self.rfracmax = rfracmax
        self.pndaspect = pndaspect
        self.hi_min_pond = hi_min_pond
        self.dpscale = dpscale
        self.frzpnd = frzpnd
        # reference shortwave nml_record tuning (Registry shortwave
        # record): ccsm3 albedos + dEdd R_ice/R_pnd/R_snw adjusters
        self.shortwave_tuning = dict(shortwave_tuning or {})
        from .tuning import DEFAULT as _TUN_DEFAULT
        self.tun = tunables if tunables is not None else _TUN_DEFAULT
        self.include_pond_freshwater_feedback = \
            include_pond_freshwater_feedback
        self.optics = self.aero = self.snicar = None
        if shortwave == "dEdd":
            from .dedd import dedd_optics
            self.optics = dedd_optics(dtype, self.device)
        if n_aerosols:
            from .aerosol import KSCAV_DEFAULT
            self.set_aerosol_optics()
            self.kscav = torch.as_tensor(KSCAV_DEFAULT[:n_aerosols]).to(
                device=self.device, dtype=dtype)
        if use_snicar:
            self.set_snicar_tables()
        # brine height is implied by the BGC and the z-salinity
        self.use_brine_height = use_brine_height or use_biogeochemistry \
            or solve_zsalinity
        self.use_biogeochemistry = use_biogeochemistry
        self.use_skeletal_bgc = use_skeletal_bgc
        self.n_bio_layers = n_bio_layers
        self.solve_zsalinity = solve_zsalinity
        self.zbgc_params = None
        if use_biogeochemistry or zbgc_params is not None:
            from .zbgc import ZbgcParams
            self.zbgc_params = zbgc_params or ZbgcParams(n_algae=n_algae)
        self.brine_grid = self.zbgc = None
        if self.use_brine_height:
            from .brine import brine_grid
            self.brine_grid = brine_grid(n_bio_layers, dtype, self.device)
        if self.zbgc_params is not None:
            from .zbgc import zbgc_tables
            self.zbgc = zbgc_tables(self.zbgc_params, dtype, self.device,
                                    n_bio_layers)
            if self.zbgc_params.use_zaero and self.aero is None:
                # the z-aerosol mass paths mix into the dEdd optics
                self.set_aerosol_optics()

    # -- optics tables (the reference reads them from its optics files) --

    def set_aerosol_optics(self, **tables):
        """The aerosol optics this column mixes into the shortwave: the
        bulk tables kaer/waer/gaer [3, n_species] (the reference's
        set_aerosol_optics) and the modal BC tables kaer_bc/waer_bc/
        gaer_bc [3, 10] and bcenh [3, 10, 8] (its
        set_modal_aerosol_optics), each the JAX package's default unless
        given; in this column's dtype on its device."""
        from .dedd import aerosol_optics
        self.aero = aerosol_optics(self.dtype, self.device, **tables)

    def set_snicar_tables(self, ssp=None):
        """The SNICAR tables of the use_snicar shortwave: the snow SSPs
        `ssp` (a `snicar.SnicarSSP`, e.g. from `load_snicar_ssp`; None:
        the embedded fallback), with the 3-band aerosol tables mapped
        onto the five bands until `set_aerosol_optics_5bd`."""
        from .snicar import snicar_tables
        self.snicar = snicar_tables(self.dtype, self.device, ssp)

    def set_aerosol_optics_5bd(self, kaer, waer, gaer):
        """Install exact 5-band aerosol optics (kaer_tab_5bd /
        waer_tab_5bd / gaer_tab_5bd from the SNICAR optics file, shape
        [5, n_species]) for the SNICAR shortwave, keeping its SSPs (the
        reference's set_aerosol_optics_5bd)."""
        self.snicar = self.snicar._replace(aer5=tuple(
            torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
                device=self.device, dtype=self.dtype)
            for a in (kaer, waer, gaer)))

    # -- ice strength (reference colpkg_ice_strength / ice_mechred) ------

    def ice_strength(self, tracers: Dict[str, Any]):
        """Cell ice strength for the dynamics pressure (reference
        colpkg_ice_strength; kstrength=0 Hibler 1979, 1 Rothrock 1975)."""
        aicen = tracers["iceAreaCategory"]
        vicen = tracers["iceVolumeCategory"]
        aice = aicen.sum(-1)
        if self.kstrength == 1:
            aice0 = (1.0 - aice).clamp(min=0.0)
            return ice_strength_rothrock(
                aicen, vicen, aice, aice0, self.hin_max_f,
                Cf=self.tun.ratio_ridging_work_to_pe,
                krdg_partic=self.krdg_partic,
                krdg_redist=self.krdg_redist, mu_rdg=self.mu_rdg)
        return ice_strength_hibler(aice, vicen.sum(-1))

    # -- radiation (reference colpkg_step_radiation / prep_radiation) ----

    def _step_radiation(self, aicen, vicen, vsnon, tsfc, coszen,
                        swvdr, swvdf, swidr, swidf, tracers):
        tune = self.shortwave_tuning
        if self.shortwave == "dEdd":
            from .dedd import shortwave_dedd
            kwargs = {}
            if self.pond_scheme != "none":
                apnd = tracers.get("pondArea")
                hpnd = tracers.get("pondDepth")
                if apnd is not None:
                    fpond = apnd
                    if self.pond_scheme == "lvl" and \
                            "levelIceArea" in tracers:
                        fpond = apnd * tracers["levelIceArea"]
                    # snow-on-pond-lid taper (reference run_dEdd
                    # :1030-1035, hs1): reduce the effective pond
                    # fraction where snow sits on a refrozen lid.
                    # Approximation: the reference tapers with the
                    # snow depth ON the pond (dhsn tracer); without
                    # that tracer the category snow depth stands in.
                    hs1 = self.tun.snow_on_pond_ice_tapering_parameter
                    ipnd = tracers.get("pondLidThickness")
                    if hs1 > 0.0 and ipnd is not None:
                        safe_a = torch.where(aicen > 1e-11, aicen, 1.0)
                        hsn_cat = torch.where(aicen > 1e-11,
                                              vsnon / safe_a, 0.0)
                        asnow = (hsn_cat / hs1).clamp(max=1.0)
                        fpond = torch.where(ipnd > 1e-11,
                                            (1.0 - asnow) * fpond, fpond)
                    kwargs = dict(apnd=fpond, hpnd=hpnd)
            if self.use_snow_tracers and "snowGrainRadius" in tracers:
                kwargs["rsnw"] = tracers["snowGrainRadius"]
            pz = self.zbgc_params
            if pz is not None and pz.use_zaero and \
                    "bioTracers" in tracers and "brineHeight" in tracers:
                # z-layer aerosols into the shortwave (reference
                # dEdd_algae zbio path, ice_shortwave.F90:2432-2470):
                # the vertically-resolved aerosol mass collapses onto
                # the dEdd SSL/body pools, mass path = brine
                # concentration x layer brine depth (porosity folded
                # at ~1, the reference's fully-flooded limit); species
                # order (BC1, BC2, dust...) as in the bulk table
                nbl1 = self.n_bio_layers + 1
                bio = tracers["bioTracers"]
                Cz = bio.reshape(bio.shape[:-1] + (pz.n_bio, nbl1))[
                    ..., pz.index()["zaero"], :]
                safe_a = torch.where(aicen > 1e-11, aicen, 1.0)
                hi_cat = torch.where(aicen > 1e-11, vicen / safe_a, 0.0)
                hbr = tracers["brineHeight"] * hi_cat
                zw = self.zbgc.zspace
                # SSL pool = top bio layer, body = the rest
                mp_ssl = Cz[..., 0] * (hbr * zw[0])[..., None]
                mp_body = (Cz[..., 1:] * zw[1:]).sum(-1) * hbr[..., None]
                kwargs["aero_mp_ice"] = torch.stack([mp_ssl, mp_body], -1)
            if self.n_aerosols and "snowScatteringAerosol" in tracers:
                # bulk aerosol mass paths (reference aero_mp
                # :1417-1428): per-volume tracers * snow/ice volume
                kwargs["aero_mp_snow"] = torch.stack(
                    [tracers["snowScatteringAerosol"] * vsnon[..., None],
                     tracers["snowBodyAerosol"] * vsnon[..., None]], -1)
                kwargs["aero_mp_ice"] = torch.stack(
                    [tracers["iceScatteringAerosol"] * vicen[..., None],
                     tracers["iceBodyAerosol"] * vicen[..., None]], -1)
            for k in ("R_ice", "R_pnd"):
                if k in tune:
                    kwargs[k] = tune[k]
            if self.use_snicar:
                from .snicar import shortwave_snicar
                return shortwave_snicar(
                    aicen, vicen, vsnon, tsfc, coszen,
                    swvdr, swvdf, swidr, swidf, self.ni, self.ns,
                    tables=self.snicar, optics=self.optics, aero=self.aero,
                    **kwargs)
            for k in ("R_snw", "dT_mlt", "rsnw_mlt"):
                if k in tune:
                    kwargs[k] = tune[k]
            kwargs["hs0"] = self.tun.snow_to_ice_transition_depth
            kwargs["kalg"] = self.tun.algae_absorption_coefficient
            return shortwave_dedd(aicen, vicen, vsnon, tsfc, coszen,
                                  swvdr, swvdf, swidr, swidf,
                                  self.ni, self.ns, optics=self.optics,
                                  aero=self.aero,
                                  modal_aero=self.use_modal_aerosols,
                                  **kwargs)
        alb = {k: tune[k] for k in ("albicev", "albicei", "albsnowv",
                                    "albsnowi", "ahmax") if k in tune}
        return shortwave_ccsm3(aicen, vicen, vsnon, tsfc,
                               swvdr, swvdf, swidr, swidf,
                               self.ni, self.ns, **alb)

    # -- therm1 + therm2 (predynamics; reference column.F:1038-1137) -----

    def step_thermodynamics(self, dt, tracers: Dict[str, Any],
                            atm: AtmosForcing, ocn: OceanForcing,
                            strocnx=None, strocny=None, coszen=None,
                            uvel=None, vvel=None, day_of_year=None,
                            lat=None, faero_atm=None, sfc_fluxes=None):
        """Vertical + ITD thermodynamics for one coupling step.

        coszen: cosine solar zenith (cell field) for the dEdd shortwave
        (compute with column.orbital.compute_coszen).  uvel/vvel: cell
        ice velocity (highfreq coupling).  day_of_year (a number or a
        0-d tensor) and lat (cell latitudes, radians): the first-year-ice
        reset, skipped without either.  faero_atm [*B, nAero]: aerosol
        deposition (kg/m^2/s; none without it).  sfc_fluxes: calc_Tsfc=False
        prescribed surface fluxes from the atmosphere model: dict with
        'fsurf', 'fcondtop', 'flat', 'fsens' [*B, nCat] (Registry
        surfaceHeatFluxCouple / surfaceConductiveFluxCouple /
        latentHeatFluxCouple / sensibleHeatFluxCouple).  Returns (new
        tracers, ColumnFluxes)."""
        if not self.calc_tsfc and sfc_fluxes is None:
            raise ValueError(
                "calc_tsfc=False requires sfc_fluxes (the coupler's "
                "per-category surface flux fields)")
        if self.calc_tsfc:
            sfc_fluxes = None
        aicen, vicen, vsnon, at, it_, st = _split_tracers(tracers)
        tsfc = at["surfaceTemperature"]
        qin = it_["iceEnthalpy"]
        sin = it_["iceSalinity"]
        qsn = st["snowEnthalpy"]
        ncat = self.ncat
        ktherm = self.ktherm

        def pc(x):   # broadcast cell field over categories
            return x[..., None] * torch.ones_like(aicen)

        wind = torch.sqrt(atm.u_air ** 2 + atm.v_air ** 2)
        # bulk '30percent' wind redistribution: a wind-dependent
        # fraction of snowfall blows into leads before accumulating
        # (reference snow_redist bulk branch); the loss is booked as
        # freshwater to the ocean via the retained-rate difference
        snow_rate_eff = atm.snow_rate
        if self.snwredist == "bulk":
            snow_rate_eff, _ = wind_snow_loss(wind, atm.snow_rate)

        # shortwave partition (reference column_prep/step_radiation)
        if self.shortwave == "dEdd" and coszen is None:
            raise ValueError(
                "dEdd shortwave requires coszen (compute real zenith "
                "angles with column.orbital.compute_coszen)")
        sw = self._step_radiation(aicen, vicen, vsnon, tsfc, coszen,
                                  atm.sw_vis_dir, atm.sw_vis_dif,
                                  atm.sw_ir_dir, atm.sw_ir_dif, tracers)
        if not self.use_shortwave:
            # package off (config_use_column_shortwave=false): no
            # absorbed/transmitted shortwave anywhere
            sw = ShortwaveResult(*[torch.zeros_like(x) for x in sw])

        # form drag from the pack geometry (reference :2102, Tsamados)
        Cdn_atm = Cdn_ocn = None
        if self.use_form_drag:
            fd = neutral_drag_coeffs(
                at.get("pondArea", torch.zeros_like(aicen)),
                at.get("pondDepth", torch.zeros_like(aicen)),
                at.get("levelIceArea", torch.ones_like(aicen)),
                aicen, vicen, vsnon,
                vlvl=it_.get("levelIceVolume"),
                use_ponds=self.pond_scheme != "none")
            Cdn_atm, Cdn_ocn = fd.Cdn_atm, fd.Cdn_ocn

        # atmosphere boundary layer per category (reference :2150);
        # atmbndy='constant' selects the fixed-coefficient scheme
        # (atmo_boundary_const, ice_atmo.F90:382)
        if self.atmbndy == "constant":
            ab = atmo_constant_coefficients(
                tsfc, pc(atm.air_temperature), pc(atm.u_air),
                pc(atm.v_air), pc(wind),
                pc(atm.specific_humidity), pc(atm.air_density))
        else:
            ab = atmo_boundary_layer(
                tsfc, pc(atm.air_temperature), pc(atm.u_air),
                pc(atm.v_air), pc(wind), pc(atm.air_level_height),
                pc(atm.specific_humidity), pc(atm.air_density),
                natmiter=self.natmiter, highfreq=self.highfreq,
                uvel=pc(uvel) if uvel is not None else None,
                vvel=pc(vvel) if vvel is not None else None,
                Cdn_atm=pc(Cdn_atm) if Cdn_atm is not None else None)

        # age / first-year tracers (reference :2186-2189)
        if self.use_ice_age and "iceAge" in at:
            at["iceAge"] = increment_age(dt, at["iceAge"], vicen)
        if self.use_first_year_ice and "firstYearIceArea" in at and \
                day_of_year is not None and lat is not None:
            # day 265 in the north, day 81 in the south; day_of_year may
            # be a 0-d tensor on the device (no host sync)
            fy = at["firstYearIceArea"]
            doy = torch.as_tensor(day_of_year, device=fy.device)
            reset = torch.where((lat >= 0.0)[..., None], doy == 265,
                                doy == 81)
            at["firstYearIceArea"] = torch.where(reset, 0.0, fy).clamp(
                0.0, 1.0)

        # ocean-ice bottom flux + lateral melt fraction
        aice = aicen.sum(-1)
        hilyr_e = vicen.clamp(min=0.0) / self.ni
        hslyr_e = vsnon.clamp(min=0.0) / self.ns
        etot = ((hilyr_e[..., None] * qin).sum((-2, -1)) +
                (hslyr_e[..., None] * qsn).sum((-2, -1)))
        if strocnx is None:
            strocnx = torch.zeros_like(aice)
            strocny = torch.zeros_like(aice)
        Tbot, fbot_cell, rside = frzmlt_bottom_lateral(
            dt, aice, ocn.frzmlt, ocn.sst, ocn.freezing_temperature,
            strocnx, strocny, etot, tun=self.tun)
        # the same unscaled per-area fbot applies to every category
        # (reference colpkg_step_therm1 -> thermo_vertical; the frzmlt
        # limiter above already accounts for the total extraction)
        fbot = torch.where(aicen > c.PUNY, fbot_cell[..., None], 0.0)

        aicen_init = aicen
        vicen_init = vicen

        # pond inputs to the vertical thermo (mushy flushing)
        apnd = at.get("pondArea")
        hpnd = at.get("pondDepth")
        apond_cat = None
        if apnd is not None:
            apond_cat = apnd
            if self.pond_scheme == "lvl" and "levelIceArea" in at:
                apond_cat = apnd * at["levelIceArea"]

        smice = st.get("snowIceMass")
        smliq = st.get("snowLiquidMass")
        rsnw = st.get("snowGrainRadius")

        # vertical thermodynamics (therm1) with ktherm dispatch
        if self.use_vertical_thermodynamics:
            tv = thermo_vertical(
                dt, aicen, vicen, vsnon, tsfc, qin, qsn,
                sin if ktherm == 2 else self.salin.expand(qin.shape),
                flw=pc(atm.longwave_down),
                potT=pc(atm.air_temperature),
                Qa=pc(atm.specific_humidity), rhoa=pc(atm.air_density),
                fsnow=pc(snow_rate_eff), fbot=fbot,
                Tbot=pc(Tbot),
                fswsfc=sw.fswsfc, fswint=sw.fswint,
                Sswabs=sw.Sswabs, Iswabs=sw.Iswabs,
                shcoef=ab.shcoef, lhcoef=ab.lhcoef,
                ktherm=ktherm,
                sss=pc(ocn.sss) if ktherm == 2 else None,
                frain=pc(atm.rain_rate),
                apond=apond_cat, hpond=hpnd, tun=self.tun,
                smice=smice, smliq=smliq, rsnw=rsnw,
                prescribed_sfc_fluxes=sfc_fluxes)
        else:
            # package off: therm1 skipped, state passes through
            tv = thermo_vertical_noop(aicen, vicen, vsnon, tsfc,
                                      qin, qsn, sin)

        aicen2 = aicen
        vicen2 = tv.hin * aicen
        vsnon2 = tv.hsn * aicen
        at2 = dict(at)
        at2["surfaceTemperature"] = tv.Tsf
        it2 = dict(it_)
        it2["iceEnthalpy"] = tv.zqin
        it2["iceSalinity"] = tv.zSin if ktherm == 2 else sin
        st2 = dict(st)
        st2["snowEnthalpy"] = tv.zqsn
        if tv.smice is not None:
            st2["snowIceMass"] = tv.smice
            st2["snowLiquidMass"] = tv.smliq
        if tv.rsnw is not None:
            st2["snowGrainRadius"] = tv.rsnw
        if tv.hpond is not None and hpnd is not None:
            at2["pondDepth"] = tv.hpond
        meltsliq = tv.meltsliq

        # aerosol pools (reference update_aerosol call :2258)
        faero_ocn = None
        if self.n_aerosols and "snowScatteringAerosol" in st2:
            from .aerosol import update_aerosol
            aero = torch.stack(
                [st2["snowScatteringAerosol"], st2["snowBodyAerosol"],
                 it2["iceScatteringAerosol"], it2["iceBodyAerosol"]], -1)
            if faero_atm is None:
                faero_atm = torch.zeros(aice.shape + (self.n_aerosols,),
                                        dtype=aicen.dtype,
                                        device=aicen.device)
            ar = update_aerosol(
                dt, aero, aicen2, vicen2, vsnon2,
                tv.melts, tv.meltt, tv.meltb, tv.congel, tv.snoice,
                tv.hsn_new, faero_atm, kscav=self.kscav)
            st2["snowScatteringAerosol"] = ar.aero[..., 0]
            st2["snowBodyAerosol"] = ar.aero[..., 1]
            it2["iceScatteringAerosol"] = ar.aero[..., 2]
            it2["iceBodyAerosol"] = ar.aero[..., 3]
            faero_ocn = ar.flux_ocn

        # snow meltwater drainage (reference drain_snow :2279)
        if self.use_snow_tracers and "snowLiquidMass" in st2:
            st2["snowLiquidMass"], meltsliq_d = drain_snow(
                dt, vsnon2, aicen2, st2["snowIceMass"],
                st2["snowLiquidMass"])
            meltsliq = meltsliq + meltsliq_d

        # melt ponds (reference :2292-2352, per-category part);
        # use_smliq_pnd (config_use_snow_liquid_ponds) routes the
        # drained snow-liquid mass into the ponds instead of snow melt
        # + rain (ice_colpkg.F90:2278-2334)
        fpond = torch.zeros_like(aice)
        pond_smliq = meltsliq if self.use_snow_liquid_ponds else None
        if self.pond_scheme != "none" and apnd is not None:
            rfrac = self.rfracmin + \
                (self.rfracmax - self.rfracmin) * aicen2
            lid = at2.get("pondLidThickness", torch.zeros_like(aicen2))
            if self.pond_scheme == "cesm":
                from .ponds import compute_ponds_cesm
                at2["pondArea"], at2["pondDepth"] = compute_ponds_cesm(
                    dt, rfrac, tv.meltt, tv.melts, pc(atm.rain_rate),
                    aicen2, vicen2, vsnon2, at2["surfaceTemperature"],
                    at2["pondArea"], at2["pondDepth"],
                    pndaspect=self.pndaspect, meltsliq=pond_smliq)
            elif self.pond_scheme == "lvl":
                from .ponds import compute_ponds_lvl
                apnd_n, hpnd_n, ipnd_n, _ = compute_ponds_lvl(
                    dt, rfrac, tv.meltt, tv.melts, pc(atm.rain_rate),
                    pc(atm.air_temperature), tv.fsurfn, tv.dsnow,
                    aicen2, vicen2, vsnon2, it2["iceEnthalpy"],
                    it2["iceSalinity"], at2["surfaceTemperature"],
                    at2["levelIceArea"], at2["pondArea"], at2["pondDepth"],
                    lid, pndaspect=self.pndaspect, hi_min=self.hi_min_pond,
                    dpscale=self.dpscale, frzpnd=self.frzpnd,
                    ktherm=ktherm, meltsliq=pond_smliq)
                at2["pondArea"], at2["pondDepth"] = apnd_n, hpnd_n
                if "pondLidThickness" in at2:
                    at2["pondLidThickness"] = ipnd_n
            else:   # topo: collect water per category, level cell-wise
                from .ponds import compute_ponds_topo
                if pond_smliq is None:
                    pond_src = (tv.meltt * c.RHOI + tv.melts * c.RHOS +
                                pc(atm.rain_rate) * dt)
                else:
                    pond_src = tv.meltt * c.RHOI + pond_smliq
                pond = rfrac / c.RHOFRESH * pond_src
                apnd_t = at2["pondArea"]
                hpnd_t = at2["pondDepth"]
                new_pond = apnd_t < c.PUNY
                apnd_t = torch.where(new_pond & (pond > 0), 1.0, apnd_t)
                hpnd_t = torch.where(new_pond, 0.0, hpnd_t)
                hpnd_t = torch.where(
                    apnd_t > c.PUNY,
                    (pond + hpnd_t * apnd_t) / apnd_t.clamp(min=c.PUNY),
                    hpnd_t)
                fpond = fpond + (pond * aicen2).sum(-1)
                fsurf_cell = (tv.fsurfn * aicen2).sum(-1)
                meltt_cell = (tv.meltt * aicen2).sum(-1)
                apnd_t, hpnd_t, ipnd_t, dfpond, _ = compute_ponds_topo(
                    dt, aicen2, vicen2, vsnon2, meltt_cell, fsurf_cell,
                    at2["surfaceTemperature"], it2["iceEnthalpy"],
                    it2["iceSalinity"], apnd_t, hpnd_t, lid,
                    ktherm=ktherm)
                at2["pondArea"], at2["pondDepth"] = apnd_t, hpnd_t
                if "pondLidThickness" in at2:
                    at2["pondLidThickness"] = ipnd_t
                fpond = fpond + dfpond

        # brine height + vertical salinity + biogeochemistry
        # (reference column_biogeochemistry, column.F:3570; runs after
        # vertical thermo, before ITD thermo :1038-1137)
        bgc_diags = {}
        if self.use_brine_height and "brineHeight" in at2:
            at2, it2, bgc_diags = self.step_biogeochemistry(
                dt, aicen2, vicen2, vsnon2, aicen_init, vicen_init,
                at2, it2, tv, sw.fswthru, pc(Tbot), ocn,
                faero_atm=faero_atm)
        if self.use_skeletal_bgc and "sklBgc" in it2:
            # skeletal (bottom ~3 cm) biogeochemistry (reference
            # ice_algae.F90 skl_biogeochemistry, dispatched by
            # config_use_skeletal_biochemistry)
            from .bgc import SklBgcState, step_skl_bgc
            skl_has = (aicen2 > c.PUNY) & (vicen2 > c.PUNY)
            s = it2["sklBgc"]
            fresh_skl = (~(s[..., 0] > c.PUNY)) & skl_has
            algal0 = torch.where(fresh_skl, 0.16, s[..., 0])
            no3_0 = torch.where(fresh_skl, 5.0, s[..., 1])
            sio3_0 = torch.where(fresh_skl, 10.0, s[..., 2])
            res = step_skl_bgc(
                dt, SklBgcState(algal0, no3_0, sio3_0), aicen2, vicen2,
                sw.fswthru, pc(Tbot), 5.0, 10.0)
            it2["sklBgc"] = torch.where(
                skl_has[..., None],
                torch.stack([res.state.algalN, res.state.NO3,
                             res.state.SiO3], -1), 0.0)
            bgc_diags = dict(bgc_diags)
            bgc_diags["skl_pp"] = res.primary_production
            bgc_diags["skl_chla"] = res.chlorophyll
            bgc_diags["skl_no3_flux"] = res.nitrate_flux_ocean

        # aggregate per-category atmosphere fluxes (area-weighted)
        def agg(x):
            return (x * aicen).sum(-1)

        fsens = agg(tv.fsensn)
        flat = agg(tv.flatn)
        flwout = agg(tv.flwoutn) - (1.0 - c.EMISSIVITY) * \
            aice * atm.longwave_down
        fswthru = agg(sw.fswthru)
        evap = agg(tv.evapn)
        fhocn = agg(tv.fhocnn)
        fresh = tv.freshn.sum(-1)
        if self.snwredist == "bulk":
            # blown snow lands in leads -> ocean freshwater
            fresh = fresh + (atm.snow_rate - snow_rate_eff)
        fsalt = tv.fsaltn.sum(-1)

        # therm2 (frazil + lateral melt + ITD remap), gated by the
        # config_use_column_itd_thermodynamics package switch
        frazil_diag = torch.zeros_like(aice)
        meltl_diag = torch.zeros_like(aice)
        if self.use_itd_thermodynamics:
            # frazil formation (therm2; reference column.F:2086-2460)
            ni_res = add_new_ice(
                dt, self.hin_max_f, aicen2, vicen2, at2, it2,
                ocn.frzmlt, ocn.freezing_temperature, self.salin,
                dilute_ponds=self.pond_scheme in ("cesm", "topo"))
            aicen2, vicen2 = ni_res.aicen, ni_res.vicen
            at2, it2 = ni_res.area_tracers, ni_res.ice_tracers
            fresh = fresh + ni_res.dfresh
            fsalt = fsalt + ni_res.dfsalt

            # lateral melt
            lm = lateral_melt(dt, aicen2, vicen2, vsnon2,
                              it2["iceEnthalpy"], st2["snowEnthalpy"],
                              rside)
            aicen2, vicen2, vsnon2 = lm.aicen, lm.vicen, lm.vsnon
            fresh = fresh + lm.dfresh
            fsalt = fsalt + lm.dfsalt
            fhocn = fhocn + lm.dfhocn

            # ITD linear remap between categories
            if ncat > 1:
                (aicen2, vicen2, vsnon2, at2, it2,
                 st2) = linear_itd_remap(
                    self.hin_max_f, aicen_init, vicen_init,
                    aicen2, vicen2, vsnon2, at2, it2, st2)
            frazil_diag = ni_res.frazil
            meltl_diag = lm.meltl

        # cleanup tiny categories
        (aicen2, vicen2, vsnon2, at2, it2, st2, dfresh_z,
         dheat_z) = cleanup_small_ice(aicen2, vicen2, vsnon2, at2, it2,
                                      st2)
        fresh = fresh + dfresh_z / dt
        fhocn = fhocn + dheat_z / dt

        # pond freshwater feedback (reference coupling prep,
        # mpas_seaice_column.F:4790-4797): pond-retained water is
        # withheld from the ocean freshwater flux
        if self.include_pond_freshwater_feedback:
            fresh = fresh - fpond * c.RHOFRESH / dt

        fluxes = ColumnFluxes(
            fresh=fresh, fsalt=fsalt, fhocn=fhocn, fswthru=fswthru,
            evap=evap, fsens=fsens, flat=flat, flwout=flwout,
            congel=agg(tv.congel), frazil=frazil_diag,
            snoice=agg(tv.snoice), meltt=agg(tv.meltt),
            meltb=agg(tv.meltb), melts=agg(tv.melts),
            meltl=meltl_diag,
            albedo_vis_dir=agg(sw.alvdr), albedo_ir_dir=agg(sw.alidr),
            albedo_vis_dif=agg(sw.alvdf), albedo_ir_dif=agg(sw.alidf),
            fpond=fpond / dt, faero_ocn=faero_ocn, Cdn_atm=Cdn_atm,
            Cdn_ocn=Cdn_ocn, bgc=bgc_diags if bgc_diags else None,
            # non-convergence only aborts for columns that carry flux
            # weight IN f32: a category at the puny edge
            # (aicen ~1e-11..1e-8) contributes ~nothing area-weighted
            # and its f32 heat balance sits below the arithmetic noise
            # floor.  In f64 (the only precision the reference runs)
            # convergence is asserted unconditionally down to puny.
            warnings={"thermo_unconverged":
                      (~tv.converged) & (aicen > (
                          1.0e-8 if aicen.dtype == torch.float32
                          else 1.0e-11))},
            thermo_iterations=tv.iterations)

        return _merge_tracers(tracers, aicen2, vicen2, vsnon2, at2, it2,
                              st2), fluxes

    # -- biogeochemistry (reference colpkg_biogeochemistry,
    #    ice_colpkg.F90:5540-5786) --------------------------------------

    def step_biogeochemistry(self, dt, aicen, vicen, vsnon,
                             aicen_init, vicen_init, at2, it2, tv,
                             fswthru, Tbot, ocn: OceanForcing,
                             faero_atm=None):
        """Brine-height dynamics + optional vertical salinity and
        z-tracer biogeochemistry, per category.  Mirrors the reference
        per-category flow: preflushing_changes -> compute_microS_mushy
        -> update_hbrine -> zsalinity -> zbio.  Returns (area tracers,
        ice tracers, diagnostics dict)."""
        from .brine import (MIN_SALIN, compute_micro_s_mushy,
                            preflushing_changes, remap_profile_to_bgrid,
                            update_hbrine)
        nbl = self.n_bio_layers
        puny = c.PUNY
        diags = {}

        def pc(x):
            return x[..., None] * torch.ones_like(aicen)

        fbri = at2["brineHeight"]
        # first ice initializes fbri = 1 (reference :5570)
        fbri = torch.where(fbri > puny, fbri, 1.0)
        hice_old = torch.where(aicen_init > puny,
                               vicen_init / aicen_init.clamp(min=puny), 0.0)
        pf = preflushing_changes(
            aicen, vicen, vsnon, tv.meltb, tv.meltt, tv.congel,
            tv.snoice, hice_old, fbri)

        # salinity profile feeding the brine microstructure
        if self.solve_zsalinity and "verticalSalinity" in it2:
            bpts = np.array([(k - 0.5) / nbl for k in range(1, nbl + 1)])
            cpts = np.array([(k - 0.5) / self.ni
                             for k in range(1, self.ni + 1)])
            zSin_b = remap_profile_to_bgrid(it2["verticalSalinity"], bpts,
                                            cpts, 0.1)
        else:
            zSin_b = it2["iceSalinity"]
        ms = compute_micro_s_mushy(tv.zqin, zSin_b, pc(ocn.sss),
                                   pc(ocn.sst), pf.hbr_old, nbl,
                                   grid=self.brine_grid)

        aice0 = (1.0 - aicen.sum(-1)).clamp(min=0.0)[..., None] * \
            torch.ones_like(aicen)
        hb = update_hbrine(dt, tv.meltb, tv.meltt, tv.melts,
                           pf.hin, pf.hsn, pf.hin_old, pf.hbr_old,
                           tv.snoice, pf.dhbr_bot, ms.kperm,
                           ms.bphi_min, aice0)
        has = aicen > puny
        at2 = dict(at2)
        at2["brineHeight"] = torch.where(has, hb.fbri, 1.0)
        diags["hbrine"] = (hb.hbr * aicen).sum(-1)
        diags["darcy_v"] = (hb.darcy_v * aicen).sum(-1)

        it2 = dict(it2)
        if self.solve_zsalinity and "verticalSalinity" in it2:
            from .zsalinity import solve_zsalinity
            zs = solve_zsalinity(
                dt, it2["verticalSalinity"], ms.iphin, ms.iDin,
                hb.darcy_v, hb.hbr, pf.hbr_old, pf.dhbr_bot,
                hb.dhS_top, pc(ocn.sss), ms.brine_sal[..., -1])
            it2["verticalSalinity"] = torch.where(has[..., None], zs.bSin,
                                                  MIN_SALIN)
            diags["fzsal"] = (zs.fzsal * aicen).sum(-1)
            diags["fzsal_g"] = (zs.fzsal_g * aicen).sum(-1)
            diags["zsal_tot"] = (zs.zsal_tot * aicen).sum(-1)

        if self.use_biogeochemistry and "bioTracers" in it2:
            from .zbgc import zbgc_transport_react
            p, tables = self.zbgc_params, self.zbgc
            K = nbl + 1
            bio = it2["bioTracers"]
            Cb = bio.reshape(bio.shape[:-1] + (p.n_bio, K))
            ocean_bio = tables.ocean
            # first ice seeds from the ocean (initbio_frac)
            fresh_ice = (~(bio.sum(-1) > puny)) & has
            Cb = torch.where(fresh_ice[..., None, None],
                             p.initbio_frac * ocean_bio[:, None] *
                             torch.ones_like(Cb), Cb)
            frac = it2.get("bioMobileFraction")
            if frac is not None:
                frac = torch.where(fresh_ice[..., None], 1.0, frac)
            flux_atm = None
            if p.use_zaero and faero_atm is not None:
                # aerosol deposition into the top brine layer
                # (kg/m^2/s; the reference's zbgc snow pools are
                # subsumed by direct-to-brine deposition here)
                zsl = p.index()["zaero"]
                nz = min(zsl.stop - zsl.start, faero_atm.shape[-1])
                flux_atm = torch.zeros(aicen.shape + (p.n_bio,),
                                       dtype=bio.dtype, device=bio.device)
                flux_atm[..., zsl.start:zsl.start + nz] = \
                    faero_atm[..., None, :nz] * \
                    torch.ones_like(aicen)[..., None]
            zr = zbgc_transport_react(
                dt, Cb, ms.iphin, ms.iDin, hb.darcy_v, hb.hbr,
                pf.hbr_old, pf.dhbr_bot, fswthru, Tbot, ocean_bio, p,
                frac=frac, flux_bio_atm=flux_atm, tables=tables)
            if frac is not None and zr.frac_new is not None:
                it2["bioMobileFraction"] = torch.where(
                    has[..., None], zr.frac_new, 1.0)
            it2["bioTracers"] = torch.where(
                has[..., None], zr.tracers.reshape(bio.shape), 0.0)
            diags["flux_bio"] = (zr.flux_bio * aicen[..., None]).sum(-2)
            diags["pp_net"] = (zr.pp_net * aicen).sum(-1)
            diags["chla"] = (zr.chla * aicen).sum(-1)
            diags["up_NO"] = (zr.up_NO * aicen).sum(-1)
            diags["up_NH"] = (zr.up_NH * aicen).sum(-1)
            # ecosystem closure diagnostics (reference Zoo /
            # nitrification history fields + the Cerror gate)
            diags["zoo_loss"] = (zr.zoo * aicen).sum(-1)
            diags["nitrification"] = (zr.nitrification * aicen).sum(-1)
            diags["bgc_carbon_error"] = zr.cerror.amax(-1)

        return at2, it2, diags

    # -- ridging (dynamics phase; reference column.F:3283-3560) ----------

    def step_ridging(self, dt, tracers: Dict[str, Any],
                     ridge_convergence, ridge_shear):
        """Mechanical redistribution after transport.

        ridge_convergence/shear: cell fields from the velocity solver
        diagnostics (1/s; the EVP driver returns these unconverted,
        unlike divergence/shear which carry CICE %/day units)."""
        aicen, vicen, vsnon, at, it_, st = _split_tracers(tracers)
        res = ridge_ice(
            dt, self.hin_max_f,
            rdg_conv=ridge_convergence.clamp(min=0.0),
            rdg_shear=ridge_shear.clamp(min=0.0),
            aicen=aicen, vicen=vicen, vsnon=vsnon,
            area_tracers=at, ice_tracers=it_, snow_tracers=st,
            krdg_partic=self.krdg_partic, krdg_redist=self.krdg_redist,
            mu_rdg=self.mu_rdg, bounds=self.ridge_bounds)
        # trailing cleanup, as in the reference's colpkg_step_ridge
        # (ice_colpkg.F90:3333): zap negative/sliver categories left by
        # transport roundoff + ridging, returning the mass/heat to the
        # ocean fluxes.  This is where post-advection O(1e-9) negative
        # areas from departure-triangle roundoff get removed.
        (aicen2, vicen2, vsnon2, at2, it2, st2, dfresh_z,
         dheat_z) = cleanup_small_ice(res.aicen, res.vicen, res.vsnon,
                                      res.area_tracers, res.ice_tracers,
                                      res.snow_tracers)
        out = _merge_tracers(tracers, aicen2, vicen2, vsnon2, at2, it2,
                             st2)
        extra = {"dardg1dt": res.dardg1dt, "dardg2dt": res.dardg2dt,
                 "dvirdgdt": res.dvirdgdt, "opening": res.opening,
                 "ridge_fresh": (res.msnow_mlt + dfresh_z) / dt,
                 "ridge_fhocn": (res.esnow_mlt + dheat_z) / dt}
        return out, extra

    # -- post-dynamics (reference column.F:1208: snow -> radiation ->
    #    coupling prep) ---------------------------------------------------

    def step_snow(self, dt, tracers: Dict[str, Any], wind, snow_rate):
        """Advanced snow physics (reference colpkg_step_snow,
        ice_colpkg.F90:3821): effective density, wind loss of new
        snowfall to leads, grain metamorphism, and the redistribution
        scheme.  No-op unless snow tracers are enabled."""
        if not self.use_snow_tracers or "snowGrainRadius" not in tracers:
            return tracers, {}
        aicen = tracers["iceAreaCategory"]
        vicen = tracers["iceVolumeCategory"]
        zTin1 = ice_temperature_from_enthalpy(
            tracers["iceEnthalpy"][..., 0],
            -tracers["iceSalinity"][..., 0] * c.DEPRESST)
        rsnw_n, smice_n, smliq_n = update_snow_radius(
            dt, tracers["snowGrainRadius"], aicen, vicen,
            tracers["snowVolumeCategory"], tracers["snowEnthalpy"],
            tracers["surfaceTemperature"], zTin1, tracers["snowIceMass"],
            tracers["snowLiquidMass"], tun=self.tun)
        out = dict(tracers)
        out["snowGrainRadius"] = rsnw_n
        out["snowIceMass"] = smice_n
        out["snowLiquidMass"] = smliq_n
        rhos_eff = snow_effective_density(smice_n, smliq_n)
        rhos_cmp = wind_compaction(
            dt, wind[..., None, None] * torch.ones_like(rhos_eff),
            rhos_eff, tun=self.tun)
        _, fsloss = wind_snow_loss(wind, snow_rate, tun=self.tun)
        diags = {"rhos_eff": rhos_eff.mean(-1),
                 "rhos_cmp": rhos_cmp.mean(-1), "fsloss": fsloss}
        if self.snwredist != "none":
            rd = snow_redistribution(
                dt, wind, snow_rate, aicen, vicen,
                out["snowVolumeCategory"], out["snowEnthalpy"], rhos_cmp,
                scheme=self.snwredist, alvl=out.get("levelIceArea"),
                vlvl=out.get("levelIceVolume"), tun=self.tun)
            out["snowVolumeCategory"] = rd.vsnon
            out["snowEnthalpy"] = rd.zqsn
            diags["rhos_cmp"] = rd.rhos_cmpn.mean(-1)
            diags["fsloss"] = diags["fsloss"] + rd.fsloss
            diags["redist_fresh"] = rd.fresh
            diags["redist_fhocn"] = rd.fhocn
        return out, diags

    def aggregate(self, tracers: Dict[str, Any]) -> Dict[str, Any]:
        """Cell-mean state for the coupler/diagnostics (reference
        colpkg_aggregate, called from seaice_column_coupling_prep,
        mpas_seaice_column.F:4391-4508)."""
        aicen, vicen, vsnon, at, it_, st = _split_tracers(tracers)
        aice = aicen.sum(-1)
        safe = aice.clamp(min=c.PUNY)
        out = {
            "iceAreaCell": aice,
            "iceVolumeCell": vicen.sum(-1),
            "snowVolumeCell": vsnon.sum(-1),
            "openWaterArea": (1.0 - aice).clamp(min=0.0),
        }
        out["surfaceTemperatureCell"] = torch.where(
            aice > c.PUNY,
            (at["surfaceTemperature"] * aicen).sum(-1) / safe, 0.0)
        for name, key in (("iceAge", "iceAgeCell"),
                          ("firstYearIceArea", "firstYearIceAreaCell"),
                          ("levelIceArea", "levelIceAreaCell"),
                          ("pondArea", "pondAreaCell")):
            if name in at:
                out[key] = (at[name] * aicen).sum(-1)
        if "pondDepth" in at and "pondArea" in at:
            pa = (at["pondArea"] * aicen).sum(-1)
            out["pondDepthCell"] = torch.where(
                pa > c.PUNY,
                (at["pondDepth"] * at["pondArea"] * aicen).sum(-1) /
                pa.clamp(min=c.PUNY), 0.0)
        return out

    def step_post_dynamics(self, dt, tracers: Dict[str, Any],
                           wind=None, snow_rate=None):
        """Post-dynamics phase (reference
        seaice_column_postdynamics_time_integration, column.F:1208):
        snow physics then coupling-prep aggregation.  Radiation for the
        next interval is folded into the next therm1 (see module
        docstring)."""
        diags = {}
        if wind is not None:
            tracers, sd = self.step_snow(
                dt, tracers, wind,
                snow_rate if snow_rate is not None
                else torch.zeros_like(wind))
            diags.update(sd)
        diags.update(self.aggregate(tracers))
        return tracers, diags


def slab_ocean_frzmlt(sst, Tf, mixed_layer_depth, dt):
    """Freezing/melting potential of a slab mixed layer (reference
    colpkg_ocn_mixed_layer / MPAS ocean coupling): the heat required to
    bring the mixed layer to the freezing point in one step, clipped to
    +-1000 W/m^2."""
    f = (Tf - sst) * c.CPRHO * mixed_layer_depth / dt
    return f.clamp(-1000.0, 1000.0)
