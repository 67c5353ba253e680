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
BL99 and mushy thermodynamics (`ktherm` 1, 2), the CCSM3 and
delta-Eddington shortwave, Hibler and Rothrock strength, level-ice
ponds and ITD thermodynamics + ridging; every other option raises
`NotImplementedError` naming ROADMAP Queue 1 item 10 when the
`ColumnPhysics` is built: ktherm=0, calc_Tsfc=False, the CESM and
topographic ponds, ice age, first-year ice, snow tracers and snow
redistribution, aerosols (bulk, modal, z-layer), SNICAR, form drag,
high-frequency coupling, brine height, z-salinity and biogeochemistry.

Deviation from the reference phasing (as in the JAX package): shortwave
radiation is computed at the START of therm1 from the current forcing;
the post-dynamics phase runs snow physics and coupling-prep aggregation.

The numpy tables (category bounds, the BL99 salinity profile, the dEdd
snow optics) are made once here in the state's dtype and on its device,
so an f32 step stays f32: the category bounds as Python floats, the
salinity profile and the optics as tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import constants as c
from .atmo import atmo_boundary_layer, atmo_constant_coefficients
from .itd import (category_boundaries, cleanup_small_ice,
                  ice_strength_hibler, ice_strength_rothrock,
                  linear_itd_remap)
from .itd_thermo import add_new_ice, lateral_melt
from .ridging import ridge_bounds, ridge_ice
from .shortwave import ShortwaveResult, shortwave_ccsm3
from .thermo_shared import salinity_profile
from .vertical import (frzmlt_bottom_lateral, thermo_vertical,
                       thermo_vertical_noop)
from ..utils.containers import tensor_dataclass

_LATER = "ROADMAP Queue 1 item 10"


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
    faero_ocn: Any             # aerosol flux to ocean (not ported: None)
    Cdn_atm: Any               # neutral atm drag (form drag; None)
    Cdn_ocn: Any               # neutral ocn drag (form drag; None)
    bgc: Any                   # BGC diagnostics (not ported: None)
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


def _not_ported(**options):
    """Raise for the first option (name=True) that the port leaves out."""
    for name, on in options.items():
        if on:
            raise NotImplementedError(
                f"column option {name}: not ported; {_LATER}")


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
                 dtype=torch.float64, device="cpu"):
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
        _not_ported(
            ktherm_0=ktherm == 0, calc_tsfc_false=not calc_tsfc,
            pond_scheme_cesm=pond_scheme == "cesm",
            pond_scheme_topo=pond_scheme == "topo",
            use_ice_age=use_ice_age,
            use_first_year_ice=use_first_year_ice,
            use_snow_tracers=use_snow_tracers,
            snwredist=snwredist != "none",
            n_aerosols=n_aerosols > 0,
            use_modal_aerosols=use_modal_aerosols,
            use_snicar=use_snicar, use_form_drag=use_form_drag,
            highfreq=highfreq, use_brine_height=use_brine_height,
            use_biogeochemistry=use_biogeochemistry,
            use_skeletal_bgc=use_skeletal_bgc,
            solve_zsalinity=solve_zsalinity,
            zbgc_params=zbgc_params is not None,
            use_snow_liquid_ponds=use_snow_liquid_ponds)
        self.ncat = n_categories
        self.ni = n_ice_layers
        self.ns = n_snow_layers
        self.dtype = dtype
        self.device = torch.device(device)
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
        self.optics = None
        if shortwave == "dEdd":
            from .dedd import dedd_optics
            self.optics = dedd_optics(dtype, self.device)

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
            for k in ("R_ice", "R_pnd", "R_snw", "dT_mlt", "rsnw_mlt"):
                if k in tune:
                    kwargs[k] = tune[k]
            kwargs["hs0"] = self.tun.snow_to_ice_transition_depth
            kwargs["kalg"] = self.tun.algae_absorption_coefficient
            return shortwave_dedd(aicen, vicen, vsnon, tsfc, coszen,
                                  swvdr, swvdf, swidr, swidf,
                                  self.ni, self.ns, optics=self.optics,
                                  **kwargs)
        alb = {k: tune[k] for k in ("albicev", "albicei", "albsnowv",
                                    "albsnowi", "ahmax") if k in tune}
        return shortwave_ccsm3(aicen, vicen, vsnon, tsfc,
                               swvdr, swvdf, swidr, swidf,
                               self.ni, self.ns, **alb)

    # -- therm1 + therm2 (predynamics; reference column.F:1038-1137) -----

    def step_thermodynamics(self, dt, tracers: Dict[str, Any],
                            atm: AtmosForcing, ocn: OceanForcing,
                            strocnx=None, strocny=None, coszen=None):
        """Vertical + ITD thermodynamics for one coupling step.

        coszen: cosine solar zenith (cell field) for the dEdd shortwave
        (compute with column.orbital.compute_coszen).  Returns (new
        tracers, ColumnFluxes)."""
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
                natmiter=self.natmiter)

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

        # vertical thermodynamics (therm1) with ktherm dispatch
        if self.use_vertical_thermodynamics:
            tv = thermo_vertical(
                dt, aicen, vicen, vsnon, tsfc, qin, qsn,
                sin if ktherm == 2 else self.salin.expand(qin.shape),
                flw=pc(atm.longwave_down),
                potT=pc(atm.air_temperature),
                Qa=pc(atm.specific_humidity), rhoa=pc(atm.air_density),
                fsnow=pc(atm.snow_rate), fbot=fbot,
                Tbot=pc(Tbot),
                fswsfc=sw.fswsfc, fswint=sw.fswint,
                Sswabs=sw.Sswabs, Iswabs=sw.Iswabs,
                shcoef=ab.shcoef, lhcoef=ab.lhcoef,
                ktherm=ktherm,
                sss=pc(ocn.sss) if ktherm == 2 else None,
                apond=apond_cat, hpond=hpnd, tun=self.tun)
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
        if tv.hpond is not None and hpnd is not None:
            at2["pondDepth"] = tv.hpond

        # melt ponds (reference :2292-2352, per-category part): the
        # level-ice scheme, the one pond scheme the port runs
        fpond = torch.zeros_like(aice)
        if self.pond_scheme == "lvl" and apnd is not None:
            from .ponds import compute_ponds_lvl
            rfrac = self.rfracmin + \
                (self.rfracmax - self.rfracmin) * aicen2
            apnd_n, hpnd_n, ipnd_n, _ = compute_ponds_lvl(
                dt, rfrac, tv.meltt, tv.melts, pc(atm.rain_rate),
                pc(atm.air_temperature), tv.fsurfn, tv.dsnow,
                aicen2, vicen2, vsnon2, it2["iceEnthalpy"],
                it2["iceSalinity"], at2["surfaceTemperature"],
                at2["levelIceArea"], at2["pondArea"], at2["pondDepth"],
                at2.get("pondLidThickness", torch.zeros_like(aicen2)),
                pndaspect=self.pndaspect, hi_min=self.hi_min_pond,
                dpscale=self.dpscale, frzpnd=self.frzpnd, ktherm=ktherm)
            at2["pondArea"], at2["pondDepth"] = apnd_n, hpnd_n
            if "pondLidThickness" in at2:
                at2["pondLidThickness"] = ipnd_n

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
            fpond=fpond / dt, faero_ocn=None, Cdn_atm=None, Cdn_ocn=None,
            bgc=None,
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
        ice_colpkg.F90:3821): a no-op without the snow tracers, which
        the port does not run (`__init__` raises for them)."""
        return tracers, {}

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
