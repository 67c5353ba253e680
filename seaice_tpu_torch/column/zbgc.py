"""Vertical (z-layer) biogeochemistry, its parameters and tracer roster.

Port of the JAX package's `column/zbgc.py`, its re-design of the
reference zBGC stack: `z_biogeochemistry` (`ice_algae.F90:794-1497`,
per-tracer vertical FCT advection-diffusion + reactions), `algal_dyn`
(:1505-2309, the full reaction network) and the zbio driver (:29-386).
The brine microstructure inputs (porosity, diffusivity iDin, Darcy
velocity) come from `brine.py`.

  * One implicit advection-diffusion solve on the static (nblyr+1)-point
    bio grid, a Thomas sweep over layers batched over [cells,
    categories, tracers], then a Zalesak flux-corrected anti-diffusion
    pass (`_fct_antidiffusion`) on the interior interfaces; boundary
    interfaces keep the low-order fluxes so the ocean exchange
    bookkeeping is untouched.
  * `algal_reactions`: the complete `algal_dyn` ecosystem (up to three
    autotroph classes, light / nitrate+ammonium / silicate / iron
    Liebig-minimum growth, max_loss uptake caps, Dunne grazing,
    mortality, ammonium sources, nitrification, DON, DOC and DIC, iron,
    the DMSPd -> DMS chain).  Nitrogen is conserved up to the `zoo`
    closure sink and carbon up to `cerror` (both returned).  The port
    evaluates it for every layer in one call (the layer axis is one
    more batch axis), where the JAX package loops over the layers.
  * The numpy constants (per-species parameters, ocean concentrations,
    tracer types, phase timescales, layer weights) become tensors once
    per dtype and device (`zbgc_tables`), where the `ColumnPhysics` is
    built; the functions make them when given none.

Tracer layout: bio tracers are BRINE concentrations (mmol/m^3 of brine)
on the nblyr+1 interface grid; total content per unit ice area =
sum_k C_k phi_k hbr zspace_k.  Slot order (built by ZbgcParams flags;
defaults reproduce the minimal [N, Nit, Am, Sil] roster):

    N x n_algae | Nit | Am? | Sil? | DOC x n_doc, DIC? | DON? |
    Fed?, Fep? | DMSPd?, DMS? | PON? | hum? | zaero x n_zaero?

`namelist.config_from_namelist` builds a `ZbgcParams` from the
biogeochemistry record (Registry.xml:893-1328).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import constants as c

SECDAY = 86400.0

# reference 3-species defaults (Registry.xml; index order diatoms,
# small plankton, phaeocystis)
_MU_MAX = (1.44, 0.41, 0.63)          # config_maximum_growth_rate_* (1/day)
_GROW_TDEP = (0.063, 0.063, 0.063)    # config_temperature_growth_*
_FR_GRAZE = (0.19, 0.19, 0.19)        # config_grazed_fraction_*
_GRAZE_EXP = (0.333, 1.0, 1.0)        # Dunne et al 2005 exponents
_MORT_PRE = (0.007, 0.007, 0.007)     # config_mortality_* (1/day)
_MORT_TDEP = (0.03, 0.03, 0.03)       # config_temperature_mortality_*
_K_NIT = (1.0, 1.0, 1.0)              # config_nitrate_saturation_*
_K_AM = (0.3, 0.3, 0.3)               # config_ammonium_saturation_*
_K_SIL = (4.0, 0.0, 0.0)              # config_silicate_saturation_*
_K_FE = (1.0, 0.2, 0.1)               # config_iron_saturation_*
_R_SI2N = (1.8, 0.0, 0.0)             # config_ratio_Si_to_N_*
_R_S2N = (0.03, 0.03, 0.03)           # config_ratio_S_to_N_*
_R_FE2N = (0.023, 0.023, 0.7)         # config_ratio_Fe_to_N_*
_R_C2N = (7.0, 7.0, 7.0)              # config_ratio_C_to_N_*
_R_CHL2N = (2.1, 1.1, 0.84)           # config_ratio_chla_to_N_*
_CHLABS = (0.03, 0.01, 0.05)          # config_chla_absorptivity_of_*
_ALPHA2MAX = (0.3, 0.2, 0.17)         # config_light_attenuation_*
_BETA2MAX = (0.001, 0.001, 0.04)      # config_light_inhibition_*
_K_EXUDE = (0.0, 0.0, 0.0)            # config_exudation_* (1/day)
# ocean concentrations (colpkg_init_ocean_conc, ice_colpkg.F90:5885)
_OCEAN_N = (1.0, 0.0057, 0.0027)      # mmol N/m^3 (ISPOL/Lannuzel 2013)



@dataclasses.dataclass(frozen=True)
class ZbgcParams:
    """Reaction parameters and tracer roster.

    Per-species values default to the reference 3-species vectors
    (Registry.xml:893-1328), truncated to `n_algae`; scalar rates cite
    their config names in the module-level tables above.  The roster
    flags mirror the reference tr_bgc_* switches
    (ice_colpkg_tracers.F90): the default roster is the minimal
    [N x n_algae, Nit, Am, Sil]; enabling use_C/use_DON/use_Fe/use_DMS
    /use_PON appends the corresponding pools."""
    n_algae: int = 1
    # roster flags (tr_bgc_* analogs)
    use_Am: bool = True
    use_Sil: bool = True
    use_C: bool = False             # DOC x n_doc + DIC
    use_DON: bool = False
    use_Fe: bool = False
    use_DMS: bool = False
    use_PON: bool = False
    use_hum: bool = False           # refractory humic carbon
    # z-layer aerosols (config_use_zaerosols, Registry.xml:838-842):
    # passive vertically-resolved aerosol tracers carried on the bio
    # grid with their own mobility types, no reactions
    use_zaero: bool = False
    n_zaero: int = 3                # BC1, BC2, dust bins
    n_doc: int = 2                  # polysaccharids, lipids
    # per-species (length >= n_algae; reference vectors)
    mu_max: tuple = _MU_MAX
    grow_Tdep: tuple = _GROW_TDEP
    fr_graze: tuple = _FR_GRAZE
    graze_exponent: tuple = _GRAZE_EXP
    mort_pre: tuple = _MORT_PRE
    mort_Tdep: tuple = _MORT_TDEP
    K_Nit: tuple = _K_NIT
    K_Am: tuple = _K_AM
    K_Sil: tuple = _K_SIL
    K_Fe: tuple = _K_FE
    R_Si2N: tuple = _R_SI2N
    R_S2N: tuple = _R_S2N
    R_Fe2N: tuple = _R_FE2N
    R_C2N: tuple = _R_C2N
    R_chl2N: tuple = _R_CHL2N
    chlabs: tuple = _CHLABS
    alpha2max: tuple = _ALPHA2MAX
    beta2max: tuple = _BETA2MAX
    k_exude: tuple = _K_EXUDE
    # scalar rates (config names in comments)
    graze_conc: float = 1.36        # mmol N/m^3 (Dunne 2005 fit)
    T_max: float = 0.0              # config_maximum_brine_temperature
    fsal: float = 1.0               # salinity restriction factor
    fr_resp: float = 0.05           # config_respiration_fraction_of_growth
    fr_graze_s: float = 0.5         # config_slopped_grazing_fraction
    fr_graze_e: float = 0.5         # config_excreted_fraction
    fr_mort2min: float = 0.9        # config_fraction_mortality_to_ammonium
    fr_dFe: float = 1.0             # config_fraction_iron_remineralized
    k_nitrif: float = 0.046         # config_nitrification_rate (1/day)
    t_iron_conv: float = 3065.0     # config_desorption_loss_particulate_iron (day)
    max_loss: float = 0.9           # config_maximum_loss_fraction
    max_dfe_doc1: float = 0.2       # config_maximum_ratio_iron_to_saccharids
    fr_resp_s: float = 0.9          # config_respiration_loss_to_DMSPd
    y_sk_DMS: float = 0.7           # config_DMSP_to_DMS_conversion_fraction
    t_sk_conv: float = 5.0          # config_DMSP_to_DMS_conversion_time (day)
    t_sk_ox: float = 12.0           # config_DMS_oxidation_time (day)
    kn_bac: float = 0.2             # config_degredation_of_DON (1/day)
    f_don_Am: float = 1.0           # config_fraction_DON_ammonium
    f_doc: tuple = (0.5, 0.5)       # config_fraction_loss_to_saccharids/lipids
    k_bac: tuple = (0.03, 0.03)     # config_remineralization_* (1/day)
    R_C2N_DON: float = 5.0          # config_ratio_C_to_N_proteins
    op_dep_min: float = 0.1         # config_minimum_optical_depth
    algal_vel: float = 1.11e-8      # m/s (Lavoie 2005)
    # ocean boundary concentrations (colpkg_init_ocean_conc defaults)
    ocean_N: tuple = _OCEAN_N       # per species
    ocean_Nit: float = 12.0
    ocean_Am: float = 1.0
    ocean_Sil: float = 25.0
    ocean_DOC: tuple = (16.2, 9.0)  # saccharides, lipids (mmol C/m^3)
    ocean_DIC: float = 1950.0       # Tynan et al. 2015
    ocean_DON: float = 12.9
    ocean_Fed: float = 0.4          # nM (Tagliabue 2012)
    ocean_Fep: float = 2.0          # nM (van der Merwe 2011)
    ocean_DMSPd: float = 0.1
    ocean_DMS: float = 0.1
    ocean_PON: float = 12.0         # shadows nitrate
    ocean_hum: float = 1.0          # mmol C/m^3 (colpkg_init_ocean_conc)
    initbio_frac: float = 1.0
    frazil_scav: float = 1.0
    # mobile/stationary phase partitioning (reference
    # ice_zbgc_shared.F90 bgc_tracer_type + tau_ret/tau_rel;
    # Registry config_mobility_type_* / config_*_mobile_to_stationary_
    # time).  type < 0: purely mobile; [0,0.5): retain fast, release
    # slow; [0.5,1): both fast; [1,2): retain slow, release fast;
    # >= 2: both slow (ice_colpkg.F90:1507-1523)
    mobility_type_diatoms: float = 0.0
    mobility_type_small_plankton: float = 0.0
    mobility_type_phaeocystis: float = 0.0
    mobility_type_nitrate: float = -1.0
    mobility_type_ammonium: float = 0.0
    mobility_type_silicate: float = -1.0
    mobility_type_DMSPp: float = 0.5
    mobility_type_DMSPd: float = 0.0
    mobility_type_humics: float = 0.0
    mobility_type_saccharids: float = 0.0
    mobility_type_lipids: float = 0.0
    mobility_type_inorganic_carbon: float = -1.0
    mobility_type_proteins: float = 0.0
    mobility_type_dissolved_iron: float = 0.0
    mobility_type_particulate_iron: float = 0.5
    mobility_type_black_carbon1: float = 0.0
    mobility_type_black_carbon2: float = 0.0
    mobility_type_dust1: float = 0.0
    mobility_type_dust2: float = 0.0
    mobility_type_dust3: float = 0.0
    mobility_type_dust4: float = 0.0
    rapid_mobile_to_stationary_time: float = 3600.0    # s
    long_mobile_to_stationary_time: float = 604800.0   # s

    # -- roster indexing (nlt_bgc_* analog) -----------------------------------

    def _roster(self):
        """[(name, count)] in slot order."""
        na = self.n_algae
        r = [("N", na), ("Nit", 1)]
        if self.use_Am:
            r.append(("Am", 1))
        if self.use_Sil:
            r.append(("Sil", 1))
        if self.use_C:
            r.append(("DOC", self.n_doc))
            r.append(("DIC", 1))
        if self.use_DON:
            r.append(("DON", 1))
        if self.use_Fe:
            r.append(("Fed", 1))
            r.append(("Fep", 1))
        if self.use_DMS:
            r.append(("DMSPd", 1))
            r.append(("DMS", 1))
        if self.use_PON:
            r.append(("PON", 1))
        if self.use_hum:
            r.append(("hum", 1))
        if self.use_zaero:
            r.append(("zaero", self.n_zaero))
        return r

    def index(self) -> Dict[str, slice]:
        out = {}
        off = 0
        for name, n in self._roster():
            out[name] = slice(off, off + n)
            off += n
        return out

    @property
    def n_bio(self) -> int:
        return sum(n for _, n in self._roster())

    def species(self, name: str) -> np.ndarray:
        """Per-species parameter truncated to n_algae."""
        return np.asarray(getattr(self, name)[:self.n_algae])

    def ocean_concentrations(self, dtype=torch.float64, device=None):
        vals = []
        for name, n in self._roster():
            if name == "N":
                vals += list(self.ocean_N[:self.n_algae])
            elif name == "DOC":
                vals += list(self.ocean_DOC[:n])
            elif name == "zaero":
                vals += [0.0] * n     # the ocean is an aerosol sink
            else:
                vals.append(getattr(self, "ocean_" + name))
        return torch.as_tensor(np.asarray(vals, np.float64)).to(
            device=device, dtype=dtype)

    def tracer_types(self) -> np.ndarray:
        """bgc_tracer_type per slot (ice_zbgc_shared.F90:70-75)."""
        algal = [self.mobility_type_diatoms,
                 self.mobility_type_small_plankton,
                 self.mobility_type_phaeocystis]
        out = []
        for name, n in self._roster():
            if name == "N":
                out += algal[:n]
            elif name == "Nit":
                out.append(self.mobility_type_nitrate)
            elif name == "Am":
                out.append(self.mobility_type_ammonium)
            elif name == "Sil":
                out.append(self.mobility_type_silicate)
            elif name == "DOC":
                out += [self.mobility_type_saccharids,
                        self.mobility_type_lipids][:n]
            elif name == "DIC":
                out.append(self.mobility_type_inorganic_carbon)
            elif name == "DON":
                out.append(self.mobility_type_proteins)
            elif name == "Fed":
                out.append(self.mobility_type_dissolved_iron)
            elif name == "Fep":
                out.append(self.mobility_type_particulate_iron)
            elif name == "DMSPd":
                out.append(self.mobility_type_DMSPd)
            elif name == "DMS":
                out.append(-1.0)      # dissolved gas: purely mobile
            elif name == "PON":
                out.append(self.mobility_type_nitrate)
            elif name == "hum":
                out.append(self.mobility_type_humics)
            elif name == "zaero":
                out += [self.mobility_type_black_carbon1,
                        self.mobility_type_black_carbon2,
                        self.mobility_type_dust1,
                        self.mobility_type_dust2,
                        self.mobility_type_dust3,
                        self.mobility_type_dust4][:n]
        return np.asarray(out)

    def phase_timescales(self):
        """(tau_ret, tau_rel) per slot from the tracer types
        (reference ice_colpkg.F90:1507-1523)."""
        t = self.tracer_types()
        tmin = self.rapid_mobile_to_stationary_time
        tmax = self.long_mobile_to_stationary_time
        tau_ret = np.where(t < 0.5, tmin, tmax)
        tau_rel = np.where((t >= 0.5) & (t < 2.0), tmin, tmax)
        tau_rel = np.where(t < 0.0, tmin, tau_rel)
        return tau_ret, tau_rel


# the per-species parameters the reactions read
_SPECIES = ("mu_max", "grow_Tdep", "fr_graze", "graze_exponent",
            "mort_pre", "mort_Tdep", "K_Nit", "K_Am", "K_Sil", "K_Fe",
            "R_Si2N", "R_S2N", "R_Fe2N", "R_C2N", "R_chl2N", "chlabs",
            "alpha2max", "beta2max", "k_exude")


class ZbgcTables(NamedTuple):
    """The numpy constants of a `ZbgcParams` as tensors of one dtype on
    one device: per-species parameters {name: [n_algae]}, f_doc and k_bac
    [n_doc], the ocean concentrations [n_bio], the mobile flags
    (tracer type >= 0) and 1/tau_ret, 1/tau_rel [n_bio]; for nblyr bio
    layers the layer weights `zspace` and the shortwave's decay down the
    column [nblyr+1] (None without nblyr)."""
    species: Dict[str, torch.Tensor]
    f_doc: torch.Tensor
    k_bac: torch.Tensor
    ocean: torch.Tensor
    mobile: torch.Tensor
    rtau_ret: torch.Tensor
    rtau_rel: torch.Tensor
    zspace: Optional[torch.Tensor] = None
    sw_decay: Optional[torch.Tensor] = None


def layer_weights(nblyr: int) -> np.ndarray:
    """zspace: the bio layers' thickness weights [nblyr+1] on the
    interface grid (half layers at the top and bottom)."""
    zspace = np.full(nblyr + 1, 1.0 / nblyr)
    zspace[0] *= 0.5
    zspace[-1] *= 0.5
    return zspace


def shortwave_decay(nblyr: int) -> np.ndarray:
    """The penetrating shortwave's share at each of the nblyr+1 bio grid
    points: exp(-1.5 k / nblyr)."""
    K = nblyr + 1
    return np.exp(-1.5 * (np.arange(K) / max(K - 1, 1)))


def zbgc_tables(p: ZbgcParams, dtype, device,
                nblyr: Optional[int] = None) -> ZbgcTables:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=dtype)
    tau_ret, tau_rel = p.phase_timescales()
    return ZbgcTables(
        species={n: t(p.species(n)) for n in _SPECIES},
        f_doc=t(p.f_doc[:p.n_doc]), k_bac=t(p.k_bac[:p.n_doc]),
        ocean=p.ocean_concentrations(dtype, device),
        mobile=t(p.tracer_types() >= 0.0),
        rtau_ret=1.0 / t(tau_ret), rtau_rel=1.0 / t(tau_rel),
        zspace=None if nblyr is None else t(layer_weights(nblyr)),
        sw_decay=None if nblyr is None else t(shortwave_decay(nblyr)))


class ReactionResult(NamedTuple):
    react: torch.Tensor         # [*B, n_bio] concentration change / dt
    grow: torch.Tensor          # [*B] total algal growth (mmol N/m^3/s)
    upNO: torch.Tensor          # [*B] nitrate uptake (mmol/m^3/s)
    upNH: torch.Tensor          # [*B] ammonium uptake (mmol/m^3/s)
    zoo: torch.Tensor           # [*B] N closure sink (mmol N/m^3, Zoo)
    nitrif: torch.Tensor        # [*B] nitrification (mmol N/m^3)
    cerror: torch.Tensor        # [*B] carbon budget residual (Cerror)


def algal_reactions(dt, C_brine, fswpen, T_bot, p: ZbgcParams,
                    tables: Optional[ZbgcTables] = None) -> ReactionResult:
    """The full algal_dyn reaction network (reference
    ice_algae.F90:1505-2309), batched.  C_brine [*B, n_bio] brine
    concentrations in the roster order of `p.index()`; fswpen [*B]
    penetrating shortwave (W/m^2); T_bot [*B] (broadcast against
    fswpen); tables: `zbgc_tables(p, ...)` (made here when None)."""
    if tables is None:
        tables = zbgc_tables(p, C_brine.dtype, C_brine.device)
    ix = p.index()
    sp = tables.species.__getitem__

    Nin = C_brine[..., ix["N"]]
    Nit = C_brine[..., ix["Nit"].start]
    zero = torch.zeros_like(Nit)
    Am = C_brine[..., ix["Am"].start] if p.use_Am else zero
    Sil = C_brine[..., ix["Sil"].start] if p.use_Sil else zero
    DOC = C_brine[..., ix["DOC"]] if p.use_C else None
    DON = C_brine[..., ix["DON"].start] if p.use_DON else None
    Fed = C_brine[..., ix["Fed"].start] if p.use_Fe else None
    Fep = C_brine[..., ix["Fep"].start] if p.use_Fe else None
    DMSPd = C_brine[..., ix["DMSPd"].start] if p.use_DMS else None
    DMS = C_brine[..., ix["DMS"].start] if p.use_DMS else None

    # light limitation through self-shading chlorophyll (:1880-1892)
    chlin = sp("R_chl2N") * Nin
    op_dep = (sp("chlabs") * chlin).sum(-1)
    Iavg = torch.where(op_dep > p.op_dep_min,
                       fswpen * (1.0 - torch.exp(-op_dep)) /
                       op_dep.clamp(min=c.PUNY), fswpen)
    L_lim = (1.0 - torch.exp(-sp("alpha2max") * Iavg[..., None])) * \
        torch.exp(-sp("beta2max") * Iavg[..., None])
    dTemp = (T_bot - p.T_max).clamp(max=0.0)

    # nutrient limitation (:1903-1925)
    Nit_lim = Nit[..., None] / (Nit[..., None] + sp("K_Nit"))
    Am_lim = (Am[..., None] / (Am[..., None] + sp("K_Am"))
              if p.use_Am else torch.zeros_like(Nit_lim))
    N_lim = (Nit_lim + Am_lim).clamp(max=1.0)
    K_Sil = sp("K_Sil")
    Sil_lim = (torch.where(K_Sil > 0.0,
                           Sil[..., None] / (Sil[..., None] +
                                             K_Sil.clamp(min=c.PUNY)),
                           1.0)
               if p.use_Sil else torch.ones_like(Nit_lim))
    K_Fe = sp("K_Fe")
    Fe_lim = (torch.where(K_Fe > 0.0,
                          Fed[..., None] / (Fed[..., None] +
                                            K_Fe.clamp(min=c.PUNY)),
                          1.0)
              if p.use_Fe else torch.ones_like(Nit_lim))

    # growth and potential uptake (:1930-1949)
    growmax = sp("mu_max") / SECDAY * \
        torch.exp(sp("grow_Tdep") * dTemp[..., None]) * Nin * p.fsal
    lim = torch.minimum(torch.minimum(L_lim, N_lim),
                        torch.minimum(Sil_lim, Fe_lim))
    grow = lim * growmax
    potU_Am = Am_lim * growmax
    U_Am = torch.minimum(grow, potU_Am)
    U_Nit = grow - U_Am
    U_Sil = sp("R_Si2N") * grow
    U_Fe = sp("R_Fe2N") * grow

    # proportional-redistribution caps at max_loss of each pool
    # (:1943-1975): totals are capped, species shares preserved
    def cap(U, pool):
        tot = U.sum(-1)
        frac = torch.where(tot[..., None] > 0.0,
                           U / tot.clamp(min=c.PUNY)[..., None], 0.0)
        tot_c = torch.minimum(tot, p.max_loss * pool / dt)
        return frac * tot_c[..., None]

    U_Nit = cap(U_Nit, Nit)
    if p.use_Am:
        U_Am = cap(U_Am, Am)
    if p.use_Sil:
        U_Sil = cap(U_Sil, Sil)
    if p.use_Fe:
        U_Fe = cap(U_Fe, Fed)

    # re-derive growth from the capped uptakes (:1977-1994)
    R_Si2N = sp("R_Si2N")
    R_Fe2N = sp("R_Fe2N")
    grow = torch.where(R_Si2N > 0.0,
                       torch.minimum(U_Sil / R_Si2N.clamp(min=c.PUNY),
                                     U_Nit + U_Am),
                       U_Nit + U_Am)
    if p.use_Fe:
        grow = torch.minimum(grow, U_Fe / R_Fe2N.clamp(min=c.PUNY))
    fr_Am = (torch.where(grow > 0.0,
                         (U_Am / grow.clamp(min=c.PUNY)).clamp(max=1.0),
                         0.5)
             if p.use_Am else torch.zeros_like(grow))
    U_Am = fr_Am * grow
    U_Nit = (1.0 - fr_Am) * grow
    U_Sil = R_Si2N * grow
    U_Fe = R_Fe2N * grow

    # losses (:1994-2015)
    resp = p.fr_resp * grow
    graze = torch.minimum(
        p.max_loss * Nin / dt,
        grow * sp("fr_graze") *
        (Nin / p.graze_conc).clamp(min=c.PUNY) ** sp("graze_exponent"))
    mort = torch.minimum(
        p.max_loss * Nin / dt,
        sp("mort_pre") * torch.exp(sp("mort_Tdep") * dTemp[..., None]) *
        Nin / SECDAY)

    R_C2N = sp("R_C2N")
    dN_alg = (grow - graze - mort - resp) * dt
    graze_N = graze.sum(-1)
    graze_C = (R_C2N * graze).sum(-1)
    mort_N = mort.sum(-1)
    mort_C = (R_C2N * mort).sum(-1)
    resp_N = resp.sum(-1)

    # ammonium sources: excretion, remineralized mortality, respiration
    # (:2019-2023)
    Am_s_e = graze_N * (1.0 - p.fr_graze_s) * p.fr_graze_e * dt
    Am_s_mo = mort_N * p.fr_mort2min * dt
    Am_s_r = resp_N * dt
    Am_s = Am_s_e + Am_s_mo + Am_s_r

    # nitrification (:2045-2050)
    nitrif = p.k_nitrif / SECDAY * Am * dt

    # zooplankton/bacteria closure sink Zoo (:2058-2072)
    if p.use_Am:
        Zoo = graze_N * dt * (1.0 - p.fr_graze_e) * (1.0 - p.fr_graze_s) \
            + graze_N * p.fr_graze_s * dt + mort_N * dt - Am_s_mo
    else:
        Zoo = graze_N * dt + mort_N * dt

    # DON: proteins from non-remineralized grazing + mortality,
    # bacterial degradation to NH4 (:2078-2092)
    dDON = None
    DON_s = torch.zeros_like(graze_N)
    DON_r = torch.zeros_like(graze_N)
    if p.use_DON:
        DON_r = p.kn_bac / SECDAY * DON * dt
        DON_s = graze_N * dt - Am_s_e + mort_N * dt - Am_s_mo
        Zoo = Zoo - DON_s + DON_r * (1.0 - p.f_don_Am)
        Am_s = Am_s + DON_r * p.f_don_Am
        dDON = DON_s - DON_r

    # DOC: fraction of grazed/dead carbon not sent to DON, bacterial
    # remineralization into DIC (:2098-2106); exudation (k_exude)
    dDOC = None
    DIC_s = torch.zeros_like(graze_N)
    DIC_r = torch.zeros_like(graze_N)
    if p.use_C:
        f_doc, k_bac = tables.f_doc, tables.k_bac
        exude_C = ((sp("k_exude") * R_C2N * Nin).sum(-1) / SECDAY) * dt
        doc_pool = (graze_C + mort_C) * dt - DON_s * p.R_C2N_DON
        DOC_s = f_doc * doc_pool[..., None] + exude_C[..., None] / p.n_doc
        DOC_r = k_bac / SECDAY * DOC * dt
        DIC_s = DOC_r.sum(-1) + DON_r * p.R_C2N_DON
        DIC_r = ((1.0 - p.fr_resp) * grow * R_C2N).sum(-1) * dt
        dDOC = DOC_s - DOC_r

    # iron (:2110-2150): uptake from Fed, remineralization source,
    # particulate->dissolved conversion gated by saccharid:dFe ratio
    dFed = dFep = None
    if p.use_Fe:
        Fed_r = U_Fe.sum(-1) * dt
        Fed_s = Am_s * float(p.R_Fe2N[0]) * p.fr_dFe
        Fep_s = Am_s * float(p.R_Fe2N[0]) * (1.0 - p.fr_dFe)
        Fep_r = torch.zeros_like(Fed_r)
        if p.use_C:
            convert = (DOC[..., 0] > 0.0) & \
                (Fed / DOC[..., 0].clamp(min=c.PUNY) < p.max_dfe_doc1)
            Fep_r = torch.where(convert,
                                Fep / p.t_iron_conv / SECDAY * dt, 0.0)
            Fed_s = Fed_s + Fep_r
        dFed = Fed_s - Fed_r
        dFep = Fep_s - Fep_r

    # sulfur chain (:2153-2186): DMSPd from respiration + mortality,
    # conversion to DMS (y_sk_DMS / t_sk_conv), DMS oxidation (t_sk_ox)
    dDMSPd = dDMS = None
    if p.use_DMS:
        R_S2N = sp("R_S2N")
        DMSPd_s = (p.fr_resp_s * (R_S2N * resp).sum(-1) +
                   p.fr_mort2min * (R_S2N * mort).sum(-1)) * dt
        DMSPd_r = DMSPd / p.t_sk_conv / SECDAY * dt
        dDMSPd = DMSPd_s - DMSPd_r
        dDMS = p.y_sk_DMS * DMSPd_r - DMS / p.t_sk_ox / SECDAY * dt

    # assemble the reaction vector in roster order (:2190-2270)
    dAm = Am_s - (U_Am.sum(-1) * dt + nitrif) if p.use_Am else None
    dNit = nitrif - U_Nit.sum(-1) * dt
    if not p.use_Am:
        # without an ammonium pool, remineralized N returns to nitrate
        dNit = dNit + Am_s
    parts = [dN_alg, dNit[..., None]]
    if p.use_Am:
        parts.append(dAm[..., None])
    if p.use_Sil:
        parts.append(-U_Sil.sum(-1)[..., None] * dt)
    if p.use_C:
        parts.append(DOC_s - DOC_r)
        parts.append((DIC_s - DIC_r)[..., None])
    if p.use_DON:
        parts.append(dDON[..., None])
    if p.use_Fe:
        parts.append(dFed[..., None])
        parts.append(dFep[..., None])
    if p.use_DMS:
        parts.append(dDMSPd[..., None])
        parts.append(dDMS[..., None])
    if p.use_PON:
        # PON shadows nitrate (no independent reactions, :2052-2056)
        parts.append(torch.zeros_like(dNit)[..., None])
    if p.use_hum:
        # refractory humics: transported + ocean-exchanged only
        parts.append(torch.zeros_like(dNit)[..., None])
    if p.use_zaero:
        # z-aerosols are chemically inert (reference nlt_zaero
        # 'non-reacting layer aerosols', ice_colpkg_tracers.F90:112)
        parts.append(torch.zeros(dNit.shape + (p.n_zaero,),
                                 dtype=dNit.dtype, device=dNit.device))
    react = torch.cat(parts, -1)

    # carbon budget residual (reference Cerror / conserve_C gate)
    dC = (dN_alg * R_C2N).sum(-1)
    if p.use_C:
        dC = dC + dDOC.sum(-1) + (DIC_s - DIC_r)
    if p.use_DON:
        dC = dC + dDON * p.R_C2N_DON

    grow_tot = grow.sum(-1)
    return ReactionResult(
        react=react, grow=grow_tot, upNO=U_Nit.sum(-1),
        upNH=U_Am.sum(-1) if p.use_Am else torch.zeros_like(grow_tot),
        zoo=Zoo, nitrif=nitrif, cerror=dC)


def _thomas(a, b, cc, d):
    """Tridiagonal solve, unrolled over the (static) layer axis.
    a/b/cc/d: [*B, n] (a[0], cc[-1] ignored); a/b/cc broadcast against
    d."""
    n = d.shape[-1]
    cp = [cc[..., 0] / b[..., 0]]
    dp = [d[..., 0] / b[..., 0]]
    for k in range(1, n):
        m = b[..., k] - a[..., k] * cp[-1]
        m = torch.where(m.abs() < 1e-30, 1e-30, m)
        cp.append(cc[..., k] / m)
        dp.append((d[..., k] - a[..., k] * dp[-1]) / m)
    x = [dp[-1]]
    for k in range(n - 2, -1, -1):
        x.append(dp[k] - cp[k] * x[-1])
    return torch.stack(x[::-1], -1)


def _fct_antidiffusion(C_old, C_low, w, dt, dx):
    """Zalesak flux-corrected anti-diffusion pass (second-order
    advective correction of the low-order implicit-upwind solution).

    The reference transports each bio tracer with flux-corrected
    transport (ice_algae.F90:794-1497: low-order monotone fluxes plus
    limited anti-diffusive corrections).  Here the low-order solution
    C_low comes from the batched implicit upwind+diffusion Thomas solve;
    this pass adds the limited difference between the second-order
    centered advective flux and the upwind flux, evaluated at C_low, on
    the interior interfaces only.  The Zalesak limiter bounds every cell
    by the local min/max of {C_old, C_low} over the three-point
    neighborhood.

    C_old/C_low: [*B, K]; w: [*B] nondimensional velocity (1/s,
    positive = downward toward larger k); returns corrected [*B, K]."""
    K = C_old.shape[-1]
    if K < 3:
        return C_low
    wexp = w[..., None]
    # anti-diffusive advective flux at interior interfaces k+1/2,
    # k = 0..K-2: F_high - F_low evaluated at the low-order solution
    c_lo = C_low[..., :-1]
    c_hi = C_low[..., 1:]
    F_high = wexp * 0.5 * (c_lo + c_hi)
    F_low = torch.where(wexp >= 0.0, wexp * c_lo, wexp * c_hi)
    A = F_high - F_low                      # [*B, K-1]

    # local bounds from the union of old and low-order states
    both_max = torch.maximum(C_old, C_low)
    both_min = torch.minimum(C_old, C_low)

    def shifted(x):
        up = torch.cat([x[..., :1], x[..., :-1]], -1)
        dn = torch.cat([x[..., 1:], x[..., -1:]], -1)
        return up, dn

    up, dn = shifted(both_max)
    Cmax = torch.maximum(torch.maximum(up, both_max), dn)
    up, dn = shifted(both_min)
    Cmin = torch.minimum(torch.minimum(up, both_min), dn)

    # incoming / outgoing anti-flux sums per cell (Zalesak P/Q/R)
    zpad = torch.zeros_like(A[..., :1])
    A_up = torch.cat([zpad, A], -1)    # interface above k
    A_dn = torch.cat([A, zpad], -1)    # interface below k
    P_plus = A_up.clamp(min=0.0) - A_dn.clamp(max=0.0)
    P_minus = A_dn.clamp(min=0.0) - A_up.clamp(max=0.0)
    Q_plus = (Cmax - C_low) * dx / dt
    Q_minus = (C_low - Cmin) * dx / dt
    R_plus = torch.where(
        P_plus > 0.0,
        (Q_plus / P_plus.clamp(min=1e-300)).clamp(max=1.0), 0.0)
    R_minus = torch.where(
        P_minus > 0.0,
        (Q_minus / P_minus.clamp(min=1e-300)).clamp(max=1.0), 0.0)

    # limit each interface by the stricter of its two cells
    coef = torch.where(
        A >= 0.0,
        torch.minimum(R_minus[..., :-1], R_plus[..., 1:]),
        torch.minimum(R_plus[..., :-1], R_minus[..., 1:]))
    A_lim = coef * A
    div = torch.cat([A_lim, zpad], -1) - torch.cat([zpad, A_lim], -1)
    return C_low - dt / dx * div


class ZbgcResult(NamedTuple):
    tracers: torch.Tensor        # [*B, n_bio, nblyr+1] brine conc
    flux_bio: torch.Tensor       # [*B, n_bio] to ocean (mmol/m^2/s)
    pp_net: torch.Tensor         # net primary production (mmolN/m^2/s)
    grow_net: torch.Tensor       # specific growth (1/s)
    up_NO: torch.Tensor          # nitrate uptake (mmol/m^2/s)
    up_NH: torch.Tensor          # ammonium uptake
    chla: torch.Tensor           # column chlorophyll (mg/m^2)
    zoo: torch.Tensor            # column N closure sink (mmol N/m^2)
    nitrification: torch.Tensor  # column nitrification (mmol N/m^2)
    cerror: torch.Tensor         # max |carbon residual| (mmol C/m^3)
    frac_new: Optional[torch.Tensor] = None  # [*B, n_bio] mobile fraction


def zbgc_transport_react(dt, C, iphin, iDin, darcy_v, hbr, hbr_old,
                         dh_bot, fswpen, T_bot, ocean_bio,
                         p: ZbgcParams, flux_bio_atm=None, frac=None,
                         tables: Optional[ZbgcTables] = None):
    """One z-biogeochemistry step for all tracers at once
    (reference z_biogeochemistry :794-1497).

    C [*B, n_bio, K] brine concentrations on the K=nblyr+1 igrid;
    iphin/iDin [*B, K]; darcy_v [*B] (m/s, <0 flushing downward);
    hbr/hbr_old [*B]; dh_bot [*B] bottom growth (+) / melt (-);
    fswpen [*B] shortwave at the ice interior; ocean_bio [n_bio]
    or [*B, n_bio].  flux_bio_atm [*B, n_bio]: atmospheric deposition
    (snow->brine source, mmol/m^2/s).  frac [*B, n_bio]: mobile
    fraction per tracer (the zbgc_frac tracer); when given, each
    tracer splits into a brine-mobile phase (vertically transported)
    and an ice-attached stationary phase, with retention/release
    exchange per the tracer's mobility type
    (ice_algae.F90:1113-1226); reactions act on the total.
    tables: `zbgc_tables(p, ...)` (made here when None).
    Returns ZbgcResult (frac_new set when frac was given)."""
    K = C.shape[-1]
    nblyr = K - 1
    if tables is None or tables.zspace is None or \
            tables.zspace.shape[0] != K:
        tables = zbgc_tables(p, C.dtype, C.device, nblyr)
    zw0 = float(layer_weights(nblyr)[0])
    zspace_t = tables.zspace
    hbr_s = hbr.clamp(min=c.PUNY)
    ocean_b = torch.broadcast_to(ocean_bio, C.shape[:-1])

    C_stat = None
    if frac is not None:
        # mobile/stationary split + phase exchange (reference
        # ice_algae.F90:1193-1226): melting releases, growth retains
        melting = (hbr < hbr_old)[..., None]             # [*B, 1]
        rtau_ret = torch.where(melting, 0.0, tables.rtau_ret)
        rtau_rel = torch.where(melting, tables.rtau_rel, 0.0)
        Cm = C * frac[..., None]
        Cs = (C - Cm).clamp(min=0.0)
        dmob = tables.mobile[..., None] * Cm * (
            torch.exp(-dt * rtau_ret)[..., None] - 1.0) + \
            Cs * (1.0 - torch.exp(-dt * rtau_rel)[..., None])
        Cm = (Cm + dmob).clamp(min=0.0)
        C_stat = (Cs - dmob).clamp(min=0.0)
        C = Cm

    # --- implicit vertical diffusion + upwind Darcy advection -------
    # nondimensional advective velocity (1/s): Darcy flushing through
    # the brine column
    w = darcy_v / iphin[..., K // 2].clamp(min=c.PUNY) / hbr_s
    # bottom-growth grid motion: new ice at the bottom pulls ocean
    # water in (scavenging source), melt expels to the ocean
    growth_vel = dh_bot / dt / hbr_s

    dx = 1.0 / nblyr
    # the tridiagonal coefficients are the same for every tracer
    # (velocity and diffusivity are per column), so ONE [*B, K]
    # coefficient set drives a Thomas solve batched over the tracer axis
    Dif = 0.5 * (iDin[..., :-1] + iDin[..., 1:])         # [*B, K-1]
    lo = torch.zeros_like(iDin)
    di = torch.ones_like(iDin)
    up = torch.zeros_like(iDin)
    wp = w.clamp(min=0.0)
    wm = (-w).clamp(min=0.0)
    for k in range(K):
        d_dn = Dif[..., k] / dx ** 2 if k < K - 1 else 0.0
        d_up = Dif[..., k - 1] / dx ** 2 if k > 0 else 0.0
        # upwind advection: w>0 moves tracer downward (to larger k)
        a_dn = wm / dx if k < K - 1 else 0.0
        a_up = wp / dx if k > 0 else 0.0
        diag = 1.0 + dt * (d_dn + d_up + a_dn + a_up)
        if k == K - 1:
            # bottom boundary: exchange with the ocean through the
            # molecular sublayer + growth scavenging
            ex = 2.0 * iDin[..., K - 1] / dx ** 2 + \
                growth_vel.clamp(min=0.0) / dx + wp / dx
            diag = diag + dt * ex
        di[..., k] = diag
        if k > 0:
            lo[..., k] = -dt * (d_up + a_up)
        if k < K - 1:
            up[..., k] = -dt * (d_dn + a_dn)
    rhs = C.clone()
    rhs[..., K - 1] = C[..., K - 1] + dt * ex[..., None] * ocean_b * \
        p.frazil_scav
    C_low = _thomas(lo[..., None, :], di[..., None, :], up[..., None, :],
                    rhs)
    # second-order flux-corrected anti-diffusion of the advective part
    # (the reference's FCT correction; boundary exchange untouched)
    C2 = _fct_antidiffusion(C, C_low, w[..., None], dt, dx)

    # recombine phases: the stationary part saw no vertical transport;
    # the new mobile fraction is the transported share of the column
    # totals (reference sum_new/sum_tot, ice_algae.F90:1296-1307)
    frac_new = None
    if C_stat is not None:
        wgt = iphin[..., None, :] * zspace_t
        num = (C2 * wgt).sum(-1)
        den = ((C2 + C_stat) * wgt).sum(-1)
        frac_new = torch.where(den > c.PUNY,
                               num / den.clamp(min=c.PUNY), 1.0)
        frac_new = frac_new.clamp(0.0, 1.0)
        C2 = C2 + C_stat

    # atmospheric deposition into the top layer (zbgc_atm/snow source)
    if flux_bio_atm is not None:
        C2 = C2.clone()
        C2[..., 0] = C2[..., 0] + flux_bio_atm * dt / (
            (iphin[..., 0] * hbr_s).clamp(min=c.PUNY) * zw0)[..., None]

    # --- reactions: every layer in one call (the layer axis batched) ----
    # shortwave decays toward the bottom of the column
    fk = fswpen[..., None] * tables.sw_decay
    r = algal_reactions(dt, C2.transpose(-1, -2), fk, T_bot[..., None], p,
                        tables)
    C3 = C2 + r.react.transpose(-1, -2)
    wgt = iphin * hbr_s[..., None] * zspace_t               # [*B, K]
    pp_net = (r.grow * wgt).sum(-1)
    upNO = (r.upNO * wgt).sum(-1)
    upNH = (r.upNH * wgt).sum(-1)
    zoo_col = (r.zoo * wgt).sum(-1)
    nitrif_col = (r.nitrif * wgt).sum(-1)
    cerr = r.cerror.abs().amax(-1)
    grow_net = r.grow.sum(-1)

    # positivity with conservative ocean-flux bookkeeping: clipped
    # mass leaves/enters as ocean flux (reference adjust_tracer_profile)
    neg = C3.clamp(max=0.0)
    flux_ocn = (neg * iphin[..., None, :] * zspace_t).sum(-1) * \
        hbr_s[..., None] / dt
    C3 = C3.clamp(min=0.0)

    # content change from brine-height change (melt releases to ocean)
    shrink = (hbr - hbr_old).clamp(max=0.0)
    flux_ocn = flux_ocn - (
        C3 * iphin[..., None, :] * zspace_t).sum(-1) * \
        shrink[..., None] / dt

    na = p.n_algae
    R_chl2N = tables.species["R_chl2N"]
    chla = (R_chl2N[:, None] * C3[..., :na, :] * iphin[..., None, :] *
            zspace_t).sum((-2, -1)) * hbr_s
    return ZbgcResult(tracers=C3, flux_bio=flux_ocn, pp_net=pp_net,
                      grow_net=grow_net / K, up_NO=upNO, up_NH=upNH,
                      chla=chla, zoo=zoo_col, nitrification=nitrif_col,
                      cerror=cerr, frac_new=frac_new)
