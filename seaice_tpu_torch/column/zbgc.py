"""The zBGC reaction parameters and tracer roster (`ZbgcParams`).

The port's copy of the dataclass of the JAX package's `column/zbgc.py`,
alone: `namelist.config_from_namelist` builds one from the
biogeochemistry record (Registry.xml:893-1328).  The vertical
biogeochemistry that consumes it is not ported (`ColumnPhysics` raises
for `zbgc_params`, ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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
