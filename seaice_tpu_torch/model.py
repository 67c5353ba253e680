"""The model: state container + the timestep.

Equivalent of the reference's core run loop and time integration
(MPAS-Seaice `src/model_forward/mpas_seaice_core.F:257-371` and
`src/shared/mpas_seaice_time_integration.F:42-175`): one `seaice_timestep`
= column pre-dynamics -> (dynamics subcycle: velocity solve -> transport
-> ridging) -> column post-dynamics, with the working set resident on the
device; the velocity solve's kernel follows from the mesh
(panel-reordered sphere, raster quad box, or any connectivity).  The
column physics (`column/`, `cfg.column.use_column_package`) supplies the
thermodynamics before the dynamics, the Rothrock strength and the
ridging inside each dynamics subcycle, and the post-dynamics
aggregation.  The body of the dynamics subcycles,
`dynamics_transport_steps`, is a generator that stops at every halo
exchange (`utils/lockstep.py`): `SeaIceModel` runs it alone,
`parallel/sharded.py` runs one per block, with the column phases
before and after it on each block's cells.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .column.driver import AtmosForcing, ColumnPhysics, OceanForcing
from .column.tuning import Tunables
from .config import AdvectionType, Config
from .mesh.core import Mesh, MeshTensors
from .dynamics import evp
from .dynamics.evp import (DynamicsForcing, DynamicsTensors,
                           VelocitySolverState, build_dynamics_tensors,
                           init_velocity_state)
from .transport.geometry import RemapTensors, build_remap_geometry
from .transport.remap import (global_conserved_sums, local_extrema,
                              make_remap_step, monotonicity_violation)
from .transport.tracers import (TracerTree, mass_only_tree,
                                standard_tracer_tree)
from .utils.containers import tensor_dataclass
from .utils.device import resolve_device
from .utils.lockstep import drive


@tensor_dataclass
class State:
    """Full prognostic model state (the Registry 'restart' field set,
    reference Registry.xml:1910-2014)."""
    velocity: VelocitySolverState
    tracers: Dict[str, Any]         # tracer tensors keyed by name
    time: Any                       # model time, seconds since start


@tensor_dataclass
class ModelTensors:
    """All static per-mesh device tensors used by the step."""
    mesh: MeshTensors
    dynamics: DynamicsTensors
    remap: Optional[RemapTensors]
    upwind: Optional[Any]
    area_cell: Any


def _col_tunables(col) -> Tunables:
    """Build the column physics Tunables from the flat ColumnConfig
    fields (the namelist maps Registry options onto these)."""
    return Tunables(**{f.name: getattr(col, f.name)
                       for f in dataclasses.fields(Tunables)})


def column_tracer_tree(cfg: Config) -> TracerTree:
    """The tracer tree the column configuration carries (the JAX
    package's `SeaIceModel.__init__` tree; the biogeochemistry's own
    sizing is left out with it: `ColumnPhysics` raises for every option
    whose tracers the port does not step)."""
    col = cfg.column
    return standard_tracer_tree(
        n_ice_layers=cfg.run.n_ice_layers,
        n_snow_layers=cfg.run.n_snow_layers,
        use_ice_age=col.use_ice_age,
        use_first_year_ice=col.use_first_year_ice,
        use_level_ice=col.use_level_ice,
        pond_scheme=col.pond_scheme,
        use_snow_tracers=col.use_snow_tracers,
        n_aerosols=col.n_aerosols,
        use_brine_height=(col.use_brine_height or col.use_biogeochemistry
                          or col.solve_zsalinity),
        n_bio_tracers=col.n_bio_tracers,
        n_bio_grid_points=(col.n_bio_layers + 1
                           if col.use_biogeochemistry else 0),
        use_skeletal_bgc=col.use_skeletal_biochemistry,
        n_vertical_salinity=(col.n_bio_layers if col.solve_zsalinity
                             else 0))


def build_column_physics(cfg: Config, dtype, device) -> ColumnPhysics:
    """The ColumnPhysics of a config (the JAX package's
    `SeaIceModel.__init__` call), its tables in dtype on device."""
    col = cfg.column
    return ColumnPhysics(
        cfg.run.n_categories, cfg.run.n_ice_layers, cfg.run.n_snow_layers,
        kcatbound=col.kcatbound, kitd=col.kitd,
        krdg_partic=col.krdg_partic, krdg_redist=col.krdg_redist,
        natmiter=col.natmiter, shortwave=col.shortwave,
        ktherm=col.ktherm, kstrength=col.kstrength, atmbndy=col.atmbndy,
        use_shortwave=col.use_shortwave,
        use_vertical_thermodynamics=col.use_vertical_thermodynamics,
        use_itd_thermodynamics=col.use_itd_thermodynamics,
        pond_scheme=col.pond_scheme,
        use_level_ice=col.use_level_ice or col.pond_scheme == "lvl",
        use_ice_age=col.use_ice_age,
        use_first_year_ice=col.use_first_year_ice,
        use_snow_tracers=col.use_snow_tracers, snwredist=col.snwredist,
        n_aerosols=col.n_aerosols, use_form_drag=col.use_form_drag,
        highfreq=col.highfreq, tfrz_option=col.tfrz_option,
        rfracmin=col.rfracmin, rfracmax=col.rfracmax,
        pndaspect=col.pndaspect, frzpnd=col.frzpnd,
        dpscale=col.dpscale, hi_min_pond=col.hi_min_pond,
        mu_rdg=col.mu_rdg,
        shortwave_tuning=dict(
            albicev=col.albicev, albicei=col.albicei,
            albsnowv=col.albsnowv, albsnowi=col.albsnowi,
            ahmax=col.ahmax, R_ice=col.r_ice, R_pnd=col.r_pnd,
            R_snw=col.r_snw, dT_mlt=col.dt_mlt, rsnw_mlt=col.rsnw_mlt),
        zbgc_params=col.zbgc_params, tunables=_col_tunables(col),
        use_snicar=col.use_snicar, use_brine_height=col.use_brine_height,
        use_biogeochemistry=col.use_biogeochemistry,
        use_skeletal_bgc=col.use_skeletal_biochemistry,
        n_algae=col.n_algae, n_bio_layers=col.n_bio_layers,
        solve_zsalinity=col.solve_zsalinity,
        calc_tsfc=col.calc_surface_temperature,
        use_snow_liquid_ponds=col.use_snow_liquid_ponds,
        include_pond_freshwater_feedback=(
            col.include_pond_freshwater_feedback),
        use_modal_aerosols=col.use_modal_aerosols,
        dtype=dtype, device=device)


class SeaIceModel:
    """Owns the static mesh/basis/geometry tensors and builds the step for
    a Config (scheme selection at build time, like the reference's
    init-time scheme selection)."""

    def __init__(self, mesh: Mesh, cfg: Config, dtype=torch.float32,
                 device=None, tracer_tree: Optional[TracerTree] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.column = None
        if cfg.column.use_column_package:
            self.column = build_column_physics(cfg, dtype, self.device)
        if tracer_tree is None:
            if cfg.column.use_column_package:
                tracer_tree = column_tracer_tree(cfg)
            else:
                tracer_tree = TracerTree((
                    mass_only_tree().specs[0],
                    standard_tracer_tree().specs[1],
                    standard_tracer_tree().specs[2],
                ))
        self.tree = tracer_tree

        dev = self.device
        mesh_t = mesh.tensors(dtype, dev)
        dyn_t = build_dynamics_tensors(mesh, cfg, dtype, dev)
        remap_t = None
        if cfg.advection.advection_type == AdvectionType.INCREMENTAL_REMAP:
            remap_t = build_remap_geometry(
                mesh,
                rotate_cartesian_grid=cfg.velocity.rotate_cartesian_grid
            ).tensors(dtype, dev)
        elif cfg.advection.advection_type == AdvectionType.UPWIND:
            raise NotImplementedError(
                "upwind advection: later slice of the port")
        self.tensors = ModelTensors(
            mesh=mesh_t, dynamics=dyn_t, remap=remap_t, upwind=None,
            area_cell=torch.as_tensor(
                np.ascontiguousarray(mesh.area_cell, np.float64)).to(
                    device=dev, dtype=dtype))

    # -- state ---------------------------------------------------------------

    def init_state(self, ice_area_cat=None, ice_volume_cat=None,
                   snow_volume_cat=None) -> State:
        nc = self.mesh.n_cells
        ncat = self.cfg.run.n_categories
        dt, dev = self.dtype, self.device

        def fl(a):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dt)

        tr = {}
        for spec in self.tree.specs:
            shape = (nc, ncat) + ((spec.n_layers,) if spec.n_layers else ())
            tr[spec.name] = torch.zeros(shape, dtype=dt, device=dev)
        # non-zero tracer defaults: undeformed initial ice is all level
        # (reference init_column_tracers)
        if "levelIceArea" in tr:
            tr["levelIceArea"] = torch.ones((nc, ncat), dtype=dt, device=dev)
            tr["levelIceVolume"] = torch.ones((nc, ncat), dtype=dt,
                                              device=dev)
        for name in ("snowGrainRadius", "brineHeight", "bioMobileFraction",
                     "verticalSalinity"):
            if name in tr:
                raise NotImplementedError(
                    f"tracer {name}: its initial profile comes with the "
                    "column-physics slice of the port")
        if ice_area_cat is not None:
            tr["iceAreaCategory"] = fl(ice_area_cat)
        if ice_volume_cat is not None:
            tr["iceVolumeCategory"] = fl(ice_volume_cat)
        if snow_volume_cat is not None:
            tr["snowVolumeCategory"] = fl(snow_volume_cat)
        # physical enthalpy/salinity/Tsfc profiles wherever there is
        # ice: zero-enthalpy "ice" sits exactly at the melting point
        # (the reference always initializes via colpkg_init_trcr)
        if ice_area_cat is not None and "iceEnthalpy" in tr:
            from .column.thermo_shared import init_thermo_tracers
            tr = init_thermo_tracers(tr, self.cfg.run.n_ice_layers,
                                     self.cfg.run.n_snow_layers, dt)
        return State(
            velocity=init_velocity_state(self.mesh, dt, dev),
            tracers=tr,
            time=torch.zeros((), dtype=dt, device=dev),
        )

    # -- step ----------------------------------------------------------------

    def _raster_loop_eligible(self, raster) -> bool:
        """Whether the velocity solve takes the raster loop
        (`dynamics/cuda_raster.py`): a planar raster-quad mesh with a
        cell-constant basis, standard EVP with quadratic ocean stress, no
        metric terms.  `use_pallas_subcycle=True` on a raster mesh that is
        ineligible raises instead of falling back."""
        from .config import (ConstitutiveRelation, OceanStressType,
                             StrainScheme)
        from .dynamics.cuda_raster import basis_is_cell_constant
        v = self.cfg.velocity
        fast = self.tensors.dynamics.fast
        eligible = (
            raster is not None and not getattr(raster, "periodic", False)
            and v.strain_scheme == StrainScheme.VARIATIONAL
            and v.constitutive_relation == ConstitutiveRelation.EVP
            and not v.include_metric_terms
            and not v.average_variational_strains
            and v.use_ocean_stress
            and v.ocean_stress_type == OceanStressType.QUADRATIC
            and fast is not None and basis_is_cell_constant(fast))
        if raster is not None and v.use_pallas_subcycle is True \
                and not eligible:
            raise ValueError(
                "use_pallas_subcycle=True but the configuration is "
                "ineligible (needs raster-quad mesh, cell-constant basis, "
                "standard EVP, quadratic ocean stress, no metric terms)")
        return eligible

    def make_step(self):
        """Build step(tensors, state, forcing) -> (state, diags).

        The subcycle loop and the flux integration go through the kernels'
        wrappers (CUDA kernels for CUDA tensors, their plain versions for
        CPU tensors).  Which subcycle kernel follows from the mesh: a
        panel-reordered sphere (`mesh.panel_layout`) takes the whole-loop
        panel kernel, or with `use_fused_panel_loop=False` the
        per-subcycle cell kernel; an eligible raster quad mesh takes the
        raster loop; any other mesh the any-connectivity loop.  The
        config's `use_pallas_subcycle` / `use_fused_unstructured` /
        `use_pallas_flux` = False raise: no option runs a plain version on
        the card."""
        cfg = self.cfg
        tree = self.tree
        check_kernel_options(cfg)
        from .mesh.structured import detect_raster_quad
        lay = getattr(self.mesh, "panel_layout", None)
        panel_n = (lay.N if lay is not None
                   and self.tensors.dynamics.panel is not None else None)
        raster = None
        if panel_n is None:
            raster = detect_raster_quad(self.mesh)
            if not self._raster_loop_eligible(raster):
                raster = None
        vel_solve = evp.velocity_solve_steps(
            cfg, raster=raster, panel_n=panel_n,
            panel_mesh=self.mesh if panel_n is not None else None)
        remap_step = None
        if cfg.advection.advection_type == AdvectionType.INCREMENTAL_REMAP:
            remap_step = make_remap_step(
                tree, self.mesh.vertex_degree,
                monotonic=cfg.advection.monotonic)
        column = self.column
        body = dynamics_transport_steps(cfg, tree, vel_solve, remap_step,
                                        column=column)

        def step(tensors: ModelTensors, state: State,
                 forcing: DynamicsForcing,
                 atmos: Optional[AtmosForcing] = None,
                 ocean: Optional[OceanForcing] = None,
                 coszen=None):
            """One coupling timestep (reference seaice_timestep,
            mpas_seaice_time_integration.F:42-175): column pre-dynamics
            -> (velocity solve -> transport -> ridging) x n_sub ->
            column post-dynamics.  Without the column package, or
            without `atmos`, the column phases before and after the
            dynamics are left out.

            coszen: cell cosine solar zenith (dEdd shortwave).  The
            JAX step's further inputs (day_of_year/lat, faero_atm,
            sfc_fluxes) feed options the port does not run (first-year
            ice, aerosols, calc_Tsfc=False), which raise when the model
            is built (ROADMAP.md Queue 1 item 10)."""
            thermo = column is not None and atmos is not None
            if thermo:
                state, fluxes = column_before_dynamics(
                    cfg, column, state, atmos, ocean, coszen)
            new_state, diags = drive(body(tensors, state, forcing))
            if thermo:
                new_state, diags = column_after_dynamics(
                    cfg, column, new_state, diags, atmos, fluxes)
            return new_state, diags

        return step


def column_before_dynamics(cfg: Config, column: ColumnPhysics, state: State,
                           atmos: AtmosForcing, ocean: OceanForcing,
                           coszen=None):
    """The column phase before the dynamics: vertical and ITD
    thermodynamics, per cell.  Returns (state, ColumnFluxes)."""
    tr, fluxes = column.step_thermodynamics(
        cfg.run.dt, dict(state.tracers), atmos, ocean, coszen=coszen)
    return state.replace(tracers=tr), fluxes


def column_after_dynamics(cfg: Config, column: ColumnPhysics, state: State,
                          diags, atmos: AtmosForcing, fluxes):
    """The column phase after the dynamics, per cell: snow physics and
    coupling prep (reference column.F:1208).  Returns (state, diags)
    with the coupling prep and the thermodynamics' fluxes in diags."""
    wind = torch.sqrt(atmos.u_air ** 2 + atmos.v_air ** 2)
    tr, post = column.step_post_dynamics(
        cfg.run.dt, state.tracers, wind=wind, snow_rate=atmos.snow_rate)
    diags["coupling_prep"] = post
    diags["column_fluxes"] = fluxes
    return state.replace(tracers=tr), diags


def check_kernel_options(cfg: Config):
    """The config's `use_pallas_flux` / `use_pallas_subcycle` = False ask
    for a plain version on the card, which no option of the port runs."""
    if cfg.advection.use_pallas_flux is False:
        raise NotImplementedError(
            "use_pallas_flux=False: the port has one flux integration, "
            "`integrate_fluxes_cuda`, which takes its CUDA kernel for "
            "CUDA tensors and its plain version for CPU tensors; there "
            "is no option that runs the plain version on the card")
    if cfg.velocity.use_pallas_subcycle is False:
        raise NotImplementedError(
            "use_pallas_subcycle=False: every subcycle loop of the "
            "port is a kernel wrapper that takes its CUDA kernel for "
            "CUDA tensors and its plain version for CPU tensors; there "
            "is no option that runs a plain version on the card")


def dynamics_transport_steps(cfg: Config, tree: TracerTree, vel_solve,
                             remap_step, adv_checks: bool = True,
                             column: Optional[ColumnPhysics] = None):
    """The body of the dynamics-transport step as a generator function:
    (velocity solve -> incremental remap -> tracer halo refresh ->
    ridging) x dynamics_subcycle_number, returning (state, diags).

    vel_solve: from `evp.velocity_solve_steps`; remap_step: from
    `make_remap_step`, or None without transport.  It yields where the
    velocity solve does, and ("cell_field", tracers) after each remap (the
    2-deep tracer halo refresh of a partitioned mesh; the remap returns new
    tensors, so the refresh may write them in place).  adv_checks=False
    leaves out the optional conservation and monotonicity checks of the
    config, which sum over the mesh (a block's sums are not the mesh's).
    column: the model's `ColumnPhysics`, or None without the column
    package; with it the velocity solve takes the Rothrock strength
    (kstrength=1) and every subcycle ends with ridging
    (`cfg.column.use_ridging`)."""
    adv_checks = adv_checks and (cfg.advection.conservation_check or
                                 cfg.advection.monotonicity_check)
    dt_dyn = cfg.dynamics_timestep
    n_sub = cfg.velocity.dynamics_subcycle_number
    use_ridging = column is not None and cfg.column.use_ridging
    use_kstrength = column is not None and cfg.column.kstrength == 1

    def steps(tensors: ModelTensors, state: State,
              forcing: DynamicsForcing):
        tr = dict(state.tracers)
        vel = state.velocity
        diags = {}
        for _ in range(n_sub):
            if cfg.velocity.use_velocity_solver:
                # Rothrock strength from the column package (reference
                # kstrength dispatch, ice_mechred.F90 ice_strength)
                pressure_in = (column.ice_strength(tr) if use_kstrength
                               else None)
                vel, diags = yield from vel_solve(
                    tensors.dynamics, vel, forcing,
                    tr["iceAreaCategory"], tr["iceVolumeCategory"],
                    tr["snowVolumeCategory"], pressure_in=pressure_in)
            if remap_step is not None:
                tr, diags = yield from _transport(tensors, tr, vel, diags)
            if use_ridging and diags:
                tr, rdg = column.step_ridging(
                    dt_dyn, tr, diags["ridge_convergence"],
                    diags["ridge_shear"])
                diags.update(rdg)
        new_state = State(velocity=vel, tracers=tr,
                          time=state.time + cfg.run.dt)
        return new_state, diags

    def _transport(tensors, tr, vel, diags):
        """Incremental remap of every tracer, the tracer halo refresh and
        the optional self-checks."""
        if adv_checks:
            pre_sums = (global_conserved_sums(tree, tr, tensors.area_cell)
                        if cfg.advection.conservation_check else None)
            pre_ext = (local_extrema(
                tree, tr, tensors.mesh.cells_on_cell,
                tensors.mesh.cells_on_cell_mask)
                if cfg.advection.monotonicity_check else None)
        tr = remap_step(
            tensors.remap, tensors.mesh.cells_on_cell,
            tensors.mesh.cells_on_cell_mask, tensors.area_cell,
            tr, vel.u_velocity, vel.v_velocity, dt_dyn)
        # 2-deep tracer halo refresh (owned values are authoritative;
        # halo updates computed locally are discarded)
        yield "cell_field", tuple(tr.values())
        if adv_checks:
            # runtime self-checks (reference optional IR checks,
            # ..._incremental_remap.F:8126,8416)
            if pre_sums is not None:
                post = global_conserved_sums(tree, tr, tensors.area_cell)
                err = torch.stack([
                    (post[k] - pre_sums[k]).abs() /
                    pre_sums[k].abs().clamp(min=1e-30)
                    for k in pre_sums]).max()
                prev = diags.get("ir_conservation_error")
                diags["ir_conservation_error"] = err \
                    if prev is None else torch.maximum(prev, err)
            if pre_ext is not None:
                viol = monotonicity_violation(tree, tr, *pre_ext)
                prev = diags.get("ir_monotonicity_violation")
                diags["ir_monotonicity_violation"] = viol \
                    if prev is None else torch.maximum(prev, viol)
        return tr, diags

    return steps
