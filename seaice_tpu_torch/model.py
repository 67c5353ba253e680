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

import copy
import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .column.driver import AtmosForcing, ColumnPhysics, OceanForcing
from .column.tuning import Tunables
from .config import AdvectionType, Config
from .diagnostics import span
from .mesh.core import Mesh, MeshTensors, vertex_to_cell
from .dynamics import evp
from .dynamics.evp import (DynamicsForcing, DynamicsTensors,
                           VelocitySolverState, build_dynamics_tensors,
                           init_velocity_state)
from .transport.geometry import RemapTensors, build_remap_geometry
from .transport.remap import (global_conserved_sums, local_extrema,
                              make_remap_step, monotonicity_violation)
from .transport.tracers import (TracerTree, mass_only_tree,
                                standard_tracer_tree)
from .transport.upwind import build_upwind_tensors, make_upwind_step
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
    package's `SeaIceModel.__init__` tree): with the vertical
    biogeochemistry and no `n_bio_tracers` given, `bioTracers` is sized
    from the roster, n_bio x (n_bio_layers + 1) of the `zbgc_params`, or
    (n_algae + 3) x (n_bio_layers + 1) without them."""
    col = cfg.column
    n_bio = col.n_bio_tracers
    if col.use_biogeochemistry and not n_bio:
        n_per = (col.zbgc_params.n_bio if col.zbgc_params is not None
                 else col.n_algae + 3)
        n_bio = n_per * (col.n_bio_layers + 1)
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
        n_bio_tracers=n_bio,
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
        self.dtype = dtype
        self.device = resolve_device(device)
        self._set_config(cfg, tracer_tree)

        dev = self.device
        if dev.type == "cuda":
            # set-up, not the first step, pays nvcc where a library is
            # stale (`setup.kernels`)
            from .kernels.build import build_cuda
            build_cuda()
        mesh_t = mesh.tensors(dtype, dev)
        dyn_t = build_dynamics_tensors(mesh, cfg, dtype, dev)
        remap_t = None
        upwind_t = None
        if cfg.advection.advection_type == AdvectionType.INCREMENTAL_REMAP:
            remap_t = build_remap_geometry(
                mesh,
                rotate_cartesian_grid=cfg.velocity.rotate_cartesian_grid
            ).tensors(dtype, dev)
        elif cfg.advection.advection_type == AdvectionType.UPWIND:
            # the JAX package builds these with the builder's default
            # grid rotation, whatever the config says
            upwind_t = build_upwind_tensors(mesh, dtype, device=dev)
        self.tensors = ModelTensors(
            mesh=mesh_t, dynamics=dyn_t, remap=remap_t, upwind=upwind_t,
            area_cell=torch.as_tensor(
                np.ascontiguousarray(mesh.area_cell, np.float64)).to(
                    device=dev, dtype=dtype))

    def _set_config(self, cfg: Config,
                    tracer_tree: Optional[TracerTree] = None):
        """The config and what the model derives from its column options:
        the ColumnPhysics and the tracer tree (unless one is given)."""
        self.cfg = cfg
        self.column = None
        if cfg.column.use_column_package:
            self.column = build_column_physics(cfg, self.dtype, self.device)
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

    def with_column(self, **options) -> "SeaIceModel":
        """This model with the column options `options` over its own: a
        shallow copy that shares the mesh tensors (none of them depends on
        the column options) and derives its column physics and tracer
        tree as the constructor does when given no tree.  Saves rebuilding
        the tensors of a large mesh for each column configuration."""
        model = copy.copy(self)
        model._set_config(dataclasses.replace(
            self.cfg, column=dataclasses.replace(self.cfg.column, **options)))
        return model

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
        # non-zero tracer defaults: undeformed initial ice is all level;
        # fresh snow grain radius (reference init_column_tracers)
        if "levelIceArea" in tr:
            tr["levelIceArea"] = torch.ones((nc, ncat), dtype=dt, device=dev)
            tr["levelIceVolume"] = torch.ones((nc, ncat), dtype=dt,
                                              device=dev)
        if "snowGrainRadius" in tr:
            from .column.snow import RSNW_FALL
            tr["snowGrainRadius"] = torch.full(
                tr["snowGrainRadius"].shape, RSNW_FALL, dtype=dt,
                device=dev)
        if "brineHeight" in tr:
            tr["brineHeight"] = torch.ones((nc, ncat), dtype=dt, device=dev)
        if "bioMobileFraction" in tr:
            # zbgc_frac_init = 1: all-mobile initial phase partition
            # (reference ice_colpkg.F90:1510-1522)
            tr["bioMobileFraction"] = torch.ones(
                tr["bioMobileFraction"].shape, dtype=dt, device=dev)
        if "verticalSalinity" in tr:
            from .column.thermo_shared import salinity_profile
            tr["verticalSalinity"] = fl(salinity_profile(
                tr["verticalSalinity"].shape[-1])).expand(
                    tr["verticalSalinity"].shape).clone()
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
        """Whether the velocity solve of standard EVP takes the raster
        loop (`dynamics/cuda_raster.py`): a planar raster-quad mesh with
        a cell-constant basis, standard EVP with quadratic ocean stress,
        no metric terms.  `use_pallas_subcycle=True` on a raster mesh
        that is ineligible raises instead of falling back."""
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
        raster loop; any other mesh the any-connectivity loop.  A solver
        variant (`evp.is_variant`) runs its plain-torch loop instead,
        and upwind advection (`transport/upwind.py`) takes the place of
        the remap.  The
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
            # a solver variant takes the raster shifts on any raster
            # layout, standard EVP the raster loop where it is eligible
            raster = detect_raster_quad(self.mesh)
            if not (self._raster_loop_eligible(raster) or
                    evp.is_variant(cfg)):
                raster = None
        dv = self.mesh.dv_edge
        vel_solve = evp.velocity_solve_steps(
            cfg, min_dv_edge=float(np.min(dv[dv > 0])), raster=raster,
            panel_n=panel_n,
            panel_mesh=self.mesh if panel_n is not None else None)
        remap_step = upwind_step = None
        if cfg.advection.advection_type == AdvectionType.INCREMENTAL_REMAP:
            remap_step = make_remap_step(
                tree, self.mesh.vertex_degree,
                monotonic=cfg.advection.monotonic)
        elif cfg.advection.advection_type == AdvectionType.UPWIND:
            upwind_step = make_upwind_step(tree)
        column = self.column
        body = dynamics_transport_steps(cfg, tree, vel_solve, remap_step,
                                        column=column,
                                        upwind_step=upwind_step)

        def step(tensors: ModelTensors, state: State,
                 forcing: DynamicsForcing,
                 atmos: Optional[AtmosForcing] = None,
                 ocean: Optional[OceanForcing] = None,
                 coszen=None, day_of_year=None, lat=None,
                 faero_atm=None, sfc_fluxes=None):
            """One coupling timestep (reference seaice_timestep,
            mpas_seaice_time_integration.F:42-175): column pre-dynamics
            -> (velocity solve -> transport -> ridging) x n_sub ->
            column post-dynamics.  Without the column package, or
            without `atmos`, the column phases before and after the
            dynamics are left out.

            coszen: cell cosine solar zenith (dEdd shortwave).
            day_of_year (a number or a 0-d tensor) and lat (cell
            latitudes, radians): the first-year-ice reset.  sfc_fluxes:
            the calc_Tsfc=False prescribed per-category surface fluxes
            (dict: fsurf/fcondtop/flat/fsens [nCells, nCat]).  faero_atm
            [nCells, nAero]: aerosol deposition rate (kg/m^2/s)."""
            thermo = column is not None and atmos is not None
            with span("step"):
                if thermo:
                    state, fluxes = column_before_dynamics(
                        cfg, column, state, atmos, ocean, coszen,
                        day_of_year, lat, sfc_fluxes, tensors.mesh,
                        faero_atm)
                new_state, diags = drive(body(tensors, state, forcing))
                if thermo:
                    new_state, diags = column_after_dynamics(
                        cfg, column, new_state, diags, atmos, fluxes)
            return new_state, diags

        return step


def column_before_dynamics(cfg: Config, column: ColumnPhysics, state: State,
                           atmos: AtmosForcing, ocean: OceanForcing,
                           coszen=None, day_of_year=None, lat=None,
                           sfc_fluxes=None, mesh_t: MeshTensors = None,
                           faero_atm=None):
    """The column phase before the dynamics: vertical and ITD
    thermodynamics, per cell.  With high-frequency coupling the cell ice
    velocity is the mean of the state's vertex velocities over the
    cell's vertices (`mesh_t`: the mesh or block whose vertices the
    state holds).  Returns (state, ColumnFluxes)."""
    uvel = vvel = None
    if column.highfreq:
        vel = state.velocity
        uvel = vertex_to_cell(mesh_t, vel.u_velocity)
        vvel = vertex_to_cell(mesh_t, vel.v_velocity)
    with span("column.thermo"):
        tr, fluxes = column.step_thermodynamics(
            cfg.run.dt, dict(state.tracers), atmos, ocean, coszen=coszen,
            uvel=uvel, vvel=vvel, day_of_year=day_of_year, lat=lat,
            faero_atm=faero_atm, sfc_fluxes=sfc_fluxes)
    return state.replace(tracers=tr), fluxes


def column_after_dynamics(cfg: Config, column: ColumnPhysics, state: State,
                          diags, atmos: AtmosForcing, fluxes):
    """The column phase after the dynamics, per cell: snow physics and
    coupling prep (reference column.F:1208).  Returns (state, diags)
    with the coupling prep and the thermodynamics' fluxes in diags."""
    with span("column.post"):
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
                             column: Optional[ColumnPhysics] = None,
                             upwind_step=None):
    """The body of the dynamics-transport step as a generator function:
    (velocity solve -> incremental remap -> tracer halo refresh ->
    ridging) x dynamics_subcycle_number, returning (state, diags).

    vel_solve: from `evp.velocity_solve_steps`; remap_step: from
    `make_remap_step`, or None; upwind_step: from
    `transport.upwind.make_upwind_step`, run where the remap would be
    (on a whole mesh: no halo refresh follows it), or None; neither:
    no transport.  It yields where the
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
            elif upwind_step is not None:
                tr = upwind_step(tensors.upwind, tensors.area_cell, tr,
                                 vel.u_velocity, vel.v_velocity, dt_dyn)
            if use_ridging and diags:
                with span("column.ridging"):
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
            with span("remap.checks"):
                pre_sums = (global_conserved_sums(tree, tr,
                                                  tensors.area_cell)
                            if cfg.advection.conservation_check else None)
                pre_ext = (local_extrema(
                    tree, tr, tensors.mesh.cells_on_cell,
                    tensors.mesh.cells_on_cell_mask)
                    if cfg.advection.monotonicity_check else None)
        with span("transport.remap"):
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
            with span("remap.checks"):
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
