"""The model: state container + the timestep.

Equivalent of the reference's core run loop and time integration
(MPAS-Seaice `src/model_forward/mpas_seaice_core.F:257-371` and
`src/shared/mpas_seaice_time_integration.F:42-175`): one `seaice_timestep`
= column pre-dynamics -> (dynamics subcycle: velocity solve -> transport
-> ridging) -> column post-dynamics.

The port runs the dynamics-transport step so far
(`use_column_package=False`): velocity solve -> incremental remap, with
the working set resident on the device; the velocity solve's kernel
follows from the mesh (panel-reordered sphere, raster quad box, or any
connectivity).  The body of the step, `dynamics_transport_steps`, is a
generator that stops at every halo exchange (`utils/lockstep.py`):
`SeaIceModel` runs it alone, `parallel/sharded.py` runs one per block.
The column physics (and with it ridging and the Rothrock strength) is a
later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

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


class SeaIceModel:
    """Owns the static mesh/basis/geometry tensors and builds the step for
    a Config (scheme selection at build time, like the reference's
    init-time scheme selection)."""

    def __init__(self, mesh: Mesh, cfg: Config, dtype=torch.float32,
                 device=None, tracer_tree: Optional[TracerTree] = None):
        if cfg.column.use_column_package:
            raise NotImplementedError(
                "column physics: a later slice of the port (ROADMAP Queue 1 "
                "item 4)")
        self.mesh = mesh
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        if tracer_tree is None:
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
        self.column = None

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
        body = dynamics_transport_steps(cfg, tree, vel_solve, remap_step)

        def step(tensors: ModelTensors, state: State,
                 forcing: DynamicsForcing):
            """One coupling timestep (reference seaice_timestep,
            mpas_seaice_time_integration.F:42-175) without the column
            package: (velocity solve -> transport) x n_sub."""
            return drive(body(tensors, state, forcing))

        return step


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
                             remap_step, adv_checks: bool = True):
    """The body of the dynamics-transport step as a generator function:
    (velocity solve -> incremental remap -> tracer halo refresh) x
    dynamics_subcycle_number, returning (state, diags).

    vel_solve: from `evp.velocity_solve_steps`; remap_step: from
    `make_remap_step`, or None without transport.  It yields where the
    velocity solve does, and ("cell_field", tracers) after each remap (the
    2-deep tracer halo refresh of a partitioned mesh; the remap returns new
    tensors, so the refresh may write them in place).  adv_checks=False
    leaves out the optional conservation and monotonicity checks of the
    config, which sum over the mesh (a block's sums are not the mesh's)."""
    adv_checks = adv_checks and (cfg.advection.conservation_check or
                                 cfg.advection.monotonicity_check)
    dt_dyn = cfg.dynamics_timestep
    n_sub = cfg.velocity.dynamics_subcycle_number

    def steps(tensors: ModelTensors, state: State,
              forcing: DynamicsForcing):
        tr = dict(state.tracers)
        vel = state.velocity
        diags = {}
        for _ in range(n_sub):
            if cfg.velocity.use_velocity_solver:
                vel, diags = yield from vel_solve(
                    tensors.dynamics, vel, forcing,
                    tr["iceAreaCategory"], tr["iceVolumeCategory"],
                    tr["snowVolumeCategory"], pressure_in=None)
            if remap_step is None:
                continue
            if adv_checks:
                pre_sums = (global_conserved_sums(
                    tree, tr, tensors.area_cell)
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
                    post = global_conserved_sums(
                        tree, tr, tensors.area_cell)
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
        new_state = State(velocity=vel, tracers=tr,
                          time=state.time + cfg.run.dt)
        return new_state, diags

    return steps
