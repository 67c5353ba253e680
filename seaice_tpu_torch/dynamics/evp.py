"""EVP velocity solver.

One dynamics step covers the reference's pre-subcycle prep kernels, the
~120-iteration elastic subcycle loop (strain -> EVP stress -> stress
divergence -> ocean-stress coefficient -> 2x2 implicit momentum solve),
and the post-subcycle diagnostics (reference
`mpas_seaice_velocity_solver.F:562-3700`).  The subcycle loop goes through
one of four kernel wrappers, each a CUDA kernel on the GPU and its plain
PyTorch version on the CPU:

  * a panel-reordered icosahedral mesh (`mesh/panels.py`): the whole loop
    in one call of `cuda_panel_fused.evp_panel_loop`, or, with
    `use_fused_panel_loop=False`, one call of `cuda_panel.panel_cell_step`
    per subcycle with the vertex side in torch;
  * a raster-ordered planar quad mesh with a cell-constant basis
    (`mesh/structured.py`): one call of `cuda_raster.evp_raster_loop`;
  * any other mesh: one call of `cuda_unstructured.evp_subcycle_loop`;
    on a block of a partitioned mesh (a vertex halo exchange present),
    one `cuda_unstructured.evp_subcycle_step` per subcycle with the
    vertex-velocity halo refreshed between calls.

The solve is written as a generator (`velocity_solve_steps`) that stops
at each halo exchange (`utils/lockstep.py`); `make_velocity_solver` runs
it with the caller's exchange functions, the partitioned model
(`parallel/sharded.py`) runs one per block in lockstep.

The port covers the variational scheme with standard EVP and quadratic
ocean stress.  The weak scheme, revised EVP (and with it `min_dv_edge`),
the linear relation, strain averaging and the interior/boundary overlap
of the halo exchange (`halo_overlap`) raise NotImplementedError.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from .. import constants as c
from ..config import (Config, ConstitutiveRelation, OceanStressType,
                      StrainScheme, StressDivergenceScheme)
from ..mesh.core import Mesh, MeshTensors, cell_to_vertex
from ..utils.containers import tensor_dataclass
from ..utils.device import resolve_device
from ..utils.lockstep import drive
from . import constitutive, variational
from . import variational_panel as vpn
from .cuda_panel import panel_cell_step
from .cuda_panel_fused import evp_panel_loop
from .cuda_raster import basis_tables, build_raster_loop
from .cuda_unstructured import (evp_subcycle_finish, evp_subcycle_loop,
                                evp_subcycle_prepare, evp_subcycle_step)
from .momentum import momentum_update
from .variational_fast import build_fast_tensors, strain_tensor_T


@tensor_dataclass
class DynamicsTensors:
    """Static per-mesh tensors for the velocity solver."""
    mesh: MeshTensors
    basis_gradient_u: Any        # [nCells, maxEdges, maxEdges]
    basis_gradient_v: Any
    basis_integrals_u: Any       # [nCells, maxEdges, maxEdges]
    basis_integrals_v: Any
    basis_integrals_metric: Any
    variational_denominator: Any  # [nVertices]
    tan_lat_vertex: Any          # [nVertices] tan(lat)/r metric factor
    fast: Optional[Any]          # transposed-layout subcycle tensors
    area_cell: Any               # [nCells]
    area_triangle: Any           # [nVertices]
    panel: Optional[Any] = None  # panel-shift tensors (icosahedral)


def _uses_weak(cfg: Config) -> bool:
    return (cfg.velocity.strain_scheme == StrainScheme.WEAK or
            cfg.velocity.stress_divergence_scheme ==
            StressDivergenceScheme.WEAK)


def build_dynamics_tensors(mesh: Mesh, cfg: Config, dtype=torch.float32,
                           device=None) -> DynamicsTensors:
    """Init-time basis precompute + device upload
    (reference seaice_init_velocity_solver, velocity_solver.F:85-386).
    device=None: the GPU."""
    import numpy as np
    from ..ops.basis import compute_variational_basis

    device = resolve_device(device)
    if _uses_weak(cfg):
        raise NotImplementedError(
            "weak strain/stress-divergence scheme: later slice of the port")
    vb = compute_variational_basis(
        mesh,
        basis_type=cfg.velocity.variational_basis.value,
        integration_type=cfg.velocity.integration_type,
        integration_order=cfg.velocity.integration_order,
        denominator_type=cfg.velocity.variational_denominator.value,
        include_metric_terms=cfg.velocity.include_metric_terms,
        rotate_cartesian_grid=cfg.velocity.rotate_cartesian_grid,
    )

    def fl(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
            device=device, dtype=dtype)

    # panel-shift tensors when the mesh carries a rhombic-panel layout
    # (mesh/panels.panel_reorder attaches it)
    panel = None
    lay = getattr(mesh, "panel_layout", None)
    if lay is not None and mesh.max_edges == 6:
        from .variational_panel import build_panel_tensors
        panel = build_panel_tensors(mesh, lay, vb, dtype, device)
    return DynamicsTensors(
        panel=panel,
        mesh=mesh.tensors(dtype, device),
        basis_gradient_u=fl(vb.basis_gradient_u),
        basis_gradient_v=fl(vb.basis_gradient_v),
        basis_integrals_u=fl(vb.basis_integrals_u),
        basis_integrals_v=fl(vb.basis_integrals_v),
        basis_integrals_metric=fl(vb.basis_integrals_metric),
        variational_denominator=fl(vb.variational_denominator),
        tan_lat_vertex=fl(vb.tan_lat_vertex_over_radius),
        fast=build_fast_tensors(mesh, vb, dtype, device),
        area_cell=fl(mesh.area_cell),
        area_triangle=fl(mesh.area_triangle),
    )


@tensor_dataclass
class VelocitySolverState:
    """Prognostic state of the velocity solver."""
    u_velocity: Any              # [nVertices]
    v_velocity: Any              # [nVertices]
    stress11: Any                # [nCells, maxEdges] corner stresses
    stress22: Any
    stress12: Any
    solve_velocity_prev: Any     # [nVertices] mask from previous step


def init_velocity_state(mesh: Mesh, dtype=torch.float32,
                        device=None) -> VelocitySolverState:
    device = resolve_device(device)
    nv, nc, me = mesh.n_vertices, mesh.n_cells, mesh.max_edges
    z = functools.partial(torch.zeros, dtype=dtype, device=device)
    return VelocitySolverState(
        u_velocity=z((nv,)), v_velocity=z((nv,)),
        stress11=z((nc, me)), stress22=z((nc, me)), stress12=z((nc, me)),
        solve_velocity_prev=z((nv,)),
    )


@tensor_dataclass
class DynamicsForcing:
    """External forcing fields for one dynamics step (cell-centered unless
    noted)."""
    u_air_velocity: Any          # [nCells]
    v_air_velocity: Any
    air_density: Any             # [nCells]
    u_ocean_velocity: Any        # [nCells]
    v_ocean_velocity: Any
    sea_surface_tilt_u: Any      # [nCells]
    sea_surface_tilt_v: Any
    land_ice_mask: Any           # [nCells] float {0,1}


def zero_forcing(mesh: Mesh, dtype=torch.float32,
                 device=None) -> DynamicsForcing:
    device = resolve_device(device)
    z = functools.partial(torch.zeros, dtype=dtype, device=device)
    nc = mesh.n_cells
    return DynamicsForcing(
        u_air_velocity=z((nc,)), v_air_velocity=z((nc,)),
        air_density=torch.full((nc,), c.DENSITY_AIR, dtype=dtype,
                               device=device),
        u_ocean_velocity=z((nc,)), v_ocean_velocity=z((nc,)),
        sea_surface_tilt_u=z((nc,)), sea_surface_tilt_v=z((nc,)),
        land_ice_mask=z((nc,)),
    )


@tensor_dataclass
class IceMassState:
    """Aggregate mass/area fields entering the momentum solve."""
    ice_area_cell: Any           # [nCells] fractional area
    ice_volume_cell: Any         # [nCells] m
    snow_volume_cell: Any        # [nCells] m
    open_water_area: Any         # [nCells]


def aggregate_mass(ice_area_cat, ice_volume_cat, snow_volume_cat):
    """Category aggregation (reference velocity_solver.F:685-752).
    Inputs [nCells, nCategories]."""
    area = ice_area_cat.sum(dim=1)
    vol = ice_volume_cat.sum(dim=1)
    snow = snow_volume_cat.sum(dim=1)
    return IceMassState(
        ice_area_cell=area, ice_volume_cell=vol, snow_volume_cell=snow,
        open_water_area=(1.0 - area).clamp(min=0.0))


# -- pre-subcycle prep kernels ------------------------------------------------

def _computation_masks(mass: IceMassState, forcing: DynamicsForcing,
                       dyn: DynamicsTensors):
    """solveStress (cells) and solveVelocity (vertices) masks
    (reference velocity_solver.F:961-1150)."""
    mesh = dyn.mesh
    total_mass = (mass.ice_volume_cell * c.DENSITY_ICE +
                  mass.snow_volume_cell * c.DENSITY_SNOW)
    has_ice = ((mass.ice_area_cell > c.ICE_AREA_MINIMUM) &
               (total_mass > c.ICE_MASS_MINIMUM) &
               (forcing.land_ice_mask == 0)).to(total_mass.dtype)

    # a cell solves stress if it or any neighbor has ice
    neigh = has_ice[mesh.cells_on_cell] * mesh.cells_on_cell_mask
    solve_stress = torch.maximum(has_ice, neigh.max(dim=1).values)

    area_vertex = cell_to_vertex(mesh, mass.ice_area_cell)
    mass_vertex = cell_to_vertex(mesh, total_mass)
    land_vertex = cell_to_vertex(mesh, forcing.land_ice_mask)
    solve_velocity = (
        (mesh.interior_vertex > 0) &
        (land_vertex == 0) &
        (area_vertex > c.ICE_AREA_MINIMUM) &
        (mass_vertex > c.ICE_MASS_MINIMUM)).to(total_mass.dtype)
    return solve_stress, solve_velocity, total_mass, mass_vertex, area_vertex


def _ice_strength_hibler(mass: IceMassState, solve_stress):
    """Hibler (1979) P = P* h exp(-C (1-a))
    (reference velocity_solver.F:1422-1435)."""
    p = (c.ICE_STRENGTH_HIBLER_P * mass.ice_volume_cell *
         torch.exp(-c.ICE_STRENGTH_HIBLER_C * (1.0 - mass.ice_area_cell)))
    return torch.where(solve_stress > 0, p, torch.zeros_like(p))


def _air_stress(forcing: DynamicsForcing, mass: IceMassState,
                dyn: DynamicsTensors, use_air_stress: bool):
    """Constant-coefficient quadratic air drag, interpolated to vertices
    (reference velocity_solver.F:1665-1728)."""
    if not use_air_stress:
        nv = dyn.mesh.n_vertices
        z = torch.zeros((nv,), dtype=forcing.u_air_velocity.dtype,
                        device=forcing.u_air_velocity.device)
        return z, z
    wind = torch.sqrt(forcing.u_air_velocity ** 2 +
                      forcing.v_air_velocity ** 2)
    coeff = forcing.air_density * wind * c.AIR_STRESS_COEFF * \
        mass.ice_area_cell
    tau_u = coeff * forcing.u_air_velocity
    tau_v = coeff * forcing.v_air_velocity
    return (cell_to_vertex(dyn.mesh, tau_u),
            cell_to_vertex(dyn.mesh, tau_v))


# -- solver -------------------------------------------------------------------

def make_velocity_solver(cfg: Config, dyn: DynamicsTensors = None,
                         halo_exchange_vertex=None,
                         halo_exchange_cell_field=None,
                         halo_exchange_vertex_field=None, halo_overlap=None,
                         raster=None, use_pallas: Optional[bool] = None,
                         panel_n: Optional[int] = None, panel_mesh=None):
    """Build the dynamics-step function.

    The subcycle loop goes through a kernel wrapper: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors; see
    `velocity_solve_steps` for the routes and for raster, use_pallas,
    panel_n and panel_mesh.
    halo_exchange_vertex: optional (u, v) -> (u, v), the vertex-velocity
    halo refresh of one block of a partitioned mesh, run before the loop
    and after every subcycle; with it the loop is one
    `evp_subcycle_step` per subcycle (K6).
    halo_exchange_cell_field / halo_exchange_vertex_field: optional
    f -> f refreshers of the solveStress (cell) and solveVelocity (vertex)
    masks, whose stencils reach one ring beyond the halo (the reference's
    exchange groups, velocity_solver.F:257-345).  An exchange may refresh
    in place and return its argument, or return new tensors.
    halo_overlap: the interior/boundary overlap of the JAX package; not
    ported, raises.
    dyn: optional; if given, returns a convenience wrapper with dyn bound.

    Returns step(dyn, state, forcing, ice_area_cat, ice_volume_cat,
                 snow_volume_cat, pressure_in=None) -> (state, diags).
    """
    if halo_overlap is not None:
        raise NotImplementedError(
            "make_velocity_solver(halo_overlap=...): the interior/boundary "
            "overlap of the halo exchange needs CUDA streams; ROADMAP "
            "Queue 1 item 10")
    exchanges = {"vertex_uv": halo_exchange_vertex,
                 "cell_field": halo_exchange_cell_field,
                 "vertex_field": halo_exchange_vertex_field}
    solve = velocity_solve_steps(
        cfg, halo=any(f is not None for f in exchanges.values()),
        raster=raster, use_pallas=use_pallas, panel_n=panel_n,
        panel_mesh=panel_mesh)

    def step(dyn, state, forcing, ice_area_cat, ice_volume_cat,
             snow_volume_cat, pressure_in=None):
        return drive(solve(dyn, state, forcing, ice_area_cat,
                           ice_volume_cat, snow_volume_cat, pressure_in),
                     exchanges)

    if dyn is not None:
        return functools.partial(step, dyn)
    return step  # call as step(dyn, state, forcing, area, vol, snow)


def velocity_solve_steps(cfg: Config, *, halo: bool = False, raster=None,
                         use_pallas: Optional[bool] = None,
                         panel_n: Optional[int] = None, panel_mesh=None):
    """The velocity solve as a generator function (`utils/lockstep.py`).

    Returns solve(dyn, state, forcing, ice_area_cat, ice_volume_cat,
    snow_volume_cat, pressure_in=None): a generator that yields
    ("cell_field", (solveStress,)), ("vertex_field", (solveVelocity,)) and
    ("vertex_uv", (u, v)) where the JAX package refreshes halos
    (`seaice_tpu/dynamics/evp.py:597-598, 608, 812`) and returns
    (state, diags).

    The subcycle loop goes through a kernel wrapper.
    halo: the solve runs on one block of a partitioned mesh: the loop is
    `evp_subcycle_prepare`, then per subcycle `evp_subcycle_step` and a
    ("vertex_uv", (u, v)) exchange, then `evp_subcycle_finish` (K6).  The
    panel and raster routes take no halo: with either, ValueError.
    raster: optional mesh.structured.RasterQuad layout; the loop is then
    `evp_raster_loop` (planar raster quad mesh, cell-constant basis, no
    metric terms; the caller asserts the basis, as `SeaIceModel` does).
    panel_n: panel size N of a panel-reordered icosahedral mesh whose
    `dyn.panel` tensors exist; the loop is then `evp_panel_loop` when
    panel_mesh (the mesh object carrying `panel_layout`) is given and
    `use_fused_panel_loop` is not False, else one `panel_cell_step` per
    subcycle with the vertex side in torch.
    use_pallas: False asks for a plain loop and raises; None and True
    mean the kernel routes above.
    """
    if halo and (panel_n is not None or raster is not None):
        raise ValueError(
            "a halo exchange needs the any-connectivity loop: the panel "
            "and raster loops run on a whole, unpartitioned mesh")
    if use_pallas is False:
        raise NotImplementedError(
            "use_pallas=False: every subcycle loop of the port is a "
            "kernel wrapper that takes its CUDA kernel for CUDA tensors "
            "and its plain version for CPU tensors; there is no option "
            "that runs a plain version on the card")
    v_cfg = cfg.velocity
    dt_e = cfg.elastic_timestep
    damping_t = cfg.evp_damping_timescale
    relation = v_cfg.constitutive_relation

    if _uses_weak(cfg):
        raise NotImplementedError(
            "weak strain/stress-divergence scheme: later slice of the port")
    if relation != ConstitutiveRelation.EVP:
        raise NotImplementedError(
            f"constitutive relation {relation.value}: later slice of the "
            "port (this slice has standard EVP)")
    if v_cfg.average_variational_strains:
        raise NotImplementedError(
            "average_variational_strains: later slice of the port")
    if not v_cfg.use_ocean_stress or \
            v_cfg.ocean_stress_type != OceanStressType.QUADRATIC:
        raise NotImplementedError(
            "the subcycle loop of this slice has quadratic ocean stress "
            "only; linear or no ocean stress: later slice of the port")
    if v_cfg.use_fused_unstructured is False:
        raise NotImplementedError(
            "use_fused_unstructured=False: the any-connectivity subcycle "
            "loop is `evp_subcycle_loop`, which takes its CUDA kernel for "
            "CUDA tensors and its plain version for CPU tensors; there is "
            "no option that runs the plain version on the card")
    metric = v_cfg.include_metric_terms
    n_sub = v_cfg.elastic_subcycle_number

    raster_loop = None
    panel_route = None           # "loop" or "cell"
    if panel_n is not None:
        # panel-reordered sphere: the whole-loop kernel, or the
        # per-subcycle cell kernel with the vertex side in torch
        want_loop = v_cfg.use_fused_panel_loop
        loop_ok = (want_loop is not False and panel_mesh is not None and
                   getattr(panel_mesh, "panel_layout", None) is not None)
        if want_loop is True and not loop_ok:
            raise ValueError(
                "use_fused_panel_loop=True but the configuration is "
                "ineligible (needs the panel mesh object)")
        panel_route = "loop" if loop_ok else "cell"
    elif raster is not None:
        if metric:
            raise ValueError(
                "the raster loop requires a planar raster-quad mesh "
                "without metric terms")
        raster_loop = build_raster_loop(
            raster, dt_elastic=dt_e, damping_timescale=damping_t,
            n_subcycles=n_sub)
        if raster_loop is None:
            raise ValueError("raster layout ineligible for the raster "
                             "subcycle kernel")

    def solve(dyn: DynamicsTensors, state: VelocitySolverState,
              forcing: DynamicsForcing,
              ice_area_cat, ice_volume_cat, snow_volume_cat,
              pressure_in: Optional[Any] = None):
        """One dynamics step of the velocity solver (a generator, see
        `velocity_solve_steps`).

        pressure_in: optional externally computed ice strength [nCells]
        (from the column package); default Hibler.
        """
        mesh = dyn.mesh
        dtype = state.u_velocity.dtype

        # --- pre-subcycle (reference velocity_solver.F:613-671) ---
        mass = aggregate_mass(ice_area_cat, ice_volume_cat, snow_volume_cat)
        (solve_stress, solve_velocity, total_mass, mass_vertex,
         area_vertex) = _computation_masks(mass, forcing, dyn)
        if not v_cfg.calc_velocity_masks:
            # config_calc_velocity_masks=false: the dynamic ice-presence
            # masks are NOT recomputed (velocity_solver.F:897-900):
            # solve everywhere the geometry allows
            solve_stress = torch.ones_like(solve_stress)
            solve_velocity = (mesh.interior_vertex > 0).to(
                solve_velocity.dtype)
        # the solveStress neighbor-max and the vertex masks reach one ring
        # beyond the halo: refresh from their owners
        yield "cell_field", (solve_stress,)
        yield "vertex_field", (solve_velocity,)
        sv = solve_velocity > 0
        zero_v = torch.zeros_like(state.u_velocity)

        # new-ice velocities (reference :1164-1327)
        uo_v = cell_to_vertex(mesh, forcing.u_ocean_velocity)
        vo_v = cell_to_vertex(mesh, forcing.v_ocean_velocity)
        is_new = sv & (state.solve_velocity_prev == 0)
        u = torch.where(is_new, uo_v, state.u_velocity)
        v = torch.where(is_new, vo_v, state.v_velocity)
        u = torch.where(sv, u, zero_v)
        v = torch.where(sv, v, zero_v)
        yield "vertex_uv", (u, v)

        # ice strength (reference :1341-1508)
        if pressure_in is None:
            pressure = _ice_strength_hibler(mass, solve_stress)
        else:
            pressure = torch.where(solve_stress > 0, pressure_in,
                                   torch.zeros_like(pressure_in))

        # air stress (reference :1522-1651)
        air_u, air_v = _air_stress(forcing, mass, dyn, v_cfg.use_air_stress)

        # coriolis coefficient (reference :1742-1788)
        mass_f = mass_vertex * mesh.f_vertex

        # ocean stress rotation (reference :1802-1883)
        sgn_f = torch.sign(mesh.f_vertex)
        sgn_f = torch.where(sgn_f == 0, torch.ones_like(sgn_f), sgn_f)
        ocean_u = torch.where(
            sv,
            uo_v * c.COS_OCEAN_TURNING_ANGLE -
            vo_v * c.SIN_OCEAN_TURNING_ANGLE * sgn_f, zero_v)
        ocean_v = torch.where(
            sv,
            uo_v * c.SIN_OCEAN_TURNING_ANGLE * sgn_f +
            vo_v * c.COS_OCEAN_TURNING_ANGLE, zero_v)

        # surface tilt (reference :1897-2213)
        if not v_cfg.use_surface_tilt:
            tilt_u = zero_v
            tilt_v = zero_v
        elif v_cfg.geostrophic_surface_tilt:
            tilt_u = torch.where(sv, -mesh.f_vertex * mass_vertex * vo_v,
                                 zero_v)
            tilt_v = torch.where(sv, mesh.f_vertex * mass_vertex * uo_v,
                                 zero_v)
        else:
            tilt_uv = cell_to_vertex(mesh, forcing.sea_surface_tilt_u)
            tilt_vv = cell_to_vertex(mesh, forcing.sea_surface_tilt_v)
            tilt_u = torch.where(sv, -c.GRAVITY * mass_vertex * tilt_uv,
                                 zero_v)
            tilt_v = torch.where(sv, -c.GRAVITY * mass_vertex * tilt_vv,
                                 zero_v)

        # init subcycle variables (reference :2227-2386): zero stress
        # where not solving
        ss = (solve_stress > 0)[:, None]
        zero_s = torch.zeros_like(state.stress11)
        s11 = torch.where(ss, state.stress11, zero_s)
        s22 = torch.where(ss, state.stress22, zero_s)
        s12 = torch.where(ss, state.stress12, zero_s)

        # --- elastic subcycle loop (reference :2447-2592), in the
        # transposed [maxEdges, nCells] layout ---
        kw = dict(dt_elastic=dt_e, damping_timescale=damping_t,
                  n_subcycles=n_sub)
        sT = (s11.t().contiguous(), s22.t().contiguous(),
              s12.t().contiguous())
        if panel_route is not None and dyn.panel is None:
            raise ValueError("panel_n given but the dynamics tensors carry "
                             "no panel tensors (mesh not panel-reordered)")
        if panel_route == "loop":
            # ONE call runs all subcycles on the panel lattice
            u, v, t11, t22, t12 = evp_panel_loop(
                dyn.panel, u, v, *sT, pressure, solve_stress, uo_v, vo_v,
                mass_vertex, mass_f, air_u + tilt_u, air_v + tilt_v,
                ocean_u, ocean_v, solve_velocity, area_vertex,
                include_metric=metric, **kw)
        elif panel_route == "cell":
            # one kernel launch per subcycle for the cell side; ghosts,
            # dual sum, the 12 exception cells and the momentum solve in
            # torch; the loop state is slot-indexed and padded
            pt = dyn.panel
            exc_cols = pt.exc_pad_cols
            p_pad = vpn.cells_to_padded(pt, pressure)
            ss_pad = vpn.cells_to_padded(pt, solve_stress)
            p_exc = p_pad[exc_cols][None, :]
            ss_exc = (ss_pad[exc_cols] > 0)[None, :]
            ss_kernel = ss_pad.clone()
            ss_kernel[exc_cols] = 0      # the kernel leaves those columns
            t11, t22, t12 = (vpn.stress_ring_to_slot(pt, s) for s in sT)
            rhs_u0, rhs_v0 = air_u + tilt_u, air_v + tilt_v
            for _ in range(n_sub):
                planes = vpn.velocity_planes(pt, panel_n, u, v, metric)
                n11, n22, n12, stacked = panel_cell_step(
                    pt, planes, t11, t22, t12, p_pad, ss_kernel,
                    dt_elastic=dt_e, damping_timescale=damping_t,
                    include_metric=metric)
                # 12-cell exception path: ring-indexed strain + stress
                # update, written into the exception columns
                x11, x22, x12 = vpn.exception_strain(pt, u, v, metric)
                o11, o22, o12 = (t[:, exc_cols] for t in (t11, t22, t12))
                e11, e22, e12, _ = constitutive.evp_stress_update(
                    o11, o22, o12, x11, x22, x12, p_exc, dt_e, damping_t)
                n11[:, exc_cols] = torch.where(ss_exc, e11, o11)
                n22[:, exc_cols] = torch.where(ss_exc, e22, o22)
                n12[:, exc_cols] = torch.where(ss_exc, e12, o12)
                t11, t22, t12 = n11, n22, n12
                div_u, div_v = vpn.divergence_finish(
                    pt, panel_n, stacked, t11, t22, t12, solve_velocity,
                    metric)
                u, v = momentum_update(
                    u, v, div_u, div_v, uo_v, vo_v, mass_vertex, mass_f,
                    rhs_u0, rhs_v0, ocean_u, ocean_v, solve_velocity,
                    area_vertex, dt_e)
            t11, t22, t12 = (vpn.stress_slot_to_ring(pt, t)
                             for t in (t11, t22, t12))
        elif halo:
            # a block of a partitioned mesh: one kernel call per subcycle,
            # the vertex halo refreshed between calls (in place); the
            # copies, checks and scratch once per solve
            loop = evp_subcycle_prepare(
                dyn.fast, u, v, *sT, pressure, solve_stress, uo_v, vo_v,
                mass_vertex, mass_f, air_u + tilt_u, air_v + tilt_v,
                ocean_u, ocean_v, solve_velocity, area_vertex,
                include_metric=metric, dt_elastic=dt_e,
                damping_timescale=damping_t)
            for _ in range(n_sub):
                evp_subcycle_step(loop)
                yield "vertex_uv", (loop.u, loop.v)
            u, v, t11, t22, t12 = evp_subcycle_finish(loop)
        elif raster_loop is not None:
            # ONE call runs all subcycles on the raster with the four
            # cell-constant basis tables
            u, v, t11, t22, t12 = raster_loop(
                *basis_tables(dyn.fast), u, v, *sT, pressure, solve_stress,
                uo_v, vo_v, mass_vertex, mass_f, air_u, air_v, tilt_u,
                tilt_v, ocean_u, ocean_v, solve_velocity, area_vertex,
                dyn.fast.denominator)
        else:
            # ONE call runs all subcycles for any connectivity
            u, v, t11, t22, t12 = evp_subcycle_loop(
                dyn.fast, u, v, *sT, pressure, solve_stress, uo_v, vo_v,
                mass_vertex, mass_f, air_u + tilt_u, air_v + tilt_v,
                ocean_u, ocean_v, solve_velocity, area_vertex,
                include_metric=metric, **kw)
        s11, s22, s12 = (t11.t().contiguous(), t22.t().contiguous(),
                         t12.t().contiguous())

        # --- post-subcycle (reference :3360-3700) ---
        if panel_route is not None:
            # final diagnostic strain via the panel-shift formulation
            eS = vpn.strain_tensor_P(dyn.panel, panel_n, u, v, metric)
            e11, e22, e12 = (
                vpn.stress_slot_to_ring(dyn.panel, e).t() for e in eS)
        else:
            eT = strain_tensor_T(dyn.fast, u, v, metric)
            e11, e22, e12 = (e.t() for e in eT)
        div, shear, ridge_conv, ridge_shear = \
            variational.final_divergence_shear(
                e11, e22, e12, mesh, solve_stress, c.EVP_ECCENTRICITY_SQ)

        # principal stresses (reference :3443-3555)
        vm = mesh.vertices_on_cell_mask
        nvm = vm.sum(dim=1).clamp(min=1.0)
        s11m = (s11 * vm).sum(dim=1) / nvm
        s22m = (s22 * vm).sum(dim=1) / nvm
        s12m = (s12 * vm).sum(dim=1) / nvm
        mean = 0.5 * (s11m + s22m)
        rad = torch.sqrt((0.5 * (s11m - s22m)) ** 2 + s12m ** 2)
        sig1 = mean + rad
        sig2 = mean - rad

        # final ocean stress for the coupler (reference :3624-3700)
        ocean_coeff = (c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER * area_vertex *
                       torch.sqrt((uo_v - u) ** 2 + (vo_v - v) ** 2))
        ocean_coeff = torch.where(sv, ocean_coeff, zero_v)
        tau_ou = ocean_coeff * (
            (uo_v - u) * c.COS_OCEAN_TURNING_ANGLE -
            (vo_v - v) * c.SIN_OCEAN_TURNING_ANGLE * sgn_f)
        tau_ov = ocean_coeff * (
            (vo_v - v) * c.COS_OCEAN_TURNING_ANGLE +
            (uo_v - u) * c.SIN_OCEAN_TURNING_ANGLE * sgn_f)

        new_state = VelocitySolverState(
            u_velocity=u, v_velocity=v,
            stress11=s11, stress22=s22, stress12=s12,
            solve_velocity_prev=solve_velocity.to(dtype),
        )
        diags = {
            "divergence": div, "shear": shear,
            "ridge_convergence": ridge_conv, "ridge_shear": ridge_shear,
            "principal_stress1": sig1, "principal_stress2": sig2,
            "ice_pressure": pressure,
            "ocean_stress_u": tau_ou, "ocean_stress_v": tau_ov,
            "solve_stress": solve_stress, "solve_velocity": solve_velocity,
            "stress_divergence_u": torch.zeros_like(u),
            "stress_divergence_v": torch.zeros_like(v),
        }
        return new_state, diags

    return solve
