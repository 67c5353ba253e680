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
    one subcycle at a time (`cuda_unstructured.evp_subcycle_step`, one
    call for every block of the card) with the vertex-velocity halo
    refreshed between calls.

Those routes carry standard EVP with quadratic ocean drag on the
variational operators.  Every other option of the solver (the weak
scheme, revised EVP, the linear and `none` relations, strain averaging,
linear or no ocean stress) is a solver variant.  None of them reaches a
Pallas kernel in the JAX package (its XLA loop, `evp.py:842-975`), and
here their subcycle loop is plain torch on the tensors' device
(`variant_subcycles`), routed as the JAX package routes it: the weak
scheme and strain averaging through the generic gather operators, a
panel-reordered sphere through the panel-shift operators
(`variational_panel.strain_tensor_P`), a raster box through the raster
shifts (`variational_fast.strain_tensor_S`), any other mesh through the
transposed gathers (`strain_tensor_T`).  No option moves standard EVP
onto that loop.

The solve is written as a generator (`velocity_solve_steps`) that stops
at each halo exchange (`utils/lockstep.py`); `make_velocity_solver` runs
it with the caller's exchange functions, the partitioned model
(`parallel/sharded.py`) runs one per block in lockstep.  Under the
interior/boundary overlap of the halo exchange (`halo_overlap`,
`SubcycleOverlap`) a block's loop of standard EVP computes its export
vertices' new velocities first, through a small subset pipeline in plain
torch (`subcycle_exports`), so that their exchange can run while K6
computes the whole block.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from .. import constants as c
from ..diagnostics import span
from ..config import (Config, ConstitutiveRelation, OceanStressType,
                      StrainScheme, StressDivergenceScheme)
from ..mesh.core import Mesh, MeshTensors, cell_to_vertex
from ..utils.containers import tensor_dataclass
from ..utils.device import resolve_device
from ..utils.lockstep import drive
from . import constitutive, variational
from . import variational_fast as vf
from . import variational_panel as vpn
from .cuda_panel import panel_cell_prepare, panel_cell_step
from .cuda_panel_fused import evp_panel_loop
from .cuda_raster import basis_tables, build_raster_loop
from .cuda_unstructured import (evp_subcycle_finish, evp_subcycle_loop,
                                evp_subcycle_prepare, evp_subcycle_step)
from .momentum import (momentum_update, ocean_stress_coefficient,
                       solve_velocity_evp, solve_velocity_revised_evp)
from .variational_fast import build_fast_tensors, strain_tensor_T
from .weak import build_weak_tensors, strain_tensor_weak, \
    stress_divergence_weak


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
    weak: Optional[Any] = None   # line-integral scheme tensors


def _uses_weak(cfg: Config) -> bool:
    return (cfg.velocity.strain_scheme == StrainScheme.WEAK or
            cfg.velocity.stress_divergence_scheme ==
            StressDivergenceScheme.WEAK)


def is_variant(cfg: Config) -> bool:
    """Whether the velocity solve is a solver variant (plain torch,
    `variant_subcycles`) rather than standard EVP with quadratic ocean
    drag on the variational operators (a kernel's route)."""
    v = cfg.velocity
    return (_uses_weak(cfg) or
            v.constitutive_relation != ConstitutiveRelation.EVP or
            v.average_variational_strains or not v.use_ocean_stress or
            v.ocean_stress_type != OceanStressType.QUADRATIC)


def check_overlap(cfg: Config):
    """Raise the JAX package's ValueError (`seaice_tpu/dynamics/evp.py:
    690-699`) for a configuration the interior/boundary overlap cannot
    split; the port raises it as well where the ocean drag is not
    quadratic, which the JAX package's subset pipeline hard-codes while
    its full grid follows the config (ROADMAP Queue 3, fault 18)."""
    v = cfg.velocity
    msg = ("halo_overlap requires the fast variational path with standard "
           "EVP and no metric terms")
    if (_uses_weak(cfg) or v.include_metric_terms or
            v.constitutive_relation != ConstitutiveRelation.EVP or
            v.average_variational_strains):
        raise ValueError(msg)
    if is_variant(cfg):
        raise ValueError(
            msg + ", and quadratic ocean drag: the JAX package's export "
            "pipeline hard-codes it (ROADMAP Queue 3, fault 18)")


@tensor_dataclass
class SubcycleOverlap:
    """Subset tensors of one block for the interior/boundary overlap (the
    JAX package's `SubcycleOverlap`): the export vertices and the cells
    around them, so that a subcycle computes the export vertices' new
    velocities first (strain -> stress -> divergence -> momentum over
    those cells only) and their exchange runs beside the whole block's
    kernel."""
    export_idx: Any         # [nE] local owned vertex ids (0-padded)
    ec_idx: Any             # [nEc] local cell ids adjacent to exports
    voc_T_E: Any            # [me, nEc] corner vertex ids
    voc_mask_T_E: Any       # [me, nEc]
    basis_grad_T_E: Any     # [me(b), 2, me(g), nEc]
    basis_int_T_E: Any      # [me(s), 2, me(j), nEc]
    flat_corner_idx_E: Any  # [vd, nE] = pos_in_ec*me + cva
    cov_mask_E: Any         # [vd, nE]


def build_subcycle_overlap(mesh: Mesh, fast, vertex_export_idx, dtype,
                           device=None) -> SubcycleOverlap:
    """The subset of a block's FastTensors its export vertices read (host
    numpy, the JAX package's `build_subcycle_overlap`)."""
    import numpy as np
    me = mesh.max_edges
    E = np.asarray(vertex_export_idx, np.int64)
    cov = np.asarray(mesh.cells_on_vertex)[E]          # [nE, vd]
    ec = np.unique(cov[cov >= 0])
    if len(ec) == 0:
        ec = np.zeros(1, np.int64)
    pos = np.full(mesh.n_cells, 0, np.int64)
    pos[ec] = np.arange(len(ec))
    cva = np.asarray(mesh.cell_vertices_at_vertex)[E]  # [nE, vd]
    ok = (cov >= 0) & (cva >= 0)
    flat = pos[np.where(ok, cov, 0)] * me + np.where(ok, cva, 0)
    device = resolve_device(device)
    ecx = torch.as_tensor(ec).to(fast.voc_T.device)

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64)).to(device)

    def fl(t):
        return t.to(device=device, dtype=dtype)

    return SubcycleOverlap(
        export_idx=ix(E), ec_idx=ix(ec),
        voc_T_E=fast.voc_T.index_select(1, ecx).to(device),
        voc_mask_T_E=fl(fast.voc_mask_T.index_select(1, ecx)),
        basis_grad_T_E=fl(fast.basis_grad_T.index_select(3, ecx)),
        basis_int_T_E=fl(fast.basis_int_T.index_select(3, ecx)),
        flat_corner_idx_E=ix(flat.T),
        cov_mask_E=fl(torch.as_tensor(ok.T.astype(np.float64))))


def subcycle_exports(ov: SubcycleOverlap, fast, pressure, solve_stress,
                     vertex, dt_elastic: float, damping_timescale: float):
    """The export pipeline of one block's solve under the overlap (the
    JAX package's `export_pipeline`, `evp.py:719-757`, plain torch on
    the tensors' device): returns fn(u, v, t11, t22, t12) -> [nE, 2], the
    new (u, v) at the export vertices after one subcycle from the loop's
    state (stresses in the [maxEdges, nCells] layout).  vertex = (uo_v,
    vo_v, mass_vertex, mass_f, air_u, air_v, tilt_u, tilt_v, ocean_u,
    ocean_v, solve_velocity, area_vertex, denominator); the subset of
    each is taken once per solve."""
    E, ec = ov.export_idx, ov.ec_idx
    p_E = pressure.index_select(0, ec)[None, :]
    ss_E = (solve_stress.index_select(0, ec) > 0)[None, :]
    (uo, vo, mv, mf, au, av, tu, tv, ou, ovv, sv, avert,
     den) = (t.index_select(0, E) for t in vertex)
    gx, gy = ov.basis_grad_T_E[:, 0], ov.basis_grad_T_E[:, 1]
    bu, bv = ov.basis_int_T_E[:, 0], ov.basis_int_T_E[:, 1]
    solve = sv > 0
    zero = torch.zeros_like(uo)
    drag = c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER

    def exports(u, v, t11, t22, t12):
        u_c = u[ov.voc_T_E] * ov.voc_mask_T_E
        v_c = v[ov.voc_T_E] * ov.voc_mask_T_E
        e11 = (u_c[:, None, :] * gx).sum(0)
        e22 = (v_c[:, None, :] * gy).sum(0)
        e12 = 0.5 * ((u_c[:, None, :] * gy).sum(0) +
                     (v_c[:, None, :] * gx).sum(0))
        o11, o22, o12 = (t.index_select(1, ec) for t in (t11, t22, t12))
        n11, n22, n12, _ = constitutive.evp_stress_update(
            o11, o22, o12, e11, e22, e12, p_E, dt_elastic,
            damping_timescale)
        n11 = torch.where(ss_E, n11, o11)
        n22 = torch.where(ss_E, n22, o22)
        n12 = torch.where(ss_E, n12, o12)
        pu = (n11[:, None, :] * bu).sum(0) + (n12[:, None, :] * bv).sum(0)
        pv = (n22[:, None, :] * bv).sum(0) + (n12[:, None, :] * bu).sum(0)
        # the corner partials in (cell, corner) order, gathered per vertex
        fu, fv = pu.t().reshape(-1), pv.t().reshape(-1)
        du = -(fu[ov.flat_corner_idx_E] * ov.cov_mask_E).sum(0)
        dv = -(fv[ov.flat_corner_idx_E] * ov.cov_mask_E).sum(0)
        du = torch.where(solve, du / den, zero)
        dv = torch.where(solve, dv / den, zero)
        u_e, v_e = u.index_select(0, E), v.index_select(0, E)
        oc = drag * avert * torch.sqrt((uo - u_e) ** 2 + (vo - v_e) ** 2)
        oc = torch.where(solve, oc, zero)
        u_n, v_n = solve_velocity_evp(u_e, v_e, mv, mf, du, dv, au, av, tu,
                                      tv, ou, ovv, oc, sv, dt_elastic)
        return torch.stack([u_n, v_n], 1)

    return exports


@span("setup.dynamics_tensors")
def build_dynamics_tensors(mesh: Mesh, cfg: Config, dtype=torch.float32,
                           device=None) -> DynamicsTensors:
    """Init-time basis precompute + device upload
    (reference seaice_init_velocity_solver, velocity_solver.F:85-386).
    device=None: the GPU."""
    import numpy as np
    from ..ops.basis import compute_variational_basis

    device = resolve_device(device)
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

    # the weak scheme has its own tensors and neither the transposed nor
    # the panel-shift ones; the panel-shift tensors are built when the
    # mesh carries a rhombic-panel layout (mesh/panels.panel_reorder
    # attaches it)
    use_weak = _uses_weak(cfg)
    panel = None
    lay = getattr(mesh, "panel_layout", None)
    if lay is not None and not use_weak and mesh.max_edges == 6:
        from .variational_panel import build_panel_tensors
        panel = build_panel_tensors(mesh, lay, vb, dtype, device)
    return DynamicsTensors(
        panel=panel,
        weak=build_weak_tensors(
            mesh, dtype,
            rotate_cartesian_grid=cfg.velocity.rotate_cartesian_grid,
            device=device) if use_weak else None,
        mesh=mesh.tensors(dtype, device),
        basis_gradient_u=fl(vb.basis_gradient_u),
        basis_gradient_v=fl(vb.basis_gradient_v),
        basis_integrals_u=fl(vb.basis_integrals_u),
        basis_integrals_v=fl(vb.basis_integrals_v),
        basis_integrals_metric=fl(vb.basis_integrals_metric),
        variational_denominator=fl(vb.variational_denominator),
        tan_lat_vertex=fl(vb.tan_lat_vertex_over_radius),
        fast=(None if use_weak
              else build_fast_tensors(mesh, vb, dtype, device)),
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
                         halo_exchange_vertex_field=None,
                         min_dv_edge: Optional[float] = None,
                         halo_overlap=None,
                         raster=None, use_pallas: Optional[bool] = None,
                         panel_n: Optional[int] = None, panel_mesh=None):
    """Build the dynamics-step function.

    The subcycle loop of standard EVP goes through a kernel wrapper: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors; a
    solver variant runs `variant_subcycles`.  See `velocity_solve_steps`
    for the routes and for min_dv_edge, raster, use_pallas, panel_n and
    panel_mesh.
    halo_exchange_vertex: optional (u, v) -> (u, v), the vertex-velocity
    halo refresh of one block of a partitioned mesh, run before the loop
    and after every subcycle; with it the loop of standard EVP is one
    `evp_subcycle_step` per subcycle (K6).
    halo_exchange_cell_field / halo_exchange_vertex_field: optional
    f -> f refreshers of the solveStress (cell) and solveVelocity (vertex)
    masks, whose stencils reach one ring beyond the halo (the reference's
    exchange groups, velocity_solver.F:257-345).  An exchange may refresh
    in place and return its argument, or return new tensors.
    halo_overlap: optional (SubcycleOverlap, exchange_from_buf, n_owned),
    the interior/boundary overlap of the JAX package: each subcycle of
    standard EVP computes the export vertices first (`subcycle_exports`),
    then K6 runs, exchange_from_buf(buf [nE, 2]) -> [nHalo, 2] gives the
    halo's new (u, v), and the owned export vertices take the subset
    values; a configuration it cannot split raises ValueError
    (`check_overlap`).
    dyn: optional; if given, returns a convenience wrapper with dyn bound.

    Returns step(dyn, state, forcing, ice_area_cat, ice_volume_cat,
                 snow_volume_cat, pressure_in=None) -> (state, diags).
    """
    exchanges = {"vertex_uv": halo_exchange_vertex,
                 "cell_field": halo_exchange_cell_field,
                 "vertex_field": halo_exchange_vertex_field}
    overlap = None
    if halo_overlap is not None:
        check_overlap(cfg)
        overlap, exchange_from_buf, n_owned = halo_overlap

        def overlapped(loop, exports):
            evp_subcycle_step(loop)
            halo_uv = exchange_from_buf(exports)
            for j, t in enumerate((loop.u, loop.v)):
                t[:n_owned].index_copy_(0, overlap.export_idx, exports[:, j])
                t[n_owned:].copy_(halo_uv[:, j])

        exchanges["evp_overlap"] = overlapped
    solve = velocity_solve_steps(
        cfg, halo=any(f is not None for f in exchanges.values()),
        min_dv_edge=min_dv_edge, raster=raster, use_pallas=use_pallas,
        panel_n=panel_n, panel_mesh=panel_mesh, overlap=overlap)

    def step(dyn, state, forcing, ice_area_cat, ice_volume_cat,
             snow_volume_cat, pressure_in=None):
        return drive(solve(dyn, state, forcing, ice_area_cat,
                           ice_volume_cat, snow_volume_cat, pressure_in),
                     exchanges)

    if dyn is not None:
        return functools.partial(step, dyn)
    return step  # call as step(dyn, state, forcing, area, vol, snow)


def velocity_solve_steps(cfg: Config, *, halo: bool = False,
                         min_dv_edge: Optional[float] = None, raster=None,
                         use_pallas: Optional[bool] = None,
                         panel_n: Optional[int] = None, panel_mesh=None,
                         overlap: Optional[SubcycleOverlap] = None):
    """The velocity solve as a generator function (`utils/lockstep.py`).

    Returns solve(dyn, state, forcing, ice_area_cat, ice_volume_cat,
    snow_volume_cat, pressure_in=None): a generator that yields
    ("cell_field", (solveStress,)), ("vertex_field", (solveVelocity,)) and
    ("vertex_uv", (u, v)) where the JAX package refreshes halos
    (`seaice_tpu/dynamics/evp.py:597-598, 608, 812`) and returns
    (state, diags).

    The subcycle loop of standard EVP goes through a kernel wrapper; a
    solver variant (`is_variant`) runs `variant_subcycles`, which yields
    ("vertex_uv", (u, v)) after every subcycle.
    halo: the solve runs on one block of a partitioned mesh: the loop of
    standard EVP is `evp_subcycle_prepare`, then per subcycle
    ("evp_subcycle", (loop,)), made `evp_subcycle_step` (one call for
    every block of the card) by `drive` / `drive_lockstep`, and a
    ("vertex_uv", (u, v)) exchange, then `evp_subcycle_finish` (K6).  The
    panel and raster routes take no halo: with either, ValueError.
    min_dv_edge: the global minimum edge length, from which revised EVP
    takes its numerical inertia brlx (reference
    constitutive_relation.F:133-162); revised EVP without it raises
    ValueError.
    raster: optional mesh.structured.RasterQuad layout; the loop of
    standard EVP is then `evp_raster_loop` (planar raster quad mesh,
    cell-constant basis, no metric terms; the caller asserts the basis,
    as `SeaIceModel` does), a variant's takes the raster shifts.
    panel_n: panel size N of a panel-reordered icosahedral mesh whose
    `dyn.panel` tensors exist; the loop of standard EVP is then
    `evp_panel_loop` when panel_mesh (the mesh object carrying
    `panel_layout`) is given and `use_fused_panel_loop` is not False,
    else one `panel_cell_step` per subcycle with the vertex side in
    torch; a variant's takes the panel shifts.
    use_pallas: False asks for a plain loop of standard EVP and raises;
    None and True mean the kernel routes above.
    overlap: the block's SubcycleOverlap (with halo): each subcycle of K6
    is then one stop ("evp_overlap", (loop, exports)), exports [nE, 2]
    the export vertices' new (u, v) from `subcycle_exports`; whoever
    drives the generator runs K6, the exchange of the exports, and writes
    the export vertices and the halo of loop.u, loop.v.
    """
    if overlap is not None:
        check_overlap(cfg)
        if not halo:
            raise ValueError("overlap needs the halo exchange (halo=True)")
    if halo and (panel_n is not None or raster is not None):
        raise ValueError(
            "a halo exchange needs the any-connectivity loop: the panel "
            "and raster loops run on a whole, unpartitioned mesh")
    v_cfg = cfg.velocity
    dt_e = cfg.elastic_timestep
    damping_t = cfg.evp_damping_timescale
    metric = v_cfg.include_metric_terms
    n_sub = v_cfg.elastic_subcycle_number
    if (v_cfg.strain_scheme == StrainScheme.WEAK) != \
            (v_cfg.stress_divergence_scheme == StressDivergenceScheme.WEAK):
        raise ValueError(
            "mixed weak/variational strain and stress-divergence schemes "
            "are not supported; choose one scheme for both")
    variant = is_variant(cfg)
    brlx = revised_evp_inertia(cfg, min_dv_edge)
    # the options that ask for a plain loop of standard EVP
    if not variant and use_pallas is False:
        raise NotImplementedError(
            "use_pallas=False: every subcycle loop of standard EVP is a "
            "kernel wrapper that takes its CUDA kernel for CUDA tensors "
            "and its plain version for CPU tensors; there is no option "
            "that runs a plain version on the card")
    if not variant and v_cfg.use_fused_unstructured is False:
        raise NotImplementedError(
            "use_fused_unstructured=False: the any-connectivity subcycle "
            "loop is `evp_subcycle_loop`, which takes its CUDA kernel for "
            "CUDA tensors and its plain version for CPU tensors; there is "
            "no option that runs the plain version on the card")

    quadratic = v_cfg.ocean_stress_type == OceanStressType.QUADRATIC
    raster_loop = None
    panel_route = None           # "loop" or "cell"
    variant_route = None         # the operators of a variant's loop
    if variant:
        if _uses_weak(cfg) or v_cfg.average_variational_strains:
            variant_route = "gather"
        elif panel_n is not None:
            variant_route = "panel"
        elif raster is not None and not metric:
            variant_route = "raster"     # the raster shifts are planar
        else:
            variant_route = "transposed"
    elif panel_n is not None:
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
        with span("velocity.prepare"):
            mass = aggregate_mass(ice_area_cat, ice_volume_cat,
                                  snow_volume_cat)
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
        with span("velocity.prepare"):
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

        with span("velocity.prepare"):
            # ice strength (reference :1341-1508)
            if pressure_in is None:
                pressure = _ice_strength_hibler(mass, solve_stress)
            else:
                pressure = torch.where(solve_stress > 0, pressure_in,
                                       torch.zeros_like(pressure_in))

            # air stress (reference :1522-1651)
            air_u, air_v = _air_stress(forcing, mass, dyn,
                                       v_cfg.use_air_stress)

            # coriolis coefficient (reference :1742-1788)
            mass_f = mass_vertex * mesh.f_vertex

            # ocean stress rotation (reference :1802-1883)
            sgn_f = torch.sign(mesh.f_vertex)
            sgn_f = torch.where(sgn_f == 0, torch.ones_like(sgn_f), sgn_f)
            if v_cfg.use_ocean_stress:
                ocean_u = torch.where(
                    sv,
                    uo_v * c.COS_OCEAN_TURNING_ANGLE -
                    vo_v * c.SIN_OCEAN_TURNING_ANGLE * sgn_f, zero_v)
                ocean_v = torch.where(
                    sv,
                    uo_v * c.SIN_OCEAN_TURNING_ANGLE * sgn_f +
                    vo_v * c.COS_OCEAN_TURNING_ANGLE, zero_v)
            else:
                ocean_u = ocean_v = zero_v

            # surface tilt (reference :1897-2213)
            if not v_cfg.use_surface_tilt:
                tilt_u = zero_v
                tilt_v = zero_v
            elif v_cfg.geostrophic_surface_tilt:
                tilt_u = torch.where(
                    sv, -mesh.f_vertex * mass_vertex * vo_v, zero_v)
                tilt_v = torch.where(
                    sv, mesh.f_vertex * mass_vertex * uo_v, zero_v)
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
        if (panel_route is not None or variant_route == "panel") and \
                dyn.panel is None:
            raise ValueError("panel_n given but the dynamics tensors carry "
                             "no panel tensors (mesh not panel-reordered)")
        if variant:
            # a solver variant: plain torch, the halo refreshed after
            # every subcycle
            u_init, v_init = u, v

            def momentum(u, v, div_u, div_v):
                """The config's ocean drag, then the standard or the
                revised-EVP point solve."""
                oc = ocean_stress_coefficient(
                    v_cfg.use_ocean_stress, quadratic, u, v, uo_v, vo_v,
                    area_vertex, solve_velocity)
                if v_cfg.constitutive_relation == \
                        ConstitutiveRelation.EVP_REVISED:
                    return solve_velocity_revised_evp(
                        u, v, u_init, v_init, mass_vertex, mass_f, div_u,
                        div_v, air_u, air_v, tilt_u, tilt_v, ocean_u,
                        ocean_v, oc, solve_velocity, brlx,
                        cfg.dynamics_timestep)
                return solve_velocity_evp(
                    u, v, mass_vertex, mass_f, div_u, div_v, air_u, air_v,
                    tilt_u, tilt_v, ocean_u, ocean_v, oc, solve_velocity,
                    dt_e)

            u, v, t11, t22, t12 = yield from variant_subcycles(
                cfg, variant_route, dyn, momentum, u, v, *sT, pressure,
                solve_stress, solve_velocity, panel_n=panel_n,
                raster=raster)
        elif halo:
            # a block of a partitioned mesh: one subcycle at a time, the
            # vertex halo refreshed between subcycles (in place); the
            # copies, checks and scratch once per solve.  The subcycle of
            # every block of the card is one kernel call
            # (`utils/lockstep.py`, "evp_subcycle")
            with span("velocity.loop"):
                loop = evp_subcycle_prepare(
                    dyn.fast, u, v, *sT, pressure, solve_stress, uo_v, vo_v,
                    mass_vertex, mass_f, air_u + tilt_u, air_v + tilt_v,
                    ocean_u, ocean_v, solve_velocity, area_vertex,
                    include_metric=metric, dt_elastic=dt_e,
                    damping_timescale=damping_t)
            if overlap is not None:
                with span("velocity.loop"):
                    exports = subcycle_exports(
                        overlap, dyn.fast, pressure, solve_stress,
                        (uo_v, vo_v, mass_vertex, mass_f, air_u, air_v,
                         tilt_u, tilt_v, ocean_u, ocean_v, solve_velocity,
                         area_vertex, dyn.fast.denominator), dt_e, damping_t)
                for _ in range(n_sub):
                    yield "evp_overlap", (loop, exports(
                        loop.u, loop.v, loop.t11, loop.t22, loop.t12))
            else:
                for _ in range(n_sub):
                    yield "evp_subcycle", (loop,)
                    yield "vertex_uv", (loop.u, loop.v)
            with span("velocity.loop"):
                u, v, t11, t22, t12 = evp_subcycle_finish(loop)
        else:
            with span("velocity.loop"):
                if panel_route == "loop":
                    # ONE call runs all subcycles on the panel lattice
                    u, v, t11, t22, t12 = evp_panel_loop(
                        dyn.panel, u, v, *sT, pressure, solve_stress, uo_v,
                        vo_v, mass_vertex, mass_f, air_u + tilt_u,
                        air_v + tilt_v, ocean_u, ocean_v, solve_velocity,
                        area_vertex, include_metric=metric, **kw)
                elif panel_route == "cell":
                    # one kernel launch per subcycle for the cell side;
                    # ghosts, dual sum, the 12 exception cells and the
                    # momentum solve in torch; the loop state is
                    # slot-indexed and padded
                    pt = dyn.panel
                    exc_cols = pt.exc_pad_cols
                    p_pad = vpn.cells_to_padded(pt, pressure)
                    ss_pad = vpn.cells_to_padded(pt, solve_stress)
                    p_exc = p_pad[exc_cols][None, :]
                    ss_exc = (ss_pad[exc_cols] > 0)[None, :]
                    ss_kernel = ss_pad.clone()
                    ss_kernel[exc_cols] = 0   # the kernel leaves those
                    # the kernel's buffers and arguments, once per solve
                    cell_loop = panel_cell_prepare(
                        pt, p_pad, ss_kernel,
                        *(vpn.stress_ring_to_slot(pt, s) for s in sT),
                        dt_elastic=dt_e, damping_timescale=damping_t,
                        include_metric=metric)
                    rhs_u0, rhs_v0 = air_u + tilt_u, air_v + tilt_v
                    for _ in range(n_sub):
                        vpn.velocity_planes(pt, panel_n, u, v, metric,
                                            out=cell_loop.planes)
                        panel_cell_step(cell_loop)
                        # 12-cell exception path: ring-indexed strain + stress
                        # update, written into the exception columns
                        x11, x22, x12 = vpn.exception_strain(pt, u, v, metric)
                        o11, o22, o12 = (t[:, exc_cols]
                                         for t in cell_loop.previous)
                        e11, e22, e12, _ = constitutive.evp_stress_update(
                            o11, o22, o12, x11, x22, x12, p_exc, dt_e,
                            damping_t)
                        t11, t22, t12 = cell_loop.current
                        t11[:, exc_cols] = torch.where(ss_exc, e11, o11)
                        t22[:, exc_cols] = torch.where(ss_exc, e22, o22)
                        t12[:, exc_cols] = torch.where(ss_exc, e12, o12)
                        div_u, div_v = vpn.divergence_finish(
                            pt, panel_n, cell_loop.partials, t11, t22, t12,
                            solve_velocity, metric)
                        u, v = momentum_update(
                            u, v, div_u, div_v, uo_v, vo_v, mass_vertex,
                            mass_f, rhs_u0, rhs_v0, ocean_u, ocean_v,
                            solve_velocity, area_vertex, dt_e)
                    t11, t22, t12 = (vpn.stress_slot_to_ring(pt, t)
                                     for t in cell_loop.current)
                elif raster_loop is not None:
                    # ONE call runs all subcycles on the raster with the four
                    # cell-constant basis tables
                    u, v, t11, t22, t12 = raster_loop(
                        *basis_tables(dyn.fast), u, v, *sT, pressure,
                        solve_stress, uo_v, vo_v, mass_vertex, mass_f,
                        air_u, air_v, tilt_u, tilt_v, ocean_u, ocean_v,
                        solve_velocity, area_vertex, dyn.fast.denominator)
                else:
                    # ONE call runs all subcycles for any connectivity
                    u, v, t11, t22, t12 = evp_subcycle_loop(
                        dyn.fast, u, v, *sT, pressure, solve_stress, uo_v,
                        vo_v, mass_vertex, mass_f, air_u + tilt_u,
                        air_v + tilt_v, ocean_u, ocean_v, solve_velocity,
                        area_vertex, include_metric=metric, **kw)
        with span("velocity.finish"):
            s11, s22, s12 = (t11.t().contiguous(), t22.t().contiguous(),
                             t12.t().contiguous())

            # --- post-subcycle (reference :3360-3700) ---
            if variant_route == "gather":
                e11, e22, e12 = gather_strain(cfg, dyn, u, v, solve_stress)
            elif panel_route is not None or variant_route == "panel":
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
            ocean_coeff = ocean_stress_coefficient(
                v_cfg.use_ocean_stress, quadratic, u, v, uo_v, vo_v,
                area_vertex, solve_velocity)
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


# -- solver variants ----------------------------------------------------------

def revised_evp_inertia(cfg: Config, min_dv_edge: Optional[float]) -> float:
    """Revised EVP's numerical inertia coefficient brlx (Bouillon et al.
    2013; reference constitutive_relation.F:154-162), from the global
    minimum edge length; 0 for every other relation."""
    if cfg.velocity.constitutive_relation != \
            ConstitutiveRelation.EVP_REVISED:
        return 0.0
    if min_dv_edge is None:
        raise ValueError("revised EVP requires min_dv_edge")
    gamma = 0.25 * 1.0e11 * cfg.dynamics_timestep
    return (2.0 * c.REVISED_EVP_DAMPING_RATIO_DENOM *
            c.REVISED_EVP_DAMPING_RATIO * gamma) / min_dv_edge ** 2


def relax_stress(cfg: Config, s11, s22, s12, e11, e22, e12, pressure):
    """The new stresses of the config's constitutive relation
    (reference velocity_solver.F:2606-2863): standard EVP, revised EVP,
    linear, or none (the stresses kept)."""
    relation = cfg.velocity.constitutive_relation
    if relation == ConstitutiveRelation.EVP:
        return constitutive.evp_stress_update(
            s11, s22, s12, e11, e22, e12, pressure, cfg.elastic_timestep,
            cfg.evp_damping_timescale)[:3]
    if relation == ConstitutiveRelation.EVP_REVISED:
        return constitutive.evp_stress_update_revised(
            s11, s22, s12, e11, e22, e12, pressure)[:3]
    if relation == ConstitutiveRelation.LINEAR:
        return constitutive.linear_stress(e11, e22, e12)
    return s11, s22, s12


def gather_strain(cfg: Config, dyn: DynamicsTensors, u, v, solve_stress):
    """Strain by the generic gather operators, [nCells, maxEdges]: the
    weak scheme's cell-mean strain in corner slot 0's place
    ([nCells, 1]), or the variational corner strain (not averaged)."""
    if dyn.weak is not None:
        e = strain_tensor_weak(dyn.weak, dyn.mesh, u, v, dyn.area_cell,
                               solve_stress)
        return tuple(x[:, None] for x in e)
    return variational.strain_tensor(u, v, dyn.tan_lat_vertex, dyn.mesh,
                                     dyn.basis_gradient_u,
                                     dyn.basis_gradient_v)


def variant_subcycles(cfg: Config, route: str, dyn: DynamicsTensors,
                      momentum, u, v, t11, t22, t12, pressure, solve_stress,
                      solve_velocity, panel_n=None, raster=None):
    """The elastic subcycles of a solver variant in plain torch, on the
    tensors' device (the JAX package's XLA loop, `evp.py:842-975`): per
    subcycle strain -> the config's relation -> stress divergence ->
    momentum(u, v, div_u, div_v) (the config's ocean drag and point
    solve), then a generator stop ("vertex_uv", (u, v)) for the halo
    refresh of a partitioned mesh.

    route: "gather" (the weak scheme, or strain averaging: the generic
    gather operators, stresses [nCells, maxEdges], the weak scheme's in
    corner slot 0), "panel" (the panel-shift operators on the padded
    slot layout), "raster" (the raster shifts) or "transposed" (the
    transposed gathers).  The corner stresses t** come and go in the
    transposed [maxEdges, nCells] layout.  Returns (u, v, t11, t22, t12).
    """
    v_cfg = cfg.velocity
    n_sub = v_cfg.elastic_subcycle_number
    metric = v_cfg.include_metric_terms
    mesh = dyn.mesh
    sv = solve_velocity
    if route == "gather":
        s11, s22, s12 = t11.t(), t22.t(), t12.t()
        ss = (solve_stress > 0)[:, None]
        p = pressure[:, None]
        for _ in range(n_sub):
            e11, e22, e12 = gather_strain(cfg, dyn, u, v, solve_stress)
            if v_cfg.average_variational_strains and dyn.weak is None:
                e11, e22, e12 = variational.average_strains(e11, e22, e12,
                                                            mesh)
            n11, n22, n12 = relax_stress(cfg, s11, s22, s12, e11, e22, e12,
                                         p)
            s11 = torch.where(ss, n11, s11)
            s22 = torch.where(ss, n22, s22)
            s12 = torch.where(ss, n12, s12)
            if dyn.weak is not None:
                div_u, div_v = stress_divergence_weak(
                    dyn.weak, mesh, s11[:, 0], s22[:, 0], s12[:, 0],
                    dyn.area_triangle, sv)
            else:
                div_u, div_v = variational.stress_divergence(
                    s11, s22, s12, dyn.tan_lat_vertex, mesh,
                    dyn.basis_integrals_u, dyn.basis_integrals_v,
                    dyn.basis_integrals_metric, dyn.variational_denominator,
                    sv)
            u, v = momentum(u, v, div_u, div_v)
            yield "vertex_uv", (u, v)
        return u, v, s11.t(), s22.t(), s12.t()

    ft, pt = dyn.fast, dyn.panel
    if route == "panel":
        # cell fields live in the padded layout, the loop state is
        # slot-indexed
        ss_T = vpn.cells_to_padded(pt, solve_stress)[None, :]
        p_T = vpn.cells_to_padded(pt, pressure)[None, :]
        t11, t22, t12 = (vpn.stress_ring_to_slot(pt, t)
                         for t in (t11, t22, t12))
    else:
        ss_T = solve_stress[None, :]
        p_T = pressure[None, :]
    ss_T = ss_T > 0
    for _ in range(n_sub):
        if route == "panel":
            e11, e22, e12 = vpn.strain_tensor_P(pt, panel_n, u, v, metric)
        elif route == "raster":
            e11, e22, e12 = vf.strain_tensor_S(ft, raster, u, v)
        else:
            e11, e22, e12 = vf.strain_tensor_T(ft, u, v, metric)
        n11, n22, n12 = relax_stress(cfg, t11, t22, t12, e11, e22, e12,
                                     p_T)
        t11 = torch.where(ss_T, n11, t11)
        t22 = torch.where(ss_T, n22, t22)
        t12 = torch.where(ss_T, n12, t12)
        if route == "panel":
            div_u, div_v = vpn.stress_divergence_P(pt, panel_n, t11, t22,
                                                   t12, sv, metric)
        elif route == "raster":
            div_u, div_v = vf.stress_divergence_S(ft, raster, t11, t22,
                                                  t12, sv)
        else:
            div_u, div_v = vf.stress_divergence_T(ft, t11, t22, t12, sv,
                                                  metric)
        u, v = momentum(u, v, div_u, div_v)
        yield "vertex_uv", (u, v)
    if route == "panel":
        t11, t22, t12 = (vpn.stress_slot_to_ring(pt, t)
                         for t in (t11, t22, t12))
    return u, v, t11, t22, t12
