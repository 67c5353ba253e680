"""Variational (FEM) strain and stress-divergence operators.

Formulation of the reference's hot kernels
(`mpas_seaice_velocity_solver_variational.F:575-1184`) in the natural
[nCells, maxEdges] layout. The Fortran per-vertex gather loops become
two-stage dense ops:

  strain:   gather vertex velocities per cell, then a per-cell
            [maxEdges x maxEdges] contraction with the basis-gradient
            tensor.
  stressDiv: per-cell contraction of corner stresses with the
            basis-integral tensors, then a vertexDegree-wide gather:
            each cell's contraction is computed once and reused by all of
            its corners (the Fortran loop recomputes it per vertex).
"""

from __future__ import annotations

import torch

from ..mesh.core import MeshTensors


def _contract(a, t):
    """out[c, j] = sum_s a[c, s] * t[c, s, j], as multiply + sum: no
    matrix-product library path, so no reduced-precision (TF32) mode can
    reach it."""
    return (a[:, :, None] * t).sum(dim=1)


def strain_tensor(u_vertex, v_vertex, tan_lat_vertex, mesh: MeshTensors,
                  basis_gradient_u, basis_gradient_v):
    """Strain-rate tensor at every cell corner.

    Returns (e11, e22, e12), each [nCells, maxEdges]
    (reference seaice_strain_tensor_variational, variational.F:575-670).
    """
    voc = mesh.vertices_on_cell
    mask = mesh.vertices_on_cell_mask
    u_c = u_vertex[voc] * mask   # [nCells, maxEdges]
    v_c = v_vertex[voc] * mask

    # e[c, g] = sum_b vel[c, b] * basisGradient[c, b, g]
    e11 = _contract(u_c, basis_gradient_u)
    e22 = _contract(v_c, basis_gradient_v)
    e12 = 0.5 * (_contract(u_c, basis_gradient_v) +
                 _contract(v_c, basis_gradient_u))

    # spherical metric terms at the corner's own vertex
    # (reference variational.F:657-662)
    tl = tan_lat_vertex[voc] * mask
    e11 = e11 - v_c * tl
    e12 = e12 + 0.5 * u_c * tl
    return e11, e22, e12


def average_strains(e11, e22, e12, mesh: MeshTensors):
    """Replace corner strains with the area-weighted average over the
    corners meeting at each vertex
    (reference seaice_average_strains_on_vertex, variational.F:684-763)."""
    cov = mesh.cells_on_vertex
    cva = mesh.cell_vertices_at_vertex
    w = mesh.cells_on_vertex_mask * mesh.area_cell[cov]
    denom = w.sum(dim=1).clamp(min=1e-300)

    def avg(e):
        g = e[cov, cva]                      # [nVertices, vertexDegree]
        vert_avg = (g * w).sum(dim=1) / denom
        # scatter back: corner (c, k) takes the average at its vertex
        return vert_avg[mesh.vertices_on_cell] * mesh.vertices_on_cell_mask

    return avg(e11), avg(e22), avg(e12)


def stress_divergence(s11, s22, s12, tan_lat_vertex, mesh: MeshTensors,
                      basis_integrals_u, basis_integrals_v,
                      basis_integrals_metric, variational_denominator,
                      solve_velocity):
    """Divergence of internal stress at vertices.

    Returns (div_u, div_v), each [nVertices]
    (reference seaice_stress_divergence_variational,
    variational.F:1064-1184).
    """
    # per-cell contractions over the stress-corner axis s:
    #   P*[c, j], reused by every vertex of cell c
    pu = (_contract(s11, basis_integrals_u) +
          _contract(s12, basis_integrals_v))
    pv = (_contract(s22, basis_integrals_v) +
          _contract(s12, basis_integrals_u))
    mu = _contract(s12, basis_integrals_metric)
    mv = _contract(s11, basis_integrals_metric)

    cov = mesh.cells_on_vertex
    cva = mesh.cell_vertices_at_vertex
    m = mesh.cells_on_vertex_mask
    tl = tan_lat_vertex[:, None]

    div_u = -((pu[cov, cva] + mu[cov, cva] * tl) * m).sum(dim=1)
    div_v = ((-pv[cov, cva] + mv[cov, cva] * tl) * m).sum(dim=1)

    denom = variational_denominator
    zero = torch.zeros_like(div_u)
    solve = solve_velocity != 0
    div_u = torch.where(solve, div_u / denom, zero)
    div_v = torch.where(solve, div_v / denom, zero)
    return div_u, div_v


def final_divergence_shear(e11, e22, e12, mesh: MeshTensors, solve_stress,
                           eccentricity_sq: float):
    """Cell-average divergence / shear / ridging strain diagnostics
    (reference seaice_final_divergence_shear_variational,
    variational.F:1198-1330). Returns (divergence, shear, ridge_convergence,
    ridge_shear), each [nCells]; divergence and shear in the CICE
    comparison units (% / day)."""
    mask = mesh.vertices_on_cell_mask
    n = mask.sum(dim=1).clamp(min=1.0)

    div_c = e11 + e22
    ten_c = e11 - e22
    shr_c = 2.0 * e12
    delta_c = torch.sqrt(div_c ** 2 + (ten_c ** 2 + shr_c ** 2)
                         / eccentricity_sq)

    div_sum = (div_c * mask).sum(dim=1)
    ten_sum = (ten_c * mask).sum(dim=1)
    shr_sum = (shr_c * mask).sum(dim=1)
    delta_avg = (delta_c * mask).sum(dim=1) / n

    solve = solve_stress != 0
    zero = torch.zeros_like(div_sum)
    divergence = torch.where(solve, div_sum / n, zero)
    shear = torch.where(solve,
                        torch.sqrt(ten_sum ** 2 + shr_sum ** 2) / n, zero)

    ridge_convergence = torch.where(solve, -divergence.clamp(max=0.0), zero)
    ridge_shear = torch.where(
        solve, 0.5 * (delta_avg - divergence.abs()), zero)

    to_cice_units = 100.0 * 86400.0
    return (divergence * to_cice_units, shear * to_cice_units,
            ridge_convergence, ridge_shear)
