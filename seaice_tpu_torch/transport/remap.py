"""Incremental-remapping transport: the per-step pipeline.

Re-design of the reference IR routine (MPAS-Seaice
`src/shared/mpas_seaice_advection_incremental_remap.F:2338-2667` and the
stage kernels it calls). The Fortran per-edge branching of
`find_departure_triangles` (:5365-6269) becomes a *fixed-slot* masked dense
computation: every potential departure triangle has a static slot, invalid
slots carry zero area, and all case analysis is `torch.where` selects, with
no data-dependent control flow.

Slot layout (N_TRI_SLOTS = 10, see geometry.py):
  s = 4*v + 2*side + {0,1} for v in {V1,V2}, side in {left,right}:
      slot a = side triangle (V, D, IP), slot b = quad-mesh split extra
      triangle (V, IP0, IP) when the D1-D2 segment also crosses the
      colinear edge E5/E6;
  s = 8, 9: the two central triangles in C1/C2.

Algorithm stages per dynamics substep (reference :2338-2667):
  masks -> reconstruct (gradient, limiter, barycenters) ->
  departure points (:5255) -> departure triangles (:5365) ->
  quadrature points (:6546) -> flux integration (:6667) ->
  mass/tracer-product update (:7125) -> zap small mass (:8764).

The flux integration is the stage with a CUDA kernel
(`cuda_flux.integrate_fluxes_cuda`); `integrate_fluxes` here is its plain
PyTorch version.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..diagnostics import span
from .geometry import RemapTensors, N_TRI_SLOTS
from .tracers import TracerTree

EPS11 = 1.0e-11
SMALL_MASS = 1.0e-22    # zap threshold (reference :8786)
BIG = 1.0e30

# moment column indices in RemapTensors.geom_moments
_M = {name: i for i, name in enumerate(
    ["x", "y", "xx", "xy", "yy",
     "xxx", "xxy", "xyy", "yyy",
     "xxxx", "xxxy", "xxyy", "xyyy", "yyyy"])}


def _mom(rt: RemapTensors, name: str):
    return rt.geom_moments[:, _M[name]]


# -- geometry primitives (vectorized over edges) ------------------------------

def _segment_intersection(p1x, p1y, p2x, p2y, p3x, p3y, p4x, p4y):
    """Strict segment-segment intersection (reference
    find_line_intersection, :8934-9016): True only for interior crossings
    (t1, t2 strictly in (0,1)); shared endpoints do not intersect."""
    rx, ry = p2x - p1x, p2y - p1y
    sx, sy = p4x - p3x, p4y - p3y
    cross = rx * sy - ry * sx
    cross_min = EPS11 * torch.sqrt(
        (rx * rx + ry * ry) * (sx * sx + sy * sy))
    nonparallel = cross.abs() > cross_min
    safe = torch.where(nonparallel, cross, 1.0)
    t1 = (sy * (p3x - p1x) - sx * (p3y - p1y)) / safe
    t2 = (ry * (p3x - p1x) - rx * (p3y - p1y)) / safe
    hit = nonparallel & (t1 > 0.0) & (t1 < 1.0) & (t2 > 0.0) & (t2 < 1.0)
    ix = p1x + t1 * rx
    iy = p1y + t1 * ry
    return hit, torch.where(nonparallel, ix, BIG), \
        torch.where(nonparallel, iy, BIG)


def _in_left_half_plane(px, py, ax, ay, bx, by):
    """True iff point p is in the left half-plane of the line a->b
    (reference point_in_half_plane, :9201-9234; >= 0 counts as left)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax) >= 0.0


def _tri_area(x, y):
    """abs area of triangles with vertices x,y [..., 3]."""
    return torch.abs(0.5 * (
        (x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0]) -
        (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0])))


# -- stage 1: departure points (reference :5255-5350) -------------------------

def departure_points(u_vertex, v_vertex, dt):
    """Backward trajectory -u*dt in vertex-local coordinates.
    Returns (dpx, dpy)."""
    dpx = -u_vertex * dt
    dpy = -v_vertex * dt
    return dpx, dpy


def cfl_violations(dpx, dpy, rt: RemapTensors):
    """Count of vertices whose trajectory exceeds the shortest adjacent
    edge (non-fatal warning in the reference, :5330-5350)."""
    traj = torch.sqrt(dpx ** 2 + dpy ** 2)
    return torch.sum(traj > rt.min_length_edges_on_vertex)


# -- stage 2: departure triangles (reference :5365-6269) ----------------------

def find_departure_triangles(rt: RemapTensors, dpx, dpy, vertex_degree: int):
    """Fixed-slot departure-triangle decomposition per edge.

    Returns dict with:
      tri_x, tri_y : [nEdges, N_TRI_SLOTS, 3] vertices in edge coordinates
      cell_slot    : [nEdges, N_TRI_SLOTS] int index into cellsOnEdgeRemap
      area         : [nEdges, N_TRI_SLOTS] signed area (+: C1 -> C2 flux)
      mask_edge    : [nEdges]
    Triangle vertex-on-edge assignment per slot is static: _VOE_IDX.
    """
    ne = rt.x_vertex_on_edge.shape[0]
    dtype, dev = dpx.dtype, dpx.device
    voe = rt.vertices_on_edge                         # [nEdges, 2]

    v1x, v1y = rt.x_vertex_on_edge[:, 0], rt.y_vertex_on_edge[:, 0]
    v2x, v2y = rt.x_vertex_on_edge[:, 1], rt.y_vertex_on_edge[:, 1]
    vx = (v1x, v2x)
    vy = (v1y, v2y)

    # departure points in edge coordinates (reference :5633-5649); the
    # two are replaced by intersections as the side passes go on
    dpx_e = [v1x + dpx[voe[:, 0]], v2x + dpx[voe[:, 1]]]
    dpy_e = [v1y + dpy[voe[:, 0]], v2y + dpy[voe[:, 1]]]

    # maskEdge: remap edge with a nonzero departure vector (:5597-5607)
    dlen = (dpx[voe] ** 2 + dpy[voe] ** 2).sum(dim=1)
    mask_edge = (rt.remap_edge > 0) & (dlen > 0.0)

    S = N_TRI_SLOTS
    # filled slot by slot, in place
    tri_x = torch.zeros((ne, S, 3), dtype=dtype, device=dev)
    tri_y = torch.zeros((ne, S, 3), dtype=dtype, device=dev)
    cell_slot = torch.zeros((ne, S), dtype=torch.int64, device=dev)
    sign = torch.zeros((ne, S), dtype=dtype, device=dev)
    valid = torch.zeros((ne, S), dtype=torch.bool, device=dev)

    def set_tri(s, ok, ax, ay, bx, by, cx, cy, cslot, sgn):
        t_x = torch.stack([ax, bx, cx], dim=-1)
        t_y = torch.stack([ay, by, cy], dim=-1)
        tri_x[:, s, :] = torch.where(ok[:, None], t_x, 0.0)
        tri_y[:, s, :] = torch.where(ok[:, None], t_y, 0.0)
        if isinstance(cslot, int):
            cell_slot[:, s] = ok.to(torch.int64) * cslot
        else:
            cell_slot[:, s] = torch.where(ok, cslot, 0)
        sign[:, s] = ok.to(dtype) * sgn
        valid[:, s] = ok

    # -- side passes (reference :5711-5964). Sequential over the 4 side
    # edges because an intersection replaces the departure point for the
    # remaining passes (:5960-5963).
    for v in (0, 1):
        for side in (0, 1):
            # edges_on_edge_remap slots (0-based): 0=E1, 1=E2, 2=E3, 3=E4.
            # V1 pairs with E1 (left) / E3 (right); V2 with E2 / E4.
            er = {(0, 0): 0, (0, 1): 2, (1, 0): 1, (1, 1): 3}[(v, side)]
            vr = er + 2                      # far vertex slot V3..V6

            exists = rt.edges_on_edge_remap_mask[:, er] > 0
            fvx = rt.x_vertex_on_edge[:, vr]
            fvy = rt.y_vertex_on_edge[:, vr]
            hit, ipx, ipy = _segment_intersection(
                dpx_e[0], dpy_e[0], dpx_e[1], dpy_e[1],
                vx[v], vy[v], fvx, fvy)
            hit = hit & exists & mask_edge
            sgn = 1.0 if side == 0 else -1.0
            s_a = 4 * v + 2 * side
            s_b = s_a + 1

            if vertex_degree == 4:
                # possible split by the colinear edge E5/E6 (:5810-5958)
                er56 = 4 + v
                exists56 = rt.edges_on_edge_remap_mask[:, er56] > 0
                f56x = rt.x_vertex_on_edge[:, 6 + v]   # V7 or V8
                f56y = rt.y_vertex_on_edge[:, 6 + v]
                hit0, ip0x, ip0y = _segment_intersection(
                    dpx_e[0], dpy_e[0], dpx_e[1], dpy_e[1],
                    vx[v], vy[v], f56x, f56y)
                split = hit & hit0 & exists56
                # triangle a: (V, D, IP) normally; (V, D, IP0) when split.
                # source cell: C3/C4 (2+v) on own side; the split or a
                # right-side crossing moves it to C5/C6 (4+v).
                own = 2 + v if side == 0 else 4 + v
                other = 4 + v if side == 0 else 2 + v
                cx = torch.where(split, ip0x, ipx)
                cy = torch.where(split, ip0y, ipy)
                cs = torch.where(split, other, own)
                set_tri(s_a, hit, vx[v], vy[v], dpx_e[v], dpy_e[v],
                        cx, cy, cs, sgn)
                # triangle b: (V, IP0, IP) on the opposite side of E5/E6
                set_tri(s_b, split, vx[v], vy[v], ip0x, ip0y, ipx, ipy,
                        own, sgn)
            else:
                own = 2 + v                  # hex: always C3/C4
                set_tri(s_a, hit, vx[v], vy[v],
                        dpx_e[v], dpy_e[v], ipx, ipy, own, sgn)

            # replace departure point with the intersection (:5960-5963)
            dpx_e[v] = torch.where(hit, ipx, dpx_e[v])
            dpy_e[v] = torch.where(hit, ipy, dpy_e[v])

    # -- central triangles (reference :5976-6157)
    hit_m, ip0x, ip0y = _segment_intersection(
        dpx_e[0], dpy_e[0], dpx_e[1], dpy_e[1],
        v1x, v1y, v2x, v2y)

    # degenerate-quad filter for the no-intersection branch (:6050-6060)
    quad_area = (_tri_area(
        torch.stack([v1x, v2x, dpx_e[1]], -1),
        torch.stack([v1y, v2y, dpy_e[1]], -1)) + _tri_area(
        torch.stack([v1x, dpx_e[1], dpx_e[0]], -1),
        torch.stack([v1y, dpy_e[1], dpy_e[0]], -1)))
    quad_ok = quad_area > 0.0

    for v, s in ((0, 8), (1, 9)):
        in_left = _in_left_half_plane(
            dpx_e[v], dpy_e[v], v1x, v1y, v2x, v2y)
        cs = torch.where(in_left, 0, 1)      # C1 or C2
        sgn = torch.where(in_left, 1.0, -1.0).to(dtype)
        if v == 0:
            # intersect: (V1, D1, IP0); else: (V1, V2, D1)
            ax, ay = v1x, v1y
            bx = torch.where(hit_m, dpx_e[0], v2x)
            by = torch.where(hit_m, dpy_e[0], v2y)
            cx = torch.where(hit_m, ip0x, dpx_e[0])
            cy = torch.where(hit_m, ip0y, dpy_e[0])
        else:
            # intersect: (V2, D2, IP0); else: (V2, D1, D2)
            ax, ay = v2x, v2y
            bx = torch.where(hit_m, dpx_e[1], dpx_e[0])
            by = torch.where(hit_m, dpy_e[1], dpy_e[0])
            cx = torch.where(hit_m, ip0x, dpx_e[1])
            cy = torch.where(hit_m, ip0y, dpy_e[1])
        ok = mask_edge & (hit_m | quad_ok)
        set_tri(s, ok, ax, ay, bx, by, cx, cy, cs, sgn)

    area = _tri_area(tri_x, tri_y) * sign * valid
    return {"tri_x": tri_x, "tri_y": tri_y, "cell_slot": cell_slot,
            "area": area, "valid": valid,
            "mask_edge": mask_edge.to(dtype)}


# vertexOnEdge index (0 or 1) per slot, static by construction
_VOE_IDX = np.array([0, 0, 0, 0, 1, 1, 1, 1, 0, 1], np.int64)


def triangles_to_cell_coords(rt: RemapTensors, tris: dict):
    """Shift triangle vertices from edge to source-cell coordinates and
    compute the 6 quadrature points per triangle (reference
    shift_vertices_of_departure_triangle :6343-6460 planar branch +
    get_triangle_quadrature_points :6546-6640).

    Planar: translation via the shared vertex, robust across periodic
    seams: offset = xLocal(cell, sharedVertex) - xVertexOnEdge(sharedVertex).
    Returns (cell [nE,S], xq, yq [nE,S,6], area [nE,S]).

    The slot choice is data-dependent; the per-slot tables (cell index,
    mask, rotation, shared-vertex coordinates) are static per (edge, k)
    and are looked up with gathers along the K=6 cell-slot axis.
    """
    cell_slot = tris["cell_slot"]                     # [nE, S] int64
    S = cell_slot.shape[1]
    dev = cell_slot.device
    cell = torch.gather(rt.cells_on_edge_remap, 1, cell_slot)
    cmask = torch.gather(rt.cells_on_edge_remap_mask, 1, cell_slot)
    # rotate edge-frame vectors (relative to the shared vertex) into the
    # cell frame, then translate: on planar meshes the rotation is the
    # identity; on the sphere it is the precomputed tangent-frame
    # rotation (replaces reference shift_vertices basis transforms)
    e_idx = torch.arange(cell_slot.shape[0], device=dev)[:, None]
    R = rt.edge_to_cell_rot[e_idx, cell_slot]         # [nE, S, 2, 2]
    voe = torch.as_tensor(_VOE_IDX[:S], device=dev)[None, :]
    xyv = rt.xy_local_on_edge_remap[e_idx, cell_slot, voe]   # [nE, S, 2]
    x0 = xyv[..., 0]
    y0 = xyv[..., 1]
    vx = rt.x_vertex_on_edge[:, voe[0]]               # shared vertex
    vy = rt.y_vertex_on_edge[:, voe[0]]
    dx = tris["tri_x"] - vx[..., None]
    dy = tris["tri_y"] - vy[..., None]
    rx = R[..., 0, 0, None] * dx + R[..., 0, 1, None] * dy
    ry = R[..., 1, 0, None] * dx + R[..., 1, 1, None] * dy
    tx = x0[..., None] + rx
    ty = y0[..., None] + ry
    # quadrature points: barycentric combination of the 3 vertices
    # (written as multiply + sum, not einsum: no matrix-product library
    # path, so no reduced-precision mode can reach it)
    xq = (tx[..., None, :] * rt.qp_coeffs).sum(-1)    # [nE, S, 6]
    yq = (ty[..., None, :] * rt.qp_coeffs).sum(-1)
    area = tris["area"] * cmask
    return cell, xq, yq, area


# -- stage 3: linear reconstruction (reference :3580-5255) --------------------

def _expand(a, extra_dims):
    """Append `extra_dims` singleton axes."""
    return a.reshape(a.shape + (1,) * extra_dims)


def batched_neighbor_gather(arrs, coc):
    """ONE neighbor gather for a list of [nC, ...] arrays (indices are
    shared across the whole tracer tree, so one gather launch moves every
    tracer's data)."""
    flats = [a.reshape(a.shape[0], -1) for a in arrs]
    widths = [f.shape[1] for f in flats]
    g = torch.cat(flats, dim=1)[coc]                 # [nC, K, F]
    out = []
    off = 0
    for a, w in zip(arrs, widths):
        out.append(g[..., off:off + w].reshape(
            (a.shape[0], coc.shape[1]) + a.shape[1:]))
        off += w
    return out


def compute_gradient(rt: RemapTensors, mesh_cells_on_cell,
                     mesh_cells_on_cell_mask, field, field_mask, mask_cell,
                     f_n=None, m_n=None):
    """Least-squares cell-center gradient from edge-normal differences
    (reference compute_gradient_2d/3d, :4204-4630). field: [nCells, ...];
    returns (gx, gy) of the same shape.  f_n/m_n: optional pre-gathered
    neighbor values (batched_neighbor_gather)."""
    extra = field.ndim - 1
    coc = mesh_cells_on_cell                        # [nC, K]
    neigh_ok = mesh_cells_on_cell_mask              # [nC, K]
    if f_n is None:
        f_n = field[coc]                            # [nC, K, ...]
    if m_n is None:
        m_n = field_mask[coc]
    dc = rt.dc_edge_on_cell.clamp(min=EPS11)
    # normal gradient along the C1->C2 edge direction, masked where either
    # side is not physically meaningful
    fm_c = field_mask.unsqueeze(1)                  # [nC, 1, ...]
    ng = (f_n - field.unsqueeze(1)) / _expand(dc, extra) \
        * _expand(neigh_ok, extra) * m_n * fm_c
    # reference sign convention: ng is the gradient component along the
    # C1->C2 normal, matching the least-squares coeffs' normals
    esoc = _expand(rt.edge_sign_on_cell, extra)
    ng = ng * esoc
    gx = (ng * _expand(rt.coeffs_reconstruct[..., 0], extra)).sum(dim=1)
    gy = (ng * _expand(rt.coeffs_reconstruct[..., 1], extra)).sum(dim=1)
    mc = _expand(mask_cell, extra)
    return gx * mc, gy * mc


def limit_gradient(rt: RemapTensors, mesh_cells_on_cell,
                   mesh_cells_on_cell_mask, field, field_mask,
                   xb, yb, gx, gy, mask_cell, f_n=None, m_n=None):
    """Monotone gradient limiter (reference limit_tracer_gradient_2d/3d,
    :4802-5200): scale the gradient so reconstructed values at cell
    corners stay within the neighborhood min/max."""
    extra = field.ndim - 1
    coc = mesh_cells_on_cell
    if f_n is None:
        f_n = field[coc]                            # [nC, K, ...]
    if m_n is None:
        m_n = field_mask[coc]
    m_n = m_n * _expand(mesh_cells_on_cell_mask, extra)
    max_n = torch.where(m_n > 0, f_n, -BIG).amax(dim=1)
    min_n = torch.where(m_n > 0, f_n, BIG).amin(dim=1)
    max_n = torch.maximum(max_n, field) - field
    min_n = torch.minimum(min_n, field) - field

    # deviation at cell corners from the barycenter (valid slots only)
    dx = _expand(rt.x_local, extra) - xb.unsqueeze(1)
    dy = _expand(rt.y_local, extra) - yb.unsqueeze(1)
    k_ok = _expand(rt.edges_on_cell_mask, extra)
    dev = (gx.unsqueeze(1) * dx + gy.unsqueeze(1) * dy) * k_ok
    max_l = dev.amax(dim=1).clamp(min=0.0)
    min_l = dev.amin(dim=1).clamp(max=0.0)

    def factor(local, neigh):
        need = local.abs() > neigh.abs()
        safe = torch.where(need, local, 1.0)
        return torch.where(need, (neigh / safe).clamp(min=0.0), 1.0)

    f = torch.minimum(factor(max_l, max_n), factor(min_l, min_n))
    f = (f - EPS11).clamp(min=0.0)                  # roundoff guard (:4975)
    f = f * _expand(mask_cell, extra)
    return gx * f, gy * f


def _normal(x):
    """Where |x| is a normal number of its dtype.  The reference flushes
    subnormals to zero (XLA on the CPU and the TPU), torch keeps them:
    a mass product below the smallest normal (1.2e-38 in float32) counts
    as zero here as it does there, so no guard below divides by it
    (ROADMAP Queue 3 fault 16).  In float64 nothing real lies below
    2.2e-308, so the float64 answers are unchanged."""
    return x.abs() >= torch.finfo(x.dtype).tiny


def _recip(x):
    """1/x where x is a normal number, else 0."""
    ok = _normal(x)
    return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), 0.0)


def barycenter(rt: RemapTensors, depth: int, chain):
    """Barycenter of mass (depth 1) or mass*tracer (depth 2) distributions,
    or the cell centroid (depth 0); reference
    compute_barycenter_coordinates :4658-4797.

    chain: list of (mean, center, gx, gy) for the ancestor chain root-first
    (length == depth), all [nCells, nCat]-shaped.
    Returns (xb, yb) with the shape of the chain fields (or [nCells] for
    depth 0)."""
    if depth == 0:
        return _mom(rt, "x"), _mom(rt, "y")

    if depth == 1:
        (mean0, c0, cx, cy), = chain
        recip = _recip(mean0)
        ex = lambda n: _expand(_mom(rt, n), mean0.ndim - 1)  # noqa: E731
        xb = (c0 * ex("x") + cx * ex("xx") + cy * ex("xy")) * recip
        yb = (c0 * ex("y") + cx * ex("xy") + cy * ex("yy")) * recip
        return xb, yb

    if depth == 2:
        (mean0, ctr0, gx0, gy0), (mean1, ctr1, gx1, gy1) = chain
        c0 = ctr0 * ctr1
        cx = ctr0 * gx1 + gx0 * ctr1
        cy = ctr0 * gy1 + gy0 * ctr1
        cxx = gx0 * gx1
        cxy = gx0 * gy1 + gy0 * gx1
        cyy = gy0 * gy1
        prod = mean0 * mean1
        recip = _recip(prod)
        ex = lambda n: _expand(_mom(rt, n), prod.ndim - 1)  # noqa: E731
        xb = (c0 * ex("x") + cx * ex("xx") + cy * ex("xy") +
              cxx * ex("xxx") + cxy * ex("xxy") + cyy * ex("xyy")) * recip
        yb = (c0 * ex("y") + cx * ex("xy") + cy * ex("yy") +
              cxx * ex("xxy") + cxy * ex("xyy") + cyy * ex("yyy")) * recip
        return xb, yb

    if depth == 3:
        # center of mass*tracer1*tracer2 (reference :4755-4793)
        (mean0, c0_, gx0, gy0), (mean1, c1_, gx1, gy1), \
            (mean2, c2_, gx2, gy2) = chain
        c0 = c0_ * c1_ * c2_
        cx = c0_ * c1_ * gx2 + c0_ * gx1 * c2_ + gx0 * c1_ * c2_
        cy = c0_ * c1_ * gy2 + c0_ * gy1 * c2_ + gy0 * c1_ * c2_
        cxx = c0_ * gx1 * gx2 + gx0 * c1_ * gx2 + gx0 * gx1 * c2_
        cxy = (c0_ * gx1 * gy2 + gx0 * gy1 * c2_ + gy0 * c1_ * gx2 +
               c0_ * gy1 * gx2 + gx0 * c1_ * gy2 + gy0 * gx1 * c2_)
        cyy = c0_ * gy1 * gy2 + gy0 * c1_ * gy2 + gy0 * gy1 * c2_
        cxxx = gx0 * gx1 * gx2
        cxxy = gx0 * gx1 * gy2 + gx0 * gy1 * gx2 + gy0 * gx1 * gx2
        cxyy = gy0 * gy1 * gx2 + gy0 * gx1 * gy2 + gx0 * gy1 * gy2
        cyyy = gy0 * gy1 * gy2
        prod = mean0 * mean1 * mean2
        recip = _recip(prod)
        ex = lambda n: _expand(_mom(rt, n), prod.ndim - 1)  # noqa: E731
        xb = (c0 * ex("x") + cx * ex("xx") + cy * ex("xy") +
              cxx * ex("xxx") + cxy * ex("xxy") + cyy * ex("xyy") +
              cxxx * ex("xxxx") + cxxy * ex("xxxy") + cxyy * ex("xxyy") +
              cyyy * ex("xyyy")) * recip
        yb = (c0 * ex("y") + cx * ex("xy") + cy * ex("yy") +
              cxx * ex("xxy") + cxy * ex("xyy") + cyy * ex("yyy") +
              cxxx * ex("xxxy") + cxxy * ex("xxyy") + cxyy * ex("xyyy") +
              cyyy * ex("yyyy")) * recip
        return xb, yb

    raise NotImplementedError("barycenters beyond depth 3 (the reference "
                              "limits children to depth <= 3 as well)")


def reconstruct_fields(tree: TracerTree, fields: Dict[str, Any],
                       masks: Dict[str, Any], mask_cell,
                       rt: RemapTensors, cells_on_cell, cells_on_cell_mask,
                       monotonic: bool = True):
    """Build limited linear reconstructions for every tracer
    (reference construct_linear_tracer_fields :3580-4200).

    Returns dict name -> {center, gx, gy}."""
    recon = {}
    barys = {}
    centroid = (_mom(rt, "x"), _mom(rt, "y"))
    # one shared neighbor gather for every tracer's values and masks
    arrs = []
    for spec in tree.specs:
        arrs.append(fields[spec.name])
        arrs.append(masks[spec.name])
    gathered = batched_neighbor_gather(arrs, cells_on_cell)
    neigh = {spec.name: (gathered[2 * i], gathered[2 * i + 1])
             for i, spec in enumerate(tree.specs)}
    for spec in tree.specs:
        f = fields[spec.name]
        fm = masks[spec.name]
        f_n, m_n = neigh[spec.name]
        gx, gy = compute_gradient(rt, cells_on_cell, cells_on_cell_mask,
                                  f, fm, mask_cell, f_n=f_n, m_n=m_n)
        # parent barycenter (centroid for the root)
        if spec.parent is None:
            pxb = _expand(centroid[0], f.ndim - 1)
            pyb = _expand(centroid[1], f.ndim - 1)
        else:
            pxb, pyb = barys[spec.parent]
            if f.ndim > pxb.ndim:               # 3D tracer with 2D parent
                pxb = pxb.unsqueeze(-1)
                pyb = pyb.unsqueeze(-1)
        pxb_b = pxb.expand(f.shape)
        pyb_b = pyb.expand(f.shape)
        if monotonic:
            gx, gy = limit_gradient(rt, cells_on_cell, cells_on_cell_mask,
                                    f, fm, pxb_b, pyb_b, gx, gy,
                                    mask_cell, f_n=f_n, m_n=m_n)
        center = f - gx * pxb_b - gy * pyb_b
        recon[spec.name] = {"center": center, "gx": gx, "gy": gy}

        if tree.has_child(spec.name):
            depth = tree.depth(spec.name)
            chain_names = tree.ancestors(spec.name) + [spec.name]
            chain = [(fields[n], recon[n]["center"], recon[n]["gx"],
                      recon[n]["gy"]) for n in chain_names]
            xb, yb = barycenter(rt, depth + 1, chain)
            xb = torch.where(_expand(mask_cell, xb.ndim - 1) > 0, xb, 0.0)
            yb = torch.where(_expand(mask_cell, yb.ndim - 1) > 0, yb, 0.0)
            barys[spec.name] = (xb, yb)
    return recon


# -- stage 4: flux integration (reference :6667-6982) -------------------------
#
# Redesign of integrate_fluxes_over_triangles: instead of carrying
# per-quad-point product value arrays ([nEdges, slots, 6, nCat] per
# tracer, the reference structure), each tracer's mass*tracer product
# is represented by its POLYNOMIAL COEFFICIENTS in the cell frame
# (products of linear reconstructions are polynomials of degree <=
# chain length; coefficient products are computed cellwise), and the
# triangle integrals of the monomials are computed once per (edge,
# slot). Same finite quadrature sum, reassociated: results match the
# reference formulation to roundoff.

# monomial exponents up to degree 4 (covers mass*t1*t2*t3 chains)
_MONOMIALS = [(0, 0), (1, 0), (0, 1),
              (2, 0), (1, 1), (0, 2),
              (3, 0), (2, 1), (1, 2), (0, 3),
              (4, 0), (3, 1), (2, 2), (1, 3), (0, 4)]
_MONO_IDX = {m: i for i, m in enumerate(_MONOMIALS)}


def _poly_mul_linear(poly: dict, c, gx, gy):
    """Multiply a monomial-coefficient dict by (c + gx*x + gy*y)."""
    out = {}
    for (i, j), a in poly.items():
        for (di, dj), b in (((0, 0), c), ((1, 0), gx), ((0, 1), gy)):
            key = (i + di, j + dj)
            term = a * b
            out[key] = out[key] + term if key in out else term
    return out


def triangle_monomial_integrals(rt: RemapTensors, xq, yq,
                                max_degree: int):
    """mom[e, s, m] = sum_q w_q x_q^i y_q^j for monomials up to
    max_degree (exact for the same polynomials the reference's 6-point
    degree-4 rule integrates exactly)."""
    terms = [m for m in _MONOMIALS if m[0] + m[1] <= max_degree]
    w = rt.qp_weights
    cols = []
    for (i, j) in terms:
        cols.append(((xq ** i) * (yq ** j) * w).sum(-1))
    return torch.stack(cols, dim=-1), terms           # [nE, S, M]


def integrate_fluxes(tree: TracerTree, recon, rt: RemapTensors,
                     cell, xq, yq, area, mask_edge):
    """Edge fluxes of mass and mass*tracer products.
    Returns dict name -> flux [nEdges, nCat(, nLayers)].

    The plain PyTorch version of `cuda_flux.integrate_fluxes_cuda`:
    gathers run along the LEADING cell axis with all (category,
    coefficient) data flattened into the minor axis, and the coefficient
    contraction is a minor-axis reduce."""
    nE, S = cell.shape
    X = nE * S
    dev = cell.device
    cellf = cell.reshape(-1)                         # [X]
    areaf = area.reshape(-1)                         # [X]
    max_depth = max(tree.depth(s.name) for s in tree.specs)
    mom, terms = triangle_monomial_integrals(rt, xq, yq,
                                             max_degree=max_depth + 1)
    term_idx = {m: i for i, m in enumerate(terms)}
    W = mom.reshape(X, len(terms))                   # [X, M]
    me = mask_edge[:, None]
    fluxes = {}
    polys = {}                       # 2D tracers: coeff dicts (cellwise)

    def cols(idx):
        return W[:, torch.as_tensor(idx, dtype=torch.int64, device=dev)]

    # pass 1: build every tracer's cellwise coefficient block and
    # concatenate them: the gather indices are shared, so ONE gather
    # moves all tracers' data
    blocks = []                      # (name, kind, shape info, offset)
    cat = []
    off = 0
    for spec in tree.specs:
        r = recon[spec.name]
        c0, gx, gy = r["center"], r["gx"], r["gy"]
        if c0.ndim == 2:
            if spec.parent is None:
                poly = {(0, 0): c0, (1, 0): gx, (0, 1): gy}
            else:
                poly = _poly_mul_linear(polys[spec.parent], c0, gx, gy)
            polys[spec.name] = poly
            keys = sorted(poly.keys(), key=lambda m: term_idx[m])
            nCat = c0.shape[1]
            coeff = torch.stack([poly[k] for k in keys],
                                dim=-1)              # [nc, nCat, M']
            flat = coeff.reshape(coeff.shape[0], -1)
            blocks.append((spec.name, "2d", (nCat, keys), off))
            off += flat.shape[1]
            cat.append(flat)
        else:
            nCat, nL = c0.shape[1], c0.shape[2]
            blocks.append((spec.name, "3d", (nCat, nL), off))
            for a in (c0, gx, gy):
                cat.append(a.reshape(a.shape[0], -1))
            off += 3 * nCat * nL
    gathered = torch.cat(cat, dim=1)[cellf]          # [X, F]

    for (name, kind, info, off) in blocks:
        if kind == "2d":
            nCat, keys = info
            Mp = len(keys)
            g = gathered[:, off:off + nCat * Mp].reshape(X, nCat, Mp)
            w = cols([term_idx[k] for k in keys])
            integral = (g * w[:, None, :]).sum(-1)   # [X, nCat]
            flux = (integral * areaf[:, None]).reshape(
                nE, S, nCat).sum(1) * me             # [nE, nCat]
        else:
            nCat, nL = info
            spec = tree.spec(name)
            ppoly = polys[spec.parent]
            keys = sorted(ppoly.keys(), key=lambda m: term_idx[m])
            Mp = len(keys)
            # the parent's block was already gathered
            poff = [b for b in blocks if b[0] == spec.parent][0][3]
            g = gathered[:, poff:poff + nCat * Mp].reshape(X, nCat, Mp)
            w0 = cols([term_idx[k] for k in keys])
            wx = cols([term_idx[(k[0] + 1, k[1])] for k in keys])
            wy = cols([term_idx[(k[0], k[1] + 1)] for k in keys])
            P0 = (g * w0[:, None, :]).sum(-1)        # [X, nCat]
            Px = (g * wx[:, None, :]).sum(-1)
            Py = (g * wy[:, None, :]).sum(-1)
            F3 = nCat * nL
            c3 = gathered[:, off:off + F3].reshape(X, nCat, nL)
            gx3 = gathered[:, off + F3:off + 2 * F3].reshape(
                X, nCat, nL)
            gy3 = gathered[:, off + 2 * F3:off + 3 * F3].reshape(
                X, nCat, nL)
            integral = (c3 * P0[..., None] + gx3 * Px[..., None]
                        + gy3 * Py[..., None])       # [X, nCat, nL]
            flux = (integral * areaf[:, None, None]).reshape(
                nE, S, nCat, nL).sum(1) * me[..., None]
        fluxes[name] = flux
    return fluxes


# -- stage 5: update (reference :7125-7523) -----------------------------------

def mass_tracer_products(tree: TracerTree, fields):
    """products[t] = mass * t1 * ... * t (root-down;
    reference compute_mass_tracer_products :6982-7120)."""
    products = {}
    for spec in tree.specs:
        if spec.parent is None:
            products[spec.name] = fields[spec.name]
        else:
            p = products[spec.parent]
            f = fields[spec.name]
            if f.ndim > p.ndim:
                p = p.unsqueeze(-1)
            products[spec.name] = p * f
    return products


def update_mass_and_tracers(tree: TracerTree, fields, fluxes,
                            rt: RemapTensors, area_cell):
    """Flux-divergence update of mass and hierarchical tracer recovery
    (reference update_mass_and_tracers :7125-7523)."""
    products = mass_tracer_products(tree, fields)
    eoc = rt.edges_on_cell                           # [nC, K]
    new_fields = {}
    new_products = {}
    # ONE gather for every tracer's edge fluxes (shared indices):
    # concat minors, gather, signed-sum over the cell's edges, split
    shapes = {}
    cat = []
    off = 0
    offs = {}
    for spec in tree.specs:
        f = fluxes[spec.name]
        shapes[spec.name] = tuple(f.shape[1:])
        offs[spec.name] = off
        off += int(np.prod(f.shape[1:]))
        cat.append(f.reshape(f.shape[0], -1))
    fluxcat = torch.cat(cat, dim=1)                  # [nE, F]
    f_e = fluxcat[eoc]                               # [nC, K, F]
    sgn2 = (rt.edge_sign_on_cell * rt.edges_on_cell_mask)[..., None]
    divcat = (f_e * sgn2).sum(dim=1) / area_cell[:, None]    # [nC, F]
    for spec in tree.specs:
        sh = shapes[spec.name]
        o = offs[spec.name]
        div = divcat[:, o:o + int(np.prod(sh))].reshape(
            (divcat.shape[0],) + sh)
        new_prod = products[spec.name] - div
        if spec.parent is None:
            new_fields[spec.name] = new_prod
            new_products[spec.name] = new_prod
        else:
            pp = new_products[spec.parent]
            if new_prod.ndim > pp.ndim:
                pp = pp.unsqueeze(-1)
            # a positive normal mass (`_normal`: subnormals count as 0)
            ok = pp >= torch.finfo(pp.dtype).tiny
            val = torch.where(ok, new_prod / torch.where(ok, pp, 1.0), 0.0)
            # monotone-recovery guard: in exact arithmetic the
            # recovered tracer of a consistent product/mass flux pair
            # is bounded by the pre-remap tracer range; for SLIVER
            # masses (new parent mass < 1e-8, i.e. tiny-product /
            # tiny-mass near-cancellation) the ratio can be roundoff
            # junk (observed: Tsfc = +55 C, positive ice enthalpies in
            # a 1.4e-11-area category, which then wedges the BL99
            # solve).  Clamp ONLY such slivers to the global
            # pre-remap range over physically-meaningful cells
            # (parent mass > eps11, the reference's make_masks
            # exclusive threshold, :3024-3028); an exact no-op for
            # every in-bounds value, so conservation is untouched
            # except for the junk being repaired.
            old = fields[spec.name]
            pm_old = products[spec.parent]
            if old.ndim > pm_old.ndim:
                pm_old = pm_old.unsqueeze(-1)
            meaningful = pm_old > 1e-11
            lo = torch.where(meaningful, old, BIG).amin(dim=0)
            hi = torch.where(meaningful, old, -BIG).amax(dim=0)
            none_valid = lo > hi
            lo = torch.where(none_valid, 0.0, lo)
            hi = torch.where(none_valid, 0.0, hi)
            tiny = pp < 1e-8
            val = torch.where(tiny, torch.clamp(val, min=lo, max=hi), val)
            new_fields[spec.name] = val
            new_products[spec.name] = pp * val
    return new_fields


def zap_small_mass(tree: TracerTree, fields):
    """Zero out mass below 1e-22 (reference zap_small_mass :8764-8900);
    tracers riding on zapped mass are zeroed too."""
    root = tree.root.name
    m = fields[root]
    zap = (m > 0.0) & (m < SMALL_MASS)
    out = dict(fields)
    out[root] = torch.where(zap, 0.0, m)
    for spec in tree.specs[1:]:
        f = out[spec.name]
        z = zap if f.ndim == zap.ndim else zap[..., None]
        out[spec.name] = torch.where(z, 0.0, f)
    return out


# -- masks (reference make_masks :3404-3570) ----------------------------------

def make_masks(tree: TracerTree, fields, threshold: float = 0.0):
    """mask_cell [nCells] plus per-tracer physical-meaning masks."""
    root = tree.root.name
    mask_cell = (fields[root].sum(dim=1) > 0.0).to(fields[root].dtype)
    masks = {root: torch.ones_like(fields[root])}
    for spec in tree.specs[1:]:
        parent = fields[spec.parent]
        m = (parent > threshold).to(parent.dtype)
        if fields[spec.name].ndim > m.ndim:
            m = m[..., None].expand(fields[spec.name].shape)
        masks[spec.name] = m
    return mask_cell, masks


# -- volume <-> thickness (reference :2500-2544, 2602-2650) -------------------

def to_transport_fields(tree: TracerTree, state: Dict[str, Any]):
    """Convert product-stored state entries (volumes) to per-area tracers
    (thickness) for transport."""
    root = tree.root.name
    area = state[root]
    out = {}
    for spec in tree.specs:
        f = state[spec.name]
        if spec.stored_as_product:
            pa = area if spec.parent == root else state[spec.parent]
            # a positive normal mass (`_normal`: subnormals count as 0)
            ok = pa >= torch.finfo(pa.dtype).tiny
            f = torch.where(ok, f / torch.where(ok, pa, 1.0), 0.0)
        out[spec.name] = f
    return out


def from_transport_fields(tree: TracerTree, fields: Dict[str, Any]):
    """Inverse of to_transport_fields."""
    root = tree.root.name
    area = fields[root]
    out = {}
    for spec in tree.specs:
        f = fields[spec.name]
        if spec.stored_as_product:
            pa = area if spec.parent == root else out[spec.parent]
            f = f * pa
        out[spec.name] = f
    return out


# -- the step ----------------------------------------------------------------

def make_remap_step(tree: TracerTree, vertex_degree: int,
                    monotonic: bool = True):
    """Build the IR transport step.

    Returns step(rt, cells_on_cell, cells_on_cell_mask, area_cell,
                 state, u_vertex, v_vertex, dt) -> new state,
    where `state` is a dict of tracer arrays in *storage* convention
    (volumes stored as volumes). Mirrors
    seaice_run_advection_incremental_remap (reference :2338-2667).

    The flux integration goes through `cuda_flux.integrate_fluxes_cuda`:
    the CUDA kernel for CUDA tensors, the plain `integrate_fluxes` for
    CPU tensors."""
    from . import cuda_flux

    def step(rt: RemapTensors, cells_on_cell, cells_on_cell_mask,
             area_cell, state, u_vertex, v_vertex, dt):
        with span("remap.reconstruct"):
            fields = to_transport_fields(tree, state)
            mask_cell, masks = make_masks(tree, fields)
            recon = reconstruct_fields(tree, fields, masks, mask_cell, rt,
                                       cells_on_cell, cells_on_cell_mask,
                                       monotonic=monotonic)
        with span("remap.departure"):
            dpx, dpy = departure_points(u_vertex, v_vertex, dt)
            tris = find_departure_triangles(rt, dpx, dpy, vertex_degree)
            cell, xq, yq, area = triangles_to_cell_coords(rt, tris)
        with span("remap.flux"):
            fluxes = cuda_flux.integrate_fluxes_cuda(
                tree, recon, rt, cell, xq, yq, area, tris["mask_edge"])
        with span("remap.update"):
            new_fields = update_mass_and_tracers(tree, fields, fluxes, rt,
                                                 area_cell)
            new_fields = zap_small_mass(tree, new_fields)
            return from_transport_fields(tree, new_fields)

    return step


# -- runtime self-checks (reference :8126-8266, :8416-8700) -------------------

def global_conserved_sums(tree: TracerTree, state, area_cell):
    """sum_cells areaCell * massTracerProduct for every tracer: invariant
    under IR transport up to roundoff (reference conservation check)."""
    fields = to_transport_fields(tree, state)
    products = mass_tracer_products(tree, fields)
    out = {}
    for name, p in products.items():
        extra = p.ndim - 1
        out[name] = (p * _expand(area_cell, extra)).sum()
    return out


def local_extrema(tree: TracerTree, state, cells_on_cell,
                  cells_on_cell_mask):
    """Per-cell pre-remap neighborhood [min, max] for each TRACER
    (reference monotonicity-check setup :8416-8700).  Mass fields are
    excluded: convergent flow concentrates mass legitimately."""
    fields = to_transport_fields(tree, state)
    coc = cells_on_cell.clamp(min=0)
    m = cells_on_cell_mask
    lo, hi = {}, {}
    for spec in tree.specs:
        if spec.parent is None or spec.stored_as_product:
            continue
        f = fields[spec.name]
        nb = f[coc]                                  # [nC, K, ...]
        extra = f.ndim - 1
        mm = _expand(m, extra)
        nb_lo = torch.where(mm > 0, nb, float("inf")).amin(dim=1)
        nb_hi = torch.where(mm > 0, nb, -float("inf")).amax(dim=1)
        lo[spec.name] = torch.minimum(nb_lo, f)
        hi[spec.name] = torch.maximum(nb_hi, f)
    return lo, hi


def monotonicity_violation(tree: TracerTree, state, lo, hi,
                           tol: float = 1e-10):
    """Largest overshoot of any tracer beyond its pre-remap local
    bounds (0 when the limiter held; reference check :8416)."""
    fields = to_transport_fields(tree, state)
    worst = None
    for name in lo:
        f = fields[name]
        scale = hi[name].abs().clamp(min=1.0)
        over = (f - hi[name]).clamp(min=0.0) / scale
        under = (lo[name] - f).clamp(min=0.0) / scale
        w = torch.maximum(over.max(), under.max())
        worst = w if worst is None else torch.maximum(worst, w)
    if worst is None:
        return torch.zeros(())
    return (worst - tol).clamp(min=0.0)
