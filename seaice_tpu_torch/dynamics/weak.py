"""Weak (line-integral) strain and stress-divergence operators.

The reference's weak scheme (`mpas_seaice_velocity_solver_weak.F`: strain
:112, stress divergence :493) and its normal-vector init
(`mpas_seaice_mesh.F`: seaice_normal_vectors :703-1000): Green's-theorem
strain on primal cells, stress divergence on the dual triangles.
Stresses are cell-centered scalars (one per cell, unlike the variational
scheme's per-corner values).  The normal vectors are built on the host in
numpy (a copy of the JAX package's builder), the operators are torch.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..mesh.core import Mesh, MeshTensors
from ..mesh.rotation import grid_rotation_forward
from ..utils.containers import tensor_dataclass
from ..utils.device import resolve_device


def _wrap(d, period):
    if period > 0.0:
        return d - period * np.round(d / period)
    return d


@tensor_dataclass
class WeakTensors:
    """Static tensors for the weak scheme."""
    normal_polygon: Any        # [nCells, maxEdges, 2] outward normals
    dv_on_cell: Any            # [nCells, maxEdges] primal edge lengths
    voe_on_cell: Any           # [nCells, maxEdges, 2] vertex ids per edge
    edge_on_cell_mask: Any     # [nCells, maxEdges]
    normal_triangle: Any       # [nVertices, vertexDegree, 2]
    dc_on_vertex: Any          # [nVertices, vertexDegree]
    coe_on_vertex: Any         # [nVertices, vertexDegree, 2] cell ids
    edge_on_vertex_mask: Any   # [nVertices, vertexDegree]
    tan_lat_cell: Any          # [nCells] tan(lat)/r (0 planar)
    tan_lat_vertex: Any        # [nVertices]


def _weak_tensors(arrays, dtype, device) -> WeakTensors:
    """The host arrays as a WeakTensors on device: index arrays int64,
    the rest in dtype."""
    def put(name, a):
        a = np.ascontiguousarray(a)
        if name in ("voe_on_cell", "coe_on_vertex"):
            return torch.as_tensor(a.astype(np.int64)).to(device)
        return torch.as_tensor(a.astype(np.float64)).to(device=device,
                                                        dtype=dtype)
    return WeakTensors(**{k: put(k, a) for k, a in arrays.items()})


def build_weak_tensors(mesh: Mesh, dtype=torch.float64,
                       rotate_cartesian_grid: bool = True,
                       device=None) -> WeakTensors:
    """Host-side normal-vector precompute (reference
    seaice_normal_vectors, mpas_seaice_mesh.F:703-1000: planar branch
    :858-937/:960-1020, spherical :1038-1241/:1393-1606).
    device=None: the GPU."""
    device = resolve_device(device)
    if mesh.on_sphere:
        return _weak_tensors(
            _weak_arrays_spherical(mesh, rotate_cartesian_grid), dtype,
            device)
    nc, me = mesh.n_cells, mesh.max_edges
    nv, vd = mesh.n_vertices, mesh.vertex_degree
    px, py = mesh.period_x, mesh.period_y

    nvp = np.zeros((nc, me, 2))
    dv_on_cell = np.zeros((nc, me))
    voe_on_cell = np.zeros((nc, me, 2), np.int32)
    eoc_mask = np.zeros((nc, me))
    for c in range(nc):
        for k in range(mesh.n_edges_on_cell[c]):
            e = mesh.edges_on_cell[c, k]
            if e < 0:
                continue
            v1, v2 = mesh.vertices_on_edge[e]
            if v1 < 0 or v2 < 0:
                continue
            tx = _wrap(mesh.x_vertex[v2] - mesh.x_vertex[v1], px)
            ty = _wrap(mesh.y_vertex[v2] - mesh.y_vertex[v1], py)
            tmag = np.hypot(tx, ty)
            tx, ty = tx / tmag, ty / tmag
            nx = _wrap(mesh.x_edge[e] - mesh.x_cell[c], px)
            ny = _wrap(mesh.y_edge[e] - mesh.y_cell[c], py)
            if nx * ty - ny * tx < 0.0:
                tx, ty = -tx, -ty
            nvp[c, k] = (ty, -tx)
            dv_on_cell[c, k] = mesh.dv_edge[e]
            voe_on_cell[c, k] = (v1, v2)
            eoc_mask[c, k] = 1.0

    nvt = np.zeros((nv, vd, 2))
    dc_on_vertex = np.zeros((nv, vd))
    coe_on_vertex = np.zeros((nv, vd, 2), np.int32)
    eov_mask = np.zeros((nv, vd))
    for v in range(nv):
        if not mesh.interior_vertex[v]:
            continue
        for k in range(vd):
            e = mesh.edges_on_vertex[v, k]
            if e < 0:
                continue
            dx = _wrap(mesh.x_edge[e] - mesh.x_vertex[v], px)
            dy = _wrap(mesh.y_edge[e] - mesh.y_vertex[v], py)
            d = np.hypot(dx, dy)
            if d <= 0:
                continue
            nvt[v, k] = (dx / d, dy / d)
            dc_on_vertex[v, k] = mesh.dc_edge[e]
            c1, c2 = mesh.cells_on_edge[e]
            coe_on_vertex[v, k] = (max(c1, 0), max(c2, 0))
            eov_mask[v, k] = 1.0 if (c1 >= 0 and c2 >= 0) else 0.0

    return _weak_tensors(dict(
        normal_polygon=nvp, dv_on_cell=dv_on_cell, voe_on_cell=voe_on_cell,
        edge_on_cell_mask=eoc_mask, normal_triangle=nvt,
        dc_on_vertex=dc_on_vertex, coe_on_vertex=coe_on_vertex,
        edge_on_vertex_mask=eov_mask, tan_lat_cell=np.zeros((nc,)),
        tan_lat_vertex=np.zeros((nv,))), dtype, device)


def _rotation_to_equator(lat, lon):
    """Per-point 3x3 matrices R = Ry(lat) @ Rz(-lon) carrying each point
    to (r, 0, 0): the reference's removeMetricTerms frames
    (mpas_seaice_mesh.F:1145-1166)."""
    cl, sl = np.cos(lat), np.sin(lat)
    co, so = np.cos(lon), np.sin(lon)
    R = np.empty(lat.shape + (3, 3))
    # Ry(lat) rows applied to Rz(-lon):
    #   Rz(-lon) = [[ co, so, 0], [-so, co, 0], [0, 0, 1]]
    #   Ry(lat)  = [[ cl, 0, sl], [0, 1, 0], [-sl, 0, cl]]
    R[..., 0, 0] = cl * co
    R[..., 0, 1] = cl * so
    R[..., 0, 2] = sl
    R[..., 1, 0] = -so
    R[..., 1, 1] = co
    R[..., 1, 2] = 0.0
    R[..., 2, 0] = -sl * co
    R[..., 2, 1] = -sl * so
    R[..., 2, 2] = cl
    return R


def _great_circle_normal(R, p_edge, p_a, p_b, flip):
    """East/north components of the outward great-circle normal of the
    arc (p_a -> p_b) at the edge point, all rotated by the per-entity
    frame R (reference mpas_seaice_mesh.F:1196-1236).

    R: [..., 3, 3]; p_*: [..., 3]; flip: [...] bool (negate normal).
    Returns (n_east, n_north)."""
    e = np.einsum("...ij,...j->...i", R, p_edge)
    a = np.einsum("...ij,...j->...i", R, p_a)
    b = np.einsum("...ij,...j->...i", R, p_b)
    ngc = np.cross(b - a, e)
    ngc = np.where(flip[..., None], -ngc, ngc)
    nrm = np.linalg.norm(ngc, axis=-1, keepdims=True)
    ngc = ngc / np.maximum(nrm, 1e-300)
    # eastwards unit vector at the edge point
    east = np.stack([-e[..., 1], e[..., 0],
                     np.zeros_like(e[..., 0])], axis=-1)
    east = east / np.maximum(
        np.linalg.norm(east, axis=-1, keepdims=True), 1e-300)
    n1 = (ngc * east).sum(-1)
    n2 = np.sign(ngc[..., 2]) * np.sqrt(
        1.0 - np.clip(n1, -1.0, 1.0) ** 2)
    return n1, n2


def _weak_arrays_spherical(mesh: Mesh, rotate_cartesian_grid: bool):
    """Spherical normal vectors in per-entity equator frames + metric
    terms from the rotated latitudes (reference
    normal_vectors_spherical_polygon_metric :1038-1241 and
    _triangle_metric :1393-1606, called with removeMetricTerms=.true.
    from the weak init, velocity_solver_weak.F:84-92; metric terms
    tan(latRotated)/r applied in strain :244-245 and divergence
    :620-640).  Returns the WeakTensors fields as numpy arrays."""
    nc, me = mesh.n_cells, mesh.max_edges
    nv = mesh.n_vertices
    r = mesh.sphere_radius

    def fwd(x, y, z):
        if rotate_cartesian_grid:
            return grid_rotation_forward(x, y, z)
        return x, y, z

    cx, cy, cz = fwd(mesh.x_cell, mesh.y_cell, mesh.z_cell)
    vx, vy, vz = fwd(mesh.x_vertex, mesh.y_vertex, mesh.z_vertex)
    cpos = np.stack([cx, cy, cz], axis=-1)          # [nc, 3]
    vpos = np.stack([vx, vy, vz], axis=-1)          # [nv, 3]
    # spherical edge points: sphere-projected midpoints of the two
    # endpoint vertices (the mesh carries no 3-D edge coordinates; the
    # great-circle construction needs only a point on the edge arc)
    voe = np.maximum(mesh.vertices_on_edge, 0)      # [nE, 2]
    em = 0.5 * (vpos[voe[:, 0]] + vpos[voe[:, 1]])
    em = em / np.maximum(np.linalg.norm(em, axis=-1, keepdims=True),
                         1e-300) * r                # [nE, 3]

    lat_c = np.arcsin(np.clip(cz / r, -1.0, 1.0))
    lon_c = np.arctan2(cy, cx)
    lat_v = np.arcsin(np.clip(vz / r, -1.0, 1.0))
    lon_v = np.arctan2(vy, vx)

    # --- polygon (cell) normals ---
    eoc = mesh.edges_on_cell                        # [nc, me]
    slot = np.arange(me)[None, :]
    eoc_mask_b = (slot < mesh.n_edges_on_cell[:, None]) & (eoc >= 0)
    eid = np.where(eoc_mask_b, eoc, 0)
    R_c = _rotation_to_equator(lat_c, lon_c)        # [nc, 3, 3]
    flip = mesh.cells_on_edge[eid, 1] == np.arange(nc)[:, None]
    n1, n2 = _great_circle_normal(
        R_c[:, None], em[eid], vpos[voe[eid, 0]], vpos[voe[eid, 1]],
        flip)
    nvp = np.stack([np.where(eoc_mask_b, n1, 0.0),
                    np.where(eoc_mask_b, n2, 0.0)], axis=-1)
    dv_on_cell = np.where(eoc_mask_b, mesh.dv_edge[eid], 0.0)
    voe_on_cell = np.where(eoc_mask_b[..., None], voe[eid], 0)
    eoc_mask = eoc_mask_b.astype(np.float64)

    # --- triangle (vertex) normals ---
    eov = mesh.edges_on_vertex                      # [nv, vd]
    interior = np.asarray(mesh.interior_vertex) > 0
    eov_mask_b = (eov >= 0) & interior[:, None]
    evid = np.where(eov_mask_b, eov, 0)
    coe = np.maximum(mesh.cells_on_edge, 0)         # [nE, 2]
    coe_valid = (mesh.cells_on_edge[evid] >= 0).all(axis=-1)
    eov_mask_b = eov_mask_b & coe_valid
    R_v = _rotation_to_equator(lat_v, lon_v)        # [nv, 3, 3]
    flip_v = voe[evid, 0] == np.arange(nv)[:, None]
    t1, t2 = _great_circle_normal(
        R_v[:, None], em[evid], cpos[coe[evid, 0]], cpos[coe[evid, 1]],
        flip_v)
    nvt = np.stack([np.where(eov_mask_b, t1, 0.0),
                    np.where(eov_mask_b, t2, 0.0)], axis=-1)
    dc_on_vertex = np.where(eov_mask_b, mesh.dc_edge[evid], 0.0)
    coe_on_vertex = np.where(eov_mask_b[..., None], coe[evid], 0)
    eov_mask = eov_mask_b.astype(np.float64)

    return dict(
        normal_polygon=nvp, dv_on_cell=dv_on_cell, voe_on_cell=voe_on_cell,
        edge_on_cell_mask=eoc_mask, normal_triangle=nvt,
        dc_on_vertex=dc_on_vertex, coe_on_vertex=coe_on_vertex,
        edge_on_vertex_mask=eov_mask,
        tan_lat_cell=np.tan(lat_c) / r,
        tan_lat_vertex=np.where(interior, np.tan(lat_v) / r, 0.0))


def strain_tensor_weak(wk: WeakTensors, mesh: MeshTensors,
                       u_vertex, v_vertex, area_cell, solve_stress):
    """Cell-mean strain via boundary line integral (reference
    seaice_strain_tensor_weak :112-250). Returns (e11, e22, e12),
    each [nCells]."""
    u_e = 0.5 * (u_vertex[wk.voe_on_cell[..., 0]] +
                 u_vertex[wk.voe_on_cell[..., 1]])   # [nCells, maxEdges]
    v_e = 0.5 * (v_vertex[wk.voe_on_cell[..., 0]] +
                 v_vertex[wk.voe_on_cell[..., 1]])
    w = wk.edge_on_cell_mask * wk.dv_on_cell
    nx = wk.normal_polygon[..., 0]
    ny = wk.normal_polygon[..., 1]
    e11 = (u_e * nx * w).sum(-1) / area_cell
    e22 = (v_e * ny * w).sum(-1) / area_cell
    e12 = (0.5 * (u_e * ny + v_e * nx) * w).sum(-1) / area_cell

    # spherical metric terms from cell-mean velocity (:233-242)
    voc_mask = mesh.vertices_on_cell_mask
    n = voc_mask.sum(-1).clamp(min=1.0)
    u_c = (u_vertex[mesh.vertices_on_cell] * voc_mask).sum(-1) / n
    v_c = (v_vertex[mesh.vertices_on_cell] * voc_mask).sum(-1) / n
    tl = wk.tan_lat_cell
    e11 = e11 - v_c * tl
    e12 = e12 + 0.5 * u_c * tl

    ss = solve_stress > 0
    zero = torch.zeros_like(e11)
    return (torch.where(ss, e11, zero), torch.where(ss, e22, zero),
            torch.where(ss, e12, zero))


def stress_divergence_weak(wk: WeakTensors, mesh: MeshTensors,
                           s11, s22, s12, area_triangle, solve_velocity):
    """Divergence of cell stresses on the dual triangle (reference
    seaice_stress_divergence_weak :493-650). s** [nCells];
    returns (div_u, div_v) [nVertices]."""
    c1 = wk.coe_on_vertex[..., 0]
    c2 = wk.coe_on_vertex[..., 1]
    m = wk.edge_on_vertex_mask
    s11e = 0.5 * (s11[c1] + s11[c2])
    s22e = 0.5 * (s22[c1] + s22[c2])
    s12e = 0.5 * (s12[c1] + s12[c2])
    nx = wk.normal_triangle[..., 0]
    ny = wk.normal_triangle[..., 1]
    w = m * wk.dc_on_vertex
    div_u = ((s11e * nx + s12e * ny) * w).sum(-1) / area_triangle
    div_v = ((s22e * ny + s12e * nx) * w).sum(-1) / area_triangle

    # metric terms from vertex-mean stress (:620-640)
    cov = mesh.cells_on_vertex
    cm = mesh.cells_on_vertex_mask
    nvd = cm.sum(-1).clamp(min=1.0)
    s11v = (s11[cov] * cm).sum(-1) / nvd
    s22v = (s22[cov] * cm).sum(-1) / nvd
    s12v = (s12[cov] * cm).sum(-1) / nvd
    tl = wk.tan_lat_vertex
    div_u = div_u - 2.0 * tl * s12v
    div_v = div_v + tl * (s11v - s22v)

    sv = solve_velocity > 0
    zero = torch.zeros_like(div_u)
    return torch.where(sv, div_u, zero), torch.where(sv, div_v, zero)
