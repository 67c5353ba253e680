"""Host-side geometry precompute for incremental remapping.

Equivalent of `get_geometry_incremental_remap` and
`compute_geometric_cell_averages` (MPAS-Seaice
`src/shared/mpas_seaice_advection_incremental_remap.F:1105-1808,2097-2323`):
everything data-dependent-branchy is resolved ONCE here in NumPy into
fixed-slot index/coordinate tables, so the per-step pipeline is pure
masked dense arithmetic.

Edge-local remap stencil (slots are 0-based versions of the reference's
diagram, incremental_remap.F:1133-1172):

  cells_on_edge_remap[e, 0:6] = C1, C2, C3, C4, C5, C6  (-1 if absent;
      C5/C6 exist only on quad meshes)
  edges_on_edge_remap[e, 0:6] = E1, E2, E3, E4, E5, E6  (-1 if absent)
  xy_vertex_on_edge[e, 0:8]   = V1, V2, V3..V6 (far ends of E1..E4),
      V7, V8 (far ends of E5, E6), in edge-midpoint-relative coordinates

Also provides the least-squares gradient-reconstruction coefficients that
replace the MPAS framework's RBF `coeffsReconstruct` (used by
compute_gradient_2d, incremental_remap.F:4204-4414): exact for linear
fields, which is all the 2nd-order IR reconstruction requires.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..diagnostics import span
from ..mesh.core import Mesh
from ..utils.containers import tensor_dataclass
from ..utils.device import resolve_device

# 6-point, degree-4 triangle quadrature (reference incremental_remap.F
# module constants q1..q4TriangleQP, w1/w2TriangleQP; documented at
# :6523-6545)
Q1 = 0.0915762135097704655
Q2 = 0.816847572980458514
Q3 = 0.108103018168070275
Q4 = 0.445948490915964113
W1 = 0.109951743655321885
W2 = 0.223381589678011389

# rows: quadrature points; cols: barycentric weights on the 3 tri vertices
QP_COEFFS = np.array([
    [Q1, Q1, Q2],
    [Q1, Q2, Q1],
    [Q2, Q1, Q1],
    [Q3, Q4, Q4],
    [Q4, Q3, Q4],
    [Q4, Q4, Q3],
])
QP_WEIGHTS = np.array([W1, W1, W1, W2, W2, W2])

# Fixed triangle slots per edge in our vectorized pipeline. The reference
# packs at most 6 triangles with a running counter
# (find_departure_triangles :5365-6269); we give every potential triangle
# its own slot (4 side-intersection passes x {side tri, quad-split tri}
# + 2 central) so slot assignment is static. Unused slots have area 0.
N_TRI_SLOTS = 10


def _wrap(d, period):
    if period > 0.0:
        return d - period * np.round(d / period)
    return d


@dataclasses.dataclass
class RemapGeometry:
    """Host-side (NumPy) remap geometry; see build_remap_geometry."""
    remap_edge: np.ndarray            # [nEdges] {0,1}
    cells_on_edge_remap: np.ndarray   # [nEdges, 6] int32, -1 invalid
    edges_on_edge_remap: np.ndarray   # [nEdges, 6] int32, -1 invalid
    x_vertex_on_edge: np.ndarray      # [nEdges, 8]
    y_vertex_on_edge: np.ndarray      # [nEdges, 8]
    vertex_on_edge_valid: np.ndarray  # [nEdges, 8] {0,1}
    vertex_on_cell_remap: np.ndarray  # [nEdges, 6, 2] int32 local idx, -1
    min_length_edges_on_vertex: np.ndarray  # [nVertices]
    geom_moments: np.ndarray          # [nCells, 14] x..yyyy averages
    coeffs_reconstruct: np.ndarray    # [nCells, maxEdges, 2]
    edge_sign_on_cell: np.ndarray     # [nCells, maxEdges] +-1 (0 invalid)
    vertex_degree: int
    # mesh-derived companions needed by the pipeline
    vertices_on_edge: np.ndarray = None   # [nEdges, 2] int32
    edges_on_cell: np.ndarray = None      # [nCells, maxEdges] int32, -1
    dc_edge_on_cell: np.ndarray = None    # [nCells, maxEdges]
    x_local: np.ndarray = None            # [nCells, maxEdges]
    y_local: np.ndarray = None            # [nCells, maxEdges]
    edge_to_cell_rot: np.ndarray = None   # [nEdges, 6, 2, 2]

    @span("setup.upload")
    def tensors(self, dtype=torch.float64, device=None) -> "RemapTensors":
        """Device upload of the remap geometry (device=None: the GPU)."""
        device = resolve_device(device)
        m = self
        # Precompute the shared-vertex local coordinates per (edge,
        # cell-slot k, vertexOnEdge): the runtime then never gathers
        # x_local/vertex_on_cell_remap by data-dependent indices (see
        # remap.triangles_to_cell_coords).
        coc_r = np.maximum(m.cells_on_edge_remap, 0)        # [nE, 6]
        vocr = np.maximum(m.vertex_on_cell_remap, 0)        # [nE, 6, 2]
        ok = (m.cells_on_edge_remap >= 0)[..., None]        # [nE, 6, 1]
        xl = np.where(ok, m.x_local[coc_r[:, :, None], vocr], 0.0)
        yl = np.where(ok, m.y_local[coc_r[:, :, None], vocr], 0.0)
        xy_local_oer = np.stack([xl, yl], axis=-1)          # [nE, 6, 2, 2]

        def fl(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
                device=device, dtype=dtype)

        def ix(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int64)).to(
                device=device)

        return RemapTensors(
            xy_local_on_edge_remap=fl(xy_local_oer),
            remap_edge=fl(m.remap_edge),
            cells_on_edge_remap=ix(np.maximum(m.cells_on_edge_remap, 0)),
            cells_on_edge_remap_mask=fl(m.cells_on_edge_remap >= 0),
            edges_on_edge_remap_mask=fl(m.edges_on_edge_remap >= 0),
            x_vertex_on_edge=fl(m.x_vertex_on_edge),
            y_vertex_on_edge=fl(m.y_vertex_on_edge),
            vertex_on_cell_remap=ix(np.maximum(m.vertex_on_cell_remap, 0)),
            min_length_edges_on_vertex=fl(m.min_length_edges_on_vertex),
            geom_moments=fl(m.geom_moments),
            coeffs_reconstruct=fl(m.coeffs_reconstruct),
            edge_sign_on_cell=fl(m.edge_sign_on_cell),
            qp_coeffs=fl(QP_COEFFS),
            qp_weights=fl(QP_WEIGHTS),
            vertices_on_edge=ix(np.maximum(m.vertices_on_edge, 0)),
            edges_on_cell=ix(np.maximum(m.edges_on_cell, 0)),
            edges_on_cell_mask=fl(m.edges_on_cell >= 0),
            dc_edge_on_cell=fl(m.dc_edge_on_cell),
            x_local=fl(m.x_local),
            y_local=fl(m.y_local),
            edge_to_cell_rot=fl(m.edge_to_cell_rot),
        )


@tensor_dataclass
class RemapTensors:
    """Device-side remap geometry consumed by the IR pipeline (index
    tensors int64)."""
    remap_edge: Any
    cells_on_edge_remap: Any
    cells_on_edge_remap_mask: Any
    edges_on_edge_remap_mask: Any
    x_vertex_on_edge: Any
    y_vertex_on_edge: Any
    vertex_on_cell_remap: Any
    min_length_edges_on_vertex: Any
    geom_moments: Any
    coeffs_reconstruct: Any
    edge_sign_on_cell: Any
    qp_coeffs: Any
    qp_weights: Any
    vertices_on_edge: Any
    edges_on_cell: Any
    edges_on_cell_mask: Any
    dc_edge_on_cell: Any
    x_local: Any
    y_local: Any
    edge_to_cell_rot: Any
    # [nEdges, 6, 2 (vertexOnEdge), 2 (x,y)] shared-vertex cell-frame
    # coordinates per remap cell slot (gather-free runtime lookup)
    xy_local_on_edge_remap: Any = None


def _spherical_frames(mesh: Mesh, rotate: bool = True):
    """Rotated tangent-plane frames and local coordinates for spherical
    IR (replaces the reference's transGlobalToCell /
    transGlobalToEdge machinery, incremental_remap.F:1105-2332).

    Returns (x_local, y_local [nCells, maxEdges] cell-frame vertex
    coords; xy_voe [nEdges, 8, 2] edge-frame stencil-vertex coords
    filled by caller; frame bases) plus a function projecting points
    into a frame."""
    from ..mesh.rotation import east_north_basis, grid_rotation_forward

    def rot(x, y, z):
        return grid_rotation_forward(x, y, z) if rotate else (x, y, z)

    xc, yc, zc = rot(mesh.x_cell, mesh.y_cell, mesh.z_cell)
    xv, yv, zv = rot(mesh.x_vertex, mesh.y_vertex, mesh.z_vertex)
    # edge midpoint z from its vertices (generators store 3D coords)
    v1 = np.maximum(mesh.vertices_on_edge[:, 0], 0)
    v2 = np.maximum(mesh.vertices_on_edge[:, 1], 0)
    exyz = np.stack([mesh.x_vertex[v1] + mesh.x_vertex[v2],
                     mesh.y_vertex[v1] + mesh.y_vertex[v2],
                     mesh.z_vertex[v1] + mesh.z_vertex[v2]], -1)
    nrm = np.linalg.norm(exyz, axis=-1, keepdims=True)
    exyz = exyz / np.maximum(nrm, 1e-300) * mesh.sphere_radius
    xe, ye, ze = rot(exyz[:, 0], exyz[:, 1], exyz[:, 2])

    e_c, n_c = east_north_basis(xc, yc, zc)     # [nCells, 3]
    e_e, n_e = east_north_basis(xe, ye, ze)     # [nEdges, 3]
    cell_pts = np.stack([xc, yc, zc], -1)
    edge_pts = np.stack([xe, ye, ze], -1)
    vert_pts = np.stack([xv, yv, zv], -1)

    def to_cell_frame(c_idx, pts):
        d = pts - cell_pts[c_idx]
        return (d * e_c[c_idx]).sum(-1), (d * n_c[c_idx]).sum(-1)

    def to_edge_frame(e_idx, pts):
        d = pts - edge_pts[e_idx]
        return (d * e_e[e_idx]).sum(-1), (d * n_e[e_idx]).sum(-1)

    # cell-local vertex coordinates
    voc = mesh.vertices_on_cell
    valid = voc >= 0
    voc_safe = np.where(valid, voc, 0)
    xl, yl = to_cell_frame(
        np.repeat(np.arange(mesh.n_cells)[:, None], mesh.max_edges, 1),
        vert_pts[voc_safe])
    x_local = np.where(valid, xl, 0.0)
    y_local = np.where(valid, yl, 0.0)

    def edge_to_cell_rot(e_idx, c_idx):
        """2x2 rotation taking edge-frame components to cell-frame
        components (tangent planes nearly parallel for neighbors)."""
        r = np.empty(e_idx.shape + (2, 2))
        r[..., 0, 0] = (e_c[c_idx] * e_e[e_idx]).sum(-1)
        r[..., 0, 1] = (e_c[c_idx] * n_e[e_idx]).sum(-1)
        r[..., 1, 0] = (n_c[c_idx] * e_e[e_idx]).sum(-1)
        r[..., 1, 1] = (n_c[c_idx] * n_e[e_idx]).sum(-1)
        return r

    return (x_local, y_local, vert_pts, to_edge_frame, edge_to_cell_rot)


@span("setup.remap_geometry")
def build_remap_geometry(mesh: Mesh,
                         rotate_cartesian_grid: bool = True,
                         use_native: bool = True) -> RemapGeometry:
    """use_native=False forces the Python stencil loops (the oracle the
    C++ stencil code is tested against)."""
    ne = mesh.n_edges
    nc = mesh.n_cells
    nv = mesh.n_vertices
    me = mesh.max_edges
    vd = mesh.vertex_degree
    px, py = mesh.period_x, mesh.period_y

    coe = mesh.cells_on_edge
    voe = mesh.vertices_on_edge
    eoc = mesh.edges_on_cell
    voc = mesh.vertices_on_cell
    neoc = mesh.n_edges_on_cell

    # stencil construction: native C++ when available (the loops are
    # O(nEdges) Python otherwise; see ../native/)
    from ..native import build_remap_stencil as _native_stencil
    _nat = _native_stencil(mesh) if use_native else None
    if _nat is not None:
        (remap_edge, cells_rm, edges_rm, vocr, min_len, esoc) = _nat
        return _finish_remap_geometry(
            mesh, rotate_cartesian_grid, remap_edge, cells_rm, edges_rm,
            vocr, min_len, esoc)

    # remapEdge: edges with both cell neighbors (no-flux at boundaries;
    # reference :1263-1287)
    remap_edge = ((coe[:, 0] >= 0) & (coe[:, 1] >= 0)).astype(np.int32)

    cells_rm = np.full((ne, 6), -1, np.int32)
    edges_rm = np.full((ne, 6), -1, np.int32)
    cells_rm[:, 0] = coe[:, 0]
    cells_rm[:, 1] = coe[:, 1]

    def edge_of_cell_with_vertex(c, v, exclude):
        """Edge of cell c containing vertex v, not in `exclude`."""
        for k in range(neoc[c]):
            e2 = eoc[c, k]
            if e2 < 0 or e2 in exclude:
                continue
            if voe[e2, 0] == v or voe[e2, 1] == v:
                return e2
        return -1

    def other_cell(e2, c):
        if e2 < 0:
            return -1
        a, b = coe[e2]
        return b if a == c else a

    for e in range(ne):
        if not remap_edge[e]:
            continue
        v1, v2 = voe[e]
        c1, c2 = coe[e]
        # side edges by vertex membership (robust to any slot ordering;
        # equivalent to the reference's edgesOnCell walk :1420-1509)
        e1 = edge_of_cell_with_vertex(c1, v1, (e,))
        e2_ = edge_of_cell_with_vertex(c1, v2, (e,))
        e3 = edge_of_cell_with_vertex(c2, v1, (e,))
        e4 = edge_of_cell_with_vertex(c2, v2, (e,))
        edges_rm[e, 0:4] = (e1, e2_, e3, e4)
        if vd == 4:
            # E5/E6: remaining edge at V1/V2 (reference :1478-1509)
            for kk, (v, known) in enumerate(((v1, (e, e1, e3)),
                                             (v2, (e, e2_, e4)))):
                for j in range(vd):
                    cand = mesh.edges_on_vertex[v, j]
                    if cand >= 0 and cand not in known:
                        edges_rm[e, 4 + kk] = cand
                        break
        # side cells (reference :1512-1576)
        if vd == 3:
            # C3: third cell on V1; C4: third cell on V2
            c3 = other_cell(e1, c1)
            if c3 < 0 or c3 == c2:
                c3 = other_cell(e3, c2)
                if c3 == c1:
                    c3 = -1
            c4 = other_cell(e2_, c1)
            if c4 < 0 or c4 == c2:
                c4 = other_cell(e4, c2)
                if c4 == c1:
                    c4 = -1
            cells_rm[e, 2] = c3
            cells_rm[e, 3] = c4
        else:
            cells_rm[e, 2] = other_cell(e1, c1)   # C3 (left, shares V1)
            cells_rm[e, 3] = other_cell(e2_, c1)  # C4 (left, shares V2)
            cells_rm[e, 4] = other_cell(e3, c2)   # C5 (right, shares V1)
            cells_rm[e, 5] = other_cell(e4, c2)   # C6 (right, shares V2)

    # local index of V1/V2 within each remap cell's vertex list
    vocr = np.full((ne, 6, 2), -1, np.int32)
    for e in range(ne):
        v12 = voe[e]
        for s in range(6):
            c = cells_rm[e, s]
            if c < 0:
                continue
            for t in range(2):
                for k in range(neoc[c]):
                    if voc[c, k] == v12[t]:
                        vocr[e, s, t] = k
                        break

    # min edge length meeting at each vertex (CFL check; reference
    # :1766-1806)
    min_len = np.full(nv, np.inf)
    for e in range(ne):
        v1, v2 = voe[e]
        if v1 >= 0 and v2 >= 0:
            ln = mesh.dv_edge[e]
            for v in (v1, v2):
                if ln < min_len[v]:
                    min_len[v] = ln
    min_len[~np.isfinite(min_len)] = 0.0

    # +-1 orientation of each cell relative to its edges (update step;
    # reference update_mass_and_tracers :7436-7444)
    esoc = np.zeros((nc, me))
    for c in range(nc):
        for k in range(neoc[c]):
            e = eoc[c, k]
            if e < 0:
                continue
            esoc[c, k] = 1.0 if coe[e, 0] == c else -1.0

    return _finish_remap_geometry(
        mesh, rotate_cartesian_grid, remap_edge, cells_rm, edges_rm,
        vocr, min_len, esoc)


def _finish_remap_geometry(mesh: Mesh, rotate_cartesian_grid,
                           remap_edge, cells_rm, edges_rm, vocr,
                           min_len, esoc) -> RemapGeometry:
    """Coordinate/moment portion of the geometry build (vectorized;
    shared between the native and Python stencil paths)."""
    ne, nc = mesh.n_edges, mesh.n_cells
    me, vd = mesh.max_edges, mesh.vertex_degree
    px, py = mesh.period_x, mesh.period_y
    voe = mesh.vertices_on_edge
    eoc = mesh.edges_on_cell
    coe = mesh.cells_on_edge

    # vertex coordinates relative to the edge midpoint: planar path of
    # reference :1695-1763 with periodic minimum-image wrap; spherical
    # path projects onto the edge tangent plane in the rotated frame.
    # The 8-slot stencil vertex table is built fully vectorized.
    if mesh.on_sphere:
        (sph_x_local, sph_y_local, vert_pts, to_edge_frame,
         edge_to_cell_rot_fn) = _spherical_frames(mesh,
                                                  rotate_cartesian_grid)

        def rel_vertices(e_arr, v_arr):
            return to_edge_frame(e_arr, vert_pts[np.maximum(v_arr, 0)])
    else:
        def rel_vertices(e_arr, v_arr):
            vs = np.maximum(v_arr, 0)
            return (_wrap(mesh.x_vertex[vs] - mesh.x_edge[e_arr], px),
                    _wrap(mesh.y_vertex[vs] - mesh.y_edge[e_arr], py))

    # slot vertex ids: V1, V2, then the far vertices of E1..E6
    slot_v = np.full((ne, 8), -1, np.int64)
    slot_v[:, 0] = voe[:, 0]
    slot_v[:, 1] = voe[:, 1]
    voe_safe = np.maximum(voe, 0)
    for j in range(6):
        en = edges_rm[:, j]
        en_safe = np.maximum(en, 0)
        shared = voe[:, 0] if j in (0, 2, 4) else voe[:, 1]
        a = voe_safe[en_safe, 0]
        b = voe_safe[en_safe, 1]
        far = np.where(a == shared, b, a)
        slot_v[:, 2 + j] = np.where(en >= 0, far, -1)
    voe_valid = (slot_v >= 0).astype(np.int32)
    e_grid = np.repeat(np.arange(ne)[:, None], 8, axis=1)
    xs, ys = rel_vertices(e_grid, slot_v)
    xvoe = np.where(voe_valid > 0, xs, 0.0)
    yvoe = np.where(voe_valid > 0, ys, 0.0)

    # edge-frame -> cell-frame rotation per (edge, remap-cell slot)
    if mesh.on_sphere:
        e_idx = np.repeat(np.arange(ne)[:, None], 6, 1)
        c_safe = np.maximum(cells_rm, 0)
        e2c_rot = edge_to_cell_rot_fn(e_idx, c_safe)
        ident = np.zeros((ne, 6, 2, 2))
        ident[..., 0, 0] = 1.0
        ident[..., 1, 1] = 1.0
        e2c_rot = np.where((cells_rm >= 0)[..., None, None], e2c_rot,
                           ident)
    else:
        e2c_rot = np.zeros((ne, 6, 2, 2))
        e2c_rot[..., 0, 0] = 1.0
        e2c_rot[..., 1, 1] = 1.0

    if mesh.on_sphere:
        x_local, y_local = sph_x_local, sph_y_local
    else:
        x_local, y_local = mesh.x_local, mesh.y_local
    geom_moments = compute_geometric_moments(mesh, x_local, y_local)
    coeffs = least_squares_reconstruction_coeffs(mesh, x_local, y_local)

    # dcEdge gathered per (cell, edge slot) for gradient reconstruction
    eoc_safe = np.where(eoc >= 0, eoc, 0)
    dc_on_cell = np.where(eoc >= 0, mesh.dc_edge[eoc_safe], 0.0)

    return RemapGeometry(
        remap_edge=remap_edge,
        cells_on_edge_remap=cells_rm,
        edges_on_edge_remap=edges_rm,
        x_vertex_on_edge=xvoe, y_vertex_on_edge=yvoe,
        vertex_on_edge_valid=voe_valid,
        vertex_on_cell_remap=vocr,
        min_length_edges_on_vertex=min_len,
        geom_moments=geom_moments,
        coeffs_reconstruct=coeffs,
        edge_sign_on_cell=esoc,
        vertex_degree=vd,
        vertices_on_edge=voe,
        edges_on_cell=eoc,
        dc_edge_on_cell=dc_on_cell,
        x_local=x_local,
        y_local=y_local,
        edge_to_cell_rot=e2c_rot,
    )


def compute_geometric_moments(mesh: Mesh, x_local=None,
                              y_local=None) -> np.ndarray:
    """Cell-average moments <x>, <y>, <xx> ... <yyyy> in cell-local
    coordinates (reference compute_geometric_cell_averages,
    incremental_remap.F:2097-2323).

    Integrates over the fan of triangles (center, v_k, v_{k+1}) with
    6-point degree-4 quadrature; triangle weights use the MPAS convention
    0.25*dcEdge*dvEdge normalized by their sum.
    """
    nc, me = mesh.n_cells, mesh.max_edges
    neoc = mesh.n_edges_on_cell
    xl = mesh.x_local if x_local is None else x_local
    yl = mesh.y_local if y_local is None else y_local

    k = np.arange(me)[None, :]
    valid = k < neoc[:, None]

    # triangle k: (0,0), v_k, v_{k+1 mod n}
    nxt = np.where(k + 1 < neoc[:, None], k + 1, 0)
    x2, y2 = xl, yl
    x3 = np.take_along_axis(xl, nxt, axis=1)
    y3 = np.take_along_axis(yl, nxt, axis=1)

    # fractional triangle weights from edge lengths, matching the reference
    # (edge k of the MPAS convention joins vertices k and k+1)
    w_tri = np.zeros((nc, me))
    for c in range(nc):
        for kk in range(neoc[c]):
            e = mesh.edges_on_cell[c, kk]
            # our generator's edge slot kk joins corners kk and kk+1
            if e >= 0:
                w_tri[c, kk] = 0.25 * mesh.dc_edge[e] * mesh.dv_edge[e]
            else:
                # boundary edge without dcEdge: fall back to triangle area
                x_a, y_a = xl[c, kk], yl[c, kk]
                kk2 = (kk + 1) % neoc[c]
                x_b, y_b = xl[c, kk2], yl[c, kk2]
                w_tri[c, kk] = 0.5 * abs(x_a * y_b - y_a * x_b)
    wsum = np.maximum(w_tri.sum(axis=1, keepdims=True), 1e-300)
    w_tri = np.where(valid, w_tri / wsum, 0.0)

    # quadrature points per (cell, tri): [nc, me, 6]
    xq = (QP_COEFFS[None, None, :, 0] * 0.0 +
          QP_COEFFS[None, None, :, 1] * x2[..., None] +
          QP_COEFFS[None, None, :, 2] * x3[..., None])
    yq = (QP_COEFFS[None, None, :, 1] * y2[..., None] +
          QP_COEFFS[None, None, :, 2] * y3[..., None])

    w = QP_WEIGHTS[None, None, :]
    mom = []
    for ex, ey in ((1, 0), (0, 1), (2, 0), (1, 1), (0, 2),
                   (3, 0), (2, 1), (1, 2), (0, 3),
                   (4, 0), (3, 1), (2, 2), (1, 3), (0, 4)):
        tri_avg = (w * xq ** ex * yq ** ey).sum(axis=2)
        mom.append((w_tri * tri_avg).sum(axis=1))
    return np.stack(mom, axis=1)   # [nCells, 14]


def least_squares_reconstruction_coeffs(mesh: Mesh, x_local=None,
                                        y_local=None) -> np.ndarray:
    """Per-cell coefficients turning edge-normal gradient components into a
    cell-center gradient vector: grad = sum_k coeffs[c,k,:] * g_k, where
    g_k ~ grad.n_k and n_k is the unit vector from cellsOnEdge[0] to
    cellsOnEdge[1].

    Least-squares fit, exact for linear fields: the stand-in
    for the MPAS framework RBF coeffsReconstruct consumed at
    incremental_remap.F:4340-4346.

    Normal directions are built in the cell's own local frame from the
    edge midpoints: on a Voronoi mesh the cell-center line through an
    edge passes through its midpoint perpendicular to it, so
    unit(midpoint) in the cell frame IS the C1->C2 direction (signed by
    which side the cell is on). This makes the construction frame-
    agnostic (planar and spherical).
    """
    nc, me = mesh.n_cells, mesh.max_edges
    xl = mesh.x_local if x_local is None else x_local
    yl = mesh.y_local if y_local is None else y_local
    coeffs = np.zeros((nc, me, 2))
    for c in range(nc):
        ncn = mesh.n_edges_on_cell[c]
        normals = np.zeros((me, 2))
        ok = np.zeros(me, bool)
        for k in range(ncn):
            e = mesh.edges_on_cell[c, k]
            if e < 0:
                continue
            c1, c2 = mesh.cells_on_edge[e]
            if c1 < 0 or c2 < 0:
                continue
            k2 = (k + 1) % ncn
            mx = 0.5 * (xl[c, k] + xl[c, k2])
            my = 0.5 * (yl[c, k] + yl[c, k2])
            ln = np.hypot(mx, my)
            if ln <= 0:
                continue
            sgn = 1.0 if c1 == c else -1.0
            normals[k] = (sgn * mx / ln, sgn * my / ln)
            ok[k] = True
        if ok.sum() < 2:
            continue
        nmat = normals[ok]
        g = nmat.T @ nmat
        ginv = np.linalg.inv(g)
        coeffs[c, ok, :] = nmat @ ginv.T
    return coeffs
