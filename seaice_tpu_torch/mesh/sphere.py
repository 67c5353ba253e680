"""Spherical mesh generation: icosahedral Voronoi (hex/pentagon) grids.

Quasi-uniform global meshes in the MPAS format — the stand-in for the
reference's QU meshes (e.g. QU120km, which the reference test harness
downloads; testing_and_setup/testing/README.rst): generating points
from an n-times-subdivided icosahedron, cells = spherical Voronoi
regions (12 pentagons + hexagons), mesh vertices = triangle
circumcenters, all projected to the sphere.
"""

from __future__ import annotations

import numpy as np

from ..diagnostics import span
from .core import Mesh
from .. import constants as c


def _icosahedron():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
        float)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        np.int64)
    return v, f


def _first_seen_unique(keys):
    """np.unique with ids renumbered in FIRST-OCCURRENCE order (the
    numbering a sequential dict-based construction would produce).
    Returns (first_idx_in_seen_order, inverse_ranks)."""
    _, first_idx, inv = np.unique(keys, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return first_idx[order], rank[inv]


def _subdivide(verts, faces):
    """One 4-way triangle subdivision, points projected to the sphere
    (vectorized; midpoint numbering identical to the sequential
    construction: first-seen order over the ab,bc,ca per-face sequence)."""
    F = len(faces)
    a, b, cc = faces[:, 0], faces[:, 1], faces[:, 2]
    pairs = np.stack([np.stack([a, b], 1), np.stack([b, cc], 1),
                      np.stack([cc, a], 1)], axis=1).reshape(-1, 2)
    lo = pairs.min(1).astype(np.int64)
    hi = pairs.max(1).astype(np.int64)
    first_idx, mid_rank = _first_seen_unique(lo * (1 << 32) + hi)
    mids = verts[lo[first_idx]] + verts[hi[first_idx]]
    mids /= np.linalg.norm(mids, axis=1, keepdims=True)
    new_verts = np.concatenate([verts, mids])
    mid_id = (len(verts) + mid_rank).reshape(F, 3)
    ab, bc, ca = mid_id[:, 0], mid_id[:, 1], mid_id[:, 2]
    new_faces = np.empty((4 * F, 3), np.int64)
    new_faces[0::4] = np.stack([a, ab, ca], 1)
    new_faces[1::4] = np.stack([b, bc, ab], 1)
    new_faces[2::4] = np.stack([cc, ca, bc], 1)
    new_faces[3::4] = np.stack([ab, bc, ca], 1)
    return new_verts, new_faces


def _circumcenter(p1, p2, p3):
    """Spherical triangle circumcenter (normalized)."""
    n = np.cross(p2 - p1, p3 - p1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    # orient outward
    centroid = (p1 + p2 + p3) / 3.0
    sign = np.sign((n * centroid).sum(-1, keepdims=True))
    sign = np.where(sign == 0, 1.0, sign)
    return n * sign


def _spherical_polygon_area(points, radius):
    """Area of spherical polygons given CCW corner unit vectors
    [..., n, 3] (spherical excess via interior-angle sum), batched
    over leading axes."""
    points = np.asarray(points)
    n = points.shape[-2]
    a = np.roll(points, 1, axis=-2)
    b = points
    cc = np.roll(points, -1, axis=-2)
    t1 = a - b * (a * b).sum(-1, keepdims=True)
    t2 = cc - b * (cc * b).sum(-1, keepdims=True)
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 /= np.linalg.norm(t2, axis=-1, keepdims=True)
    ang = np.arccos(np.clip((t1 * t2).sum(-1), -1.0, 1.0))
    return (ang.sum(-1) - (n - 2) * np.pi) * radius ** 2


@span("setup.mesh")
def icosahedral_mesh(subdivisions: int = 3,
                     radius: float = c.EARTH_RADIUS) -> Mesh:
    """Build the spherical Voronoi mesh from an n-subdivided icosahedron.

    subdivisions=3 -> 642 cells (~885 km); 4 -> 2562 (~440 km);
    5 -> 10242 (~220 km); 6 -> 40962 (~110 km, QU120km-class)."""
    pts, tris = _icosahedron()
    for _ in range(subdivisions):
        pts, tris = _subdivide(pts, tris)
    return delaunay_dual_mesh(pts, tris, radius)


def delaunay_dual_mesh(pts: np.ndarray, tris: np.ndarray,
                       radius: float = c.EARTH_RADIUS) -> Mesh:
    """Build the Voronoi-dual Mesh of an arbitrary spherical Delaunay
    triangulation: generators `pts` [n,3] (unit vectors) become cells,
    triangle circumcenters become mesh vertices.  This is the generic
    core of the QU-mesh construction — any valid full-sphere
    triangulation works (icosahedral subdivision, convex hull of an
    SCVT point set, ...); mirrors the mesh format the reference
    consumes (`MPAS-Seaice src/Registry.xml` mesh stream)."""
    n_cells = len(pts)          # generators = cells
    n_vertices = len(tris)      # triangle circumcenters = vertices
    vert_xyz = _circumcenter(pts[tris[:, 0]], pts[tris[:, 1]],
                             pts[tris[:, 2]])

    # cells on vertex = the triangle's corners
    cells_on_vertex = tris.astype(np.int32)
    vertex_degree = 3

    # vertices (triangles) around each cell, CCW-ordered — all loops
    # below are vectorized over cells/edges (the sequential version was
    # the setup bottleneck at QU-class sizes); entity numbering is
    # identical to a sequential first-seen pass.
    pairs_c = tris.reshape(-1)
    pairs_t = np.repeat(np.arange(n_vertices, dtype=np.int64), 3)
    by_cell = np.argsort(pairs_c, kind="stable")
    counts = np.bincount(pairs_c, minlength=n_cells)
    max_edges = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(pairs_c)) - starts[pairs_c[by_cell]]
    vertices_on_cell = np.full((n_cells, max_edges), -1, np.int32)
    vertices_on_cell[pairs_c[by_cell], slot] = pairs_t[by_cell]
    n_edges_on_cell = counts.astype(np.int32)

    # CCW order by angle in the local tangent frame at each cell
    z = np.array([0.0, 0.0, 1.0])
    e1 = np.cross(np.broadcast_to(z, pts.shape), pts)
    degen = np.linalg.norm(e1, axis=-1) < 1e-12
    if degen.any():
        e1[degen] = np.cross(np.array([1.0, 0.0, 0.0]), pts[degen])
    e1 /= np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = np.cross(pts, e1)
    voc_safe = np.maximum(vertices_on_cell, 0)
    vp = vert_xyz[voc_safe]                           # [nC, me, 3]
    ang = np.arctan2((vp * e2[:, None]).sum(-1),
                     (vp * e1[:, None]).sum(-1))
    ang = np.where(vertices_on_cell >= 0, ang, np.inf)
    order = np.argsort(ang, axis=1)
    vertices_on_cell = np.take_along_axis(
        vertices_on_cell, order, axis=1)

    # edges: consecutive ring vertices, deduplicated in first-seen
    # order (ring-major scan like the sequential version)
    kidx = np.arange(max_edges)[None, :]
    valid = kidx < n_edges_on_cell[:, None]
    nxt = np.where(kidx + 1 < n_edges_on_cell[:, None], kidx + 1, 0)
    v1 = vertices_on_cell
    v2 = np.take_along_axis(vertices_on_cell, nxt, axis=1)
    flat_ok = valid.reshape(-1)
    v1f = v1.reshape(-1)[flat_ok].astype(np.int64)
    v2f = v2.reshape(-1)[flat_ok].astype(np.int64)
    ccf = np.repeat(np.arange(n_cells), max_edges)[flat_ok]
    lo = np.minimum(v1f, v2f)
    hi = np.maximum(v1f, v2f)
    first_idx, edge_rank = _first_seen_unique(lo * (1 << 32) + hi)
    n_edges = len(first_idx)
    edges_on_cell = np.full((n_cells, max_edges), -1, np.int32)
    edges_on_cell.reshape(-1)[flat_ok] = edge_rank
    vertices_on_edge = np.stack(
        [v1f[first_idx], v2f[first_idx]], axis=1).astype(np.int32)
    # each spherical edge is scanned by exactly two cells: the
    # first-seen cell is column 0, the other column 1
    by_edge = np.argsort(edge_rank, kind="stable")
    cells_sorted = ccf[by_edge].astype(np.int32)
    cells_on_edge = cells_sorted.reshape(n_edges, 2)

    # cells_on_cell via the shared edge
    eoc_safe = np.maximum(edges_on_cell, 0)
    ce = cells_on_edge[eoc_safe]                     # [nC, me, 2]
    own = np.arange(n_cells, dtype=np.int32)[:, None]
    cells_on_cell = np.where(ce[..., 0] == own, ce[..., 1],
                             ce[..., 0])
    cells_on_cell = np.where(edges_on_cell >= 0, cells_on_cell, -1)

    # edges_on_vertex: e-major scan order per vertex
    ev_v = vertices_on_edge.reshape(-1)
    ev_e = np.repeat(np.arange(n_edges, dtype=np.int32), 2)
    by_v = np.argsort(ev_v, kind="stable")
    vcounts = np.bincount(ev_v, minlength=n_vertices)
    vstarts = np.concatenate([[0], np.cumsum(vcounts)])
    vslot = np.arange(len(ev_v)) - vstarts[ev_v[by_v]]
    keep = vslot < vertex_degree
    edges_on_vertex = np.full((n_vertices, vertex_degree), -1,
                              np.int32)
    edges_on_vertex[ev_v[by_v][keep], vslot[keep]] = ev_e[by_v][keep]

    # geometry (vectorized)
    cell_xyz = pts * radius
    vxyz = vert_xyz * radius
    mve = vert_xyz[vertices_on_edge[:, 0]] + \
        vert_xyz[vertices_on_edge[:, 1]]
    mve /= np.linalg.norm(mve, axis=-1, keepdims=True)
    edge_xyz = mve * radius
    dv_edge = radius * np.arccos(np.clip(
        (vert_xyz[vertices_on_edge[:, 0]] *
         vert_xyz[vertices_on_edge[:, 1]]).sum(-1), -1, 1))
    dc_edge = np.where(
        cells_on_edge[:, 1] >= 0,
        radius * np.arccos(np.clip(
            (pts[cells_on_edge[:, 0]] *
             pts[np.maximum(cells_on_edge[:, 1], 0)]).sum(-1),
            -1, 1)),
        0.0)

    # polygon areas, batched per ring size (pentagons + hexagons)
    area_cell = np.zeros(n_cells)
    for ne in np.unique(n_edges_on_cell):
        rows = np.nonzero(n_edges_on_cell == ne)[0]
        rings = vertices_on_cell[rows, :ne]
        area_cell[rows] = _spherical_polygon_area(
            vert_xyz[rings], radius)

    # dual triangle areas + kites
    area_triangle = _spherical_polygon_area(pts[cells_on_vertex],
                                            radius)
    kite = np.repeat(area_triangle[:, None] / vertex_degree,
                     vertex_degree, axis=1)

    lat_cell = np.arcsin(np.clip(pts[:, 2], -1, 1))
    lon_cell = np.mod(np.arctan2(pts[:, 1], pts[:, 0]), 2 * np.pi)
    lat_vertex = np.arcsin(np.clip(vert_xyz[:, 2], -1, 1))
    lon_vertex = np.mod(np.arctan2(vert_xyz[:, 1], vert_xyz[:, 0]),
                        2 * np.pi)

    mesh = Mesh(
        n_cells=n_cells, n_vertices=n_vertices, n_edges=n_edges,
        max_edges=max_edges, vertex_degree=vertex_degree,
        on_sphere=True, sphere_radius=radius,
        vertices_on_cell=vertices_on_cell,
        n_edges_on_cell=n_edges_on_cell,
        cells_on_vertex=cells_on_vertex,
        edges_on_cell=edges_on_cell,
        cells_on_cell=cells_on_cell,
        cells_on_edge=cells_on_edge,
        vertices_on_edge=vertices_on_edge,
        edges_on_vertex=edges_on_vertex,
        x_cell=cell_xyz[:, 0], y_cell=cell_xyz[:, 1],
        z_cell=cell_xyz[:, 2],
        x_vertex=vxyz[:, 0], y_vertex=vxyz[:, 1], z_vertex=vxyz[:, 2],
        x_edge=edge_xyz[:, 0], y_edge=edge_xyz[:, 1],
        lat_cell=lat_cell, lon_cell=lon_cell,
        lat_vertex=lat_vertex, lon_vertex=lon_vertex,
        area_cell=area_cell, area_triangle=area_triangle,
        kite_areas_on_vertex=kite,
        dv_edge=dv_edge, dc_edge=dc_edge,
        f_vertex=2.0 * c.OMEGA * np.sin(lat_vertex),
        f_cell=2.0 * c.OMEGA * np.sin(lat_cell),
    )
    return mesh.finalize()


def _hull_triangulation(pts: np.ndarray) -> np.ndarray:
    """Spherical Delaunay triangulation of unit points via the convex
    hull, with all triangles oriented outward (CCW seen from outside)."""
    from scipy.spatial import ConvexHull

    tris = ConvexHull(pts).simplices.astype(np.int64)
    a, b, t = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    outward = (np.cross(b - a, t - a) * (a + b + t)).sum(-1) > 0
    tris[~outward] = tris[~outward][:, [0, 2, 1]]
    return tris


def spherical_voronoi_mesh(subdivisions: int = 3,
                           jitter: float = 0.3,
                           lloyd_iters: int = 4,
                           seed: int = 0,
                           radius: float = c.EARTH_RADIUS) -> Mesh:
    """Genuinely unstructured global SCVT-style Voronoi mesh.

    The stand-in for a real MPAS QU mesh produced by an SCVT generator
    (the reference's QU120km meshes come from JIGSAW/MPAS-Tools): start
    from quasi-uniform icosahedral generator points, perturb each
    tangentially by `jitter` * local-spacing (destroying the panel /
    raster structure entirely — no shift-based fast path can engage),
    then Lloyd-relax toward centroidal Voronoi so cell quality matches
    an SCVT mesh.  The dual is rebuilt from the convex-hull Delaunay
    triangulation of the final points, so the connectivity is generic.
    """
    pts, tris = _icosahedron()
    for _ in range(subdivisions):
        pts, tris = _subdivide(pts, tris)
    n = len(pts)
    spacing = np.sqrt(4.0 * np.pi / n)   # mean point spacing (unit sphere)

    rng = np.random.default_rng(seed)
    if jitter > 0.0:
        d = rng.standard_normal((n, 3))
        d -= pts * (d * pts).sum(-1, keepdims=True)   # tangential
        nrm = np.linalg.norm(d, axis=-1, keepdims=True)
        d /= np.where(nrm > 0, nrm, 1.0)
        amp = jitter * spacing * rng.random((n, 1))
        pts = pts + amp * d
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)

    for _ in range(lloyd_iters):
        tris = _hull_triangulation(pts)
        cc = _circumcenter(pts[tris[:, 0]], pts[tris[:, 1]],
                           pts[tris[:, 2]])
        # generator -> mean of surrounding circumcenters (≈ centroid)
        acc = np.zeros_like(pts)
        cnt = np.zeros(n)
        for k in range(3):
            np.add.at(acc, tris[:, k], cc)
            np.add.at(cnt, tris[:, k], 1.0)
        pts = acc / cnt[:, None]
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)

    return delaunay_dual_mesh(pts, _hull_triangulation(pts), radius)
