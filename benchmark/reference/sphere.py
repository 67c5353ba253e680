"""The reference's input mesh: the Voronoi dual of an icosahedron bisected
`subdivisions` times, on a sphere of the Earth's radius.

Each generator of the bisected icosahedron is a cell; the circumcentre of
each of its triangles is a vertex, shared by the triangle's three cells.
Connectivity, lengths and areas are worked out here from the positions
alone:
  * a cell's vertices run counter-clockwise seen from outside;
  * edge k of a cell joins its vertices k and k+1 and separates it from
    cellsOnCell[k]; an edge's cells are (the cell that found it first,
    the other), its vertices the finding cell's vertices k and k+1;
  * areaCell is the spherical polygon's area, areaTriangle that of the
    triangle of the three cell centres around a vertex, dcEdge and dvEdge
    great-circle arcs (the MPAS mesh fields of those names).
Numbering is this module's own: the comparison matches the program's
entities to these by position."""

from __future__ import annotations

import dataclasses

import numpy as np

EARTH_RADIUS = 6371229.0
OMEGA = 7.29212e-5


@dataclasses.dataclass
class SphereMesh:
    radius: float
    cell_xyz: np.ndarray          # [nc, 3] m
    vertex_xyz: np.ndarray        # [nv, 3] m
    n_corners: np.ndarray         # [nc]
    vertices_on_cell: np.ndarray  # [nc, 6], -1 past n_corners
    cells_on_cell: np.ndarray     # [nc, 6], -1 past n_corners
    edges_on_cell: np.ndarray     # [nc, 6], -1 past n_corners
    cells_on_vertex: np.ndarray   # [nv, 3]
    cells_on_edge: np.ndarray     # [ne, 2]
    vertices_on_edge: np.ndarray  # [ne, 2]
    area_cell: np.ndarray
    area_triangle: np.ndarray
    dc_edge: np.ndarray
    dv_edge: np.ndarray

    @property
    def n_cells(self):
        return len(self.cell_xyz)

    @property
    def n_vertices(self):
        return len(self.vertex_xyz)

    @property
    def lat_cell(self):
        return np.arcsin(np.clip(self.cell_xyz[:, 2] / self.radius, -1, 1))

    @property
    def lon_cell(self):
        return np.mod(np.arctan2(self.cell_xyz[:, 1], self.cell_xyz[:, 0]),
                      2 * np.pi)

    @property
    def f_vertex(self):
        """The Coriolis parameter 2 Omega sin(latitude) at the vertices."""
        return 2.0 * OMEGA * self.vertex_xyz[:, 2] / self.radius


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _arc(a, b):
    """Angle between unit vectors, accurate for short arcs."""
    return np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1),
                      (a * b).sum(-1))


def _triangle_excess(a, b, c):
    """Spherical excess of triangles of unit vectors (Van Oosterom and
    Strackee)."""
    num = np.abs((a * np.cross(b, c)).sum(-1))
    den = 1.0 + (a * b).sum(-1) + (b * c).sum(-1) + (c * a).sum(-1)
    return 2.0 * np.arctan2(num, den)


def icosahedron_bisected(subdivisions: int):
    """(unit generators [n, 3], triangles [m, 3]) of an icosahedron whose
    triangles are split into four, `subdivisions` times, each new point
    the normalised midpoint of an edge."""
    from scipy.spatial import ConvexHull
    g = (1.0 + 5.0 ** 0.5) / 2.0
    pts = np.array([[s1, s2 * g, 0.0] for s1 in (-1, 1) for s2 in (-1, 1)]
                   + [[0.0, s1, s2 * g] for s1 in (-1, 1) for s2 in (-1, 1)]
                   + [[s2 * g, 0.0, s1] for s1 in (-1, 1) for s2 in (-1, 1)])
    pts = _unit(pts)
    tris = ConvexHull(pts).simplices.astype(np.int64)
    for _ in range(subdivisions):
        pairs = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                tris[:, [2, 0]]])
        keys = np.sort(pairs, axis=1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        mid = len(pts) + inv.reshape(3, -1)
        pts = np.concatenate([pts, _unit(pts[uniq[:, 0]] + pts[uniq[:, 1]])])
        a, b, c = tris.T
        ab, bc, ca = mid
        tris = np.concatenate([np.stack([a, ab, ca], 1),
                               np.stack([b, bc, ab], 1),
                               np.stack([c, ca, bc], 1),
                               np.stack([ab, bc, ca], 1)])
    return pts, tris


def build(subdivisions: int, radius: float = EARTH_RADIUS) -> SphereMesh:
    pts, tris = icosahedron_bisected(subdivisions)
    nc, nv = len(pts), len(tris)
    # vertices: circumcentres, on the side of the triangle
    a, b, c = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    vx = _unit(np.cross(b - a, c - a))
    vx *= np.sign((vx * (a + b + c)).sum(-1))[:, None]

    # each cell's triangles, counter-clockwise about its outward normal
    flat_c = tris.reshape(-1)
    flat_t = np.repeat(np.arange(nv), 3)
    order = np.argsort(flat_c, kind="stable")
    counts = np.bincount(flat_c, minlength=nc)
    me = int(counts.max())
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(flat_c)) - np.repeat(start, counts)
    voc = np.full((nc, me), -1, np.int64)
    voc[flat_c[order], slot] = flat_t[order]
    ref = np.where(np.abs(pts[:, 2:3]) < 0.9, [[0.0, 0.0, 1.0]],
                   [[1.0, 0.0, 0.0]])
    e1 = _unit(np.cross(ref, pts))
    e2 = np.cross(pts, e1)
    vp = vx[np.maximum(voc, 0)]
    ang = np.arctan2((vp * e2[:, None]).sum(-1), (vp * e1[:, None]).sum(-1))
    ang = np.where(voc >= 0, ang, np.inf)
    voc = np.take_along_axis(voc, np.argsort(ang, axis=1), axis=1)

    # the cell across each corner pair k, k+1: the two triangles' other
    # common generator
    k = np.arange(me)[None, :]
    valid = k < counts[:, None]
    nxt = np.where(k + 1 < counts[:, None], k + 1, 0)
    t1 = np.maximum(voc, 0)
    t2 = np.take_along_axis(t1, nxt, axis=1)
    own = np.arange(nc)[:, None, None]
    g1 = tris[t1]                                   # [nc, me, 3]
    g2 = tris[t2]
    common = (g1[..., :, None] == g2[..., None, :]).any(-1) & \
        (g1 != own)
    coc = np.where(valid, np.take_along_axis(
        g1, common.argmax(-1)[..., None], axis=-1)[..., 0], -1)

    # edges: unordered cell pairs, numbered by first finding
    cc = np.repeat(np.arange(nc), me)[valid.reshape(-1)]
    nb = coc[valid]
    key = np.minimum(cc, nb) * nc + np.maximum(cc, nb)
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    eoc = np.full((nc, me), -1, np.int64)
    eoc[valid] = inv
    coe = np.stack([cc[first], nb[first]], 1)
    voe = np.stack([t1[valid][first], t2[valid][first]], 1)

    ok = voc >= 0
    ring_v = vx[np.maximum(voc, 0)]
    ring_n = np.take_along_axis(ring_v, nxt[..., None], axis=1)
    exc = _triangle_excess(np.broadcast_to(pts[:, None], ring_v.shape),
                           ring_v, ring_n)
    area_cell = (np.where(ok, exc, 0.0)).sum(1) * radius ** 2
    area_tri = _triangle_excess(a, b, c) * radius ** 2
    return SphereMesh(
        radius=radius, cell_xyz=pts * radius, vertex_xyz=vx * radius,
        n_corners=counts, vertices_on_cell=voc, cells_on_cell=coc,
        edges_on_cell=eoc, cells_on_vertex=tris, cells_on_edge=coe,
        vertices_on_edge=voe, area_cell=area_cell, area_triangle=area_tri,
        dc_edge=radius * _arc(pts[coe[:, 0]], pts[coe[:, 1]]),
        dv_edge=radius * _arc(vx[voe[:, 0]], vx[voe[:, 1]]))
