"""Rhombic-panel structure of the icosahedral mesh.

An answer to the unstructured-gather problem for the global
(quasi-uniform hex) workload: the n-times-subdivided icosahedron is 10
logically-rectangular rhombic panels of N x N cells (N = 2^s) plus the
two pole cells; MPAS vertices (triangles) are exactly [panel, i, j, 2].
On that layout the EVP corner "gathers" (reference hot loops
`mpas_seaice_velocity_solver_variational.F:575-670,1064-1184`) are
STATIC SHIFTS of panel arrays (fixed flat offsets that neighbouring GPU
threads read at neighbouring addresses) instead of per-index gathers,
with only a thin seam/ghost exchange (O(N) indices instead of O(N^2))
and a 12-cell exception path (2 poles, 10 pentagons).

Construction is purely combinatorial: the subdivision is re-run with
integer lattice-coordinate tracking (same deterministic point ids as
`sphere.icosahedral_mesh`), then every cell/vertex gets a (panel,i,j)
home, corner rings are aligned to the uniform slot pattern, and the
seam ghost tables are derived from the actual mesh connectivity (so
correctness never depends on geometric reasoning about seams).

Slot pattern (derived from the up/down triangle lattice; cell array
position (I,J) = lattice (I+1, J), vertex array = lattice min-corner):
  cell (I,J) corner slot k -> vertex array position (I+di, J+dj, t):
    slot 0: (+1,  0, 0)   slot 1: ( 0,  0, 0)   slot 2: (+1, -1, 0)
    slot 3: ( 0,  0, 1)   slot 4: (+1, -1, 1)   slot 5: ( 0, -1, 1)
  vertex (I,J,0) <- cells (I-1,J) s0, (I,J) s1, (I-1,J+1) s2
  vertex (I,J,1) <- cells (I,J) s3, (I-1,J+1) s4, (I,J+1) s5
Ghosts: vertex reads spill to i=N and j=-1; cell reads (divergence)
spill to i=-1 and j=N.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..diagnostics import span
from .sphere import _icosahedron

# corner slot offsets: (di, dj, t) such that the corner vertex of the
# cell at array position (I, J), slot k, lives at vertex array
# position (I + di, J + dj, t)
CORNER_OFFSETS = ((1, 0, 0), (0, 0, 0), (1, -1, 0),
                  (0, 0, 1), (1, -1, 1), (0, -1, 1))


def _subdivide_tracked(s: int):
    """Re-run sphere._subdivide's exact id assignment, additionally
    tracking each point's integer lattice coordinates on each ORIGINAL
    icosahedron face it lies on.

    Returns (n_points, faces, coords) where faces is the final
    triangle list [nTri, 3] with a parallel array orig_face [nTri],
    and coords[orig_face] is {point_id: (a, b)} with (a, b) the
    lattice coordinates scaled to N = 2^s (face corners at (0,0),
    (N,0), (0,N))."""
    v0, f0 = _icosahedron()
    N = 2 ** s
    n_pts = len(v0)
    faces = [tuple(face) for face in f0]
    orig = list(range(len(f0)))
    coords: List[Dict[int, Tuple[int, int]]] = [dict() for _ in f0]
    for fi, (a, b, c) in enumerate(f0):
        coords[fi][a] = (0, 0)
        coords[fi][b] = (N, 0)
        coords[fi][c] = (0, N)

    corner_coords = [((0, 0), (N, 0), (0, N))] * len(f0)

    for _level in range(s):
        edge_mid: Dict[Tuple[int, int], int] = {}
        new_faces = []
        new_orig = []
        new_cc = []

        def midpoint(a, b):
            nonlocal n_pts
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                edge_mid[key] = n_pts
                n_pts += 1
            return edge_mid[key]

        for (a, b, c), fi, (ca, cb, cc_) in zip(faces, orig,
                                                corner_coords):
            ab = midpoint(a, b)
            bc = midpoint(b, c)
            ca_ = midpoint(c, a)
            cab = ((ca[0] + cb[0]) // 2, (ca[1] + cb[1]) // 2)
            cbc = ((cb[0] + cc_[0]) // 2, (cb[1] + cc_[1]) // 2)
            cca = ((cc_[0] + ca[0]) // 2, (cc_[1] + ca[1]) // 2)
            for p, cp in ((ab, cab), (bc, cbc), (ca_, cca)):
                coords[fi][p] = cp
            new_faces += [(a, ab, ca_), (b, bc, ab), (c, ca_, bc),
                          (ab, bc, ca_)]
            new_orig += [fi, fi, fi, fi]
            new_cc += [(ca, cab, cca), (cb, cbc, cab),
                       (cc_, cca, cbc), (cab, cbc, cca)]
        faces, orig, corner_coords = new_faces, new_orig, new_cc

    return (n_pts, np.array(faces, np.int64), np.array(orig, np.int64),
            coords)


# The 10 rhombi: (upper face, lower face) pairs of original-icosahedron
# faces that share an edge.  Upper faces are the 5 north-cap + the 5
# south-cap faces' partners; derived programmatically in build.
def _rhombus_pairs(f0: np.ndarray):
    """Pair the 20 faces into 10 edge-sharing rhombi: each north-cap
    face (containing vertex 0) pairs with the unique middle face
    sharing its opposite edge, and each south-cap face (vertex 3)
    likewise."""
    faces = [tuple(f) for f in f0]
    pairs = []
    used = set()
    for fi, f in enumerate(faces):
        if 0 not in f and 3 not in f:
            continue
        apex = 0 if 0 in f else 3
        others = tuple(x for x in f if x != apex)
        # find the face sharing the opposite edge
        for gi, g in enumerate(faces):
            if gi == fi or gi in used or 0 in g or 3 in g:
                continue
            if others[0] in g and others[1] in g:
                pairs.append((fi, gi, apex))
                used.add(fi)
                used.add(gi)
                break
    assert len(pairs) == 10, pairs
    return pairs


def _face_maps(f0, pairs, swaps, N):
    """Affine lattice->rhombus corner maps for every original face."""
    face_rhombus = np.full(len(f0), -1, np.int64)
    face_corner_rc: List[Optional[np.ndarray]] = [None] * len(f0)
    for r, (fu, fl, apex) in enumerate(pairs):
        cu = [int(x) for x in f0[fu]]
        X, Y = [x for x in cu if x != apex]
        if swaps[r]:
            X, Y = Y, X
        face_rhombus[fu] = r
        face_rhombus[fl] = r
        rc_u = {apex: (0, 0), X: (N, 0), Y: (0, N)}
        cl = [int(x) for x in f0[fl]]
        Z = [x for x in cl if x not in (X, Y)][0]
        rc_l = {X: (N, 0), Y: (0, N), Z: (N, N)}
        face_corner_rc[fu] = np.array([rc_u[c] for c in f0[fu]], float)
        face_corner_rc[fl] = np.array([rc_l[c] for c in f0[fl]], float)
    return face_rhombus, face_corner_rc


def _find_consistent_orientation(f0, pairs) -> Tuple[bool, ...]:
    """Search the 2^10 per-rhombus X/Y assignments for one where the
    {1<=i<=N, 0<=j<N} ownership blocks tile all non-pole points exactly
    once.  Done at N=2 (the structure is scale-invariant); cached."""
    key = "_cached_orientation"
    if key in globals():
        return globals()[key]
    n_pts, _tris, _orig, coords = _subdivide_tracked(1)
    N = 2
    import itertools
    for swaps in itertools.product((False, True), repeat=10):
        face_rhombus, face_corner_rc = _face_maps(f0, pairs, swaps, N)
        homes = {}
        ok = True
        for fi in range(len(f0)):
            for pid, (a, b) in coords[fi].items():
                w = np.array([1.0 - (a + b) / N, a / N, b / N])
                ij = np.rint(w @ face_corner_rc[fi]).astype(int)
                i, j = int(ij[0]), int(ij[1])
                if 1 <= i <= N and 0 <= j < N:
                    r = int(face_rhombus[fi])
                    prev = homes.get(pid)
                    if prev is not None and prev != (r, i, j):
                        ok = False
                        break
                    homes[pid] = (r, i, j)
            if not ok:
                break
        if ok and len(homes) == 10 * N * N:
            globals()[key] = swaps
            return swaps
    raise AssertionError("no consistent rhombus orientation found")


@dataclasses.dataclass
class PanelLayout:
    """Panel addressing of an icosahedral mesh (host-side numpy).

    Cell (p, i, j) and vertex (p, i, j, t) homes; plus the tables the
    shift-based EVP kernels need.  All index arrays refer to MESH ids
    (cells/vertices of the Mesh object this layout was built from)."""
    N: int
    n_cells: int
    n_vertices: int
    cell_slot: np.ndarray        # [10, N, N] -> cell id
    pole_cells: np.ndarray       # [2] cell ids not in any panel
    vert_slot: np.ndarray        # [10, N, N, 2] -> vertex id
    # ring->slot alignment: slot_of_ring[c, r] = pattern slot of the
    # cell's ring-position-r corner (-1 beyond the ring)
    slot_of_ring: np.ndarray     # [nCells, maxEdges]
    cell_of: np.ndarray          # [nCells, 3] (p, i, j); -1 for poles
    vert_of: np.ndarray          # [nVertices, 4] (p, i, j, t)
    # ghost tables: low-side vertex ghosts (positions i=-1 or j=-1)
    # needed by the corner shifts, and high-side cell ghosts
    # (i=N or j=N) needed by the divergence shifts
    ghost_vert_pos: np.ndarray   # [nGV, 4] (p, gi, gj, t) with -1 idx
    ghost_vert_id: np.ndarray    # [nGV] vertex ids
    # divergence ghost table: reader-frame (slot, p, gi, gj) <-
    # (cell, owner-frame slot)
    ghost_pu_pos: np.ndarray     # [nGP, 4] (slot, p, gi, gj)
    ghost_pu_src: np.ndarray     # [nGP, 2] (cell, owner slot)
    # the 12 cells (2 poles + 10 panel-corner pentagons) whose rings
    # span a 5-fold original corner: they run on a tiny gather/scatter
    # exception path instead of the shift pattern
    exception_cells: np.ndarray = None


def build_panel_layout(mesh, subdivisions: int) -> PanelLayout:
    """Derive the panel structure of `icosahedral_mesh(subdivisions)`.

    Everything is asserted against the actual mesh connectivity; a
    failed assertion means the mesh did not come from the generator
    (or the generator changed)."""
    N = 2 ** subdivisions
    n_pts, tris, tri_orig, coords = _subdivide_tracked(subdivisions)
    if n_pts != mesh.n_cells or len(tris) != mesh.n_vertices:
        raise ValueError("mesh is not icosahedral_mesh(subdivisions)")
    if not np.array_equal(np.asarray(mesh.cells_on_vertex),
                          tris.astype(np.int32)):
        raise ValueError("mesh triangle ids do not match the "
                         "tracked subdivision")

    _, f0 = _icosahedron()
    pairs = _rhombus_pairs(f0)
    apexes = sorted({p[2] for p in pairs})
    assert apexes == [0, 3]

    # Ownership convention: every rhombus owns the lattice block
    # {1<=i<=N, 0<=j<N} (its apex->X and X->Z boundary edges), stored
    # at array position (i-1, j).  For the tiling to be exact, each
    # seam must pair an owned edge with an unowned one — which pins
    # down, per rhombus, WHICH of its two non-apex corners is X.  The
    # consistent orientation is found once by search at N=2 (purely
    # combinatorial, scale-invariant) and reused for any N.
    swaps = _find_consistent_orientation(f0, pairs)

    face_rhombus, face_corner_rc = _face_maps(f0, pairs, swaps, N)

    # integer corner tables: all chart positions are exact lattice
    # points, so the barycentric evaluation is exact integer
    # arithmetic scaled by N (no float rint/allclose per call — these
    # two evaluators dominated layout-build time at QU-class sizes)
    fcr_i = [[(int(round(x)), int(round(y))) for x, y in fc]
             for fc in face_corner_rc]

    def _bary_int(a, b, corners):
        (i0, j0), (i1, j1), (i2, j2) = corners
        w0 = N - a - b
        iN = w0 * i0 + a * i1 + b * i2
        jN = w0 * j0 + a * j1 + b * j2
        assert iN % N == 0 and jN % N == 0
        return iN // N, jN // N

    def to_rhombus(fi, ab):
        """Face-lattice (a, b) -> rhombus lattice (i, j) (integer)."""
        a, b = ab
        return _bary_int(a, b, fcr_i[fi])

    cell_slot = np.full((10, N, N), -1, np.int64)
    cell_of = np.full((mesh.n_cells, 3), -1, np.int64)
    for fi in range(len(f0)):
        r = int(face_rhombus[fi])
        for pid, ab in coords[fi].items():
            i, j = to_rhombus(fi, ab)
            if 1 <= i <= N and 0 <= j < N:
                prev = cell_slot[r, i - 1, j]
                assert prev in (-1, pid), (r, i, j, prev, pid)
                cell_slot[r, i - 1, j] = pid
                cell_of[pid] = (r, i - 1, j)
    assert (cell_slot >= 0).all()
    owned, counts = np.unique(cell_slot, return_counts=True)
    assert (counts == 1).all()
    pole_cells = np.setdiff1d(np.arange(mesh.n_cells), owned)
    assert len(pole_cells) == 2, pole_cells

    # --- vertex (triangle) homes: array position = lattice
    # min-corner; up triangle {(i,j),(i+1,j),(i,j+1)} -> (i, j, 0),
    # down {(i+1,j),(i,j+1),(i+1,j+1)} -> (i, j, 1) ---
    vert_slot = np.full((10, N, N, 2), -1, np.int64)
    vert_of = np.full((mesh.n_vertices, 4), -1, np.int64)
    for t in range(len(tris)):
        fi = int(tri_orig[t])
        r = int(face_rhombus[fi])
        cs = [to_rhombus(fi, coords[fi][int(p)]) for p in tris[t]]
        imin = min(c[0] for c in cs)
        jmin = min(c[1] for c in cs)
        rel = sorted((c[0] - imin, c[1] - jmin) for c in cs)
        if rel == [(0, 0), (0, 1), (1, 0)]:
            i, j, tt = imin, jmin, 0
        elif rel == [(0, 1), (1, 0), (1, 1)]:
            i, j, tt = imin, jmin, 1
        else:
            raise AssertionError((t, cs))
        assert 0 <= i < N and 0 <= j < N, (t, i, j)
        assert vert_slot[r, i, j, tt] == -1
        vert_slot[r, i, j, tt] = t
        vert_of[t] = (r, i, j, tt)
    assert (vert_slot >= 0).all()

    # --- cell corner-slot assignment via the dual relation ---
    # vertex at array (p,I,J,0) has cells at array positions
    # (I-1,J) s0, (I,J) s1, (I-1,J+1) s2; t=1: (I,J) s3, (I-1,J+1)
    # s4, (I,J+1) s5 — derive each cell's slot for each of its corner
    # vertices, including seam/pole cells, purely combinatorially.
    slot_positions = {
        0: ((-1, 0, 0), (0, 0, 1), (-1, 1, 2)),
        1: ((0, 0, 3), (-1, 1, 4), (0, 1, 5)),
    }
    # -- chart machinery: positions of any face's corners in a given
    # rhombus's lattice chart, extended one face beyond its seams by
    # the parallelogram gluing (triangles ABC_fi / ABC_fj across a
    # shared edge AB form a lattice parallelogram: C_fj -> A + B - C_fi)
    rhombus_faces = [(fu, fl) for (fu, fl, _apex) in pairs]
    chart_cache: Dict[Tuple[int, int], Optional[np.ndarray]] = {}

    def chart_corners(fv: int, p: int) -> Optional[np.ndarray]:
        """[3, 2] lattice positions of f0[fv]'s corners in rhombus p's
        chart, or None if fv only touches p's faces at a corner."""
        key = (fv, p)
        if key in chart_cache:
            return chart_cache[key]
        out = None
        if face_rhombus[fv] == p:
            out = face_corner_rc[fv]
        else:
            for fi in rhombus_faces[p]:
                shared = set(int(x) for x in f0[fv]) & \
                    set(int(x) for x in f0[fi])
                if len(shared) != 2:
                    continue
                pos_fi = {int(c): face_corner_rc[fi][k]
                          for k, c in enumerate(f0[fi])}
                third_fi = [int(c) for c in f0[fi]
                            if int(c) not in shared][0]
                a, b = sorted(shared)
                reflect = (pos_fi[a] + pos_fi[b] - pos_fi[third_fi])
                third_fv = [int(c) for c in f0[fv]
                            if int(c) not in shared][0]
                pos = {a: pos_fi[a], b: pos_fi[b], third_fv: reflect}
                out = np.array([pos[int(c)] for c in f0[fv]], float)
                break
        chart_cache[key] = out
        return out

    chart_int_cache: Dict[Tuple[int, int], Optional[list]] = {}

    def chart_corners_int(fv: int, p: int):
        key = (fv, p)
        if key not in chart_int_cache:
            cc = chart_corners(fv, p)
            chart_int_cache[key] = None if cc is None else \
                [(int(round(x)), int(round(y))) for x, y in cc]
        return chart_int_cache[key]

    def tri_in_chart(t: int, p: int):
        """Vertex (triangle) t's array position (i, j, up/down) in
        rhombus p's chart, or None (non-adjacent face)."""
        fv = int(tri_orig[t])
        cc = chart_corners_int(fv, p)
        if cc is None:
            return None
        cs = []
        for c in tris[t]:
            a, b = coords[fv][int(c)]
            cs.append(_bary_int(a, b, cc))
        imin = min(x[0] for x in cs)
        jmin = min(x[1] for x in cs)
        rel = sorted((x[0] - imin, x[1] - jmin) for x in cs)
        if rel == [(0, 0), (0, 1), (1, 0)]:
            return imin, jmin, 0
        if rel == [(0, 1), (1, 0), (1, 1)]:
            return imin, jmin, 1
        return None                   # reflected: inconsistent chart

    # --- pass A (cell frame): per-cell corner slots + ghost-vertex
    # table.  Cells whose ring spans a 5-fold original corner (the 10
    # panel-corner pentagons) cannot follow the regular pattern and
    # join the pole cells on the exception (gather) path. ---
    voc = np.asarray(mesh.vertices_on_cell)
    neoc = np.asarray(mesh.n_edges_on_cell)
    me = mesh.max_edges
    slot_of_ring = np.full((mesh.n_cells, me), -1, np.int64)
    offset_slot = {(di, dj, t): k
                   for k, (di, dj, t) in enumerate(CORNER_OFFSETS)}
    exception_cells = list(int(x) for x in pole_cells)
    ghost_vert: Dict[Tuple[int, int, int, int], set] = {}
    for c in range(mesh.n_cells):
        p, I, J = (int(x) for x in cell_of[c])
        if p < 0:
            continue                  # pole cell
        ring = [int(voc[c, r]) for r in range(neoc[c])]
        assign = {}
        ok = True
        for r, v in enumerate(ring):
            pos = tri_in_chart(v, p)
            if pos is None:
                ok = False
                break
            vi, vj, t = pos
            # vertex array pos = lattice min-corner; CORNER_OFFSETS is
            # defined on array coords: offset = (vi - I, vj - J)
            k = offset_slot.get((vi - I, vj - J, t))
            if k is None or k in assign.values():
                ok = False
                break
            assign[r] = (k, vi, vj, t)
        if not ok:
            exception_cells.append(c)
            continue
        for r, (k, vi, vj, t) in assign.items():
            slot_of_ring[c, r] = k
            v = ring[r]
            if 0 <= vi < N and 0 <= vj < N:
                assert int(vert_slot[p, vi, vj, t]) == v, (c, r, v)
            else:
                ghost_vert.setdefault((p, vi, vj, t), set()).add(v)

    exception_cells = np.array(sorted(set(exception_cells)), np.int64)
    assert len(exception_cells) == 12, len(exception_cells)
    exc_set = set(int(x) for x in exception_cells)

    # --- pass B (vertex frame): slot-aware ghost table for the
    # divergence shifts.  A vertex reading a cross-seam cell needs that
    # cell's contribution AT THE CORNER THE VERTEX IS, i.e. indexed by
    # the OWNER-frame slot (frames rotate across seams, so the reader-
    # frame slot s and owner-frame slot s' differ): each entry is
    # (reader slot s, ghost position) <- (cell, owner slot s').
    # Exception cells feed the divergence through a dedicated scatter
    # instead and are skipped here. ---
    ring_pos = {}
    for c in range(mesh.n_cells):
        for r in range(neoc[c]):
            ring_pos[(c, int(voc[c, r]))] = r
    ghost_pu: Dict[Tuple[int, int, int, int], Tuple[int, int]] = {}
    for t in range(len(tris)):
        p, I, J, tt = vert_of[t]
        fi = int(tri_orig[t])
        pos_by_cell = {}
        for c in tris[t]:
            ci, cj = to_rhombus(fi, coords[fi][int(c)])
            pos_by_cell[(ci - 1, cj)] = int(c)   # cell array position
        for (di, dj, slot) in slot_positions[int(tt)]:
            ci, cj = int(I + di), int(J + dj)
            cid = pos_by_cell.get((ci, cj))
            assert cid is not None, (t, (ci, cj), pos_by_cell)
            if ci >= 0 and cj < N:
                assert int(cell_slot[p, ci, cj]) == cid, \
                    (t, cid, (p, ci, cj))
                continue
            if cid in exc_set:
                continue
            sp = int(slot_of_ring[cid, ring_pos[(cid, t)]])
            assert sp >= 0, (cid, t)
            key = (slot, int(p), ci, cj)
            assert ghost_pu.get(key, (cid, sp)) == (cid, sp), \
                (key, ghost_pu[key], (cid, sp))
            ghost_pu[key] = (cid, sp)
    gp_pos = []
    gp_src = []
    for key, (cid, sp) in sorted(ghost_pu.items()):
        gp_pos.append(key)
        gp_src.append((cid, sp))
    gv_pos = []
    gv_id = []
    for key, ids in sorted(ghost_vert.items()):
        assert len(ids) == 1, (key, ids)
        gv_pos.append(key)
        gv_id.append(ids.pop())

    return PanelLayout(
        N=N, n_cells=mesh.n_cells, n_vertices=mesh.n_vertices,
        cell_slot=cell_slot, pole_cells=pole_cells,
        vert_slot=vert_slot, slot_of_ring=slot_of_ring,
        cell_of=cell_of, vert_of=vert_of,
        ghost_vert_pos=np.array(gv_pos, np.int64).reshape(-1, 4),
        ghost_vert_id=np.array(gv_id, np.int64),
        ghost_pu_pos=np.array(gp_pos, np.int64).reshape(-1, 4),
        ghost_pu_src=np.array(gp_src, np.int64).reshape(-1, 2),
        exception_cells=exception_cells,
    )


def permute_mesh(mesh, cell_new_of_old: np.ndarray,
                 vertex_new_of_old: np.ndarray):
    """Relabel the mesh's cells and vertices by the given permutations
    (new_of_old maps).  Edges keep their ids; derived vertex tables are
    rebuilt by finalize()."""
    c_old_of_new = np.argsort(cell_new_of_old)
    v_old_of_new = np.argsort(vertex_new_of_old)

    def pc(a):
        return None if a is None else a[c_old_of_new]

    def pv(a):
        return None if a is None else a[v_old_of_new]

    def rc(a):
        if a is None:
            return None
        return np.where(a >= 0, cell_new_of_old[np.maximum(a, 0)],
                        -1).astype(a.dtype)

    def rv(a):
        if a is None:
            return None
        return np.where(a >= 0, vertex_new_of_old[np.maximum(a, 0)],
                        -1).astype(a.dtype)

    m = dataclasses.replace(
        mesh,
        vertices_on_cell=rv(pc(mesh.vertices_on_cell)),
        n_edges_on_cell=pc(mesh.n_edges_on_cell),
        cells_on_vertex=rc(pv(mesh.cells_on_vertex)),
        edges_on_cell=pc(mesh.edges_on_cell),
        cells_on_cell=rc(pc(mesh.cells_on_cell)),
        cells_on_edge=rc(mesh.cells_on_edge),
        vertices_on_edge=rv(mesh.vertices_on_edge),
        edges_on_vertex=pv(mesh.edges_on_vertex),
        x_cell=pc(mesh.x_cell), y_cell=pc(mesh.y_cell),
        z_cell=pc(mesh.z_cell),
        x_vertex=pv(mesh.x_vertex), y_vertex=pv(mesh.y_vertex),
        z_vertex=pv(mesh.z_vertex),
        lat_cell=pc(mesh.lat_cell), lon_cell=pc(mesh.lon_cell),
        lat_vertex=pv(mesh.lat_vertex), lon_vertex=pv(mesh.lon_vertex),
        area_cell=pc(mesh.area_cell),
        area_triangle=pv(mesh.area_triangle),
        kite_areas_on_vertex=pv(mesh.kite_areas_on_vertex),
        f_vertex=pv(mesh.f_vertex), f_cell=pc(mesh.f_cell),
        cell_vertices_at_vertex=None,
        interior_vertex=None,
    )
    return m.finalize()


@span("setup.panel_reorder")
def panel_reorder(mesh, subdivisions: int):
    """Relabel an icosahedral mesh into panel-major order and rebase
    the layout: cell id = p*N^2 + i*N + j (poles last), vertex id =
    ((p*N + i)*N + j)*2 + t.  Returns (mesh, PanelLayout) with all
    layout tables expressed in the new ids."""
    lay = build_panel_layout(mesh, subdivisions)
    N = lay.N
    cell_new = np.empty(mesh.n_cells, np.int64)
    cell_new[lay.cell_slot.reshape(-1)] = np.arange(10 * N * N)
    cell_new[lay.pole_cells] = 10 * N * N + np.arange(2)
    vert_new = np.empty(mesh.n_vertices, np.int64)
    vert_new[lay.vert_slot.reshape(-1)] = np.arange(mesh.n_vertices)
    m2 = permute_mesh(mesh, cell_new, vert_new)

    so = np.full((mesh.n_cells, lay.slot_of_ring.shape[1]), -1,
                 np.int64)
    so[cell_new] = lay.slot_of_ring
    lay2 = PanelLayout(
        N=N, n_cells=mesh.n_cells, n_vertices=mesh.n_vertices,
        cell_slot=cell_new[lay.cell_slot],
        pole_cells=cell_new[lay.pole_cells],
        vert_slot=vert_new[lay.vert_slot],
        slot_of_ring=so,
        cell_of=lay.cell_of[np.argsort(cell_new)],
        vert_of=lay.vert_of[np.argsort(vert_new)],
        ghost_vert_pos=lay.ghost_vert_pos,
        ghost_vert_id=vert_new[lay.ghost_vert_id],
        ghost_pu_pos=lay.ghost_pu_pos,
        ghost_pu_src=np.stack(
            [cell_new[lay.ghost_pu_src[:, 0]],
             lay.ghost_pu_src[:, 1]], axis=1),
        exception_cells=np.sort(cell_new[lay.exception_cells]),
    )
    m2.panel_layout = lay2       # picked up by build_dynamics_tensors
    return m2, lay2
