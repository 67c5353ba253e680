"""Static mesh description.

The replacement for the reference's mesh pool
(MPAS-Seaice `src/shared/mpas_seaice_mesh.F`,
`mpas_seaice_mesh_pool.F`): a host-side `Mesh` of NumPy connectivity /
geometry arrays built once at startup, and a device-side `MeshTensors`
container of torch tensors consumed by the step.

Index convention: 0-based everywhere; invalid entries are -1 in the host
mesh. For device gathers, invalid indices are clipped to 0 and a float
mask (1.0 valid / 0.0 invalid) is carried alongside, so kernels are pure
masked dense ops (no data-dependent control flow).  Index tensors are
int64, the type torch indexes with.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..diagnostics import span
from ..utils.containers import tensor_dataclass
from ..utils.device import resolve_device


@dataclasses.dataclass
class Mesh:
    """Host-side static mesh (NumPy, float64, 0-based indices, -1 invalid)."""

    # dimensions
    n_cells: int
    n_vertices: int
    n_edges: int
    max_edges: int
    vertex_degree: int
    on_sphere: bool = False
    sphere_radius: float = 0.0
    # planar periodicity: period length, or 0.0 if not periodic in that axis
    period_x: float = 0.0
    period_y: float = 0.0

    # connectivity
    vertices_on_cell: np.ndarray = None   # [nCells, maxEdges] int32
    n_edges_on_cell: np.ndarray = None    # [nCells] int32
    cells_on_vertex: np.ndarray = None    # [nVertices, vertexDegree] int32
    edges_on_cell: np.ndarray = None      # [nCells, maxEdges] int32
    cells_on_cell: np.ndarray = None      # [nCells, maxEdges] int32
    cells_on_edge: np.ndarray = None      # [nEdges, 2] int32
    vertices_on_edge: np.ndarray = None   # [nEdges, 2] int32
    edges_on_vertex: np.ndarray = None    # [nVertices, vertexDegree] int32

    # geometry
    x_cell: np.ndarray = None
    y_cell: np.ndarray = None
    z_cell: np.ndarray = None
    x_vertex: np.ndarray = None
    y_vertex: np.ndarray = None
    z_vertex: np.ndarray = None
    x_edge: np.ndarray = None
    y_edge: np.ndarray = None
    lat_cell: np.ndarray = None
    lon_cell: np.ndarray = None
    lat_vertex: np.ndarray = None
    lon_vertex: np.ndarray = None
    area_cell: np.ndarray = None          # [nCells]
    area_triangle: np.ndarray = None      # [nVertices] dual-cell area
    kite_areas_on_vertex: np.ndarray = None  # [nVertices, vertexDegree]
    dv_edge: np.ndarray = None            # [nEdges] edge length
    dc_edge: np.ndarray = None            # [nEdges] cell-center distance
    f_vertex: np.ndarray = None           # [nVertices] Coriolis parameter
    f_cell: np.ndarray = None             # [nCells]

    # derived (filled by finalize())
    cell_vertices_at_vertex: np.ndarray = None  # [nVertices, vertexDegree]
    interior_vertex: np.ndarray = None          # [nVertices] int32 {0,1}
    x_local: np.ndarray = None                  # [nCells, maxEdges]
    y_local: np.ndarray = None                  # [nCells, maxEdges]

    def finalize(self) -> "Mesh":
        """Compute derived connectivity/geometry. Call once after building."""
        self._compute_cell_vertices_at_vertex()
        self._compute_interior_vertex()
        self._compute_local_coords()
        if self.f_vertex is None:
            self.f_vertex = np.zeros(self.n_vertices)
        if self.f_cell is None:
            self.f_cell = np.zeros(self.n_cells)
        return self

    # -- derived connectivity -------------------------------------------------

    def _compute_cell_vertices_at_vertex(self):
        """For each (vertex, surrounding-cell) pair, the local index of that
        vertex within the cell's vertex list.

        Mirrors seaice_cell_vertices_at_vertex
        (reference mpas_seaice_mesh.F:632-685); invalid -> -1.
        """
        nv, vd = self.n_vertices, self.vertex_degree
        result = np.full((nv, vd), -1, dtype=np.int32)
        cov = self.cells_on_vertex
        valid = cov >= 0
        cov_safe = np.where(valid, cov, 0)
        # voc[cov_safe] : [nVertices, vertexDegree, maxEdges]
        voc = self.vertices_on_cell[cov_safe]
        match = voc == np.arange(nv, dtype=np.int32)[:, None, None]
        has = match.any(axis=2) & valid
        local = match.argmax(axis=2).astype(np.int32)
        result[has] = local[has]
        self.cell_vertices_at_vertex = result

    def _compute_interior_vertex(self):
        """interiorVertex=1 iff all vertexDegree adjacent cells exist
        (reference mpas_seaice_mesh.F:423-488)."""
        self.interior_vertex = (
            (self.cells_on_vertex >= 0).all(axis=1).astype(np.int32))

    def _compute_local_coords(self):
        """Per-cell local 2D coordinates of the cell's vertices.

        Mirrors seaice_calc_local_coords
        (reference mpas_seaice_velocity_solver_variational_shared.F:42-279).
        Planar: vertex - cell center. Spherical: rotate then project onto the
        local tangent plane at the cell center.
        """
        voc = self.vertices_on_cell
        valid = voc >= 0
        voc_safe = np.where(valid, voc, 0)
        if not self.on_sphere:
            xl = self.x_vertex[voc_safe] - self.x_cell[:, None]
            yl = self.y_vertex[voc_safe] - self.y_cell[:, None]
            # minimum-image convention across periodic seams
            if self.period_x > 0.0:
                xl -= self.period_x * np.round(xl / self.period_x)
            if self.period_y > 0.0:
                yl -= self.period_y * np.round(yl / self.period_y)
        else:
            xc = np.stack([self.x_cell, self.y_cell, self.z_cell], axis=-1)
            xv = np.stack([self.x_vertex[voc_safe],
                           self.y_vertex[voc_safe],
                           self.z_vertex[voc_safe]], axis=-1)
            xl, yl = project_3d_onto_local_2d(xv, xc)
        self.x_local = np.where(valid, xl, 0.0)
        self.y_local = np.where(valid, yl, 0.0)

    # -- device export --------------------------------------------------------

    @span("setup.upload")
    def tensors(self, dtype=torch.float32, device=None) -> "MeshTensors":
        """Build the device-side container used by the step
        (device=None: the GPU)."""
        device = resolve_device(device)
        ne = self.n_edges_on_cell[:, None]
        k = np.arange(self.max_edges)[None, :]
        voc_mask = (k < ne) & (self.vertices_on_cell >= 0)
        cov_valid = self.cells_on_vertex >= 0

        # cell->vertex interpolation weights (area-weighted mean over the
        # surrounding cells; reference mpas_seaice_mesh.F:2833-2852)
        cov_safe = np.where(cov_valid, self.cells_on_vertex, 0)
        w = np.where(cov_valid, self.area_cell[cov_safe], 0.0)
        wsum = w.sum(axis=1, keepdims=True)
        cell_to_vertex_w = np.where(wsum > 0, w / np.maximum(wsum, 1e-300), 0.0)

        coc_valid = (self.cells_on_cell >= 0) & (k < ne)

        def fl(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
                device=device, dtype=dtype)

        def ix(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int64)).to(
                device=device)

        return MeshTensors(
            vertices_on_cell=ix(np.where(voc_mask, self.vertices_on_cell, 0)),
            vertices_on_cell_mask=fl(voc_mask),
            cells_on_vertex=ix(cov_safe),
            cells_on_vertex_mask=fl(cov_valid),
            cells_on_cell=ix(np.where(coc_valid, self.cells_on_cell, 0)),
            cells_on_cell_mask=fl(coc_valid),
            cell_vertices_at_vertex=ix(
                np.where(self.cell_vertices_at_vertex >= 0,
                         self.cell_vertices_at_vertex, 0)),
            interior_vertex=fl(self.interior_vertex),
            area_cell=fl(self.area_cell),
            area_triangle=fl(self.area_triangle),
            cell_to_vertex_w=fl(cell_to_vertex_w),
            f_vertex=fl(self.f_vertex),
        )


@tensor_dataclass
class MeshTensors:
    """Device-side mesh tensors consumed by the step."""
    vertices_on_cell: Any        # [nCells, maxEdges] int64, invalid->0
    vertices_on_cell_mask: Any   # [nCells, maxEdges] float {0,1}
    cells_on_vertex: Any         # [nVertices, vertexDegree] int64, invalid->0
    cells_on_vertex_mask: Any    # [nVertices, vertexDegree] float {0,1}
    cells_on_cell: Any           # [nCells, maxEdges] int64, invalid->0
    cells_on_cell_mask: Any      # [nCells, maxEdges] float {0,1}
    cell_vertices_at_vertex: Any  # [nVertices, vertexDegree] int64
    interior_vertex: Any         # [nVertices] float {0,1}
    area_cell: Any               # [nCells]
    area_triangle: Any           # [nVertices]
    cell_to_vertex_w: Any        # [nVertices, vertexDegree] interp weights
    f_vertex: Any                # [nVertices]

    @property
    def n_cells(self):
        return self.vertices_on_cell.shape[0]

    @property
    def n_vertices(self):
        return self.cells_on_vertex.shape[0]


def project_3d_onto_local_2d(points_3d: np.ndarray, center_3d: np.ndarray):
    """Project 3D points near a sphere-surface center onto the local tangent
    plane (reference seaice_project_3D_vector_onto_local_2D in
    mpas_seaice_mesh.F). `points_3d`: [..., 3]; `center_3d`: broadcastable.

    The local basis: e1 = unit eastward (z x r), e2 = unit northward
    (r x e1), both at the center point.
    """
    # padded/degenerate rows (all-zero centers from halo padding) must not
    # produce NaN warnings: normalize against a floored norm; their basis
    # vectors come out of the deterministic fallback below and are never
    # read (the rows are masked by the callers)
    nr = np.linalg.norm(center_3d, axis=-1, keepdims=True)
    r = center_3d / np.maximum(nr, 1e-300)
    zhat = np.array([0.0, 0.0, 1.0])
    e1 = np.cross(np.broadcast_to(zhat, r.shape), r)
    n1 = np.linalg.norm(e1, axis=-1, keepdims=True)
    # at the frame poles (r ~ +-z) east/north degenerates; fall back to a
    # deterministic tangent basis from the x axis (the reference has the
    # same singularity, placed on the true equator by the grid rotation)
    xhat = np.array([1.0, 0.0, 0.0])
    e1_fallback = np.cross(np.broadcast_to(xhat, r.shape), r)
    nf = np.linalg.norm(e1_fallback, axis=-1, keepdims=True)
    use_fb = n1 < 1e-6
    e1 = np.where(use_fb, e1_fallback / np.maximum(nf, 1e-300),
                  e1 / np.maximum(n1, 1e-300))
    e2 = np.cross(r, e1)
    if center_3d.ndim < points_3d.ndim:
        e1 = np.expand_dims(e1, axis=-2)
        e2 = np.expand_dims(e2, axis=-2)
    x = (points_3d * e1).sum(axis=-1)
    y = (points_3d * e2).sum(axis=-1)
    return x, y


def cell_to_vertex(mesh_t: MeshTensors, field_cell):
    """Area-weighted interpolation of a cell field to vertices
    (reference seaice_interpolate_cell_to_vertex, mpas_seaice_mesh.F:2760)."""
    gathered = field_cell[mesh_t.cells_on_vertex]
    return (gathered * mesh_t.cell_to_vertex_w).sum(dim=1)


def vertex_to_cell(mesh_t: MeshTensors, field_vertex):
    """Masked-mean interpolation of a vertex field to cell centers
    (reference seaice_interpolate_vertex_to_cell,
    mpas_seaice_mesh.F:2906)."""
    gathered = field_vertex[mesh_t.vertices_on_cell]
    m = mesh_t.vertices_on_cell_mask
    return (gathered * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
