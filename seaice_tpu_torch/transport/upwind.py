"""First-order upwind advection (the reference's alternative transport,
`mpas_seaice_advection_upwind.F`): finite-volume upwind fluxes of the
conserved quantities (area, volumes, and mass*tracer products) across
cell edges, using the edge-normal velocity from the mean of the edge's
two vertex velocities.  The edge geometry is built on the host in numpy
(a copy of the JAX package's builder), the step is torch.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..mesh.core import Mesh
from ..mesh.rotation import east_north_basis, grid_rotation_forward
from ..utils.containers import tensor_dataclass
from ..utils.device import resolve_device
from .remap import (_expand, from_transport_fields, mass_tracer_products,
                    to_transport_fields)
from .tracers import TracerTree


def _wrap(d, period):
    if period > 0.0:
        return d - period * np.round(d / period)
    return d


@tensor_dataclass
class UpwindTensors:
    """Static edge geometry for upwind transport."""
    edge_normal: Any          # [nEdges, 2] unit normal C1 -> C2
    dv_edge: Any              # [nEdges]
    cells_on_edge: Any        # [nEdges, 2] (clipped)
    flux_edge_mask: Any       # [nEdges] 1 where both cells exist
    vertices_on_edge: Any     # [nEdges, 2]
    edges_on_cell: Any        # [nCells, maxEdges]
    edge_sign_on_cell: Any    # [nCells, maxEdges] +1 if cell is C1
    edges_on_cell_mask: Any


_INDEX_FIELDS = ("cells_on_edge", "vertices_on_edge", "edges_on_cell")


def build_upwind_tensors(mesh: Mesh, dtype=torch.float64,
                         rotate_cartesian_grid: bool = True,
                         device=None) -> UpwindTensors:
    """The edge normals (in the rotated local east/north frame on the
    sphere), lengths and cell-edge signs of a mesh (device=None: the
    GPU)."""
    device = resolve_device(device)
    ne = mesh.n_edges
    coe = mesh.cells_on_edge
    nx = np.zeros(ne)
    ny = np.zeros(ne)
    ok = np.zeros(ne)
    if mesh.on_sphere:
        # edge normal in the (rotated) local east/north frame at the edge
        # midpoint: project the cell-center chord onto the tangent plane
        xc, yc, zc = mesh.x_cell, mesh.y_cell, mesh.z_cell
        xe, ye = mesh.x_edge, mesh.y_edge
        # edge z from the vertex mean (x_edge/y_edge stored 3D for
        # spherical meshes via sphere.py)
        ze = getattr(mesh, "z_edge", None)
        if ze is None:
            v1 = np.maximum(mesh.vertices_on_edge[:, 0], 0)
            v2 = np.maximum(mesh.vertices_on_edge[:, 1], 0)
            ze = 0.5 * (mesh.z_vertex[v1] + mesh.z_vertex[v2])
        if rotate_cartesian_grid:
            xc, yc, zc = grid_rotation_forward(xc, yc, zc)
            xe, ye, ze = grid_rotation_forward(xe, ye, ze)
        e_b, n_b = east_north_basis(xe, ye, ze)
        for e in range(ne):
            c1, c2 = coe[e]
            if c1 < 0 or c2 < 0:
                continue
            d3 = np.array([xc[c2] - xc[c1], yc[c2] - yc[c1],
                           zc[c2] - zc[c1]])
            de = d3 @ e_b[e]
            dn = d3 @ n_b[e]
            d = np.hypot(de, dn)
            if d <= 0:
                continue
            nx[e], ny[e] = de / d, dn / d
            ok[e] = 1.0
    else:
        for e in range(ne):
            c1, c2 = coe[e]
            if c1 < 0 or c2 < 0:
                continue
            dx = _wrap(mesh.x_cell[c2] - mesh.x_cell[c1], mesh.period_x)
            dy = _wrap(mesh.y_cell[c2] - mesh.y_cell[c1], mesh.period_y)
            d = np.hypot(dx, dy)
            if d <= 0:
                continue
            nx[e], ny[e] = dx / d, dy / d
            ok[e] = 1.0
    esoc = np.zeros((mesh.n_cells, mesh.max_edges))
    eoc_mask = np.zeros((mesh.n_cells, mesh.max_edges))
    for c in range(mesh.n_cells):
        for k in range(mesh.n_edges_on_cell[c]):
            e = mesh.edges_on_cell[c, k]
            if e < 0:
                continue
            esoc[c, k] = 1.0 if coe[e, 0] == c else -1.0
            eoc_mask[c, k] = 1.0
    arrays = dict(
        edge_normal=np.stack([nx, ny], -1), dv_edge=mesh.dv_edge,
        cells_on_edge=np.maximum(coe, 0), flux_edge_mask=ok,
        vertices_on_edge=np.maximum(mesh.vertices_on_edge, 0),
        edges_on_cell=np.maximum(mesh.edges_on_cell, 0),
        edge_sign_on_cell=esoc, edges_on_cell_mask=eoc_mask)

    def put(name, a):
        a = np.ascontiguousarray(a)
        if name in _INDEX_FIELDS:
            return torch.as_tensor(a.astype(np.int64)).to(device)
        return torch.as_tensor(a.astype(np.float64)).to(device=device,
                                                        dtype=dtype)
    return UpwindTensors(**{k: put(k, a) for k, a in arrays.items()})


def make_upwind_step(tree: TracerTree):
    """Build step(ut, area_cell, state, u_vertex, v_vertex, dt) ->
    new state: upwind flux-divergence update of every conserved
    quantity (mass and mass*tracer products)."""

    def step(ut: UpwindTensors, area_cell, state, u_vertex, v_vertex, dt):
        fields = to_transport_fields(tree, state)
        products = mass_tracer_products(tree, fields)

        u_e = 0.5 * (u_vertex[ut.vertices_on_edge[:, 0]] +
                     u_vertex[ut.vertices_on_edge[:, 1]])
        v_e = 0.5 * (v_vertex[ut.vertices_on_edge[:, 0]] +
                     v_vertex[ut.vertices_on_edge[:, 1]])
        un = (u_e * ut.edge_normal[:, 0] +
              v_e * ut.edge_normal[:, 1]) * ut.flux_edge_mask
        w = un * ut.dv_edge * dt                 # swept length * width
        up = w.clamp(min=0.0)
        dn = w.clamp(max=0.0)
        c1 = ut.cells_on_edge[:, 0]
        c2 = ut.cells_on_edge[:, 1]

        new_products = {}
        for name, q in products.items():
            extra = q.ndim - 1
            flux = _expand(up, extra) * q[c1] + _expand(dn, extra) * q[c2]
            f_c = flux[ut.edges_on_cell]
            sgn = _expand(ut.edge_sign_on_cell * ut.edges_on_cell_mask,
                          extra)
            div = (f_c * sgn).sum(dim=1) / _expand(area_cell, extra)
            new_products[name] = q - div

        # recover tracer means from products root-down
        new_fields = {}
        new_p = {}
        for spec in tree.specs:
            if spec.parent is None:
                new_fields[spec.name] = new_products[spec.name]
                new_p[spec.name] = new_products[spec.name]
            else:
                pp = new_p[spec.parent]
                npq = new_products[spec.name]
                if npq.ndim > pp.ndim:
                    pp = pp.unsqueeze(-1)
                val = torch.where(
                    pp > 0.0, npq / torch.where(pp == 0, 1.0, pp), 0.0)
                new_fields[spec.name] = val
                new_p[spec.name] = pp * val
        return from_transport_fields(tree, new_fields)

    return step
