"""MPAS NetCDF mesh reader and writer.

The port of the JAX package's `io/mesh_reader.py`: builds the port's
`Mesh` from a standard MPAS mesh file (the format the reference reads
through the framework's bootstrapping; fields per the MPAS mesh
specification: nCells/nEdges/nVertices dimensions, 1-based connectivity
with 0 = invalid).  Classic netCDF is read with scipy, netCDF-4/HDF5 with
h5py, imported only for such a file.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..mesh.core import Mesh


def native(a) -> np.ndarray:
    """An array of a file in the machine's byte order (classic netCDF is
    big-endian; torch takes native arrays only)."""
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("="), copy=False)


def _read_netcdf(path: str) -> Dict[str, np.ndarray]:
    """Every variable of the file as a numpy array in native byte order;
    the file is closed before returning."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:3] == b"CDF":
        from scipy.io import netcdf_file
        nc = netcdf_file(path, "r", mmap=False)
        try:
            return {k: native(v[:]) for k, v in nc.variables.items()}
        finally:
            nc.close()
    if magic[:4] == b"\x89HDF":
        import h5py
        with h5py.File(path, "r") as h:
            return {k: native(h[k][()]) for k in h.keys()
                    if isinstance(h[k], h5py.Dataset)}
    raise ValueError(f"unrecognized netCDF magic in {path!r}")


def read_mpas_mesh(path: str) -> Mesh:
    """Read an MPAS mesh file into a finalized Mesh."""
    var = _read_netcdf(path)

    def get(name, default=None):
        return var.get(name, default)

    x_cell = get("xCell")
    n_cells = len(x_cell)
    n_vertices = len(get("xVertex"))
    dv_edge = get("dvEdge")
    n_edges = len(dv_edge)
    max_edges = get("verticesOnCell").shape[1]
    vertex_degree = get("cellsOnVertex").shape[1]

    def conn(name):
        a = get(name)
        if a is None:
            return None
        return a.astype(np.int32) - 1    # 1-based, 0 = invalid -> -1

    # attributes are not variables in classic files: detect the sphere
    # from the coordinates
    z_cell = get("zCell", np.zeros(n_cells))
    on_sphere = bool(np.abs(z_cell).max() > 1.0)
    radius = float(np.sqrt(
        get("xCell") ** 2 + get("yCell") ** 2 + z_cell ** 2).max()) \
        if on_sphere else 0.0

    n_edges_on_cell = get("nEdgesOnCell").astype(np.int32)
    # mask the per-cell lists beyond nEdgesOnCell
    k = np.arange(max_edges)[None, :]
    live = k < n_edges_on_cell[:, None]
    voc = np.where(live, conn("verticesOnCell"), -1)
    eoc = np.where(live, conn("edgesOnCell"), -1)
    coc = np.where(live, conn("cellsOnCell"), -1)

    mesh = Mesh(
        n_cells=n_cells, n_vertices=n_vertices, n_edges=n_edges,
        max_edges=max_edges, vertex_degree=vertex_degree,
        on_sphere=on_sphere, sphere_radius=radius,
        vertices_on_cell=voc,
        n_edges_on_cell=n_edges_on_cell,
        cells_on_vertex=conn("cellsOnVertex"),
        edges_on_cell=eoc,
        cells_on_cell=coc,
        cells_on_edge=conn("cellsOnEdge"),
        vertices_on_edge=conn("verticesOnEdge"),
        edges_on_vertex=conn("edgesOnVertex"),
        x_cell=get("xCell"), y_cell=get("yCell"),
        z_cell=get("zCell", np.zeros(n_cells)),
        x_vertex=get("xVertex"), y_vertex=get("yVertex"),
        z_vertex=get("zVertex", np.zeros(n_vertices)),
        x_edge=get("xEdge"), y_edge=get("yEdge"),
        lat_cell=get("latCell", np.zeros(n_cells)),
        lon_cell=get("lonCell", np.zeros(n_cells)),
        lat_vertex=get("latVertex", np.zeros(n_vertices)),
        lon_vertex=get("lonVertex", np.zeros(n_vertices)),
        area_cell=get("areaCell"),
        area_triangle=get("areaTriangle", np.ones(n_vertices)),
        kite_areas_on_vertex=get("kiteAreasOnVertex",
                                 np.zeros((n_vertices, vertex_degree))),
        dv_edge=dv_edge, dc_edge=get("dcEdge"),
    )
    return mesh.finalize()


def write_mpas_mesh(path: str, mesh: Mesh) -> None:
    """Write a Mesh as a classic-NetCDF MPAS mesh file (the standard
    variable set read back by read_mpas_mesh; 1-based connectivity,
    0 = invalid per the MPAS specification)."""
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "w")
    nc.createDimension("nCells", mesh.n_cells)
    nc.createDimension("nVertices", mesh.n_vertices)
    nc.createDimension("nEdges", mesh.n_edges)
    nc.createDimension("maxEdges", mesh.max_edges)
    nc.createDimension("vertexDegree", mesh.vertex_degree)
    nc.createDimension("TWO", 2)

    def or_zeros(a, n):
        return a if a is not None else np.zeros(n)

    def putf(name, dims, data):
        v = nc.createVariable(name, "d", dims)
        v[:] = np.asarray(data, np.float64)

    def putc(name, dims, data):
        v = nc.createVariable(name, "i", dims)
        v[:] = np.asarray(data, np.int32) + 1      # 0-based -> 1-based

    nC, nV = mesh.n_cells, mesh.n_vertices
    putf("xCell", ("nCells",), mesh.x_cell)
    putf("yCell", ("nCells",), mesh.y_cell)
    putf("zCell", ("nCells",), or_zeros(mesh.z_cell, nC))
    putf("xVertex", ("nVertices",), mesh.x_vertex)
    putf("yVertex", ("nVertices",), mesh.y_vertex)
    putf("zVertex", ("nVertices",), or_zeros(mesh.z_vertex, nV))
    putf("latCell", ("nCells",), or_zeros(mesh.lat_cell, nC))
    putf("lonCell", ("nCells",), or_zeros(mesh.lon_cell, nC))
    putf("latVertex", ("nVertices",), or_zeros(mesh.lat_vertex, nV))
    putf("lonVertex", ("nVertices",), or_zeros(mesh.lon_vertex, nV))
    if mesh.x_edge is not None:
        putf("xEdge", ("nEdges",), mesh.x_edge)
        putf("yEdge", ("nEdges",), mesh.y_edge)
    putf("areaCell", ("nCells",), mesh.area_cell)
    putf("areaTriangle", ("nVertices",), mesh.area_triangle)
    if mesh.kite_areas_on_vertex is not None:
        putf("kiteAreasOnVertex", ("nVertices", "vertexDegree"),
             mesh.kite_areas_on_vertex)
    putf("dvEdge", ("nEdges",), mesh.dv_edge)
    putf("dcEdge", ("nEdges",), mesh.dc_edge)
    v = nc.createVariable("nEdgesOnCell", "i", ("nCells",))
    v[:] = np.asarray(mesh.n_edges_on_cell, np.int32)
    putc("verticesOnCell", ("nCells", "maxEdges"), mesh.vertices_on_cell)
    putc("edgesOnCell", ("nCells", "maxEdges"), mesh.edges_on_cell)
    putc("cellsOnCell", ("nCells", "maxEdges"), mesh.cells_on_cell)
    putc("cellsOnVertex", ("nVertices", "vertexDegree"),
         mesh.cells_on_vertex)
    putc("cellsOnEdge", ("nEdges", "TWO"), mesh.cells_on_edge)
    putc("verticesOnEdge", ("nEdges", "TWO"), mesh.vertices_on_edge)
    putc("edgesOnVertex", ("nVertices", "vertexDegree"),
         mesh.edges_on_vertex)
    nc.close()
