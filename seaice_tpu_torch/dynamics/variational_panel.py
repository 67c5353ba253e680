"""Panel-shift variational operators for icosahedral global meshes.

The spherical analog of the raster-quad path
(`variational_fast.strain_tensor_S`): on the rhombic-panel layout
(mesh/panels.py) the per-subcycle corner gather and stress-divergence
scatter of the EVP hot loop (reference
`mpas_seaice_velocity_solver_variational.F:575-670,1064-1184`) become
STATIC FLAT OFFSETS into padded arrays.  Gathers shrink from O(nCells)
indices to the O(N) seam ghosts plus a 12-cell exception path (poles +
panel-corner pentagons).

Layout: one flat "padded grid" index q = (p*(N+1) + a)*(N+1) + b per
panel position; cells live at (a=i+1, b=j), vertices at (a=i, b=j+1).
Divergence ghost positions (cell i=-1 -> a=0, j=N -> b=N) and corner
ghost positions (vertex i=N -> a=N, j=-1 -> b=0) fall inside the same
padded range, so ghost refresh is a small in-array copy and every
corner/dual stencil offset is a single flat offset:
  corner slot k (cell q reads vertex plane t at q + D):
    s0:+1  s1:-N  s2:0 (t=0)   s3:-N  s4:0  s5:-(N+1) (t=1)
  dual (vertex q reads pu[slot] at q + D'):
    t=0: s0:-1  s1:+N  s2:0    t=1: s3:+N  s4:0  s5:+(N+1)
All arrays keep the long padded axis LAST (neighbouring GPU threads,
one per padded column, read neighbouring addresses); numerics are the
contractions of variational_fast with the corner axis re-indexed by
pattern slot.

The functions here are plain PyTorch: the torch side of the
per-subcycle panel path (`cuda_panel.py`) and the building blocks of
the plain version of the whole-loop panel kernel
(`cuda_panel_fused.py`).  The pre-shifted `corner_planes` of the JAX
package are not carried over: the CUDA cell kernel reads the two vertex
planes at the six static offsets itself.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..mesh.panels import CORNER_OFFSETS, PanelLayout
from ..utils.containers import tensor_dataclass
from ..utils.device import resolve_device

# dual pattern: vertex (I,J,t) <- cell array offsets (see panels.py)
DUAL_OFFSETS = {0: ((-1, 0, 0), (0, 0, 1), (-1, 1, 2)),
                1: ((0, 0, 3), (-1, 1, 4), (0, 1, 5))}


def _corner_flat_offsets(N):
    """Flat q-offset per corner slot (cell q -> vertex plane t)."""
    out = []
    for (di, dj, t) in CORNER_OFFSETS:
        out.append(((di - 1) * (N + 1) + dj + 1, t))
    return out


def _dual_flat_offsets(N):
    """Flat q-offset per dual slot (vertex q -> pu[slot])."""
    out = {}
    for t, offs in DUAL_OFFSETS.items():
        out[t] = [((di + 1) * (N + 1) + dj - 1, slot)
                  for (di, dj, slot) in offs]
    return out


def panel_n_of(pt: "PanelTensors") -> int:
    """Panel size N from the padded width npc = 10*(N+1)^2 + 2."""
    npc = pt.basis_grad_S.shape[-1]
    N = int(round(((npc - 2) / 10) ** 0.5)) - 1
    if 10 * (N + 1) ** 2 + 2 != npc:
        raise ValueError(f"padded width {npc} is not 10*(N+1)^2 + 2")
    return N


@tensor_dataclass
class PanelTensors:
    """Static tensors for the flat-padded panel-shift operators."""
    # slot-indexed basis in PADDED layout [.., npc] (npc = padded grid
    # + 2 pole slots; zero at unused slots / ghost / exception cells)
    basis_grad_S: Any      # [6(b), 2, 6(g), npc]
    basis_int_S: Any       # [6(s), 2, 6(j), npc]
    basis_metric_S: Any    # [6(s), 6(j), npc]
    denominator: Any       # [nVertices] (real layout)
    tan_lat_vertex: Any    # [nVertices]
    slot_used: Any         # [6, npc]
    cell_pad_idx: Any      # [nCells] real cell -> padded column
    ring_of_slot: Any      # [6, nCells] (real layout; 0-padded)
    slot_of_ring_a: Any    # [6, nCells]
    # corner ghost refresh: vertex-plane flat positions <- real vertex
    ghost_vert_dst: Any    # [nGV] flat into [2(t), npp]
    ghost_vert_id: Any     # [nGV] real vertex ids
    # divergence ghost refresh: padded pu positions <- (slot, padded
    # cell column)
    ghost_pu_dst: Any      # [nGP] flat into [6, npp]
    ghost_pu_src: Any      # [nGP] flat into [6, npc] (slot*npc + col)
    # full gather maps (identity layout + ghost overrides)
    plane_src: Any         # [2*npp] -> row into [1 zero row + uv]
    pu_src_full: Any       # [6*npp] -> flat into [6, npc]
    # dense EDGE-ROW maps: every seam ghost lives on the pad row/col of
    # its panel (vertex ghosts at a=N or b=0; divergence ghosts at a=0
    # or b=N), so the padded planes are a pure reshape of the
    # panel-major real arrays plus two small gathered edge strips
    plane_row_src: Any     # [2, 10, N+1] -> row into [1 zero + uv]
    plane_col_src: Any     # [2, 10, N]   -> row into [1 zero + uv]
    pu_row_src: Any        # [6, 10, N+1] -> flat into [6, npc]
    pu_col_src: Any        # [6, 10, N+1] -> flat into [6, npc]
    # exception path (12 cells; ring-indexed contraction)
    exc_pad_cols: Any      # [12] padded columns of the exception cells
    exc_real: Any          # [12] real cell ids of the exception cells
    exc_voc: Any           # [me, 12] real ring vertex ids
    exc_mask: Any          # [me, 12]
    exc_basis_grad: Any    # [me, 2, me, 12]
    exc_basis_int: Any     # [me, 2, me, 12]
    exc_basis_metric: Any  # [me, me, 12]
    # int32 tables read by the CUDA kernels (`kernel_index_lists`)
    k_plane_row_pos: Any = None   # [2, 10, N+1] flat into [2, npp], or -1
    k_plane_col_pos: Any = None   # [2, 10, N]   flat into [2, npp], or -1
    k_pu_row_src: Any = None      # [6, 10, N+1] flat into [6, npc]
    k_pu_col_src: Any = None      # [6, 10, N+1] flat into [6, npc]
    k_exc_vpos: Any = None        # [me, 12] flat into [2, npp]
    k_real_pos: Any = None        # [nVertices] int64, flat into [2, npp]
    k_exc_tgt_pos: Any = None     # [nT] flat into [2, npp]
    k_exc_tgt_items: Any = None   # [nT, K] j*12 + e, or -1


def _plane_pos_of_vertex(vid, N):
    """Flat position in the [2, npp] vertex planes of real vertex ids
    ((p*N + a)*N + j)*2 + t  ->  t*npp + (p*(N+1) + a)*(N+1) + j + 1."""
    npp = 10 * (N + 1) * (N + 1)
    t = vid % 2
    r = vid // 2
    j = r % N
    a = (r // N) % N
    p = r // (N * N)
    return t * npp + (p * (N + 1) + a) * (N + 1) + j + 1


def kernel_index_lists(pt: PanelTensors) -> PanelTensors:
    """Fill the int32 tables of the CUDA kernels from the maps that the
    plain operators use, so kernel and plain version read the same seam
    ghosts from the same sources.

    The kernels store no ghost: a reader whose static offset lands on a
    seam position looks its source up.  Vertex ghosts (the a = N row and
    the b = 0 column of every plane and panel): `plane_row_src` /
    `plane_col_src` with the real vertex ids converted to plane positions
    (-1 where the plain planes hold zero).  Divergence ghosts (the a = 0
    row and the b = N column of every slot and panel): `pu_row_src` /
    `pu_col_src` as they are; the reader takes the row table first, so the
    row strip wins the shared corner as in `divergence_finish`.
    `k_real_pos` is the plane position of every real vertex (int64: the
    wrapper indexes with it).  Exception cells: plane positions of their
    ring vertices, and for
    every vertex that receives an exception contribution the fixed list
    of (ring slot, exception cell) items it sums, in the order of the
    plain version's scatter-add."""
    N = panel_n_of(pt)
    dev = pt.basis_grad_S.device

    def np_(a):
        return a.detach().cpu().numpy()

    def plane_pos(src1):               # row into [1 zero + uv] -> position
        return np.where(src1 > 0, _plane_pos_of_vertex(
            np.maximum(src1 - 1, 0), N), -1)

    # exception cells
    voc = np_(pt.exc_voc)                              # [me, 12]
    mask = np_(pt.exc_mask) > 0
    vpos = _plane_pos_of_vertex(voc, N)
    flat_pos = vpos.reshape(-1)
    flat_ok = mask.reshape(-1)
    targets = np.unique(flat_pos[flat_ok])
    items = [np.nonzero(flat_ok & (flat_pos == t))[0] for t in targets]
    K = max(len(i) for i in items)
    tgt_items = np.full((len(targets), K), -1, np.int64)
    for r, i in enumerate(items):
        tgt_items[r, :len(i)] = i

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32)).to(dev)

    return pt.replace(
        k_plane_row_pos=i32(plane_pos(np_(pt.plane_row_src))),
        k_plane_col_pos=i32(plane_pos(np_(pt.plane_col_src))),
        k_pu_row_src=i32(np_(pt.pu_row_src)),
        k_pu_col_src=i32(np_(pt.pu_col_src)),
        k_exc_vpos=i32(vpos),
        k_real_pos=torch.as_tensor(_plane_pos_of_vertex(
            np.arange(pt.denominator.shape[0]), N)).to(dev),
        k_exc_tgt_pos=i32(targets), k_exc_tgt_items=i32(tgt_items))


def build_panel_tensors(mesh, lay: PanelLayout, basis,
                        dtype=torch.float32, device=None) -> PanelTensors:
    """Slot-ify + pad the variational basis for a panel-reordered
    mesh (cell id = p*N^2+i*N+j, poles last; vertex id = panel-major,
    as produced by mesh.panels.panel_reorder).  device=None: the GPU."""
    device = resolve_device(device)
    N = lay.N
    nc, me = mesh.n_cells, mesh.max_edges
    assert me == 6
    npp = 10 * (N + 1) * (N + 1)
    npc = npp + 2

    # real cell -> padded column
    p = np.arange(10 * N * N) // (N * N)
    ij = np.arange(10 * N * N) % (N * N)
    i, j = ij // N, ij % N
    cell_pad = np.empty(nc, np.int64)
    cell_pad[:10 * N * N] = (p * (N + 1) + i + 1) * (N + 1) + j
    cell_pad[10 * N * N:] = npp + np.arange(2)

    bg = np.stack([basis.basis_gradient_u, basis.basis_gradient_v],
                  axis=2)                    # [nc, me(b), 2, me(g)]
    bi = np.stack([basis.basis_integrals_u, basis.basis_integrals_v],
                  axis=2)
    bm = np.asarray(basis.basis_integrals_metric)   # [nc, me(s), me(j)]

    so = np.asarray(lay.slot_of_ring)        # [nc, me] ring -> slot
    idx = np.where(so >= 0)
    cells_i, ring_i = idx
    slot_i = so[idx]
    # scatter ring axes into slot axes (row then column)
    tmp_g = np.zeros((nc, 6, 2, me))
    tmp_i = np.zeros((nc, 6, 2, me))
    tmp_m = np.zeros((nc, 6, me))
    tmp_g[cells_i, slot_i] = bg[cells_i, ring_i]
    tmp_i[cells_i, slot_i] = bi[cells_i, ring_i]
    tmp_m[cells_i, slot_i] = bm[cells_i, ring_i]
    bg_S = np.zeros((6, 2, 6, npc))
    bi_S = np.zeros((6, 2, 6, npc))
    bm_S = np.zeros((6, 6, npc))
    cp = cell_pad[cells_i]
    bg_S[:, :, slot_i, cp] = np.transpose(tmp_g[cells_i, :, :, ring_i],
                                          (1, 2, 0))
    bi_S[:, :, slot_i, cp] = np.transpose(tmp_i[cells_i, :, :, ring_i],
                                          (1, 2, 0))
    bm_S[:, slot_i, cp] = tmp_m[cells_i, :, ring_i].T

    slot_used = np.zeros((6, npc))
    slot_used[slot_i, cp] = 1.0
    ring_of_slot = np.zeros((nc, 6), np.int32)
    ring_of_slot[cells_i, slot_i] = ring_i
    slot_of_ring_a = np.where(so >= 0, so, 0).astype(np.int32)

    # corner ghosts: flat into [2, npp] (vertex planes, t-major)
    gvp = lay.ghost_vert_pos                 # (p, vi, vj, t)
    gv2d = (gvp[:, 0] * (N + 1) + gvp[:, 1]) * (N + 1) + gvp[:, 2] + 1
    gv_dst = gvp[:, 3] * npp + gv2d
    # divergence ghosts: dst flat into [6, npp]; src into [6, npc]
    gpp = lay.ghost_pu_pos                   # (slot, p, gi, gj)
    gp2d = (gpp[:, 1] * (N + 1) + gpp[:, 2] + 1) * (N + 1) + gpp[:, 3]
    gp_dst = gpp[:, 0] * npp + gp2d
    gp_src = (lay.ghost_pu_src[:, 1] * npc +
              cell_pad[lay.ghost_pu_src[:, 0]])

    # full gather maps (identity layout + ghost overrides)
    # vertex planes [2(t), npp]: position (t; p, a, b) holds real
    # vertex ((p*N + a)*N + (b-1))*2 + t for a<N, 1<=b<=N, else zero
    plane_src = np.zeros(2 * npp, np.int64)          # 0 = zero row
    tt, ppn, aa, bb = np.meshgrid(
        np.arange(2), np.arange(10), np.arange(N), np.arange(1, N + 1),
        indexing="ij")
    dst = tt * npp + (ppn * (N + 1) + aa) * (N + 1) + bb
    src = ((ppn * N + aa) * N + (bb - 1)) * 2 + tt + 1
    plane_src[dst.reshape(-1)] = src.reshape(-1)
    plane_src[gv_dst] = np.asarray(lay.ghost_vert_id) + 1
    # pu pads [6, npp]: identity from stacked [6, npc] + ghosts
    ss_, qq = np.meshgrid(np.arange(6), np.arange(npp), indexing="ij")
    pu_src_full = (ss_ * npc + qq).reshape(-1)
    pu_src_full[gp_dst] = gp_src

    # dense edge strips (see PanelTensors docstring): verify the ghost
    # sets really live on the pad rows/cols, then slice the full maps
    assert ((gvp[:, 1] == N) | (gvp[:, 2] == -1)).all(), \
        "vertex ghost off the pad row/col"
    assert ((gpp[:, 2] == -1) | (gpp[:, 3] == N)).all(), \
        "pu ghost off the pad row/col"
    ps2 = plane_src.reshape(2, 10, N + 1, N + 1)
    plane_row_src = ps2[:, :, N, :]              # a = N row
    plane_col_src = ps2[:, :, :N, 0]             # b = 0 col, a < N
    pu2 = pu_src_full.reshape(6, 10, N + 1, N + 1)
    # identity entries point back at zero-valued pad positions of
    # `stacked`, so gathering every strip entry from it is exact; the
    # (a=0, b=N) corner appears in both strips: the row strip wins
    # at merge time
    pu_row_src = pu2[:, :, 0, :]                 # a = 0 row
    pu_col_src = pu2[:, :, :, N]                 # b = N col (full)

    # exception path
    exc = np.asarray(lay.exception_cells)
    voc = np.asarray(mesh.vertices_on_cell)[exc]         # [12, me]
    neoc = np.asarray(mesh.n_edges_on_cell)[exc]
    mask = (np.arange(me)[None, :] < neoc[:, None]) & (voc >= 0)
    voc0 = np.where(mask, voc, 0)

    def fl(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
            device=device, dtype=dtype)

    def ix(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64)).to(
            device=device)

    return kernel_index_lists(PanelTensors(
        basis_grad_S=fl(bg_S),
        basis_int_S=fl(bi_S),
        basis_metric_S=fl(bm_S),
        denominator=fl(basis.variational_denominator),
        tan_lat_vertex=fl(basis.tan_lat_vertex_over_radius),
        slot_used=fl(slot_used),
        cell_pad_idx=ix(cell_pad),
        ring_of_slot=ix(ring_of_slot.T),
        slot_of_ring_a=ix(slot_of_ring_a.T),
        ghost_vert_dst=ix(gv_dst),
        ghost_vert_id=ix(lay.ghost_vert_id),
        ghost_pu_dst=ix(gp_dst),
        ghost_pu_src=ix(gp_src),
        plane_src=ix(plane_src),
        pu_src_full=ix(pu_src_full),
        plane_row_src=ix(plane_row_src),
        plane_col_src=ix(plane_col_src),
        pu_row_src=ix(pu_row_src),
        pu_col_src=ix(pu_col_src),
        exc_pad_cols=ix(cell_pad[exc]),
        exc_real=ix(exc),
        exc_voc=ix(voc0.T),
        exc_mask=fl(mask.T),
        exc_basis_grad=fl(np.transpose(bg[exc], (1, 2, 3, 0))),
        exc_basis_int=fl(np.transpose(bi[exc], (1, 2, 3, 0))),
        exc_basis_metric=fl(np.transpose(bm[exc], (1, 2, 0))),
    ))


# -- stress-state relabeling (once per velocity solve) -----------------------

def stress_ring_to_slot(pt: PanelTensors, s_ring_T):
    """[me, nCells] ring-indexed corner field -> padded slot-indexed
    [6, npc] (exception cells keep ring indexing in their columns)."""
    npc = pt.basis_grad_S.shape[-1]
    s = torch.gather(s_ring_T, 0, pt.ring_of_slot)
    out = torch.zeros((6, npc), dtype=s_ring_T.dtype,
                      device=s_ring_T.device)
    out[:, pt.cell_pad_idx] = s
    out = out * pt.slot_used
    out[:, pt.exc_pad_cols] = s_ring_T[:, pt.exc_real]
    return out


def stress_slot_to_ring(pt: PanelTensors, s_slot_pad):
    """Inverse: padded slot-indexed [6, npc] -> real ring [me, nc]."""
    s = s_slot_pad[:, pt.cell_pad_idx]            # [6, nc]
    out = torch.gather(s, 0, pt.slot_of_ring_a)
    out[:, pt.exc_real] = s_slot_pad[:, pt.exc_pad_cols]
    return out


def cells_to_padded(pt: PanelTensors, x):
    """Real cell field [nCells] -> padded columns [npc], zero at the pad
    and ghost positions."""
    out = torch.zeros((pt.basis_grad_S.shape[-1],), dtype=x.dtype,
                      device=x.device)
    out[pt.cell_pad_idx] = x
    return out


# -- operators ----------------------------------------------------------------

def _vertex_planes(pt, N, uv, out=None):
    """Real [nv, F] vertex fields -> padded planes [2(t), npp, F] with
    seam ghosts filled (written into `out` where given).  The panel-major
    vertex numbering makes the plane interior a pure reshape of `uv`
    (vertex ((p*N+a)*N+(b-1))*2+t sits at plane (t; p, a, b)); only the
    two pad strips per panel (a = N row, b = 0 column) hold seam ghosts,
    gathered as small dense edge strips and joined by concatenation."""
    npp = 10 * (N + 1) * (N + 1)
    F = uv.shape[-1]
    uv1 = torch.cat([torch.zeros((1, F), dtype=uv.dtype,
                                 device=uv.device), uv], dim=0)
    interior = uv.reshape(10, N, N, 2, F).permute(3, 0, 1, 2, 4)
    gc = uv1[pt.plane_col_src]                   # [2, 10, N, F]
    gr = uv1[pt.plane_row_src]                   # [2, 10, N+1, F]
    body = torch.cat([gc[:, :, :, None], interior], dim=3)
    if out is not None:
        torch.cat([body, gr[:, :, None]], dim=2,
                  out=out.view(2, 10, N + 1, N + 1, F))
        return out
    planes = torch.cat([body, gr[:, :, None]], dim=2)
    return planes.reshape(2, npp, F)


def velocity_planes(pt: PanelTensors, N: int, u, v,
                    include_metric: bool = False, out=None):
    """The padded vertex planes [2, npp, F] of (u, v[, tan(lat)/r]),
    written into `out` (contiguous, [2, npp, F]) where given."""
    cols = [u, v] + ([pt.tan_lat_vertex] if include_metric else [])
    return _vertex_planes(pt, N, torch.stack(cols, dim=-1), out)


def corner_values(pt: PanelTensors, N: int, planes):
    """Vertex planes [2, npp, F] -> the six corner values of every padded
    column, [6, npc, F], by the static flat offsets (reads outside the
    planes give zero; unused slots are masked to zero)."""
    npp = 10 * (N + 1) * (N + 1)
    npc = pt.basis_grad_S.shape[-1]
    pad0 = N + 1                                  # safety margin
    F = planes.shape[-1]
    ext = torch.zeros((2, npp + 2 * pad0, F), dtype=planes.dtype,
                      device=planes.device)
    ext[:, pad0:pad0 + npp] = planes
    cs = [ext[t, pad0 + d:pad0 + d + npp]
          for (d, t) in _corner_flat_offsets(N)]
    corner = torch.stack(cs)                      # [6, npp, F]
    zpad = torch.zeros((6, npc - npp, F), dtype=corner.dtype,
                       device=corner.device)
    corner = torch.cat([corner, zpad], dim=1)     # [6, npc, F]
    return corner * pt.slot_used[..., None]


def strain_from_corners(pt: PanelTensors, corner, include_metric: bool):
    """The strain contraction on given corner values [6, npc, F]."""
    u_c = corner[..., 0]
    v_c = corner[..., 1]
    gx = pt.basis_grad_S[:, 0]                   # [6(b), 6(g), npc]
    gy = pt.basis_grad_S[:, 1]
    e11 = (u_c[:, None, :] * gx).sum(0)
    e22 = (v_c[:, None, :] * gy).sum(0)
    e12 = 0.5 * ((u_c[:, None, :] * gy).sum(0) +
                 (v_c[:, None, :] * gx).sum(0))
    if include_metric:
        tl_c = corner[..., 2]
        e11 = e11 - v_c * tl_c
        e12 = e12 + 0.5 * u_c * tl_c
    return e11, e22, e12


def exception_strain(pt: PanelTensors, u, v,
                     include_metric: bool = False):
    """Ring-indexed strain for the 12 exception cells (the small
    gather path shared by the whole-loop and per-subcycle routes)."""
    uve = torch.stack([u, v], dim=-1)[pt.exc_voc] * \
        pt.exc_mask[..., None]                   # [me, 12, 2]
    ue, ve = uve[..., 0], uve[..., 1]
    egx = pt.exc_basis_grad[:, 0]
    egy = pt.exc_basis_grad[:, 1]
    x11 = (ue[:, None, :] * egx).sum(0)
    x22 = (ve[:, None, :] * egy).sum(0)
    x12 = 0.5 * ((ue[:, None, :] * egy).sum(0) +
                 (ve[:, None, :] * egx).sum(0))
    if include_metric:
        tle = pt.tan_lat_vertex[pt.exc_voc] * pt.exc_mask
        x11 = x11 - ve * tle
        x12 = x12 + 0.5 * ue * tle
    return x11, x22, x12


def strain_tensor_P(pt: PanelTensors, N: int, u, v,
                    include_metric: bool = False):
    """Strain at cell corners via flat panel shifts; returns
    [6, npc] padded slot-indexed arrays."""
    planes = velocity_planes(pt, N, u, v, include_metric)
    corner = corner_values(pt, N, planes)
    e11, e22, e12 = strain_from_corners(pt, corner, include_metric)
    # exception cells: ring-indexed strain via the small gather
    x11, x22, x12 = exception_strain(pt, u, v, include_metric)
    e11[:, pt.exc_pad_cols] = x11
    e22[:, pt.exc_pad_cols] = x22
    e12[:, pt.exc_pad_cols] = x12
    return e11, e22, e12


def divergence_partials(pt: PanelTensors, s11, s22, s12,
                        include_metric: bool = False):
    """Cell-side partial products feeding the dual accumulation
    (split out so the cell kernel can produce them directly).
    Returns stacked [6, npc, F] (F=4 with metric)."""
    bu = pt.basis_int_S[:, 0]
    bv = pt.basis_int_S[:, 1]
    pu = (s11[:, None, :] * bu).sum(0) + (s12[:, None, :] * bv).sum(0)
    pv = (s22[:, None, :] * bv).sum(0) + (s12[:, None, :] * bu).sum(0)
    if include_metric:
        mu = (s12[:, None, :] * pt.basis_metric_S).sum(0)
        mv = (s11[:, None, :] * pt.basis_metric_S).sum(0)
        return torch.stack([pu, pv, mu, mv], dim=-1)
    return torch.stack([pu, pv], dim=-1)


def stress_divergence_P(pt: PanelTensors, N: int, s11, s22, s12,
                        solve_velocity, include_metric: bool = False):
    """Stress divergence at vertices via flat panel shifts.  s** are
    padded slot-indexed [6, npc]; returns real (du, dv) [nVertices]."""
    stacked = divergence_partials(pt, s11, s22, s12, include_metric)
    return divergence_finish(pt, N, stacked, s11, s22, s12,
                             solve_velocity, include_metric)


def divergence_finish(pt: PanelTensors, N: int, stacked,
                      s11, s22, s12, solve_velocity,
                      include_metric: bool = False):
    """Ghost refresh + dual accumulation + exception scatter +
    momentum-ready (du, dv).  `stacked` [6, npc, F] are the cell-side
    partials; s** are needed only for the exception columns."""
    npp = 10 * (N + 1) * (N + 1)
    npc = s11.shape[1]
    F = stacked.shape[-1]
    # seam ghost refresh: divergence ghosts live only on the pad strips
    # (a = 0 row, b = N column) of each panel, so the ghost values are
    # two small gathered edge strips merged by broadcast + select
    src_flat = stacked.reshape(6 * npc, F)
    gr0 = src_flat[pt.pu_row_src]                # [6, 10, N+1, F] a=0
    gcN = src_flat[pt.pu_col_src]                # [6, 10, N+1, F] b=N
    pads5 = stacked[:, :npp].reshape(6, 10, N + 1, N + 1, F)
    a_ix = torch.arange(N + 1, device=stacked.device)
    row_mask = (a_ix == 0)[None, None, :, None, None]
    col_mask = (a_ix == N)[None, None, None, :, None]
    pads5 = torch.where(row_mask, gr0[:, :, None, :, :],
                        torch.where(col_mask, gcN[:, :, :, None, :],
                                    pads5))
    pads = pads5.reshape(6, npp, F)

    pad0 = N + 1
    ext = torch.zeros((6, npp + 2 * pad0, F), dtype=pads.dtype,
                      device=pads.device)
    ext[:, pad0:pad0 + npp] = pads
    dual = _dual_flat_offsets(N)
    acc = []
    for t in (0, 1):
        tot = None
        for (d, slot) in dual[t]:
            blk = ext[slot, pad0 + d:pad0 + d + npp]
            tot = blk if tot is None else tot + blk
        acc.append(tot)
    g = torch.stack(acc)                          # [2, npp, F]
    # padded vertex planes -> real vertex order
    g = g.reshape(2, 10, N + 1, N + 1, F)[:, :, :N, 1:]
    g = g.permute(1, 2, 3, 0, 4).reshape(-1, F)   # [nv, F]

    tlv = pt.tan_lat_vertex
    if include_metric:
        du = -(g[:, 0] + g[:, 2] * tlv)
        dv = -g[:, 1] + g[:, 3] * tlv
    else:
        du = -g[:, 0]
        dv = -g[:, 1]

    # exception-cell contributions: ring-indexed scatter to their ring
    # vertices
    s11e = s11[:, pt.exc_pad_cols]
    s22e = s22[:, pt.exc_pad_cols]
    s12e = s12[:, pt.exc_pad_cols]
    ebu = pt.exc_basis_int[:, 0]
    ebv = pt.exc_basis_int[:, 1]
    pue = (s11e[:, None, :] * ebu).sum(0) + \
        (s12e[:, None, :] * ebv).sum(0)
    pve = (s22e[:, None, :] * ebv).sum(0) + \
        (s12e[:, None, :] * ebu).sum(0)
    if include_metric:
        mue = (s12e[:, None, :] * pt.exc_basis_metric).sum(0)
        mve = (s11e[:, None, :] * pt.exc_basis_metric).sum(0)
        tle = tlv[pt.exc_voc]
        cu = (pue + mue * tle) * pt.exc_mask
        cv = (pve - mve * tle) * pt.exc_mask
    else:
        cu = pue * pt.exc_mask
        cv = pve * pt.exc_mask
    du = du.index_add(0, pt.exc_voc.reshape(-1), -cu.reshape(-1))
    dv = dv.index_add(0, pt.exc_voc.reshape(-1), -cv.reshape(-1))

    solve = solve_velocity > 0
    zero = torch.zeros_like(du)
    du = torch.where(solve, du / pt.denominator, zero)
    dv = torch.where(solve, dv / pt.denominator, zero)
    return du, dv
