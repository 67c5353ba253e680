"""The IR edge-flux integration: CUDA kernel and the wrapper that chooses
between it and its plain PyTorch version (`remap.integrate_fluxes`).

Replaces the TPU kernel `_build_kernel` of
`seaice_tpu/transport/pallas_flux.py` (reached through
`integrate_fluxes_fused`).  The plain version, like the TPU wrapper,
multiplies each tracer product's linear factors out into monomial
coefficients cell by cell and contracts them with the triangles' monomial
integrals.  The kernel (`csrc/ir_flux.cu`, one warp per edge) does the same
sum pointwise instead: by linearity, sum_m coeff_m * mom_m = sum_q w_q *
poly(x_q, y_q), and each product polynomial is a chain of linear factors
c + gx*x + gy*y from the mass down the tracer tree, so it evaluates the
chains at the triangle's six quadrature points (a 3D tracer: its 2D
parent's six values times its own factor), weights them, multiplies by the
signed area, sums the slots and masks the edge.  So the wrapper hands it
the reconstruction's LINEAR coefficients as one table `[nCells, 3W]` (one
`torch.cat`, `linear_table`), the quadrature points and weights, the areas,
the int64 cell indices and the edge mask as they come, and one small int32
column table built once per tree (`flux_layout`): a call is that
concatenation, two `torch.empty` and the launch, with no monomial
integrals and no product table before it.

Its bound on an H100 (`flux_work`) is bytes: the table rows that non-empty
slots of unmasked edges touch, the points, the fluxes out; the arithmetic
is three orders of magnitude below the f32 peak.  The design reads each
table row once per non-empty slot, skips empty slots and masked edges, and
keeps every intermediate on chip.  All arithmetic is plain FMA in the
working type; no tensor-core or reduced-precision path.

A block holds 4 warps' running sums and point values in dynamic shared
memory, 4 (7 T2 + T3 + 18) values for T2 2D and T3 layered table columns
(`shared_bytes`): 20.8 kB in float32 at the widest column tree (50 + 930
columns, the vertical zBGC on its full roster), 41.5 kB in float64.  Past
the card's default 48 kB a block the kernel opts in to more
(`cudaFuncAttributeMaxDynamicSharedMemorySize`); past the card's opt-in
limit the wrapper raises, naming the table's width.

`integrate_fluxes_cuda` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .geometry import RemapTensors
from .remap import integrate_fluxes
from .tracers import TracerTree


def linear_table(tree: TracerTree, recon):
    """Every tracer's reconstruction (center, gx, gy), flattened per cell
    and concatenated: [nCells, 3W], per tracer a c block, a gx block and a
    gy block of W_t = nCat (2D) or nCat*nL (3D) columns each."""
    nc = recon[tree.root.name]["center"].shape[0]
    return torch.cat([recon[s.name][k].reshape(nc, -1) for s in tree.specs
                      for k in ("center", "gx", "gy")], dim=1)


def flux_layout(tree: TracerTree, recon):
    """The kernel's column table for `linear_table`'s layout.

    Returns (meta, out2d, out3d): meta int32 [3, T2 + T3], for each 2D
    output column (tracer, category) and then each 3D one (tracer,
    category, layer): the table column of its c, the distance from c to
    gx (and from gx to gy), and the 2D output column of its parent in the
    same category (-1 for the root); out2d = [(name, nCat, out_off)],
    out3d = [(name, nCat, nL, out_off)]."""
    col, stride, parent = [], [], []
    c3, s3, p3 = [], [], []
    out2d, out3d = [], []
    first2d = {}                     # 2D tracer -> its first output column
    off = 0
    for spec in tree.specs:
        shp = tuple(recon[spec.name]["center"].shape[1:])
        w = int(np.prod(shp))
        nCat = shp[0]
        if len(shp) == 1:
            first2d[spec.name] = len(col)
            out2d.append((spec.name, nCat, len(col)))
            for cc in range(nCat):
                col.append(off + cc)
                stride.append(w)
                parent.append(-1 if spec.parent is None
                              else first2d[spec.parent] + cc)
        else:
            nL = shp[1]
            out3d.append((spec.name, nCat, nL, len(c3)))
            for cc in range(nCat):
                for ll in range(nL):
                    c3.append(off + cc * nL + ll)
                    s3.append(w)
                    p3.append(first2d[spec.parent] + cc)
        off += 3 * w
    meta = np.asarray([col + c3, stride + s3, parent + p3], np.int32)
    return meta, out2d, out3d


def flux_work(tree: TracerTree, recon, cell, area, mask_edge,
              itemsize: int):
    """(bytes, flops) of one call for THESE inputs: the reconstruction
    coefficients of the cells that non-empty slots of unmasked edges
    touch, the quadrature points of those slots, the per-slot area and
    cell index and the edge mask read once; the fluxes written once;
    flops of the pointwise evaluation those slots need (per 2D column and
    point 4 flops a linear factor of its chain and 1 a product, per 3D
    column and point 6, then 2 a point for the weights and 2 for the
    area)."""
    nE, S = cell.shape
    active = (area != 0) & (mask_edge[:, None] != 0)
    n_active = int(active.sum())
    n_cells = int(torch.unique(cell[active]).numel()) if n_active else 0
    n_coef = 0      # reconstruction values per cell
    n_out = 0
    fl = 0
    for spec in tree.specs:
        shp = recon[spec.name]["center"].shape[1:]
        n = int(np.prod(shp))
        n_coef += 3 * n
        n_out += n
        if len(shp) == 1:
            chain = tree.depth(spec.name) + 1
            fl += n * (6 * (5 * chain) + 12 + 2)
        else:
            fl += n * (6 * 6 + 12 + 2)
    byts = itemsize * (n_cells * n_coef + n_active * 12 + nE * S
                       + nE + nE * n_out) + 8 * nE * S
    return byts, n_active * fl, n_active


_layout_cache = {}

_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 11


def _c_function(dtype):
    from ..kernels.build import get_cuda_lib
    lib = get_cuda_lib("ir_flux")
    fn = getattr(lib, "ir_flux_f32" if dtype == torch.float32
                 else "ir_flux_f64")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def integrate_fluxes_cuda(tree: TracerTree, recon, rt: RemapTensors,
                          cell, xq, yq, area, mask_edge):
    """Edge fluxes of mass and mass*tracer products; same arguments and
    result as `remap.integrate_fluxes` (dict name -> [nEdges, nCat(,
    nLayers)]).

    CPU tensors take the plain version.  CUDA tensors (float32 or
    float64) launch the kernel of `csrc/ir_flux.cu` and add one to
    `integrate_fluxes_cuda.launches`."""
    if xq.device.type == "cpu":
        return integrate_fluxes(tree, recon, rt, cell, xq, yq, area,
                                mask_edge)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    return _launch(tree, recon, rt, cell, xq, yq, area, mask_edge)


# `run_flux`'s return when a block needs more shared memory than the card
# allows a block (csrc/ir_flux.cu, kSharedTooLarge)
_SHARED_TOO_LARGE = -2


def shared_bytes(n2d: int, n3d: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the kernel for a table of
    n2d 2D and n3d layered columns (csrc/ir_flux.cu: 4 warps a block,
    7 n2d + n3d + 18 values a warp)."""
    return 4 * (7 * n2d + n3d + 18) * itemsize


def _launch(tree, recon, rt, cell, xq, yq, area, mask_edge):
    """Checks, the table, the two outputs, and the call of the C
    function."""
    call, fluxes = _bind(tree, recon, rt, cell, xq, yq, area, mask_edge)
    err = call()
    if err == _SHARED_TOO_LARGE:
        t2, t3 = call.widths
        raise RuntimeError(
            f"integrate_fluxes_cuda: the tracer table of {t2 + t3} columns "
            f"({t2} 2D, {t3} layered) needs "
            f"{shared_bytes(t2, t3, xq.element_size())} B of shared memory "
            "a block, more than this card lets a block take")
    if err != 0:
        raise RuntimeError(f"integrate_fluxes_cuda: CUDA error {err}")
    _COUNTS.launches += 1
    return fluxes


def _bind(tree, recon, rt, cell, xq, yq, area, mask_edge):
    """Check every argument, build the table and allocate the outputs;
    returns (call, fluxes): call() makes the C call on the current stream
    and returns its error, writing into the outputs that `fluxes` (name ->
    view) shows."""
    dt, dev = xq.dtype, xq.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dt}")
    nE, S = cell.shape
    for name, t, shape in (("xq", xq, (nE, S, 6)), ("yq", yq, (nE, S, 6)),
                           ("area", area, (nE, S)),
                           ("mask_edge", mask_edge, (nE,)),
                           ("qp_weights", rt.qp_weights, (6,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {shape} {dt} on {dev}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if cell.device != dev or cell.dtype != torch.int64:
        raise ValueError("cell: expected an int64 tensor on " + str(dev))

    key = (tree, tuple(tuple(recon[s.name]["center"].shape[1:])
                       for s in tree.specs), str(dev))
    if key not in _layout_cache:
        meta, out2d, out3d = flux_layout(tree, recon)
        _layout_cache[key] = (torch.as_tensor(meta).to(dev), out2d, out3d)
    meta, out2d, out3d = _layout_cache[key]
    T2 = sum(n for _, n, _ in out2d)
    T3 = sum(n * nl for _, n, nl, _ in out3d)
    table = linear_table(tree, recon)
    if table.dtype != dt or table.device != dev:
        raise ValueError("recon: dtype/device differ from xq's")
    xq, yq, area, mask_edge, cell = (t.contiguous() for t in (
        xq, yq, area, mask_edge, cell))
    wq = rt.qp_weights.contiguous()
    out2 = torch.empty((nE, T2), dtype=dt, device=dev)
    out3 = torch.empty((nE, T3), dtype=dt, device=dev)
    fn = _c_function(dt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    c_args = (nE, S, table.shape[1], T2, T3, table.data_ptr(), xq.data_ptr(),
              yq.data_ptr(), wq.data_ptr(), area.data_ptr(), cell.data_ptr(),
              mask_edge.data_ptr(), meta.data_ptr(), out2.data_ptr(),
              out3.data_ptr(), stream)

    def call():
        return fn(*c_args)
    # the tensors behind the pointers live as long as the call
    call.held = (table, xq, yq, wq, area, cell, mask_edge, meta, out2, out3)
    call.widths = (T2, T3)
    fluxes = {}
    for (name, nCat, o) in out2d:
        fluxes[name] = out2[:, o:o + nCat]
    for (name, nCat, nL, o) in out3d:
        fluxes[name] = out3[:, o:o + nCat * nL].reshape(nE, nCat, nL)
    return call, fluxes


integrate_fluxes_cuda.launches = 0
_COUNTS = integrate_fluxes_cuda      # the wrapper carries its own count
