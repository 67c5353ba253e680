"""The EVP elastic-subcycle loop on a planar raster-ordered quad mesh with
a cell-constant basis: CUDA kernel, its plain PyTorch version, and the
wrapper that chooses between them.

Replaces the TPU kernel `build_pallas_subcycle` of
`seaice_tpu/dynamics/pallas_evp.py`.  On a regular quad grid the
Wachspress basis is the same for every cell (`basis_is_cell_constant`), so
the basis stream collapses to four 4x4 tables gx, gy, bu, bv; the corner
reads are raster offsets (`mesh/structured.py`) and the divergence is a
vertex-side sum over the up to four cells that own a vertex.  The kernel
uses cell 0's tables for all cells, and so does the plain version; against
the per-cell `strain_tensor_S` path the difference is rounding (about
1e-14 relative in float64).

The CUDA source is `csrc/evp_raster.cu`: ONE persistent cooperative
launch per call, the vertices cut into tiles (one a block), each block
computing the cells around its tile with their stresses in registers,
the one-cell ring a neighbour owns included, so that only u, v cross
between blocks and a subcycle needs one grid barrier
(`evp_raster_loop.last_launch` says how the last launch was shaped).  The
tables travel as kernel arguments, taken to the host once per tables
tensor (`host_tables`), so a call makes no device-to-host copy.  Its bound
on an H100 (`evp_raster_loop_work`) is far below its time: all state
(about 4 MB in f32 at 168 x 168 cells) stays in the L2, and what limits the
loop is, each subcycle, a chain of dependent L2 reads and divisions and
the grid barrier.

`build_raster_loop` returns None for a periodic or non-quad layout, as the
JAX package's `build_pallas_subcycle` does; the caller raises.  The function it returns
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import constants as c
from . import constitutive
from .cuda_unstructured import _check
from .momentum import momentum_update
from .variational_fast import FastTensors


def basis_is_cell_constant(fast: FastTensors, rtol: float = 1e-8) -> bool:
    """True if the basis is identical for every cell: the regular-grid
    property the raster kernel relies on."""
    for a in (fast.basis_grad_T, fast.basis_int_T):
        a = a.detach().cpu().numpy()
        scale = max(float(np.abs(a).max()), 1e-300)
        if float(np.abs(a - a[..., :1]).max()) > rtol * scale:
            return False
    return True


def basis_tables(fast: FastTensors):
    """Cell 0's four [4, 4] tables (gx, gy, bu, bv)."""
    return (fast.basis_grad_T[:, 0, :, 0], fast.basis_grad_T[:, 1, :, 0],
            fast.basis_int_T[:, 0, :, 0], fast.basis_int_T[:, 1, :, 0])


def evp_raster_loop_plain(raster, gx, gy, bu, bv, u, v, t11, t22, t12,
                          pressure, solve_stress, uo_v, vo_v, mass_vertex,
                          mass_f, air_u, air_v, tilt_u, tilt_v, ocean_u,
                          ocean_v, solve_velocity, area_vertex, denominator,
                          *, dt_elastic: float, damping_timescale: float,
                          n_subcycles: int):
    """Plain PyTorch version of the kernel: `strain_tensor_S` ->
    evp_stress_update -> `stress_divergence_S` -> momentum, with the four
    cell-constant tables in place of the per-cell basis.
    Returns (u, v, t11, t22, t12)."""
    from .variational_fast import gather_corners_S
    dte = float(dt_elastic)
    nxc, nyc = raster.nxc, raster.nyc
    ss_T = (solve_stress > 0)[None, :]
    p_T = pressure[None, :]
    sv = solve_velocity > 0
    rhs_u0, rhs_v0 = air_u + tilt_u, air_v + tilt_v
    zero_v = torch.zeros_like(u)
    for _ in range(int(n_subcycles)):
        u_c, v_c = gather_corners_S(raster, u, v)            # [4(b), nc]
        # e[g, c] = sum_b vel[b, c] * table[b, g]
        e11 = (u_c[:, None, :] * gx[:, :, None]).sum(0)
        e22 = (v_c[:, None, :] * gy[:, :, None]).sum(0)
        e12 = 0.5 * ((u_c[:, None, :] * gy[:, :, None]).sum(0) +
                     (v_c[:, None, :] * gx[:, :, None]).sum(0))
        n11, n22, n12, _ = constitutive.evp_stress_update(
            t11, t22, t12, e11, e22, e12, p_T, dte, damping_timescale)
        t11 = torch.where(ss_T, n11, t11)
        t22 = torch.where(ss_T, n22, t22)
        t12 = torch.where(ss_T, n12, t12)
        pu = (t11[:, None, :] * bu[:, :, None]).sum(0) + \
            (t12[:, None, :] * bv[:, :, None]).sum(0)
        pv = (t22[:, None, :] * bv[:, :, None]).sum(0) + \
            (t12[:, None, :] * bu[:, :, None]).sum(0)
        du2 = torch.zeros((raster.nxv, raster.nyv), dtype=u.dtype,
                          device=u.device)
        dv2 = torch.zeros_like(du2)
        for b, (oi, oj) in enumerate(raster.offsets):
            du2[oi:oi + nxc, oj:oj + nyc] += pu[b].reshape(nxc, nyc)
            dv2[oi:oi + nxc, oj:oj + nyc] += pv[b].reshape(nxc, nyc)
        div_u = torch.where(sv, -du2.reshape(-1) / denominator, zero_v)
        div_v = torch.where(sv, -dv2.reshape(-1) / denominator, zero_v)
        u, v = momentum_update(
            u, v, div_u, div_v, uo_v, vo_v, mass_vertex, mass_f, rhs_u0,
            rhs_v0, ocean_u, ocean_v, solve_velocity, area_vertex, dte)
    return u, v, t11, t22, t12


def evp_raster_loop_work(nxc: int, nyc: int, n_subcycles: int,
                         itemsize: int):
    """(bytes, flops) of one call: every input read once and every output
    written once; flops of the arithmetic the loop does on them."""
    nc, nv = nxc * nyc, (nxc + 1) * (nyc + 1)
    n_in = 64 + 2 * nv + 3 * 4 * nc + 2 * nc + 15 * nv
    n_out = 2 * nv + 3 * 4 * nc
    me = 4
    cell = 8 * me * me + 40 * me + 8 * me * me + 2 * me
    vertex = 2 * 4 + 47
    return ((n_in + n_out) * itemsize,
            n_subcycles * (nc * cell + nv * vertex))


_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 23 +
             [ctypes.c_double] * 7 + [ctypes.c_void_p, ctypes.c_void_p])

# the last tables taken to the host: (key, the four tables, held so that no
# other tensor takes their memory while the key names it, the host copy)
_host_copy = None


def host_tables(gx, gy, bu, bv):
    """The four [4, 4] tables as 64 host doubles (gx, gy, bu, bv, each
    row-major), copied once per tables tensor: a call with the tables of
    the call before, or new views of the same memory unchanged since (the
    tensors' version counters), returns the same host tensor without a
    device-to-host copy."""
    global _host_copy
    tabs = (gx, gy, bu, bv)
    key = tuple((t.device, t.dtype, t.data_ptr(), tuple(t.shape), t.stride(),
                 t._version) for t in tabs)
    if _host_copy is None or _host_copy[0] != key:
        _host_copy = (key, tabs,
                      torch.stack(tabs).double().cpu().contiguous())
    return _host_copy[2]


def launch_shape(info):
    """What a K4 launch was: grid, threads per block, dynamic shared memory
    per block and the vertex tile (rows x columns)."""
    grid, threads, smem, tx, ty = (int(x) for x in info[1:6])
    return {"grid": grid, "threads": threads, "smem_bytes": smem,
            "tile": [tx, ty]}


def _c_function(dtype):
    from ..kernels.build import get_cuda_lib
    lib = get_cuda_lib("evp_raster")
    fn = getattr(lib, "evp_raster_loop_f32" if dtype == torch.float32
                 else "evp_raster_loop_f64")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def build_raster_loop(raster, *, dt_elastic: float, damping_timescale: float,
                      n_subcycles: int):
    """Build the whole-loop function for a raster-quad layout.

    Returns fn(gx, gy, bu, bv, u, v, t11, t22, t12, pressure,
               solve_stress, uo_v, vo_v, mass_vertex, mass_f, air_u,
               air_v, tilt_u, tilt_v, ocean_u, ocean_v, solve_velocity,
               area_vertex, denominator) -> (u, v, t11, t22, t12)
    with gx/gy/bu/bv the [4, 4] cell-constant basis tables, u/v/...
    [nVertices] and t** [4, nCells]; air stress and surface tilt are
    passed separately and summed inside.  The inputs are not modified.
    Returns None if the layout is ineligible (periodic, or not a quad)."""
    if raster is None or getattr(raster, "periodic", False):
        return None
    if len(raster.offsets) != 4:
        return None
    kw = dict(dt_elastic=dt_elastic, damping_timescale=damping_timescale,
              n_subcycles=n_subcycles)

    def run(*args):
        return evp_raster_loop(raster, *args, **kw)

    return run


def evp_raster_loop(raster, gx, gy, bu, bv, u, v, t11, t22, t12, pressure,
                    solve_stress, uo_v, vo_v, mass_vertex, mass_f, air_u,
                    air_v, tilt_u, tilt_v, ocean_u, ocean_v, solve_velocity,
                    area_vertex, denominator, *, dt_elastic: float,
                    damping_timescale: float, n_subcycles: int):
    """Run all `n_subcycles` elastic subcycles on a raster quad mesh (see
    `build_raster_loop` for the arguments).

    CPU tensors take the plain version.  CUDA tensors make one cooperative
    launch of the kernel of `csrc/evp_raster.cu` (float32 or float64) and
    add one to `evp_raster_loop.launches`; `evp_raster_loop.inner_launches`
    accumulates the kernel launches made inside those calls (one each) and
    `evp_raster_loop.last_launch` says how the last one was shaped.  A
    launch the card refuses raises.
    """
    kw = dict(dt_elastic=dt_elastic, damping_timescale=damping_timescale,
              n_subcycles=n_subcycles)
    args = (gx, gy, bu, bv, u, v, t11, t22, t12, pressure, solve_stress,
            uo_v, vo_v, mass_vertex, mass_f, air_u, air_v, tilt_u, tilt_v,
            ocean_u, ocean_v, solve_velocity, area_vertex, denominator)
    if u.device.type == "cpu":
        return evp_raster_loop_plain(raster, *args, **kw)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    return _launch(raster, *args, **kw)


def _launch(*args, **kw):
    """Checks, copies and the call of the C function."""
    call, outputs = _bind(*args, **kw)
    err, info = call()
    _COUNTS.inner_launches += info[0]
    if err != 0:
        raise RuntimeError(f"evp_raster_loop: CUDA error {err} (a refused "
                           "cooperative launch is not retried)")
    _COUNTS.launches += 1
    _COUNTS.last_launch = launch_shape(info)
    return outputs


def _bind(raster, gx, gy, bu, bv, u, v, t11, t22, t12, pressure,
          solve_stress, uo_v, vo_v, mass_vertex, mass_f, air_u, air_v,
          tilt_u, tilt_v, ocean_u, ocean_v, solve_velocity, area_vertex,
          denominator, *, dt_elastic, damping_timescale, n_subcycles):
    """Check every argument, copy the five tensors the kernel updates in
    place and allocate its scratch; returns (call, (u, v, t11, t22,
    t12)): call() makes the C call on the current stream, which carries
    the copies n_subcycles further, and returns (error, info)."""
    dt, dev = u.dtype, u.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dt}")
    nxc, nyc = raster.nxc, raster.nyc
    if (raster.nxv, raster.nyv) != (nxc + 1, nyc + 1):
        raise ValueError("raster layout: nxv, nyv must be nxc+1, nyc+1")
    nc, nv = nxc * nyc, raster.nxv * raster.nyv
    for name, t in dict(gx=gx, gy=gy, bu=bu, bv=bv).items():
        if tuple(t.shape) != (4, 4):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             "expected (4, 4)")
    tables = host_tables(gx, gy, bu, bv)
    offsets = (ctypes.c_int * 8)(*[o for pair in raster.offsets
                                   for o in pair])
    # the kernel updates these five in place: work on copies
    u, v = u.contiguous().clone(), v.contiguous().clone()
    t11, t22, t12 = (s.contiguous().clone() for s in (t11, t22, t12))
    vertex_in = dict(uo_v=uo_v, vo_v=vo_v, mass_vertex=mass_vertex,
                     mass_f=mass_f, air_u=air_u, air_v=air_v,
                     tilt_u=tilt_u, tilt_v=tilt_v, ocean_u=ocean_u,
                     ocean_v=ocean_v, solve_velocity=solve_velocity,
                     area_vertex=area_vertex, denominator=denominator)
    vertex_in = {k: t.contiguous() for k, t in vertex_in.items()}
    pressure, solve_stress = pressure.contiguous(), solve_stress.contiguous()
    for name, t in dict(u=u, v=v, **vertex_in).items():
        _check(name, t, (nv,), dt, dev)
    for name, t in dict(t11=t11, t22=t22, t12=t12).items():
        _check(name, t, (4, nc), dt, dev)
    _check("pressure", pressure, (nc,), dt, dev)
    _check("solve_stress", solve_stress, (nc,), dt, dev)

    # the second buffers of u, v and the stresses
    work = torch.empty(2 * nv + 12 * nc, dtype=dt, device=dev)
    fn = _c_function(dt)
    info = (ctypes.c_int * 6)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    ptr = [t.data_ptr() for t in (
        u, v, t11, t22, t12, pressure, solve_stress, *vertex_in.values(),
        work)]
    args = (nxc, nyc, int(n_subcycles),
            ctypes.cast(offsets, ctypes.c_void_p), tables.data_ptr(),
            *ptr, float(dt_elastic), float(damping_timescale),
            float(c.EVP_ECCENTRICITY_SQ), float(c.PUNY),
            float(c.COS_OCEAN_TURNING_ANGLE),
            float(c.SIN_OCEAN_TURNING_ANGLE),
            float(c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER), stream,
            ctypes.byref(info))

    outputs = (u, v, t11, t22, t12)

    def call():
        return fn(*args), info

    # what the pointers address lives as long as the call
    call.keep = (tables, offsets, work, pressure, solve_stress, vertex_in,
                 outputs)
    return call, outputs


evp_raster_loop.launches = 0
evp_raster_loop.inner_launches = 0
evp_raster_loop.last_launch = None
_COUNTS = evp_raster_loop            # the wrapper carries its own counts
