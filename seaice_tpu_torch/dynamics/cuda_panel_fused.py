"""The EVP elastic-subcycle loop on the panel-reordered icosahedral sphere:
CUDA kernel, its plain PyTorch version, and the wrapper that chooses
between them.

Replaces the TPU kernel `build_fused_panel_solver` of
`seaice_tpu/dynamics/pallas_panel_fused.py`.  One call runs all
`n_subcycles` of: corner reads at static flat offsets -> Wachspress strain
(with the tan(lat)/r metric terms) -> EVP stress relaxation ->
stress-divergence partials -> dual sum at static offsets, seam ghosts
included -> the 12 exception cells (2 poles, 10 pentagons) on their
ring-indexed side path -> ocean drag -> 2x2 momentum solve (reference
`mpas_seaice_velocity_solver.F:2447-2592`).

The CUDA source is `csrc/evp_panel_fused.cu`: ONE cooperative launch per
call, its grid what is co-resident on the card (the occupancy query at the
shared-memory budget times the SM count: one block per SM on an H100).
Each block owns a fixed run of cell columns and fixed vertices for the
whole loop, with a grid-wide barrier after the cell phase and after the
vertex phase of every subcycle.  Where their state lives follows from N,
the dtype, the metric terms, the SM count and the opt-in shared-memory
budget (the C side's `plan_loop`; `launch_shape` reports it): one column
and two vertices a thread in registers, 320 threads a block, where they
fit (N = 64); else blocks of 640 threads (320 in f64) with every
column's and vertex's fixed data in tables the kernel's prologue writes,
the columns' stresses in shared memory as far as it goes (N = 128: all of
them) and in `s_out` past that.  The basis of a block's first columns takes the shared memory
left (N = 64 in f32: all of it); the rest is read from device memory every
subcycle.  The kernel gathers the real-order inputs itself in a prologue
and scatters the results in an epilogue (through `cell_pad_idx`,
`ring_of_slot`, `slot_of_ring_a` and `k_real_pos`), so the wrapper only
checks, plans, allocates the two outputs and launches.  Its scratch
(vertex planes, partials, the exception cells' buffers, the tables) is
allocated and zeroed once per shape: the kernel writes only the positions
it reads.  No seam ghost is stored: a reader whose static offset lands on
a seam position takes the real position from the edge tables of
`variational_panel.kernel_index_lists`, once, in the prologue.  The strip
schedule of the JAX package (`panel_strips.py`) exists because its kernel
cannot gather, and is not needed here.

Its bound on an H100 (`evp_panel_loop_work`): the ~1,100 flops per cell
and subcycle, 0.08 ms a call at the f32 peak at N = 64 and 0.33 ms at
N = 128.  At N = 128 the basis streamed from device memory every subcycle
(`launch_shape`'s `streamed_basis_bytes_per_subcycle`) is what bounds it.
`chip_smoke.py` reports the kernel's time beside its bound.  A refused
cooperative launch raises; there is no per-subcycle fallback.

Arithmetic: that of the plain version (division by the variational
denominator, the sign of mass*f with sign(0) = +1, det = a11*a11 -
a12*a21), not the reciprocal-multiply and a11^2 + a12^2 forms of the TPU
kernel; kernel and plain version differ only in the order of sums and in
fused multiply-adds.  The cell side does not multiply the corner values
by `slot_used`: where a slot is unused the basis is zero, so neither
stresses nor partials can see the value.

`evp_panel_loop` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import constants as c
from ..diagnostics import RECORDER
from . import constitutive
from .cuda_unstructured import _check
from .momentum import momentum_update
from .variational_panel import (PanelTensors, cells_to_padded, panel_n_of,
                                strain_tensor_P, stress_divergence_P,
                                stress_ring_to_slot, stress_slot_to_ring)


def evp_panel_loop_plain(pt: PanelTensors, u, v, s11T, s22T, s12T,
                         pressure, solve_stress, uo_v, vo_v,
                         mass_vertex, mass_f, rhs_u0, rhs_v0,
                         ocean_u, ocean_v, solve_velocity, area_vertex,
                         *, dt_elastic: float, damping_timescale: float,
                         n_subcycles: int, include_metric: bool):
    """Plain PyTorch version of the kernel: the
    strain_tensor_P -> evp_stress_update -> stress_divergence_P ->
    momentum loop on the slot-indexed padded stresses.
    Returns (u, v, s11T, s22T, s12T), stresses ring-indexed [6, nCells]."""
    N = panel_n_of(pt)
    dte = float(dt_elastic)
    ss_T = (cells_to_padded(pt, solve_stress) > 0)[None, :]
    p_T = cells_to_padded(pt, pressure)[None, :]
    t11, t22, t12 = (stress_ring_to_slot(pt, s)
                     for s in (s11T, s22T, s12T))
    for _ in range(int(n_subcycles)):
        e11, e22, e12 = strain_tensor_P(pt, N, u, v, include_metric)
        n11, n22, n12, _ = constitutive.evp_stress_update(
            t11, t22, t12, e11, e22, e12, p_T, dte, damping_timescale)
        t11 = torch.where(ss_T, n11, t11)
        t22 = torch.where(ss_T, n22, t22)
        t12 = torch.where(ss_T, n12, t12)
        div_u, div_v = stress_divergence_P(pt, N, t11, t22, t12,
                                           solve_velocity, include_metric)
        u, v = momentum_update(
            u, v, div_u, div_v, uo_v, vo_v, mass_vertex, mass_f, rhs_u0,
            rhs_v0, ocean_u, ocean_v, solve_velocity, area_vertex, dte)
    return (u, v, *(stress_slot_to_ring(pt, t) for t in (t11, t22, t12)))


def evp_panel_loop_work(N: int, n_subcycles: int, include_metric: bool,
                        itemsize: int):
    """(bytes, flops) of one call: every input read once and every output
    written once; flops of the arithmetic the loop does on them."""
    nc = 10 * N * N + 2
    nv = 20 * N * N
    npc = 10 * (N + 1) ** 2 + 2
    n_basis = (5 if include_metric else 4) * 36 * npc
    n_exc = 12 * ((5 if include_metric else 4) * 36 + 6)
    n_in = (n_basis + n_exc
            + 2 * nv + 3 * 6 * nc            # u, v, stresses
            + 2 * nc + 12 * nv)              # cell and vertex invariants
    n_out = 2 * nv + 3 * 6 * nc
    byts = (n_in + n_out) * itemsize
    me = 6
    strain = 8 * me * me + (5 * me if include_metric else 0)
    stress = 40 * me
    partial = 8 * me * me + 2 * me + ((4 * me * me) if include_metric
                                      else 0)
    vertex = 4 * 3 + (4 if include_metric else 0) + 45
    flops = n_subcycles * (nc * (strain + stress + partial) + nv * vertex)
    return byts, flops


_ARGTYPES = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_double), ctypes.c_void_p,
             ctypes.POINTER(ctypes.c_int)]


def _c_function(dtype):
    from ..kernels.build import get_cuda_lib
    lib = get_cuda_lib("evp_panel_fused")
    fn = getattr(lib, "evp_panel_loop_f32" if dtype == torch.float32
                 else "evp_panel_loop_f64")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_panel_tensors(pt: PanelTensors, N: int, dt, dev):
    """Device, type, shape and contiguity of what the panel kernels read."""
    npp = 10 * (N + 1) ** 2
    npc = npp + 2
    _check("basis_grad_S", pt.basis_grad_S, (6, 2, 6, npc), dt, dev)
    _check("basis_int_S", pt.basis_int_S, (6, 2, 6, npc), dt, dev)
    _check("basis_metric_S", pt.basis_metric_S, (6, 6, npc), dt, dev)
    if pt.k_exc_vpos is None:
        raise ValueError("PanelTensors without the kernels' index tables: "
                         "build them with kernel_index_lists(pt)")


_scratch = {}


def loop_scratch(N: int, metric: bool, dtype, device, info):
    """The kernel's scratch for panel size N and the plan `info`
    (`plan_loop`): vertex planes [3, 2, npp], partials [4, 6, npc], the
    exception cells' stresses [2, 3, 6, 12] and contributions [2, 72]; in
    the table placement the columns' values [1 + 6 metric, grid * cpb] and,
    int32, their corner positions and columns [7, grid * cpb] and the
    vertices' table [5, nv].  Zeroed once and reused by every call with
    the same shapes: the kernel writes only the positions it reads, so the
    zeros elsewhere (pad columns of the partials) hold."""
    grid, cpb, tables = int(info[1]), int(info[4]), bool(info[7])
    n_tab = grid * cpb if tables else 0
    n_vt = 20 * N * N if tables else 0
    key = (N, bool(metric), dtype, str(device), n_tab, n_vt)
    if key not in _scratch:
        npp = 10 * (N + 1) ** 2
        npc = npp + 2
        sizes = (3 * 2 * npp, 4 * 6 * npc, 2 * 3 * 72, 2 * 72,
                 (7 if metric else 1) * n_tab)
        flat = torch.zeros(sum(sizes), dtype=dtype, device=device)
        isizes = (7 * n_tab, 5 * n_vt)
        iflat = torch.zeros(sum(isizes), dtype=torch.int32, device=device)
        _scratch[key] = torch.split(flat, sizes) + torch.split(iflat, isizes)
    return _scratch[key]


@functools.lru_cache(maxsize=64)
def launch_shape(info, N: int, metric: bool, itemsize: int):
    """What a launch with plan `info` (a tuple, `plan_loop`) was: grid,
    threads per block, dynamic shared memory per block, columns per block,
    the placement ("registers" or "tables"), resident-basis columns and
    shared-memory stress columns per block; the shares of the 10 N^2
    columns whose basis stays in shared memory (`basis_share_in_smem`) or
    is streamed from device memory every subcycle
    (`basis_share_streamed`), and whose stresses stay on chip (registers
    or shared memory); and the basis bytes streamed a subcycle (the
    exception cells among the columns included)."""
    grid, threads, smem, cpb, n_res, n_ss, tables = (
        int(x) for x in info[1:8])
    ncol = 10 * N * N
    resident = on_chip = 0
    for b in range(grid):
        ncb = max(0, min(cpb, ncol - b * cpb))
        resident += min(n_res, ncb)
        on_chip += min(n_ss, ncb) if tables else ncb
    streamed = ncol - resident
    nk = 180 if metric else 144
    return {"grid": grid, "threads": threads, "smem_bytes": smem,
            "columns_per_block": cpb,
            "placement": "tables" if tables else "registers",
            "smem_columns_per_block": n_res,
            "smem_stress_columns_per_block": n_ss,
            "basis_share_in_smem": resident / ncol,
            "basis_share_streamed": streamed / ncol,
            "stress_share_on_chip": on_chip / ncol,
            "streamed_basis_columns": streamed,
            "on_chip_stress_columns": on_chip,
            "streamed_basis_bytes_per_subcycle": streamed * nk * itemsize}


def evp_panel_loop(pt: PanelTensors, u, v, s11T, s22T, s12T, pressure,
                   solve_stress, uo_v, vo_v, mass_vertex, mass_f,
                   rhs_u0, rhs_v0, ocean_u, ocean_v, solve_velocity,
                   area_vertex, *, dt_elastic: float,
                   damping_timescale: float, n_subcycles: int,
                   include_metric: bool):
    """Run all `n_subcycles` elastic subcycles on a panel mesh.

    u, v and the ten vertex fields are [nVertices] in the panel-major real
    order; s11T, s22T, s12T are ring-indexed [6, nCells]; pressure and
    solve_stress [nCells]; rhs_u0 = air stress + surface tilt, summed by
    the caller.  Returns new (u, v, s11T, s22T, s12T); the inputs are not
    modified.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    of `csrc/evp_panel_fused.cu` (float32 or float64) and add one to
    `evp_panel_loop.launches`; `evp_panel_loop.inner_launches`
    accumulates the kernel launches made inside those calls (one each),
    and `evp_panel_loop.last_launch` says how the last one was shaped
    (`launch_shape`).  Each launch adds to the counters
    `velocity.k3_streamed_basis_bytes` (the basis bytes it streamed over
    its subcycles), `velocity.k3_streamed_basis_columns` and
    `velocity.k3_on_chip_stress_columns` of `diagnostics.RECORDER`.
    """
    kw = dict(dt_elastic=dt_elastic, damping_timescale=damping_timescale,
              n_subcycles=n_subcycles, include_metric=include_metric)
    if u.device.type == "cpu":
        return evp_panel_loop_plain(
            pt, u, v, s11T, s22T, s12T, pressure, solve_stress, uo_v, vo_v,
            mass_vertex, mass_f, rhs_u0, rhs_v0, ocean_u, ocean_v,
            solve_velocity, area_vertex, **kw)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    return _launch(pt, u, v, s11T, s22T, s12T, pressure, solve_stress,
                   uo_v, vo_v, mass_vertex, mass_f, rhs_u0, rhs_v0, ocean_u,
                   ocean_v, solve_velocity, area_vertex, **kw)


def _launch(*args, **kw):
    """Checks, the two outputs, and the call of the C function."""
    call, outputs = _bind(*args, **kw)
    err, info = call()
    _COUNTS.inner_launches += info[0]
    if err != 0:
        raise RuntimeError(f"evp_panel_loop: CUDA error {err} (a refused "
                           "cooperative launch is not retried)")
    _COUNTS.launches += 1
    metric = bool(kw["include_metric"])
    shape = launch_shape(tuple(info), panel_n_of(args[0]), metric,
                         args[1].element_size())
    _COUNTS.last_launch = shape
    RECORDER.count("velocity.k3_streamed_basis_bytes",
                   shape["streamed_basis_bytes_per_subcycle"]
                   * int(kw["n_subcycles"]))
    RECORDER.count("velocity.k3_streamed_basis_columns",
                   shape["streamed_basis_columns"])
    RECORDER.count("velocity.k3_on_chip_stress_columns",
                   shape["on_chip_stress_columns"])
    return outputs


def _bind(pt, u, v, s11T, s22T, s12T, pressure, solve_stress, uo_v, vo_v,
          mass_vertex, mass_f, rhs_u0, rhs_v0, ocean_u, ocean_v,
          solve_velocity, area_vertex, *, dt_elastic, damping_timescale,
          n_subcycles, include_metric, phase_timer=None):
    """Check every argument and allocate the outputs; returns (call,
    (u, v, s11T, s22T, s12T)): call() makes the C call on the current
    stream and returns (error, info) (`csrc/evp_panel_fused.cu`,
    `run_loop`), writing the outputs anew each time.  `phase_timer`, a
    zeroed int64 tensor [grid, 4] on the device, accumulates each block's
    SM cycles in its cell work, first barrier, vertex work and second
    barrier (`PhaseTimer`); None leaves the timer off."""
    dt, dev = u.dtype, u.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dt}")
    N = panel_n_of(pt)
    nv, nc = 20 * N * N, 10 * N * N + 2
    check_panel_tensors(pt, N, dt, dev)
    vert = dict(u=u, v=v, uo_v=uo_v, vo_v=vo_v, mass_vertex=mass_vertex,
                mass_f=mass_f, rhs_u0=rhs_u0, rhs_v0=rhs_v0,
                ocean_u=ocean_u, ocean_v=ocean_v,
                solve_velocity=solve_velocity, area_vertex=area_vertex,
                denominator=pt.denominator, tan_lat_vertex=pt.tan_lat_vertex)
    vert = {k: x.contiguous() for k, x in vert.items()}
    cells = {k: x.contiguous() for k, x in dict(
        s11T=s11T, s22T=s22T, s12T=s12T, pressure=pressure,
        solve_stress=solve_stress).items()}
    for name, x in vert.items():
        _check(name, x, (nv,), dt, dev)
    for name, x in cells.items():
        _check(name, x, (6, nc) if name.endswith("T") else (nc,), dt, dev)
    R = N + 1
    n_t, k_t = pt.k_exc_tgt_items.shape
    for name, x, shape, t in (
            ("slot_used", pt.slot_used, (6, 10 * R * R + 2), dt),
            ("exc_mask", pt.exc_mask, (6, 12), dt),
            ("exc_basis_grad", pt.exc_basis_grad, (6, 2, 6, 12), dt),
            ("exc_basis_int", pt.exc_basis_int, (6, 2, 6, 12), dt),
            ("exc_basis_metric", pt.exc_basis_metric, (6, 6, 12), dt),
            ("cell_pad_idx", pt.cell_pad_idx, (nc,), torch.int64),
            ("ring_of_slot", pt.ring_of_slot, (6, nc), torch.int64),
            ("slot_of_ring_a", pt.slot_of_ring_a, (6, nc), torch.int64),
            ("k_real_pos", pt.k_real_pos, (nv,), torch.int64),
            ("exc_real", pt.exc_real, (12,), torch.int64),
            ("k_plane_row_pos", pt.k_plane_row_pos, (2, 10, R), torch.int32),
            ("k_plane_col_pos", pt.k_plane_col_pos, (2, 10, N), torch.int32),
            ("k_pu_row_src", pt.k_pu_row_src, (6, 10, R), torch.int32),
            ("k_pu_col_src", pt.k_pu_col_src, (6, 10, R), torch.int32),
            ("k_exc_vpos", pt.k_exc_vpos, (6, 12), torch.int32),
            ("k_exc_tgt_pos", pt.k_exc_tgt_pos, (n_t,), torch.int32),
            ("k_exc_tgt_items", pt.k_exc_tgt_items, (n_t, k_t),
             torch.int32)):
        _check(name, x, shape, t, dev)

    ints = (ctypes.c_int * 5)(N, int(n_subcycles), int(bool(include_metric)),
                              n_t, k_t)
    reals = (ctypes.c_double * 7)(
        float(dt_elastic), float(damping_timescale),
        float(c.EVP_ECCENTRICITY_SQ), float(c.PUNY),
        float(c.COS_OCEAN_TURNING_ANGLE), float(c.SIN_OCEAN_TURNING_ANGLE),
        float(c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER))
    info = (ctypes.c_int * 8)()
    fn = _c_function(dt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ints, None, reals, None, info)     # the plan alone
    if err != 0:
        raise RuntimeError(f"evp_panel_loop: CUDA error {err} while planning")
    uv = torch.empty((2, nv), dtype=dt, device=dev)
    s_out = torch.empty((3, 6, nc), dtype=dt, device=dev)
    ptrs = [x.data_ptr() for x in (
        vert["u"], vert["v"], cells["s11T"], cells["s22T"], cells["s12T"],
        cells["pressure"], cells["solve_stress"],
        *[vert[k] for k in ("uo_v", "vo_v", "mass_vertex", "mass_f",
                            "rhs_u0", "rhs_v0", "ocean_u", "ocean_v",
                            "solve_velocity", "area_vertex", "denominator",
                            "tan_lat_vertex")],
        pt.basis_grad_S, pt.basis_int_S, pt.basis_metric_S, pt.slot_used,
        pt.cell_pad_idx, pt.ring_of_slot, pt.slot_of_ring_a, pt.k_real_pos,
        pt.exc_real, pt.k_plane_row_pos, pt.k_plane_col_pos, pt.k_pu_row_src,
        pt.k_pu_col_src, pt.k_exc_vpos, pt.k_exc_tgt_pos, pt.k_exc_tgt_items,
        pt.exc_mask, pt.exc_basis_grad, pt.exc_basis_int,
        pt.exc_basis_metric,
        *loop_scratch(N, include_metric, dt, dev, info), uv, s_out)] + [
        None if phase_timer is None else phase_timer.data_ptr()]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)

    def call():
        return fn(ints, c_ptrs, reals, stream, info), info
    # the tensors behind the pointers live as long as the call
    call.held = (vert, cells, uv, s_out, phase_timer)
    return call, (uv[0], uv[1], s_out[0], s_out[1], s_out[2])


evp_panel_loop.launches = 0
evp_panel_loop.inner_launches = 0
evp_panel_loop.last_launch = None
_COUNTS = evp_panel_loop             # the wrapper carries its own counts
