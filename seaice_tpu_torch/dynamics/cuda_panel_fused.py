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
shared-memory budget times the SM count: one block of 320 threads per SM
on an H100).  Each block owns a fixed run of cell columns and fixed vertex
positions for the whole loop: their state in registers, the columns' basis
in shared memory as far as the budget goes (all of it at N = 64 in f32),
and a grid-wide barrier after the cell phase and after the vertex phase of
every subcycle.  The kernel gathers the real-order inputs itself in a
prologue and scatters the results in an epilogue (through `cell_pad_idx`,
`ring_of_slot`, `slot_of_ring_a` and `k_real_pos`), so the wrapper only
checks, allocates the two outputs and launches.  Its scratch (vertex
planes, partials, the exception cells' buffers) is allocated and zeroed
once per (N, dtype, device): the kernel writes only the positions it
reads.  No seam ghost is stored: a reader whose static offset lands on a
seam position takes the real position from the edge tables of
`variational_panel.kernel_index_lists`, once, in the prologue.  The strip
schedule of the JAX package (`panel_strips.py`) exists because its kernel
cannot gather, and is not needed here.

Its bound on an H100 (`evp_panel_loop_work`): the inputs read once take
about 0.01 ms and the ~1,100 flops per cell and subcycle about 0.08 ms at
the f32 peak.  What the design cannot remove is the 2 * n_subcycles + 1
grid barriers and, per subcycle, the partials and u, v through L2;
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

import torch

from .. import constants as c
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


def loop_scratch(N: int, dtype, device):
    """The kernel's scratch for panel size N: vertex planes [3, 2, npp],
    partials [4, 6, npc], the exception cells' stresses [2, 3, 6, 12] and
    contributions [2, 72], zeroed once and reused by every call on the
    same (N, dtype, device).  The kernel writes only the positions it
    reads, so the zeros elsewhere (pad columns of the partials) hold."""
    key = (N, dtype, str(device))
    if key not in _scratch:
        npp = 10 * (N + 1) ** 2
        npc = npp + 2
        sizes = (3 * 2 * npp, 4 * 6 * npc, 2 * 3 * 72, 2 * 72)
        flat = torch.zeros(sum(sizes), dtype=dtype, device=device)
        _scratch[key] = torch.split(flat, sizes)
    return _scratch[key]


def launch_shape(info, N: int):
    """What the last launch was: grid, threads per block, dynamic shared
    memory per block, columns per block, and the share of the basis held
    in shared memory."""
    grid, threads, smem, cpb, ns = (int(x) for x in info[1:6])
    ncol = 10 * N * N
    in_smem = sum(min(ns, max(0, min(cpb, ncol - b * cpb)))
                  for b in range(grid))
    return {"grid": grid, "threads": threads, "smem_bytes": smem,
            "columns_per_block": cpb, "smem_columns_per_block": ns,
            "basis_share_in_smem": in_smem / ncol}


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
    (`launch_shape`).
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
    _COUNTS.last_launch = launch_shape(info, panel_n_of(args[0]))
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
        pt.exc_basis_metric, *loop_scratch(N, dt, dev), uv, s_out)] + [
        None if phase_timer is None else phase_timer.data_ptr()]
    ints = (ctypes.c_int * 5)(N, int(n_subcycles), int(bool(include_metric)),
                              n_t, k_t)
    reals = (ctypes.c_double * 7)(
        float(dt_elastic), float(damping_timescale),
        float(c.EVP_ECCENTRICITY_SQ), float(c.PUNY),
        float(c.COS_OCEAN_TURNING_ANGLE), float(c.SIN_OCEAN_TURNING_ANGLE),
        float(c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER))
    info = (ctypes.c_int * 6)()
    fn = _c_function(dt)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream

    def call():
        return fn(ints, c_ptrs, reals, stream, info), info
    # the tensors behind the pointers live as long as the call
    call.held = (vert, cells, uv, s_out, phase_timer)
    return call, (uv[0], uv[1], s_out[0], s_out[1], s_out[2])


evp_panel_loop.launches = 0
evp_panel_loop.inner_launches = 0
evp_panel_loop.last_launch = None
_COUNTS = evp_panel_loop             # the wrapper carries its own counts
