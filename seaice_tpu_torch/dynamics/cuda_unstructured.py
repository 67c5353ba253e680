"""The EVP elastic-subcycle loop for any mesh connectivity: CUDA kernel,
its plain PyTorch version, and the wrappers that choose between them.

Replaces two TPU kernels of `seaice_tpu/dynamics/pallas_unstructured.py`:

  * `build_unstructured_solver` (K1) by `evp_subcycle_loop`: one call runs
    all `n_subcycles` of corner-velocity gather -> Wachspress strain (with
    the tan(lat)/r metric terms) -> EVP stress relaxation ->
    stress-divergence partials -> vertex-side gather-sum -> ocean drag ->
    2x2 momentum solve (reference `mpas_seaice_velocity_solver.F:
    2447-2592`);
  * `build_unstructured_loop_solver` (K6) by the loop form
    `evp_subcycle_prepare` / `evp_subcycle_step` / `evp_subcycle_finish`:
    the same body one subcycle per call, so that the caller refreshes the
    vertex-velocity halo of a partitioned mesh between calls (the
    reference exchanges it after every subcycle, :2546-2584).  `prepare`
    does the checks, the copies and the scratch allocation once per
    solve; `evp_subcycle_step` is one C call; the caller's exchange writes
    the halo entries of `loop.u`, `loop.v` in place.

The CUDA source is `csrc/evp_unstructured.cu`: a cell kernel and a vertex
kernel launched alternately from a host loop inside one C function,
`2*n_subcycles` launches on the current stream with no synchronisation
(two for the one-subcycle entry).  Its bound on an H100 (`evp_loop_work`):
the inputs read once take about 0.01 ms and the ~1,100 flops per cell and
subcycle about 0.08 ms at the f32 peak, so neither roofline term limits
it; what does is streaming the five basis tensors (29.5 MB in f32 at
40,962 cells, resident in the 50 MB L2) once per subcycle, and the launch
latencies.  The kernels therefore keep every corner array in the
[maxEdges, nCells] layout (contiguous loads across a warp) and keep the
divergence a gather, not an atomic scatter.

The wrappers take the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants as c
from . import constitutive
from .momentum import momentum_update
from .variational_fast import (FastTensors, strain_tensor_T,
                               stress_divergence_T)


def _plain_subcycle(ft: FastTensors, u, v, t11, t22, t12, ss_T, p_T,
                    vertex, dte: float, damping_timescale: float,
                    include_metric: bool):
    """One subcycle of the plain version; vertex = (uo_v, vo_v,
    mass_vertex, mass_f, rhs_u0, rhs_v0, ocean_u, ocean_v, solve_velocity,
    area_vertex)."""
    (uo_v, vo_v, mass_vertex, mass_f, rhs_u0, rhs_v0, ocean_u, ocean_v,
     solve_velocity, area_vertex) = vertex
    e11, e22, e12 = strain_tensor_T(ft, u, v, include_metric)
    n11, n22, n12, _ = constitutive.evp_stress_update(
        t11, t22, t12, e11, e22, e12, p_T, dte, damping_timescale)
    t11 = torch.where(ss_T, n11, t11)
    t22 = torch.where(ss_T, n22, t22)
    t12 = torch.where(ss_T, n12, t12)
    div_u, div_v = stress_divergence_T(ft, t11, t22, t12, solve_velocity,
                                       include_metric)
    u, v = momentum_update(
        u, v, div_u, div_v, uo_v, vo_v, mass_vertex, mass_f, rhs_u0,
        rhs_v0, ocean_u, ocean_v, solve_velocity, area_vertex, dte)
    return u, v, t11, t22, t12


def evp_subcycle_loop_plain(ft: FastTensors, u, v, s11T, s22T, s12T,
                            pressure, solve_stress, uo_v, vo_v,
                            mass_vertex, mass_f, rhs_u0, rhs_v0,
                            ocean_u, ocean_v, solve_velocity, area_vertex,
                            *, dt_elastic: float, damping_timescale: float,
                            n_subcycles: int, include_metric: bool):
    """Plain PyTorch version of the kernel: the
    strain_tensor_T -> evp_stress_update -> stress_divergence_T ->
    momentum loop.  Returns (u, v, s11T, s22T, s12T)."""
    ss_T = (solve_stress > 0)[None, :]
    p_T = pressure[None, :]
    vertex = (uo_v, vo_v, mass_vertex, mass_f, rhs_u0, rhs_v0, ocean_u,
              ocean_v, solve_velocity, area_vertex)
    t11, t22, t12 = s11T, s22T, s12T
    for _ in range(int(n_subcycles)):
        u, v, t11, t22, t12 = _plain_subcycle(
            ft, u, v, t11, t22, t12, ss_T, p_T, vertex, float(dt_elastic),
            damping_timescale, include_metric)
    return u, v, t11, t22, t12


def evp_loop_work(nc: int, nv: int, me: int, vd: int, n_subcycles: int,
                  include_metric: bool, itemsize: int):
    """(bytes, flops) of one call: every input read once and every output
    written once; flops of the arithmetic the loop does on them."""
    n_basis = (5 if include_metric else 4) * me * me * nc
    n_in = (n_basis + 2 * me * nc            # voc mask, (voc as int32)
            + 2 * vd * nv                    # corner index + mask
            + 2 * nv                         # denominator, tan(lat)
            + 2 * nv + 3 * me * nc           # u, v, stresses
            + 2 * nc + 10 * nv)              # cell and vertex invariants
    n_out = 2 * nv + 3 * me * nc
    byts = (n_in + n_out) * itemsize
    strain = 8 * me * me + (5 * me if include_metric else 0)
    stress = 40 * me
    partial = 8 * me * me + 2 * me + ((4 * me * me + 4 * me)
                                      if include_metric else 0)
    vertex = 4 * vd + 45
    flops = n_subcycles * (nc * (strain + stress + partial) + nv * vertex)
    return byts, flops


# after the leading ints: 28 pointers, 7 constants, the stream, &count
_TAIL_ARGTYPES = ([ctypes.c_void_p] * 28 + [ctypes.c_double] * 7 +
                  [ctypes.c_void_p] * 2)


def _c_function(dtype, entry="evp_subcycle_loop"):
    """The C entry `evp_subcycle_loop_*` (n_subcycles before the metric
    flag) or `evp_subcycle_step_*` (one subcycle)."""
    from ..kernels.build import get_cuda_lib
    lib = get_cuda_lib("evp_unstructured")
    fn = getattr(lib, entry + ("_f32" if dtype == torch.float32 else "_f64"))
    n_int = 6 if entry == "evp_subcycle_loop" else 5
    fn.argtypes = [ctypes.c_int] * n_int + _TAIL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


class SubcycleLoop:
    """One solve's loop state between `evp_subcycle_prepare` and
    `evp_subcycle_finish`: the working tensors u, v [nVertices] and t11,
    t22, t12 [maxEdges, nCells] (private copies, updated in place by the
    kernel and by the plain version alike, so their addresses hold for
    the kernel's argument list and for the caller's halo exchange), the
    loop invariants, and for CUDA tensors the kernel's argument list,
    fixed at `prepare`."""

    def __init__(self, ft, u, v, t11, t22, t12, pressure, solve_stress,
                 vertex, dt_elastic, damping_timescale, include_metric):
        self.ft = ft
        self.u, self.v, self.t11, self.t22, self.t12 = u, v, t11, t22, t12
        self.pressure, self.solve_stress = pressure, solve_stress
        self.vertex = vertex
        self.dt_elastic = float(dt_elastic)
        self.damping_timescale = float(damping_timescale)
        self.include_metric = bool(include_metric)
        self.scratch = None        # the kernel's [2, nc*me] partials
        self.shape = None          # (nc, nv, me, vd) for the C entries
        self.c_tail = None         # pointers, constants, stream, &count
        self.c_count = None
        self.c_step = None         # (C function, its full argument tuple)


def evp_subcycle_prepare(ft: FastTensors, u, v, s11T, s22T, s12T, pressure,
                         solve_stress, uo_v, vo_v, mass_vertex, mass_f,
                         rhs_u0, rhs_v0, ocean_u, ocean_v, solve_velocity,
                         area_vertex, *, dt_elastic: float,
                         damping_timescale: float, include_metric: bool):
    """Start a loop of `evp_subcycle_step` calls (K6's `prepare`).

    u, v and the ten vertex fields are [nVertices]; s11T, s22T, s12T are
    [maxEdges, nCells]; pressure and solve_stress [nCells];
    rhs_u0 = air stress + surface tilt, summed by the caller.  The inputs
    are not modified: the loop works on copies of u, v and the stresses.
    For CUDA tensors this checks every argument, allocates the scratch and
    fixes the kernel's argument list on the current stream."""
    vertex = tuple(t.contiguous() for t in (
        uo_v, vo_v, mass_vertex, mass_f, rhs_u0, rhs_v0, ocean_u, ocean_v,
        solve_velocity, area_vertex))
    loop = SubcycleLoop(
        ft, u.contiguous().clone(), v.contiguous().clone(),
        *(s.contiguous().clone() for s in (s11T, s22T, s12T)),
        pressure.contiguous(), solve_stress.contiguous(), vertex,
        dt_elastic, damping_timescale, include_metric)
    if u.device.type == "cpu":
        return loop
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    _bind_kernel(loop)
    return loop


def _bind_kernel(loop: SubcycleLoop):
    """Check the loop's tensors for the kernel, allocate its scratch and
    fix its argument lists on the current stream."""
    ft, u = loop.ft, loop.u
    dt, dev = u.dtype, u.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dt}")
    me, nc = ft.voc_T.shape
    vd, nv = ft.flat_corner_idx.shape
    if not 3 <= me <= 10:
        raise ValueError(f"maxEdges {me} outside the kernel's 3..10")
    names = ("uo_v", "vo_v", "mass_vertex", "mass_f", "rhs_u0", "rhs_v0",
             "ocean_u", "ocean_v", "solve_velocity", "area_vertex")
    for name, t in dict(u=loop.u, v=loop.v, **dict(zip(names, loop.vertex))
                        ).items():
        _check(name, t, (nv,), dt, dev)
    for name, t in dict(s11T=loop.t11, s22T=loop.t22, s12T=loop.t12).items():
        _check(name, t, (me, nc), dt, dev)
    _check("pressure", loop.pressure, (nc,), dt, dev)
    _check("solve_stress", loop.solve_stress, (nc,), dt, dev)
    _check("voc_T_i32", ft.voc_T_i32, (me, nc), torch.int32, dev)
    _check("voc_mask_T", ft.voc_mask_T, (me, nc), dt, dev)
    _check("basis_grad_T", ft.basis_grad_T, (me, 2, me, nc), dt, dev)
    _check("basis_int_T", ft.basis_int_T, (me, 2, me, nc), dt, dev)
    _check("basis_metric_T", ft.basis_metric_T, (me, me, nc), dt, dev)
    _check("flat_corner_idx_i32", ft.flat_corner_idx_i32, (vd, nv),
           torch.int32, dev)
    _check("cov_mask_T", ft.cov_mask_T, (vd, nv), dt, dev)
    _check("denominator", ft.denominator, (nv,), dt, dev)
    _check("tan_lat_vertex", ft.tan_lat_vertex, (nv,), dt, dev)

    loop.scratch = torch.empty((2, nc * me), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    loop.c_count = ctypes.c_int(0)
    loop.shape = (nc, nv, me, vd)
    loop.c_tail = tuple(t.data_ptr() for t in (
        ft.voc_T_i32, ft.voc_mask_T, ft.basis_grad_T, ft.basis_int_T,
        ft.basis_metric_T, ft.flat_corner_idx_i32, ft.cov_mask_T,
        ft.denominator, ft.tan_lat_vertex, loop.u, loop.v, loop.t11,
        loop.t22, loop.t12, loop.pressure, loop.solve_stress, *loop.vertex,
        loop.scratch[0], loop.scratch[1])) + (
        loop.dt_elastic, loop.damping_timescale,
        float(c.EVP_ECCENTRICITY_SQ), float(c.PUNY),
        float(c.COS_OCEAN_TURNING_ANGLE), float(c.SIN_OCEAN_TURNING_ANGLE),
        float(c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER), stream,
        ctypes.byref(loop.c_count))
    loop.c_step = (_c_function(dt, "evp_subcycle_step"),
                   loop.shape + (int(loop.include_metric),) + loop.c_tail)


def evp_subcycle_finish(loop: SubcycleLoop):
    """End the loop (K6's `finish`): (u, v, s11T, s22T, s12T)."""
    return loop.u, loop.v, loop.t11, loop.t22, loop.t12


def evp_subcycle_step_plain(loop: SubcycleLoop):
    """Plain PyTorch version of one `evp_subcycle_step`: one iteration of
    `evp_subcycle_loop_plain`, on tensors of any device, written into the
    loop's u, v and stresses."""
    new = _plain_subcycle(
        loop.ft, loop.u, loop.v, loop.t11, loop.t22, loop.t12,
        (loop.solve_stress > 0)[None, :], loop.pressure[None, :],
        loop.vertex, loop.dt_elastic, loop.damping_timescale,
        loop.include_metric)
    for t, n in zip(evp_subcycle_finish(loop), new):
        t.copy_(n)


def evp_subcycle_step(loop: SubcycleLoop):
    """One elastic subcycle of a loop begun by `evp_subcycle_prepare`.

    CPU tensors take the plain version.  CUDA tensors make one call of
    `evp_subcycle_step_*` in `csrc/evp_unstructured.cu` (a cell and a vertex
    launch, in place, on the stream fixed at `prepare`) and add one to
    `evp_subcycle_step.launches`; `.inner_launches` accumulates the kernel
    launches."""
    if loop.u.device.type == "cpu":
        evp_subcycle_step_plain(loop)
        return
    fn, args = loop.c_step
    err = fn(*args)
    evp_subcycle_step.inner_launches += loop.c_count.value
    if err != 0:
        raise RuntimeError(
            f"evp_subcycle_step: CUDA error {err} after "
            f"{loop.c_count.value} launches")
    evp_subcycle_step.launches += 1


evp_subcycle_step.launches = 0
evp_subcycle_step.inner_launches = 0


def evp_subcycle_loop(ft: FastTensors, u, v, s11T, s22T, s12T, pressure,
                      solve_stress, uo_v, vo_v, mass_vertex, mass_f,
                      rhs_u0, rhs_v0, ocean_u, ocean_v, solve_velocity,
                      area_vertex, *, dt_elastic: float,
                      damping_timescale: float, n_subcycles: int,
                      include_metric: bool):
    """Run all `n_subcycles` elastic subcycles.

    Arguments as for `evp_subcycle_prepare`.  Returns new
    (u, v, s11T, s22T, s12T); the inputs are not modified.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    `csrc/evp_unstructured.cu` (float32 or float64) and add one to
    `evp_subcycle_loop.launches`; `evp_subcycle_loop.inner_launches`
    accumulates the kernel launches made inside those calls.
    """
    args = (ft, u, v, s11T, s22T, s12T, pressure, solve_stress, uo_v, vo_v,
            mass_vertex, mass_f, rhs_u0, rhs_v0, ocean_u, ocean_v,
            solve_velocity, area_vertex)
    kw = dict(dt_elastic=dt_elastic, damping_timescale=damping_timescale,
              include_metric=include_metric)
    if u.device.type == "cpu":
        return evp_subcycle_loop_plain(*args, n_subcycles=n_subcycles, **kw)
    loop = evp_subcycle_prepare(*args, **kw)
    fn = _c_function(u.dtype)
    err = fn(*loop.shape, int(n_subcycles), int(loop.include_metric),
             *loop.c_tail)
    evp_subcycle_loop.inner_launches += loop.c_count.value
    if err != 0:
        raise RuntimeError(
            f"evp_subcycle_loop: CUDA error {err} after "
            f"{loop.c_count.value} launches")
    evp_subcycle_loop.launches += 1
    return evp_subcycle_finish(loop)


evp_subcycle_loop.launches = 0
evp_subcycle_loop.inner_launches = 0
