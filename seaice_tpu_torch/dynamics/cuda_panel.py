"""The cell side of ONE elastic subcycle on the panel-reordered sphere:
CUDA kernel, its plain PyTorch version, and the wrappers that choose
between them.

Replaces the TPU kernel `build_panel_cell_kernel` of
`seaice_tpu/dynamics/pallas_panel.py`: strain from the six corner values,
EVP stress relaxation, stress-divergence partials, in one launch per
subcycle.  The route of `use_fused_panel_loop=False`: the seam-ghost
refresh, the dual sum, the 12 exception cells and the momentum solve run
in PyTorch between two launches (`evp.py`), about 40 small torch
operations per subcycle, so this route is bound by the host, not by its
kernel.

The loop form binds once per solve: `panel_cell_prepare` checks every
tensor, allocates the loop's buffers (the vertex planes, a pair of stress
buffers [3, 6, npc] and the partials [6, npc, F]) and fixes the C call's
argument lists on the current stream; `panel_cell_step` is then one C
call and one launch, with no torch operation.  Between steps the caller
fills `loop.planes` (`variational_panel.velocity_planes(..., out=)`),
reads the new stresses `loop.current` and the old ones `loop.previous`,
writes the exception columns of `loop.current`, and hands
`loop.partials` to the dual sum.

Corners: the kernel reads the two padded vertex planes `[2, npp, F]`
(u, v, and tan(lat)/r with metric terms) with their seam ghosts, in the
layout `velocity_planes` builds, at the six static offsets itself; the
six pre-shifted copies of the planes that the TPU kernel needs are not
made.  The mask it is given has the exception columns zeroed: their
stress is copied unchanged, for the caller's ring-indexed update.

Its bound on an H100 (`panel_cell_work`) is bytes: the three basis tensors
(30.4 MB in f32 at N = 64) plus about 4 MB of stresses and partials per
launch, about 0.010 ms at 3.35 TB/s.  The CUDA source is
`csrc/evp_panel_cell.cu` (with `csrc/evp_panel_common.cuh`, which the
whole-loop route shares).

`panel_cell_step` takes the plain version only for a loop on the CPU; on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import constants as c
from . import constitutive
from .cuda_panel_fused import check_panel_tensors
from .cuda_unstructured import _check
from .variational_panel import (PanelTensors, corner_values,
                                divergence_partials, panel_n_of,
                                strain_from_corners)


def panel_cell_plain(pt: PanelTensors, planes, t11, t22, t12, pressure,
                     ss_mask, *, dt_elastic: float,
                     damping_timescale: float, include_metric: bool):
    """Plain PyTorch version of the kernel: the contractions of
    `strain_tensor_P` and `divergence_partials` on the corners read from
    the given planes.  Returns (t11, t22, t12 [6, npc], partials
    [6, npc, 2 or 4])."""
    N = panel_n_of(pt)
    corner = corner_values(pt, N, planes)
    e11, e22, e12 = strain_from_corners(pt, corner, include_metric)
    n11, n22, n12, _ = constitutive.evp_stress_update(
        t11, t22, t12, e11, e22, e12, pressure[None, :],
        float(dt_elastic), damping_timescale)
    ss = (ss_mask > 0)[None, :]
    t11 = torch.where(ss, n11, t11)
    t22 = torch.where(ss, n22, t22)
    t12 = torch.where(ss, n12, t12)
    return t11, t22, t12, divergence_partials(pt, t11, t22, t12,
                                              include_metric)


def panel_cell_work(N: int, include_metric: bool, itemsize: int):
    """(bytes, flops) of one launch: every input read once and every
    output written once; flops of the arithmetic done on them."""
    npp = 10 * (N + 1) ** 2
    npc = npp + 2
    nf_in, nf_out = (3, 4) if include_metric else (2, 2)
    n_in = ((5 if include_metric else 4) * 36 * npc     # basis
            + nf_in * 2 * npp + 3 * 6 * npc + 2 * npc)  # planes, stress
    n_out = 3 * 6 * npc + nf_out * 6 * npc
    me = 6
    strain = 8 * me * me + (5 * me if include_metric else 0)
    stress = 40 * me
    partial = 8 * me * me + 2 * me + ((4 * me * me) if include_metric
                                      else 0)
    return (n_in + n_out) * itemsize, npp * (strain + stress + partial)


class PanelCellLoop:
    """One solve's buffers between `panel_cell_prepare` and the last
    `panel_cell_step`: the vertex planes [2, npp, F] that the caller
    fills before each step, a pair of stress buffers [2, 3(s11, s22,
    s12), 6, npc] of which `parity` names the current one, the partials
    [6, npc, 2 or 4], the loop invariants, and for CUDA tensors the two C
    calls (current buffer 0 or 1 as the source), fixed at `prepare`."""

    def __init__(self, pt, N, planes, stress, partials, pressure, ss_mask,
                 kw):
        self.pt, self.N = pt, N
        self.planes, self.stress, self.partials = planes, stress, partials
        self.pressure, self.ss_mask = pressure, ss_mask
        self.kw = kw
        self.parity = 0
        self.calls = None
        self._views = tuple(tuple(b.unbind(0)) for b in stress)

    @property
    def current(self):
        """(t11, t22, t12) [6, npc] after the last step: views of the
        current buffer, which the caller may write in place."""
        return self._views[self.parity]

    @property
    def previous(self):
        """(t11, t22, t12) before the last step (overwritten by the next)."""
        return self._views[1 - self.parity]


def panel_cell_prepare(pt: PanelTensors, pressure, ss_mask, t11, t22, t12,
                       *, dt_elastic: float, damping_timescale: float,
                       include_metric: bool):
    """Begin a loop of `panel_cell_step` calls.

    pressure and ss_mask are padded columns [npc], the mask with the
    exception columns zeroed; t11, t22, t12 the slot-indexed stresses
    [6, npc], copied into the loop's current buffer (the inputs are not
    modified).  For CUDA tensors this checks every tensor the kernel
    reads and fixes its argument lists on the current stream."""
    N = panel_n_of(pt)
    npp = 10 * (N + 1) ** 2
    npc = npp + 2
    nf_in, nf_out = (3, 4) if include_metric else (2, 2)
    dt, dev = t11.dtype, t11.device
    stress = torch.empty((2, 3, 6, npc), dtype=dt, device=dev)
    for s, t in zip(stress[0], (t11, t22, t12)):
        s.copy_(t)
    loop = PanelCellLoop(
        pt, N, torch.zeros((2, npp, nf_in), dtype=dt, device=dev), stress,
        torch.zeros((6, npc, nf_out), dtype=dt, device=dev),
        pressure.contiguous(), ss_mask.contiguous(),
        dict(dt_elastic=float(dt_elastic),
             damping_timescale=float(damping_timescale),
             include_metric=bool(include_metric)))
    if dev.type == "cpu":
        return loop
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _bind(loop)
    return loop


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 +
             [ctypes.c_double] * 4 + [ctypes.c_void_p])


def _c_function(dtype):
    from ..kernels.build import get_cuda_lib
    lib = get_cuda_lib("evp_panel_cell")
    fn = getattr(lib, "panel_cell_f32" if dtype == torch.float32
                 else "panel_cell_f64")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _bind(loop: PanelCellLoop):
    """Check what the kernel reads and fix its two argument lists (source
    buffer 0 or 1) on the current stream."""
    pt, N = loop.pt, loop.N
    dt, dev = loop.stress.dtype, loop.stress.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dt}")
    npc = 10 * (N + 1) ** 2 + 2
    check_panel_tensors(pt, N, dt, dev)
    _check("pressure", loop.pressure, (npc,), dt, dev)
    _check("ss_mask", loop.ss_mask, (npc,), dt, dev)
    fn = _c_function(dt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    head = (N, int(loop.kw["include_metric"]), loop.planes.data_ptr(),
            pt.basis_grad_S.data_ptr(), pt.basis_int_S.data_ptr(),
            pt.basis_metric_S.data_ptr(), loop.pressure.data_ptr(),
            loop.ss_mask.data_ptr())
    tail = (loop.partials.data_ptr(), loop.kw["dt_elastic"],
            loop.kw["damping_timescale"], float(c.EVP_ECCENTRICITY_SQ),
            float(c.PUNY), stream)
    buf = [b.data_ptr() for b in loop.stress]
    loop.calls = tuple(functools.partial(fn, *head, buf[i], buf[1 - i],
                                         *tail) for i in (0, 1))


def panel_cell_step_plain(loop: PanelCellLoop):
    """Plain PyTorch version of one `panel_cell_step`, on tensors of any
    device: `panel_cell_plain` on the loop's planes and current stresses,
    written into the other buffer and the partials."""
    src, dst = loop.stress[loop.parity], loop.stress[1 - loop.parity]
    *new, part = panel_cell_plain(loop.pt, loop.planes, *src, loop.pressure,
                                  loop.ss_mask, **loop.kw)
    for d, x in zip(dst, new):
        d.copy_(x)
    loop.partials.copy_(part)
    loop.parity = 1 - loop.parity


def panel_cell_step(loop: PanelCellLoop):
    """The cell side of one subcycle of a loop begun by
    `panel_cell_prepare`, on the planes the caller wrote into
    `loop.planes`: the stresses go from the current buffer into the other,
    which becomes current, and the partials into `loop.partials`.

    A loop on the CPU takes the plain version.  On CUDA tensors: one C call
    of `csrc/evp_panel_cell.cu` (float32 or float64), one launch on the
    stream fixed at `prepare`, and one added to `panel_cell_step.launches`.
    """
    if loop.stress.device.type == "cpu":
        panel_cell_step_plain(loop)
        return
    _launch(loop)


def _launch(loop: PanelCellLoop):
    """The C call fixed at `prepare` for the current buffer."""
    err = loop.calls[loop.parity]()
    if err != 0:
        raise RuntimeError(f"panel_cell_step: CUDA error {err}")
    loop.parity = 1 - loop.parity
    panel_cell_step.launches += 1


panel_cell_step.launches = 0
