"""Special boundaries: test-harness Dirichlet overrides.

The port of the JAX package's `special_boundaries.py`, a re-design of
MPAS-Seaice `mpas_seaice_special_boundaries.F` (init :61, setters
:253-415): masked overrides of velocity and tracer values at marked
vertices and cells, applied after each solve or advection step.  Nothing
in the model calls it; it is configured programmatically (the namelist's
`config_use_special_boundaries_velocity` is `unsupported`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .utils.containers import tensor_dataclass
from .utils.device import resolve_device


@tensor_dataclass
class SpecialBoundaries:
    """Dirichlet boundary description (device tensors)."""
    vertex_mask: Any       # [nVertices] {0,1}: override velocity here
    u_value: Any           # [nVertices]
    v_value: Any
    cell_mask: Any         # [nCells] {0,1}: override tracers here
    tracer_values: Dict[str, Any]   # name -> [nCells, ...] target values


def no_special_boundaries(n_vertices: int, n_cells: int,
                          dtype=torch.float64, device=None
                          ) -> SpecialBoundaries:
    """Boundaries that override nothing, on `device` (None: the card)."""
    device = resolve_device(device)

    def z(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return SpecialBoundaries(vertex_mask=z(n_vertices), u_value=z(n_vertices),
                             v_value=z(n_vertices), cell_mask=z(n_cells),
                             tracer_values={})


def apply_velocity_boundaries(sb: SpecialBoundaries, u, v):
    """(reference seaice_set_special_boundaries_velocity :253)"""
    m = sb.vertex_mask > 0
    return torch.where(m, sb.u_value, u), torch.where(m, sb.v_value, v)


def apply_tracer_boundaries(sb: SpecialBoundaries,
                            tracers: Dict[str, Any]) -> Dict[str, Any]:
    """(reference seaice_set_special_boundaries_tracers :345)"""
    out = dict(tracers)
    for name, target in sb.tracer_values.items():
        if name not in out:
            continue
        cur = out[name]
        m = sb.cell_mask
        m = m.reshape(m.shape + (1,) * (cur.ndim - m.ndim)) > 0
        out[name] = torch.where(m, target, cur)
    return out
