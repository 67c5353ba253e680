"""Copies of the port's work counts, the operations and bytes behind each
kernel's roofline share, kept here so that a later change to the port
cannot change the yardstick:
  * `evp_panel_loop_work`: `dynamics/cuda_panel_fused.py` (K3, the panel
    sphere);
  * `flux_work`: `transport/cuda_flux.py` (K2, the remap's flux
    integration), counted from the inputs of a call; split in two so that
    the counts are read on the device (`flux_work_start`) and finished
    after the window (`flux_work_finish`).
Every input byte is read once and every output byte written once.  The
benchmark's tests hold them equal to the port's functions at several
shapes."""

import numpy as np
import torch


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


def flux_work(tree, recon, cell, area, mask_edge,
              itemsize: int):
    """(bytes, flops) of one call for THESE inputs: the reconstruction
    coefficients of the cells that non-empty slots of unmasked edges
    touch, the quadrature points of those slots, the per-slot area and
    cell index and the edge mask read once; the fluxes written once;
    flops of the pointwise evaluation those slots need (per 2D column and
    point 4 flops a linear factor of its chain and 1 a product, per 3D
    column and point 6, then 2 a point for the weights and 2 for the
    area)."""
    return flux_work_finish(flux_work_start(tree, recon, cell, area,
                                            mask_edge), itemsize)


def flux_work_start(tree, recon, cell, area, mask_edge):
    """What `flux_work` reads of a call's inputs, without waiting for the
    device: the tracers' shapes, (nE, S), and the active slots and the
    cells they touch as 0-d tensors (so that a traced window holds no
    input of the call and makes no host synchronise)."""
    nE, S = cell.shape
    active = (area != 0) & (mask_edge[:, None] != 0)
    nc = recon[tree.root.name]["center"].shape[0]
    touched = torch.zeros(nc, dtype=torch.int32, device=cell.device)
    touched.index_add_(0, cell.reshape(-1).clamp(min=0),
                       active.reshape(-1).to(torch.int32))
    shapes = {s.name: tuple(recon[s.name]["center"].shape[1:])
              for s in tree.specs}
    return tree, shapes, (nE, S), active.sum(), (touched > 0).sum()


def flux_work_finish(start, itemsize: int):
    """`flux_work`'s (bytes, flops, active slots) from `flux_work_start`."""
    tree, shapes, (nE, S), n_active, n_cells = start
    n_active, n_cells = int(n_active), int(n_cells)
    n_coef = 0      # reconstruction values per cell
    n_out = 0
    fl = 0
    for spec in tree.specs:
        shp = shapes[spec.name]
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
