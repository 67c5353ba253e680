"""The port's IR flux integration (`remap.integrate_fluxes`, the plain
version the CUDA kernel is held against on the card, and the packed
coefficient table the kernel reads) against the JAX package's XLA
formulation and its Pallas kernel in interpret mode.  float64, explicit
full-enthalpy tracer tree, column package off."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from seaice_tpu import config as jconfig
from seaice_tpu_torch import config as tconfig
from seaice_tpu.testcases import box as jbox
from seaice_tpu_torch.testcases import box as tbox

torch.set_num_threads(1)


def _cfg(c):
    return c.Config(
        run=c.RunConfig(dt=1800.0, n_categories=3, n_ice_layers=4),
        velocity=c.VelocitySolverConfig(elastic_subcycle_number=2),
        advection=c.AdvectionConfig(),
        column=c.ColumnConfig(use_column_package=False))


def _velocities(nv):
    rng = np.random.default_rng(3)
    return (0.12 * rng.standard_normal(nv), 0.12 * rng.standard_normal(nv))


def _reference():
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.transport import remap as R, standard_tracer_tree
    from seaice_tpu.transport.pallas_flux import integrate_fluxes_fused
    mesh = jbox.box_test_mesh(8, 8)
    model = SeaIceModel(mesh, _cfg(jconfig), dtype=jnp.float64,
                        tracer_tree=standard_tracer_tree(
                            n_ice_layers=4, n_snow_layers=1))
    area, vol, snow = jbox.box_initial_state(mesh, 3)
    state = model.init_state(area, vol, snow)
    tree, rt = model.tree, model.tensors.remap
    coc = model.tensors.mesh.cells_on_cell
    cocm = model.tensors.mesh.cells_on_cell_mask
    uv, vv = (jnp.asarray(a) for a in _velocities(mesh.n_vertices))

    # one jitted program: compiling it once costs less than running the
    # stages op by op
    @jax.jit
    def run(rt, coc, cocm, tracers, uv, vv):
        fields = R.to_transport_fields(tree, tracers)
        mask_cell, masks = R.make_masks(tree, fields)
        recon = R.reconstruct_fields(tree, fields, masks, mask_cell, rt,
                                     coc, cocm, monotonic=True)
        dpx, dpy = R.departure_points(uv, vv, 900.0)
        tris = R.find_departure_triangles(rt, dpx, dpy,
                                          mesh.vertex_degree)
        cell, xq, yq, tarea = R.triangles_to_cell_coords(rt, tris)
        f_xla = R.integrate_fluxes(tree, recon, rt, cell, xq, yq, tarea,
                                   tris["mask_edge"])
        f_pl = integrate_fluxes_fused(tree, recon, rt, tris["cell_slot"],
                                      xq, yq, tarea, tris["mask_edge"],
                                      interpret=True, K=16)
        stages = dict(recon=recon, cell=cell, xq=xq, yq=yq, area=tarea,
                      mask_edge=tris["mask_edge"])
        return stages, f_xla, f_pl

    stages, f_xla, f_pl = run(rt, coc, cocm, dict(state.tracers), uv, vv)
    return stages, f_xla, f_pl


def _port():
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.transport import remap as R
    from seaice_tpu_torch.transport.tracers import standard_tracer_tree
    mesh = tbox.box_test_mesh(8, 8)
    model = SeaIceModel(mesh, _cfg(tconfig), dtype=torch.float64,
                        device="cpu", tracer_tree=standard_tracer_tree(
                            n_ice_layers=4, n_snow_layers=1))
    area, vol, snow = tbox.box_initial_state(mesh, 3)
    state = model.init_state(area, vol, snow)
    tree, rt = model.tree, model.tensors.remap
    coc = model.tensors.mesh.cells_on_cell
    cocm = model.tensors.mesh.cells_on_cell_mask
    uv, vv = (torch.as_tensor(a) for a in _velocities(mesh.n_vertices))
    fields = R.to_transport_fields(tree, dict(state.tracers))
    mask_cell, masks = R.make_masks(tree, fields)
    recon = R.reconstruct_fields(tree, fields, masks, mask_cell, rt,
                                 coc, cocm, monotonic=True)
    dpx, dpy = R.departure_points(uv, vv, 900.0)
    tris = R.find_departure_triangles(rt, dpx, dpy, mesh.vertex_degree)
    cell, xq, yq, tarea = R.triangles_to_cell_coords(rt, tris)
    args = (tree, recon, rt, cell, xq, yq, tarea, tris["mask_edge"])
    stages = dict(recon=recon, cell=cell, xq=xq, yq=yq, area=tarea,
                  mask_edge=tris["mask_edge"])
    return stages, args


def _close(got, ref, tol, name):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=name)


def test_flux_integration_matches_reference_and_pallas_interpret():
    from seaice_tpu_torch.transport import remap as R
    from seaice_tpu_torch.transport import cuda_flux
    stages_j, f_xla, f_pl = _reference()
    stages_t, args = _port()
    # the stages that feed the kernel, to 1e-12 of each array's max
    for name in ("xq", "yq", "area", "mask_edge"):
        _close(stages_t[name].numpy(), stages_j[name], 1e-12, name)
    assert np.array_equal(stages_t["cell"].numpy(),
                          np.asarray(stages_j["cell"]))
    for name, r in stages_j["recon"].items():
        for part in ("center", "gx", "gy"):
            _close(stages_t["recon"][name][part].numpy(), r[part], 1e-12,
                   f"recon {name} {part}")
    # the fluxes: 1e-11 of each field's max against XLA and against the
    # TPU kernel in interpret mode (its sums run in another order)
    before = cuda_flux.integrate_fluxes_cuda.launches
    plain = R.integrate_fluxes(*args)
    wrapped = cuda_flux.integrate_fluxes_cuda(*args)
    assert cuda_flux.integrate_fluxes_cuda.launches == before
    assert set(plain) == set(f_xla)
    for k in f_xla:
        assert tuple(plain[k].shape) == tuple(f_xla[k].shape), k
        _close(plain[k].numpy(), f_xla[k], 1e-11, k + " vs XLA")
        _close(plain[k].numpy(), f_pl[k], 1e-11, k + " vs Pallas")
        assert torch.equal(plain[k], wrapped[k]), k


def test_packed_table_reproduces_fluxes():
    """What the CUDA kernel does with the packed table of linear
    coefficients and its column table (each tracer product evaluated as a
    chain of linear factors at the six quadrature points), replayed in
    numpy, gives the plain version's fluxes: 1e-12 of each field's max."""
    from seaice_tpu_torch.transport import remap as R
    from seaice_tpu_torch.transport.cuda_flux import flux_layout, linear_table
    _, args = _port()
    tree, recon, rt, cell, xq, yq, area, mask_edge = args
    want = R.integrate_fluxes(*args)
    meta, out2d, out3d = flux_layout(tree, recon)
    table = linear_table(tree, recon).numpy()
    assert meta.dtype == np.int32
    col, st, par = meta
    T2 = sum(n for _, n, _ in out2d)
    cell, area, me = cell.numpy(), area.numpy(), mask_edge.numpy()
    xq, yq, w = xq.numpy(), yq.numpy(), rt.qp_weights.numpy()
    nE, S = cell.shape
    out = np.zeros((nE, meta.shape[1]))
    for e in range(nE):
        if me[e] == 0:
            continue
        for s in range(S):
            if area[e, s] == 0:
                continue
            row, x, y = table[cell[e, s]], xq[e, s], yq[e, s]

            def factor(k):
                return row[col[k]] + row[col[k] + st[k]] * x + \
                    row[col[k] + 2 * st[k]] * y

            v = np.ones((T2, 6))
            for o in range(T2):
                k = o
                while k >= 0:
                    v[o] *= factor(k)
                    k = par[k]
            for m in range(meta.shape[1]):
                vals = v[m] if m < T2 else v[par[m]] * factor(m)
                out[e, m] += (w * vals).sum() * area[e, s]
    out *= me[:, None]
    for name, ncat, o in out2d:
        _close(out[:, o:o + ncat], want[name].numpy(), 1e-12, name)
    for name, ncat, nl, o in out3d:
        _close(out[:, T2 + o:T2 + o + ncat * nl].reshape(nE, ncat, nl),
               want[name].numpy(), 1e-12, name)
