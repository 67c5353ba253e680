"""The remap's repair of sliver tracers against the JAX package's, on a
state whose melt ponds are rounding noise (float64, CPU).

Where a tracer's new parent mass is under 1e-8, both packages clamp the
recovered tracer to the range it had, before the remap, over the cells
whose parent mass exceeded 1e-11 (`update_mass_and_tracers`).  With
pond fractions of 1e-13 to 1e-9 every pond depth is such a sliver, and
the deeper ponds of the cells under 1e-11 are clamped down: the
pond-depth product's global sum is not conserved, in the reference as in
the port, while every product above the sliver floor is.  This is the
loss that `chip_smoke.py`'s file-driven run reads in the pond tracers
(ROADMAP Queue 3, fault 7)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seaice_tpu.testcases import box as jbox
from seaice_tpu.transport import remap as JR
from seaice_tpu.transport import standard_tracer_tree as jtree
from seaice_tpu.transport.geometry import build_remap_geometry as jgeom
from seaice_tpu_torch.testcases import box as tbox
from seaice_tpu_torch.transport.geometry import build_remap_geometry
from seaice_tpu_torch.transport.remap import (global_conserved_sums,
                                              make_remap_step)
from seaice_tpu_torch.transport.tracers import standard_tracer_tree

torch.set_num_threads(1)

N_CAT, N_ICE, DT = 3, 4, 900.0


def _noise_pond_state(mesh):
    """Box ice with level ponds of rounding-noise area: pond fractions
    log-uniform in [1e-13, 1e-9], the ponds under 1e-11 deeper (2 to 4
    cm) than the others (under 0.5 cm), lids under 1 mm."""
    rng = np.random.default_rng(0)
    nc = mesh.n_cells
    area, vol, _ = (np.asarray(a) for a in tbox.box_initial_state(mesh,
                                                                   N_CAT))
    apnd = 10.0 ** rng.uniform(-13.0, -9.0, (nc, N_CAT))
    hpnd = np.where(apnd < 1e-11, 0.02 + 0.02 * rng.random((nc, N_CAT)),
                    0.005 * rng.random((nc, N_CAT)))
    return {"iceAreaCategory": area, "iceVolumeCategory": vol,
            "snowVolumeCategory": 0.1 * area,
            "surfaceTemperature": -10.0 + rng.random((nc, N_CAT)),
            "iceEnthalpy": -2e8 * (1.0 + 0.1 * rng.random((nc, N_CAT,
                                                            N_ICE))),
            "iceSalinity": 4.0 + rng.random((nc, N_CAT, N_ICE)),
            "snowEnthalpy": -1e8 * (1.0 + 0.1 * rng.random((nc, N_CAT, 1))),
            "levelIceArea": np.ones((nc, N_CAT)),
            "levelIceVolume": vol.copy(),
            "pondArea": apnd, "pondDepth": hpnd,
            "pondLidThickness": 1e-3 * rng.random((nc, N_CAT))}


@pytest.fixture(scope="module")
def reference_remap():
    """The JAX package's remap step (jitted once) on the 8 x 8 box."""
    mesh = jbox.box_test_mesh(8, 8)
    tree = jtree(n_ice_layers=N_ICE, n_snow_layers=1, pond_scheme="lvl")
    rt, mt = jgeom(mesh).tensors(jnp.float64), mesh.tensors(jnp.float64)
    step = jax.jit(JR.make_remap_step(tree, mesh.vertex_degree,
                                      use_pallas_flux=False))
    ac = jnp.asarray(mesh.area_cell)

    def run(state, u, v):
        st = {k: jnp.asarray(a) for k, a in state.items()}
        out = step(rt, mt.cells_on_cell, mt.cells_on_cell_mask, ac, st,
                   jnp.asarray(u), jnp.asarray(v), DT)
        s0, s1 = (JR.global_conserved_sums(tree, x, ac) for x in (st, out))
        return ({k: np.asarray(a) for k, a in out.items()},
                {k: float((s1[k] - s0[k]) / s0[k]) for k in s0})
    return run


@pytest.mark.parametrize("flow", ["moving", "at rest"])
def test_sliver_repair_matches_reference(reference_remap, flow):
    """One remap of the noise-pond state, the ice moving (random vertex
    velocities of 0.12 m/s) or at rest: the port's tracers equal the
    reference's to 1e-13 of each field's max, and so does the relative
    change of every product's global sum (to 1e-13).  Both lose the same
    share of the pond-depth product (measured 6.7% moving), while every
    product whose parent mass lies above the sliver floor keeps its sum
    to 1e-13."""
    mesh = tbox.box_test_mesh(8, 8)
    tree = standard_tracer_tree(n_ice_layers=N_ICE, n_snow_layers=1,
                                pond_scheme="lvl")
    state = _noise_pond_state(mesh)
    nv = mesh.n_vertices
    rng = np.random.default_rng(3)
    u, v = (0.12 * rng.standard_normal(nv), 0.12 * rng.standard_normal(nv)) \
        if flow == "moving" else (np.zeros(nv), np.zeros(nv))
    rt = build_remap_geometry(mesh).tensors(torch.float64, "cpu")
    mt = mesh.tensors(torch.float64, "cpu")
    ac = torch.as_tensor(mesh.area_cell)
    st = {k: torch.as_tensor(a) for k, a in state.items()}
    out = make_remap_step(tree, mesh.vertex_degree)(
        rt, mt.cells_on_cell, mt.cells_on_cell_mask, ac, st,
        torch.as_tensor(u), torch.as_tensor(v), DT)
    s0, s1 = (global_conserved_sums(tree, x, ac) for x in (st, out))
    change = {k: float((s1[k] - s0[k]) / s0[k]) for k in s0}

    ref, ref_change = reference_remap(state, u, v)
    for k, a in ref.items():
        scale = max(float(np.abs(a).max()), 1e-300)
        assert float(np.abs(out[k].numpy() - a).max()) <= 1e-13 * scale, k
    for k in ref_change:
        assert abs(change[k] - ref_change[k]) <= 1e-13, (k, change[k],
                                                         ref_change[k])
    print(f"\n{flow}: pond-depth product {change['pondDepth']:.3e} "
          f"(reference {ref_change['pondDepth']:.3e})")
    assert change["pondDepth"] < -1e-2
    for k in change:
        if k not in ("pondDepth", "pondLidThickness"):
            assert abs(change[k]) <= 1e-13, (k, change[k])
