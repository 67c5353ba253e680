"""The remap's repair of sliver tracers against the JAX package's, on a
state whose melt ponds are rounding noise (float64, CPU), and the remap
of mass products below float32's smallest normal number (float32, CPU).

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


def _subnormal_pond_state(mesh):
    """The noise-pond state in float32 with real ponds (fractions 0.05 to
    0.3 of the level ice) and 30% of the categories at the ice edge: ice
    area log-uniform in [1e-8, 1e-6] and pond fractions in [1e-34,
    1e-30], so that their mass product a * alvl * apnd lies mostly below
    float32's smallest normal number (1.2e-38)."""
    state = _noise_pond_state(mesh)
    rng = np.random.default_rng(5)
    shape = state["iceAreaCategory"].shape
    edge = rng.random(shape) < 0.3
    area = np.where(edge, 10.0 ** rng.uniform(-8.0, -6.0, shape),
                    state["iceAreaCategory"])
    hi = state["iceVolumeCategory"] / np.maximum(
        state["iceAreaCategory"], 1e-300)
    state.update(
        iceAreaCategory=area, iceVolumeCategory=area * hi,
        levelIceVolume=area * hi, snowVolumeCategory=0.1 * area,
        pondArea=np.where(edge, 10.0 ** rng.uniform(-34.0, -30.0, shape),
                          rng.uniform(0.05, 0.3, shape)))
    return {k: a.astype(np.float32) for k, a in state.items()}


@pytest.fixture(scope="module")
def jax_box():
    """The JAX package's 8 x 8 box, its tracer tree and its remap
    geometry."""
    mesh = jbox.box_test_mesh(8, 8)
    return (mesh, jtree(n_ice_layers=N_ICE, n_snow_layers=1,
                        pond_scheme="lvl"), jgeom(mesh))


@pytest.fixture(scope="module")
def reference_remap(jax_box):
    """The JAX package's remap step on the 8 x 8 box, jitted once for each
    dtype: run(state, u, v, dtype)."""
    mesh, tree, geom = jax_box
    step = jax.jit(JR.make_remap_step(tree, mesh.vertex_degree,
                                      use_pallas_flux=False))

    def run(state, u, v, dtype=jnp.float64):
        rt, mt = geom.tensors(dtype), mesh.tensors(dtype)
        ac = jnp.asarray(mesh.area_cell, dtype)
        st = {k: jnp.asarray(a, dtype) for k, a in state.items()}
        u, v = (jnp.asarray(x, dtype) for x in (u, v))
        out = step(rt, mt.cells_on_cell, mt.cells_on_cell_mask, ac, st,
                   u, v, DT)
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


# fields below NOISE in the reference are rounding noise (ROADMAP Queue 3
# fault 4): the port's are held below NOISE too, not pointwise
NOISE = 1e-8
F32_LIMIT = 1e-5


def test_subnormal_mass_products_stay_finite_in_float32(reference_remap):
    """One float32 remap of the ice-edge state of `_subnormal_pond_state`,
    the ice moving.  The JAX package flushes the subnormal mass products
    to zero, so its barycenters and recovered pond tracers stay finite;
    the port's must too, where before it took 1 / 1e-40 = inf into the
    pond-depth and lid barycenters (ROADMAP Queue 3 fault 16).  Every
    tracer agrees with the reference to F32_LIMIT of its max,
    and so do the pond tracers on the categories whose pond covers more
    than NOISE of the cell; a pond tracer of a noise pond (fault 4) is
    held to be finite only."""
    mesh = tbox.box_test_mesh(8, 8)
    tree = standard_tracer_tree(n_ice_layers=N_ICE, n_snow_layers=1,
                                pond_scheme="lvl")
    state = _subnormal_pond_state(mesh)
    f32 = torch.float32
    prod = state["iceAreaCategory"] * state["pondArea"]
    assert (prod[prod > 0] < np.finfo(np.float32).tiny).mean() > 0.2
    nv = mesh.n_vertices
    rng = np.random.default_rng(3)
    u, v = (0.12 * rng.standard_normal(nv) for _ in range(2))
    rt = build_remap_geometry(mesh).tensors(f32, "cpu")
    mt = mesh.tensors(f32, "cpu")
    ac = torch.as_tensor(mesh.area_cell).to(f32)
    st = {k: torch.as_tensor(a) for k, a in state.items()}
    out = make_remap_step(tree, mesh.vertex_degree)(
        rt, mt.cells_on_cell, mt.cells_on_cell_mask, ac, st,
        torch.as_tensor(u).to(f32), torch.as_tensor(v).to(f32), DT)
    ref, _ = reference_remap(state, u, v, jnp.float32)
    real_pond = (ref["iceAreaCategory"] * ref["levelIceArea"] *
                 ref["pondArea"]) > NOISE
    for k, a in ref.items():
        got = out[k].numpy()
        assert got.dtype == np.float32, k
        assert np.isfinite(a).all(), k
        assert np.isfinite(got).all(), (k, int((~np.isfinite(got)).sum()))
        if k in ("pondDepth", "pondLidThickness"):
            a, got = a[real_pond], got[real_pond]
        err = float(np.abs(got - a).max()) / float(np.abs(a).max())
        assert err <= F32_LIMIT, (k, err)


@pytest.mark.parametrize("guard", ["recovery", "thickness"])
def test_subnormal_division_guards_match_reference(guard, jax_box):
    """The remap's two other division guards read a subnormal float32
    divisor as zero, as the JAX package (which flushes it) does: the
    recovery of a child tracer whose new parent mass product is subnormal
    (`update_mass_and_tracers`, no flux: the tracer takes the sliver
    clamp's floor in both packages) and the thickness of a category whose
    ice area is subnormal (`to_transport_fields`: 0 in both)."""
    from seaice_tpu_torch.transport.remap import (mass_tracer_products,
                                                  to_transport_fields,
                                                  update_mass_and_tracers)
    mesh = tbox.box_test_mesh(8, 8)
    jmesh, jt, jg = jax_box
    tree = standard_tracer_tree(n_ice_layers=N_ICE, n_snow_layers=1,
                                pond_scheme="lvl")
    state = _subnormal_pond_state(mesh)
    tiny = np.finfo(np.float32).tiny
    if guard == "thickness":
        a = state["iceAreaCategory"]
        state["iceAreaCategory"] = np.where(a < 1e-6, 1e-40, a).astype(
            np.float32)
        state["iceVolumeCategory"] = np.where(
            a < 1e-6, 2e-40, state["iceVolumeCategory"]).astype(np.float32)
        got = to_transport_fields(
            tree, {k: torch.as_tensor(x) for k, x in state.items()})
        ref = JR.to_transport_fields(
            jt, {k: jnp.asarray(x) for k, x in state.items()})
        sub = state["iceAreaCategory"] < tiny
        names = ("iceVolumeCategory", "levelIceVolume")
    else:
        f32 = torch.float32
        fields = to_transport_fields(
            tree, {k: torch.as_tensor(x) for k, x in state.items()})
        zero = {k: torch.zeros((mesh.n_edges,) + tuple(f.shape[1:]),
                               dtype=f32) for k, f in fields.items()}
        got = update_mass_and_tracers(
            tree, fields, zero, build_remap_geometry(mesh).tensors(f32, "cpu"),
            torch.as_tensor(mesh.area_cell).to(f32))
        jf = {k: jnp.asarray(f.numpy()) for k, f in fields.items()}
        ref = jax.jit(lambda *a: JR.update_mass_and_tracers(jt, *a))(
            jf, {k: jnp.asarray(z.numpy()) for k, z in zero.items()},
            jg.tensors(jnp.float32),
            jnp.asarray(jmesh.area_cell, jnp.float32))
        pp = mass_tracer_products(tree, fields)["pondArea"].numpy()
        sub = (pp > 0.0) & (pp < tiny)
        names = ("pondDepth", "pondLidThickness")
    assert sub.sum() > 5
    for k in names:
        assert np.array_equal(got[k].numpy()[sub], np.asarray(ref[k])[sub]), k
