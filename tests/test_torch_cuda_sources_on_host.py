"""The CUDA sources of the EVP kernels, run on the CPU.

A CUDA kernel has no interpret mode, so its arithmetic is only ever held
against the plain version on the card (`chip_smoke.py`).  What CAN be run
here is the source itself: compiled as C++ against a host stand-in for the
CUDA runtime (`tests/cuda_host_shim/cuda_runtime.h`: a block's threads are
host threads), loaded through the wrappers' own ctypes binding, and
compared with the plain versions, float64 to 1e-12 and float32 to 1e-5 of
each field's max.  This checks indexing, offsets, ghost lists, exception
cells, argument order and the wrappers' layout work; it says nothing of
what nvcc accepts or of the card.  Needs g++ with C++20; skips without.
"""

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import seaice_tpu_torch.mesh as tmesh
from seaice_tpu_torch import config as tconfig
from seaice_tpu_torch.dynamics import (cuda_panel, cuda_panel_fused,
                                       cuda_raster, cuda_unstructured)
from seaice_tpu_torch.dynamics import evp as tevp
from seaice_tpu_torch.dynamics import variational_panel as vpn
from seaice_tpu_torch.kernels import build
from seaice_tpu_torch.mesh.panels import panel_reorder
from seaice_tpu_torch.mesh.structured import (detect_raster_quad,
                                              raster_reorder)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SHIM = os.path.join(HERE, "cuda_host_shim")
SOURCES = ("evp_unstructured", "evp_panel_fused", "evp_panel_cell",
           "evp_raster")
LAUNCH = re.compile(
    r"([A-Za-z_]\w*(?:<[^<>;()]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _to_host_source(text):
    def conv(m):
        grid, block = [x.strip() for x in m.group(2).split(",")][:2]
        return (f"shim_launch({grid}, {block}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")
    return LAUNCH.subn(conv, text)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_on_host")
    for h in os.listdir(build.CSRC):
        if h.endswith(".cuh"):
            shutil.copy(os.path.join(build.CSRC, h), out)
    libs, procs = {}, []
    for name in SOURCES:
        with open(os.path.join(build.CSRC, name + ".cu")) as f:
            text, n = _to_host_source(f.read())
        assert n >= 1, name
        cpp, lib = out / (name + ".cpp"), out / f"lib{name}.so"
        cpp.write_text(text)
        procs.append((name, lib, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-Wno-unknown-pragmas", "-I", SHIM, "-I", str(out), "-o",
             str(lib), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0 and "barrier" in text and "No such file" in text:
            pytest.skip("needs g++ with C++20 <barrier>")
        assert p.returncode == 0, text[-3000:]
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The wrappers' launch bodies bound to the host libraries."""
    monkeypatch.setattr(build, "get_cuda_lib", lambda name: host_libs[name])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    counts = {}
    for fn in (cuda_panel_fused.evp_panel_loop, cuda_panel.panel_cell_step,
               cuda_raster.evp_raster_loop):
        counts[fn] = (fn.launches, getattr(fn, "inner_launches", 0))
    yield
    # launches made here are no launches on a card: restore the counts
    for fn, (n, inner) in counts.items():
        fn.launches = n
        if hasattr(fn, "inner_launches"):
            fn.inner_launches = inner


def _cfg(metric):
    return tconfig.Config(
        run=tconfig.RunConfig(n_categories=1),
        velocity=tconfig.VelocitySolverConfig(
            elastic_subcycle_number=4, rotate_cartesian_grid=True,
            include_metric_terms=metric),
        column=tconfig.ColumnConfig(use_column_package=False))


def _loop_inputs(mesh, rng, dtype):
    nv, nc, me = mesh.n_vertices, mesh.n_cells, mesh.max_edges

    def f(a):
        return torch.as_tensor(a).to(dtype)

    return dict(
        u=f(0.1 * rng.standard_normal(nv)), v=f(0.1 * rng.standard_normal(nv)),
        s=[f(1e3 * rng.standard_normal((me, nc))) for _ in range(3)],
        pressure=f(rng.uniform(1e3, 1e4, nc)),
        ss=f((rng.uniform(size=nc) > 0.1).astype(np.float64)),
        uo=f(0.05 * rng.standard_normal(nv)),
        vo=f(0.05 * rng.standard_normal(nv)),
        mass=f(rng.uniform(500.0, 2000.0, nv)),
        mass_f=f(0.2 * rng.standard_normal(nv)),
        rhs=[f(0.1 * rng.standard_normal(nv)) for _ in range(2)],
        ocn=[f(0.05 * rng.standard_normal(nv)) for _ in range(2)],
        sv=f((rng.uniform(size=nv) > 0.15).astype(np.float64)),
        area=f(rng.uniform(0.1, 1.0, nv)))


def _loop_args(a):
    return (a["u"], a["v"], *a["s"], a["pressure"], a["ss"], a["uo"],
            a["vo"], a["mass"], a["mass_f"], *a["rhs"], *a["ocn"], a["sv"],
            a["area"])


def _assert_close(got, want, dtype, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        scale = float(w.abs().max())
        assert scale > 0, (what, i)
        assert float((g - w).abs().max()) <= TOL[dtype] * scale, (what, i)


_PANEL = {}


def _panel_problem(metric, dtype):
    key = (metric, dtype)
    if key not in _PANEL:
        mesh, lay = panel_reorder(tmesh.icosahedral_mesh(2), 2)
        dyn = tevp.build_dynamics_tensors(mesh, _cfg(metric), dtype, "cpu")
        _PANEL[key] = (mesh, lay, dyn)
    return _PANEL[key]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("metric", [False, True])
def test_panel_loop_source_matches_plain(on_host, metric, dtype):
    mesh, _, dyn = _panel_problem(metric, dtype)
    args = _loop_args(_loop_inputs(mesh, np.random.default_rng(7), dtype))
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=5,
              include_metric=metric)
    want = cuda_panel_fused.evp_panel_loop_plain(dyn.panel, *args, **kw)
    before = [a.clone() for a in args]
    got = cuda_panel_fused._launch(dyn.panel, *args, **kw)
    _assert_close(got, want, dtype, "K3")
    # two launches per subcycle, and the inputs are left as they were
    assert cuda_panel_fused.evp_panel_loop.inner_launches % 10 == 0
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    # and the any-connectivity loop (its plain version) gives the same
    got1 = cuda_unstructured.evp_subcycle_loop_plain(dyn.fast, *args, **kw)
    valid = torch.as_tensor(
        np.arange(6)[:, None] < mesh.n_edges_on_cell[None, :])
    _assert_close([g * valid if g.dim() == 2 else g for g in got],
                  [g * valid if g.dim() == 2 else g for g in got1],
                  dtype, "K3 against K1's plain version")


@pytest.mark.parametrize("name", ["k_pu_row_src", "k_pu_col_src",
                                  "k_plane_row_pos", "k_plane_col_pos",
                                  "k_exc_tgt_pos", "k_exc_vpos"])
def test_panel_loop_source_reads_every_index_list(on_host, name):
    """A wrong entry in any of the kernels' index tables shows in the
    result: the comparison above is sensitive to each of them."""
    mesh, _, dyn = _panel_problem(True, torch.float64)
    args = _loop_args(_loop_inputs(mesh, np.random.default_rng(7),
                                   torch.float64))
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=3,
              include_metric=True)
    want = cuda_panel_fused.evp_panel_loop_plain(dyn.panel, *args, **kw)
    t = getattr(dyn.panel, name)
    t = torch.roll(t.reshape(-1), 1).reshape(t.shape)   # every entry wrong
    got = cuda_panel_fused._launch(dyn.panel.replace(**{name: t}), *args,
                                   **kw)
    worst = max(float((g - w).abs().max()) / float(w.abs().max())
                for g, w in zip(got, want))
    assert worst > 1e-8


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("metric", [False, True])
def test_panel_cell_source_matches_plain(on_host, metric, dtype):
    mesh, lay, dyn = _panel_problem(metric, dtype)
    pt = dyn.panel
    a = _loop_inputs(mesh, np.random.default_rng(8), dtype)
    planes = vpn.velocity_planes(pt, lay.N, a["u"], a["v"], metric)
    t = [vpn.stress_ring_to_slot(pt, s) for s in a["s"]]
    ss = vpn.cells_to_padded(pt, a["ss"])
    ss[pt.exc_pad_cols] = 0
    args = (pt, planes, *t, vpn.cells_to_padded(pt, a["pressure"]), ss)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0,
              include_metric=metric)
    _assert_close(cuda_panel._launch(*args, **kw),
                  cuda_panel.panel_cell_plain(*args, **kw), dtype, "K5")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("metric", [False, True])
def test_unstructured_loop_source_matches_plain(on_host, metric, dtype):
    """K1's source through the same stand-in: the harness is held against
    a kernel that is known to agree on the card."""
    mesh, _, dyn = _panel_problem(metric, dtype)
    args = _loop_args(_loop_inputs(mesh, np.random.default_rng(9), dtype))
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=5,
              include_metric=metric)
    want = cuda_unstructured.evp_subcycle_loop_plain(dyn.fast, *args, **kw)
    fn = cuda_unstructured._c_function(dtype)
    ft = dyn.fast
    u, v, s11, s22, s12, pressure, ss, *vert = (x.clone() for x in args)
    me, nc = ft.voc_T.shape
    vd, nv = ft.flat_corner_idx.shape
    scratch = torch.empty((2, nc * me), dtype=dtype)
    n_inner = ctypes.c_int(0)
    from seaice_tpu_torch import constants as c
    ptr = [x.data_ptr() for x in (
        ft.voc_T_i32, ft.voc_mask_T, ft.basis_grad_T, ft.basis_int_T,
        ft.basis_metric_T, ft.flat_corner_idx_i32, ft.cov_mask_T,
        ft.denominator, ft.tan_lat_vertex, u, v, s11, s22, s12, pressure,
        ss, *vert, scratch[0], scratch[1])]
    err = fn(nc, nv, me, vd, 5, int(metric), *ptr, 15.0, 648.0,
             float(c.EVP_ECCENTRICITY_SQ), float(c.PUNY),
             float(c.COS_OCEAN_TURNING_ANGLE),
             float(c.SIN_OCEAN_TURNING_ANGLE),
             float(c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER), 0,
             ctypes.byref(n_inner))
    assert err == 0 and n_inner.value == 10
    _assert_close((u, v, s11, s22, s12), want, dtype, "K1")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_unstructured_step_source_matches_plain(on_host, dtype):
    """K6's C entry (one subcycle per call) through the same stand-in: two
    calls with a halo refresh written in place between them, against the
    plain version with the same refresh."""
    mesh, _, dyn = _panel_problem(True, dtype)
    args = _loop_inputs(mesh, np.random.default_rng(10), dtype)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, include_metric=True)
    halo = torch.arange(0, mesh.n_vertices, 3)
    fresh = [torch.as_tensor(np.random.default_rng(11).normal(
        0.0, 0.1, len(halo))).to(dtype) for _ in range(2)]

    def two_steps(step, loop):
        step(loop)
        loop.u[halo], loop.v[halo] = fresh      # the exchange, in place
        step(loop)
        return cuda_unstructured.evp_subcycle_finish(loop)

    want = two_steps(cuda_unstructured.evp_subcycle_step_plain,
                     cuda_unstructured.evp_subcycle_prepare(
                         dyn.fast, *_loop_args(args), **kw))
    loop = cuda_unstructured.evp_subcycle_prepare(dyn.fast, *_loop_args(args),
                                                  **kw)
    cuda_unstructured._bind_kernel(loop)
    fn, c_args = loop.c_step

    def c_step(lp):
        assert fn(*c_args) == 0 and lp.c_count.value == 2

    _assert_close(two_steps(c_step, loop), want, dtype, "K6")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nx, ny", [(8, 8), (12, 7)])
def test_raster_loop_source_matches_plain(on_host, nx, ny, dtype):
    mesh = raster_reorder(tmesh.planar_quad_mesh(nx, ny, 2000.0,
                                                 periodic=False))
    lay = detect_raster_quad(mesh)
    ft = tevp.build_dynamics_tensors(mesh, tconfig.box_test_config(), dtype,
                                     "cpu").fast
    a = _loop_inputs(mesh, np.random.default_rng(3), dtype)
    args = (lay, *cuda_raster.basis_tables(ft), a["u"], a["v"], *a["s"],
            a["pressure"], a["ss"], a["uo"], a["vo"], a["mass"], a["mass_f"],
            *a["rhs"], 0.3 * a["rhs"][1], 0.2 * a["rhs"][0], *a["ocn"],
            a["sv"], a["area"], ft.denominator)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=5)
    _assert_close(cuda_raster._launch(*args, **kw),
                  cuda_raster.evp_raster_loop_plain(*args, **kw), dtype,
                  "K4")
    assert cuda_raster.evp_raster_loop.inner_launches % 10 == 0
