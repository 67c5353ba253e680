"""The CUDA sources of the EVP and flux kernels, run on the CPU.

A CUDA kernel has no interpret mode, so its arithmetic is only ever held
against the plain version on the card (`chip_smoke.py`).  What CAN be run
here is the source itself: compiled as C++ against a host stand-in for the
CUDA runtime (`tests/cuda_host_shim/`: a block's threads are host threads;
a cooperative launch runs every block's threads at once, with a grid-wide
barrier; the card it reports is small, so that a small mesh exercises both
sides of a shared-memory budget), loaded through the wrappers' own ctypes
binding, and compared with the plain versions, float64 to 1e-12 and
float32 to 1e-5 of each field's max.  This checks indexing, offsets, ghost
lists, exception cells, argument order, grid and shared-memory sizing and
the kernels' own layout work; it says nothing of what nvcc accepts or of
the card.  Needs g++ with C++20; skips without.
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
from seaice_tpu_torch.diagnostics import RECORDER
from seaice_tpu_torch.dynamics import (cuda_panel, cuda_panel_fused,
                                       cuda_raster, cuda_unstructured)
from seaice_tpu_torch.dynamics import evp as tevp
from seaice_tpu_torch.dynamics import variational_panel as vpn
from seaice_tpu_torch.kernels import build
from seaice_tpu_torch.mesh.panels import panel_reorder
from seaice_tpu_torch.mesh.structured import (detect_raster_quad,
                                              raster_reorder)
from seaice_tpu_torch.transport import cuda_flux
from seaice_tpu_torch.transport.remap import (
    integrate_fluxes as remap_integrate_fluxes)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SHIM = os.path.join(HERE, "cuda_host_shim")
SOURCES = ("evp_unstructured", "evp_panel_fused", "evp_panel_cell",
           "evp_raster", "ir_flux")
LAUNCH = re.compile(
    r"([A-Za-z_]\w*(?:<[^<>;()]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
DYN_SMEM = re.compile(
    r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];")
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _to_host_source(text):
    """Launch sites -> `shim_launch`, dynamic shared memory -> the block's
    own buffer; returns (text, number of kernel launch sites)."""
    def conv(m):
        cfg = [x.strip() for x in m.group(2).split(",")]
        smem = cfg[2] if len(cfg) > 2 else "0"
        return (f"shim_launch({m.group(1)}, {cfg[0]}, {cfg[1]}, {smem}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")
    text, n = LAUNCH.subn(conv, text)
    text = DYN_SMEM.sub(r"\1* const \2 = reinterpret_cast<\1*>(shim_dyn_smem);",
                        text)
    return text, n + text.count("cudaLaunchKernelEx(&")


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
               cuda_raster.evp_raster_loop, cuda_flux.integrate_fluxes_cuda):
        counts[fn] = {k: getattr(fn, k) for k in (
            "launches", "inner_launches", "last_launch") if hasattr(fn, k)}
    yield
    # launches made here are no launches on a card: restore the counts
    for fn, saved in counts.items():
        for k, val in saved.items():
            setattr(fn, k, val)


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


def _panel_problem(metric, dtype, subdiv=2):
    key = (metric, dtype, subdiv)
    if key not in _PANEL:
        mesh, lay = panel_reorder(tmesh.icosahedral_mesh(subdiv), subdiv)
        dyn = tevp.build_dynamics_tensors(mesh, _cfg(metric), dtype, "cpu")
        _PANEL[key] = (mesh, lay, dyn)
    return _PANEL[key]


def _panel_loop_on_host(mesh, dyn, metric, dtype, seed):
    """K3's source against its plain version: one launch per call, the
    inputs left as they were; returns (args, kw, result, launch shape)."""
    args = _loop_args(_loop_inputs(mesh, np.random.default_rng(seed), dtype))
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=5,
              include_metric=metric)
    want = cuda_panel_fused.evp_panel_loop_plain(dyn.panel, *args, **kw)
    before = [a.clone() for a in args]
    k3 = cuda_panel_fused.evp_panel_loop
    n0 = (k3.launches, k3.inner_launches)
    c0 = dict(RECORDER.counters)
    got = cuda_panel_fused._launch(dyn.panel, *args, **kw)
    _assert_close(got, want, dtype, "K3")
    assert (k3.launches, k3.inner_launches) == (n0[0] + 1, n0[1] + 1)
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    # the launch's placement, counted once in the recorder
    shape = k3.last_launch
    added = {k: RECORDER.counters.get(k, 0) - c0.get(k, 0) for k in (
        "velocity.k3_streamed_basis_bytes",
        "velocity.k3_streamed_basis_columns",
        "velocity.k3_on_chip_stress_columns")}
    assert added == {
        "velocity.k3_streamed_basis_bytes":
            shape["streamed_basis_bytes_per_subcycle"] * kw["n_subcycles"],
        "velocity.k3_streamed_basis_columns": shape["streamed_basis_columns"],
        "velocity.k3_on_chip_stress_columns": shape["on_chip_stress_columns"]}
    ncol = mesh.n_cells - 2
    assert shape["streamed_basis_columns"] == round(
        shape["basis_share_streamed"] * ncol)
    assert "velocity.k3_on_chip_stress_columns" in RECORDER.report()
    return args, kw, got, shape


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("metric", [False, True])
def test_panel_loop_source_matches_plain(on_host, metric, dtype):
    mesh, _, dyn = _panel_problem(metric, dtype)
    args, kw, got, shape = _panel_loop_on_host(mesh, dyn, metric, dtype, 7)
    # three blocks at once, a column and two vertices a thread in
    # registers; with metric terms the stand-in's 32 KB hold part of each
    # block's basis, the rest is read from global memory
    assert shape["grid"] == 3 and shape["placement"] == "registers"
    if metric:
        assert 0.0 < shape["basis_share_in_smem"] < 1.0
    # and the any-connectivity loop (its plain version) gives the same
    got1 = cuda_unstructured.evp_subcycle_loop_plain(dyn.fast, *args, **kw)
    valid = torch.as_tensor(
        np.arange(6)[:, None] < mesh.n_edges_on_cell[None, :])
    _assert_close([g * valid if g.dim() == 2 else g for g in got],
                  [g * valid if g.dim() == 2 else g for g in got1],
                  dtype, "K3 against K1's plain version")


@pytest.mark.parametrize("dtype,optin,n_ss,n_res", [
    (torch.float64, None, 227, 0), (torch.float32, None, 455, 0),
    (torch.float32, 98304, 640, 27)], ids=["f64", "f32", "f32-resident"])
def test_panel_loop_source_one_block_many_columns(on_host, monkeypatch,
                                                  dtype, optin, n_ss, n_res):
    """On a card of one multiprocessor the one block owns 640 columns and
    1,280 vertices, more than one column and two vertices a thread: the
    table placement, 640 threads a block in float32 and 320 in float64.  Every column's fixed data and
    every vertex's come from the tables the prologue writes, the columns'
    stresses stay in the stand-in's 32 KB of shared memory as far as they
    go (227 columns in float64, 455 in float32) and in s_out past that,
    and the basis is read from global memory: the register, stress and
    resident-basis shares are all exceeded at once.  The exception threads
    own columns too.  With 96 KB (f32-resident) every column's stresses
    fit, and the basis of the first 27 columns stays in shared memory: as
    far as the placement leaves the L1 32 KB more than its least (64 KB of
    shared memory used)."""
    monkeypatch.setenv("SHIM_SMS", "1")
    if optin is not None:
        monkeypatch.setenv("SHIM_SMEM_OPTIN", str(optin))
    mesh, _, dyn = _panel_problem(True, dtype, subdiv=3)
    args, kw, got, shape = _panel_loop_on_host(mesh, dyn, True, dtype, 12)
    assert shape["placement"] == "tables"
    assert shape["threads"] == (640 if dtype == torch.float32 else 320)
    assert shape["grid"] == 1 and shape["columns_per_block"] == 640
    assert shape["smem_stress_columns_per_block"] == n_ss
    assert shape["smem_columns_per_block"] == n_res
    assert shape["stress_share_on_chip"] == n_ss / 640
    assert shape["basis_share_in_smem"] == n_res / 640
    assert shape["streamed_basis_bytes_per_subcycle"] == (
        (640 - n_res) * 180 * got[0].element_size())
    # the phase timer's barriers leave the result as it was
    timer = torch.zeros((1, 4), dtype=torch.int64)
    call, timed = cuda_panel_fused._bind(dyn.panel, *args, **kw,
                                         phase_timer=timer)
    assert call()[0] == 0
    assert all(torch.equal(a, b) for a, b in zip(timed, got))
    assert bool((timer >= 0).all())


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
    """K5's loop form: prepare, then two steps (the stresses from buffer 0
    into 1, then back), each one launch, against the plain step on the
    same planes; the pole columns' partials come out zero."""
    mesh, lay, dyn = _panel_problem(metric, dtype)
    pt = dyn.panel
    a = _loop_inputs(mesh, np.random.default_rng(8), dtype)
    t = [vpn.stress_ring_to_slot(pt, s) for s in a["s"]]
    ss = vpn.cells_to_padded(pt, a["ss"])
    ss[pt.exc_pad_cols] = 0
    args = (pt, vpn.cells_to_padded(pt, a["pressure"]), ss, *t)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0,
              include_metric=metric)
    loops = [cuda_panel.panel_cell_prepare(*args, **kw) for _ in range(2)]
    cuda_panel._bind(loops[1])
    k5 = cuda_panel.panel_cell_step
    for i, (u, v) in enumerate(((a["u"], a["v"]), (a["v"], -a["u"]))):
        for lp in loops:
            vpn.velocity_planes(pt, lay.N, u, v, metric, out=lp.planes)
        cuda_panel.panel_cell_step_plain(loops[0])
        n0 = k5.launches
        cuda_panel._launch(loops[1])
        assert k5.launches == n0 + 1 and loops[1].parity == (i + 1) % 2
        # each field alone: the partials pu, pv (mu, mv) each to its max
        _assert_close(loops[1].current + loops[1].partials.unbind(-1),
                      loops[0].current + loops[0].partials.unbind(-1), dtype,
                      "K5")
        npp = 10 * (lay.N + 1) ** 2
        assert not bool(loops[1].partials[:, npp:].any())


def _k1_on_host(ft, args, kw):
    """K1's C call through the wrapper's own binding (`evp_subcycle_prepare`,
    `loop_call`): one cooperative launch per call; returns the loop's
    (u, v, s11T, s22T, s12T) and the launch shape."""
    kw = dict(kw)
    n_sub = kw.pop("n_subcycles")
    loop = cuda_unstructured.evp_subcycle_prepare(ft, *args, **kw)
    cuda_unstructured._bind_kernel(loop)
    assert cuda_unstructured.loop_call(loop, n_sub)() == 0
    assert loop.c_info[0] == 1
    return (cuda_unstructured.evp_subcycle_finish(loop),
            cuda_unstructured.launch_shape(loop.c_info, loop.shape[0]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("metric", [False, True])
def test_unstructured_loop_source_matches_plain(on_host, metric, dtype):
    """K1's source through the same stand-in: one launch a call, two
    blocks, the basis partly in the stand-in's 32 KB of shared memory and
    partly in global memory (with metric terms, and in float64)."""
    mesh, _, dyn = _panel_problem(metric, dtype)
    args = _loop_args(_loop_inputs(mesh, np.random.default_rng(9), dtype))
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=5,
              include_metric=metric)
    want = cuda_unstructured.evp_subcycle_loop_plain(dyn.fast, *args, **kw)
    before = [a.clone() for a in args]
    got, shape = _k1_on_host(dyn.fast, args, kw)
    _assert_close(got, want, dtype, "K1")
    assert shape["grid"] == 2 and shape["threads"] == 768
    if metric or dtype == torch.float64:
        assert 0.0 < shape["basis_share_in_smem"] < 1.0
    for a, b in zip(args, before):
        assert torch.equal(a, b)


def _other_mesh(name, dtype):
    """A mesh whose maxEdges is not 6: the planar quad mesh (4) or a jittered
    spherical Voronoi mesh with one 7-sided cell (7)."""
    if name == "quad4":
        mesh = tmesh.planar_quad_mesh(12, 10, 2000.0, periodic=False)
        cfg = tconfig.box_test_config()
    else:
        mesh = tmesh.spherical_voronoi_mesh(2, jitter=0.3, seed=0)
        cfg = _cfg(True)
    return mesh, cfg, tevp.build_dynamics_tensors(mesh, cfg, dtype, "cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["one_block_many_cells", "quad4", "voronoi7"])
def test_unstructured_loop_source_other_shapes(on_host, monkeypatch, case,
                                               dtype):
    """K1 where the shape differs from the sphere's: on a card of one
    multiprocessor at subdiv 3 the one block owns 642 cells with 768
    threads (six passes of 120 cells: three keep their stresses in
    registers, three in the stress arrays between subcycles, most read
    their basis from global memory); and meshes of maxEdges 4 and 7."""
    if case == "one_block_many_cells":
        monkeypatch.setenv("SHIM_SMS", "1")
        mesh, _, dyn = _panel_problem(True, dtype, subdiv=3)
        metric = True
    else:
        mesh, cfg, dyn = _other_mesh(case, dtype)
        metric = cfg.velocity.include_metric_terms
        assert mesh.max_edges == {"quad4": 4, "voronoi7": 7}[case]
    args = _loop_args(_loop_inputs(mesh, np.random.default_rng(13), dtype))
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=3,
              include_metric=metric)
    want = cuda_unstructured.evp_subcycle_loop_plain(dyn.fast, *args, **kw)
    got, shape = _k1_on_host(dyn.fast, args, kw)
    _assert_close(got, want, dtype, "K1 " + case)
    if case == "one_block_many_cells":
        # 129 runs of 5 cells (a warp's), the last with 2
        assert shape["grid"] == 1 and shape["cells_per_block"] == 645
        assert 0.0 < shape["basis_share_in_smem"] < 1.0


def test_unstructured_loop_equals_k6_steps_bitwise(on_host):
    """K1's loop against n calls of K6's entry (`evp_subcycle_step_f64`) on
    the same mesh as one block, float64: bitwise equal (the host contracts
    no multiply-add, so this pins that both keep one order of every sum)."""
    dtype = torch.float64
    mesh, _, dyn = _panel_problem(True, dtype)
    args = _loop_args(_loop_inputs(mesh, np.random.default_rng(14), dtype))
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, include_metric=True)
    got, _ = _k1_on_host(dyn.fast, args, dict(kw, n_subcycles=4))
    loop = cuda_unstructured.evp_subcycle_prepare(dyn.fast, *args, **kw)
    cuda_unstructured._bind_kernel(loop)
    blocks = cuda_unstructured._bind_blocks((loop,))
    for _ in range(4):
        assert blocks.call() == 0
    want = cuda_unstructured.evp_subcycle_finish(loop)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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
    blocks = cuda_unstructured._bind_blocks((loop,))

    def c_step(lp):
        assert blocks.call() == 0 and blocks.count.value == 2

    _assert_close(two_steps(c_step, loop), want, dtype, "K6")


_SHARDED = {}


def _sharded_blocks(dtype, n_shards):
    """The dynamics tensors of the subdiv-2 sphere in n_shards blocks."""
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    key = (dtype, n_shards)
    if key not in _SHARDED:
        _SHARDED[key] = ShardedSeaIceModel(
            tmesh.icosahedral_mesh(2), _cfg(True), n_shards, dtype,
            devices="cpu")
    return _SHARDED[key]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_unstructured_blocks_source_matches_plain(on_host, n_shards, dtype):
    """K6's batched entry: one C call, two launches, advances every block
    of a partitioned sphere (the block as blockIdx.y), three subcycles with
    the model's own vertex exchange between calls, against the plain
    version run block by block with the same exchanges, and bitwise equal
    to the same entry called for each block alone; and a table of blocks
    of unequal size (a block beside the whole mesh), each block bitwise as
    it is alone."""
    sm = _sharded_blocks(dtype, n_shards)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, include_metric=True)

    def loops(seed, tensors):
        out = []
        for s, ft in enumerate(tensors):
            me, nc = ft.voc_T.shape
            a = _loop_inputs(types.SimpleNamespace(
                n_vertices=ft.flat_corner_idx.shape[1], n_cells=nc,
                max_edges=me), np.random.default_rng(seed + s), dtype)
            lp = cuda_unstructured.evp_subcycle_prepare(ft, *_loop_args(a),
                                                        **kw)
            cuda_unstructured._bind_kernel(lp)
            out.append(lp)
        return out

    def c_call(lps):
        blocks = cuda_unstructured._bind_blocks(tuple(lps))
        assert tuple(blocks.table.shape) == (len(lps), 30)
        assert blocks.call() == 0 and blocks.count.value == 2

    def alone(lps):
        for lp in lps:
            c_call([lp])

    def plain(lps):
        for lp in lps:
            cuda_unstructured.evp_subcycle_step_plain(lp)

    def run(step, lps, exchange=True):
        for _ in range(3):
            step(lps)
            if exchange:
                sm.exchange("vertex_uv", [(lp.u, lp.v) for lp in lps])
        return [cuda_unstructured.evp_subcycle_finish(lp) for lp in lps]

    fts = [t.dynamics.fast for t in sm.tensors]
    got = run(c_call, loops(20, fts))
    for g, w, a in zip(got, run(plain, loops(20, fts)),
                       run(alone, loops(20, fts))):
        _assert_close(g, w, dtype, "K6 blocks")
        assert all(torch.equal(x, y) for x, y in zip(g, a))

    # unequal blocks: the grid spans the larger, the smaller stops at its
    # own size
    mesh, _, dyn = _panel_problem(True, dtype)
    pair = [fts[0], dyn.fast]
    assert fts[0].voc_T.shape[1] < dyn.fast.voc_T.shape[1]
    for g, a in zip(run(c_call, loops(40, pair), False),
                    run(alone, loops(40, pair), False)):
        assert all(torch.equal(x, y) for x, y in zip(g, a))


def _raster_problem(nx, ny, dtype, seed=3):
    mesh = raster_reorder(tmesh.planar_quad_mesh(nx, ny, 2000.0,
                                                 periodic=False))
    lay = detect_raster_quad(mesh)
    ft = tevp.build_dynamics_tensors(mesh, tconfig.box_test_config(), dtype,
                                     "cpu").fast
    a = _loop_inputs(mesh, np.random.default_rng(seed), dtype)
    return (lay, *cuda_raster.basis_tables(ft), a["u"], a["v"], *a["s"],
            a["pressure"], a["ss"], a["uo"], a["vo"], a["mass"], a["mass_f"],
            *a["rhs"], 0.3 * a["rhs"][1], 0.2 * a["rhs"][0], *a["ocn"],
            a["sv"], a["area"], ft.denominator)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nx, ny", [(8, 8), (12, 7)])
def test_raster_loop_source_matches_plain(on_host, nx, ny, dtype):
    args = _raster_problem(nx, ny, dtype)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=5)
    k4 = cuda_raster.evp_raster_loop
    n0 = (k4.launches, k4.inner_launches)
    _assert_close(cuda_raster._launch(*args, **kw),
                  cuda_raster.evp_raster_loop_plain(*args, **kw), dtype,
                  "K4")
    assert (k4.launches, k4.inner_launches) == (n0[0] + 1, n0[1] + 1)
    assert k4.last_launch["grid"] >= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["one_tile", "uneven_tiles",
                                  "several_tiles_a_block"])
def test_raster_loop_source_tilings(on_host, monkeypatch, case, dtype):
    """K4's tilings against the plain version, with an even and an odd
    number of subcycles, and a second call bitwise the first: one tile on
    a card of one multiprocessor; tiles that do not divide the box (15 x 9
    vertices in two tiles of 8 x 9 on a card of three); and a card of one
    multiprocessor whose one block takes two tiles in turn (the second
    tile's stresses, and those the first tile's ring reads, through global
    memory)."""
    nx, ny, sms = {"one_tile": (12, 7, "1"), "uneven_tiles": (14, 8, "3"),
                   "several_tiles_a_block": (40, 33, "1")}[case]
    monkeypatch.setenv("SHIM_SMS", sms)
    args = _raster_problem(nx, ny, dtype, seed=4)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0)
    for n_sub in (3, 4):
        outs = []
        for _ in range(2):
            call, got = cuda_raster._bind(*args, **kw, n_subcycles=n_sub)
            err, info = call()
            assert err == 0 and info[0] == 1
            outs.append(got)
        _assert_close(outs[0], cuda_raster.evp_raster_loop_plain(
            *args, **kw, n_subcycles=n_sub), dtype, "K4 " + case)
        assert all(torch.equal(a, b) for a, b in zip(*outs))
    shape = cuda_raster.launch_shape(info)
    want = {"one_tile": dict(grid=1, tile=[13, 8]),
            "uneven_tiles": dict(grid=2, tile=[8, 9]),
            "several_tiles_a_block": dict(grid=1)}[case]
    assert shape["grid"] == want["grid"]
    if "tile" in want:
        assert shape["tile"] == want["tile"]
    if case == "several_tiles_a_block":
        tx, ty = shape["tile"]
        assert -(-(nx + 1) // tx) * -(-(ny + 1) // ty) > 1


def test_raster_loop_host_tables_copied_once(on_host):
    """Two solves with the step's table views (new view objects of the same
    basis each step) reuse one host buffer of the tables; a table changed
    in place is copied anew."""
    args = _raster_problem(8, 8, torch.float64)
    kw = dict(dt_elastic=15.0, damping_timescale=648.0, n_subcycles=2)
    lay, gx, gy, bu, bv, *rest = args
    views = [(gx[:], gy[:], bu[:], bv[:]) for _ in range(2)]
    calls = [cuda_raster._bind(lay, *v, *rest, **kw)[0] for v in views]
    assert calls[0].keep[0] is calls[1].keep[0]
    assert torch.equal(calls[0].keep[0].reshape(4, 4, 4),
                       torch.stack([gx, gy, bu, bv]))
    gx2 = gx.clone()
    first = cuda_raster._bind(lay, gx2, gy, bu, bv, *rest, **kw)[0].keep[0]
    gx2.mul_(2.0)
    second = cuda_raster._bind(lay, gx2, gy, bu, bv, *rest, **kw)[0].keep[0]
    assert second is not first and torch.equal(second[0], 2.0 * first[0])


def _full_roster_tree():
    """The tracer tree of the widest column configuration: 5 categories,
    7 + 1 layers, level-ice ponds, the vertical zBGC on the full roster
    (n_algae 3, every pool) with 3 z-aerosol bins (19 tracers on 8 bio
    grid points) and its mobile fractions: 50 2D and 930 layered
    columns."""
    from seaice_tpu_torch.column.zbgc import ZbgcParams
    from seaice_tpu_torch.model import column_tracer_tree
    zp = ZbgcParams(n_algae=3, use_C=True, use_DON=True, use_Fe=True,
                    use_DMS=True, use_PON=True, use_hum=True,
                    use_zaero=True, n_zaero=3)
    return column_tracer_tree(tconfig.Config(
        run=tconfig.RunConfig(n_categories=5, n_ice_layers=7),
        column=tconfig.ColumnConfig(pond_scheme="lvl",
                                    use_biogeochemistry=True,
                                    zbgc_params=zp)))


def _flux_problem(dtype, tree=None, ncat=3, n_ice=4):
    """The IR flux stage's inputs on the subdiv-2 sphere: by default 3
    categories, 4 ice + 1 snow layers (2D and 3D tracers, chains of up to
    3 factors), or the tracer tree `tree` of ncat categories with every
    tracer seeded; random ice and velocities, and a fifth of the edges
    masked."""
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.transport import remap as R
    from seaice_tpu_torch.transport.tracers import standard_tracer_tree
    from seaice_tpu_torch.utils.containers import to_device
    mesh = tmesh.icosahedral_mesh(2)
    cfg = tconfig.Config(
        run=tconfig.RunConfig(dt=1800.0, n_categories=ncat,
                              n_ice_layers=n_ice),
        velocity=tconfig.VelocitySolverConfig(elastic_subcycle_number=2),
        advection=tconfig.AdvectionConfig(),
        column=tconfig.ColumnConfig(use_column_package=False))
    model = SeaIceModel(mesh, cfg, dtype=torch.float64, device="cpu",
                        tracer_tree=tree or standard_tracer_tree(
                            n_ice_layers=4, n_snow_layers=1))
    rng = np.random.default_rng(5)
    nc, nv = mesh.n_cells, mesh.n_vertices
    area = rng.uniform(0.0, 0.3, (nc, ncat)) * (rng.uniform(size=(nc, 1))
                                                 > 0.3)
    state = model.init_state(area, area * rng.uniform(0.5, 3.0, (nc, ncat)),
                             area * 0.1)
    if tree is not None:
        state = state.replace(tracers={
            k: (v if k in ("iceAreaCategory", "iceVolumeCategory",
                           "snowVolumeCategory")
                else torch.as_tensor(rng.uniform(0.1, 2.0, tuple(v.shape))))
            for k, v in state.tracers.items()})
    tree, rt = model.tree, model.tensors.remap
    coc = model.tensors.mesh.cells_on_cell
    cocm = model.tensors.mesh.cells_on_cell_mask
    fields = R.to_transport_fields(tree, dict(state.tracers))
    mask_cell, masks = R.make_masks(tree, fields)
    recon = R.reconstruct_fields(tree, fields, masks, mask_cell, rt, coc,
                                 cocm, monotonic=True)
    uv, vv = (torch.as_tensor(60.0 * rng.standard_normal(nv))
              for _ in range(2))
    dpx, dpy = R.departure_points(uv, vv, 1800.0)
    tris = R.find_departure_triangles(rt, dpx, dpy, mesh.vertex_degree)
    cell, xq, yq, tarea = R.triangles_to_cell_coords(rt, tris)
    mask_edge = tris["mask_edge"] * torch.as_tensor(
        rng.uniform(size=mesh.n_edges) > 0.2)
    args = (tree, recon, rt, cell, xq, yq, tarea, mask_edge)
    return args if dtype == torch.float64 else to_device(
        args, torch.device("cpu"), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_flux_source_matches_plain(on_host, dtype):
    """K2's source (pointwise chains of linear factors) against
    `remap.integrate_fluxes` (monomial coefficients and integrals)."""
    args = _flux_problem(dtype)
    tree, _, _, cell, _, _, area, mask_edge = args
    active = (area != 0) & (mask_edge[:, None] != 0)
    # the case covers empty slots, masked edges with non-empty slots, and
    # edges with more than one non-empty slot
    assert 0 < int(active.sum()) < active.numel()
    assert bool(((mask_edge == 0) & (area != 0).any(1)).any())
    assert int(active.sum(1).max()) > 1
    want = remap_integrate_fluxes(*args)
    before = cuda_flux.integrate_fluxes_cuda.launches
    got = cuda_flux._launch(*args)
    assert cuda_flux.integrate_fluxes_cuda.launches == before + 1
    assert set(got) == set(want) == set(tree.names)
    assert any(g.dim() == 3 for g in got.values())
    _assert_close([got[k] for k in tree.names], [want[k] for k in tree.names],
                  dtype, "K2")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_flux_source_full_roster_width(on_host, monkeypatch, dtype):
    """K2's source at the widest column tree's table (50 2D + 930 layered
    columns: 20,768 B of shared memory a block in f32, 41,536 B in f64)
    on a card whose default per-block budget (SHIM_SMEM_DEFAULT, 16 KB
    here, 48 KB on an H100) both cross, so the launch runs only after the
    kernel opts in to more; against the plain version.  Where the opt-in
    limit is below the block's need, the wrapper raises naming the
    table's width and never runs the plain version instead."""
    from seaice_tpu_torch.transport.cuda_flux import shared_bytes
    tree = _full_roster_tree()
    args = _flux_problem(dtype, tree, ncat=5, n_ice=7)
    t2 = sum(5 for s in tree.specs if s.n_layers == 0)
    t3 = sum(5 * s.n_layers for s in tree.specs if s.n_layers)
    assert (t2, t3) == (50, 930)
    need = shared_bytes(t2, t3, torch.finfo(dtype).bits // 8)
    assert need == {torch.float32: 20768, torch.float64: 41536}[dtype]
    monkeypatch.setenv("SHIM_SMEM_DEFAULT", "16384")
    monkeypatch.setenv("SHIM_SMEM_OPTIN", "65536")
    want = remap_integrate_fluxes(*args)
    before = cuda_flux.integrate_fluxes_cuda.launches
    got = cuda_flux._launch(*args)
    assert cuda_flux.integrate_fluxes_cuda.launches == before + 1
    _assert_close([got[k] for k in tree.names], [want[k] for k in tree.names],
                  dtype, "K2 full roster")
    monkeypatch.setenv("SHIM_SMEM_OPTIN", str(need - 8))
    with pytest.raises(RuntimeError, match="980 columns"):
        cuda_flux._launch(*args)
    assert cuda_flux.integrate_fluxes_cuda.launches == before + 1
