"""Hygiene of the port: it stands alone (no jax, nothing of the JAX
package), it does not run on the CPU unless asked to, and on the CPU a
kernel wrapper takes its plain version without counting a launch."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "seaice_tpu_torch", "seaice_tpu_torch.constants",
    "seaice_tpu_torch.config", "seaice_tpu_torch.convert",
    "seaice_tpu_torch.model", "seaice_tpu_torch.mesh",
    "seaice_tpu_torch.ops.basis", "seaice_tpu_torch.ops.quadrature",
    "seaice_tpu_torch.dynamics.evp",
    "seaice_tpu_torch.dynamics.cuda_unstructured",
    "seaice_tpu_torch.dynamics.cuda_panel_fused",
    "seaice_tpu_torch.dynamics.cuda_panel",
    "seaice_tpu_torch.dynamics.cuda_raster",
    "seaice_tpu_torch.dynamics.momentum",
    "seaice_tpu_torch.dynamics.variational_panel",
    "seaice_tpu_torch.mesh.panels", "seaice_tpu_torch.mesh.structured",
    "seaice_tpu_torch.utils.device",
    "seaice_tpu_torch.transport.remap",
    "seaice_tpu_torch.transport.cuda_flux",
    "seaice_tpu_torch.column", "seaice_tpu_torch.column.atmo",
    "seaice_tpu_torch.column.bl99", "seaice_tpu_torch.column.dedd",
    "seaice_tpu_torch.column.driver", "seaice_tpu_torch.column.itd",
    "seaice_tpu_torch.column.itd_thermo", "seaice_tpu_torch.column.mushy",
    "seaice_tpu_torch.column.mushy_solver",
    "seaice_tpu_torch.column.orbital", "seaice_tpu_torch.column.ponds",
    "seaice_tpu_torch.column.ridging", "seaice_tpu_torch.column.shortwave",
    "seaice_tpu_torch.column.thermo_shared",
    "seaice_tpu_torch.column.tuning", "seaice_tpu_torch.column.vertical",
    "seaice_tpu_torch.testcases",
    "seaice_tpu_torch.kernels.build", "seaice_tpu_torch.native",
    "seaice_tpu_torch.parallel", "seaice_tpu_torch.parallel.partition",
    "seaice_tpu_torch.parallel.sharded", "seaice_tpu_torch.utils.lockstep",
    "seaice_tpu_torch.forcing", "seaice_tpu_torch.forcing.clock",
    "seaice_tpu_torch.forcing.core", "seaice_tpu_torch.io",
    "seaice_tpu_torch.io.mesh_reader", "seaice_tpu_torch.io.forcing_reader",
    "seaice_tpu_torch.io.state_reader", "seaice_tpu_torch.io.checkpoint",
    "seaice_tpu_torch.io.output", "seaice_tpu_torch.io.parallel",
    "seaice_tpu_torch.testcases.ic", "seaice_tpu_torch.namelist",
    "seaice_tpu_torch.diagnostics", "seaice_tpu_torch.error",
    "seaice_tpu_torch.run",
]


def test_import_leaves_jax_out():
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'seaice_tpu' "
        "or m.startswith('seaice_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stdout


def test_sources_do_not_name_the_jax_package_in_imports():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|seaice_tpu)(\s|\.|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "seaice_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    names = {os.path.relpath(f, ROOT) for f in files}
    for new in ("mesh/panels.py", "mesh/structured.py",
                "dynamics/variational_panel.py", "dynamics/cuda_panel.py",
                "dynamics/cuda_panel_fused.py", "dynamics/cuda_raster.py",
                "parallel/partition.py", "parallel/sharded.py",
                "forcing/clock.py", "forcing/core.py", "io/mesh_reader.py",
                "io/forcing_reader.py", "io/state_reader.py",
                "io/checkpoint.py", "io/output.py", "io/parallel.py",
                "testcases/ic.py", "namelist.py", "diagnostics.py",
                "error.py", "run.py"):
        assert os.path.join("seaice_tpu_torch", new) in names
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.match(line), f"{path}:{i}: {line}"


def _small_model_args():
    from seaice_tpu_torch import config as C
    from seaice_tpu_torch.mesh import icosahedral_mesh
    cfg = C.Config(run=C.RunConfig(n_categories=1),
                   velocity=C.VelocitySolverConfig(
                       elastic_subcycle_number=2),
                   column=C.ColumnConfig(use_column_package=False))
    return icosahedral_mesh(1), cfg


def _public_constructors():
    """Every public constructor of the port that takes a device, as
    {name: call(device)}; `...` stands for "the argument left out"."""
    from seaice_tpu_torch.dynamics import evp, variational_fast as vf
    from seaice_tpu_torch.io import load_checkpoint, load_sharded_checkpoint
    from seaice_tpu_torch.dynamics import variational_panel as vpn
    from seaice_tpu_torch.mesh.panels import panel_reorder
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.ops.basis import compute_variational_basis
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    from seaice_tpu_torch.testcases import box
    from seaice_tpu_torch.transport.geometry import build_remap_geometry
    from seaice_tpu_torch.transport.tracers import (init_tracer_state,
                                                    mass_only_tree)
    mesh, cfg = _small_model_args()
    pmesh, lay = panel_reorder(icosahedral_mesh(1), 1)
    vb = compute_variational_basis(mesh)
    pvb = compute_variational_basis(pmesh)
    geom = build_remap_geometry(mesh)
    bmesh = box.box_test_mesh(4, 4)
    f64 = torch.float64
    ckpt = _checkpoints(mesh, cfg)

    def with_device(fn, *args):
        return lambda device: fn(*args) if device is ... else \
            fn(*args, device=device)

    return {
        "SeaIceModel": with_device(
            lambda **kw: SeaIceModel(mesh, cfg, **kw).tensors.area_cell),
        "ShardedSeaIceModel": with_device(
            lambda **kw: ShardedSeaIceModel(
                mesh, cfg, 2, f64, **({"devices": kw["device"]} if kw else {})
            ).tensors[1].area_cell),
        "Mesh.tensors": with_device(
            lambda **kw: mesh.tensors(f64, **kw).area_cell),
        "build_dynamics_tensors": with_device(
            lambda **kw: evp.build_dynamics_tensors(
                mesh, cfg, f64, **kw).area_cell),
        "init_velocity_state": with_device(
            lambda **kw: evp.init_velocity_state(mesh, f64, **kw).u_velocity),
        "zero_forcing": with_device(
            lambda **kw: evp.zero_forcing(mesh, f64, **kw).air_density),
        "build_fast_tensors": with_device(
            lambda **kw: vf.build_fast_tensors(mesh, vb, f64,
                                               **kw).denominator),
        "build_panel_tensors": with_device(
            lambda **kw: vpn.build_panel_tensors(pmesh, lay, pvb, f64,
                                                 **kw).denominator),
        "RemapGeometry.tensors": with_device(
            lambda **kw: geom.tensors(f64, **kw).remap_edge),
        "init_tracer_state": with_device(
            lambda **kw: init_tracer_state(mass_only_tree(), 4, 1, f64,
                                           **kw)["iceAreaCategory"]),
        "box_forcing": with_device(
            lambda **kw: box.box_forcing(bmesh, 0.0, f64,
                                         **kw).air_density),
        "load_checkpoint": with_device(
            lambda **kw: load_checkpoint(ckpt["single"],
                                         **kw)[0].velocity.u_velocity),
        "load_sharded_checkpoint": with_device(
            lambda **kw: load_sharded_checkpoint(
                ckpt["dir"], "sharded", ckpt["part"], ckpt["template"],
                **kw)[0][1].time),
    }


_CKPT = {}


def _checkpoints(mesh, cfg):
    """A checkpoint and a 2-block sharded checkpoint of a small model,
    written once (to a temporary directory) for the loaders above."""
    import tempfile
    from seaice_tpu_torch.io import save_checkpoint, save_sharded_checkpoint
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    if not _CKPT:
        d = tempfile.mkdtemp(prefix="seaice_ckpt_")
        model = SeaIceModel(mesh, cfg, torch.float64, device="cpu")
        save_checkpoint(os.path.join(d, "single.npz"), model.init_state())
        sm = ShardedSeaIceModel(mesh, cfg, 2, torch.float64, devices="cpu")
        template = sm.init_state()
        save_sharded_checkpoint(d, "sharded", template, sm.part,
                                mesh.n_cells, mesh.n_vertices)
        _CKPT.update(dir=d, single=os.path.join(d, "single.npz"),
                     part=sm.part, template=template)
    return _CKPT


CONSTRUCTORS = ["SeaIceModel", "ShardedSeaIceModel", "Mesh.tensors",
            "build_dynamics_tensors", "init_velocity_state", "zero_forcing", "build_fast_tensors",
            "build_panel_tensors", "RemapGeometry.tensors",
            "init_tracer_state", "box_forcing", "load_checkpoint",
            "load_sharded_checkpoint"]


def test_default_device_is_the_gpu_or_an_error():
    """device=None never means the CPU: every public constructor of the port,
    called without a device or with device=None, gives tensors on the
    card, or raises where there is none."""
    from seaice_tpu_torch.model import SeaIceModel
    makers = _public_constructors()
    assert sorted(makers) == sorted(CONSTRUCTORS)
    for name, call in makers.items():
        for device in (..., None):
            if torch.cuda.is_available():
                assert call(device).device.type == "cuda", name
            else:
                with pytest.raises(RuntimeError, match="CUDA"):
                    call(device)
        assert call("cpu").device.type == "cpu", name
    mesh, cfg = _small_model_args()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SeaIceModel(mesh, cfg, device=None, dtype=torch.float64)
    assert SeaIceModel(mesh, cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_asked_for_the_cpu_gives_the_cpu(name):
    """Each one alone, so that a fault names it: asked for "cpu" it
    builds there, and it has no positional default that hides a device."""
    call = _public_constructors()[name]
    assert call("cpu").device.type == "cpu"
    assert call(torch.device("cpu")).device.type == "cpu"


def test_column_package_is_the_next_slice():
    """The column package builds (the default config is the column
    package with BL99 thermodynamics), in the sharded model too (each
    block carries it); an option of it that the port leaves out raises,
    naming its roadmap item, in both."""
    import dataclasses
    from seaice_tpu_torch import config as C
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    mesh, _ = _small_model_args()
    assert SeaIceModel(mesh, C.Config(), device="cpu").column is not None
    cfg = C.Config(column=C.ColumnConfig(use_snow_tracers=True))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        SeaIceModel(mesh, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        ShardedSeaIceModel(mesh, cfg, 2, devices="cpu")
    cfg = dataclasses.replace(cfg, column=C.ColumnConfig())
    sm = ShardedSeaIceModel(mesh, cfg, 2, devices="cpu")
    assert all(m.column is not None for m in sm.models)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    from seaice_tpu_torch.dynamics import cuda_unstructured as K1
    from seaice_tpu_torch.dynamics.evp import build_dynamics_tensors
    mesh, cfg = _small_model_args()
    dyn = build_dynamics_tensors(mesh, cfg, torch.float64, "cpu")
    rng = np.random.default_rng(0)
    nv, nc, me = mesh.n_vertices, mesh.n_cells, mesh.max_edges

    def vert():
        return torch.as_tensor(rng.uniform(0.1, 1.0, nv))

    args = (dyn.fast, vert(), vert(),
            *(torch.as_tensor(rng.standard_normal((me, nc)))
              for _ in range(3)),
            torch.as_tensor(rng.uniform(1e3, 1e4, nc)), torch.ones(
                nc, dtype=torch.float64), *(vert() for _ in range(8)),
            torch.ones(nv, dtype=torch.float64), vert())
    kw = dict(dt_elastic=7.5, damping_timescale=324.0, n_subcycles=3,
              include_metric=True)
    before = (K1.evp_subcycle_loop.launches,
              K1.evp_subcycle_loop.inner_launches)
    got = K1.evp_subcycle_loop(*args, **kw)
    want = K1.evp_subcycle_loop_plain(*args, **kw)
    assert (K1.evp_subcycle_loop.launches,
            K1.evp_subcycle_loop.inner_launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and the one-subcycle wrapper (K6): three calls are the loop's three
    kw1 = dict(kw)
    del kw1["n_subcycles"]
    before = (K1.evp_subcycle_step.launches,
              K1.evp_subcycle_step.inner_launches)
    loop = K1.evp_subcycle_prepare(*args, **kw1)
    for _ in range(3):
        K1.evp_subcycle_step(loop)
    assert (K1.evp_subcycle_step.launches,
            K1.evp_subcycle_step.inner_launches) == before
    for g, w in zip(K1.evp_subcycle_finish(loop), want):
        assert torch.equal(g, w)


def test_kernel_sources_and_work_counts():
    """Every kernel the wrappers name has its CUDA source in csrc/, and
    the roofline work counts are positive and scale with the loop."""
    from seaice_tpu_torch.kernels import build, wrappers
    from seaice_tpu_torch.dynamics.cuda_unstructured import evp_loop_work
    names = {os.path.splitext(os.path.basename(p))[0]
             for p in build.cuda_sources()}
    assert names == {"evp_unstructured", "ir_flux", "evp_panel_fused",
                     "evp_panel_cell", "evp_raster"}
    assert set(wrappers()) == {"evp_subcycle_loop", "integrate_fluxes_cuda",
                               "evp_panel_loop", "panel_cell_step",
                               "evp_raster_loop", "evp_subcycle_step"}
    # each source says which TPU kernel it replaces and has both types
    for name, sym in (("evp_panel_fused", "evp_panel_loop"),
                      ("evp_panel_cell", "panel_cell"),
                      ("evp_raster", "evp_raster_loop"),
                      ("evp_unstructured", "evp_subcycle_loop"),
                      ("evp_unstructured", "evp_subcycle_step")):
        with open(os.path.join(build.CSRC, name + ".cu")) as f:
            text = f.read()
        assert "Replaces the TPU kernel" in text, name
        assert f'extern "C" int {sym}_f32(' in text, name
        assert f'extern "C" int {sym}_f64(' in text, name
    # the shared header of the two panel sources is part of their hash
    assert os.path.exists(os.path.join(build.CSRC, "evp_panel_common.cuh"))
    b1, f1 = evp_loop_work(40962, 81920, 6, 3, 1, True, 4)
    b120, f120 = evp_loop_work(40962, 81920, 6, 3, 120, True, 4)
    assert b1 == b120 > 0 and f120 == 120 * f1 > 0
    # the five basis tensors dominate the bytes: 5*36*nc*4 B = 29.5 MB
    assert 5 * 36 * 40962 * 4 < b1 < 2 * 5 * 36 * 40962 * 4


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """Needs an NVIDIA GPU and nvcc: the smoke run builds every kernel and
    holds each against its plain version at the main-path shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python3 chip_smoke.py` "
                    "on a machine with one")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                        "--steps", "1", "--reps", "2"], cwd=ROOT,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    assert r.returncode == 0, r.stdout[-4000:]
