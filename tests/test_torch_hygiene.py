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
    "seaice_tpu_torch.parallel.comm",
    "seaice_tpu_torch.forcing", "seaice_tpu_torch.forcing.clock",
    "seaice_tpu_torch.forcing.core", "seaice_tpu_torch.io",
    "seaice_tpu_torch.io.mesh_reader", "seaice_tpu_torch.io.forcing_reader",
    "seaice_tpu_torch.io.state_reader", "seaice_tpu_torch.io.checkpoint",
    "seaice_tpu_torch.io.output", "seaice_tpu_torch.io.parallel",
    "seaice_tpu_torch.testcases.ic", "seaice_tpu_torch.namelist",
    "seaice_tpu_torch.diagnostics", "seaice_tpu_torch.error",
    "seaice_tpu_torch.run", "seaice_tpu_torch.column.zbgc",
    "seaice_tpu_torch.coupler", "seaice_tpu_torch.coupled",
    "seaice_tpu_torch.prescribed", "seaice_tpu_torch.special_boundaries",
    "seaice_tpu_torch.analysis", "seaice_tpu_torch.analysis.driver",
    "seaice_tpu_torch.analysis.members", "seaice_tpu_torch.dynamics.weak",
    "seaice_tpu_torch.dynamics.implicit",
    "seaice_tpu_torch.transport.upwind", "seaice_tpu_torch.column.snicar",
    "seaice_tpu_torch.column.aerosol", "seaice_tpu_torch.io.synthetic",
]
EXAMPLES = [os.path.join(ROOT, "examples", name) for name in (
    "torch_run_from_namelist.py", "torch_run_coupled.py",
    "torch_run_box_test.py", "torch_run_global.py",
    "torch_run_5day_global.py", "torch_run_5day_from_files.py")] + [
    os.path.join(ROOT, "entry_torch.py")]


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
    files = [os.path.join(ROOT, "chip_smoke.py")] + EXAMPLES
    for d, _, names in os.walk(os.path.join(ROOT, "seaice_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    names = {os.path.relpath(f, ROOT) for f in files}
    for new in ("mesh/panels.py", "mesh/structured.py",
                "dynamics/variational_panel.py", "dynamics/cuda_panel.py",
                "dynamics/cuda_panel_fused.py", "dynamics/cuda_raster.py",
                "parallel/partition.py", "parallel/sharded.py",
                "parallel/comm.py",
                "forcing/clock.py", "forcing/core.py", "io/mesh_reader.py",
                "io/forcing_reader.py", "io/state_reader.py",
                "io/checkpoint.py", "io/output.py", "io/parallel.py",
                "testcases/ic.py", "namelist.py", "diagnostics.py",
                "error.py", "run.py", "coupler.py", "coupled.py",
                "prescribed.py", "special_boundaries.py", "column/zbgc.py",
                "analysis/driver.py", "analysis/members.py",
                "dynamics/weak.py", "dynamics/implicit.py",
                "transport/upwind.py", "column/snicar.py",
                "column/aerosol.py", "io/synthetic.py"):
        assert os.path.join("seaice_tpu_torch", new) in names
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.match(line), f"{path}:{i}: {line}"


TINY_RUN = ["--subdiv", "2", "--subcycles", "8"]
# each of the port's example scripts (and its entry file) with tiny CPU
# arguments
EXAMPLE_RUNS = {
    "coupled": ("torch_run_coupled.py", ["--nx", "4", "--hours", "1"]),
    "namelist": ("torch_run_from_namelist.py", [
        "--namelist", os.path.join(ROOT, "examples",
                                   "namelist.seaice.example"),
        "--subdiv", "1"]),
    "box": ("torch_run_box_test.py", ["--nx", "6", "--hours", "1",
                                      "--subcycles", "8"]),
    "global": ("torch_run_global.py", TINY_RUN + ["--days", "0.021"]),
    "5day_global": ("torch_run_5day_global.py",
                    TINY_RUN + ["--days", "0.042"]),
    "5day_from_files": ("torch_run_5day_from_files.py",
                        TINY_RUN + ["--days", "0.042", "--verify-restart"]),
    "entry_torch": ("../entry_torch.py", ["--nx", "8", "--subcycles", "2",
                                          "--blocks", "2"]),
}

# run in a fresh process, which imports torch but not JAX: each example
# with --device cpu, then the JAX modules it loaded (none is allowed),
# then the example without --device, which must fail for want of a card
_EXAMPLE_RUNNER = """
import json, runpy, sys, traceback, torch
results = {}
for name, (path, args) in json.loads(sys.argv[1]).items():
    try:
        sys.argv = [path] + args + ["--device", "cpu"]
        runpy.run_path(path, run_name="__main__")
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "seaice_tpu")]
        assert not bad, bad
        if not torch.cuda.is_available():
            sys.argv = [path] + args
            try:
                runpy.run_path(path, run_name="__main__")
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("ran without a card")
        results[name] = "clean"
    except BaseException:
        results[name] = traceback.format_exc()[-3000:]
print("RESULTS " + json.dumps(results))
"""


@pytest.fixture(scope="module")
def example_runs(tmp_path_factory):
    """{example id: "clean" or the failure} of one subprocess that runs
    every example of EXAMPLE_RUNS in turn (torch is imported once: about 3 s
    a process)."""
    import json
    todo = {}
    for name, (example, args) in EXAMPLE_RUNS.items():
        if "namelist" in example or "5day" in example:
            args = args + ["--outdir", str(tmp_path_factory.mktemp(name))]
        todo[name] = (os.path.normpath(os.path.join(ROOT, "examples",
                                                    example)), args)
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _EXAMPLE_RUNNER,
                        json.dumps(todo)], cwd=ROOT, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=600)
    lines = [x for x in r.stdout.splitlines() if x.startswith("RESULTS ")]
    assert r.returncode == 0 and lines, r.stdout[-3000:]
    return json.loads(lines[-1][len("RESULTS "):])


@pytest.mark.parametrize("name", list(EXAMPLE_RUNS))
def test_examples_leave_jax_out_and_default_to_the_card(name, example_runs):
    """Each of the port's examples, and its entry file `entry_torch.py`,
    runs on the CPU when asked (`--device cpu`, tiny sizes) and loads
    nothing of JAX or of the JAX package while it runs; without --device
    it asks for the card, and without one it fails.  All run in one
    subprocess (`example_runs`), each checked on its own."""
    assert example_runs[name] == "clean", example_runs[name]


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
    from seaice_tpu_torch.column.driver import ColumnPhysics
    from seaice_tpu_torch.parallel.sharded import full_physics_inputs
    from seaice_tpu_torch.dynamics.weak import build_weak_tensors
    from seaice_tpu_torch.transport.upwind import build_upwind_tensors
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
        "ColumnPhysics": with_device(
            lambda **kw: ColumnPhysics(3, 4, shortwave="dEdd",
                                       dtype=f64, **kw).salin),
        "full_physics_inputs": with_device(
            lambda **kw: full_physics_inputs(
                mesh, C_full(), f64, **kw)[3]["iceSalinity"]),
        "build_weak_tensors": with_device(
            lambda **kw: build_weak_tensors(mesh, f64,
                                            **kw).tan_lat_vertex),
        "build_upwind_tensors": with_device(
            lambda **kw: build_upwind_tensors(mesh, f64, **kw).dv_edge),
        "load_sharded_checkpoint": with_device(
            lambda **kw: load_sharded_checkpoint(
                ckpt["dir"], "sharded", ckpt["part"], ckpt["template"],
                **kw)[0][1].time),
    }


def C_full():
    """The small full-physics config of `full_physics_inputs`."""
    from seaice_tpu_torch import config as C
    return C.Config(run=C.RunConfig(n_categories=3, n_ice_layers=4))


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
            "load_sharded_checkpoint", "ColumnPhysics", "full_physics_inputs",
            "build_weak_tensors", "build_upwind_tensors"]


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
    """Every column option builds (the default config is the column
    package with BL99 thermodynamics), in the sharded model too (each
    block carries it): the brine height, z-salinity, skeletal and
    vertical biogeochemistry with the z-layer aerosols, the last options
    the port once left out (ROADMAP Queue 1 item 10e), among them; the
    reference's exclusive options raise ValueError in both."""
    import dataclasses
    from seaice_tpu_torch import config as C
    from seaice_tpu_torch.column.zbgc import ZbgcParams
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    mesh, _ = _small_model_args()
    assert SeaIceModel(mesh, C.Config(), device="cpu").column is not None
    zp = ZbgcParams(n_algae=3, use_C=True, use_DON=True, use_Fe=True,
                    use_DMS=True, use_PON=True, use_hum=True, use_zaero=True)
    for opts in (dict(solve_zsalinity=True, use_skeletal_biochemistry=True),
                 dict(use_biogeochemistry=True, shortwave="dEdd",
                      zbgc_params=zp)):
        cfg = C.Config(column=C.ColumnConfig(**opts))
        assert SeaIceModel(mesh, cfg, device="cpu").column is not None
        sm = ShardedSeaIceModel(mesh, cfg, 2, devices="cpu")
        assert all(m.column is not None for m in sm.models)
    for opts in (dict(use_biogeochemistry=True,
                      use_skeletal_biochemistry=True),
                 dict(use_biogeochemistry=True, n_aerosols=2,
                      zbgc_params=zp)):
        cfg = C.Config(column=C.ColumnConfig(**opts))
        with pytest.raises(ValueError, match="exclusive"):
            SeaIceModel(mesh, cfg, device="cpu")
        with pytest.raises(ValueError, match="exclusive"):
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
