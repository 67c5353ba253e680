#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`seaice_tpu_torch`).

Run `python3 chip_smoke.py` from the repository root on a machine with one
NVIDIA Hopper GPU, PyTorch with CUDA and `nvcc`.  It

  1. builds the CUDA kernels from `seaice_tpu_torch/csrc/` (one nvcc per
     source, in parallel) and the host remap-stencil library;
  2. drives these paths at full width through `SeaIceModel.make_step()`,
     `ShardedSeaIceModel.make_step()`, the runners of `run.py` and the
     drivers of `coupled.py`, float32, the first four with the column
     package off:
       raw sphere   raw icosahedral subdiv 6 (40,962 cells), 5 categories,
                    7 ice + 1 snow layers, full enthalpy tracer tree, EVP
                    with 120 subcycles and metric terms, incremental
                    remapping: the any-connectivity loop K1 + the flux
                    kernel K2;
       panel sphere the same model on the panel-reordered mesh: the
                    whole-loop panel kernel K3 + K2, and with
                    `use_fused_panel_loop=False` the per-subcycle cell
                    kernel K5 (bound once per solve, 120 launches); then
                    K3 alone on the subdiv-7 panel sphere (163,842 cells,
                    the benchmark's QU60 mesh), where its blocks stream
                    the basis, held to its plain version as at subdiv 6;
       sharded sphere the raw sphere split into 4 blocks on the one card,
                    stepped in lockstep: the one-subcycle kernel K6 (one
                    call per subcycle for all 4 blocks, two launches, the
                    vertex halo exchanged between calls) + K2 per block;
       raster box   the 168 x 168 box test, raster-ordered, one category:
                    the raster loop K4;
       full-physics panel sphere  `bench_full.py`'s workload (the main
                    path): the panel sphere with mushy thermodynamics,
                    delta-Eddington shortwave, level-ice ponds, Rothrock
                    strength and ridging around K3 + K2 (its inputs built
                    here, nothing of the JAX package imported);
       file-driven run  the same column on the subdiv-6 MPAS file of
                    `tests/mpas_fixture.py` (written into a temporary
                    directory, read by the port's reader; not
                    panel-ordered, so K1 + K2) with CORE and NCAR forcing
                    files, through `run.py::StandaloneRunner`: 48 steps
                    (240 with --five-day) with the state check after every
                    step, restarted halfway from a checkpoint in a new
                    runner (bitwise the straight run), and the same steps
                    in float64 (BASELINE.md's budget on the global totals
                    and on the surface temperature where both runs hold
                    ice: ROADMAP Queue 3, fault 6);
       sharded full physics  the raw sphere with the column in 4 blocks
                    (K6 + K2) against the unsharded step (K1), then two
                    steps of `ShardedStandaloneRunner` from forcing files,
                    whose per-block checkpoint reads back bitwise;
       namelist run `config_from_namelist` on
                    `examples/namelist.seaice.example` (the same column
                    with ice age and first-year ice), the raw sphere,
                    forcing files, `StandaloneRunner` with every analysis
                    member, 12 steps (K1 + K2): the ice age and first-year
                    area held every step, the members' results finite;
       coupled run  `CoupledDriver` on that model, 2 substeps an interval,
                    4 intervals (K1 + K2): the exports, the interval means
                    bitwise the same steps by hand, one interval in
                    prescribed mode;
       sharded coupled run  `ShardedCoupledDriver`, 4 blocks, 1 interval
                    (K6 + K2): the gathered export bitwise the same
                    sharded steps by hand;
       solver variants  the options whose subcycle loop is plain torch
                    (`evp.variant_subcycles`, the JAX package's XLA loop):
                    a. revised EVP on the raw sphere with IR (K2, held
                    against its plain version), moved off standard EVP's
                    answer; d. linear ocean stress, no ocean stress, strain
                    averaging and the linear relation, one step each;
                    e. revised EVP in 4 blocks against the unsharded steps;
                    b. the weak scheme with upwind transport under a 5 m/s
                    zonal wind (no kernel); c. upwind transport on the
                    panel sphere (K3, held against its plain version);
                    f. the JFNK VP solver (`dynamics/implicit.py`) against
                    EVP with 240 subcycles on the 168 x 168 box (K4, held),
                    its GMRES cycles and host syncs a step printed;
       column options  the full-physics panel sphere with the column's
                    thermodynamics, surface and snow options (K3 + K2):
                    a. the snow tracers with ITDrdg snow redistribution,
                    form drag and high-frequency coupling, 2 steps (K3 and
                    K2 held against their plain versions on step 2's
                    inputs, K2's table width printed), then bulk and
                    ITDsd one step each; b. the zero-layer thermodynamics,
                    2 steps, held likewise; a and b each with the remap's
                    conservation by tracer product, the host syncs of a
                    step, the idle share and float32 against float64 by
                    ROADMAP Queue 3 fault 6's rule; c. one CoupledDriver
                    interval with BL99 and prescribed per-category surface
                    fluxes, bitwise the same steps by hand, float32
                    against float64; d. CESM ponds with the snow tracers
                    and the snow-liquid routing, SNICAR and 2 bulk
                    aerosol species; e. topographic ponds with the pond
                    freshwater feedback, dEdd and modal aerosols (2
                    species); d and e under a melting atmosphere with real
                    initial ponds and seeded aerosol deposition, 2 steps
                    each, held as a and b, the pond and aerosol products
                    among the conserved ones, the aerosol budget of each
                    column step held; f. BL99 with the vertical salinity
                    and the skeletal biogeochemistry (the salt budget of
                    each column step held); g. mushy with the vertical
                    zBGC on the full roster (3 algal classes, every pool)
                    and 3 z-layer aerosol bins under the melting
                    atmosphere with seeded deposition (every zBGC step's
                    output finite and non-negative, its carbon residual
                    held, the z-aerosol mass in the ice growing): f and g
                    2 steps each, held as a and b, K2 at the widest
                    table (980 columns; its plain version over edge
                    chunks, the card's peak memory around it printed);
       fault 16     the full-physics panel sphere with BL99 (Tsfc
                    computed) through CoupledDriver, float32, 8 substeps:
                    every tracer finite after each (ROADMAP Queue 3
                    fault 16);
       entry scripts  `examples/torch_run_box_test.py` (K4),
                    `torch_run_global.py` (K1), `torch_run_5day_global.py`
                    and `torch_run_5day_from_files.py` (K1 + K2, with its
                    restart check) through runpy, 2 steps each at the
                    script's own mesh (the box 80 x 80), and
                    `entry_torch.py`'s entry() (K4) and
                    dryrun_multichip(4) (K6 + K2);
  3. holds each kernel against its plain PyTorch version on the card, on
     the very tensors the step hands it (float32, and the same tensors
     cast to float64), and times both with CUDA events; reports the
     kernel launches per call of the three whole-loop kernels K1, K3 and
     K4 (each one cooperative launch: anything else fails), their grid
     and shared-memory shape (`launch_f32`, `launch_f64`), the C call
     alone (`kernel_ms`) of every kernel, the CUDA kernels per call of K2,
     K5 and K6 (torch.profiler; more than 3, 1 and 2 fail), the registers
     and spills of K1, K4 (`build` line) and K5, K6's host time per call;
     runs K1 against K6's per-subcycle calls on the raw sphere as one
     block and on K3's inputs (two kernels, one function) and reports
     their times and distances; holds the sharded step against the
     unsharded one; on the full-physics path holds K3 (fed the Rothrock
     strength) and K2 (the column's tracer table, ponds included) to
     their plain versions on the tensors that step hands them;
  4. for each path sets the launch counts to 0, takes a few steps, reads
     the counts and checks the state (finite, |u| bounded, every tracer
     product conserved; on the full-physics path, which changes the
     mass, aice <= 1 + 1e-6, the remap's own conservation error, no
     unconverged column); on the full-physics path it also counts the
     host syncs of a step and holds the float32 state against the same
     steps in float64 (BASELINE.md's budget); with --profile each traced
     path splits its device and idle time by the program's own spans;
  5. checks small float64 models (raw sphere, panel sphere by both routes,
     box, sphere in 4 blocks, full-physics panel sphere, `CoupledDriver`
     on the 8 x 8 box with the column; the raw sphere with revised EVP,
     the weak scheme with upwind, the panel sphere with upwind, 2 blocks
     with revised EVP, the VP solver on the 12 x 12 box) on the card
     against the same models on the CPU (plain PyTorch throughout).

One JSON object per line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase exits non-zero.  Without a CUDA device it prints no
result and exits 2.
"""

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet), for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12      # float32 outside the tensor cores

# tolerances, relative to the field's max |value|.  Kernel and plain
# version do the same arithmetic; they differ in the order of sums and in
# fused multiply-adds, nothing else.
TOL = {torch.float32: 2e-5, torch.float64: 1e-10}
# K1's float32 kernel against its float32 plain version over a short loop
SHORT_LOOP, SHORT_LOOP_TOL = 10, 1e-4
# the full width of the sphere paths, and of the box path
SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES = 6, 5, 7, 120
BOX_NX = 168
# the blocks of the sharded sphere, all on the one card
SHARDS = 4

# the full-physics path: the float32 step against float64 after the same
# steps (BASELINE.md's f32-vs-f64 budget: area and volume 3.3e-5 and
# enthalpy 1.4e-4 of their max, surface temperature 0.27 K pointwise)
F32_F64_BUDGET = {"iceAreaCategory": 3.3e-5, "iceVolumeCategory": 3.3e-5,
                  "iceEnthalpy": 1.4e-4}
TSFC_BUDGET_K = 0.27
IR_CONSERVATION_LIMIT = 1e-5
# a field whose CPU max stays below this in the small full-physics model
# is rounding noise (melt ponds of 1e-10 m under cold forcing): the
# card's must stay below it too
NOISE = 1e-8

# CICE category thickness bounds for 5 categories (m)
HIN_MAX = np.array([0.0, 0.6445, 1.3914, 2.4702, 4.5673, 9.3338])


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        fail("nvidia-smi: " + r.stdout)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=1):
    """Median milliseconds of fn() by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def time_ms_per_call(fn, reps, n=20):
    """Median milliseconds per call of fn() over runs of n calls back to
    back, by CUDA events: the device time of a short kernel without the
    host's gap before a single launch."""
    def run():
        for _ in range(n):
            fn()
    return time_ms(run, reps) / n


def ptxas_of(source, kernel):
    """The lines `nvcc -Xptxas -v` printed for the entry functions of
    `source` whose names contain `kernel`: registers, spills, stack."""
    from seaice_tpu_torch.kernels import build
    out, name = {}, None
    for ln in build.build_log.get(source, "").splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if kernel in ln else None
        elif name is not None and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def device_profile(fn, n=3):
    """torch.profiler over n calls of fn() after one warm-up call and one
    profiled warm-up round whose records are dropped (the tracer misses
    kernels launched right after it starts): (CUDA kernels per call,
    {kernel name: device ms per call})."""
    from torch.profiler import ProfilerActivity, schedule
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA],
                                schedule=schedule(wait=0, warmup=1, active=1,
                                                  repeat=1)) as prof:
        for _ in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    count, ms = 0, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is None or \
                "CUDA" not in str(e.device_type):
            continue
        count += e.count
        ms[e.key[:60]] = getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0.0)) / 1e3 / n
    return count / n, ms


def rel_err(a, b):
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-300)


def sphere_case(subdiv, n_cat, n_ice, n_sub, panel=False,
                fused_panel_loop=None, vel=None, upwind=False, zonal=False):
    """The sphere configuration: mesh, config, tracer tree, and the global
    initial ice (polar caps) and forcing (analytic wind) as numpy.  vel:
    velocity-solver options over the defaults (a solver variant); upwind:
    upwind advection in place of incremental remapping; zonal: the
    forcing of `tests/test_sphere.py` (a 5 m/s zonal wind)."""
    from seaice_tpu_torch import config as C
    from seaice_tpu_torch.mesh import (icosahedral_mesh,
                                       latlon_vector_rotation_forward)
    from seaice_tpu_torch.transport.tracers import standard_tracer_tree

    mesh = icosahedral_mesh(subdiv)
    if panel:
        from seaice_tpu_torch.mesh.panels import panel_reorder
        mesh, _ = panel_reorder(mesh, subdiv)
    cfg = C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=n_cat, n_ice_layers=n_ice,
                        n_snow_layers=1),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=n_sub, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False,
            use_fused_panel_loop=fused_panel_loop, **(vel or {})),
        advection=C.AdvectionConfig(advection_type=(
            C.AdvectionType.UPWIND if upwind
            else C.AdvectionType.INCREMENTAL_REMAP)),
        column=C.ColumnConfig(use_column_package=False))
    tree = standard_tracer_tree(n_ice_layers=n_ice, n_snow_layers=1)
    nc = mesh.n_cells
    polar = np.abs(mesh.lat_cell) > np.deg2rad(65.0)
    h = HIN_MAX[:n_cat + 1]
    mids = 0.5 * (h[:-1] + np.minimum(h[1:], 10.0))
    area = np.where(polar[:, None], 0.9 / n_cat, 0.0) * np.ones((1, n_cat))
    lat, lon = mesh.lat_cell, mesh.lon_cell
    u_t = 6.0 * np.cos(lat) + 2.0 * np.sin(lon)
    v_t = 1.5 * np.sin(2 * lon)
    if zonal:
        u_t, v_t = np.full(nc, 5.0), np.zeros(nc)
    uw, vw = latlon_vector_rotation_forward(
        u_t, v_t, mesh.x_cell, mesh.y_cell, mesh.z_cell)
    z = np.zeros(nc)
    forcing = dict(u_air_velocity=uw, v_air_velocity=vw,
                   air_density=np.full(nc, 1.3), u_ocean_velocity=z,
                   v_ocean_velocity=z, sea_surface_tilt_u=z,
                   sea_surface_tilt_v=z, land_ice_mask=z)
    return mesh, cfg, tree, (area, area * mids, area * 0.05), forcing


def build_model(subdiv, n_cat, n_ice, n_sub, dtype, device, panel=False,
                fused_panel_loop=None, **case):
    """The sphere model: raw icosahedral mesh, or panel-reordered; case:
    `sphere_case`'s vel, upwind and zonal."""
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing
    from seaice_tpu_torch.model import SeaIceModel
    mesh, cfg, tree, ice, forcing = sphere_case(
        subdiv, n_cat, n_ice, n_sub, panel, fused_panel_loop, **case)
    model = SeaIceModel(mesh, cfg, dtype=dtype, device=device,
                        tracer_tree=tree)
    device = model.device          # the card, where None was asked for
    state = model.init_state(*ice)
    forcing = DynamicsForcing(**{
        k: torch.as_tensor(v).to(device=device, dtype=dtype)
        for k, v in forcing.items()})
    return model, state, forcing


def build_sharded_model(subdiv, n_cat, n_ice, n_sub, dtype, device,
                        n_shards, vel=None):
    """The raw sphere split into n_shards blocks on one device (vel: a
    solver variant's options)."""
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    mesh, cfg, tree, ice, forcing = sphere_case(subdiv, n_cat, n_ice, n_sub,
                                                vel=vel)
    model = ShardedSeaIceModel(mesh, cfg, n_shards, dtype=dtype,
                               devices=device, tracer_tree=tree)
    return (model, model.init_state(*ice),
            model.scatter_cell_tree(DynamicsForcing(**forcing)))


def stepper(model, col=None):
    """step(state, forcing) -> (state, diags) of a SeaIceModel or a
    ShardedSeaIceModel (whose state and forcing are lists of blocks);
    col: the column physics' (AtmosForcing, OceanForcing, coszen) of a
    full-physics model, with the aerosol deposition faero_atm as a fourth
    entry where the model carries aerosols (of a sharded one: lists of
    blocks)."""
    step = model.make_step()
    if hasattr(model, "halo"):
        return lambda state, forcing: step(model.tensors, model.halo, state,
                                           forcing, *(col or ()))
    if col is not None:
        atm, ocn, coszen, *faero = col
        kw = {"faero_atm": faero[0]} if faero else {}
        return lambda state, forcing: step(model.tensors, state, forcing,
                                           atm, ocn, coszen=coszen, **kw)
    return lambda state, forcing: step(model.tensors, state, forcing)


def global_fields(model, state):
    """{"u", "v", tracer names: numpy array on the whole mesh}."""
    if hasattr(model, "halo"):
        u, v = model.gather_velocity(state)
        return dict(u=u, v=v, **model.gather_tracers(state))
    return dict(u=state.velocity.u_velocity.cpu().numpy(),
                v=state.velocity.v_velocity.cpu().numpy(),
                **{k: t.cpu().numpy() for k, t in state.tracers.items()})


def build_box_model(nx, n_sub, dtype, device):
    """The box test on a raster-ordered nx x nx quad mesh, one category."""
    from seaice_tpu_torch.config import box_test_config
    from seaice_tpu_torch.mesh.structured import raster_reorder
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.testcases import box
    cfg = box_test_config(elastic_subcycles=n_sub)
    mesh = raster_reorder(box.box_test_mesh(nx, nx))
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=dtype, device=device)
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    state = model.init_state(area, vol, snow)
    forcing = box.box_forcing(mesh, t=0.0, dtype=dtype, device=model.device)
    return model, state, forcing


def full_physics_case(subdiv, n_cat, n_ice, n_sub, dtype, device,
                      panel=True):
    """The full-physics workload of `bench_full.py` (the north-star panel
    step), built by the port alone: the panel-reordered sphere, mushy
    thermodynamics, delta-Eddington shortwave, level-ice ponds, Rothrock
    strength, ITD thermodynamics and ridging, incremental remapping with
    its conservation check; polar caps of ice (|lat| > 65 deg, 90%
    spread over the categories, -10 C ice, -12 C snow, -15 C surface),
    the analytic wind, an air temperature falling to the poles,
    shortwave, a slab ocean's frzmlt and coszen = clip(cos(lat - 0.3)).
    Returns (model, state, forcing, (AtmosForcing, OceanForcing,
    coszen))."""
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.mesh.panels import panel_reorder
    from seaice_tpu_torch.model import SeaIceModel

    mesh = icosahedral_mesh(subdiv)
    if panel:
        mesh, _ = panel_reorder(mesh, subdiv)
    model = SeaIceModel(mesh, full_physics_config(n_cat, n_ice, n_sub),
                        dtype=dtype, device=device)
    return (model,) + full_physics_inputs(model)


def full_physics_config(n_cat, n_ice, n_sub):
    """`full_physics_case`'s configuration."""
    from seaice_tpu_torch import config as C
    return C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=n_cat, n_ice_layers=n_ice),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=n_sub, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(conservation_check=True),
        column=C.ColumnConfig(ktherm=2, shortwave="dEdd",
                              pond_scheme="lvl", kstrength=1))


def full_physics_inputs(model):
    """The initial state, forcing and column forcing of
    `full_physics_case` for a full-physics model of the panel sphere:
    (state, forcing, (AtmosForcing, OceanForcing, coszen))."""
    from seaice_tpu_torch.column.driver import (AtmosForcing, OceanForcing,
                                                slab_ocean_frzmlt)
    from seaice_tpu_torch.column.thermo_shared import (
        ice_enthalpy_from_temperature, melting_temperature,
        salinity_profile, snow_enthalpy_from_temperature)
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing
    from seaice_tpu_torch.mesh import latlon_vector_rotation_forward
    mesh, dtype, dev = model.mesh, model.dtype, model.device
    dt = model.cfg.run.dt
    n_cat, n_ice = model.cfg.run.n_categories, model.cfg.run.n_ice_layers

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=dev, dtype=dtype)

    nc, ns = mesh.n_cells, 1
    lat, lon = mesh.lat_cell, mesh.lon_cell
    polar = np.abs(lat) > np.deg2rad(65.0)
    h = model.column.hin_max
    mids = 0.5 * (h[:-1] + np.minimum(h[1:], 10.0))
    area = np.where(polar[:, None], 0.9 / n_cat, 0.0) * np.ones((1, n_cat))
    state = model.init_state(area, area * mids, area * 0.05)
    S = t(np.tile(salinity_profile(n_ice), (nc, n_cat, 1)))
    has = t(area[..., None] > 0)
    tr = dict(state.tracers)
    tr["surfaceTemperature"] = t(np.where(area > 0, -15.0, 0.0))
    tr["iceEnthalpy"] = ice_enthalpy_from_temperature(
        t(np.full((nc, n_cat, n_ice), -10.0)) * has,
        melting_temperature(S)) * has
    tr["iceSalinity"] = S * has
    tr["snowEnthalpy"] = snow_enthalpy_from_temperature(
        t(np.full((nc, n_cat, ns), -12.0))) * has
    state = state.replace(tracers=tr)

    u_t = 6.0 * np.cos(lat) + 2.0 * np.sin(lon)
    v_t = 1.5 * np.sin(2 * lon)
    uw, vw = latlon_vector_rotation_forward(
        u_t, v_t, mesh.x_cell, mesh.y_cell, mesh.z_cell)
    one, z = np.ones(nc), np.zeros(nc)
    forcing = DynamicsForcing(
        u_air_velocity=t(uw), v_air_velocity=t(vw),
        air_density=t(1.3 * one), u_ocean_velocity=t(z),
        v_ocean_velocity=t(z), sea_surface_tilt_u=t(z),
        sea_surface_tilt_v=t(z), land_ice_mask=t(z))
    atm = AtmosForcing(
        air_temperature=t(288.0 - 45.0 * np.sin(np.abs(lat)) ** 2),
        specific_humidity=t(4e-4 * one), u_air=t(uw), v_air=t(vw),
        longwave_down=t(180.0 * one), sw_vis_dir=t(30.0 * one),
        sw_vis_dif=t(20.0 * one), sw_ir_dir=t(25.0 * one),
        sw_ir_dif=t(15.0 * one), rain_rate=t(z), snow_rate=t(2e-6 * one),
        air_density=t(1.3 * one), air_level_height=t(10.0 * one))
    sst, Tf = t(np.where(polar, -1.7, 8.0)), t(-1.8 * one)
    ocn = OceanForcing(
        sst=sst, sss=t(34.0 * one), freezing_temperature=Tf,
        frzmlt=slab_ocean_frzmlt(sst, Tf, t(20.0 * one), dt),
        mixed_layer_depth=t(20.0 * one))
    coszen = t(np.clip(np.cos(lat - 0.3), 0.0, 1.0))
    return state, forcing, (atm, ocn, coszen)


def count_host_syncs(fn):
    """The synchronizing CUDA operations fn() makes (torch's sync debug
    mode warns once for each)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n = sum("synchroniz" in str(w.message) for w in caught)
    return out, n


def full_physics_path(label, model, state, forcing, col, n_steps,
                      capture_last=False, sums=None):
    """Drive the full-physics step: counts to 0, n_steps steps, read the
    counts, check the state (finite, |u| < 3 m/s, aice <= 1 + 1e-6, the
    remap's conservation error <= IR_CONSERVATION_LIMIT, no column left
    unconverged) and that K3 and K2 ran once per velocity solve and
    remap.  capture_last: record the kernel calls of the last step
    (`capture_calls`); sums: a RemapSums whose errors are held by tracer
    product after the steps (`hold_products`).  Returns (state, median
    ms per step, the BL99/Picard/zero-layer iterations of each step, the
    last step's kernel calls or None, the launch counts read, the last
    step's diags)."""
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    step = stepper(model, col)
    n_dyn = model.cfg.velocity.dynamics_subcycle_number
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()     # the path's own peak
    ms, diags_all, calls = [], [], None
    for i in range(n_steps):
        t0 = time.perf_counter()
        if capture_last and i == n_steps - 1:
            (state, diags), calls = capture_calls(
                lambda: step(state, forcing))
        else:
            state, diags = step(state, forcing)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        diags_all.append(diags)
    counts = launch_counts()
    iters = [d["column_fluxes"].thermo_iterations for d in diags_all]
    ir_err = max(float(d["ir_conservation_error"]) for d in diags_all)
    unconv = sum(int(d["column_fluxes"].warnings["thermo_unconverged"].sum())
                 for d in diags_all)
    fields = global_fields(model, state)
    u, v = fields.pop("u"), fields.pop("v")
    max_u = float(np.sqrt(u * u + v * v).max())
    aice_max = float(fields["iceAreaCategory"].sum(-1).max())
    out = {"path": label, "steps": n_steps, "ms_per_step": ms,
           "ms_per_step_median": float(np.median(ms)), "launches": counts,
           "max_speed": max_u, "aice_max": aice_max,
           "ir_conservation_error": ir_err, "thermo_unconverged": unconv,
           "thermo_iterations_per_step": iters,
           "ice_area_sum": float(fields["iceAreaCategory"].sum()),
           "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    if sums is not None:
        out["ir_conservation_by_product"] = hold_products(
            label, state.tracers, model.tensors.area_cell, sums)
    emit({"main_path": out})
    for name, t in list(fields.items()) + [("u", u), ("v", v)]:
        if not np.isfinite(t).all():
            fail(f"{label}: {name} is not finite")
    if not 0.0 < max_u < 3.0:
        fail(f"{label}: max |u| = {max_u} outside (0, 3) m/s")
    if not aice_max <= 1.0 + 1e-6:
        fail(f"{label}: aice = {aice_max} > 1 + 1e-6")
    if not ir_err <= IR_CONSERVATION_LIMIT:
        fail(f"{label}: ir_conservation_error {ir_err} > "
             f"{IR_CONSERVATION_LIMIT}")
    if unconv:
        fail(f"{label}: {unconv} columns left in thermo_unconverged")
    want = {"evp_panel_loop": n_dyn * n_steps,
            "integrate_fluxes_cuda": n_dyn * n_steps}
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times in {n_steps} steps, "
                 f"expected {want.get(name, 0)}")
    return state, float(np.median(ms)), iters, calls, counts, diags


def f32_against_f64(f32, n_steps):
    """The float32 full-physics state after n_steps against the same
    steps in float64 on the card, from the same initial state
    (`hold_f32_to_f64`)."""
    model, state, forcing, col = full_physics_case(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, torch.float64, None)
    step = stepper(model, col)
    for _ in range(n_steps):
        state, _ = step(state, forcing)
    hold_f32_to_f64("full physics", f32, global_fields(model, state),
                    n_steps)


def hold_f32_to_f64(label, f32, f64, n_steps):
    """Area and volume to F32_F64_BUDGET relative to their max,
    iceEnthalpy likewise, surfaceTemperature to TSFC_BUDGET_K pointwise
    (BASELINE.md's f32-vs-f64 budget); the velocity distance is printed,
    not held."""
    out = {k: rel_err(torch.as_tensor(f32[k]).double(),
                      torch.as_tensor(f64[k]))
           for k in F32_F64_BUDGET}
    out["surfaceTemperature_max_abs_K"] = float(
        np.abs(f32["surfaceTemperature"] - f64["surfaceTemperature"]).max())
    speed = float(np.sqrt(f64["u"] ** 2 + f64["v"] ** 2).max())
    out["velocity_max_abs_over_max_speed_unheld"] = float(max(
        np.abs(f32["u"] - f64["u"]).max(),
        np.abs(f32["v"] - f64["v"]).max())) / speed
    emit({"full_physics_f32_vs_f64": dict(out, steps=n_steps)})
    for k, lim in F32_F64_BUDGET.items():
        if not out[k] <= lim:
            fail(f"{label}: f32 {k} differs from f64 by {out[k]} > {lim}")
    if not out["surfaceTemperature_max_abs_K"] <= TSFC_BUDGET_K:
        fail(f"{label}: f32 surfaceTemperature differs from f64 by "
             f"{out['surfaceTemperature_max_abs_K']} K > {TSFC_BUDGET_K}")


def capture_kernel_inputs(model, state, forcing, col=None):
    """Take one step (with the column forcing `col` of a full-physics
    model) with recording wrappers in place of the kernel wrappers;
    returns (state after the step, {kernel name: [(args, kwargs)
    of each call in that step]})."""
    (state, _), rec = capture_calls(
        lambda: stepper(model, col)(state, forcing))
    return state, rec


def capture_calls(fn):
    """fn() with recording wrappers in place of the kernel wrappers;
    returns (fn's result, {kernel name: [(args, kwargs) of each call]})."""
    from seaice_tpu_torch.dynamics import cuda_raster, evp as evp_mod
    from seaice_tpu_torch.transport import cuda_flux as flux_mod
    sites = [(evp_mod, "evp_subcycle_loop"), (evp_mod, "evp_panel_loop"),
             (evp_mod, "panel_cell_step"), (cuda_raster, "evp_raster_loop"),
             (evp_mod, "evp_subcycle_prepare"),
             (flux_mod, "integrate_fluxes_cuda")]
    rec, saved = {}, []

    def recorder(name, fn):
        def wrapped(*a, **kw):
            if name != "panel_cell_step":
                rec.setdefault(name, []).append((a, kw))
            elif name not in rec:
                # K5's loop: the inputs of its first step, as the plain
                # version takes them (the loop's buffers change later)
                lp = a[0]
                rec[name] = [((lp.pt, lp.planes.clone(),
                               *(t.clone() for t in lp.current),
                               lp.pressure, lp.ss_mask), dict(lp.kw))]
            return fn(*a, **kw)
        return wrapped

    for mod, name in sites:
        f = getattr(mod, name)
        saved.append((mod, name, f))
        setattr(mod, name, recorder(name, f))
    try:
        out = fn()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    torch.cuda.synchronize()
    return out, rec


def cast(obj, dtype):
    from seaice_tpu_torch.utils.containers import to_device
    return to_device(obj, torch.device("cuda"), dtype)


def loop_specs():
    """The three whole-loop EVP kernels: wrapper, plain version, the work
    count (bytes, flops) of a captured call in float32, and where in the
    arguments the loop state (u, v, s11, s22, s12) begins."""
    from seaice_tpu_torch.dynamics import (cuda_panel_fused, cuda_raster,
                                           cuda_unstructured)
    from seaice_tpu_torch.dynamics.variational_panel import panel_n_of

    def work_k1(args, kw):
        me, nc = args[0].voc_T.shape
        vd, nv = args[0].flat_corner_idx.shape
        shapes = {"nc": nc, "nv": nv, "me": me, "vd": vd}
        return shapes, cuda_unstructured.evp_loop_work(
            nc, nv, me, vd, kw["n_subcycles"], kw["include_metric"], 4)

    def work_k3(args, kw):
        N = panel_n_of(args[0])
        shapes = {"N": N, "npc": 10 * (N + 1) ** 2 + 2,
                  "nc": 10 * N * N + 2, "nv": 20 * N * N}
        return shapes, cuda_panel_fused.evp_panel_loop_work(
            N, kw["n_subcycles"], kw["include_metric"], 4)

    def work_k4(args, kw):
        r = args[0]
        shapes = {"nxc": r.nxc, "nyc": r.nyc, "nc": r.nxc * r.nyc,
                  "nv": r.nxv * r.nyv}
        return shapes, cuda_raster.evp_raster_loop_work(
            r.nxc, r.nyc, kw["n_subcycles"], 4)

    return {
        "evp_subcycle_loop": dict(
            tag="K1", source="seaice_tpu_torch/csrc/evp_unstructured.cu",
            replaces="seaice_tpu/dynamics/pallas_unstructured.py:322",
            kernel=cuda_unstructured.evp_subcycle_loop,
            plain=cuda_unstructured.evp_subcycle_loop_plain, work=work_k1,
            state_at=1),
        "evp_panel_loop": dict(
            tag="K3", source="seaice_tpu_torch/csrc/evp_panel_fused.cu",
            replaces="seaice_tpu/dynamics/pallas_panel_fused.py:681",
            kernel=cuda_panel_fused.evp_panel_loop,
            plain=cuda_panel_fused.evp_panel_loop_plain, work=work_k3,
            state_at=1),
        "evp_raster_loop": dict(
            tag="K4", source="seaice_tpu_torch/csrc/evp_raster.cu",
            replaces="seaice_tpu/dynamics/pallas_evp.py:211",
            kernel=cuda_raster.evp_raster_loop,
            plain=cuda_raster.evp_raster_loop_plain, work=work_k4,
            state_at=5),
    }


def short_loop(name, a32, kw):
    """SHORT_LOOP float32 subcycles of a whole-loop EVP kernel against its
    plain version on the float32 arguments a32, and, for scale, the plain
    loop's own response to its arguments one float32 ulp larger: its
    state (u, v and the stresses; "state"), and the tensors after the
    state that are not 0/1 masks (strength, forcing, masses; "inputs",
    the only perturbation that moves a loop started from rest).  Returns
    (kernel's distance, {"state": response, "inputs": response}), each
    by field, relative to the field's max."""
    spec = loop_specs()[name]
    kernel, plain, at = spec["kernel"], spec["plain"], spec["state_at"]
    kws = dict(kw, n_subcycles=SHORT_LOOP)
    names = ("u", "v", "s11", "s22", "s12")
    ulp = 1.0 + 2.0 ** -23
    p_short = plain(*a32, **kws)

    def errs(x):
        return {n: rel_err(g.double(), w.double())
                for n, g, w in zip(names, x, p_short)}

    up = list(a32)
    up[at:at + 5] = [x * ulp for x in up[at:at + 5]]
    return errs(kernel(*a32, **kws)), {
        "state": errs(plain(*up, **kws)),
        "inputs": errs(plain(*inputs_one_ulp(a32, at + 5), **kws))}


def inputs_one_ulp(args, first):
    """args with every floating tensor from index `first` on that is not
    a 0/1 mask one ulp of its dtype larger."""
    def up(x):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point() \
                or bool(((x == 0) | (x == 1)).all()):
            return x
        return x * (1.0 + torch.finfo(x.dtype).eps)
    return list(args[:first]) + [up(x) for x in args[first:]]


def check_loop(name, call, reps, short_loop_from_response=False):
    """A whole-loop EVP kernel (K1, K3 or K4) against its plain version,
    twice over.

    ONE subcycle, where kernel and plain version differ only in the order
    of sums and in fused multiply-adds: held to TOL.  The WHOLE loop: the
    EVP iteration amplifies rounding differences (measured on an H100 at
    K1's shapes: float64 kernel against float64 plain 4e-16 after one
    subcycle, 7e-10 after 120; float32 PLAIN against float64 plain 6e-2
    in the shear stress after 120), so no fixed float32 tolerance on the
    whole loop separates a wrong kernel from a right one.  Nor does a
    fixed float64 one: how far two float64 evaluations drift apart in 120
    subcycles depends on the state (measured on an H100 on the panel
    sphere: the plain loop against ITSELF with u, v and the stresses one
    ulp larger, 5e-9 on the fourth step from rest and 1.5e-6 on the
    second, where K1, K3 and both plain loops all lie 1e-7 to 2e-6 from
    one another).  There the float64 pair is held to the larger of 1e-7
    and ten times that response of the plain loop to a one-ulp
    perturbation (`loop_rel_err_f64_plain_one_ulp`).  The float32
    kernel's distance to the float64 plain version is held, field by
    field, to the larger of twice the float32 plain version's own distance
    to it (plus 1e-5) and, as in float64, ten times the float32 plain
    loop's response to rounding (`loop_rel_err_f32_plain_one_ulp`: the
    largest distance of the float32 plain loop to itself started with its
    state one float32 ulp larger, or moved one ulp up or down at random in
    two seeded draws).  Twice a single float32 distance alone is no limit:
    measured on an H100 with `dev/k3_drift.py`, the float32 plain loop
    started one ulp away lies up to 3.6 times (full-physics state, u,
    120 subcycles) and 7.8 times (column-off state, s12, 60 subcycles) as
    far from float64 as the same loop from its inputs, the largest
    distances sit at single vertices of the ice edge, and K3's float32
    draws spread alike.  A ten-ulp error per subcycle would still be
    caught.  A SHORT loop of
    SHORT_LOOP subcycles, where the amplification has barely begun, holds
    the float32 kernel to the float32 plain version at SHORT_LOOP_TOL, so
    that a fault of the float32 instantiation in the loop (carrying state
    from one subcycle to the next) is caught as well; with
    short_loop_from_response (the column options' full-physics states,
    as K6's on the sharded full-physics step) at the larger of it and ten
    times the float32 plain loop's response to its state or its inputs
    one ulp larger (ROADMAP Queue 3, fault 2).  `max_abs_err` and
    `max_rel_err_f32` of the result are those of the one-subcycle float32
    comparison, the one held to TOL; the whole-loop distances are reported
    under `loop_rel_err_*`."""
    spec = loop_specs()[name]
    kernel, plain, tag0 = spec["kernel"], spec["plain"], spec["tag"]
    args, kw = call
    out = {"name": name, "route": "cuda", "source": spec["source"],
           "replaces": spec["replaces"], "library_ms": None}
    names = ("u", "v", "s11", "s22", "s12")
    a = {torch.float32: cast(args, torch.float32),
         torch.float64: cast(args, torch.float64)}
    tags = {torch.float32: "f32", torch.float64: "f64"}

    def errs(x, y):
        return {n: rel_err(g.double(), w.double())
                for n, g, w in zip(names, x, y)}

    kw1 = dict(kw, n_subcycles=1)
    for dtype, tag in tags.items():
        got = kernel(*a[dtype], **kw1)
        want = plain(*a[dtype], **kw1)
        torch.cuda.synchronize()
        e = errs(got, want)
        out["one_subcycle_rel_err_" + tag] = e
        if dtype == torch.float32:
            # the float32 comparison that is held to TOL
            out["max_abs_err"] = max(float((g - w).abs().max())
                                     for g, w in zip(got, want))
            out["max_rel_err_f32"] = max(e.values())
        if not max(e.values()) <= TOL[dtype]:
            fail(f"{tag0} {tag}, one subcycle: kernel and plain version "
                 f"disagree, {e} > {TOL[dtype]}")

    e, resp = short_loop(name, a[torch.float32], kw)
    out["short_loop_subcycles"] = SHORT_LOOP
    out["short_loop_rel_err_f32"] = e
    out["short_loop_rel_err_f32_plain_one_ulp"] = resp["state"]
    out["short_loop_rel_err_f32_plain_inputs_one_ulp"] = resp["inputs"]
    lim = {n: max(SHORT_LOOP_TOL, 10.0 * max(r[n] for r in resp.values()))
           if short_loop_from_response else SHORT_LOOP_TOL for n in e}
    out["short_loop_limit"] = lim
    if any(not e[n] <= lim[n] for n in e):
        fail(f"{tag0} f32, {SHORT_LOOP} subcycles: kernel and plain "
             f"version disagree, {e} > {lim} (the plain "
             f"loop's one-ulp response "
             f"{out['short_loop_rel_err_f32_plain_one_ulp']})")

    k32 = kernel(*a[torch.float32], **kw)
    p32 = plain(*a[torch.float32], **kw)
    k64 = kernel(*a[torch.float64], **kw)
    p64 = plain(*a[torch.float64], **kw)
    torch.cuda.synchronize()
    for got in (k32, k64):
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"{tag0}: non-finite output")
    e64, ek, ep = errs(k64, p64), errs(k32, p64), errs(p32, p64)
    out["max_rel_err_f64"] = max(e64.values())
    out["loop_rel_err_f64"] = e64
    out["loop_rel_err_f32_kernel_vs_f64_plain"] = ek
    out["loop_rel_err_f32_plain_vs_f64_plain"] = ep
    out["loop_rel_err_f32_kernel_vs_f32_plain"] = errs(k32, p32)
    # the plain loop's own response to a one-ulp perturbation of its state
    ulp, at = 1.0 + 2.0 ** -52, spec["state_at"]
    pert = list(a[torch.float64])
    pert[at:at + 5] = [x * ulp for x in pert[at:at + 5]]
    e_ulp = errs(plain(*pert, **kw), p64)
    out["loop_rel_err_f64_plain_one_ulp"] = e_ulp
    limit64 = max(1e-7, 10.0 * max(e_ulp.values()))
    out["loop_rel_err_f64_limit"] = limit64
    if not max(e64.values()) <= limit64:
        fail(f"{tag0} f64, whole loop: kernel and plain version disagree, "
             f"{e64} > {limit64}")
    # the f32 plain loop from its state one f32 ulp larger, and moved one
    # ulp up or down at random (two seeded draws)
    g = torch.Generator(device="cuda")
    draws = []
    for seed in (None, 0, 1):
        d = list(a[torch.float32])
        if seed is not None:
            g.manual_seed(seed)
        d[at:at + 5] = [x * (1.0 + 2.0 ** -23 * (1 if seed is None else (
            torch.randint(0, 2, x.shape, generator=g, device=x.device)
            * 2 - 1).to(x.dtype))) for x in d[at:at + 5]]
        draws.append(d)
    r32 = [errs(plain(*d, **kw), p32) for d in draws]
    resp32 = {n: max(r[n] for r in r32) for n in names}
    lim32 = {n: max(2.0 * ep[n] + 1e-5, 10.0 * resp32[n]) for n in names}
    out["loop_rel_err_f32_plain_one_ulp"] = resp32
    out["loop_rel_err_f32_limit"] = lim32
    for n in names:
        if not ek[n] <= lim32[n]:
            fail(f"{tag0} f32, whole loop, {n}: kernel is {ek[n]} from the "
                 f"f64 plain version > {lim32[n]} (the f32 plain version "
                 f"{ep[n]}, its one-ulp response {resp32[n]})")

    shapes, (byts, flops) = spec["work"](a[torch.float32], kw)
    t_b, t_f = byts / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_F32
    out["bound_ms"] = 1e3 * max(t_b, t_f)
    out["bound_by"] = "bytes" if t_b >= t_f else "operations"
    out["bytes"], out["flops"] = byts, flops
    out["shapes"] = dict(shapes, n_subcycles=kw["n_subcycles"])
    a32 = a[torch.float32]
    out["ms"] = time_ms(lambda: kernel(*a32, **kw), reps)
    out["plain_ms"] = time_ms(lambda: plain(*a32, **kw), max(2, reps // 3))
    out["ms_f64"] = time_ms(lambda: kernel(*a[torch.float64], **kw), reps)
    n0 = (kernel.launches, kernel.inner_launches)
    kernel(*a32, **kw)
    out["inner_launches_per_call"] = (
        (kernel.inner_launches - n0[1]) / (kernel.launches - n0[0]))
    if out["inner_launches_per_call"] != 1:
        fail(f"{tag0}: {out['inner_launches_per_call']} kernel launches per "
             "call, not one")
    out["launch_f32"] = kernel.last_launch
    kernel(*a[torch.float64], **kw)
    out["launch_f64"] = kernel.last_launch
    c_call = {"evp_panel_loop": k3_c_call, "evp_raster_loop": k4_c_call,
              "evp_subcycle_loop": k1_c_call}[name]
    out["kernel_ms"] = time_ms(c_call(a32, kw), reps)
    out["kernel_ms_f64"] = time_ms(c_call(a[torch.float64], kw), reps)
    return out


def k1_c_call(args, kw):
    """The C call of K1 alone (its loop state, checks and scratch fixed
    beforehand by `evp_subcycle_prepare`; each call carries the loop
    further)."""
    from seaice_tpu_torch.dynamics import cuda_unstructured as K1
    loop = K1.evp_subcycle_prepare(*args, **{
        k: v for k, v in kw.items() if k != "n_subcycles"})
    c_call = K1.loop_call(loop, kw["n_subcycles"])

    def call():
        if c_call() != 0:
            fail("K1: the C call returned an error")
    return call


def k1_against_k6(call, reps):
    """K1's whole loop against N_SUBCYCLES calls of K6's entry on the same
    mesh as ONE block, float32 and float64, on the inputs K1 was handed: the
    two share every sum's order, so they differ only where the compiler
    contracts a multiply-add differently (bitwise on the host,
    `tests/test_torch_cuda_sources_on_host.py`).  Not a gate: the distance
    is printed; `check_loop` holds K1 to its plain version."""
    from seaice_tpu_torch.dynamics import cuda_unstructured as K
    args, kw = call
    names = ("u", "v", "s11", "s22", "s12")
    kw6 = {k: v for k, v in kw.items() if k != "n_subcycles"}
    out = {"n_subcycles": kw["n_subcycles"]}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        a = cast(args, dtype)
        k1 = K.evp_subcycle_loop(*a, **kw)
        loop = K.evp_subcycle_prepare(*a, **kw6)
        for _ in range(kw["n_subcycles"]):
            K.evp_subcycle_step(loop)
        k6 = K.evp_subcycle_finish(loop)
        torch.cuda.synchronize()
        out["max_rel_err_" + tag] = max(
            rel_err(x.double(), y.double()) for x, y in zip(k1, k6))
        out["bitwise_" + tag] = all(torch.equal(x, y) for x, y in zip(k1, k6))
        out["rel_err_by_field_" + tag] = {
            n: rel_err(x.double(), y.double()) for n, x, y in zip(names, k1, k6)}
    a32 = cast(args, torch.float32)
    loop = K.evp_subcycle_prepare(*a32, **kw6)

    def k6_loop():
        for _ in range(kw["n_subcycles"]):
            K.evp_subcycle_step(loop)
    # in turns: K1's call, K6's per-subcycle loop, K6, K1
    k1c = k1_c_call(a32, kw)
    t = [time_ms(k1c, reps), time_ms(k6_loop, reps), time_ms(k6_loop, reps),
         time_ms(k1c, reps)]
    out["k1_kernel_ms"], out["k6_loop_ms"] = [t[0], t[3]], [t[1], t[2]]
    emit({"k1_against_k6_one_block": out})
    return out


def k4_c_call(args, kw):
    """The C call of K4 alone (checks, copies and scratch made beforehand
    by the wrapper's `_bind`; each call carries the copies further)."""
    from seaice_tpu_torch.dynamics.cuda_raster import _bind
    c_call, _ = _bind(*args, **kw)

    def call():
        if c_call()[0] != 0:
            fail("K4: the C call returned an error")
    return call


def k3_phase_cycles(args, kw):
    """K3 once with its phase timer on: SM cycles per subcycle in each
    block's cell work, wait at the first barrier, vertex work and wait at
    the second, as the mean, least and largest over the blocks."""
    from seaice_tpu_torch.dynamics.cuda_panel_fused import (_bind,
                                                            evp_panel_loop)
    evp_panel_loop(*args, **kw)
    grid = evp_panel_loop.last_launch["grid"]
    timer = torch.zeros((grid, 4), dtype=torch.int64, device="cuda")
    call, _ = _bind(*args, **kw, phase_timer=timer)
    if call()[0] != 0:
        fail("K3 with its phase timer: the C call returned an error")
    torch.cuda.synchronize()
    per = timer.double() / kw["n_subcycles"]
    return {name: {"mean": float(per[:, i].mean()),
                   "min": float(per[:, i].min()),
                   "max": float(per[:, i].max())}
            for i, name in enumerate(("cell_work", "cell_barrier",
                                      "vertex_work", "vertex_barrier"))}


def k3_c_call(args, kw):
    """The C call of K3 alone (checks and outputs made beforehand by the
    wrapper's `_bind`), for CUDA events around the kernel."""
    from seaice_tpu_torch.dynamics.cuda_panel_fused import _bind
    c_call, _ = _bind(*args, **kw)

    def call():
        if c_call()[0] != 0:
            fail("K3: the C call returned an error")
    return call


def check_k5(call, reps):
    """K5, one launch: the cell side of one subcycle against its plain
    version, through the loop form the route uses (`panel_cell_prepare`,
    the planes written into `loop.planes`, `panel_cell_step`).

    float64: held to TOL.  float32: where the strain rate is small against
    its own terms the stress update divides by a difference of nearly
    equal numbers, so how far two float32 evaluations of the same formula
    lie apart depends on the state (measured on an H100 at these shapes:
    3e-6 of the largest stress on the second step from rest, 3e-5 four
    steps later).  So, as for the whole loops, the float32 kernel's
    distance to the float64 plain version is held to twice the float32
    plain version's own distance to it, and the float32 pair itself to
    SHORT_LOOP_TOL.  `max_abs_err` and `max_rel_err_f32` are those of the
    float32 pair.  Times: the wrapper (`ms`, one call; `ms_per_call_in_a_run`,
    20 back to back), the C call alone (`kernel_ms`, 20 back to back), the
    plain version; the CUDA kernels per wrapper call (torch.profiler; more
    than 1 fails); the kernel's registers and spills (ptxas)."""
    from seaice_tpu_torch.dynamics.cuda_panel import (
        panel_cell_plain, panel_cell_prepare, panel_cell_step,
        panel_cell_work)
    from seaice_tpu_torch.dynamics.variational_panel import panel_n_of
    args, kw = call
    out = {"name": "panel_cell_step", "route": "cuda",
           "source": "seaice_tpu_torch/csrc/evp_panel_cell.cu",
           "replaces": "seaice_tpu/dynamics/pallas_panel.py:175",
           "library_ms": None}
    names = ("t11", "t22", "t12", "partials")

    def kernel(a):
        pt, planes, t11, t22, t12, pressure, ss_mask = a
        loop = panel_cell_prepare(pt, pressure, ss_mask, t11, t22, t12, **kw)
        loop.planes.copy_(planes)
        panel_cell_step(loop)
        return loop.current + (loop.partials,), loop

    a32, a64 = cast(args, torch.float32), cast(args, torch.float64)
    (k32, loop32), p32 = kernel(a32), panel_cell_plain(*a32, **kw)
    (k64, _), p64 = kernel(a64), panel_cell_plain(*a64, **kw)
    torch.cuda.synchronize()
    for got, want in ((k32, p32), (k64, p64)):
        if any(g.shape != w.shape for g, w in zip(got, want)):
            fail("K5: result shapes differ")
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail("K5: non-finite output")

    def errs(x, y):
        return {n: rel_err(g.double(), w.double())
                for n, g, w in zip(names, x, y)}

    e64, e32 = errs(k64, p64), errs(k32, p32)
    ek, ep = errs(k32, p64), errs(p32, p64)
    out["max_rel_err_f64"] = max(e64.values())
    out["rel_err_by_field_f64"] = e64
    out["max_rel_err_f32"] = max(e32.values())
    out["rel_err_by_field_f32"] = e32
    out["rel_err_f32_kernel_vs_f64_plain"] = ek
    out["rel_err_f32_plain_vs_f64_plain"] = ep
    out["max_abs_err"] = max(float((g - w).abs().max())
                             for g, w in zip(k32, p32))
    if not max(e64.values()) <= TOL[torch.float64]:
        fail(f"K5 f64: kernel and plain version disagree, {e64}")
    if not max(e32.values()) <= SHORT_LOOP_TOL:
        fail(f"K5 f32: kernel and plain version disagree, {e32} > "
             f"{SHORT_LOOP_TOL}")
    for n in names:
        if not ek[n] <= 2.0 * ep[n] + 1e-6:
            fail(f"K5 f32, {n}: kernel is {ek[n]} from the f64 plain "
                 f"version, the f32 plain version {ep[n]}")
    N = panel_n_of(a32[0])
    byts, flops = panel_cell_work(N, kw["include_metric"], 4)
    t_b, t_f = byts / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_F32
    out["bound_ms"] = 1e3 * max(t_b, t_f)
    out["bound_by"] = "bytes" if t_b >= t_f else "operations"
    out["bytes"], out["flops"] = byts, flops
    out["shapes"] = {"N": N, "npc": 10 * (N + 1) ** 2 + 2,
                     "planes": list(a32[1].shape)}
    out["ms"] = time_ms(lambda: panel_cell_step(loop32), reps)
    out["ms_per_call_in_a_run"] = time_ms_per_call(
        lambda: panel_cell_step(loop32), reps)
    c_call = loop32.calls[0]

    def alone():
        if c_call() != 0:
            fail("K5: the C call returned an error")
    out["kernel_ms"] = time_ms_per_call(alone, reps)
    out["plain_ms"] = time_ms(lambda: panel_cell_plain(*a32, **kw), reps)
    per_call, dev_ms = device_profile(lambda: panel_cell_step(loop32))
    out["device_kernels_per_call"] = per_call
    out["device_ms_by_kernel"] = dev_ms
    out["ptxas"] = ptxas_of("evp_panel_cell", "panel_cell_kernel")
    if per_call > 1:
        fail(f"K5: {per_call} CUDA kernels per panel_cell_step call, "
             "more than 1")
    return out


def k3_against_k1(call, dyn, reps, limit64):
    """Two kernels, one function: K1 (any connectivity, index gathers) on
    the very inputs K3 was handed on the panel mesh.  Times of both in
    float32, and the distance of their results in float64: after one
    subcycle held to TOL, after the whole loop to `limit64`, the limit
    `check_loop` found for K3 against its plain version on this state."""
    from seaice_tpu_torch.dynamics.cuda_panel_fused import evp_panel_loop
    from seaice_tpu_torch.dynamics.cuda_unstructured import evp_subcycle_loop
    args, kw = call
    names = ("u", "v", "s11", "s22", "s12")
    a32, a64 = cast(args, torch.float32), cast(args, torch.float64)
    ft32, ft64 = cast(dyn.fast, torch.float32), cast(dyn.fast, torch.float64)
    k3 = evp_panel_loop(*a64, **kw)
    k1 = evp_subcycle_loop(ft64, *a64[1:], **kw)
    torch.cuda.synchronize()
    e = {n: rel_err(g, w) for n, g, w in zip(names, k3, k1)}
    kw1 = dict(kw, n_subcycles=1)
    e1 = {n: rel_err(g, w) for n, g, w in zip(
        names, evp_panel_loop(*a64, **kw1),
        evp_subcycle_loop(ft64, *a64[1:], **kw1))}
    # in turns: K1, K3, K3, K1
    t = [time_ms(lambda: evp_subcycle_loop(ft32, *a32[1:], **kw), reps),
         time_ms(lambda: evp_panel_loop(*a32, **kw), reps),
         time_ms(lambda: evp_panel_loop(*a32, **kw), reps),
         time_ms(lambda: evp_subcycle_loop(ft32, *a32[1:], **kw), reps)]
    # the kernels alone, in turns: K1's C call, K3's
    k1_call = k1_c_call((ft32,) + tuple(a32[1:]), kw)
    k3_call = k3_c_call(a32, kw)
    tk = [time_ms(k1_call, reps), time_ms(k3_call, reps),
          time_ms(k3_call, reps), time_ms(k1_call, reps)]
    sweep = {n: time_ms(k3_c_call(a32, dict(kw, n_subcycles=n)), reps)
             for n in (0, 1, 10, 60, 120)}
    phases = k3_phase_cycles(a32, kw)
    out = {"mesh": "panel-reordered icos", "n_subcycles": kw["n_subcycles"],
           "k1_ms": [t[0], t[3]], "k3_ms": [t[1], t[2]],
           "k3_over_k1": (t[1] + t[2]) / (t[0] + t[3]),
           "k1_kernel_ms": [tk[0], tk[3]], "k3_kernel_ms": [tk[1], tk[2]],
           "k3_kernel_ms_by_n_subcycles": sweep,
           "k3_kernel_us_per_subcycle": 1e3 * (sweep[120] - sweep[10]) / 110,
           "k3_phase_cycles_per_subcycle": phases,
           "whole_loop_limit": limit64,
           "rel_diff_f64_one_subcycle": e1, "rel_diff_f64_whole_loop": e}
    emit({"k3_against_k1": out})
    if not max(e1.values()) <= 1e-10:
        fail(f"K3 and K1 disagree after one subcycle in f64: {e1}")
    if not max(e.values()) <= limit64:
        fail(f"K3 and K1 disagree after the loop in f64: {e} > {limit64}")
    return out


def k3_at_qu60_scale(reps, subdiv=SUBDIV + 1):
    """K3 on the subdivision-7 panel sphere (N = 128, the benchmark's QU60
    mesh), where a block owns more columns than threads and its columns'
    basis no longer fits in shared memory: held to its plain version as at
    subdivision 6 (`check_loop`: one subcycle f32 and f64, 10 subcycles
    f32, the whole f64 loop, the same limits) on the inputs of the model's
    second step.  `launch_f32` / `launch_f64` say where the loop state
    lived (`cuda_panel_fused.launch_shape`: the shares of columns whose
    basis is resident, streamed or read in place, whose stresses stay on
    chip, and the basis bytes streamed a subcycle)."""
    t0 = time.perf_counter()
    model, state, forcing = build_model(
        subdiv, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, torch.float32, None,
        panel=True)
    state, _ = stepper(model)(state, forcing)
    state, calls = capture_kernel_inputs(model, state, forcing)
    if set(calls) != {"evp_panel_loop", "integrate_fluxes_cuda"}:
        fail(f"panel sphere, subdiv {subdiv}: the step called "
             f"{sorted(calls)}")
    out = check_loop("evp_panel_loop", calls["evp_panel_loop"][0], reps)
    out["subdiv"] = subdiv
    out["seconds"] = time.perf_counter() - t0
    emit({"k3_qu60": out})
    del model, state, forcing, calls
    torch.cuda.empty_cache()
    return out


# the plain flux integration's gather and products on one chunk of edges
# (bytes): a wider table is evaluated over the edges chunk by chunk
PLAIN_FLUX_CHUNK_BYTES = 4e9


def plain_flux_chunks(args):
    """The edge chunks `plain_fluxes` evaluates `remap.integrate_fluxes`
    over: one where the plain version's gathered table [nE S, ~2 x 3W]
    and its layered products [nE S, 6 T3] of all edges fit in
    PLAIN_FLUX_CHUNK_BYTES, else as many equal chunks as that budget
    asks; every edge is covered."""
    from seaice_tpu_torch.transport.cuda_flux import flux_layout
    tree, recon, _rt, cell = args[:4]
    _, out2d, out3d = flux_layout(tree, recon)
    t2 = sum(n for _, n, _ in out2d)
    t3 = sum(n * nl for _, n, nl, _ in out3d)
    n_e, n_s = cell.shape
    per_edge = n_s * (6 * (t2 + t3) + 6 * t3) * args[4].element_size()
    n = max(1, int(np.ceil(n_e * per_edge / PLAIN_FLUX_CHUNK_BYTES)))
    bounds = np.linspace(0, n_e, n + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def plain_fluxes(args, kw):
    """`remap.integrate_fluxes` on every edge of these inputs, evaluated
    over the edge chunks of `plain_flux_chunks` (the edges are
    independent: the same arithmetic per edge as one call)."""
    from seaice_tpu_torch.transport.remap import integrate_fluxes
    tree, recon, rt, cell, xq, yq, area, mask_edge = args
    chunks = plain_flux_chunks(args)
    if len(chunks) == 1:
        return integrate_fluxes(*args, **kw)
    parts = [integrate_fluxes(tree, recon, rt, cell[a:b], xq[a:b],
                              yq[a:b], area[a:b], mask_edge[a:b], **kw)
             for a, b in chunks]
    return {n: torch.cat([p[n] for p in parts]) for n in parts[0]}


def k2_against_plain(call):
    """K2 on one captured call against `remap.integrate_fluxes` on the same
    tensors (over edge chunks where its table is wide, `plain_fluxes`),
    float32 and float64, each field held to TOL of its max.  Returns
    {tag: (max rel err, rel err by field, max abs err, the card's peak
    memory (MB) around the plain version, its edge chunks)}."""
    from seaice_tpu_torch.transport.cuda_flux import integrate_fluxes_cuda
    args, kw = call
    res = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        a = cast(args, dtype)
        got = integrate_fluxes_cuda(*a, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = plain_fluxes(a, kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        if set(got) != set(want) or any(
                got[n].shape != want[n].shape for n in want):
            fail("K2 " + tag + ": result names or shapes differ")
        if not all(bool(torch.isfinite(g).all()) for g in got.values()):
            fail("K2 " + tag + ": non-finite output")
        errs = {n: rel_err(got[n], want[n]) for n in want}
        err = max(errs.values())
        if not err <= TOL[dtype]:
            fail(f"K2 {tag}: kernel and plain version disagree, "
                 f"{errs} > {TOL[dtype]}")
        res[tag] = (err, errs, max(float((got[n] - want[n]).abs().max())
                                   for n in want), peak,
                    len(plain_flux_chunks(a)))
        del got, want
        torch.cuda.empty_cache()
    return res


def k2_on_path(label, calls):
    """K2 against its plain version on every captured call of a path."""
    rows = [k2_against_plain(call) for call in calls]
    emit({"k2_against_plain": {
        "path": label, "calls": len(rows),
        "max_rel_err_f32": max(r["f32"][0] for r in rows),
        "max_rel_err_f64": max(r["f64"][0] for r in rows)}})


def check_k2(call, reps):
    """K2 against its plain version (`k2_against_plain`), its bound, and
    its times: the wrapper's and the plain version's by CUDA events, the
    C call alone (`kernel_ms`), and the CUDA kernels per wrapper call by
    torch.profiler (more than 3 fails)."""
    from seaice_tpu_torch.transport.cuda_flux import (flux_work,
                                                      integrate_fluxes_cuda)
    from seaice_tpu_torch.transport.remap import integrate_fluxes
    out = {"name": "integrate_fluxes_cuda", "route": "cuda",
           "source": "seaice_tpu_torch/csrc/ir_flux.cu",
           "replaces": "seaice_tpu/transport/pallas_flux.py:263",
           "library_ms": None}
    res = k2_against_plain(call)
    for tag, (err, errs, _, peak, chunks) in res.items():
        out["max_rel_err_" + tag] = err
        out["rel_err_by_field_" + tag] = errs
        out["plain_peak_mem_mb_" + tag] = peak
        out["plain_edge_chunks_" + tag] = chunks
    out["max_abs_err"] = res["f32"][2]
    a, kw = cast(call[0], torch.float32), call[1]
    tree, recon, _rt, cell, _xq, _yq, area, mask_edge = a
    byts, flops, n_active = flux_work(tree, recon, cell, area, mask_edge, 4)
    t_b, t_f = byts / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_F32
    out["bound_ms"] = 1e3 * max(t_b, t_f)
    out["bound_by"] = "bytes" if t_b >= t_f else "operations"
    out["bytes"], out["flops"] = byts, flops
    n_e, n_s = cell.shape
    out["shapes"] = {"nE": n_e, "S": n_s, "active_slots": n_active,
                     "unmasked_edges": int((mask_edge != 0).sum())}
    out["ms"] = time_ms(lambda: integrate_fluxes_cuda(*a, **kw), reps)
    out["plain_ms"] = time_ms(lambda: plain_fluxes(a, kw), reps)
    out["kernel_ms"] = time_ms(k2_c_call(a), reps)
    per_call, dev_ms = device_profile(lambda: integrate_fluxes_cuda(*a, **kw))
    out["device_kernels_per_call"] = per_call
    out["device_ms_by_kernel"] = dev_ms
    if per_call > 3:
        fail(f"K2: {per_call} CUDA kernels per integrate_fluxes_cuda call, "
             "more than 3")
    return out


def k2_c_call(args):
    """The C call of K2 alone on these inputs (its table and outputs made
    beforehand by the wrapper's `_bind`), for CUDA events around the
    kernel without the wrapper."""
    from seaice_tpu_torch.transport.cuda_flux import _bind
    c_call, _ = _bind(*args)

    def call():
        if c_call() != 0:
            fail("K2: the C call returned an error")
    return call


def sharded_loops(model, calls, dtype, inputs_up=False):
    """K6's loops of every block, begun from the step's captured
    `evp_subcycle_prepare` calls cast to dtype (with inputs_up, their
    inputs after the loop state one ulp larger, `inputs_one_ulp`)."""
    from seaice_tpu_torch.dynamics.cuda_unstructured import (
        evp_subcycle_prepare)
    return [evp_subcycle_prepare(*(inputs_one_ulp(cast(a, dtype), 6)
                                   if inputs_up else cast(a, dtype)), **kw)
            for a, kw in calls]


def plain_steps(*loops):
    """The batched K6 call's plain version: `evp_subcycle_step_plain`
    block after block."""
    from seaice_tpu_torch.dynamics.cuda_unstructured import (
        evp_subcycle_step_plain)
    for lp in loops:
        evp_subcycle_step_plain(lp)


def run_sharded_loops(model, loops, step, n):
    """n subcycles of every block's loop, step(*loops) for all blocks, the
    vertex halo exchanged after each, as the sharded step does; returns
    every block's state."""
    from seaice_tpu_torch.dynamics.cuda_unstructured import (
        evp_subcycle_finish)
    for _ in range(n):
        step(*loops)
        model.exchange("vertex_uv", [(lp.u, lp.v) for lp in loops])
    return [evp_subcycle_finish(lp) for lp in loops]


def check_k6(model, calls, reps, short_loop_from_response=False):
    """K6, the one-subcycle EVP kernel, on the captured inputs of every
    block of the sharded sphere: one call advances all the blocks.

    One call on all blocks against `evp_subcycle_step_plain` block by
    block on the same tensors, float32 and float64: held to TOL.
    SHORT_LOOP subcycles of all blocks with the exchange after each,
    float32 kernel against float32 plain: SHORT_LOOP_TOL, or with
    short_loop_from_response (the sharded full-physics step, whose
    Rothrock strength amplifies rounding more), the larger of it and ten
    times the float32 plain loop's response to its state or its inputs
    one ulp larger (ROADMAP Queue 3, fault 2).  The whole loop
    (N_SUBCYCLES) with exchanges in float64: the larger of 1e-7 and ten
    times the plain loop's response to a one-ulp perturbation of every
    block's u, v and stresses (ROADMAP Queue 3, fault 4).  Distances are
    relative to each field's max |value| over the blocks.  Times per call
    (all blocks): the wrapper (`ms`, over runs of N_SUBCYCLES calls), the C
    call alone (`kernel_ms`), the plain version, the host time
    (`host_us_per_call`), the CUDA kernels per call (torch.profiler)."""
    from seaice_tpu_torch.dynamics.cuda_unstructured import (
        evp_loop_work, evp_subcycle_finish, evp_subcycle_share_uv,
        evp_subcycle_step)
    names = ("u", "v", "s11", "s22", "s12")
    out = {"name": "evp_subcycle_step", "route": "cuda",
           "source": "seaice_tpu_torch/csrc/evp_unstructured.cu",
           "replaces": "seaice_tpu/dynamics/pallas_unstructured.py:395",
           "library_ms": None}

    def errs(x, y):
        return {n: max(float((a[i].double() - b[i].double()).abs().max())
                       for a, b in zip(x, y)) /
                max(max(float(b[i].double().abs().max()) for b in y), 1e-300)
                for i, n in enumerate(names)}

    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        k, p = (sharded_loops(model, calls, dtype) for _ in range(2))
        evp_subcycle_step(*k)
        plain_steps(*p)
        torch.cuda.synchronize()
        got = [evp_subcycle_finish(lp) for lp in k]
        want = [evp_subcycle_finish(lp) for lp in p]
        e = errs(got, want)
        out["one_call_rel_err_" + tag] = e
        if dtype == torch.float32:
            out["max_abs_err"] = max(float((a - b).abs().max())
                                     for g, w in zip(got, want)
                                     for a, b in zip(g, w))
            out["max_rel_err_f32"] = max(e.values())
        if not max(e.values()) <= TOL[dtype]:
            fail(f"K6 {tag}, one call on {len(calls)} blocks: kernel and "
                 f"plain version disagree, {e} > {TOL[dtype]}")

    def run(dtype, step, n, scale=None, inputs_up=False):
        loops = sharded_loops(model, calls, dtype, inputs_up)
        if scale is not None:
            for lp in loops:
                for t in evp_subcycle_finish(lp):
                    t.mul_(scale)
        return run_sharded_loops(model, loops, step, n)

    p32 = run(torch.float32, plain_steps, SHORT_LOOP)
    e = errs(run(torch.float32, evp_subcycle_step, SHORT_LOOP), p32)
    out["short_loop_subcycles"] = SHORT_LOOP
    out["short_loop_rel_err_f32"] = e
    # the f32 plain loop's own response to one f32 ulp of its state and
    # of its inputs
    resp = {"state": errs(run(torch.float32, plain_steps, SHORT_LOOP,
                              1.0 + 2.0 ** -23), p32),
            "inputs": errs(run(torch.float32, plain_steps, SHORT_LOOP,
                               inputs_up=True), p32)}
    out["short_loop_rel_err_f32_plain_one_ulp"] = resp["state"]
    out["short_loop_rel_err_f32_plain_inputs_one_ulp"] = resp["inputs"]
    lim = {n: max(SHORT_LOOP_TOL, 10.0 * max(r[n] for r in resp.values()))
           if short_loop_from_response else SHORT_LOOP_TOL for n in names}
    out["short_loop_limit"] = lim
    if any(not e[n] <= lim[n] for n in names):
        fail(f"K6 f32, {SHORT_LOOP} subcycles with exchanges: kernel and "
             f"plain version disagree, {e} > {lim} (the plain loop's "
             f"one-ulp responses {resp})")
    k64 = run(torch.float64, evp_subcycle_step, N_SUBCYCLES)
    p64 = run(torch.float64, plain_steps, N_SUBCYCLES)
    pu = run(torch.float64, plain_steps, N_SUBCYCLES, 1.0 + 2.0 ** -52)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for b in k64 for t in b):
        fail("K6: non-finite output")
    e64, e_ulp = errs(k64, p64), errs(pu, p64)
    limit64 = max(1e-7, 10.0 * max(e_ulp.values()))
    out["max_rel_err_f64"] = max(e64.values())
    out["loop_rel_err_f64"] = e64
    out["loop_rel_err_f64_plain_one_ulp"] = e_ulp
    out["loop_rel_err_f64_limit"] = limit64
    if not max(e64.values()) <= limit64:
        fail(f"K6 f64, {N_SUBCYCLES} subcycles with exchanges: kernel and "
             f"plain version disagree, {e64} > {limit64}")

    # the bound of one call: every block's inputs read and outputs written
    byts = flops = 0
    blocks = []
    for args, kw in calls:
        ft = args[0]
        me, nc = ft.voc_T.shape
        vd, nv = ft.flat_corner_idx.shape
        b, f = evp_loop_work(nc, nv, me, vd, 1, kw["include_metric"], 4)
        byts, flops = byts + b, flops + f
        blocks.append({"nc": nc, "nv": nv, "me": me, "vd": vd})
    t_b, t_f = byts / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_F32
    out["bound_ms"] = 1e3 * max(t_b, t_f)
    out["bound_by"] = "bytes" if t_b >= t_f else "operations"
    out["bytes"], out["flops"] = byts, flops
    out["shapes"] = {"blocks": blocks, "n_subcycles": 1}
    # per call (all blocks), over runs of N_SUBCYCLES calls
    k = sharded_loops(model, calls, torch.float32)
    p = sharded_loops(model, calls, torch.float32)

    def calls_of(step, loops):
        def run_n():
            for _ in range(N_SUBCYCLES):
                step(*loops)
        return run_n

    out["ms"] = time_ms(calls_of(evp_subcycle_step, k), reps) / N_SUBCYCLES
    out["plain_ms"] = time_ms(calls_of(plain_steps, p),
                              max(2, reps // 3)) / N_SUBCYCLES
    c_call, count = k[0].blocks.call, k[0].blocks.count

    def alone():
        if c_call() != 0 or count.value != 2:
            fail("K6: the C call returned an error")
    out["kernel_ms"] = time_ms_per_call(alone, reps, N_SUBCYCLES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls_of(evp_subcycle_step, k)()
    out["host_us_per_call"] = 1e6 * (time.perf_counter() - t0) / N_SUBCYCLES
    torch.cuda.synchronize()
    per_call, dev_ms = device_profile(lambda: evp_subcycle_step(*k))
    out["device_kernels_per_call"] = per_call
    out["device_ms_by_kernel"] = dev_ms
    if per_call > 2:
        fail(f"K6: {per_call} CUDA kernels per call, more than 2")
    # the exchange alone, per subcycle: block by block, and as the step
    # makes it, on the loops' shared velocity buffer
    fields = [(lp.u, lp.v) for lp in k]
    out["exchange_ms_per_subcycle_by_block"] = time_ms(
        lambda: model.exchange("vertex_uv", fields), reps)
    solve = {"loops": tuple(k), "uv": evp_subcycle_share_uv(k)}
    fields = [(lp.u, lp.v) for lp in k]
    out["exchange_ms_per_subcycle"] = time_ms(
        lambda: model.exchange("vertex_uv", fields, solve=solve), reps)
    return out


def sharded_against_unsharded(smodel, sstate, sforcing, model, state,
                              forcing, reps):
    """The sharded step against the unsharded one (K1) from the same
    initial state and forcing, two steps: torch.equal and the largest
    relative distance of u, v and every tracer after each, held to the
    larger of 1e-7 and ten times the unsharded second step's response to
    a one-ulp (float32) perturbation of its velocities and stresses.  Then
    ms per step of both, in turns.  The second sharded step is recorded
    (`capture_kernel_inputs`), so that K6 is checked on the step where K1
    is.  Returns the sharded state after two steps, that record and the
    largest relative distance."""
    sstep, step = stepper(smodel), stepper(model)
    rows, states = [], []
    for i in range(2):
        states.append(state)
        if i == 0:
            sstate, _ = sstep(sstate, sforcing)
        else:
            sstate, calls = capture_kernel_inputs(smodel, sstate, sforcing)
        state, _ = step(state, forcing)
        torch.cuda.synchronize()
        got, want = global_fields(smodel, sstate), global_fields(model, state)
        rows.append({k: {"equal": bool(np.array_equal(got[k], want[k])),
                         "rel_diff": float(np.abs(got[k] - want[k]).max()) /
                         max(float(np.abs(want[k]).max()), 1e-300)}
                     for k in want})
    ulp = 1.0 + 2.0 ** -23
    vel = states[1].velocity
    pert = states[1].replace(velocity=vel.replace(**{
        k: getattr(vel, k) * ulp for k in (
            "u_velocity", "v_velocity", "stress11", "stress22", "stress12")}))
    pstate, _ = step(pert, forcing)
    want, pw = global_fields(model, state), global_fields(model, pstate)
    resp = {k: float(np.abs(pw[k] - want[k]).max()) /
            max(float(np.abs(want[k]).max()), 1e-300) for k in want}
    limit = max(1e-7, 10.0 * max(resp.values()))
    worst = max(r["rel_diff"] for row in rows for r in row.values())
    t = [time_ms(lambda: step(state, forcing), reps),
         time_ms(lambda: sstep(sstate, sforcing), reps),
         time_ms(lambda: sstep(sstate, sforcing), reps),
         time_ms(lambda: step(state, forcing), reps)]
    out = {"blocks": smodel.n_shards, "dtype": str(model.dtype),
           "after_step": rows,
           "bitwise": all(r["equal"] for row in rows for r in row.values()),
           "uv_bitwise": all(row[k]["equal"] for row in rows
                             for k in ("u", "v")),
           "max_rel_diff": worst, "one_ulp_response": resp,
           "limit": limit, "unsharded_ms": [t[0], t[3]],
           "sharded_ms": [t[1], t[2]]}
    emit({"sharded_against_unsharded": out})
    if not worst <= limit:
        fail(f"sharded and unsharded steps disagree: {worst} > {limit}")
    return sstate, calls, worst


def loop_drift(model, state, forcing, n_steps=4):
    """How far float64 evaluations of the same EVP loop drift apart
    (--drift): on each of the panel sphere's first `n_steps` steps, after
    30, 60, 90 and 120 subcycles, the largest relative distance over
    u, v and the stresses between K3, K1, their plain versions, and the
    plain panel loop with its state one ulp larger.  The whole-loop limits
    of `check_loop` rest on this table."""
    from seaice_tpu_torch.dynamics.cuda_panel_fused import (
        evp_panel_loop, evp_panel_loop_plain)
    from seaice_tpu_torch.dynamics.cuda_unstructured import (
        evp_subcycle_loop, evp_subcycle_loop_plain)
    ft = cast(model.tensors.dynamics.fast, torch.float64)
    ulp = 1.0 + 2.0 ** -52

    def dist(x, y):
        return max(rel_err(a, b) for a, b in zip(x, y))

    rows = []
    for i in range(n_steps):
        state, calls = capture_kernel_inputs(model, state, forcing)
        args, kw = calls["evp_panel_loop"][0]
        a = cast(args, torch.float64)
        pert = list(a)
        pert[1:6] = [x * ulp for x in pert[1:6]]
        for n in (30, 60, 90, 120):
            kwn = dict(kw, n_subcycles=n)
            k3, p3 = evp_panel_loop(*a, **kwn), evp_panel_loop_plain(*a, **kwn)
            k1 = evp_subcycle_loop(ft, *a[1:], **kwn)
            p1 = evp_subcycle_loop_plain(ft, *a[1:], **kwn)
            pu = evp_panel_loop_plain(*pert, **kwn)
            torch.cuda.synchronize()
            rows.append({"step": i + 1, "n_subcycles": n,
                         "k3_vs_plain": dist(k3, p3),
                         "k1_vs_plain": dist(k1, p1),
                         "k3_vs_k1": dist(k3, k1),
                         "plain_panel_vs_plain_unstructured": dist(p3, p1),
                         "plain_vs_plain_one_ulp": dist(pu, p3)})
    emit({"loop_drift_f64": rows})


def conserved_sums(model, state):
    """Global tracer-product sums over the whole mesh (a sharded model's
    blocks gathered by owner), accumulated in float64."""
    from seaice_tpu_torch.transport.remap import global_conserved_sums
    if hasattr(model, "halo"):
        tr = {k: torch.as_tensor(a).cuda().double()
              for k, a in model.gather_tracers(state).items()}
        area = torch.as_tensor(model.global_mesh.area_cell).to(
            model.dtype).cuda().double()
    else:
        tr = {k: v.double() for k, v in state.tracers.items()}
        area = model.tensors.area_cell.double()
    sums = global_conserved_sums(model.tree, tr, area)
    return {k: float(v) for k, v in sums.items()}


def main_path(label, model, state, forcing, n_steps, expect):
    """Drive one path: counts to 0, n_steps steps, read the counts, check
    the state.  `expect` maps each kernel of the path to its launches per
    step; every other kernel must stay at 0."""
    from seaice_tpu_torch.kernels import (launch_counts, reset_launch_counts,
                                          wrappers)
    step = stepper(model)
    before = conserved_sums(model, state)
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()     # the path's own peak
    ms = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, diags = step(state, forcing)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    counts = launch_counts()
    inner = {name: fn.inner_launches for name, fn in wrappers().items()
             if getattr(fn, "inner_launches", 0)}
    after = conserved_sums(model, state)
    cons = {k: abs(after[k] - before[k]) / max(abs(before[k]), 1e-30)
            for k in before}
    fields = global_fields(model, state)
    u, v = fields.pop("u"), fields.pop("v")
    max_u = float(np.sqrt(u * u + v * v).max())
    mesh = getattr(model, "global_mesh", None) or model.mesh
    nc, nv = mesh.n_cells, mesh.n_vertices
    out = {"path": label, "steps": n_steps, "ms_per_step": ms,
           "ms_per_step_median": float(np.median(ms)),
           "launches": counts, "inner_launches": inner,
           "max_speed": max_u, "conservation_rel_err": cons,
           "cells": nc, "vertices": nv, "edges": mesh.n_edges,
           "ice_area_sum": after["iceAreaCategory"],
           "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    emit({"main_path": out})
    for name, t in list(fields.items()) + [("u", u), ("v", v)]:
        if not np.isfinite(t).all():
            fail(f"{label}: {name} is not finite")
    if tuple(u.shape) != (nv,) or fields["iceAreaCategory"].shape[0] != nc:
        fail(f"{label}: state has the wrong shape")
    if not 0.0 < max_u < 3.0:
        fail(f"{label}: max |u| = {max_u} outside (0, 3) m/s")
    bad = {k: e for k, e in cons.items() if not e <= 1e-5}
    if bad:
        fail(f"{label}: tracer products not conserved: {bad}")
    for name, n in counts.items():
        want = expect.get(name, 0) * n_steps
        if n != want:
            fail(f"{label}: {name} launched {n} times in {n_steps} "
                 f"steps, expected {want}: the step did not go through "
                 "the kernels of its path")
    for name, tag in (("evp_panel_loop", "K3"), ("evp_subcycle_loop", "K1"),
                      ("evp_raster_loop", "K4")):
        if counts[name] and inner.get(name) != counts[name]:
            fail(f"{label}: {tag} made {inner.get(name)} kernel launches in "
                 f"{counts[name]} calls, not one each")
    if counts["evp_subcycle_step"] and \
            inner.get("evp_subcycle_step") != 2 * counts["evp_subcycle_step"]:
        fail(f"{label}: K6 made {inner.get('evp_subcycle_step')} kernel "
             f"launches in {counts['evp_subcycle_step']} calls, not two each")
    return state, counts, out["ms_per_step_median"]


def profile(model, state, forcing, step_ms):
    """Where a panel-sphere step's time goes (--profile): `trace_steps`,
    whose phase split comes from the program's own spans."""
    trace_steps("panel sphere", model, state, forcing, step_ms)


def trace_steps(label, model, state, forcing, step_ms, extra=None, n=2,
                col=None, advance=None, host_events=True):
    """A torch.profiler trace of n whole steps of a path: device-busy ms
    and CUDA kernels per step, the device's idle share (1 - busy over
    `step_ms`, the path's UNTRACED median ms per step of this run: tracing
    slows the host severalfold, so the traced wall time would overstate
    the idle share), the package's own kernels, the top device kernels,
    and the phase split: each of the program's spans with the device ms
    of the operations launched in it and the idle ms while the host was
    in it, a step (`benchmark/harness/spans.py`, the innermost span; each
    device operation paired with its call by the profiler's correlation
    id; where some cannot pair, the split is left out and the line says
    so, with the first of them).  extra: more numbers of the path for the
    line.  advance: a callable taking one step in place of the model's
    step (a runner's run(1)).  host_events=False records the device's events alone (no
    phase split): the idle share is the same sum, and the trace of a
    path of tens of thousands of launches is processed in a fraction of
    the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from benchmark.harness.spans import Spans
    step = stepper(model, col)
    torch.cuda.synchronize()          # nothing queued before the session
    with torch.profiler.profile(
            activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if host_events else [])) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            if advance is not None:
                advance()
            else:
                state, _ = step(state, forcing)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)) / 1e3,
             e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type)]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    # the package's own kernels: [device ms, launches] per step
    own = {}
    for key, ms, count in rows:
        for name in ("evp_loop_kernel", "raster_loop_kernel",
                     "evp_cell_blocks_kernel", "evp_vertex_blocks_kernel",
                     "panel_loop_kernel", "panel_cell_kernel",
                     "ir_flux_kernel"):
            if name + "<" in key:
                own[name] = [ms / n, count / n]
    phase = None
    if host_events:
        ops = ([], [])
        for e in prof.events():
            ops[e.device_type != DeviceType.CUDA].append(
                (e.name, e.time_range.start, e.time_range.end, e.id))
        sp = Spans(*ops)
        phase = {"launch_calls": sp.n_launches,
                 "device_ops": sp.n_device, "spans": len(sp.spans),
                 "launched_by": sorted(sp.launch_names)}
        if sp.unpaired:
            t0 = min(e[1] for e in ops[1])
            phase["not_split"] = (
                f"{len(sp.unpaired)} device operations have no call in "
                f"the trace, the first "
                f"{[[n[:60], s - t0] for n, s in sp.unpaired[:3]]} "
                f"(name, us after the trace's first host event)")
        if sp.ok:
            phase["device_ms"] = {str(k): v / 1e3 / n for k, v in
                                  sp.device_by_innermost().items()}
            phase["idle_ms"] = {str(k): v / 1e3 / n for k, v in
                                sp.idle_by_innermost().items()}
    emit({"profile": {
        "path": label, "phase_ms": phase, "traced_steps": n,
        "extra": extra,
        "wall_ms_per_step_traced": wall / n,
        "wall_ms_per_step_untraced": step_ms,
        "device_busy_ms_per_step": busy / n,
        "device_kernels_per_step": sum(r[2] for r in rows) / n,
        "device_idle_share": (1.0 - busy / n / step_ms) if busy else None,
        "device_idle_share_of_traced_wall":
            (1.0 - busy / wall) if busy else None,
        "own_kernels_ms_per_step": own,
        "top_device_kernels_ms_per_step": [
            [k[:70], ms / n, c / n] for k, ms, c in rows[:12]]}})


# -- the file-driven run and the sharded full-physics step --------------------

# the file-driven run: steps by default and with --five-day (the restart
# halfway), and the setup of `examples/run_5day_from_files.py`
FILE_STEPS, FIVE_DAY_STEPS = 48, 240
FILE_SETUP = dict(initial_condition_type="cice_default",
                  initial_latitude_north=65.0, initial_latitude_south=-65.0)
SPEED_LIMIT = 3.0
# the file-driven run's surface temperature is held to TSFC_BUDGET_K on
# the categories with at least this much ice area in both dtypes
FILE_RUN_AREA_FLOOR = 1e-3
PONDS = ("pondArea", "pondDepth", "pondLidThickness")
# the remap's conservation limit on the pond tracers while the ponds'
# water is rounding noise: 2.5 times the largest loss read on the H100
# (1.98e-2 in the five-day run; ROADMAP Queue 3, fault 7)
POND_NOISE_LIMIT = 5e-2


def mpas_fixture():
    """`tests/mpas_fixture.py` (numpy and scipy), loaded by its path."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "mpas_fixture.py")
    spec = importlib.util.spec_from_file_location("mpas_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def file_config(C=None):
    """The north-star column of `bench_full.py` (5 categories, 7+1
    layers, 120 subcycles, dt 1800 s, metric terms, mushy, dEdd, level
    ponds, Rothrock, ridging) with the remap's conservation check, built
    from the config module C (default: the port's)."""
    if C is None:
        from seaice_tpu_torch import config as C
    return C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=N_CATEGORIES,
                        n_ice_layers=N_ICE_LAYERS),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=N_SUBCYCLES, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(conservation_check=True),
        column=C.ColumnConfig(ktherm=2, shortwave="dEdd",
                              pond_scheme="lvl", kstrength=1))


def file_inputs(workdir):
    """The subdiv-SUBDIV mesh file of `tests/mpas_fixture.py` and its
    forcing files, written once into workdir, read back through the
    port's readers: (mesh, CoreAtmosForcing, NcarOceanForcing)."""
    from seaice_tpu_torch.io.synthetic import write_forcing_files
    import os
    from seaice_tpu_torch.io import read_mpas_mesh
    from seaice_tpu_torch.io.forcing_reader import (core_atmos_from_files,
                                                    ncar_ocean_from_file)
    path = os.path.join(workdir, f"mesh_icos{SUBDIV}.nc")
    t0 = time.perf_counter()
    mpas_fixture().write_icosahedral_mpas_file(path, subdiv=SUBDIV)
    t1 = time.perf_counter()
    mesh = read_mpas_mesh(path)
    six, mon, ocn = write_forcing_files(workdir, mesh)
    emit({"file_inputs": {"mesh_file_seconds": t1 - t0,
                          "read_and_forcing_seconds":
                              time.perf_counter() - t1,
                          "cells": mesh.n_cells}})
    return (mesh, core_atmos_from_files(six, mon, mesh.lon_cell,
                                        mesh.lat_cell),
            ncar_ocean_from_file(ocn))


def file_runner(inputs, dtype, state=None, device=None):
    """A StandaloneRunner of `file_config()` on the file mesh in dtype on
    the card (or `device`), from `FILE_SETUP`'s initial state or from
    `state`."""
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.run import StandaloneRunner
    mesh, atmos, ocean = inputs
    model = SeaIceModel(mesh, file_config(), dtype=dtype, device=device)
    if state is None:
        state = initial_state_from_setup(model, RunSetup(**FILE_SETUP))
    return StandaloneRunner(model, state, atmos_forcing=atmos,
                            ocean_forcing=ocean)


def runner_step(runner, label):
    """One step of a runner with the state check fetched after it;
    returns the host ms of the step."""
    from seaice_tpu_torch.error import SeaIceAbort
    t0 = time.perf_counter()
    try:
        runner.run(1, check_interval=1)
    except SeaIceAbort as e:
        fail(f"{label}: {e}")
    return 1e3 * (time.perf_counter() - t0)


class RemapSums:
    """Records the global mass-tracer sums the model takes around every
    remap for its conservation check (`model.global_conserved_sums`,
    called before and after each remap), so that the remap's
    conservation error can be read by tracer product."""

    def __enter__(self):
        from seaice_tpu_torch import model as model_mod
        self.mod, self.fn, self.sums = model_mod, \
            model_mod.global_conserved_sums, []

        def recorded(*a, **kw):
            out = self.fn(*a, **kw)
            self.sums.append(out)
            return out
        model_mod.global_conserved_sums = recorded
        return self

    def __exit__(self, *exc):
        self.mod.global_conserved_sums = self.fn

    def errors(self):
        """{product: the largest relative change of its global sum over
        the remaps recorded since the last call} (0-d tensors)."""
        pre, post = self.sums[0::2], self.sums[1::2]
        self.sums = []
        return {k: torch.stack([(b[k] - a[k]).abs() /
                                a[k].abs().clamp(min=1e-30)
                                for a, b in zip(pre, post)]).max()
                for k in pre[0]}


def hold_products(label, tr, area, sums):
    """The remap's conservation error by tracer product over the remaps
    `sums` (a RemapSums) recorded: every product to
    IR_CONSERVATION_LIMIT, but the three pond tracers, while the ponds'
    water per unit ice area is under NOISE, to POND_NOISE_LIMIT (ROADMAP
    Queue 3, fault 7: the remap's sliver repair clamps the pond depth of
    slivers to the range of the meaningful cells, which is not
    conservative; under cold forcing the ponds are rounding noise,
    fault 4); the level-ice fraction enters the pond water where the
    tree carries it.  tr: the state's tracers after the remaps, area: the
    cells' areas.  Returns {"by_product", "max_error_but_ponds",
    "ponds_max_error", "pond_water_m", "ponds_limit"}; fails when a
    product exceeds its limit."""
    a = tr["iceAreaCategory"]
    pond = a * tr.get("levelIceArea", 1.0) * tr["pondArea"]
    water = ((pond * tr["pondDepth"]).sum(-1) * area).sum() / (
        (a.sum(-1) * area).sum())
    by = sums.errors()
    vals = torch.stack([water.double()] + [e.double() for e in by.values()])
    water, *errs = vals.cpu().tolist()
    err = max(e for k, e in zip(by, errs) if k not in PONDS)
    pond = max(e for k, e in zip(by, errs) if k in PONDS)
    pond_limit = IR_CONSERVATION_LIMIT if water >= NOISE else POND_NOISE_LIMIT
    if not err <= IR_CONSERVATION_LIMIT:
        fail(f"{label}: ir_conservation_error {err} > "
             f"{IR_CONSERVATION_LIMIT} ({dict(zip(by, errs))})")
    if not pond <= pond_limit:
        fail(f"{label}: the pond tracers' conservation error "
             f"{pond} > {pond_limit} (pond water {water} m per unit ice "
             f"area)")
    return {"by_product": dict(zip(by, errs)), "max_error_but_ponds": err,
            "ponds_max_error": pond, "pond_water_m": water,
            "ponds_limit": pond_limit}


def bare_step_ms(runner, reps=3):
    """Host ms of the runner's model step alone (synchronised), on the
    runner's state with the forcing of its next step, reps times after
    one warm-up step that is not counted; the runner does not advance."""
    model, state = runner.model, runner.state
    dyn, atmf, ocnf, coszen = runner.next_step_inputs()
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.step_fn(model.tensors, state, dyn, atmf, ocnf, coszen=coszen)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out[1:]


def file_driven_run(inputs, n_steps, reps, card, workdir):
    """The file-driven full-physics run (K1 + K2, f32) through
    StandaloneRunner: step 1 from rest recorded (K1's short loop against
    its plain version, held to ten times the plain loop's one-ulp
    response: from rest the EVP loop amplifies rounding far more, ROADMAP
    Queue 3 fault 2), step 2 recorded (K1 and K2 against their plain
    versions on its inputs, `check_loop` and `k2_on_path`), then the
    path: counts to 0, steps 3 to n_steps with the state check after
    every step and a checkpoint after step n_steps / 2; a second runner
    restarted from it runs the second half, and the two final states
    must be bitwise equal; before its steps, the bare model step on the
    checkpoint's state (`bare_step_ms`, against ms per runner step), and
    its first two steps traced for the device idle share
    (`trace_steps`).  Then the same n_steps in f64, twice, the second
    rounded to f32 once after step 1 (`hold_file_run_to_f64`)."""
    import os
    from seaice_tpu_torch.io import load_checkpoint, save_checkpoint
    from seaice_tpu_torch.kernels import (launch_counts, reset_launch_counts,
                                          wrappers)
    label = "file-driven run"
    half = n_steps // 2
    t0 = time.perf_counter()
    runner = file_runner(inputs, torch.float32)
    model = runner.model
    emit({"model": {"path": label, "seconds_to_build":
                    time.perf_counter() - t0, "cells": model.mesh.n_cells,
                    "dtype": "float32", "tracers": model.tree.names,
                    "steps": n_steps, "restart_after": half}})
    # step 1 from rest: K1's short loop held to its plain version at the
    # larger of SHORT_LOOP_TOL and ten times the plain loop's response to
    # its inputs one ulp larger (from rest the loop amplifies rounding
    # far more; ROADMAP Queue 3, fault 2)
    _, calls = capture_calls(lambda: runner_step(runner, label))
    e, resp = short_loop("evp_subcycle_loop", cast(
        calls["evp_subcycle_loop"][0][0], torch.float32),
        calls["evp_subcycle_loop"][0][1])
    lim = {n: max(SHORT_LOOP_TOL, 10.0 * max(r[n] for r in resp.values()))
           for n in e}
    emit({"file_run_k1_step1_short_loop": {
        "subcycles": SHORT_LOOP, "rel_err_f32": e,
        "plain_one_ulp_response": resp, "limit": lim}})
    if any(not e[n] <= lim[n] for n in e):
        fail(f"{label}, step 1: K1's {SHORT_LOOP} subcycles disagree with "
             f"the plain version, {e} > {lim}")
    del calls
    _, calls = capture_calls(lambda: runner.run(1, check_interval=1))
    if set(calls) != {"evp_subcycle_loop", "integrate_fluxes_cuda"}:
        fail(f"{label}: the step called {sorted(calls)}")
    k1 = check_loop("evp_subcycle_loop", calls["evp_subcycle_loop"][0],
                    min(reps, 3))
    emit({"file_run_k1_against_plain": {
        k: v for k, v in k1.items()
        if "err" in k or k in ("ms", "plain_ms", "bound_ms", "shapes")}})
    k2_on_path(label, calls["integrate_fluxes_cuda"])
    del calls

    # the path: steps 2 .. n_steps, a checkpoint after step `half`
    ckpt = os.path.join(workdir, "restart_half.npz")
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, ir_err, iters, ponds, pond_err, pond_lim = [], [], [], [], [], []
    with RemapSums() as sums:
        for i in range(3, n_steps + 1):
            ms.append(runner_step(runner, label))
            held = hold_products(label, runner.state.tracers,
                                 runner.model.tensors.area_cell, sums)
            ir_err.append(held["max_error_but_ponds"])
            pond_err.append(held["ponds_max_error"])
            ponds.append(held["pond_water_m"])
            pond_lim.append(held["ponds_limit"])
            iters.append(runner.diags["column_fluxes"].thermo_iterations)
            if i == half:
                save_checkpoint(ckpt, runner.state, {
                    "year": runner.clock.year,
                    "seconds": runner.clock.seconds})
    counts = launch_counts()
    inner = {name: fn.inner_launches for name, fn in wrappers().items()
             if getattr(fn, "inner_launches", 0)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    f32 = global_fields(model, runner.state)
    u, v = f32["u"], f32["v"]
    max_u = float(np.sqrt(u * u + v * v).max())
    aice_max = float(f32["iceAreaCategory"].sum(-1).max())
    n_dyn = model.cfg.velocity.dynamics_subcycle_number
    out = {"path": label, "steps": n_steps - 2, "card": card,
           "ms_per_runner_step": ms,
           "ms_per_runner_step_median": float(np.median(ms)),
           "launches": counts, "inner_launches": inner,
           "max_speed": max_u, "aice_max": aice_max,
           "ir_conservation_error_max": max(ir_err),
           "ir_conservation_error_per_step": ir_err,
           "pond_water_per_ice_area_m_per_step": ponds,
           "ir_conservation_error_pond_tracers_per_step": pond_err,
           "ir_conservation_limit_pond_tracers_per_step": pond_lim,
           "thermo_iterations_per_step": iters,
           "ice_area_sum": float(f32["iceAreaCategory"].sum()),
           "peak_mem_mb": peak, "timers": runner.timers.totals}
    emit({"main_path": out})
    for name, t in f32.items():
        if not np.isfinite(t).all():
            fail(f"{label}: {name} is not finite")
    if not 0.0 < max_u < SPEED_LIMIT:
        fail(f"{label}: max |u| = {max_u} outside (0, {SPEED_LIMIT}) m/s")
    if not aice_max <= 1.0 + 1e-6:
        fail(f"{label}: aice = {aice_max} > 1 + 1e-6")
    want = {"evp_subcycle_loop": n_dyn * (n_steps - 2),
            "integrate_fluxes_cuda": n_dyn * (n_steps - 2)}
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times in {n_steps - 2} "
                 f"steps, expected {want.get(name, 0)}")
    if inner.get("evp_subcycle_loop") != counts["evp_subcycle_loop"]:
        fail(f"{label}: K1 made {inner.get('evp_subcycle_loop')} kernel "
             f"launches in {counts['evp_subcycle_loop']} calls, not one each")

    # the restart: a new model and runner from the checkpoint; on its
    # state the bare model step, then its first two steps traced
    st, meta = load_checkpoint(ckpt)
    second = file_runner(inputs, torch.float32, st)
    second.restore_clock(meta)
    bare_ms = bare_step_ms(second)
    trace_steps(label, model, None, None, float(np.median(ms)),
                extra={"bare_model_step_ms": float(np.median(bare_ms)),
                        "bare_model_step_ms_each": bare_ms,
                        "runner_step_ms": float(np.median(ms)),
                        "traced_steps": [half + 1, half + 2]},
                advance=lambda: runner_step(second, label + ", restarted"))
    for _ in range(n_steps - half - 2):
        runner_step(second, label + ", restarted")
    got = global_fields(second.model, second.state)
    differ = [k for k in f32 if not np.array_equal(f32[k], got[k])]
    emit({"file_run_restart": {
        "restart_after": half, "steps_after_restart": n_steps - half,
        "bitwise": not differ, "fields_differing": differ,
        "clock": [second.clock.timestamp(), runner.clock.timestamp()],
        "state_time": [float(second.state.time), float(runner.state.time)]}})
    if differ or second.clock.seconds != runner.clock.seconds:
        fail(f"{label}: the restarted run differs from the straight run in "
             f"{differ}")
    del runner, second, st
    torch.cuda.empty_cache()

    # the same steps in f64, the comparison run, and beside it the f64
    # run rounded to f32 once after step 1: not gated by the state
    # check, whose column rule fails the f64 run on a sliver of ice at
    # step 49 (ROADMAP Queue 3, fault 6; the reference's column flags the
    # same cell on the same inputs); the flagged columns are counted
    third = file_runner(inputs, torch.float64)
    fourth = file_runner(inputs, torch.float64)
    unconv64 = []
    for i in range(n_steps):
        for r in (third, fourth):
            r.run(1, check_interval=2)      # one step: no check fetched
        if i == 0:
            fourth.state = rounded(fourth.state, torch.float32)
        unconv64.append(int(third.diags["column_fluxes"].warnings[
            "thermo_unconverged"].sum()))
    hold_file_run_to_f64(label, f32, global_fields(third.model, third.state),
                         global_fields(fourth.model, fourth.state),
                         third.model.mesh.area_cell, n_steps,
                         {"f64_thermo_unconverged_per_step": unconv64})
    del third, fourth
    torch.cuda.empty_cache()
    return counts


def file_run_distances(a, b, area_cell):
    """Run a's fields against run b's (global numpy fields): the global
    totals of ice area, volume, energy (volume x enthalpy) and salt,
    relative; and on the categories with at least FILE_RUN_AREA_FLOOR of
    ice area in both runs, area, volume and enthalpy relative to b's max
    of the field and the surface temperature in K."""
    def totals(f):
        v, n = f["iceVolumeCategory"], f["iceEnthalpy"].shape[-1]
        layer = (v / n)[..., None]
        return {"area": (f["iceAreaCategory"].sum(-1) * area_cell).sum(),
                "volume": (v.sum(-1) * area_cell).sum(),
                "energy": ((layer * f["iceEnthalpy"]).sum((-2, -1)) *
                           area_cell).sum(),
                "salt": ((layer * f["iceSalinity"]).sum((-2, -1)) *
                         area_cell).sum()}
    ta, tb = totals(a), totals(b)
    out = {"total_" + k: float(abs(ta[k] - tb[k]) / abs(tb[k])) for k in tb}
    keep = (a["iceAreaCategory"] >= FILE_RUN_AREA_FLOOR) & \
        (b["iceAreaCategory"] >= FILE_RUN_AREA_FLOOR)
    for k in F32_F64_BUDGET:
        d = np.abs(a[k] - b[k])
        out[k + "_where_area_ge_floor"] = float(
            d[keep].max() / max(float(np.abs(b[k]).max()), 1e-300)) \
            if keep.any() else 0.0
    out["surfaceTemperature_K_where_area_ge_floor"] = float(np.abs(
        a["surfaceTemperature"] - b["surfaceTemperature"])[keep].max()) \
        if keep.any() else 0.0
    out["categories_held"] = int(keep.sum())
    return out


def rounded(state, dtype):
    """The state with every floating tensor rounded to dtype and back."""

    def r(t):
        return t.to(dtype).to(t.dtype) \
            if isinstance(t, torch.Tensor) and t.is_floating_point() else t
    vel = state.velocity
    return state.replace(
        tracers={k: r(t) for k, t in state.tracers.items()},
        velocity=vel.replace(**{f.name: r(getattr(vel, f.name))
                                for f in dataclasses.fields(vel)}))


def hold_file_run_to_f64(label, f32, f64, f64r, area_cell, n_steps, extra,
                         key="file_run_f32_vs_f64"):
    """The float32 file-driven run (f32) against the same steps in
    float64 (f64), beside the float64 run with its state rounded to
    float32 once after step 1 (f64r: the float64 run's own response to
    one float32 rounding).  Held (`file_run_distances`): the global
    totals of ice area and volume to 3.3e-5 and of ice energy to 1.4e-4,
    relative (BASELINE.md's budget; a state rounded to bfloat16 every
    step leaves them after one step, PERF.md section 6); on the
    categories with at least FILE_RUN_AREA_FLOOR of ice area in both
    runs, area, volume and enthalpy to the larger of the budget and ten
    times f64r's distance there, and the surface temperature to
    TSFC_BUDGET_K.  The EVP loop amplifies rounding (ROADMAP Queue 3,
    faults 2 and 6): after 48 steps one float32 rounding of the float64
    state moves those categories further than the float32 run's own
    distance, far past the budget.  Printed, not held: the distances on
    every category (at the ice edge a category of 1e-9 area holds ice in
    one run and not in the other), the salt total, the velocity, and the
    categories with ice in one run only."""
    out = file_run_distances(f32, f64, area_cell)
    resp = file_run_distances(f64r, f64, area_cell)
    unheld = {k: rel_err(torch.as_tensor(f32[k]).double(),
                         torch.as_tensor(f64[k]))
              for k in list(F32_F64_BUDGET) + ["u", "v"]}
    unheld["surfaceTemperature_max_abs_K"] = float(np.abs(
        f32["surfaceTemperature"] - f64["surfaceTemperature"]).max())
    unheld["categories_with_ice_in_one_run_only"] = int(
        ((f32["iceAreaCategory"] > 1e-11) !=
         (f64["iceAreaCategory"] > 1e-11)).sum())
    limits = {"total_area": F32_F64_BUDGET["iceAreaCategory"],
              "total_volume": F32_F64_BUDGET["iceVolumeCategory"],
              "total_energy": F32_F64_BUDGET["iceEnthalpy"],
              "surfaceTemperature_K_where_area_ge_floor": TSFC_BUDGET_K}
    for k, budget in F32_F64_BUDGET.items():
        k = k + "_where_area_ge_floor"
        limits[k] = max(budget, 10.0 * resp[k])
    emit({key: dict(
        out, steps=n_steps, limits=limits, f64_rounded_to_f32_once=resp,
        pointwise_unheld=unheld, **extra)})
    for k, lim in limits.items():
        if not out[k] <= lim:
            fail(f"{label}: f32 {k} differs from f64 by {out[k]} > {lim} "
                 f"(the f64 run rounded to f32 once: {resp[k]})")


def sharded_full_physics(workdir, gap, card, reps):
    """The raw sphere in SHARDS blocks on the card with the column (K6 +
    K2): two steps against the unsharded full-physics step (K1) from the
    same state and forcing, the second recorded (K6 and K2 against their
    plain versions on its inputs, `check_k6` and `k2_on_path`, reps
    timing repetitions), held to the larger of 1e-7 and ten times the
    unsharded second step's response to a one-ulp perturbation of its
    velocities and stresses (fields under NOISE held to NOISE; the pond
    fields printed, not held, where the unsharded pond water is under
    NOISE metres), printed beside `gap`, the column-off sharded sphere's
    distance in this run (the K1/K6 contraction gap); one counted step
    (K6 and K2 launches); then two steps of ShardedStandaloneRunner from
    files, with its state check, whose sharded checkpoint must read back
    bitwise."""
    from seaice_tpu_torch.io import (load_sharded_checkpoint,
                                     read_restart_timestamp)
    from seaice_tpu_torch.io.forcing_reader import (core_atmos_from_files,
                                                    ncar_ocean_from_file)
    from seaice_tpu_torch.io.synthetic import write_forcing_files
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    from seaice_tpu_torch.run import RunStreams, ShardedStandaloneRunner
    label = "sharded full physics"
    t0 = time.perf_counter()
    model, state, forcing, col = full_physics_case(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, torch.float32, None,
        panel=False)
    sm = ShardedSeaIceModel(model.mesh, model.cfg, SHARDS,
                            dtype=torch.float32)
    tr = {k: t.cpu().numpy() for k, t in state.tracers.items()}
    sstate = [st.replace(tracers=t) for st, t in
              zip(sm.init_state(), sm.scatter_cell_tree(tr))]
    sforcing = sm.scatter_cell_tree(forcing)
    scol = tuple(sm.scatter_cell_tree(x) for x in col)
    emit({"model": {"path": label, "seconds_to_build":
                    time.perf_counter() - t0, "cells": model.mesh.n_cells,
                    "blocks": SHARDS, "dtype": "float32",
                    "tracers": sm.tree.names}})
    step, sstep = stepper(model, col), stepper(sm, scol)
    rows, states = [], []
    for i in range(2):
        states.append(state)
        if i == 0:
            sstate, _ = sstep(sstate, sforcing)
        else:
            sstate, calls = capture_kernel_inputs(sm, sstate, sforcing,
                                                  scol)
        state, _ = step(state, forcing)
        torch.cuda.synchronize()
        got, want = global_fields(sm, sstate), global_fields(model, state)
        rows.append({k: float(np.abs(got[k] - want[k]).max()) /
                     max(float(np.abs(want[k]).max()), 1e-300)
                     for k in want})
    if set(calls) != {"evp_subcycle_prepare", "integrate_fluxes_cuda"} \
            or len(calls["evp_subcycle_prepare"]) != SHARDS:
        fail(f"{label}: the step called "
             f"{ {k: len(v) for k, v in calls.items()} }")
    # K6 on the blocks' Rothrock strength and K2 with the column's tracer
    # table, each against its plain version on this step's inputs
    k6 = check_k6(sm, calls["evp_subcycle_prepare"], reps,
                  short_loop_from_response=True)
    emit({"sharded_full_physics_k6_against_plain": {
        k: v for k, v in k6.items() if "err" in k or k in (
            "short_loop_limit", "ms", "plain_ms", "bound_ms", "shapes")}})
    k2_on_path(label, calls["integrate_fluxes_cuda"])
    del calls
    ulp = 1.0 + 2.0 ** -23
    vel = states[1].velocity
    pert = states[1].replace(velocity=vel.replace(**{
        k: getattr(vel, k) * ulp for k in (
            "u_velocity", "v_velocity", "stress11", "stress22", "stress12")}))
    pstate, _ = step(pert, forcing)
    pw = global_fields(model, pstate)
    resp = {k: float(np.abs(pw[k] - want[k]).max()) /
            max(float(np.abs(want[k]).max()), 1e-300) for k in want}
    noise = sorted(k for k in want if float(np.abs(want[k]).max()) < NOISE)
    # melt ponds whose water is rounding noise (ROADMAP Queue 3, fault 4:
    # under this cold forcing a pond's area and depth grow from a melt of
    # 1e-19 m, so they follow the last bit of the melt): not held
    pond_water = float((want["pondArea"] * want["pondDepth"] *
                        want["levelIceArea"] *
                        want["iceAreaCategory"]).sum(-1).max())
    unheld = sorted(k for k in PONDS if k not in noise) \
        if pond_water < NOISE else []
    held = [k for k in want if k not in noise and k not in unheld]
    limit = max(1e-7, 10.0 * max(resp[k] for k in held))
    worst = max(r[k] for r in rows for k in held)
    out = {"blocks": SHARDS, "card": card, "after_step": rows,
           "max_rel_diff": worst, "one_ulp_response": resp, "limit": limit,
           "noise_fields": noise, "pond_water_max_m": pond_water,
           "unheld_noise_ponds": unheld,
           "column_off_sharded_max_rel_diff_this_run": gap}
    del pstate, pert, states
    # one counted step
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    sstate, _ = sstep(sstate, sforcing)
    torch.cuda.synchronize()
    out["ms_per_step"] = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()
    out["launches_per_step"] = counts
    emit({"sharded_full_physics": out})
    if not worst <= limit:
        fail(f"{label}: sharded and unsharded steps disagree: {worst} > "
             f"{limit}")
    for k in noise:
        if not float(np.abs(got[k]).max()) < NOISE:
            fail(f"{label}: {k} is noise unsharded and not sharded")
    n_dyn = model.cfg.velocity.dynamics_subcycle_number
    want_counts = {"evp_subcycle_step": N_SUBCYCLES * n_dyn,
                   "integrate_fluxes_cuda": SHARDS * n_dyn}
    for name, n in counts.items():
        if n != want_counts.get(name, 0):
            fail(f"{label}: {name} launched {n} times in one step, "
                 f"expected {want_counts.get(name, 0)}")
    del model, state, forcing, col, step
    torch.cuda.empty_cache()

    # two steps of the sharded runner from forcing files of this mesh
    import os
    fdir = os.path.join(workdir, "raw_sphere")
    os.makedirs(fdir)
    six, mon, ocn = write_forcing_files(fdir, sm.global_mesh)
    atmos = core_atmos_from_files(six, mon, sm.global_mesh.lon_cell,
                                  sm.global_mesh.lat_cell)
    runner = ShardedStandaloneRunner(
        sm, sstate, atmos_forcing=atmos, ocean_forcing=ncar_ocean_from_file(
            ocn), streams=RunStreams(restart_dir=fdir,
                                     restart_interval=2 * 1800.0))
    torch.cuda.synchronize()
    reset_launch_counts()
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        runner.run(1)
        ms.append(1e3 * (time.perf_counter() - t0))
    rcounts = launch_counts()
    ts = read_restart_timestamp(fdir)
    back, clock = load_sharded_checkpoint(fdir, f"restart.{ts}", sm.part,
                                          sm.init_state())
    got, want = global_fields(sm, back), global_fields(sm, runner.state)
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    g = global_fields(sm, runner.state)
    max_u = float(np.sqrt(g["u"] ** 2 + g["v"] ** 2).max())
    emit({"sharded_runner": {
        "steps": 2, "ms_per_runner_step": ms, "launches": rcounts,
        "restart": ts, "clock": clock, "restart_bitwise": not differ,
        "fields_differing": differ, "max_speed": max_u}})
    if differ:
        fail(f"sharded runner: the sharded checkpoint reads back with "
             f"{differ} changed")
    if not all(np.isfinite(a).all() for a in g.values()) or \
            not max_u < SPEED_LIMIT:
        fail(f"sharded runner: state not finite or max |u| = {max_u}")
    for name, n in rcounts.items():
        if n != 2 * want_counts.get(name, 0):
            fail(f"sharded runner: {name} launched {n} times in 2 steps, "
                 f"expected {2 * want_counts.get(name, 0)}")
    return counts, rcounts


# -- the namelist run, the coupled run and the sharded coupled run ------------

# the coupled phases: the coupling interval (2 steps of 1800 s), the
# intervals of the single-device run, and its prescribed coverage
COUPLING_INTERVAL, COUPLED_INTERVALS = 3600.0, 4
# the namelist run: the analysis members' alarm, and the least share of
# the category-2-and-up ice whose age rises by exactly dt in a step
ANALYSIS_INTERVAL = 3 * 3600.0
AGED_SHARE = 0.99


def age_advance(before, after, dt, elapsed):
    """How the ice age moved over one step on the device, fetched in one
    copy: the share of category-2-and-up ice (area > 1e-3 before and
    after; new ice forms in category 1) whose age rose by dt, to 1e-5 of
    the age (the remap and ridging divide age x area by area again:
    float32 rounding of a few ulps), the age's range over the ice, and
    the first-year area's range.  Transport, ridging and the ITD remap
    move age between cells and categories and may leave a few entries
    off by more, so the share is held to AGED_SHARE (every reading so far
    was 1); no ice may be older than the run (`elapsed` seconds, the age
    starting at 0) nor younger than 0."""
    a0 = before["iceAreaCategory"][:, 1:]
    a1 = after.tracers["iceAreaCategory"][:, 1:]
    g0 = before["iceAge"][:, 1:]
    g1 = after.tracers["iceAge"][:, 1:]
    ice = (a0 > 1e-3) & (a1 > 1e-3)
    exact = ice & ((g1 - g0 - dt).abs() <= 1e-5 * g1.clamp(min=dt))
    has = after.tracers["iceAreaCategory"] > 1e-3
    age = after.tracers["iceAge"]
    fy = after.tracers["firstYearIceArea"]
    v = torch.stack([ice.sum().double(), exact.sum().double(),
                     torch.where(has, age, -torch.inf).max().double(),
                     torch.where(has, age, torch.inf).min().double(),
                     fy.min().double(), fy.max().double()]).cpu().tolist()
    out = {"aged_entries": int(v[0]), "aged_by_dt": int(v[1]),
           "aged_share": v[1] / max(v[0], 1.0), "age_max_s": v[2],
           "age_min_s": v[3], "elapsed_s": elapsed,
           "first_year_min": v[4], "first_year_max": v[5]}
    out["ok"] = (out["aged_share"] >= AGED_SHARE and
                 v[2] <= elapsed * (1 + 1e-6) and v[3] >= 0.0 and
                 0.0 <= v[4] <= v[5] <= 1.0)
    return out


def namelist_run(inputs_dir, reps, card):
    """The namelist run (K1 + K2): `config_from_namelist` on the example
    namelist, the example's raw subdiv-SUBDIV sphere and cice_default
    state, CORE and NCAR forcing files for that mesh, and
    `StandaloneRunner` with every analysis member (`default_members`,
    alarm ANALYSIS_INTERVAL) for the namelist's run_duration, the state
    checked after every step.  Step 1 from rest; step 2 recorded (K1 and
    K2 against their plain versions on its inputs, `check_loop` and
    `k2_on_path`); then the path (counts to 0, the remaining steps), with
    the ice age and the first-year area held after every step
    (`age_advance`); every member that computed holds finite results; the
    conservation-check member's budget is printed.  Times: ms per runner
    step and the analysis timer.  Returns (launch counts, the model): the
    coupled phases reuse the model (the same column: mushy, dEdd,
    level-ice ponds, Rothrock, ice age and first-year ice)."""
    import os
    from seaice_tpu_torch.analysis import AnalysisDriver, default_members
    from seaice_tpu_torch.io.forcing_reader import (core_atmos_from_files,
                                                    ncar_ocean_from_file)
    from seaice_tpu_torch.io.synthetic import write_forcing_files
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.namelist import (_parse_duration,
                                           config_from_namelist,
                                           initial_state_from_setup)
    from seaice_tpu_torch.run import StandaloneRunner
    label = "namelist run"
    t0 = t_phase = time.perf_counter()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "namelist.seaice.example")
    cfg, setup = config_from_namelist(path)
    mesh = icosahedral_mesh(SUBDIV, radius=setup.earth_radius)
    model = SeaIceModel(mesh, cfg, dtype=torch.float32)
    state = initial_state_from_setup(model, setup)
    fdir = os.path.join(inputs_dir, "namelist_run")
    os.makedirs(fdir)
    six, mon, ocn = write_forcing_files(fdir, mesh)
    members = default_members(compute_interval=ANALYSIS_INTERVAL)
    runner = StandaloneRunner(
        model, state, atmos_forcing=core_atmos_from_files(
            six, mon, mesh.lon_cell, mesh.lat_cell),
        ocean_forcing=ncar_ocean_from_file(ocn),
        analysis=AnalysisDriver(members))
    n_steps = int(round(_parse_duration(setup.run_duration) / cfg.run.dt))
    emit({"model": {"path": label, "seconds_to_build":
                    time.perf_counter() - t0, "cells": mesh.n_cells,
                    "dtype": "float32", "tracers": model.tree.names,
                    "steps": n_steps, "namelist": "examples/"
                    "namelist.seaice.example"}})
    if not {"iceAge", "firstYearIceArea"} <= set(model.tree.names):
        fail(f"{label}: the namelist's ice age and first-year ice are "
             "not in the tracer tree")
    runner_step(runner, label)
    _, calls = capture_calls(lambda: runner_step(runner, label))
    if set(calls) != {"evp_subcycle_loop", "integrate_fluxes_cuda"}:
        fail(f"{label}: the step called {sorted(calls)}")
    k1 = check_loop("evp_subcycle_loop", calls["evp_subcycle_loop"][0],
                    min(reps, 3))
    emit({"namelist_run_k1_against_plain": {
        k: v for k, v in k1.items()
        if "err" in k or k in ("ms", "plain_ms", "bound_ms", "shapes")}})
    k2_on_path(label, calls["integrate_fluxes_cuda"])
    del calls
    torch.cuda.synchronize()
    reset_launch_counts()
    ms, ages = [], []
    for _ in range(3, n_steps + 1):
        before = {k: runner.state.tracers[k].clone() for k in (
            "iceAreaCategory", "iceAge")}
        ms.append(runner_step(runner, label))
        ages.append(age_advance(before, runner.state, cfg.run.dt,
                                runner.clock.seconds))
    counts = launch_counts()
    computed = {m.name: m.results for m in members if m.results}
    from seaice_tpu_torch.utils.containers import to_host
    bad = [f"{name}.{k}" for name, res in computed.items()
           for k, v in to_host(res).items()
           if not np.isfinite(np.asarray(v, np.float64)).all()]
    budget = {k: float(v) for k, v in to_host(
        computed.get("conservation_check", {})).items()}
    f = global_fields(model, runner.state)
    max_u = float(np.sqrt(f["u"] ** 2 + f["v"] ** 2).max())
    out = {"path": label, "card": card, "steps": n_steps - 2,
           "ms_per_runner_step": ms,
           "ms_per_runner_step_median": float(np.median(ms)),
           "launches": counts, "timers": runner.timers.totals,
           "analysis_ms_total": 1e3 * runner.timers.totals["analysis"],
           "members_computed": sorted(computed),
           "conservation_check_budget": budget, "ice_age_per_step": ages,
           "aged_share_min": min(a["aged_share"] for a in ages),
           "max_speed": max_u,
           "phase_seconds": time.perf_counter() - t_phase}
    emit({"namelist_run": out})
    if bad:
        fail(f"{label}: analysis results not finite: {bad}")
    if len(computed) < 15 or not budget:
        fail(f"{label}: only {sorted(computed)} computed")
    for i, a in enumerate(ages):
        if not a["ok"]:
            fail(f"{label}, step {i + 3}: ice age or first-year ice "
                 f"wrong: {a}")
    for name, t in f.items():
        if not np.isfinite(t).all():
            fail(f"{label}: {name} is not finite")
    n_dyn = cfg.velocity.dynamics_subcycle_number
    want = {"evp_subcycle_loop": n_dyn * (n_steps - 2),
            "integrate_fluxes_cuda": n_dyn * (n_steps - 2)}
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")
    return counts, model


def coupled_imports(nc):
    """The import fields of `examples/run_coupled.py` with So_u and So_v
    as in `tests/test_coupled.py`, from a fixed seed, at nc cells."""
    rng = np.random.default_rng(0)
    return {
        "So_t": np.full(nc, -1.6), "So_s": np.full(nc, 32.0),
        "So_u": 0.02 * rng.standard_normal(nc),
        "So_v": 0.02 * rng.standard_normal(nc),
        "Sa_u": 6.0 + rng.standard_normal(nc),
        "Sa_v": 2.0 + rng.standard_normal(nc),
        "Sa_ptem": np.full(nc, 258.0), "Sa_shum": np.full(nc, 8e-4),
        "Sa_dens": np.full(nc, 1.3), "Faxa_lwdn": np.full(nc, 200.0),
        "Faxa_swvdr": np.full(nc, 30.0), "Faxa_swvdf": np.full(nc, 20.0),
        "Faxa_swndr": np.full(nc, 25.0), "Faxa_swndf": np.full(nc, 15.0),
        "Faxa_rain": np.zeros(nc), "Faxa_snow": np.full(nc, 1e-8)}


# the exports of a driver with the column and the velocity solve
COUPLED_EXPORTS = {
    "Si_imask", "Si_ifrac", "Si_t", "Si_vice", "Si_vsno", "Si_avsdr",
    "Si_avsdf", "Si_anidr", "Si_anidf", "Faii_lat", "Faii_sen",
    "Faii_lwup", "Faii_evap", "Fioi_melth", "Fioi_swpen", "Fioi_meltw",
    "Fioi_salt", "Fioi_taux", "Fioi_tauy"}


def stepped_interval(model, state, fields, clock, n_sub, sharded=False,
                     sfc_fluxes=None):
    """The interval mean of the exports taken through `make_step()` by
    hand, from `state` with the import fields `fields` at `clock`: the
    single-device driver's semantics (coszen and day of year per substep
    from the interval-start clock) or, with `sharded`, the sharded
    driver's (one coszen for the interval, no day of year).  sfc_fluxes:
    the calc_Tsfc=False surface fluxes (single device).  Returns the
    export dict and the state after the interval."""
    from seaice_tpu_torch.column.orbital import compute_coszen
    from seaice_tpu_torch.coupler import export_state, import_state
    dt = model.cfg.run.dt
    dev, dtype = model.device, model.dtype
    dyn, atm, ocn = import_state(fields, dt, dtype, device=dev)
    step = model.make_step()
    sums, stress = None, None
    if sharded:
        gm = model.global_mesh
        lat, lon = (torch.as_tensor(np.asarray(a, np.float64)).to(
            device=dev, dtype=dtype) for a in (gm.lat_cell, gm.lon_cell))
        cz, _ = compute_coszen(lat, lon, float(clock.day_of_year),
                               clock.seconds_today)
        dyn, atm, ocn, cz = (model.scatter_cells(x)
                             for x in (dyn, atm, ocn, cz))
    else:
        lat, lon = (torch.as_tensor(np.asarray(a, np.float64)).to(
            device=dev, dtype=dtype) for a in (model.mesh.lat_cell,
                                               model.mesh.lon_cell))
        sec0 = torch.tensor(clock.seconds_today, dtype=dtype, device=dev)
        doy0 = torch.tensor(float(clock.day_of_year), dtype=dtype,
                            device=dev)
    for i in range(n_sub):
        if sharded:
            state, diags = step(model.tensors, model.halo, state, dyn, atm,
                                ocn, cz)
            fl = [d["column_fluxes"] for d in diags]
        else:
            secs = sec0 + (i + 0.5) * dt
            doy = doy0 + torch.floor(secs / 86400.0)
            coszen, _ = compute_coszen(lat, lon, doy,
                                       torch.remainder(secs, 86400.0))
            state, diags = step(model.tensors, state, dyn, atm, ocn,
                                coszen=coszen, day_of_year=doy, lat=lat,
                                sfc_fluxes=sfc_fluxes)
            fl = [diags["column_fluxes"]]
            su = (diags["ocean_stress_u"], diags["ocean_stress_v"])
            stress = su if stress is None else (stress[0] + su[0],
                                                stress[1] + su[1])
        now = [{f: getattr(x, f) for f in FLUX_NAMES} for x in fl]
        sums = now if sums is None else [
            {f: s[f] + x[f] for f in FLUX_NAMES} for s, x in zip(sums, now)]
    means = [{f: s[f] / float(n_sub) for f in FLUX_NAMES} for s in sums]
    if sharded:
        mean = {f: model.gather_cells([m[f] for m in means])
                for f in FLUX_NAMES}
        whole, diags = model.gather_state(state), None
    else:
        mean, whole = means[0], state
        diags = {"ocean_stress_u": stress[0] / float(n_sub),
                 "ocean_stress_v": stress[1] / float(n_sub)}
    out = export_state(whole, _Fluxes(mean), diags,
                       None if sharded else model.tensors.mesh)
    return out, state


# the column fluxes the export reads
FLUX_NAMES = ("flat", "fsens", "flwout", "evap", "fhocn", "fswthru",
              "fresh", "fsalt", "albedo_vis_dir", "albedo_vis_dif",
              "albedo_ir_dir", "albedo_ir_dif")


class _Fluxes:
    def __init__(self, d):
        self.__dict__.update(d)


def copy_state(state):
    """A State (or a list of block States) with every tensor cloned."""
    if isinstance(state, list):
        return [copy_state(s) for s in state]
    vel = state.velocity
    return state.replace(
        tracers={k: v.clone() for k, v in state.tracers.items()},
        velocity=vel.replace(**{f.name: getattr(vel, f.name).clone()
                                for f in dataclasses.fields(vel)}),
        time=state.time.clone())


def differing(got, want):
    """{export: max |got - want|} over the exports that differ."""
    return {k: float(np.abs(np.asarray(got[k], np.float64) -
                            np.asarray(want[k], np.float64)).max())
            for k in want if not np.array_equal(got[k], want[k])}


def coupled_run(model, reps, card):
    """The coupled run (K1 + K2): `CoupledDriver` on `model` (the namelist
    run's: the raw subdiv-SUBDIV sphere, the example namelist's column
    with ice age and first-year ice), coupling interval COUPLING_INTERVAL
    (2 substeps), COUPLED_INTERVALS intervals of `coupled_imports`: counts to
    0 over them (the second recorded), the export roster, shapes and
    finiteness, the clock; K1 and K2 against their plain versions on the
    recorded interval's first step; the first interval's exports against
    the same two steps taken through `make_step()` by hand from the same
    state (`stepped_interval`, bitwise expected: no atomics on this
    path); one interval in prescribed mode (every substep starts from
    the coverage and the prescribed thickness, velocities zero); ms per
    interval and the device idle share of one traced interval."""
    from seaice_tpu_torch.coupled import CoupledDriver
    from seaice_tpu_torch.forcing.core import ForcingSeries
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.prescribed import COVERAGE_MIN
    label = "coupled run"
    t0 = time.perf_counter()
    mesh = model.mesh
    state0 = initial_state_from_setup(model, RunSetup(**FILE_SETUP))
    fields = coupled_imports(mesh.n_cells)
    drv = CoupledDriver(model, copy_state(state0),
                        coupling_interval=COUPLING_INTERVAL)
    n_sub = drv.n_substeps
    emit({"model": {"path": label, "seconds_to_build":
                    time.perf_counter() - t0, "cells": mesh.n_cells,
                    "dtype": "float32", "tracers": model.tree.names,
                    "substeps_per_interval": n_sub,
                    "intervals": COUPLED_INTERVALS}})
    clock0 = drv.clock.copy()
    secs = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, ms, calls = [], [], None
    for i in range(COUPLED_INTERVALS):
        t1 = time.perf_counter()
        if i == 1:
            out, calls = capture_calls(lambda: drv.advance(fields))
        else:
            out = drv.advance(fields)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        outs.append(out)
    counts = launch_counts()
    res = {"path": label, "card": card, "intervals": COUPLED_INTERVALS,
           "substeps_per_interval": n_sub, "ms_per_interval": ms,
           "ms_per_interval_median": float(np.median(ms)),
           "launches": counts, "clock_seconds": drv.clock.seconds,
           "export_fields": sorted(outs[0])}
    for i, out in enumerate(outs):
        if set(out) != COUPLED_EXPORTS:
            fail(f"{label}: exports {sorted(set(out) ^ COUPLED_EXPORTS)} "
                 "missing or extra")
        for k, v in out.items():
            if v.shape != (mesh.n_cells,) or not np.isfinite(v).all():
                fail(f"{label}, interval {i + 1}: export {k} has shape "
                     f"{v.shape} or is not finite")
    if drv.clock.seconds != COUPLED_INTERVALS * COUPLING_INTERVAL:
        fail(f"{label}: the clock is at {drv.clock.seconds} s")
    want = {"evp_subcycle_loop": COUPLED_INTERVALS * n_sub,
            "integrate_fluxes_cuda": COUPLED_INTERVALS * n_sub}
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times in "
                 f"{COUPLED_INTERVALS} intervals, expected "
                 f"{want.get(name, 0)}")
    if set(calls) != {"evp_subcycle_loop", "integrate_fluxes_cuda"}:
        fail(f"{label}: the interval called {sorted(calls)}")
    secs["intervals"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k1 = check_loop("evp_subcycle_loop", calls["evp_subcycle_loop"][0],
                    min(reps, 3))
    emit({"coupled_run_k1_against_plain": {
        k: v for k, v in k1.items()
        if "err" in k or k in ("ms", "plain_ms", "bound_ms", "shapes")}})
    k2_on_path(label, calls["integrate_fluxes_cuda"])
    del calls
    secs["kernel_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # the first interval by hand
    want1, _ = stepped_interval(model, copy_state(state0), fields, clock0,
                                n_sub)
    diff = differing(outs[0], want1)
    res["interval_mean_vs_stepped"] = {"bitwise": not diff,
                                       "max_abs_diff": diff}

    # one interval in prescribed mode
    polar = np.abs(mesh.lat_cell) > np.deg2rad(70.0)
    cov = np.where(polar, 0.85, 0.0)
    pdrv = CoupledDriver(model, copy_state(state0),
                         coupling_interval=COUPLING_INTERVAL,
                         prescribed_coverage=ForcingSeries(
                             times=np.array([0.0]),
                             fields={"iceCoverage": cov[None, :]}))
    seen, step = [], pdrv.step_fn

    def recorder(tensors, st, *a, **kw):
        tr = st.tracers
        vel = st.velocity
        seen.append(torch.stack([
            torch.stack([getattr(vel, f).abs().max() for f in (
                "u_velocity", "v_velocity", "stress11", "stress22",
                "stress12", "solve_velocity_prev")]).max().double(),
            (tr["iceAreaCategory"].sum(-1) - cov_t).abs().max().double(),
            (tr["iceVolumeCategory"].sum(-1) -
             h_t * tr["iceAreaCategory"].sum(-1)).abs().max().double()]))
        return step(tensors, st, *a, **kw)

    cov_t = torch.as_tensor(np.where(cov >= COVERAGE_MIN, cov, 0.0)).to(
        device=model.device, dtype=model.dtype)
    h_t = torch.as_tensor(np.where(mesh.lat_cell >= 0, 2.0, 1.0)).to(
        device=model.device, dtype=model.dtype)
    pdrv.step_fn = recorder
    pout = pdrv.advance(fields)
    heads = torch.stack(seen).cpu().numpy()
    secs["by_hand_and_prescribed"] = time.perf_counter() - t0
    res["seconds"] = secs
    res["prescribed"] = {
        "substeps": len(seen), "max_velocity_state": float(heads[:, 0].max()),
        "max_coverage_error": float(heads[:, 1].max()),
        "max_thickness_error_m": float(heads[:, 2].max()),
        "aice_max_export": float(pout["Si_ifrac"].max())}

    emit({"coupled_run": res})
    if diff:
        fail(f"{label}: the interval means differ from the same steps "
             f"taken by hand: {diff}")
    p = res["prescribed"]
    if len(seen) != n_sub or p["max_velocity_state"] != 0.0 or \
            p["max_coverage_error"] != 0.0 or \
            not p["max_thickness_error_m"] <= 4 * np.finfo(np.float32).eps:
        fail(f"{label}: prescribed mode did not impose its state: {p}")
    t0 = time.perf_counter()
    trace_steps(label, model, None, None, float(np.median(ms)), n=1,
                advance=lambda: drv.advance(fields), host_events=False)
    secs["trace"] = time.perf_counter() - t0
    emit({"coupled_run_seconds": secs})
    return counts, state0, fields


def sharded_coupled_run(model, state0, fields, reps, card):
    """The sharded coupled run (K6 + K2): `ShardedCoupledDriver` on
    `model`'s mesh and config in SHARDS blocks on the card, from the
    coupled run's initial state, one interval, counts to 0 around it (its second
    substep recorded: K6 and K2 against their plain versions,
    `check_k6` with the sharded full-physics limits, `k2_on_path`); the
    gathered export against the same sharded step called twice by hand
    with the interval-start coszen (`stepped_interval`, the driver's own
    semantics; bitwise expected).  Also times `gather_state` of the
    blocks' state (the sharded runner's analysis gather)."""
    from seaice_tpu_torch.coupled import ShardedCoupledDriver
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    label = "sharded coupled run"
    t0 = t_phase = time.perf_counter()
    mesh = model.mesh
    sm = ShardedSeaIceModel(mesh, model.cfg, SHARDS, dtype=torch.float32)
    tr = {k: t.cpu().numpy() for k, t in state0.tracers.items()}
    sstate0 = [st.replace(tracers=t) for st, t in
               zip(sm.init_state(), sm.scatter_cell_tree(tr))]
    drv = ShardedCoupledDriver(sm, copy_state(sstate0),
                               coupling_interval=COUPLING_INTERVAL)
    emit({"model": {"path": label, "seconds_to_build":
                    time.perf_counter() - t0, "cells": mesh.n_cells,
                    "blocks": SHARDS, "dtype": "float32",
                    "tracers": sm.tree.names}})
    clock0 = drv.clock.copy()
    torch.cuda.synchronize()
    reset_launch_counts()
    t1 = time.perf_counter()
    out, calls = capture_calls(lambda: drv.advance(fields))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1)
    counts = launch_counts()
    n_sub = drv.n_substeps
    prep = calls.get("evp_subcycle_prepare", [])
    if set(calls) != {"evp_subcycle_prepare", "integrate_fluxes_cuda"} \
            or len(prep) != n_sub * SHARDS:
        fail(f"{label}: the interval called "
             f"{ {k: len(v) for k, v in calls.items()} }")
    k6 = check_k6(sm, prep[SHARDS:2 * SHARDS], reps,
                  short_loop_from_response=True)
    emit({"sharded_coupled_k6_against_plain": {
        k: v for k, v in k6.items() if "err" in k or k in (
            "short_loop_limit", "ms", "plain_ms", "bound_ms", "shapes")}})
    k2_on_path(label, calls["integrate_fluxes_cuda"])
    del calls, prep
    # the whole state gathered from the blocks on the card: what the
    # sharded runner's analysis hook adds to a step where a member runs
    gather_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sm.gather_state(drv.state)
        torch.cuda.synchronize()
        gather_ms.append(1e3 * (time.perf_counter() - t1))
    want, _ = stepped_interval(sm, copy_state(sstate0), fields, clock0,
                               n_sub, sharded=True)
    diff = differing(out, want)
    res = {"path": label, "card": card, "blocks": SHARDS,
           "substeps": n_sub, "ms_per_interval": ms, "launches": counts,
           "gather_state_ms": gather_ms,
           "export_fields": sorted(out),
           "export_vs_stepped": {"bitwise": not diff, "max_abs_diff": diff},
           "phase_seconds": time.perf_counter() - t_phase}
    emit({"sharded_coupled_run": res})
    if set(out) != COUPLED_EXPORTS - {"Fioi_taux", "Fioi_tauy"} or \
            not all(np.isfinite(v).all() and v.shape == (mesh.n_cells,)
                    for v in out.values()):
        fail(f"{label}: exports {sorted(out)} wrong or not finite")
    if diff:
        fail(f"{label}: the gathered export differs from the same sharded "
             f"steps taken by hand: {diff}")
    n_dyn = sm.cfg.velocity.dynamics_subcycle_number
    want_counts = {"evp_subcycle_step": N_SUBCYCLES * n_dyn * n_sub,
                   "integrate_fluxes_cuda": SHARDS * n_dyn * n_sub}
    for name, n in counts.items():
        if n != want_counts.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want_counts.get(name, 0)}")
    return counts


def small_coupled_reference():
    """`CoupledDriver` on the 8 x 8 box with the column, 2 intervals of 2
    steps, float64 on the card against the same on the CPU: every export
    of both intervals (fields under NOISE on the CPU held to NOISE)."""
    from seaice_tpu_torch.config import box_test_config
    from seaice_tpu_torch.coupled import CoupledDriver
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.testcases import box
    outs = {}
    for device in ("cuda", "cpu"):
        cfg = box_test_config(elastic_subcycles=8)
        cfg = dataclasses.replace(cfg, column=dataclasses.replace(
            cfg.column, use_column_package=True))
        mesh = box.box_test_mesh(8, 8)
        mesh.f_vertex = box.box_coriolis_parameter(mesh)
        model = SeaIceModel(mesh, cfg, dtype=torch.float64, device=device)
        area, vol, snow = box.box_initial_state(mesh, n_categories=1)
        drv = CoupledDriver(model, model.init_state(area, vol, snow),
                            coupling_interval=2 * cfg.run.dt)
        f = coupled_imports(mesh.n_cells)
        outs[device] = [drv.advance(f) for _ in range(2)]
    worst, noise = 0.0, []
    for got, want in zip(outs["cuda"], outs["cpu"]):
        for k, ref in want.items():
            scale = float(np.abs(ref).max())
            if scale < NOISE:
                noise.append(k)
                if not float(np.abs(got[k]).max()) < NOISE:
                    fail(f"small coupled box: {k} is noise on the CPU and "
                         "not on the card")
                continue
            worst = max(worst, float(np.abs(got[k] - ref).max()) / scale)
    emit({"small_reference": {"mesh": "box 8 x 8, CoupledDriver",
                              "intervals": 2, "dtype": "float64",
                              "max_rel_err_vs_cpu": worst,
                              "noise_fields": sorted(set(noise))}})
    if not worst <= 1e-9:
        fail(f"small coupled box on the card differs from the CPU: {worst}")


def add_launches(kernels, path, counts):
    """Record a path's launch counts on the kernels it launched:
    `launches_by_path[path]`, and `launches` the sum over the paths."""
    for name, n in counts.items():
        if n and name in kernels:
            by = kernels[name].setdefault("launches_by_path", {})
            by[path] = n
            kernels[name]["launches"] = sum(by.values())


# --- column options ----------------------------------------------------------

# the column options of the thermodynamics, surface and snow on the
# full-physics panel sphere: (a) the snow tracers with ITDrdg
# redistribution, form drag and high-frequency coupling (the bulk and
# ITDsd schemes one step each after it), (b) the zero-layer
# thermodynamics, (c) the prescribed surface fluxes of calc_Tsfc=False
# (BL99) through one CoupledDriver interval
OPTIONS_SNOW = dict(use_snow_tracers=True, snwredist="ITDrdg",
                    use_form_drag=True, highfreq=True)
OPTIONS_ZERO_LAYER = dict(ktherm=0)
OPTIONS_PRESCRIBED = dict(ktherm=1, calc_surface_temperature=False)
OPTION_STEPS = 2


def option_states(model, n_steps, round_after=None,
                  inputs=full_physics_inputs):
    """n_steps of a full-physics model of the panel sphere from its
    initial state (`inputs`, `full_physics_inputs` by default): the
    global fields after them and the steps' thermo iterations;
    round_after: round the state to float32 once after that many steps
    (the float64 run's own response to one float32 rounding, ROADMAP
    Queue 3 fault 6)."""
    state, forcing, col = inputs(model)
    step = stepper(model, col)
    iters = []
    for i in range(n_steps):
        if round_after == i:
            state = rounded(state, torch.float32)
        state, diags = step(state, forcing)
        iters.append(diags["column_fluxes"].thermo_iterations)
    return global_fields(model, state), iters


def option_f32_against_f64(label, model64, f32, n_steps, area_cell, extra,
                           inputs=full_physics_inputs):
    """The float32 fields `f32` after n_steps against the same steps of
    the float64 model `model64` and of it rounded to float32 once after
    step 1, held by fault 6's rule (`hold_file_run_to_f64`); the thermo
    iterations of the float64 steps beside the float32 ones (`extra`)."""
    f64, it64 = option_states(model64, n_steps, inputs=inputs)
    f64r, _ = option_states(model64, n_steps, round_after=1, inputs=inputs)
    torch.cuda.empty_cache()
    hold_file_run_to_f64(label, f32, f64, f64r, area_cell, n_steps,
                         dict(extra, thermo_iterations_f64=it64),
                         key="column_options_f32_vs_f64")


def option_path(label, bases, opts, reps, card, kernels, main_syncs,
                inputs=full_physics_inputs, watch=contextlib.nullcontext):
    """One path of the column-options phase, float32: the full-physics
    panel sphere with the column options `opts`, counts to 0 before its
    OPTION_STEPS steps from rest and read after them (the last recorded:
    K3 and K2 against their plain versions on its inputs), the checks of
    `full_physics_path` and the remap's conservation by tracer product;
    K2's table width and shared memory, the host syncs of a step beside
    the main path's, ms per step and the device's idle share; then the
    float32 state against float64 by fault 6's rule.  bases: the
    float32 and float64 full-physics models the path's models are taken
    from (`SeaIceModel.with_column`); inputs: the initial state and
    forcing (`full_physics_inputs`, or `melting_inputs`); watch: a
    context active around the path's steps alone.  Returns (model,
    state, forcing, col, the diags of the path's last step)."""
    from seaice_tpu_torch.transport.cuda_flux import flux_layout, shared_bytes
    t0 = time.perf_counter()
    model = bases[torch.float32].with_column(**opts)
    state, forcing, col = inputs(model)
    emit({"model": {"path": label, "options": {
                        k: (dataclasses.asdict(v)
                            if dataclasses.is_dataclass(v) else v)
                        for k, v in opts.items()},
                    "seconds_to_build": time.perf_counter() - t0,
                    "cells": model.mesh.n_cells, "dtype": "float32",
                    "tracers": model.tree.names}})
    with RemapSums() as sums, watch():
        state, ms, iters, calls, counts, diags = full_physics_path(
            label, model, state, forcing, col, OPTION_STEPS,
            capture_last=True, sums=sums)
    add_launches(kernels, label, counts)
    if set(calls) != {"evp_panel_loop", "integrate_fluxes_cuda"}:
        fail(f"{label}: step {OPTION_STEPS} called {sorted(calls)}")
    k3 = check_loop("evp_panel_loop", calls["evp_panel_loop"][0],
                    min(reps, 3), short_loop_from_response=True)
    k2_on_path(label, calls["integrate_fluxes_cuda"])
    k2 = check_k2(calls["integrate_fluxes_cuda"][0], min(reps, 3))
    tree, recon = calls["integrate_fluxes_cuda"][0][0][:2]
    _, out2d, out3d = flux_layout(tree, recon)
    t2 = sum(n for _, n, _ in out2d)
    t3 = sum(n * nl for _, n, nl, _ in out3d)
    shmem = {tag: shared_bytes(t2, t3, size)
             for tag, size in (("f32", 4), ("f64", 8))}
    props = torch.cuda.get_device_properties(0)
    limit = getattr(props, "shared_memory_per_block_optin",
                    props.shared_memory_per_block)
    del calls
    _, syncs = count_host_syncs(lambda: stepper(model, col)(state, forcing))
    emit({"column_options_kernels": {
        "path": label, "card": card,
        "k3_against_plain": {k: v for k, v in k3.items()
                             if "err" in k or k in ("ms", "plain_ms",
                                                    "bound_ms",
                                                    "short_loop_limit")},
        "k2": {k: v for k, v in k2.items()
               if "err" in k or "plain_" in k or k in (
                   "ms", "kernel_ms", "bound_ms", "bound_by", "shapes",
                   "device_kernels_per_call", "device_ms_by_kernel")},
        "k2_table": {"columns_2d": t2, "columns_3d": t3,
                     "width": t2 + t3, "shared_bytes": shmem,
                     "shared_bytes_per_block_limit": limit,
                     "plain_peak_mem_mb": {
                         tag: k2["plain_peak_mem_mb_" + tag]
                         for tag in ("f32", "f64")}}}})
    if not max(shmem.values()) <= limit:
        fail(f"{label}: K2's shared memory {shmem} exceeds {limit} bytes")
    f32 = global_fields(model, state)
    emit({"column_options_path": {
        "path": label, "card": card, "ms_per_step_untraced": ms,
        "host_syncs_per_step": syncs,
        "host_syncs_per_step_main_path": main_syncs,
        "thermo_iterations_per_step": iters}})
    trace_steps(label, model, state, forcing, ms, n=1, col=col,
                host_events=False)
    option_f32_against_f64(label,
                           bases[torch.float64].with_column(**opts),
                           f32, OPTION_STEPS,
                           model.tensors.area_cell.double().cpu().numpy(),
                           {"thermo_iterations_f32": iters}, inputs=inputs)
    return model, state, forcing, col, diags


def prescribed_flux_imports(nc, ncat):
    """The calc_Tsfc=False imports of an atmosphere model: per-category
    surface fluxes (W/m^2) from a fixed seed."""
    rng = np.random.default_rng(4)
    return {"surfaceHeatFluxCouple": rng.uniform(-30.0, 10.0, (nc, ncat)),
            "surfaceConductiveFluxCouple": rng.uniform(-25.0, 5.0,
                                                       (nc, ncat)),
            "latentHeatFluxCouple": rng.uniform(-6.0, 0.0, (nc, ncat)),
            "sensibleHeatFluxCouple": rng.uniform(-15.0, 5.0, (nc, ncat))}


def prescribed_flux_interval(bases, card, kernels):
    """Path (c): one CoupledDriver interval (COUPLING_INTERVAL) of the
    full-physics panel sphere with ktherm=1 and calc_Tsfc=False, the
    import fields of `coupled_imports` and per-category surface fluxes;
    counts to 0 around it (K3 and K2 once a substep), the exports finite,
    the interval mean bitwise the same steps taken by hand with the same
    fluxes (`stepped_interval`), ms of it and of a second interval, and
    the float32 state (after the first interval) against float64
    (the same interval, and float64 rounded to float32 once after the
    first substep) by fault 6's rule."""
    from seaice_tpu_torch.coupled import CoupledDriver
    from seaice_tpu_torch.coupler import import_sfc_fluxes
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    label = "column options (c) prescribed surface fluxes"
    fields = None
    runs = {}
    for dtype in (torch.float32, torch.float64):
        for round_once in ((False,) if dtype == torch.float32
                           else (False, True)):
            model = bases[dtype].with_column(**OPTIONS_PRESCRIBED)
            state0 = full_physics_inputs(model)[0]
            nc, ncat = model.mesh.n_cells, model.cfg.run.n_categories
            if fields is None:
                fields = dict(coupled_imports(nc),
                              **prescribed_flux_imports(nc, ncat))
            drv = CoupledDriver(model, copy_state(state0),
                                coupling_interval=COUPLING_INTERVAL)
            if round_once:
                inner, seen = drv.step_fn, []

                def rounding(tensors, st, *a, **kw):
                    if seen:
                        st = rounded(st, torch.float32)
                    seen.append(1)
                    return inner(tensors, st, *a, **kw)
                drv.step_fn = rounding
            clock0 = drv.clock.copy()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = drv.advance(fields)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = launch_counts()
            runs[dtype, round_once] = global_fields(model, drv.state)
            if dtype != torch.float32:
                continue
            n_sub = drv.n_substeps
            want = {"evp_panel_loop": n_sub, "integrate_fluxes_cuda": n_sub}
            for name, n in counts.items():
                if n != want.get(name, 0):
                    fail(f"{label}: {name} launched {n} times in one "
                         f"interval, expected {want.get(name, 0)}")
            add_launches(kernels, label, counts)
            bad = [k for k, v in out.items() if not np.isfinite(v).all()]
            if bad or set(out) != COUPLED_EXPORTS:
                fail(f"{label}: exports {sorted(out)} ({bad} not finite)")
            sfc = import_sfc_fluxes(fields, model.dtype, model.device)
            by_hand, _ = stepped_interval(model, copy_state(state0), fields,
                                          clock0, n_sub, sfc_fluxes=sfc)
            diff = differing(out, by_hand)
            # a second interval of the same driver, timed alone
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv.advance(fields)
            torch.cuda.synchronize()
            emit({"column_options_coupled": {
                "path": label, "card": card,
                "ms_per_interval": [ms, 1e3 * (time.perf_counter() - t0)],
                "substeps": n_sub, "launches": counts,
                "interval_mean_vs_stepped": {"bitwise": not diff,
                                             "max_abs_diff": diff}}})
            if diff:
                fail(f"{label}: the interval means differ from the same "
                     f"steps taken by hand: {diff}")
            area_cell = model.tensors.area_cell.double().cpu().numpy()
            del by_hand, sfc
        del model, state0, drv
        torch.cuda.empty_cache()
    hold_file_run_to_f64(label, runs[torch.float32, False],
                         runs[torch.float64, False],
                         runs[torch.float64, True], area_cell, 2, {},
                         key="column_options_f32_vs_f64")


def option_bases():
    """The float32 and float64 full-physics models of the sphere that
    every path of the column-options phases (a to e) and fault 16's
    configuration take their column options from, on a copy
    (`SeaIceModel.with_column`): {dtype: model}."""
    t0 = time.perf_counter()
    bases = {dtype: full_physics_case(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, dtype, None)[0]
        for dtype in (torch.float32, torch.float64)}
    emit({"model": {"path": "column options", "cells":
                    bases[torch.float32].mesh.n_cells,
                    "seconds_to_build": time.perf_counter() - t0}})
    return bases


def column_options(bases, reps, card, kernels, main_syncs):
    """The column-options phase at full width (paths a to c), on the
    models of `option_bases`: every path with its launch counts set to 0
    before and read after."""
    t0 = time.perf_counter()
    label = "column options (a) snow, form drag, highfreq"
    model, state, forcing, col, _ = option_path(
        label, bases, OPTIONS_SNOW, reps, card, kernels, main_syncs)
    # the other two redistribution schemes, one step each on the same
    # sphere from path (a)'s state
    rdg = stepper(model, col)(state, forcing)[0].tracers[
        "snowVolumeCategory"].cpu().numpy()
    for scheme in ("bulk", "ITDsd"):
        m = model.with_column(snwredist=scheme)
        with RemapSums() as sums:
            label = f"column options (a) snwredist={scheme}"
            s, _, _, _, counts, _ = full_physics_path(
                label, m, state, forcing, col, 1, sums=sums)
        add_launches(kernels, label, counts)
        if np.array_equal(s.tracers["snowVolumeCategory"].cpu().numpy(),
                          rdg):
            fail(f"snwredist={scheme}: the snow equals ITDrdg's")
    del model, state, forcing, col, m, s, rdg
    torch.cuda.empty_cache()
    option_path("column options (b) zero-layer", bases, OPTIONS_ZERO_LAYER,
                reps, card, kernels, main_syncs)
    torch.cuda.empty_cache()
    prescribed_flux_interval(bases, card, kernels)
    torch.cuda.empty_cache()
    emit({"column_options_seconds": time.perf_counter() - t0})


# --- the pond and radiation options, fault 16 and the entry scripts ----------

# the column's pond and radiation options on the full-physics panel
# sphere, each under MELT_ATMOSPHERE with real initial ponds and seeded
# aerosol deposition: (d) CESM ponds with the snow tracers and the
# snow-liquid routing, SNICAR and 2 bulk aerosol species; (e) topographic
# ponds with the pond freshwater feedback (only topographic ponds book
# the pond water withheld from the ocean), dEdd and modal aerosols (2
# species)
OPTIONS_CESM_SNICAR = dict(pond_scheme="cesm", use_snow_tracers=True,
                           use_snow_liquid_ponds=True,
                           use_snicar=True, n_aerosols=2)
OPTIONS_TOPO_MODAL = dict(pond_scheme="topo",
                          include_pond_freshwater_feedback=True,
                          n_aerosols=2, use_modal_aerosols=True)
# a melting atmosphere over the whole sphere (the CPU tests' MELT,
# tests/test_torch_column_model.py)
MELT_ATMOSPHERE = dict(air_temperature=275.0, longwave_down=320.0,
                       sw_vis_dir=120.0, sw_vis_dif=60.0, sw_ir_dir=100.0,
                       sw_ir_dif=50.0, rain_rate=1e-5,
                       specific_humidity=4e-3)
# the initial ponds of the pond paths: a fraction of the ice area and a
# depth (m) wherever a category holds ice, so that the schemes evolve
# real ponds (two steps of melt alone make rounding-noise ponds under
# CESM, ROADMAP Queue 3 fault 4)
REAL_PONDS = dict(pondArea=0.3, pondDepth=0.05)
# the aerosol deposition's largest rate (kg/m^2/s), seeded per cell
FAERO_MAX = 2e-12
# the aerosol budget of each column step (`aerosol_budget`): to this share
# of the pools and the deposition
AEROSOL_BUDGET_LIMIT = 1e-5
# fault 16's configuration: BL99 with Tsfc computed through CoupledDriver
FAULT16_OPTIONS, FAULT16_SUBSTEPS = dict(ktherm=1), 8


def melting_inputs(model):
    """`full_physics_inputs` under MELT_ATMOSPHERE, with REAL_PONDS where
    the ice is (the tracers of them the model carries) and, where the
    model carries bulk or z-layer aerosols (`deposition_species`), a
    seeded deposition rate per cell and species in [0, FAERO_MAX) as the
    column forcing's fourth entry."""
    state, forcing, (atm, ocn, coszen) = full_physics_inputs(model)
    dtype, dev = model.dtype, model.device
    atm = atm.replace(**{k: torch.full_like(getattr(atm, k), v)
                         for k, v in MELT_ATMOSPHERE.items()})
    tr = dict(state.tracers)
    ice = tr["iceAreaCategory"] > 0.0
    for k, v in REAL_PONDS.items():
        if k in tr:
            tr[k] = torch.where(ice, v, 0.0).to(dtype)
    col = (atm, ocn, coszen)
    n_aero = deposition_species(model)
    if n_aero:
        rng = np.random.default_rng(5)
        col += (torch.as_tensor(rng.uniform(
            0.0, FAERO_MAX, (model.mesh.n_cells, n_aero))).to(
                device=dev, dtype=dtype),)
    return state.replace(tracers=tr), forcing, col


def deposition_species(model):
    """The aerosol species a model's column takes deposition of: its bulk
    aerosols, or its z-layer aerosols."""
    col = model.cfg.column
    zp = col.zbgc_params
    if col.n_aerosols or zp is None or not zp.use_zaero:
        return col.n_aerosols
    return zp.n_zaero


@contextlib.contextmanager
def aerosol_budget(residuals):
    """While active, every `update_aerosol` call of the column appends to
    residuals its budget's relative residual, on the card (no host
    sync): the sum over cells and species of |a.(pools after - pools
    before) + faero_ocn dt - a faero_atm dt| over that of a.(pools
    before) + a faero_atm dt, a the categories' ice areas."""
    import inspect
    from seaice_tpu_torch.column import aerosol
    inner = aerosol.update_aerosol
    sig = inspect.signature(inner)

    def budget(*args, **kw):
        out = inner(*args, **kw)
        b = sig.bind(*args, **kw).arguments
        a, dt = b["aicen"].double(), b["dt"]
        before = (b["aero"].double().sum(-1) * a[..., None]).sum(-2)
        after = (out.aero.double().sum(-1) * a[..., None]).sum(-2)
        dep = b["faero_atm"].double() * a.sum(-1, keepdim=True) * dt
        ocean = out.flux_ocn.double() * dt
        residuals.append((after + ocean - before - dep).abs().sum() /
                         (before + dep).sum())
        return out
    aerosol.update_aerosol = budget
    try:
        yield
    finally:
        aerosol.update_aerosol = inner


def pond_radiation_options(bases, reps, card, kernels, main_syncs):
    """Paths (d) and (e) of the column-options phase at full width
    (`option_path` under `melting_inputs`, on the models of
    `option_bases`): each path's pond water per unit ice area must stay
    real (>= NOISE) after its steps, so the pond products are held to
    IR_CONSERVATION_LIMIT like every other, and every column step of
    the path must keep the aerosol budget (`aerosol_budget`) to
    AEROSOL_BUDGET_LIMIT."""
    t0 = time.perf_counter()
    for label, opts in (
            ("column options (d) CESM and snow-liquid ponds, SNICAR, "
             "bulk aerosols", OPTIONS_CESM_SNICAR),
            ("column options (e) topographic ponds, pond freshwater "
             "feedback, dEdd, modal aerosols", OPTIONS_TOPO_MODAL)):
        budgets = []
        model, state, forcing, col, diags = option_path(
            label, bases, opts, reps, card, kernels, main_syncs,
            inputs=melting_inputs, watch=lambda: aerosol_budget(budgets))
        tr = state.tracers
        a = tr["iceAreaCategory"]
        area = model.tensors.area_cell
        water = float(((a * tr["pondArea"] * tr["pondDepth"]).sum(-1) *
                       area).sum() / ((a.sum(-1) * area).sum()))
        fl = diags["column_fluxes"]
        out = {"path": label, "card": card, "pond_water_m": water,
               "aerosol_budget": [float(r) for r in budgets],
               "faero_ocn_max": float(fl.faero_ocn.abs().max()),
               "fpond_max": float(fl.fpond.abs().max()),
               "aerosol_max": {k: float(tr[k].abs().max()) for k in (
                   "snowScatteringAerosol", "snowBodyAerosol",
                   "iceScatteringAerosol", "iceBodyAerosol")}}
        emit({"pond_radiation_path": out})
        if not water >= NOISE:
            fail(f"{label}: pond water {water} m per unit ice area is "
                 f"rounding noise")
        if len(budgets) != OPTION_STEPS:
            fail(f"{label}: {len(budgets)} aerosol updates in "
                 f"{OPTION_STEPS} steps")
        if not max(out["aerosol_budget"]) <= AEROSOL_BUDGET_LIMIT:
            fail(f"{label}: aerosol budget {out['aerosol_budget']} > "
                 f"{AEROSOL_BUDGET_LIMIT}")
        del model, state, forcing, col, diags, fl
        torch.cuda.empty_cache()
    emit({"pond_radiation_seconds": time.perf_counter() - t0})


# --- brine height, z-salinity and biogeochemistry ---------------------------

# (f) BL99 with the vertical salinity and the skeletal biogeochemistry,
# under full_physics_inputs' cold forcing; (g) mushy with the vertical
# zBGC on the full roster (3 algal classes, every pool) and 3 z-layer
# aerosol bins, under MELT_ATMOSPHERE with seeded deposition
OPTIONS_ZSAL_SKL = dict(ktherm=1, solve_zsalinity=True,
                        use_skeletal_biochemistry=True)
ZBGC_FULL_ROSTER = dict(n_algae=3, use_C=True, use_DON=True, use_Fe=True,
                        use_DMS=True, use_PON=True, use_hum=True,
                        use_zaero=True, n_zaero=3)
# each z-salinity solve's salt budget (`salt_budget`): the change of the
# column salt against -fzsal dt, to this share of the salt
SALT_BUDGET_LIMIT = 1e-5
# the reactions' carbon residual against the largest bio tracer
# concentration (a sum of reaction terms that cancel to rounding)
CARBON_ERROR_LIMIT = 1e-5


def options_zbgc_zaero():
    """Path (g)'s column options, the `ZbgcParams` of ZBGC_FULL_ROSTER."""
    from seaice_tpu_torch.column.zbgc import ZbgcParams
    return dict(use_biogeochemistry=True,
                zbgc_params=ZbgcParams(**ZBGC_FULL_ROSTER))


@contextlib.contextmanager
def salt_budget(residuals):
    """While active, every `solve_zsalinity` call of the column appends to
    residuals its salt budget's relative residual, on the card: the sum
    over columns of |zsal_tot - the salt before + fzsal dt| over that of
    zsal_tot, the salt before the bulk salinity in times the new brine
    height (the reference's check_conserve_salt)."""
    from seaice_tpu_torch.column import constants as cc, zsalinity
    inner = zsalinity.solve_zsalinity

    def budget(dt, bSin, iphin, iDin, darcy_v, hbr, *rest):
        out = inner(dt, bSin, iphin, iDin, darcy_v, hbr, *rest)
        before = bSin.double().mean(-1) * hbr.double().clamp(
            min=cc.PUNY) * cc.RHOI * 1.0e-3
        tot = out.zsal_tot.double()
        residuals.append((tot - before + out.fzsal.double() * dt).abs()
                         .sum() / tot.sum())
        return out
    zsalinity.solve_zsalinity = budget
    try:
        yield
    finally:
        zsalinity.solve_zsalinity = inner


@contextlib.contextmanager
def bgc_watch(rows):
    """While active, every `zbgc_transport_react` call of the column
    appends to rows, on the card: the z-aerosol mass in the ice before
    and after it (sum over columns and layers of concentration x
    porosity x brine height x layer weight), the deposition it was
    given times dt, the smallest bio tracer it returns, whether all are
    finite, and its carbon residual against the largest bio tracer."""
    from seaice_tpu_torch.column import zbgc
    inner = zbgc.zbgc_transport_react

    def watched(dt, C, iphin, iDin, darcy_v, hbr, hbr_old, dh_bot, fswpen,
                T_bot, ocean_bio, p, flux_bio_atm=None, frac=None,
                tables=None):
        out = inner(dt, C, iphin, iDin, darcy_v, hbr, hbr_old, dh_bot,
                    fswpen, T_bot, ocean_bio, p, flux_bio_atm=flux_bio_atm,
                    frac=frac, tables=tables)
        zsl = p.index()["zaero"]
        w = (iphin * tables.zspace).double()

        def mass(c, h):
            return (c[..., zsl, :].double() * w[..., None, :]).sum(
                (-2, -1)) * h.double().clamp(min=0.0)
        dep = (flux_bio_atm[..., zsl].double().sum(-1) * dt
               if flux_bio_atm is not None
               else C.new_zeros((), dtype=torch.float64))
        rows.append(torch.stack([
            mass(C, hbr_old).sum(), mass(out.tracers, hbr).sum(),
            dep.sum(), out.tracers.min().double(),
            torch.isfinite(out.tracers).all().double(),
            out.cerror.amax().double() /
            out.tracers.abs().amax().double().clamp(min=1e-30)]))
        return out
    zbgc.zbgc_transport_react = watched
    try:
        yield
    finally:
        zbgc.zbgc_transport_react = inner


# K2's trees past the default shared memory of a block (48 KB) and past the
# opt-in limit: the widest column tree with more bio layers (KB in float64)
K2_WIDE_BIO_LAYERS = (15, 95)


def k2_shared_memory_limits(card):
    """K2 on the subdiv-2 sphere (5 categories, 7 + 1 layers, level-ice
    ponds, the vertical zBGC on the full roster, 19 tracers, with its
    mobile fractions, every tracer seeded) at K2_WIDE_BIO_LAYERS bio
    layers in float64: the first a block needs more than the card's
    default 48 KB of shared memory, so the kernel opts in, and it is held
    against its plain version to TOL; the second needs more than the
    card's opt-in limit, so the wrapper must raise naming the table's
    width (no launch counted, no plain version run in its place)."""
    from seaice_tpu_torch import config as C
    from seaice_tpu_torch.column.zbgc import ZbgcParams
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.model import SeaIceModel, column_tracer_tree
    from seaice_tpu_torch.transport import remap as R
    from seaice_tpu_torch.transport.cuda_flux import (
        flux_layout, integrate_fluxes_cuda, shared_bytes)
    dtype = torch.float64
    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin",
                    props.shared_memory_per_block)
    rows = []
    for nbl in K2_WIDE_BIO_LAYERS:
        cfg = C.Config(
            run=C.RunConfig(dt=1800.0, n_categories=5, n_ice_layers=7),
            velocity=C.VelocitySolverConfig(elastic_subcycle_number=2),
            column=C.ColumnConfig(
                use_column_package=False, n_bio_layers=nbl,
                pond_scheme="lvl", use_biogeochemistry=True,
                zbgc_params=ZbgcParams(**ZBGC_FULL_ROSTER)))
        tree = column_tracer_tree(cfg)
        mesh = icosahedral_mesh(2)
        model = SeaIceModel(mesh, cfg, dtype=dtype, tracer_tree=tree)
        rng = np.random.default_rng(6)
        nc, nv = mesh.n_cells, mesh.n_vertices
        area = rng.uniform(0.0, 0.3, (nc, 5)) * (rng.uniform(size=(nc, 1))
                                                  > 0.3)
        state = model.init_state(area, area * rng.uniform(0.5, 3.0, (nc, 5)),
                                 area * 0.1)
        dev = model.device
        tr = {k: (v if k in ("iceAreaCategory", "iceVolumeCategory",
                             "snowVolumeCategory")
                  else torch.as_tensor(rng.uniform(0.1, 2.0, tuple(v.shape)))
                  .to(device=dev, dtype=dtype))
              for k, v in state.tracers.items()}
        rt = model.tensors.remap
        fields = R.to_transport_fields(tree, tr)
        mask_cell, masks = R.make_masks(tree, fields)
        recon = R.reconstruct_fields(
            tree, fields, masks, mask_cell, rt,
            model.tensors.mesh.cells_on_cell,
            model.tensors.mesh.cells_on_cell_mask, monotonic=True)
        uv, vv = (torch.as_tensor(60.0 * rng.standard_normal(nv)).to(
            device=dev, dtype=dtype) for _ in range(2))
        dpx, dpy = R.departure_points(uv, vv, 1800.0)
        tris = R.find_departure_triangles(rt, dpx, dpy, mesh.vertex_degree)
        cell, xq, yq, tarea = R.triangles_to_cell_coords(rt, tris)
        args = (tree, recon, rt, cell, xq, yq, tarea, tris["mask_edge"])
        _, out2d, out3d = flux_layout(tree, recon)
        t2 = sum(n for _, n, _ in out2d)
        t3 = sum(n * nl for _, n, nl, _ in out3d)
        need = shared_bytes(t2, t3, 8)
        row = {"n_bio_layers": nbl, "width": t2 + t3, "shared_bytes": need,
               "optin_bytes": optin}
        before = integrate_fluxes_cuda.launches
        if need <= optin:
            got = integrate_fluxes_cuda(*args)
            torch.cuda.synchronize()
            want = plain_fluxes(args, {})
            row["max_rel_err_f64"] = max(rel_err(got[n], want[n])
                                         for n in want)
            if not row["max_rel_err_f64"] <= TOL[dtype]:
                fail(f"K2 at {t2 + t3} columns ({need} B a block): kernel "
                     f"and plain version disagree, {row}")
        else:
            try:
                integrate_fluxes_cuda(*args)
                torch.cuda.synchronize()
                fail(f"K2 at {t2 + t3} columns needs {need} B a block, "
                     f"over the card's {optin}, and did not raise")
            except RuntimeError as e:
                row["raised"] = str(e)
                if f"{t2 + t3} columns" not in str(e):
                    fail(f"K2's error does not name the width: {e}")
        integrate_fluxes_cuda.launches = before   # not the path's launches
        rows.append(row)
        del model, state, tr, fields, recon, args
        torch.cuda.empty_cache()
    emit({"k2_shared_memory": {"card": card, "trees": rows}})
    if not (rows[0]["shared_bytes"] > 48 * 1024 and
            rows[1]["shared_bytes"] > optin):
        fail(f"K2's shared-memory cases do not cross 48 KB and the opt-in "
             f"limit: {rows}")


def bgc_options(bases, reps, card, kernels, main_syncs):
    """Paths (f) and (g) of the column-options phase at full width
    (`option_path` on the models of `option_bases`): (f) every column
    step's salt budget to SALT_BUDGET_LIMIT (`salt_budget`); (g) every
    zBGC step's output finite and non-negative, its carbon residual to
    CARBON_ERROR_LIMIT of the largest bio tracer, the z-aerosol mass in
    the ice growing under deposition (`bgc_watch`); each path's BGC
    diagnostics finite."""
    t0 = time.perf_counter()
    label = ("column options (f) BL99, vertical salinity, skeletal "
             "biogeochemistry")
    budgets = []
    model, state, forcing, col, diags = option_path(
        label, bases, OPTIONS_ZSAL_SKL, reps, card, kernels, main_syncs,
        watch=lambda: salt_budget(budgets))
    bgc = diags["column_fluxes"].bgc
    out = {"path": label, "card": card,
           "salt_budget": [float(r) for r in budgets],
           "bgc_diagnostics_max": {k: float(v.abs().max())
                                   for k, v in bgc.items()},
           "verticalSalinity_min": float(
               state.tracers["verticalSalinity"].min()),
           "sklBgc_max": float(state.tracers["sklBgc"].max())}
    emit({"bgc_path": out})
    if len(budgets) != OPTION_STEPS:
        fail(f"{label}: {len(budgets)} z-salinity solves in "
             f"{OPTION_STEPS} steps")
    if not max(out["salt_budget"]) <= SALT_BUDGET_LIMIT:
        fail(f"{label}: salt budget {out['salt_budget']} > "
             f"{SALT_BUDGET_LIMIT}")
    if not all(np.isfinite(v) for v in out["bgc_diagnostics_max"].values()):
        fail(f"{label}: non-finite BGC diagnostics")
    del model, state, forcing, col, diags, bgc
    torch.cuda.empty_cache()

    label = ("column options (g) mushy, vertical zBGC on the full roster, "
             "z-layer aerosols")
    rows = []
    model, state, forcing, col, diags = option_path(
        label, bases, options_zbgc_zaero(), reps, card, kernels,
        main_syncs, inputs=melting_inputs, watch=lambda: bgc_watch(rows))
    bgc = diags["column_fluxes"].bgc
    vals = torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 6))
    bio = state.tracers["bioTracers"]
    out = {"path": label, "card": card,
           "zaero_mass_before_after_deposited": vals[:, :3].tolist(),
           "bio_min_after_column": vals[:, 3].tolist(),
           "carbon_error_over_max_tracer": vals[:, 5].tolist(),
           "bio_min_after_step": float(bio.min()),
           "bio_max_after_step": float(bio.max()),
           "bgc_diagnostics_max": {k: float(v.abs().max())
                                   for k, v in bgc.items()}}
    emit({"bgc_path": out})
    if len(rows) != OPTION_STEPS:
        fail(f"{label}: {len(rows)} zBGC steps in {OPTION_STEPS} steps")
    if not (vals[:, 4] == 1.0).all() or not bool(torch.isfinite(bio).all()):
        fail(f"{label}: non-finite bio tracers")
    if not (vals[:, 3] >= 0.0).all():
        fail(f"{label}: negative bio tracers after the column step "
             f"{vals[:, 3]}")
    if not (vals[:, 5] <= CARBON_ERROR_LIMIT).all():
        fail(f"{label}: carbon residual {vals[:, 5]} > "
             f"{CARBON_ERROR_LIMIT} of the largest bio tracer")
    if not ((vals[:, 2] > 0.0) & (vals[:, 1] > vals[:, 0])).all():
        fail(f"{label}: the z-aerosol mass in the ice does not grow under "
             f"deposition: {vals[:, :3]}")
    if not all(np.isfinite(v) for v in out["bgc_diagnostics_max"].values()):
        fail(f"{label}: non-finite BGC diagnostics")
    del model, state, forcing, col, diags, bgc, bio
    torch.cuda.empty_cache()
    k2_shared_memory_limits(card)
    emit({"bgc_seconds": time.perf_counter() - t0})


def fault16(bases, card, kernels):
    """ROADMAP Queue 3 fault 16's configuration: the full-physics panel
    sphere with BL99 (Tsfc computed) through CoupledDriver, float32, the
    imports of `coupled_imports` (and the per-category fluxes of
    `prescribed_flux_imports`, as `dev/bl99_coupled_witness.py` gives
    them), FAULT16_SUBSTEPS substeps, on the float32 model of
    `option_bases`; fails at the first substep that leaves a tracer
    non-finite.  Counts to 0 around the substeps (K3 and K2 once each a
    substep)."""
    from seaice_tpu_torch.coupled import CoupledDriver
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    label = "fault 16: BL99 through CoupledDriver, float32"
    t0 = time.perf_counter()
    model = bases[torch.float32].with_column(**FAULT16_OPTIONS)
    nc, ncat = model.mesh.n_cells, model.cfg.run.n_categories
    fields = dict(coupled_imports(nc), **prescribed_flux_imports(nc, ncat))
    drv = CoupledDriver(model, full_physics_inputs(model)[0],
                        coupling_interval=COUPLING_INTERVAL)
    inner, rows = drv.step_fn, []

    def checked(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        bad = {k: int((~torch.isfinite(v)).sum())
               for k, v in out[0].tracers.items()
               if not bool(torch.isfinite(v).all())}
        rows.append({"ms": 1e3 * (time.perf_counter() - t1),
                     "thermo_iterations":
                         out[1]["column_fluxes"].thermo_iterations,
                     "non_finite": bad})
        if bad:
            fail(f"{label}: substep {len(rows)} leaves non-finite "
                 f"tracers {bad}")
        return out
    drv.step_fn = checked
    emit({"model": {"path": label, "cells": nc, "options": FAULT16_OPTIONS,
                    "seconds_to_build": time.perf_counter() - t0}})
    torch.cuda.synchronize()
    reset_launch_counts()
    while len(rows) < FAULT16_SUBSTEPS:
        drv.advance(fields)
    counts = launch_counts()
    want = {"evp_panel_loop": len(rows), "integrate_fluxes_cuda": len(rows)}
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times in {len(rows)} "
                 f"substeps, expected {want.get(name, 0)}")
    add_launches(kernels, label, counts)
    emit({"fault16": {"path": label, "card": card, "substeps": rows,
                      "launches": counts}})
    del model, drv
    torch.cuda.empty_cache()


# each example of the port and its entry file on the card at its own
# width (the script's default mesh: the 80 x 80 box against its default
# 20 x 20) and small depth (2 steps; 3 with the file-driven run's
# restart): (script, arguments, the kernels its run launches); the 5-day
# examples also get --outdir
ENTRY_SCRIPTS = (
    ("examples/torch_run_box_test.py", ["--nx", "80", "--hours", "0.34",
                                        "--subcycles", "120", "--f32"],
     ("evp_raster_loop",)),
    ("examples/torch_run_global.py", ["--days", "0.021"],
     ("evp_subcycle_loop",)),
    ("examples/torch_run_5day_global.py", ["--days", "0.042"],
     ("evp_subcycle_loop", "integrate_fluxes_cuda")),
    ("examples/torch_run_5day_from_files.py", ["--days", "0.042",
                                               "--verify-restart"],
     ("evp_subcycle_loop", "integrate_fluxes_cuda")),
)


def entry_scripts(card, kernels, workdir):
    """The port's example scripts through runpy on the card (their
    standard output kept, its last lines printed) and `entry_torch.py`'s
    entry() (one step of the 32 x 32 box: K4) and dryrun_multichip(4) (one
    sharded full-physics step in 4 blocks on the card: K6 and K2): each
    with its counts set to 0 before and read after, and the kernels of
    its path launched."""
    import io
    import os
    import runpy
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    root = os.path.dirname(os.path.abspath(__file__))

    def counted(label, fn, expect):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        emit({"entry_script": {
            "path": label, "card": card,
            "seconds": time.perf_counter() - t0, "launches": counts,
            "output_tail": buf.getvalue().strip().splitlines()[-3:]}})
        if {k for k, n in counts.items() if n} != set(expect):
            fail(f"{label}: launched {counts}, expected {expect}")
        add_launches(kernels, label, counts)

    for script, args, expect in ENTRY_SCRIPTS:
        path = os.path.join(root, script)
        if "5day" in script:
            args = args + ["--outdir", os.path.join(
                workdir, os.path.basename(script)[:-3])]

        def run(path=path, args=args):
            argv = sys.argv
            sys.argv = [path] + args
            try:
                runpy.run_path(path, run_name="__main__")
            finally:
                sys.argv = argv
        counted(script, run, expect)
    entry = runpy.run_path(os.path.join(root, "entry_torch.py"))

    def one_step():
        fn, fn_args = entry["entry"]()
        out, _ = fn(*fn_args)
        if not bool(torch.isfinite(out.velocity.u_velocity).all()):
            fail("entry_torch.entry(): u is not finite")
    counted("entry_torch.entry()", one_step, ("evp_raster_loop",))
    counted("entry_torch.dryrun_multichip(4)",
            lambda: entry["dryrun_multichip"](4),
            ("evp_subcycle_step", "integrate_fluxes_cuda"))


# --- solver variants ---------------------------------------------------------

# an option must move the answer off standard EVP's by more than this share
# of max |u| for the path to show that the option ran
VARIANT_MOVES = 1e-3
# the VP solver's GMRES: restart cycles and Arnoldi steps a cycle
VP_NEWTON, VP_GMRES_CYCLES, VP_GMRES_RESTART = 10, 30, 15
# `tests/test_evp_box.py::test_implicit_vp_solver`'s limit on the VP
# residual's 2-norm, set on the 12 x 12 box's 169 vertices
VP_RESIDUAL_LIMIT, VP_TEST_VERTICES = 10.0, 169


def _options():
    from seaice_tpu_torch import config as C
    return {
        "revised EVP": dict(
            constitutive_relation=C.ConstitutiveRelation.EVP_REVISED),
        "weak": dict(strain_scheme=C.StrainScheme.WEAK,
                     stress_divergence_scheme=C.StressDivergenceScheme.WEAK),
        "linear ocean stress": dict(
            ocean_stress_type=C.OceanStressType.LINEAR),
        "no ocean stress": dict(use_ocean_stress=False),
        "strain averaging": dict(average_variational_strains=True),
        "linear relation": dict(
            constitutive_relation=C.ConstitutiveRelation.LINEAR)}


def with_velocity(model, **vel):
    """The same model (same tensors) with velocity options over its
    config: a variant that needs no tensors of its own."""
    import copy
    out = copy.copy(model)
    out.cfg = dataclasses.replace(model.cfg, velocity=dataclasses.replace(
        model.cfg.velocity, **vel))
    return out


def moved_off(label, state, ref):
    """The largest distance of u, v from the standard-EVP state `ref`,
    relative to the reference's max |u|: must exceed VARIANT_MOVES."""
    got = torch.stack([state.velocity.u_velocity, state.velocity.v_velocity])
    want = torch.stack([ref.velocity.u_velocity, ref.velocity.v_velocity])
    d = rel_err(got.double(), want.double())
    if not d > VARIANT_MOVES:
        fail(f"{label}: the answer lies {d} of max |u| from standard "
             f"EVP's, not more than {VARIANT_MOVES}: the option did not run")
    return d


def speed_within(label, state, limit):
    u, v = state.velocity.u_velocity, state.velocity.v_velocity
    m = float(torch.sqrt(u * u + v * v).max())
    if not 0.0 < m < limit:
        fail(f"{label}: max |u| = {m} outside (0, {limit}) m/s")
    return m


def sharded_variant_against_unsharded(smodel, sstate, sforcing, state,
                                      n_steps):
    """The sharded revised-EVP state after n_steps against the unsharded
    one (`state`, the same steps), at the limits of the CPU test
    `tests/test_torch_sharded.py::test_sharded_variants_match_unsharded`:
    u, v to 1e-11 absolute, every tracer to 1e-11 of its max in float64.
    A float32 tracer is held to two float32 ulps of its max (2.4e-7): the
    remap rounds a tracer of a block-edge cell one ulp otherwise than the
    whole mesh does (ROADMAP Queue 3, fault 3; the JAX package's sharded
    step does the same), and 1e-11 lies below one float32 ulp."""
    got = global_fields(smodel, sstate)
    want = {"u": state.velocity.u_velocity.cpu().numpy(),
            "v": state.velocity.v_velocity.cpu().numpy(),
            **{k: t.cpu().numpy() for k, t in state.tracers.items()}}
    rows = {k: {"equal": bool(np.array_equal(got[k], want[k])),
                "abs_diff": float(np.abs(got[k] - want[k]).max()),
                "rel_diff": float(np.abs(got[k] - want[k]).max()) /
                max(float(np.abs(want[k]).max()), 1e-300)} for k in want}
    emit({"sharded_variant_against_unsharded": {
        "option": "revised EVP", "blocks": smodel.n_shards,
        "steps": n_steps, "dtype": str(smodel.dtype), "fields": rows}})
    tracer_limit = 1e-11 if smodel.dtype == torch.float64 else \
        2.0 * torch.finfo(torch.float32).eps
    for k, r in rows.items():
        bad = (r["abs_diff"] > 1e-11) if k in ("u", "v") else \
            (r["rel_diff"] > tracer_limit)
        if bad:
            fail(f"sharded revised EVP: {k} differs from the unsharded "
                 f"step by {r}")


def solver_variants(reps, card, kernels):
    """The solver variants and transport at full width, float32 (paths a
    to f), each with its launch counts set to 0 before and read after;
    prints the ms per step of every path beside the card."""
    from seaice_tpu_torch.dynamics.implicit import make_vp_solver
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    opts = _options()
    ms, extra = {}, {}
    f32 = torch.float32

    # a. the raw sphere with revised EVP and IR: the plain loop, then K2
    # (held against its plain version on the first step's tensors); the
    # same model with standard EVP (K1) from the same state for scale
    t0 = time.perf_counter()
    model, state0, forcing = build_model(SUBDIV, N_CATEGORIES, N_ICE_LAYERS,
                                         N_SUBCYCLES, f32, None)
    emit({"model": {"path": "solver variants, raw sphere",
                    "seconds_to_build": time.perf_counter() - t0,
                    "cells": model.mesh.n_cells}})
    std, rev = stepper(model), with_velocity(model, **opts["revised EVP"])
    std_states = [state0]
    for _ in range(3):
        std_states.append(std(std_states[-1], forcing)[0])
    state, calls = capture_kernel_inputs(rev, state0, forcing)
    if set(calls) != {"integrate_fluxes_cuda"}:
        fail(f"revised EVP raw sphere: the step called {sorted(calls)}")
    k2_on_path("revised EVP raw sphere", calls["integrate_fluxes_cuda"])
    del calls
    rev_after_1 = state
    state, counts, ms["a. revised EVP raw sphere"] = main_path(
        "revised EVP raw sphere", rev, state, forcing, 2,
        {"integrate_fluxes_cuda": 1})
    add_launches(kernels, "revised EVP raw sphere", counts)
    speed_within("revised EVP raw sphere", state, 3.0)
    extra["a_moved_off_standard"] = moved_off("revised EVP raw sphere",
                                              state, std_states[3])

    # d. one step each of four more options on the same model
    for name in ("linear ocean stress", "no ocean stress",
                 "strain averaging", "linear relation"):
        m = with_velocity(model, **opts[name])
        s, counts, ms["d. " + name] = main_path(
            name + " raw sphere", m, state0, forcing, 1,
            {"integrate_fluxes_cuda": 1})
        add_launches(kernels, name + " raw sphere", counts)
        speed_within(name, s, 3.0)
        extra["d_moved_off_standard_" + name.replace(" ", "_")] = \
            moved_off(name, s, std_states[1])
    del std_states, s, m

    # e. the same sphere in SHARDS blocks with revised EVP: the per-block
    # plain loop with the vertex exchange every subcycle, K2 per block,
    # against the unsharded revised steps
    rev_2 = stepper(rev)(rev_after_1, forcing)[0]
    smodel, sstate, sforcing = build_sharded_model(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, f32, None, SHARDS,
        vel=opts["revised EVP"])
    sstate, counts, ms["e. revised EVP sharded sphere"] = main_path(
        "revised EVP sharded sphere", smodel, sstate, sforcing, 2,
        {"integrate_fluxes_cuda": SHARDS})
    add_launches(kernels, "revised EVP sharded sphere", counts)
    sharded_variant_against_unsharded(smodel, sstate, sforcing, rev_2, 2)
    del smodel, sstate, sforcing, model, rev, state, state0, rev_2
    del rev_after_1, forcing
    torch.cuda.empty_cache()

    # b. the weak scheme with upwind transport (tests/test_sphere.py's
    # setup at full width): no kernel
    model, state, forcing = build_model(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, f32, None,
        vel=opts["weak"], upwind=True, zonal=True)
    state, counts, ms["b. weak + upwind raw sphere"] = main_path(
        "weak + upwind raw sphere", model, state, forcing, 3, {})
    speed_within("weak + upwind raw sphere", state, 1.0)
    del model, state, forcing
    torch.cuda.empty_cache()

    # c. the panel sphere, standard EVP with upwind transport: K3, held
    # against its plain version on this path's first step
    model, state, forcing = build_model(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, f32, None,
        panel=True, upwind=True, zonal=True)
    state, calls = capture_kernel_inputs(model, state, forcing)
    if set(calls) != {"evp_panel_loop"}:
        fail(f"panel sphere with upwind: the step called {sorted(calls)}")
    k3 = check_loop("evp_panel_loop", calls["evp_panel_loop"][0],
                    min(reps, 3))
    emit({"upwind_k3_against_plain": {
        k: v for k, v in k3.items()
        if "err" in k or k in ("ms", "plain_ms", "bound_ms")}})
    del calls
    state, counts, ms["c. upwind panel sphere (K3)"] = main_path(
        "upwind panel sphere", model, state, forcing, 2,
        {"evp_panel_loop": 1})
    add_launches(kernels, "upwind panel sphere", counts)
    speed_within("upwind panel sphere", state, 1.0)
    del model, state, forcing
    torch.cuda.empty_cache()

    # f. the 168 x 168 box: the JFNK VP solver against EVP with 240
    # subcycles (K4, held against its plain version on the second step:
    # from rest the stresses are rounding noise, as on the raster box
    # path), two steps each; a third EVP step counts K4's launches
    model, state0, forcing = build_box_model(BOX_NX, 2 * N_SUBCYCLES, f32,
                                             None)
    state, _ = stepper(model)(state0, forcing)
    state, calls = capture_kernel_inputs(model, state, forcing)
    if set(calls) != {"evp_raster_loop"}:
        fail(f"VP box, EVP side: the step called {sorted(calls)}")
    k4 = check_loop("evp_raster_loop", calls["evp_raster_loop"][0],
                    min(reps, 3))
    emit({"vp_box_k4_against_plain": {
        k: v for k, v in k4.items()
        if "err" in k or k in ("ms", "plain_ms", "bound_ms")}})
    del calls
    u_evp = state.velocity.u_velocity.double().cpu().numpy()
    _, counts, ms["f. box, EVP side (K4)"] = main_path(
        "VP box, EVP side", model, state, forcing, 1, {"evp_raster_loop": 1})
    add_launches(kernels, "VP box, EVP side", counts)
    vp = make_vp_solver(model.cfg, n_newton=VP_NEWTON,
                        gmres_iters=VP_GMRES_CYCLES,
                        gmres_restart=VP_GMRES_RESTART)
    tr = state0.tracers
    ice = (tr["iceAreaCategory"], tr["iceVolumeCategory"],
           tr["snowVolumeCategory"])
    vstate, rows, t_vp = state0.velocity, [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(2):
        t0 = time.perf_counter()
        vstate, d = vp(model.tensors.dynamics, vstate, forcing, *ice)
        torch.cuda.synchronize()
        t_vp.append(1e3 * (time.perf_counter() - t0))
        rows.append({"vp_residual_norm": float(d["vp_residual_norm"]),
                     "gmres_restarts": d["gmres_restarts"],
                     "gmres_host_syncs": d["gmres_host_syncs"]})
    if any(launch_counts().values()):
        fail(f"VP box: the VP step launched {launch_counts()}")
    # the first VP step carries torch.func's first-use cost
    ms["f. box, VP solver (second step)"] = t_vp[-1]
    u_vp = vstate.u_velocity.double().cpu().numpy()
    if not np.isfinite(u_vp).all():
        fail("VP box: u is not finite")
    mask = np.abs(u_evp) > 1e-4
    corr = float(np.corrcoef(u_evp[mask], u_vp[mask])[0, 1])
    emit({"vp_box": {"newton": VP_NEWTON, "gmres_cycles": VP_GMRES_CYCLES,
                     "gmres_restart": VP_GMRES_RESTART, "steps": rows,
                     "ms_per_step": t_vp, "corr_with_evp": corr,
                     "card": card}})
    if not corr > 0.8:
        fail(f"VP box: correlation with EVP {corr} <= 0.8")
    # the 12 x 12 test's limit of 10 on the residual's 2-norm over its
    # 169 vertices, as a limit on the root mean square a vertex
    nv = model.mesh.n_vertices
    limit = VP_RESIDUAL_LIMIT * np.sqrt(nv / VP_TEST_VERTICES)
    if not rows[-1]["vp_residual_norm"] < limit:
        fail(f"VP box: residual norm {rows[-1]['vp_residual_norm']} >= "
             f"{limit} ({VP_RESIDUAL_LIMIT} over {VP_TEST_VERTICES} "
             f"vertices, scaled to {nv})")
    del model, state, state0, forcing, vstate, ice, tr
    torch.cuda.empty_cache()
    emit({"solver_variants": dict({"card": card, "ms_per_step": ms},
                                  **extra)})


def small_vp_reference():
    """The VP solver on the 12 x 12 box in the setting of
    `tests/test_evp_box.py::test_implicit_vp_solver` (12 Newton
    iterations, 40 GMRES cycles, 3 steps), float64 on the card against
    the same on the CPU: u, v to the small-model limit 1e-9, and the
    test's residual limit (below 10) on the card."""
    from seaice_tpu_torch.config import box_test_config
    from seaice_tpu_torch.dynamics.evp import (build_dynamics_tensors,
                                               init_velocity_state)
    from seaice_tpu_torch.dynamics.implicit import make_vp_solver
    from seaice_tpu_torch.testcases import box
    out = {}
    for device in ("cuda", "cpu"):
        cfg = box_test_config(elastic_subcycles=8)
        mesh = box.box_test_mesh(12, 12)
        mesh.f_vertex = box.box_coriolis_parameter(mesh)
        dyn = build_dynamics_tensors(mesh, cfg, torch.float64, device)
        ice = [torch.as_tensor(a).to(dyn.area_cell.device)
               for a in box.box_initial_state(mesh, 1)]
        forcing = box.box_forcing(mesh, 0.0, torch.float64, device)
        vp = make_vp_solver(cfg, n_newton=12, gmres_iters=40)
        state = init_velocity_state(mesh, torch.float64, device)
        for _ in range(3):
            state, d = vp(dyn, state, forcing, *ice)
        out[device] = (torch.stack([state.u_velocity,
                                    state.v_velocity]).cpu(),
                       float(d["vp_residual_norm"]))
    worst = rel_err(out["cuda"][0], out["cpu"][0])
    emit({"small_reference": {"mesh": "box 12 x 12, VP solver", "steps": 3,
                              "dtype": "float64",
                              "max_rel_err_vs_cpu": worst,
                              "vp_residual_norm": out["cuda"][1]}})
    if not worst <= 1e-9:
        fail(f"small VP box on the card differs from the CPU: {worst}")
    if not out["cuda"][1] < VP_RESIDUAL_LIMIT:
        fail(f"small VP box: residual norm {out['cuda'][1]} >= "
             f"{VP_RESIDUAL_LIMIT}")


def variant_reference_cases():
    """The small float64 models of the solver variants for
    `small_reference`."""
    opts = _options()
    rev = opts["revised EVP"]
    return {
        "icos subdiv 3, revised EVP": lambda dev: build_model(
            3, 3, 4, 8, torch.float64, dev, vel=rev),
        "icos subdiv 3, weak + upwind": lambda dev: build_model(
            3, 3, 4, 8, torch.float64, dev, vel=opts["weak"], upwind=True,
            zonal=True),
        "panel subdiv 3, upwind": lambda dev: build_model(
            3, 3, 4, 8, torch.float64, dev, panel=True, upwind=True,
            zonal=True),
        "icos subdiv 3, 2 blocks, revised EVP": lambda dev:
            build_sharded_model(3, 3, 4, 8, torch.float64, dev, 2, vel=rev),
    }


def small_reference(cases=None):
    """Small float64 models on the card (kernels) against the same models
    on the CPU (plain PyTorch): every velocity, stress and tracer field,
    for each of the four routes of the velocity solve, and the sphere
    split into 4 blocks (the one-subcycle kernel with exchanges); or the
    models of `cases` ({label: build(device)})."""
    from seaice_tpu_torch.convert import flatten_arrays, to_stacked_arrays
    cases = cases or {
        "icos subdiv 3": lambda dev: build_model(
            3, 3, 4, 8, torch.float64, dev),
        "panel subdiv 3, whole-loop kernel": lambda dev: build_model(
            3, 3, 4, 8, torch.float64, dev, panel=True),
        "panel subdiv 3, per-subcycle kernel": lambda dev: build_model(
            3, 3, 4, 8, torch.float64, dev, panel=True,
            fused_panel_loop=False),
        "box 24 x 24": lambda dev: build_box_model(
            24, 8, torch.float64, dev),
        "icos subdiv 3, 4 blocks": lambda dev: build_sharded_model(
            3, 3, 4, 8, torch.float64, dev, 4),
        "panel subdiv 3, full physics": lambda dev: full_physics_case(
            3, 3, 4, 8, torch.float64, dev),
    }
    for label, build in cases.items():
        outs = {}
        for device in ("cuda", "cpu"):
            model, state, forcing, *col = build(device)
            step = stepper(model, *col)
            for _ in range(2):
                state, _ = step(state, forcing)
            outs[device] = (to_stacked_arrays(state)
                            if isinstance(state, list)
                            else flatten_arrays(state))
        worst, noise = 0.0, []
        for k, ref in outs["cpu"].items():
            scale = float(np.abs(ref).max())
            if col and scale < NOISE:
                # rounding noise of the column physics (see NOISE)
                noise.append(k)
                if not float(np.abs(outs["cuda"][k]).max()) < NOISE:
                    fail(f"small model ({label}): {k} is noise on the CPU "
                         "and not on the card")
                continue
            worst = max(worst, float(np.abs(outs["cuda"][k] - ref).max()) /
                        max(scale, 1e-300))
        emit({"small_reference": {"mesh": label, "steps": 2,
                                  "dtype": "float64",
                                  "max_rel_err_vs_cpu": worst,
                                  "noise_fields": noise}})
        if not worst <= 1e-9:
            fail(f"small model ({label}) on the card differs from the "
                 f"CPU: {worst}")


# --- the partitioned model across processes ----------------------------------

# the ranks phase: RANKS processes sharing the one card under gloo (every
# halo staged through pinned host buffers), one NCCL process alone (world
# size 1: a real all-gather of card buffers); the spawned processes'
# limit, the exchanges timed, and the blocks of the f64 overlap check
RANKS, RANKS_STEPS, RANKS_TIMEOUT_S = 2, 2, 400.0
EXCHANGES_TIMED = 20
OVERLAP_F64_SHARDS = 2
RANKS_LABEL = ("two processes on one card (and one alone): the transport's "
               "cost, not a multi-card speed")


def ranks_inputs(workdir):
    """`full_physics_case`'s raw sphere, its initial state and forcing as
    numpy in workdir/inputs.npz, and the forcing files of its mesh:
    every process of the phase starts from these.  Returns (mesh,
    config, arrays)."""
    import os
    from seaice_tpu_torch.io.synthetic import write_forcing_files
    model, state, forcing, (atm, ocn, coszen) = full_physics_case(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, torch.float32, None,
        panel=False)
    arrays = {"tracer." + k: t.cpu().numpy()
              for k, t in state.tracers.items()}
    for tag, obj in (("forcing", forcing), ("atm", atm), ("ocn", ocn)):
        arrays.update({f"{tag}.{f.name}": getattr(obj, f.name).cpu().numpy()
                       for f in dataclasses.fields(obj)})
    arrays["coszen"] = coszen.cpu().numpy()
    np.savez(os.path.join(workdir, "inputs.npz"), **arrays)
    os.makedirs(os.path.join(workdir, "forcing"))
    write_forcing_files(os.path.join(workdir, "forcing"), model.mesh)
    return model.mesh, model.cfg, arrays


def ranks_state(sm, arrays):
    """The blocks' (states, forcing, column forcing) of `ranks_inputs`."""
    from seaice_tpu_torch.column.driver import AtmosForcing, OceanForcing
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing

    def group(tag, cls):
        return cls(**{f.name: arrays[f"{tag}.{f.name}"]
                      for f in dataclasses.fields(cls)})

    tr = {k[len("tracer."):]: a for k, a in arrays.items()
          if k.startswith("tracer.")}
    states = [st.replace(tracers=t) for st, t in
              zip(sm.init_state(), sm.scatter_cell_tree(tr))]
    col = tuple(sm.scatter_cell_tree(x) for x in (
        group("atm", AtmosForcing), group("ocn", OceanForcing),
        arrays["coszen"]))
    return states, sm.scatter_cell_tree(group("forcing", DynamicsForcing)), \
        col


def ranks_steps(sm, arrays, record=False):
    """RANKS_STEPS steps of the column-on model from `ranks_inputs`, the
    launch counts reset before and read after (the last step recorded
    where asked): (state, {"ms_per_step", "launches"}, the recorded
    calls, the whole fields)."""
    from seaice_tpu_torch.kernels import launch_counts, reset_launch_counts
    state, forcing, col = ranks_state(sm, arrays)
    step = stepper(sm, col)
    torch.cuda.synchronize()
    reset_launch_counts()
    ms, calls = [], None
    for i in range(RANKS_STEPS):
        t0 = time.perf_counter()
        if record and i == RANKS_STEPS - 1:
            state, calls = capture_kernel_inputs(sm, state, forcing, col)
        else:
            state, _ = step(state, forcing)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    out = {"ms_per_step": ms, "launches": launch_counts()}
    return state, out, calls, global_fields(sm, state)


def exchange_timing(sm):
    """The vertex halo of the K6 loops' shared velocity buffer
    (`exchange_uv`), EXCHANGES_TIMED times after one: ms per exchange (one
    a subcycle) by the host clock around each, synchronised (median,
    min, max), and the bytes the gloo-staged route copies between card
    and host per exchange.  Across ranks every rank calls it together."""
    k, nv = len(sm.blocks), sm.blocks[0].mesh.n_vertices
    uv = torch.randn((2, k * nv + 1), dtype=sm.dtype, device=sm.device)
    sm.exchange_uv(uv)
    torch.cuda.synchronize()
    b0, ms = sm.comm.bytes_staged, []
    for _ in range(EXCHANGES_TIMED):
        t0 = time.perf_counter()
        sm.exchange_uv(uv)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    plan = sm.plans["vertex"]
    return {"route": sm.comm.route, "halo_mode": sm.halo_mode,
            "exchange_ms_per_subcycle": float(np.median(ms)),
            "exchange_ms_min_max": [min(ms), max(ms)],
            "bytes_staged_per_exchange":
                (sm.comm.bytes_staged - b0) / EXCHANGES_TIMED,
            "rows_sent": plan.n_send, "rows_received": plan.n_recv,
            "rounds": plan.rounds, "export_rows": plan.n_rows}


def overlap_check(dtype, n_shards, halo_mode):
    """The interior/boundary overlap on the column-off raw sphere without
    metric terms (the overlap's configurations: with them it is off, as
    in the JAX package), from a state one step from rest: one subcycle
    of every block's K6 loop (the step's recorded `evp_subcycle_prepare`
    calls) under the overlap (`subcycle_exports`, then
    `ShardedSeaIceModel.evp_overlap`) against one without (K6, then the
    exchange), held to TOL[dtype]; the whole step, held to the larger of
    1e-7 and ten times the no-overlap step's response to its velocities
    and stresses one ulp larger (ROADMAP Queue 3, fault 2).  Relative to
    max |u|, |v| of the whole mesh."""
    import copy
    from seaice_tpu_torch.dynamics import evp as evp_mod
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    mesh, cfg, tree, ice, forcing = sphere_case(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES)
    cfg = dataclasses.replace(cfg, velocity=dataclasses.replace(
        cfg.velocity, include_metric_terms=False))
    t0 = time.perf_counter()
    sm = ShardedSeaIceModel(mesh, cfg, n_shards, dtype=dtype,
                            tracer_tree=tree, overlap=True,
                            halo_mode=halo_mode,
                            devices=f"cuda:{torch.cuda.current_device()}")
    built = time.perf_counter() - t0
    if not sm.overlap_enabled:
        fail("ranks: the overlap is not enabled on its configuration")
    plain = copy.copy(sm)
    plain.overlap = None
    state = sm.init_state(*ice)
    sforcing = sm.scatter_cell_tree(DynamicsForcing(**forcing))
    state, _ = stepper(plain)(state, sforcing)

    def rel(a, b):
        return max(float(np.abs(x - y).max()) /
                   max(float(np.abs(y).max()), 1e-300) for x, y in zip(a, b))

    # one subcycle of the recorded loops, with and without the overlap
    _, calls = capture_calls(lambda: stepper(plain)(state, sforcing))
    prep = calls["evp_subcycle_prepare"]
    over, exports = sharded_loops(sm, prep, dtype), []
    for lp, (args, kw), ov in zip(over, prep, sm.overlap):
        ft = args[0]
        (uo, vo, mass, mass_f, rhs_u, rhs_v, ocean_u, ocean_v, sv,
         area) = args[8:18]
        zero = torch.zeros_like(rhs_u)      # the surface tilt is in rhs
        exports.append(evp_mod.subcycle_exports(
            ov, ft, args[6], args[7], (uo, vo, mass, mass_f, rhs_u, rhs_v,
                                       zero, zero, ocean_u, ocean_v, sv,
                                       area, ft.denominator),
            kw["dt_elastic"], kw["damping_timescale"])(
                lp.u, lp.v, lp.t11, lp.t22, lp.t12))
    sm.evp_overlap(over, exports, {})
    base = sharded_loops(sm, prep, dtype)
    solve = {}
    sm.evp_subcycle(base, solve)
    sm.exchange_uv(solve["uv"])

    def uv_of(loops):
        return tuple(sm.gather_vertices([getattr(lp, k) for lp in loops]
                                        ).cpu().numpy() for k in "uv")

    one = rel(uv_of(over), uv_of(base))
    del calls, prep, over, base, solve

    ms = {}

    def uv(model, st, tag=None):
        step = stepper(model)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, _ = step(st, sforcing)
        torch.cuda.synchronize()
        if tag:
            ms[tag] = 1e3 * (time.perf_counter() - t1)
        return sm.gather_velocity(out)

    ulp = 1.0 + float(torch.finfo(dtype).eps)
    pert = [st.replace(velocity=st.velocity.replace(**{
        k: getattr(st.velocity, k) * ulp for k in (
            "u_velocity", "v_velocity", "stress11", "stress22",
            "stress12")})) for st in state]
    base = uv(plain, state, "without")
    whole = rel(uv(sm, state, "with"), base)
    resp = rel(uv(plain, pert), base)
    limit = max(1e-7, 10.0 * resp)
    out = {"dtype": str(dtype), "blocks": n_shards, "route": sm.comm.route,
           "halo_mode": halo_mode, "seconds_to_build": built,
           "one_subcycle_rel_err": one, "one_subcycle_limit": TOL[dtype],
           "step_rel_err": whole, "step_one_ulp_response": resp,
           "step_limit": limit, "max_speed": float(np.abs(base[0]).max()),
           "ms_per_step_with_and_without": [ms["with"], ms["without"]]}
    if not one <= TOL[dtype]:
        fail(f"ranks: one subcycle under the overlap differs from one "
             f"without, {one} > {TOL[dtype]} ({dtype})")
    if not whole <= limit:
        fail(f"ranks: a step under the overlap differs from one without, "
             f"{whole} > {limit} ({dtype})")
    return out


def gloo_rank(workdir, rank):
    """One of the RANKS processes sharing the card under gloo (the
    gloo-staged route), 2 of the SHARDS blocks each: the column-on raw
    sphere ring and all-gather, RANKS_STEPS steps each (the ring's last
    recorded: K6 against its plain version, `check_k6`, on this rank's
    blocks), two ShardedStandaloneRunner steps from the forcing files
    (the per-rank restart read back bitwise), one ShardedCoupledDriver
    interval, the f32 overlap check.  Returns (results, whole fields)."""
    import os
    from seaice_tpu_torch.coupled import ShardedCoupledDriver
    from seaice_tpu_torch.io import (load_sharded_checkpoint,
                                     read_restart_timestamp)
    from seaice_tpu_torch.io.forcing_reader import (core_atmos_from_files,
                                                    ncar_ocean_from_file)
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    from seaice_tpu_torch.run import RunStreams, ShardedStandaloneRunner
    with np.load(os.path.join(workdir, "inputs.npz")) as z:
        arrays = dict(z)
    mesh = icosahedral_mesh(SUBDIV)
    cfg = full_physics_config(N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES)
    res, fields = {"rank": rank}, {}
    dev = f"cuda:{torch.cuda.current_device()}"
    t0 = time.perf_counter()
    sm = ShardedSeaIceModel(mesh, cfg, SHARDS, dtype=torch.float32,
                            devices=dev)
    res["ring"] = {"seconds_to_build": time.perf_counter() - t0,
                   "route": sm.comm.route, "blocks": list(sm.block_ids)}
    state, steps, calls, fields["ring"] = ranks_steps(sm, arrays, True)
    res["ring"].update(steps)
    prep = calls["evp_subcycle_prepare"]
    if len(prep) != len(sm.blocks):
        fail(f"ranks: rank {rank} recorded {len(prep)} K6 loops")
    k6 = check_k6(sm, prep, 3, short_loop_from_response=True)
    res["k6"] = {k: v for k, v in k6.items() if "err" in k or k in (
        "short_loop_limit", "ms", "plain_ms", "kernel_ms", "bound_ms",
        "shapes")}
    del calls, prep

    # two runner steps from the forcing files, the restart after both
    fdir, rdir = (os.path.join(workdir, d) for d in ("forcing", "restart"))
    os.makedirs(rdir, exist_ok=True)
    names = ("core_sixhourly.nc", "core_monthly.nc", "ocean.nc")
    six, mon, ocn = (os.path.join(fdir, n) for n in names)
    runner = ShardedStandaloneRunner(
        sm, state, atmos_forcing=core_atmos_from_files(
            six, mon, mesh.lon_cell, mesh.lat_cell),
        ocean_forcing=ncar_ocean_from_file(ocn),
        streams=RunStreams(restart_dir=rdir, restart_interval=2 * 1800.0))
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(1)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    ts = read_restart_timestamp(rdir)
    back, clock = load_sharded_checkpoint(
        rdir, f"restart.{ts}", sm.part, sm.init_state(), shards=sm.block_ids)
    differ = [k for k, (a, b) in enumerate(zip(back, runner.state))
              if not all(torch.equal(x, y) for x, y in zip(
                  state_leaves(a), state_leaves(b)))]
    res["runner"] = {"ms_per_runner_step": ms, "restart": ts,
                     "clock": clock, "blocks_differing": differ}
    if differ:
        fail(f"ranks: rank {rank}'s blocks {differ} read back from the "
             "restart differ")

    # one coupled interval from the initial state
    states, _, _ = ranks_state(sm, arrays)
    drv = ShardedCoupledDriver(sm, states, coupling_interval=COUPLING_INTERVAL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export = drv.advance(coupled_imports(mesh.n_cells))
    res["coupled"] = {"ms_per_interval": 1e3 * (time.perf_counter() - t0),
                      "substeps": drv.n_substeps,
                      "export_fields": sorted(export)}
    fields["coupled"] = export
    if set(export) != COUPLED_EXPORTS - {"Fioi_taux", "Fioi_tauy"} or \
            not all(np.isfinite(v).all() for v in export.values()):
        fail(f"ranks: rank {rank}'s coupled export {sorted(export)} wrong "
             "or not finite")
    del state, runner, back, drv, states
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ag = ShardedSeaIceModel(mesh, cfg, SHARDS, dtype=torch.float32,
                            devices=dev, halo_mode="allgather")
    res["allgather"] = {"seconds_to_build": time.perf_counter() - t0}
    _, steps, _, fields["allgather"] = ranks_steps(ag, arrays)
    res["allgather"].update(steps)
    res["overlap"] = overlap_check(torch.float32, SHARDS, "ring")
    # the exchanges timed last, when the other processes of the phase
    # are most likely done
    res["ring"]["exchange"] = exchange_timing(sm)
    res["allgather"]["exchange"] = exchange_timing(ag)
    return res, fields


def nccl_rank(workdir, rank):
    """The NCCL process alone (world size 1): the column-on raw sphere in
    SHARDS blocks with the all-gather, RANKS_STEPS steps (each exchange
    a real NCCL all-gather of card buffers), and the f64 overlap check
    on OVERLAP_F64_SHARDS blocks with the all-gather (issued before K6,
    waited for after it)."""
    import os
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    with np.load(os.path.join(workdir, "inputs.npz")) as z:
        arrays = dict(z)
    mesh = icosahedral_mesh(SUBDIV)
    cfg = full_physics_config(N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES)
    t0 = time.perf_counter()
    sm = ShardedSeaIceModel(mesh, cfg, SHARDS, dtype=torch.float32,
                            halo_mode="allgather",
                            devices=f"cuda:{torch.cuda.current_device()}")
    res, fields = {"allgather": {"seconds_to_build":
                                 time.perf_counter() - t0,
                                 "route": sm.comm.route}}, {}
    _, steps, _, fields["allgather"] = ranks_steps(sm, arrays)
    res["allgather"].update(steps)
    res["overlap"] = overlap_check(torch.float64, OVERLAP_F64_SHARDS,
                                   "allgather")
    res["allgather"]["exchange"] = exchange_timing(sm)
    return res, fields


def state_leaves(st):
    v = st.velocity
    return [getattr(v, f.name) for f in dataclasses.fields(v)] + \
        [st.tracers[k] for k in sorted(st.tracers)]


def rank_worker(role, rank, world, workdir):
    """A spawned process of the ranks phase ("gloo": one of RANKS, or
    "nccl": alone): joins its process group (a file rendezvous in
    workdir), finds the kernels the parent built (it must not build
    any), runs its part and writes workdir/<role>.rank<rank>.json and
    .npz.  A failed check exits non-zero; the group's timeout ends a
    rank whose peer died."""
    import datetime
    import os
    import pickle
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl" if role == "nccl" else "gloo",
        init_method="file://" + os.path.join(workdir, f"rendezvous_{role}"),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        from seaice_tpu_torch.kernels import build
        build.build_cuda()
        build.get_native_stencil_lib()
        if build.build_log:
            fail(f"ranks: {role} rank {rank} built {sorted(build.build_log)}")
        res, fields = (gloo_rank if role == "gloo" else nccl_rank)(workdir,
                                                                  rank)
        base = os.path.join(workdir, f"{role}.rank{rank}")
        with open(base + ".pkl", "wb") as f:
            pickle.dump(fields, f)
        with open(base + ".json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def ranks_phase(workdir, card, kernels):
    """The partitioned model across processes (`parallel/comm.py`): RANKS
    spawned processes share the card under gloo, each holding 2 of the
    SHARDS blocks, and one NCCL process holds all of them (world size 1;
    NCCL refuses two ranks on one card, so NCCL between cards is not
    run here); each starts from `ranks_inputs` after the kernels are
    built.  Here: the same model in one process, RANKS_STEPS steps with
    each halo mode, the reference every run of that mode is held to
    bitwise (ring and all-gather on the ranks, the NCCL all-gather); the
    ranks' coupled exports equal each other.  A failed or hung process
    fails the phase."""
    import multiprocessing
    import os
    import pickle
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    t_phase = time.perf_counter()
    mesh, cfg, arrays = ranks_inputs(workdir)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_worker, args=("gloo", r, RANKS,
                                                   workdir))
             for r in range(RANKS)]
    procs.append(ctx.Process(target=rank_worker,
                             args=("nccl", 0, 1, workdir)))
    for p in procs:
        p.start()
    try:
        # the one-process runs of both halo modes (the modes differ in
        # the padded halo slots, which the column's convergence loops of
        # a block see)
        ref, want, models = {}, {}, {}
        for mode in ("ring", "allgather"):
            models[mode] = ShardedSeaIceModel(
                mesh, cfg, SHARDS, dtype=torch.float32, halo_mode=mode)
            _, ref[mode], _, want[mode] = ranks_steps(models[mode], arrays)
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while any(p.is_alive() for p in procs):
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                fail(f"ranks: a process exited with {bad} or the phase "
                     f"passed {RANKS_TIMEOUT_S} s")
            time.sleep(0.2)
        if any(p.exitcode != 0 for p in procs):
            fail(f"ranks: exit codes {[p.exitcode for p in procs]}")
        for mode, sm in models.items():
            ref[mode]["exchange"] = exchange_timing(sm)
        del models, sm
        torch.cuda.empty_cache()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)

    def load(role, rank):
        base = os.path.join(workdir, f"{role}.rank{rank}")
        with open(base + ".json") as f, open(base + ".pkl", "rb") as g:
            return json.load(f), pickle.load(g)

    gloo = [load("gloo", r) for r in range(RANKS)]
    nccl = load("nccl", 0)
    runs = {(f"gloo rank {r} {mode}", mode): g[1][mode]
            for r, g in enumerate(gloo) for mode in ("ring", "allgather")}
    runs[("nccl allgather", "allgather")] = nccl[1]["allgather"]
    # NaN where NaN: under the all-gather a padded halo slot carries a real
    # cell's state (ROADMAP Queue 3, fault 19)
    differ = {label: sorted(k for k in want[mode] if not np.array_equal(
                  got[k], want[mode][k], equal_nan=True))
              for (label, mode), got in runs.items()}
    nans = {f"one process {mode}": sorted(k for k, a in want[mode].items()
                                          if np.isnan(a).any())
            for mode in want}
    exports = [g[1]["coupled"] for g in gloo]
    export_differ = sorted(k for k in exports[0]
                           if not np.array_equal(exports[0][k], exports[1][k]))
    counts = {}
    for res, _ in gloo + [nccl]:
        for mode in ("ring", "allgather"):
            for name, n in res.get(mode, {}).get("launches", {}).items():
                counts[name] = counts.get(name, 0) + n
    n_dyn = cfg.velocity.dynamics_subcycle_number
    want_counts = {"evp_subcycle_step": N_SUBCYCLES * n_dyn * RANKS_STEPS,
                   "integrate_fluxes_cuda": n_dyn * RANKS_STEPS}
    wrong = {}
    for label, res in [(f"gloo rank {r}", g[0]) for r, g in enumerate(gloo)] \
            + [("nccl", nccl[0])]:
        blocks = SHARDS if label == "nccl" else SHARDS // RANKS
        for mode in ("ring", "allgather"):
            got = res.get(mode, {}).get("launches")
            if got is None:
                continue
            exp = {k: v * (blocks if k == "integrate_fluxes_cuda" else 1)
                   for k, v in want_counts.items()}
            if any(got.get(k, 0) != exp.get(k, 0)
                   for k in set(got) | set(exp)):
                wrong[f"{label} {mode}"] = got
    by_transport = {f"in-process {mode}": ref[mode]["exchange"]
                    for mode in ref}
    for r, (res, _) in enumerate(gloo):
        for mode in ("ring", "allgather"):
            by_transport[f"gloo-staged {mode}, rank {r}"] = \
                res[mode]["exchange"]
    by_transport["nccl allgather, world size 1"] = \
        nccl[0]["allgather"]["exchange"]
    emit({"ranks": {
        "label": RANKS_LABEL, "card": card, "blocks": SHARDS,
        "ranks": RANKS, "steps": RANKS_STEPS,
        "ms_per_step": {**{f"one process {mode}": ref[mode]["ms_per_step"]
                           for mode in ref}, **{
            f"gloo rank {r} {mode}": g[0][mode]["ms_per_step"]
            for r, g in enumerate(gloo) for mode in ("ring", "allgather")},
            "nccl allgather": nccl[0]["allgather"]["ms_per_step"]},
        "exchange_by_transport": by_transport,
        "bitwise_one_process": {k: not v for k, v in differ.items()},
        "fields_with_nan": nans,
        "fields_differing": {k: v for k, v in differ.items() if v},
        "launches": {"one process ring": ref["ring"]["launches"], **{
            f"gloo rank {r}": g[0]["ring"]["launches"]
            for r, g in enumerate(gloo)},
            "nccl": nccl[0]["allgather"]["launches"]},
        "runner": [g[0]["runner"] for g in gloo],
        "coupled": [g[0]["coupled"] for g in gloo],
        "coupled_exports_equal": not export_differ,
        "overlap": {"gloo f32": [g[0]["overlap"] for g in gloo],
                    "nccl f64": nccl[0]["overlap"]},
        "builds": {f"gloo rank {r}": {m: g[0][m]["seconds_to_build"]
                                      for m in ("ring", "allgather")}
                   for r, g in enumerate(gloo)},
        "phase_seconds": time.perf_counter() - t_phase}})
    emit({"ranks_k6_against_plain": {"card": card,
                                     **{f"gloo rank {r}": g[0]["k6"]
                                        for r, g in enumerate(gloo)}}})
    if nans["one process ring"]:
        fail(f"ranks: the ring run is not finite: {nans}")
    if any(differ.values()):
        fail(f"ranks: runs differ from the one-process run: "
             f"{ {k: v for k, v in differ.items() if v} }")
    if export_differ:
        fail(f"ranks: the ranks' coupled exports differ in {export_differ}")
    if wrong:
        fail(f"ranks: launch counts {wrong}, expected per rank "
             f"{want_counts} (K2 once a block)")
    add_launches(kernels, "ranks: gloo ring, gloo all-gather, nccl", counts)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--profile", action="store_true",
                    help="also print where a panel-sphere step's time goes "
                    "and trace a sharded-sphere step")
    ap.add_argument("--drift", action="store_true",
                    help="also print how far float64 evaluations of the "
                    "EVP loop drift apart on the panel sphere")
    ap.add_argument("--five-day", action="store_true",
                    help=f"the file-driven run's full gate: "
                    f"{FIVE_DAY_STEPS} steps (five days), the restart "
                    f"halfway, in place of {FILE_STEPS}")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    from seaice_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.build_cuda()
    build.get_native_stencil_lib()
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "sources": sorted(build.build_log),
                    "ptxas": {k: [ln.strip() for ln in v.splitlines()
                                  if "registers" in ln or "spill" in ln
                                  or "Function properties" in ln][:80]
                              for k, v in build.build_log.items()},
                    "ptxas_k1": ptxas_of("evp_unstructured", "evp_loop_kernel"),
                    "ptxas_k4": ptxas_of("evp_raster", "raster_loop_kernel")}})
    kernels = {}

    def model_line(label, model, t0, **extra):
        mesh = getattr(model, "global_mesh", None) or model.mesh
        emit({"model": dict({"path": label,
                             "seconds_to_build": time.perf_counter() - t0,
                             "cells": mesh.n_cells, "dtype": "float32",
                             "tracers": model.tree.names}, **extra)})

    # --- raw sphere: K1 + K2.  One step from rest to spin up, a second
    # one that is recorded, then the path itself (one step) ---
    t0 = time.perf_counter()
    model, state, forcing = build_model(SUBDIV, N_CATEGORIES, N_ICE_LAYERS,
                                        N_SUBCYCLES, torch.float32, None)
    model_line("raw sphere", model, t0)
    raw = (model, state, forcing)            # for the sharded comparison
    step = model.make_step()
    state, _ = step(model.tensors, state, forcing)
    state, calls = capture_kernel_inputs(model, state, forcing)
    if set(calls) != {"evp_subcycle_loop", "integrate_fluxes_cuda"}:
        fail(f"raw sphere: the step called {sorted(calls)}")
    kernels["evp_subcycle_loop"] = check_loop(
        "evp_subcycle_loop", calls["evp_subcycle_loop"][0], args.reps)
    k1_against_k6(calls["evp_subcycle_loop"][0], min(args.reps, 3))
    kernels["integrate_fluxes_cuda"] = check_k2(
        calls["integrate_fluxes_cuda"][0], args.reps)
    del calls
    state, counts, _ = main_path(
        "raw sphere", model, state, forcing, 1,
        {"evp_subcycle_loop": 1, "integrate_fluxes_cuda": 1})
    add_launches(kernels, "raw sphere", counts)
    del model, state, forcing, step
    torch.cuda.empty_cache()

    # --- sharded sphere: the raw sphere in SHARDS blocks on the card, K6
    # + K2.  Two steps from rest against the unsharded step, the second
    # recorded, then the path itself (one step) ---
    t0 = time.perf_counter()
    smodel, sstate, sforcing = build_sharded_model(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, torch.float32, None,
        SHARDS)
    model_line("sharded sphere", smodel, t0, blocks=[
        {"cells": b.mesh.n_cells, "cells_owned": b.n_cells_owned,
         "cells_padded": int((b.cell_global < 0).sum()),
         "vertices": b.mesh.n_vertices,
         "vertices_owned": b.n_vertices_owned,
         "vertices_padded": int((b.vertex_global < 0).sum()),
         "edges": b.mesh.n_edges} for b in smodel.part.blocks],
        halo_rounds=len(smodel.halo_perms))
    from seaice_tpu_torch.convert import flatten_arrays
    for s, t in enumerate(smodel.tensors):
        bad = [k for k, a in flatten_arrays(t).items()
               if a.dtype.kind == "f" and not np.isfinite(a).all()]
        if bad:
            fail(f"sharded sphere, block {s}: non-finite tensors {bad}")
    sstate, calls, k1_k6_gap = sharded_against_unsharded(
        smodel, sstate, sforcing, *raw, min(args.reps, 3))
    del raw
    if set(calls) != {"evp_subcycle_prepare", "integrate_fluxes_cuda"} \
            or len(calls["evp_subcycle_prepare"]) != SHARDS:
        fail(f"sharded sphere: the step called "
             f"{ {k: len(v) for k, v in calls.items()} }")
    kernels["evp_subcycle_step"] = check_k6(
        smodel, calls["evp_subcycle_prepare"], args.reps)
    k2_on_path("sharded sphere", calls["integrate_fluxes_cuda"])
    del calls
    sstate, counts, sharded_ms = main_path(
        "sharded sphere", smodel, sstate, sforcing, 1,
        {"evp_subcycle_step": N_SUBCYCLES, "integrate_fluxes_cuda": SHARDS})
    add_launches(kernels, "sharded sphere", counts)
    if args.profile:
        trace_steps("sharded sphere", smodel, sstate, sforcing, sharded_ms)
    del smodel, sstate, sforcing
    torch.cuda.empty_cache()

    # --- panel sphere: K3 + K2, then K5 ---
    t0 = time.perf_counter()
    model, state, forcing = build_model(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, torch.float32, None,
        panel=True)
    model_line("panel sphere", model, t0)
    if args.drift:
        loop_drift(model, state, forcing)      # the first steps from rest
    step = model.make_step()
    state, _ = step(model.tensors, state, forcing)
    state, calls = capture_kernel_inputs(model, state, forcing)
    if set(calls) != {"evp_panel_loop", "integrate_fluxes_cuda"}:
        fail(f"panel sphere: the step called {sorted(calls)}")
    kernels["evp_panel_loop"] = check_loop(
        "evp_panel_loop", calls["evp_panel_loop"][0], args.reps)
    k3_against_k1(calls["evp_panel_loop"][0], model.tensors.dynamics, args.reps,
                  kernels["evp_panel_loop"]["loop_rel_err_f64_limit"])
    k2_on_path("panel sphere", calls["integrate_fluxes_cuda"])
    del calls
    state, counts, step_ms = main_path(
        "panel sphere", model, state, forcing, args.steps,
        {"evp_panel_loop": 1, "integrate_fluxes_cuda": 1})
    add_launches(kernels, "panel sphere", counts)
    if args.profile:
        profile(model, state, forcing, step_ms)
    # the same model, the per-subcycle route: same tensors, another config
    import copy
    model5 = copy.copy(model)
    model5.cfg = dataclasses.replace(model.cfg, velocity=dataclasses.replace(
        model.cfg.velocity, use_fused_panel_loop=False))
    state5, calls = capture_kernel_inputs(model5, state, forcing)
    if set(calls) != {"panel_cell_step", "integrate_fluxes_cuda"}:
        fail(f"panel sphere, per-subcycle route: the step called "
             f"{sorted(calls)}")
    kernels["panel_cell_step"] = check_k5(calls["panel_cell_step"][0],
                                          args.reps)
    del calls, state5
    _, counts, route_ms = main_path(
        "panel sphere, per-subcycle route", model5, state, forcing, 1,
        {"panel_cell_step": N_SUBCYCLES, "integrate_fluxes_cuda": 1})
    add_launches(kernels, "panel sphere, per-subcycle route", counts)
    kernels["panel_cell_step"]["route_ms_per_step"] = route_ms
    del model, model5, state, forcing, step
    torch.cuda.empty_cache()
    kernels["evp_panel_loop"]["qu60"] = k3_at_qu60_scale(args.reps)

    # --- raster box: K4 ---
    t0 = time.perf_counter()
    model, state, forcing = build_box_model(BOX_NX, N_SUBCYCLES,
                                            torch.float32, None)
    model_line("raster box", model, t0)
    step = model.make_step()
    state, _ = step(model.tensors, state, forcing)
    state, calls = capture_kernel_inputs(model, state, forcing)
    if set(calls) != {"evp_raster_loop"}:       # the box test has no transport
        fail(f"raster box: the step called {sorted(calls)}")
    kernels["evp_raster_loop"] = check_loop(
        "evp_raster_loop", calls["evp_raster_loop"][0], args.reps)
    del calls
    state, counts, _ = main_path(
        "raster box", model, state, forcing, args.steps,
        {"evp_raster_loop": 1})
    add_launches(kernels, "raster box", counts)
    del model, state, forcing, step
    torch.cuda.empty_cache()

    # --- full-physics panel sphere (bench_full.py's workload): the
    # column physics around K3 + K2.  One step to spin up, a second one
    # that is recorded (K3 with the Rothrock strength and K2 with the
    # column's tracer table, each against its plain version), then the
    # path (args.steps steps), the host syncs of one step (the step's
    # phases are its spans, in `trace_steps` with --profile), and the
    # float32 state against the same steps in float64 ---
    t0 = time.perf_counter()
    model, state, forcing, col = full_physics_case(
        SUBDIV, N_CATEGORIES, N_ICE_LAYERS, N_SUBCYCLES, torch.float32, None)
    model_line("full-physics panel sphere", model, t0)
    step = stepper(model, col)
    state, _ = step(state, forcing)
    state, calls = capture_kernel_inputs(model, state, forcing, col)
    if set(calls) != {"evp_panel_loop", "integrate_fluxes_cuda"}:
        fail(f"full-physics panel sphere: the step called {sorted(calls)}")
    k3 = check_loop("evp_panel_loop", calls["evp_panel_loop"][0],
                    min(args.reps, 3))
    emit({"full_physics_k3_against_plain": {
        k: v for k, v in k3.items()
        if "err" in k or k in ("ms", "plain_ms", "bound_ms")}})
    k2_on_path("full-physics panel sphere", calls["integrate_fluxes_cuda"])
    del calls
    state, fp_ms, iters, _, counts, _ = full_physics_path(
        "full-physics panel sphere", model, state, forcing, col, args.steps)
    add_launches(kernels, "full-physics panel sphere", counts)
    f32_fields = global_fields(model, state)
    _, syncs = count_host_syncs(lambda: step(state, forcing))
    emit({"full_physics_split": {
        "card": card, "ms_per_step_untraced": fp_ms,
        "host_syncs_per_step": syncs,
        "thermo_iterations_per_step": iters}})
    if args.profile:
        trace_steps("full-physics panel sphere", model, state, forcing,
                    fp_ms, col=col)
    del model, state, forcing, col, step
    torch.cuda.empty_cache()
    f32_against_f64(f32_fields, 2 + args.steps)
    del f32_fields
    torch.cuda.empty_cache()

    # --- the file-driven run (K1 + K2) and the sharded full-physics step
    # (K6 + K2), their files written into a temporary directory ---
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        inputs = file_inputs(workdir)
        counts = file_driven_run(
            inputs, FIVE_DAY_STEPS if args.five_day else FILE_STEPS,
            args.reps, card, workdir)
        add_launches(kernels, "file-driven run", counts)
        del inputs
        counts, rcounts = sharded_full_physics(workdir, k1_k6_gap, card,
                                               min(args.reps, 3))
        add_launches(kernels, "sharded full physics", counts)
        add_launches(kernels, "sharded runner", rcounts)
        # the namelist and coupled entry points (K1 + K2, K6 + K2)
        counts, model = namelist_run(workdir, args.reps, card)
        add_launches(kernels, "namelist run", counts)
        counts, state0, fields = coupled_run(model, args.reps, card)
        add_launches(kernels, "coupled run", counts)
        add_launches(kernels, "sharded coupled run", sharded_coupled_run(
            model, state0, fields, min(args.reps, 3), card))
        del state0, model
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # the column's thermodynamics, surface and snow options (paths a to
    # c), its pond and radiation options (paths d and e), fault 16's
    # configuration, and the port's example scripts and entry file
    bases = option_bases()
    column_options(bases, args.reps, card, kernels, syncs)
    pond_radiation_options(bases, args.reps, card, kernels, syncs)
    bgc_options(bases, args.reps, card, kernels, syncs)
    fault16(bases, card, kernels)
    del bases
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    try:
        entry_scripts(card, kernels, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # the partitioned model across processes (gloo ranks sharing the
    # card, an NCCL rank alone)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        ranks_phase(workdir, card, kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # the solver variants and transport (paths a to f), then their small
    # float64 models on the card against the CPU
    solver_variants(args.reps, card, kernels)
    small_reference()
    small_coupled_reference()
    small_reference(variant_reference_cases())
    small_vp_reference()

    order = ("evp_subcycle_loop", "integrate_fluxes_cuda", "evp_panel_loop",
             "panel_cell_step", "evp_raster_loop", "evp_subcycle_step")
    for name in order:
        if not kernels[name].get("launches", 0) > 0:
            fail(f"{name} was launched no time on its path")
    emit({"kernels": [kernels[name] for name in order]})
    print(card, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
