#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`seaice_tpu_torch`).

Run `python3 chip_smoke.py` from the repository root on a machine with one
NVIDIA Hopper GPU, PyTorch with CUDA and `nvcc`.  It

  1. builds the CUDA kernels from `seaice_tpu_torch/csrc/` (one nvcc per
     source, in parallel) and the host remap-stencil library;
  2. drives four paths at full width through `SeaIceModel.make_step()` and
     `ShardedSeaIceModel.make_step()`, float32, column package off:
       raw sphere   raw icosahedral subdiv 6 (40,962 cells), 5 categories,
                    7 ice + 1 snow layers, full enthalpy tracer tree, EVP
                    with 120 subcycles and metric terms, incremental
                    remapping: the any-connectivity loop K1 + the flux
                    kernel K2;
       panel sphere the same model on the panel-reordered mesh: the
                    whole-loop panel kernel K3 + K2, and with
                    `use_fused_panel_loop=False` the per-subcycle cell
                    kernel K5 (bound once per solve, 120 launches);
       sharded sphere the raw sphere split into 4 blocks on the one card,
                    stepped in lockstep: the one-subcycle kernel K6 (one
                    call per subcycle for all 4 blocks, two launches, the
                    vertex halo exchanged between calls) + K2 per block;
       raster box   the 168 x 168 box test, raster-ordered, one category:
                    the raster loop K4;
  3. holds each kernel against its plain PyTorch version on the card, on
     the very tensors the step hands it (float32, and the same tensors
     cast to float64), and times both with CUDA events; reports K3's
     launches per call and the share of its basis held in shared memory,
     the C call alone (`kernel_ms`) of every kernel, the CUDA kernels per
     call of K2, K5 and K6 (torch.profiler; more than 3, 1 and 2 fail),
     K5's registers and spills, K6's host time per call; runs K1 on K3's
     inputs (two kernels, one function) and reports their times and their
     distance; holds the sharded step against the unsharded one;
  4. for each path sets the launch counts to 0, takes a few steps, reads
     the counts and checks the state (finite, |u| bounded, every tracer
     product conserved);
  5. checks small float64 models (raw sphere, panel sphere by both routes,
     box, sphere in 4 blocks) on the card against the same models on the
     CPU (plain PyTorch throughout).

One JSON object per line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase exits non-zero.  Without a CUDA device it prints no
result and exits 2.
"""

import argparse
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
                fused_panel_loop=None):
    """The sphere configuration: mesh, config, tracer tree, and the global
    initial ice (polar caps) and forcing (analytic wind) as numpy."""
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
            use_fused_panel_loop=fused_panel_loop),
        advection=C.AdvectionConfig(),
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
    uw, vw = latlon_vector_rotation_forward(
        u_t, v_t, mesh.x_cell, mesh.y_cell, mesh.z_cell)
    z = np.zeros(nc)
    forcing = dict(u_air_velocity=uw, v_air_velocity=vw,
                   air_density=np.full(nc, 1.3), u_ocean_velocity=z,
                   v_ocean_velocity=z, sea_surface_tilt_u=z,
                   sea_surface_tilt_v=z, land_ice_mask=z)
    return mesh, cfg, tree, (area, area * mids, area * 0.05), forcing


def build_model(subdiv, n_cat, n_ice, n_sub, dtype, device, panel=False,
                fused_panel_loop=None):
    """The sphere model: raw icosahedral mesh, or panel-reordered."""
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing
    from seaice_tpu_torch.model import SeaIceModel
    mesh, cfg, tree, ice, forcing = sphere_case(
        subdiv, n_cat, n_ice, n_sub, panel, fused_panel_loop)
    model = SeaIceModel(mesh, cfg, dtype=dtype, device=device,
                        tracer_tree=tree)
    device = model.device          # the card, where None was asked for
    state = model.init_state(*ice)
    forcing = DynamicsForcing(**{
        k: torch.as_tensor(v).to(device=device, dtype=dtype)
        for k, v in forcing.items()})
    return model, state, forcing


def build_sharded_model(subdiv, n_cat, n_ice, n_sub, dtype, device,
                        n_shards):
    """The raw sphere split into n_shards blocks on one device."""
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing
    from seaice_tpu_torch.parallel import ShardedSeaIceModel
    mesh, cfg, tree, ice, forcing = sphere_case(subdiv, n_cat, n_ice, n_sub)
    model = ShardedSeaIceModel(mesh, cfg, n_shards, dtype=dtype,
                               devices=device, tracer_tree=tree)
    return (model, model.init_state(*ice),
            model.scatter_cell_tree(DynamicsForcing(**forcing)))


def stepper(model):
    """step(state, forcing) -> (state, diags) of a SeaIceModel or a
    ShardedSeaIceModel (whose state and forcing are lists of blocks)."""
    step = model.make_step()
    if hasattr(model, "halo"):
        return lambda state, forcing: step(model.tensors, model.halo, state,
                                           forcing)
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


def capture_kernel_inputs(model, state, forcing):
    """Take one step with recording wrappers in place of the kernel
    wrappers; returns (state after the step, {kernel name: [(args, kwargs)
    of each call in that step]})."""
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
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, recorder(name, fn))
    try:
        state, _ = stepper(model)(state, forcing)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    return state, rec


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


def check_loop(name, call, reps):
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
    perturbation (`loop_rel_err_f64_plain_one_ulp`), and the float32
    kernel's distance to the float64 plain version to twice the float32
    plain version's own distance to it (measured: at most 1.6 times).  A
    SHORT loop of
    SHORT_LOOP subcycles, where the amplification has barely begun, holds
    the float32 kernel to the float32 plain version at SHORT_LOOP_TOL, so
    that a fault of the float32 instantiation in the loop (carrying state
    from one subcycle to the next) is caught as well.  `max_abs_err` and
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

    kws = dict(kw, n_subcycles=SHORT_LOOP)
    e = errs(kernel(*a[torch.float32], **kws),
             plain(*a[torch.float32], **kws))
    out["short_loop_subcycles"] = SHORT_LOOP
    out["short_loop_rel_err_f32"] = e
    if not max(e.values()) <= SHORT_LOOP_TOL:
        fail(f"{tag0} f32, {SHORT_LOOP} subcycles: kernel and plain "
             f"version disagree, {e} > {SHORT_LOOP_TOL}")

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
    for n in names:
        if not ek[n] <= 2.0 * ep[n] + 1e-5:
            fail(f"{tag0} f32, whole loop, {n}: kernel is {ek[n]} from the "
                 f"f64 plain version, the f32 plain version {ep[n]}")

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
    if name == "evp_panel_loop":
        out["launch_f32"] = kernel.last_launch
        kernel(*a[torch.float64], **kw)
        out["launch_f64"] = kernel.last_launch
        out["kernel_ms"] = time_ms(k3_c_call(a32, kw), reps)
        out["kernel_ms_f64"] = time_ms(k3_c_call(a[torch.float64], kw), reps)
    if name == "evp_raster_loop":
        out["kernel_ms"] = time_ms(k4_c_call(a32, kw), reps)
    if name == "evp_subcycle_loop":
        out["kernel_ms"] = time_ms(k1_c_call(a32, kw), reps)
    return out


def k1_c_call(args, kw):
    """The C call of K1 alone (its loop state, checks and scratch fixed
    beforehand by `evp_subcycle_prepare`; each call carries the loop
    further)."""
    from seaice_tpu_torch.dynamics import cuda_unstructured as K1
    loop = K1.evp_subcycle_prepare(*args, **{
        k: v for k, v in kw.items() if k != "n_subcycles"})
    fn = K1._c_function(args[1].dtype)

    def call():
        if fn(*loop.shape, int(kw["n_subcycles"]), int(loop.include_metric),
              *loop.c_tail) != 0:
            fail("K1: the C call returned an error")
    return call


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


def k2_against_plain(call):
    """K2 on one captured call against `remap.integrate_fluxes` on the same
    tensors, float32 and float64, each field held to TOL of its max.
    Returns {tag: (max rel err, rel err by field, max abs err)}."""
    from seaice_tpu_torch.transport.cuda_flux import integrate_fluxes_cuda
    from seaice_tpu_torch.transport.remap import integrate_fluxes
    args, kw = call
    res = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        a = cast(args, dtype)
        got = integrate_fluxes_cuda(*a, **kw)
        torch.cuda.synchronize()
        want = integrate_fluxes(*a, **kw)
        torch.cuda.synchronize()
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
                                   for n in want))
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
    for tag, (err, errs, _) in res.items():
        out["max_rel_err_" + tag] = err
        out["rel_err_by_field_" + tag] = errs
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
    out["plain_ms"] = time_ms(lambda: integrate_fluxes(*a, **kw), reps)
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


def sharded_loops(model, calls, dtype):
    """K6's loops of every block, begun from the step's captured
    `evp_subcycle_prepare` calls cast to dtype."""
    from seaice_tpu_torch.dynamics.cuda_unstructured import (
        evp_subcycle_prepare)
    return [evp_subcycle_prepare(*cast(a, dtype), **kw) for a, kw in calls]


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


def check_k6(model, calls, reps):
    """K6, the one-subcycle EVP kernel, on the captured inputs of every
    block of the sharded sphere: one call advances all the blocks.

    One call on all blocks against `evp_subcycle_step_plain` block by
    block on the same tensors, float32 and float64: held to TOL.
    SHORT_LOOP subcycles of all blocks with the exchange after each,
    float32 kernel against float32 plain: SHORT_LOOP_TOL.  The whole loop
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

    def run(dtype, step, n, scale=None):
        loops = sharded_loops(model, calls, dtype)
        if scale is not None:
            for lp in loops:
                for t in evp_subcycle_finish(lp):
                    t.mul_(scale)
        return run_sharded_loops(model, loops, step, n)

    p32 = run(torch.float32, plain_steps, SHORT_LOOP)
    e = errs(run(torch.float32, evp_subcycle_step, SHORT_LOOP), p32)
    out["short_loop_subcycles"] = SHORT_LOOP
    out["short_loop_rel_err_f32"] = e
    # for scale: the f32 plain loop's own response to one f32 ulp
    out["short_loop_rel_err_f32_plain_one_ulp"] = errs(run(
        torch.float32, plain_steps, SHORT_LOOP, 1.0 + 2.0 ** -23), p32)
    if not max(e.values()) <= SHORT_LOOP_TOL:
        fail(f"K6 f32, {SHORT_LOOP} subcycles with exchanges: kernel and "
             f"plain version disagree, {e} > {SHORT_LOOP_TOL}")
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
    is.  Returns the sharded state after two steps and that record."""
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
           "max_rel_diff": worst, "one_ulp_response": resp,
           "limit": limit, "unsharded_ms": [t[0], t[3]],
           "sharded_ms": [t[1], t[2]]}
    emit({"sharded_against_unsharded": out})
    if not worst <= limit:
        fail(f"sharded and unsharded steps disagree: {worst} > {limit}")
    return sstate, calls


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
    if counts["evp_panel_loop"] and \
            inner.get("evp_panel_loop") != counts["evp_panel_loop"]:
        fail(f"{label}: K3 made {inner.get('evp_panel_loop')} kernel "
             f"launches in {counts['evp_panel_loop']} calls, not one each")
    if counts["evp_subcycle_step"] and \
            inner.get("evp_subcycle_step") != 2 * counts["evp_subcycle_step"]:
        fail(f"{label}: K6 made {inner.get('evp_subcycle_step')} kernel "
             f"launches in {counts['evp_subcycle_step']} calls, not two each")
    return state, counts, out["ms_per_step_median"]


def profile(model, state, forcing, step_ms):
    """Where a panel-sphere step's time goes (--profile): host-clock
    milliseconds of each phase with a synchronise after it, then
    `trace_steps`."""
    from seaice_tpu_torch.dynamics import evp
    from seaice_tpu_torch.transport import remap as R
    from seaice_tpu_torch.transport.cuda_flux import integrate_fluxes_cuda
    cfg, tree, t = model.cfg, model.tree, model.tensors
    lay = getattr(model.mesh, "panel_layout", None)
    vel_step = evp.make_velocity_solver(
        cfg, panel_n=lay.N if lay is not None else None,
        panel_mesh=model.mesh if lay is not None else None)
    tr = dict(state.tracers)
    phases = {}

    def timed(name, fn, reps=5):
        out = fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        phases[name] = float(np.median(ts))
        return out

    vel, _ = timed("velocity_solve", lambda: vel_step(
        t.dynamics, state.velocity, forcing, tr["iceAreaCategory"],
        tr["iceVolumeCategory"], tr["snowVolumeCategory"]))
    coc, cocm = t.mesh.cells_on_cell, t.mesh.cells_on_cell_mask
    fields = R.to_transport_fields(tree, tr)
    mask_cell, masks = R.make_masks(tree, fields)
    recon = timed("remap_reconstruct", lambda: R.reconstruct_fields(
        tree, fields, masks, mask_cell, t.remap, coc, cocm, monotonic=True))
    dpx, dpy = R.departure_points(vel.u_velocity, vel.v_velocity,
                                  cfg.dynamics_timestep)
    tris = timed("remap_departure_triangles",
                 lambda: R.find_departure_triangles(
                     t.remap, dpx, dpy, model.mesh.vertex_degree))
    cell, xq, yq, area = timed(
        "remap_quadrature_points",
        lambda: R.triangles_to_cell_coords(t.remap, tris))
    fluxes = timed("remap_flux_integration", lambda: integrate_fluxes_cuda(
        tree, recon, t.remap, cell, xq, yq, area, tris["mask_edge"]))
    timed("remap_update", lambda: R.zap_small_mass(
        tree, R.update_mass_and_tracers(tree, fields, fluxes, t.remap,
                                        t.area_cell)))

    trace_steps("panel sphere", model, state, forcing, step_ms, phases)


def trace_steps(label, model, state, forcing, step_ms, phases=None, n=2):
    """A torch.profiler trace of n whole steps of a path: device-busy ms
    and CUDA kernels per step, the device's idle share (1 - busy over
    `step_ms`, the path's UNTRACED median ms per step of this run: tracing
    slows the host severalfold, so the traced wall time would overstate
    the idle share), the package's own kernels and the top device
    kernels."""
    from torch.profiler import ProfilerActivity
    step = stepper(model)
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
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
        for name in ("evp_cell_kernel", "evp_vertex_kernel",
                     "evp_cell_blocks_kernel", "evp_vertex_blocks_kernel",
                     "panel_loop_kernel", "panel_cell_kernel",
                     "ir_flux_kernel"):
            if name + "<" in key:
                own[name] = [ms / n, count / n]
    emit({"profile": {
        "path": label, "phase_ms": phases, "traced_steps": n,
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


def small_reference():
    """Small float64 models on the card (kernels) against the same models
    on the CPU (plain PyTorch): every velocity, stress and tracer field,
    for each of the four routes of the velocity solve, and the sphere
    split into 4 blocks (the one-subcycle kernel with exchanges)."""
    from seaice_tpu_torch.convert import flatten_arrays, to_stacked_arrays
    cases = {
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
    }
    for label, build in cases.items():
        outs = {}
        for device in ("cuda", "cpu"):
            model, state, forcing = build(device)
            step = stepper(model)
            for _ in range(2):
                state, _ = step(state, forcing)
            outs[device] = (to_stacked_arrays(state)
                            if isinstance(state, list)
                            else flatten_arrays(state))
        worst = 0.0
        for k, ref in outs["cpu"].items():
            scale = max(float(np.abs(ref).max()), 1e-300)
            worst = max(worst,
                        float(np.abs(outs["cuda"][k] - ref).max()) / scale)
        emit({"small_reference": {"mesh": label, "steps": 2,
                                  "dtype": "float64",
                                  "max_rel_err_vs_cpu": worst}})
        if not worst <= 1e-9:
            fail(f"small model ({label}) on the card differs from the "
                 f"CPU: {worst}")


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
                              for k, v in build.build_log.items()}}})
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
    kernels["integrate_fluxes_cuda"] = check_k2(
        calls["integrate_fluxes_cuda"][0], args.reps)
    del calls
    state, counts, _ = main_path(
        "raw sphere", model, state, forcing, 1,
        {"evp_subcycle_loop": 1, "integrate_fluxes_cuda": 1})
    kernels["evp_subcycle_loop"]["launches"] = counts["evp_subcycle_loop"]
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
    sstate, calls = sharded_against_unsharded(smodel, sstate, sforcing, *raw,
                                              min(args.reps, 3))
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
    kernels["evp_subcycle_step"]["launches"] = counts["evp_subcycle_step"]
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
    kernels["evp_panel_loop"]["launches"] = counts["evp_panel_loop"]
    kernels["integrate_fluxes_cuda"]["launches"] = \
        counts["integrate_fluxes_cuda"]
    if args.profile:
        profile(model, state, forcing, step_ms)
    # the same model, the per-subcycle route: same tensors, another config
    import copy
    import dataclasses
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
    kernels["panel_cell_step"]["launches"] = counts["panel_cell_step"]
    kernels["panel_cell_step"]["route_ms_per_step"] = route_ms
    del model, model5, state, forcing, step
    torch.cuda.empty_cache()

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
    kernels["evp_raster_loop"]["launches"] = counts["evp_raster_loop"]
    del model, state, forcing, step
    torch.cuda.empty_cache()

    small_reference()

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
