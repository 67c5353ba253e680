#!/usr/bin/env python3
"""Time K1 (`evp_subcycle_loop`, the whole EVP loop on any mesh) and K4
(`evp_raster_loop`, the whole loop on the raster box) of one checkout on
the GPU, at full width (raw icosahedral subdiv 6 and the 168 x 168 box,
f32, 120 subcycles), on the inputs the model's second step hands them.

    python3 dev/k1_k4_time.py [--root CHECKOUT] [--reps 7] [--steps 3]
                              [--variants]

imports `seaice_tpu_torch` and `chip_smoke.py` from CHECKOUT (default:
this repository), builds its kernels there, and prints one JSON line: the
card; the C call alone of K1 and of K4 (median ms of --reps calls by CUDA
events, f32 and f64) and, where the checkout reports it, the launch
shape; the raw-sphere step and the box step (host clock, --steps steps
from the same state, and their median).  It reads both this checkout's API
and the one before it (K1 and K4 as 240 launches from a host loop).  To
compare two versions, run it on both checkouts in turns (A, B, B, A) in
one run on one card.

--variants (this checkout's kernels only) also times K1 built with 256,
512 and 1024 threads a block (EVP_K1_THREADS; its own is 768), each a
library of its own compiled here with nvcc beside the checkout's build
directory; K1's C call by number of subcycles (0, 1, 10, 120); K1 after
ONE subcycle against one call of K6's entry on the mesh as one block (how
many values differ, u, v, stresses and the partials); and the SM cycles
a subcycle of each phase of K1 and K4 (libraries built with
EVP_PHASE_TIMER: cell work, barrier, vertex work, barrier for K1; the
tiles' work and the barrier for K4), mean, least and largest over the
blocks, beside the SM clock `nvidia-smi` reads.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time


def second_step_inputs(cs, torch, model, state, forcing, name):
    """The inputs the model's second step hands kernel `name`, and the
    state after one step."""
    state, _ = cs.stepper(model)(state, forcing)
    _, calls = cs.capture_kernel_inputs(model, state, forcing)
    return state, calls[name][0]


def step_times(cs, torch, model, state, forcing, steps):
    """Host-clock ms of `steps` steps from the same state."""
    step = cs.stepper(model)
    ts = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, forcing)
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return ts


def k1_c_call(torch, args, kw):
    """K1's C call alone, in this checkout's API or the one before it."""
    from seaice_tpu_torch.dynamics import cuda_unstructured as K
    loop = K.evp_subcycle_prepare(*args, **{
        k: v for k, v in kw.items() if k != "n_subcycles"})
    if hasattr(K, "loop_call"):
        call = K.loop_call(loop, kw["n_subcycles"])
    else:
        fn = K._c_function(args[1].dtype)
        tail = (*loop.shape, int(kw["n_subcycles"]),
                int(loop.include_metric), *loop.c_tail)

        def call():
            return fn(*tail)

    def run():
        if call() != 0:
            raise RuntimeError("K1: the C call returned an error")
    return run, loop


def k4_c_call(args, kw):
    from seaice_tpu_torch.dynamics.cuda_raster import _bind
    call, _ = _bind(*args, **kw)
    out = {}

    def run():
        err, info = call()
        if err != 0:
            raise RuntimeError(f"K4: the C call returned error {err}")
        out["info"] = info if isinstance(info, int) else list(info)
    return run, out


def k1_times(cs, torch, reps, steps, variants):
    from seaice_tpu_torch.dynamics import cuda_unstructured as K
    model, state, forcing = cs.build_model(
        cs.SUBDIV, cs.N_CATEGORIES, cs.N_ICE_LAYERS, cs.N_SUBCYCLES,
        torch.float32, None)
    state, (a, kw) = second_step_inputs(cs, torch, model, state, forcing,
                                        "evp_subcycle_loop")
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        run, loop = k1_c_call(torch, cs.cast(a, dtype), kw)
        out["kernel_ms_" + tag] = cs.time_ms(run, reps)
        info = getattr(loop, "c_info", None)
        if info is not None and hasattr(K, "launch_shape"):
            out["launch_" + tag] = K.launch_shape(info, loop.shape[0])
    out["raw_sphere_step_ms_all"] = step_times(cs, torch, model, state,
                                               forcing, steps)
    if variants:
        out["variants"] = k1_variants(cs, torch, cs.cast(a, torch.float32),
                                      kw, reps)
    return out


def build_variants(designs):
    """{name: (ctypes library or None, compiler output)} for each
    (source, extra nvcc flags) of `designs`, compiled in parallel."""
    from seaice_tpu_torch.kernels import build
    procs = {}
    for name, (source, flags) in designs.items():
        lib = os.path.join(build.build_dir(), f"lib{source}_variant_{name}.so")
        cmd = [build._nvcc()] + build.NVCC_FLAGS + flags + [
            "-I", build.CSRC, "-o", lib,
            os.path.join(build.CSRC, source + ".cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        text, _ = p.communicate()
        out[name] = (ctypes.CDLL(lib) if p.returncode == 0 else None, text)
    return out


def ptxas_lines(text, kernel):
    """The registers and spill lines ptxas printed for `kernel`."""
    keep, on = [], False
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            on = kernel in ln
        elif on and ("registers" in ln or "spill" in ln):
            keep.append(ln.strip())
    return keep


def phase_cycles(torch, so, grid, n_sub):
    """Cycles a subcycle of each phase (EVP_PHASE_TIMER library), mean,
    least and largest over the blocks; the library's counters are zeroed
    after they are read."""
    buf = (ctypes.c_longlong * (2048 * 4))()
    so.evp_phase_cycles_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int]
    torch.cuda.synchronize()
    if so.evp_phase_cycles_read(buf, 2048 * 4, 1) != 0:
        raise RuntimeError("reading the phase counters failed")
    rows = [[buf[4 * b + p] / max(n_sub, 1) for p in range(4)]
            for b in range(grid)]
    return [{"mean": sum(r[p] for r in rows) / grid,
             "min": min(r[p] for r in rows), "max": max(r[p] for r in rows)}
            for p in range(4)]


def sm_clock():
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader"], stdout=subprocess.PIPE,
                       text=True)
    return r.stdout.strip()


def k1_one_subcycle_vs_k6(cs, torch, a, kw):
    """K1 after ONE subcycle against one call of K6's entry on the mesh as
    one block: the number of values that differ, and the largest relative
    distance, of u, v, the stresses and the partials."""
    from seaice_tpu_torch.dynamics import cuda_unstructured as K
    kw6 = {k: v for k, v in kw.items() if k != "n_subcycles"}
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        x = cs.cast(a, dtype)
        l1 = K.evp_subcycle_prepare(*x, **kw6)
        assert K.loop_call(l1, 1)() == 0
        l6 = K.evp_subcycle_prepare(*x, **kw6)
        K.evp_subcycle_step(l6)
        torch.cuda.synchronize()
        names = ("u", "v", "s11", "s22", "s12", "pu", "pv")
        got = (*K.evp_subcycle_finish(l1), *l1.scratch)
        want = (*K.evp_subcycle_finish(l6), *l6.scratch)
        out[tag] = {n: [int((g != w).sum()), int(g.numel()),
                        cs.rel_err(g.double(), w.double())]
                    for n, g, w in zip(names, got, want)}
    return out


def k1_variants(cs, torch, a32, kw, reps):
    """K1's C call from libraries built with other compile-time designs,
    its subcycle sweep, its phase cycles, and K1 against K6 after one
    subcycle."""
    from seaice_tpu_torch.dynamics import cuda_unstructured as K
    from seaice_tpu_torch.kernels import build
    src = "evp_unstructured"
    libs = build_variants({
        "threads_256": (src, ["-DEVP_K1_THREADS=256"]),
        "threads_512": (src, ["-DEVP_K1_THREADS=512"]),
        "threads_1024": (src, ["-DEVP_K1_THREADS=1024"]),
        "phase_timer": (src, ["-DEVP_PHASE_TIMER"])})
    out = {"kernel_ms_by_n_subcycles": {
        n: cs.time_ms(k1_c_call(torch, a32, dict(kw, n_subcycles=n))[0], reps)
        for n in (0, 1, 10, 120)}}
    out["one_subcycle_vs_k6"] = k1_one_subcycle_vs_k6(cs, torch, a32, kw)
    saved = build.get_cuda_lib
    try:
        for name, (so, text) in libs.items():
            ptxas = ptxas_lines(text, "evp_loop_kernelIfLi6E")
            if so is None:
                out[name] = {"build_error": text[-2000:]}
                continue
            build.get_cuda_lib = lambda _name, so=so: so
            if name == "phase_timer":
                run, loop = k1_c_call(torch, a32, kw)
                phase_cycles(torch, so, 1, 1)        # zero the counters
                run()
                out[name] = {"cycles_per_subcycle": dict(zip(
                    ("cell_work", "cell_barrier", "vertex_work",
                     "vertex_barrier"),
                    phase_cycles(torch, so, loop.c_info[1],
                                 kw["n_subcycles"]))),
                    "sm_clock_mhz_now_max": sm_clock(), "ptxas": ptxas}
                build.get_cuda_lib = saved
                continue
            run, loop = k1_c_call(torch, a32, kw)
            ms = cs.time_ms(run, reps)
            once, fresh = k1_c_call(torch, a32, kw)
            once()
            got = K.evp_subcycle_finish(fresh)
            build.get_cuda_lib = saved
            want = K.evp_subcycle_loop(*a32, **kw)
            torch.cuda.synchronize()
            out[name] = {"kernel_ms": ms,
                         "launch": K.launch_shape(loop.c_info, loop.shape[0]),
                         "ptxas": ptxas,
                         "loop_rel_err_vs_chosen_design": max(
                             cs.rel_err(g.double(), w.double())
                             for g, w in zip(got, want))}
    finally:
        build.get_cuda_lib = saved
    return out


def k4_times(cs, torch, reps, steps, variants):
    model, state, forcing = cs.build_box_model(cs.BOX_NX, cs.N_SUBCYCLES,
                                               torch.float32, None)
    state, (a, kw) = second_step_inputs(cs, torch, model, state, forcing,
                                        "evp_raster_loop")
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        run, rec = k4_c_call(cs.cast(a, dtype), kw)
        out["kernel_ms_" + tag] = cs.time_ms(run, reps)
        out["info_" + tag] = rec.get("info")
    out["box_step_ms_all"] = step_times(cs, torch, model, state, forcing,
                                        steps)
    if variants:
        from seaice_tpu_torch.kernels import build
        a32 = cs.cast(a, torch.float32)
        so, text = build_variants({"phase_timer": (
            "evp_raster", ["-DEVP_PHASE_TIMER"])})["phase_timer"]
        saved = build.get_cuda_lib
        build.get_cuda_lib = lambda _name: so
        try:
            run, rec = k4_c_call(a32, kw)
            run()
            phase_cycles(torch, so, 1, 1)        # zero the counters
            run()
            cyc = phase_cycles(torch, so, rec["info"][1], kw["n_subcycles"])
            out["variants"] = {
                "phase_cycles": {"tile_work": cyc[0], "barrier": cyc[1]},
                "ptxas": ptxas_lines(text, "raster_loop_kernelIf"),
                "sm_clock_mhz_now_max": sm_clock()}
        finally:
            build.get_cuda_lib = saved
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--steps", type=int, default=3,
                    help="steps of each path timed")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k1_k4_time: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    from seaice_tpu_torch.kernels import build
    build.build_cuda()
    out = {"root": root, "card": cs.card_line()}
    out["k4"] = k4_times(cs, torch, args.reps, args.steps, args.variants)
    out["k1"] = k1_times(cs, torch, args.reps, args.steps, args.variants)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
