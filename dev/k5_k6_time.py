#!/usr/bin/env python3
"""Time K5 (`panel_cell_step`, the per-subcycle panel cell kernel) and K6
(`evp_subcycle_step`, one subcycle of every block of the sharded sphere)
of one checkout on the GPU, at full width (subdiv 6, f32), on the inputs
the model's second step hands them.

    python3 dev/k5_k6_time.py [--root CHECKOUT] [--reps 9] [--steps 3]
                              [--skip k5|k6]

imports `seaice_tpu_torch` and `chip_smoke.py` from CHECKOUT (default:
this repository), builds its kernels there, and prints one JSON line: the
card; K5's wrapper and C call (ms per call over 20 calls back to back, by
CUDA events) and the per-subcycle route's ms per step (host clock); K6's
wrapper, C calls and host time per subcycle of all 4 blocks, and the
sharded step's ms (host clock, --steps steps and their median).  It reads
both the loop form of K5 and K6 (one call for all blocks) and the
checkouts before it (K5 as one function call with planes, K6 one call per
block).  To compare two versions, run it on both checkouts in turns (A, B,
B, A) in one run on one card.
"""

import argparse
import json
import os
import sys
import time


def k5_times(cs, torch, reps, steps):
    from seaice_tpu_torch.dynamics import cuda_panel as K5
    model, state, forcing = cs.build_model(
        cs.SUBDIV, cs.N_CATEGORIES, cs.N_ICE_LAYERS, cs.N_SUBCYCLES,
        torch.float32, None, panel=True, fused_panel_loop=False)
    state, _ = cs.stepper(model)(state, forcing)
    _, calls = cs.capture_kernel_inputs(model, state, forcing)
    a, kw = calls["panel_cell_step"][0]
    a = cs.cast(a, torch.float32)
    pt, planes, t11, t22, t12, pressure, ss = a
    if hasattr(K5, "panel_cell_prepare"):
        loop = K5.panel_cell_prepare(pt, pressure, ss, t11, t22, t12, **kw)
        loop.planes.copy_(planes)
        wrapper = lambda: K5.panel_cell_step(loop)   # noqa: E731
        c_call = loop.calls[0]
    else:
        wrapper = lambda: K5.panel_cell_step(*a, **kw)   # noqa: E731
        N = cs_panel_n(pt)
        npc = 10 * (N + 1) ** 2 + 2
        planes_f = planes.permute(2, 0, 1).contiguous()
        ts = [t.contiguous().clone() for t in (t11, t22, t12)]
        part = torch.zeros((4 if kw["include_metric"] else 2, 6, npc),
                           dtype=torch.float32, device="cuda")
        fn = K5._c_function(torch.float32)
        from seaice_tpu_torch import constants as c
        args = (N, int(kw["include_metric"]), planes_f.data_ptr(),
                pt.basis_grad_S.data_ptr(), pt.basis_int_S.data_ptr(),
                pt.basis_metric_S.data_ptr(), pressure.data_ptr(),
                ss.data_ptr(), *(t.data_ptr() for t in ts), part.data_ptr(),
                float(kw["dt_elastic"]), float(kw["damping_timescale"]),
                float(c.EVP_ECCENTRICITY_SQ), float(c.PUNY),
                torch.cuda.current_stream().cuda_stream)
        keep = (planes_f, ts, part)   # noqa: F841
        c_call = lambda: fn(*args)    # noqa: E731
    out = {"wrapper_ms": cs.time_ms_per_call(wrapper, reps),
           "wrapper_ms_single": cs.time_ms(wrapper, reps),
           "kernel_ms": cs.time_ms_per_call(c_call, reps)}
    out["route_step_ms_all"] = step_times(cs, torch, model, state, forcing,
                                          steps)
    return out


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


def cs_panel_n(pt):
    from seaice_tpu_torch.dynamics.variational_panel import panel_n_of
    return panel_n_of(pt)


def k6_times(cs, torch, reps, steps):
    from seaice_tpu_torch.dynamics import cuda_unstructured as K
    smodel, sstate, sforcing = cs.build_sharded_model(
        cs.SUBDIV, cs.N_CATEGORIES, cs.N_ICE_LAYERS, cs.N_SUBCYCLES,
        torch.float32, None, cs.SHARDS)
    sstate, _ = cs.stepper(smodel)(sstate, sforcing)
    sstate, calls = cs.capture_kernel_inputs(smodel, sstate, sforcing)
    loops = cs.sharded_loops(smodel, calls["evp_subcycle_prepare"],
                             torch.float32)
    n = cs.N_SUBCYCLES
    batched = hasattr(K, "_bind_blocks")
    if batched:
        K.evp_subcycle_step(*loops)
        blocks = loops[0].blocks

        def wrapper():
            K.evp_subcycle_step(*loops)

        def c_call():
            blocks.call()
    else:
        def wrapper():
            for lp in loops:
                K.evp_subcycle_step(lp)

        def c_call():
            for lp in loops:
                fn, args = lp.c_step
                fn(*args)
    out = {"batched": batched,
           "wrapper_ms_per_subcycle": cs.time_ms_per_call(wrapper, reps, n),
           "kernel_ms_per_subcycle": cs.time_ms_per_call(c_call, reps, n)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        wrapper()
    out["host_us_per_subcycle"] = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    ts = step_times(cs, torch, smodel, sstate, sforcing, steps)
    out["sharded_step_ms"] = sorted(ts)[len(ts) // 2]
    out["sharded_step_ms_all"] = ts
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--steps", type=int, default=3,
                    help="steps of each path timed")
    ap.add_argument("--skip", choices=("k5", "k6"), default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k5_k6_time: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    if not hasattr(cs, "time_ms_per_call"):
        def time_ms_per_call(fn, reps, n=20):
            def run():
                for _ in range(n):
                    fn()
            return cs.time_ms(run, reps) / n
        cs.time_ms_per_call = time_ms_per_call
    out = {"root": root, "card": cs.card_line()}
    if args.skip != "k5":
        out["k5"] = k5_times(cs, torch, args.reps, args.steps)
    if args.skip != "k6":
        out["k6"] = k6_times(cs, torch, args.reps, args.steps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
