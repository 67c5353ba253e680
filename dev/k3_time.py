#!/usr/bin/env python3
"""Time K3 (`evp_panel_loop`, the whole-loop panel EVP kernel) of one
checkout on the GPU, on the panel sphere (subdiv 6 by default, N = 64;
subdiv 7 is the benchmark's QU60 mesh, N = 128), 120 subcycles, f32 and
f64, on the inputs the model's second step hands it.

    python3 dev/k3_time.py [--root CHECKOUT] [--subdiv 6] [--reps 9]
        [--save-io FILE | --load-io FILE] [--check]

imports `seaice_tpu_torch` and `chip_smoke.py` from CHECKOUT (default:
this repository), builds its kernels there, and prints one JSON line: the
card, the wrapper's and the C call's median ms by CUDA events (the C call
in f64 too), the launch shapes, and K3's phase timer (SM cycles per
subcycle of each block's cell work, barrier wait, vertex work, barrier
wait).  `--save-io` writes the inputs and the kernel's f32 and f64 results
to FILE; `--load-io` takes the inputs from FILE in place of building the
model and reports how far this checkout's results lie from the saved ones
(`bitwise_*`, `max_abs_diff_*`).  `--check` then holds the kernel to its
plain version as `chip_smoke.py` does (`check_loop`: one subcycle, 10
subcycles, the whole f64 loop; a second line).  To compare two versions,
save on one, then load on both in turns (A, B, B, A) in one call on
one card.
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--reps", type=int, default=9)
    io = ap.add_mutually_exclusive_group()
    io.add_argument("--save-io")
    io.add_argument("--load-io")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k3_time: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    from seaice_tpu_torch.dynamics.cuda_panel_fused import evp_panel_loop
    from seaice_tpu_torch.utils.containers import to_device

    if args.load_io:
        saved = torch.load(args.load_io, weights_only=False)
        a, kw = saved["args"], saved["kw"]
    else:
        model, state, forcing = cs.build_model(
            args.subdiv, cs.N_CATEGORIES, cs.N_ICE_LAYERS, cs.N_SUBCYCLES,
            torch.float32, None, panel=True)
        state, _ = cs.stepper(model)(state, forcing)
        _, calls = cs.capture_kernel_inputs(model, state, forcing)
        a, kw = calls["evp_panel_loop"][0]
        del model, state, forcing, calls
    a64 = cs.cast(a, torch.float64)
    a = cs.cast(a, torch.float32)
    out = {"root": root, "card": cs.card_line(), "subdiv": args.subdiv}
    results = {"f32": evp_panel_loop(*a, **kw)}
    out["launch"] = evp_panel_loop.last_launch
    results["f64"] = evp_panel_loop(*a64, **kw)
    out["launch_f64"] = evp_panel_loop.last_launch
    torch.cuda.synchronize()
    if args.save_io:
        torch.save({"args": to_device(a, torch.device("cpu")), "kw": kw,
                    "results": to_device(results, torch.device("cpu"))},
                   args.save_io)
    if args.load_io:
        for tag, got in results.items():
            want = [w.to("cuda") for w in saved["results"][tag]]
            out["bitwise_" + tag] = all(
                torch.equal(g, w) for g, w in zip(got, want))
            out["max_abs_diff_" + tag] = max(
                float((g - w).abs().max()) for g, w in zip(got, want))
    del results
    out["ms"] = cs.time_ms(lambda: evp_panel_loop(*a, **kw), args.reps)
    out["kernel_ms"] = cs.time_ms(cs.k3_c_call(a, kw), args.reps)
    out["phase_cycles_per_subcycle"] = cs.k3_phase_cycles(a, kw)
    out["kernel_ms_f64"] = cs.time_ms(cs.k3_c_call(a64, kw), args.reps)
    print(json.dumps(out), flush=True)
    if args.check:
        chk = cs.check_loop("evp_panel_loop", (a, kw), args.reps)
        print(json.dumps({"check": {k: v for k, v in chk.items() if k not in (
            "name", "route", "source", "replaces", "library_ms")}}),
            flush=True)


if __name__ == "__main__":
    main()
