#!/usr/bin/env python3
"""Time K3 (`evp_panel_loop`, the whole-loop panel EVP kernel) of one
checkout on the GPU, at the panel sphere's full width (subdiv 6, 120
subcycles, f32), on the inputs the model's second step hands it.

    python3 dev/k3_time.py [--root CHECKOUT] [--reps 9]

imports `seaice_tpu_torch` and `chip_smoke.py` from CHECKOUT (default:
this repository), builds its kernels there, and prints one JSON line: the
card, the wrapper's and the C call's median ms by CUDA events, and K3's
phase timer (SM cycles per subcycle of each block's cell work, barrier
wait, vertex work, barrier wait).  To compare two versions, run it on both
checkouts in turns (A, B, B, A) in one session on one card.
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k3_time: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    from seaice_tpu_torch.dynamics.cuda_panel_fused import evp_panel_loop

    model, state, forcing = cs.build_model(
        cs.SUBDIV, cs.N_CATEGORIES, cs.N_ICE_LAYERS, cs.N_SUBCYCLES,
        torch.float32, None, panel=True)
    state, _ = cs.stepper(model)(state, forcing)
    _, calls = cs.capture_kernel_inputs(model, state, forcing)
    a, kw = calls["evp_panel_loop"][0]
    a = cs.cast(a, torch.float32)
    out = {"root": root, "card": cs.card_line(),
           "ms": cs.time_ms(lambda: evp_panel_loop(*a, **kw), args.reps),
           "kernel_ms": cs.time_ms(cs.k3_c_call(a, kw), args.reps),
           "launch": evp_panel_loop.last_launch,
           "phase_cycles_per_subcycle": cs.k3_phase_cycles(a, kw)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
