#!/usr/bin/env python3
"""How far float32 evaluations of the panel EVP loop (K3, its plain
version, and K1 on the same inputs) drift from the float64 plain loop
over the subcycles, on the inputs the full-physics panel step (Rothrock
strength) and the column-off panel step hand K3 at full width (subdiv 6,
120 subcycles).

    python3 dev/k3_drift.py [--subcycles 1 10 30 60 120] [--draws 3]
                            [--no-fma]

Prints one JSON line per path and subcycle count: the relative distance
(max |x - y| over max |y|, per field u, v, s11, s22, s12) to the float64
plain loop of the float64 kernel, of the float32 kernel, of the float32
plain loop and of K1 in float32; of the float32 kernel to the float32
plain loop; and, for `--draws` seeded draws, of the float32 plain loop
and the float32 kernel started from their inputs with every loop-state
value moved by one float32 ulp up or down at random (the spread of
float32 evaluations that differ only by rounding).  It also says whether
the float32 kernel repeats bitwise.  `--no-fma` builds the kernels with
`-fmad=false` (no contraction into fused multiply-adds).  It decides
whether a float32 kernel that is farther from the float64 loop than the
float32 plain loop is wrong or only rounded differently.
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subcycles", type=int, nargs="+",
                    default=[1, 10, 30, 60, 120])
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--no-fma", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k3_drift: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    from seaice_tpu_torch.dynamics.cuda_panel_fused import (
        evp_panel_loop, evp_panel_loop_plain)
    from seaice_tpu_torch.dynamics.cuda_unstructured import evp_subcycle_loop
    from seaice_tpu_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    if args.no_fma:
        build.NVCC_FLAGS = build.NVCC_FLAGS + ["-fmad=false"]
    build.build_cuda()              # one nvcc per source, in parallel
    names = ("u", "v", "s11", "s22", "s12")
    at = cs.loop_specs()["evp_panel_loop"]["state_at"]

    def errs(x, y):
        return {n: cs.rel_err(g.double(), w.double())
                for n, g, w in zip(names, x, y)}

    def jittered(a, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        a = list(a)
        for i in range(at, at + 5):
            sign = torch.randint(0, 2, a[i].shape, generator=g,
                                 device="cuda") * 2 - 1
            a[i] = a[i] * (1.0 + sign.to(a[i].dtype) * 2.0 ** -23)
        return a

    def where(x, ref, lat):
        """The 5 vertices of the largest |x - ref| in u, by latitude
        (degrees), and the u distance away from the poles (|lat| < 80)."""
        d = (x[0] - ref[0]).abs().double()
        top = torch.topk(d, 5).indices.cpu().numpy()
        away = torch.as_tensor(abs(lat) < 80.0, device=d.device)
        scale = float(ref[0].abs().max())
        return {"top_u_lat": [round(float(lat[i]), 2) for i in top],
                "top_u_rel": [float(d[i]) / scale for i in top],
                "u_rel_below_lat80": float(d[away].max()) / scale}

    def table(label, call, dyn, lat):
        args_, kw = call
        a32 = cs.cast(args_, torch.float32)
        a64 = cs.cast(args_, torch.float64)
        ft32 = cs.cast(dyn.fast, torch.float32)
        for n in args.subcycles:
            k = dict(kw, n_subcycles=n)
            p64 = evp_panel_loop_plain(*a64, **k)
            k64 = evp_panel_loop(*a64, **k)
            p32 = evp_panel_loop_plain(*a32, **k)
            k32 = evp_panel_loop(*a32, **k)
            k32b = evp_panel_loop(*a32, **k)
            k1_32 = evp_subcycle_loop(ft32, *a32[1:], **k)
            torch.cuda.synchronize()
            draws = [jittered(a32, seed) for seed in range(args.draws)]
            print(json.dumps({"k3_drift": {
                "path": label, "card": card, "n_subcycles": n,
                "no_fma": args.no_fma,
                "k32_repeats_bitwise": all(
                    bool(torch.equal(x, y)) for x, y in zip(k32, k32b)),
                "k64_vs_p64": errs(k64, p64),
                "k32_vs_p64": errs(k32, p64),
                "p32_vs_p64": errs(p32, p64),
                "k1_f32_vs_p64": errs(k1_32, p64),
                "k32_vs_p32": errs(k32, p32),
                "k32_where": where(k32, p64, lat),
                "p32_where": where(p32, p64, lat),
                "p32_draws_vs_p64": [
                    errs(evp_panel_loop_plain(*d, **k), p64) for d in draws],
                "k32_draws_vs_p64": [
                    errs(evp_panel_loop(*d, **k), p64) for d in draws]}}),
                flush=True)

    model, state, forcing, col = cs.full_physics_case(
        cs.SUBDIV, cs.N_CATEGORIES, cs.N_ICE_LAYERS, cs.N_SUBCYCLES,
        torch.float32, None)
    state, _ = cs.stepper(model, col)(state, forcing)
    _, calls = cs.capture_kernel_inputs(model, state, forcing, col)
    table("full-physics panel sphere", calls["evp_panel_loop"][0],
          model.tensors.dynamics, np.rad2deg(model.mesh.lat_vertex))
    del model, state, forcing, col, calls
    torch.cuda.empty_cache()

    model, state, forcing = cs.build_model(
        cs.SUBDIV, cs.N_CATEGORIES, cs.N_ICE_LAYERS, cs.N_SUBCYCLES,
        torch.float32, None, panel=True)
    state, _ = cs.stepper(model)(state, forcing)
    _, calls = cs.capture_kernel_inputs(model, state, forcing)
    table("panel sphere", calls["evp_panel_loop"][0], model.tensors.dynamics,
          np.rad2deg(model.mesh.lat_vertex))


if __name__ == "__main__":
    main()
