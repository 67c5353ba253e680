#!/usr/bin/env python3
"""Run the solver-variants phase of `chip_smoke.py` alone on the GPU:
revised EVP with IR on the raw sphere (plain loop + K2), four more options
one step each, revised EVP in 4 blocks against the unsharded steps, the
weak scheme with upwind transport, upwind on the panel sphere (K3), the
JFNK VP solver against EVP on the 168 x 168 box (K4), then the small
float64 models of those options against the CPU.

    python3 dev/variants_smoke.py [--reps 3]

Builds the kernels, prints the JSON lines of the phase and the card
(`nvidia-smi --query-gpu=name,power.limit`), and exits non-zero where a
check fails, as `chip_smoke.py` does: the quicker rerun of the phase after
a change to the variant loop, the weak operators, upwind transport or the
VP solver.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("variants_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    from seaice_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.build_cuda()
    build.get_native_stencil_lib()
    cs.emit({"build": {"seconds": time.perf_counter() - t0}})
    kernels = {name: {} for name in (
        "evp_subcycle_loop", "integrate_fluxes_cuda", "evp_panel_loop",
        "panel_cell_step", "evp_raster_loop", "evp_subcycle_step")}
    t0 = time.perf_counter()
    cs.solver_variants(args.reps, card, kernels)
    t1 = time.perf_counter()
    cs.small_reference(cs.variant_reference_cases())
    cs.small_vp_reference()
    cs.emit({"launches_by_path": {k: v.get("launches_by_path")
                                  for k, v in kernels.items()},
             "phase_seconds": {"solver_variants": t1 - t0,
                               "small_references":
                               time.perf_counter() - t1}})
    print(card, flush=True)


if __name__ == "__main__":
    main()
