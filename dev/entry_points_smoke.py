#!/usr/bin/env python3
"""Run the three entry-point phases of `chip_smoke.py` alone on the GPU:
the namelist run (K1 + K2), the coupled run (K1 + K2) and the sharded
coupled run (K6 + K2), at full width, with their checks, then the small
float64 coupled box against the CPU.

    python3 dev/entry_points_smoke.py [--reps 3]

Builds the kernels, prints the JSON lines of those phases and the card
(`nvidia-smi --query-gpu=name,power.limit`), and exits non-zero where a
phase fails, as `chip_smoke.py` does: the quicker rerun of those phases
after a change to the namelist, coupler, analysis or coupled modules.
"""

import argparse
import os
import shutil
import sys
import tempfile
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
        print("entry_points_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    card = cs.card_line()
    from seaice_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.build_cuda()
    build.get_native_stencil_lib()
    cs.emit({"build": {"seconds": time.perf_counter() - t0}})
    workdir = tempfile.mkdtemp(prefix="entry_points_")
    try:
        t0 = time.perf_counter()
        _, model = cs.namelist_run(workdir, args.reps, card)
        t1 = time.perf_counter()
        _, state0, fields = cs.coupled_run(model, args.reps, card)
        t2 = time.perf_counter()
        cs.sharded_coupled_run(model, state0, fields, min(args.reps, 3),
                               card)
        t3 = time.perf_counter()
        cs.small_coupled_reference()
        cs.emit({"phase_seconds": {"namelist_run": t1 - t0,
                                   "coupled_run": t2 - t1,
                                   "sharded_coupled_run": t3 - t2,
                                   "small_coupled_box": time.perf_counter()
                                   - t3}})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
