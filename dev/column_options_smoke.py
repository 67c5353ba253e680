#!/usr/bin/env python3
"""Run the column-options phase of `chip_smoke.py` alone on the GPU: the
full-physics panel sphere with the snow tracers, ITDrdg snow
redistribution, form drag and high-frequency coupling (then bulk and ITDsd
one step each), with the zero-layer thermodynamics, and one CoupledDriver
interval with prescribed surface fluxes (BL99) (--phase options); the pond
and radiation paths (d) and (e) (--phase ponds); the brine height,
z-salinity and biogeochemistry paths (f) and (g) (--phase bgc); fault 16's BL99
configuration through CoupledDriver (--phase fault16); the example scripts
and entry file (--phase entry); the partitioned model across processes,
two gloo ranks sharing the card and one NCCL rank alone (--phase ranks);
each held as `chip_smoke.py` holds it.

    python3 dev/column_options_smoke.py [--reps 3] [--phase ponds ...]

Builds the kernels, prints the JSON lines of the phase and the card
(`nvidia-smi --query-gpu=name,power.limit`), and exits non-zero where a
check fails, as `chip_smoke.py` does: the quicker rerun of the phase after
a change to the column options, or (ranks) to `parallel/comm.py`,
`parallel/sharded.py` or the runners' rank handling.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


PHASES = ("options", "ponds", "bgc", "fault16", "entry", "ranks")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--phase", action="append", choices=PHASES,
                    help="the phases to run (default: all six)")
    args = ap.parse_args()
    phases = args.phase or PHASES
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("column_options_smoke: no CUDA device", file=sys.stderr)
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
    if {"options", "ponds", "bgc", "fault16"} & set(phases):
        # the main path's host syncs of a step, for comparison
        model, state, forcing, col = cs.full_physics_case(
            cs.SUBDIV, cs.N_CATEGORIES, cs.N_ICE_LAYERS, cs.N_SUBCYCLES,
            torch.float32, None)
        step = cs.stepper(model, col)
        state, _ = step(state, forcing)
        _, syncs = cs.count_host_syncs(lambda: step(state, forcing))
        del model, state, forcing, col, step
        torch.cuda.empty_cache()
        bases = cs.option_bases()
    if "options" in phases:
        cs.column_options(bases, args.reps, card, kernels, syncs)
    if "ponds" in phases:
        cs.pond_radiation_options(bases, args.reps, card, kernels, syncs)
    if "bgc" in phases:
        cs.bgc_options(bases, args.reps, card, kernels, syncs)
    if "fault16" in phases:
        cs.fault16(bases, card, kernels)
    for phase, run in (("entry", cs.entry_scripts),
                       ("ranks", lambda c, k, w: cs.ranks_phase(w, c, k))):
        if phase in phases:
            workdir = tempfile.mkdtemp(prefix="column_options_smoke_")
            try:
                run(card, kernels, workdir)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
    cs.emit({"launches_by_path": {k: v.get("launches_by_path")
                                  for k, v in kernels.items()}})
    print(card, flush=True)


if __name__ == "__main__":
    main()
