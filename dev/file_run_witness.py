#!/usr/bin/env python3
"""Readings behind three checks of `chip_smoke.py`'s file-driven run
(ROADMAP Queue 3, faults 2 and 6): the same run (the subdiv-6 MPAS file
of `tests/mpas_fixture.py`, CORE and NCAR forcing files, the mushy
column, `StandaloneRunner`) on the card.

    python3 dev/file_run_witness.py [--steps 48] [--dump-dir DIR]
                                    [--subdiv 6] [--subcycles 120]
                                    [--device cuda|cpu]

1. K1 on the run's first step (from rest) and its second: SHORT_LOOP
   float32 subcycles of the kernel against its plain version, beside the
   plain loop's own response to its state, and to its other inputs,
   one float32 ulp larger (`chip_smoke.short_loop`).  One JSON line each.
2. Four runs side by side for --steps steps: float32 (the run users
   run), float64, float64 with its state rounded to float32 once after
   step 1 (the float64 run's own response to one float32 rounding), and
   float32 with its state rounded to bfloat16 after every step (a
   lower-precision control).  Each against float64, at steps 1, 2, 4 and
   every 8th: `chip_smoke.file_run_distances` (global totals; area,
   volume, enthalpy and surface temperature on the categories with at
   least 1e-3 of ice area in both runs).  One JSON line a step.
3. The float64 run goes on (to --steps + 12 at most) until its column
   flags a cell unconverged, and writes that step's column inputs at the
   flagged cells (every tracer, the atmosphere and ocean forcing, coszen,
   the flags) to DIR/unconverged_cells.npz, for
   `dev/replay_column_cells.py`.
"""

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import numpy as np


def k1_readings(cs, runner, step):
    """One runner step with K1's inputs recorded; prints the short-loop
    readings on them."""
    _, calls = cs.capture_calls(lambda: runner.run(1))
    args, kw = calls["evp_subcycle_loop"][0]
    a32 = cs.cast(args, cs.torch.float32)
    e, resp = cs.short_loop("evp_subcycle_loop", a32, kw)
    worst = max(max(r.values()) for r in resp.values())
    print(json.dumps({"k1_short_loop": {
        "step": step, "subcycles": cs.SHORT_LOOP, "limit": cs.SHORT_LOOP_TOL,
        "kernel_vs_plain_f32": e, "plain_f32_one_ulp_response": resp,
        "kernel_over_response": max(e.values()) / max(worst, 1e-300)}}),
          flush=True)


def dump_flagged(path, step, rec, mask, mesh):
    """The column inputs of the flagged cells of one step."""
    import torch
    cells = torch.nonzero(mask.reshape(mask.shape[0], -1).any(-1))[:, 0]
    out = {"step": np.int64(step), "cell_index": cells.cpu().numpy(),
           "flags": mask[cells].cpu().numpy(),
           "lat": np.asarray(mesh.lat_cell)[cells.cpu().numpy()],
           "coszen": rec["coszen"][cells].cpu().numpy()}
    for k, t in rec["state"].tracers.items():
        out["tracer_" + k] = t[cells].cpu().numpy()
    for tag in ("atmos", "ocean"):
        f = rec[tag]
        for fld in dataclasses.fields(f):
            v = getattr(f, fld.name)
            if isinstance(v, torch.Tensor):
                out[f"{tag}_{fld.name}"] = v[cells].cpu().numpy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)
    return out["cell_index"].tolist()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--dump-dir", default="build/file_run_witness")
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs

    cs.SUBDIV, cs.N_SUBCYCLES = args.subdiv, args.subcycles
    dev = args.device
    if torch.cuda.is_available():
        print(cs.card_line(), flush=True)
    workdir = tempfile.mkdtemp(prefix="file_run_witness_")
    try:
        inputs = cs.file_inputs(workdir)
        mesh = inputs[0]
        area_cell = np.asarray(mesh.area_cell)
        runs = {"f32": cs.file_runner(inputs, torch.float32, device=dev),
                "f64": cs.file_runner(inputs, torch.float64, device=dev),
                "f64_rounded_to_f32_once":
                    cs.file_runner(inputs, torch.float64, device=dev),
                "f32_rounded_to_bf16_every_step":
                    cs.file_runner(inputs, torch.float32, device=dev)}
        # the float64 run's step inputs, for the dump
        r64, rec = runs["f64"], {}
        step64 = r64.step_fn

        def recorder(tensors, state, dyn, atmf, ocnf, coszen=None):
            rec.update(state=state, atmos=atmf, ocean=ocnf, coszen=coszen)
            return step64(tensors, state, dyn, atmf, ocnf, coszen=coszen)
        r64.step_fn = recorder
        r64._device_step = r64._build_device_step()

        flagged = None
        for i in range(1, args.steps + 13):
            for name, r in runs.items():
                if i > args.steps and name != "f64":
                    continue
                if name == "f32" and i <= 2:
                    k1_readings(cs, r, i)
                else:
                    r.run(1, check_interval=10 ** 9)    # no abort gate
                if name == "f64_rounded_to_f32_once" and i == 1:
                    r.state = cs.rounded(r.state, torch.float32)
                if name == "f32_rounded_to_bf16_every_step":
                    r.state = cs.rounded(r.state, torch.bfloat16)
            mask = r64.diags["column_fluxes"].warnings["thermo_unconverged"]
            if flagged is None and bool(mask.any()):
                path = os.path.join(args.dump_dir, "unconverged_cells.npz")
                flagged = dump_flagged(path, i, rec, mask, mesh)
                print(json.dumps({"f64_unconverged": {
                    "step": i, "cells": flagged, "dump": path}}), flush=True)
            if i <= args.steps and (i in (1, 2, 4) or i % 8 == 0
                                    or i == args.steps):
                f = {n: cs.global_fields(r.model, r.state)
                     for n, r in runs.items()}
                print(json.dumps({"step": i, **{
                    n: cs.file_run_distances(f[n], f["f64"], area_cell)
                    for n in runs if n != "f64"}}), flush=True)
            if i >= args.steps and flagged is not None:
                break
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
