#!/usr/bin/env python3
"""The delta-Eddington shortwave (`column/dedd.py::shortwave_dedd`) of a
float32 state on the card, with its layer coefficients evaluated three
ways, timed in turns and held to the float64 shortwave of the same state:

  * "f32": every coefficient in float32 (the port before the repair);
  * "f64": every coefficient in float64 (`solve_dedd_column` as it is);
  * "f64_visible": float64 in the visible band alone.

    python3 dev/dedd_time.py [--workload qu60_standard_physics.winter]
        [--seed 2200000301] [--steps 4] [--reps 10]

The state is the cell's (`Side`, float32) after --steps steps at a sunlit
hour (the sun's table is indexed at noon UTC).  Prints one JSON line a
variant: the median ms a call (CUDA events), and the largest error of
Iswabs, fswint and fswsfc against the float64 call, in W m-2."""

import argparse
import json
import os
import statistics
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="qu60_standard_physics.winter")
    ap.add_argument("--seed", type=int, default=2200000301)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from benchmark.harness.cli import power_limit
    from benchmark.harness.manifest import Cell
    from benchmark.harness.sides import Side
    from seaice_tpu_torch.column import dedd

    cell = Cell(args.workload)
    side = Side(cell.config, cell.traffic, args.seed, "cuda", torch.float32)
    for _ in range(args.steps):
        side.step()
    torch.cuda.synchronize()
    col = side.column
    i = col["inputs"].per_day // 2
    atm = col["atmos"][i]
    tr = side.state.tracers
    phys = side.model.column

    optics = {dt: dedd.dedd_optics(dt, torch.device("cuda"))
              for dt in (torch.float32, torch.float64)}

    def call(dtype):
        def t(x):
            return x.to(dtype)
        return dedd.shortwave_dedd(
            t(tr["iceAreaCategory"]), t(tr["iceVolumeCategory"]),
            t(tr["snowVolumeCategory"]), t(tr["surfaceTemperature"]),
            t(col["coszen"][i]), t(atm.sw_vis_dir), t(atm.sw_vis_dif),
            t(atm.sw_ir_dir), t(atm.sw_ir_dif), phys.ni, phys.ns,
            apnd=t(tr["pondArea"] * tr["levelIceArea"]),
            hpnd=t(tr["pondDepth"]), optics=optics[dtype])

    ref = call(torch.float64)
    orig = dedd._layer_coeffs
    band = {"n": 0}

    def variant(name):
        def coeffs(ts, ws, gs, mu):
            # the calls go: visible (snow or bare, ponded), then the two
            # near-infrared bands alike
            wide = name == "f64" or (name == "f64_visible" and
                                     band["n"] < 2)
            band["n"] += 1
            if not wide:
                return orig(ts.float(), ws.float(), gs.float(), mu.float())
            return orig(ts.double(), ws.double(), gs.double(), mu.double())
        return coeffs

    # solve_dedd_column casts to float64 before it calls _layer_coeffs;
    # each variant casts as it says (the outputs go back to float32)
    names = ["f32", "f64", "f64_visible"]
    times = {n: [] for n in names}
    err = {}
    for r in range(args.reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            dedd._layer_coeffs = variant(n)
            band["n"] = 0
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = call(torch.float32)
            b.record()
            torch.cuda.synchronize()
            times[n].append(a.elapsed_time(b))
            if n not in err:
                err[n] = {k: float((getattr(out, k).double() -
                                    getattr(ref, k)).abs().max())
                          for k in ("Iswabs", "fswint", "fswsfc",
                                    "fswthru")}
    dedd._layer_coeffs = orig
    print(json.dumps({"card": power_limit(), "cells": side.mesh.n_cells}))
    for n in names:
        print(json.dumps({"variant": n, "ms_median": statistics.median(
            times[n]), "ms": times[n], "max_abs_error_w_m2": err[n]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
