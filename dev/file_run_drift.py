#!/usr/bin/env python3
"""How far the float32 file-driven run drifts from the same run in
float64, step by step: `chip_smoke.py`'s file-driven run (the subdiv-6
MPAS file of `tests/mpas_fixture.py`, CORE and NCAR forcing files,
`StandaloneRunner`) in both dtypes side by side on the card.

    python3 dev/file_run_drift.py [--steps 48] [--column mushy bl99]
                                  [--subdiv 6] [--subcycles 120]
                                  [--every 1] [--device cuda|cpu]

For each column (`mushy`: the north-star column of `chip_smoke.py`;
`bl99`: `ColumnConfig()`'s defaults, BL99 thermodynamics and CCSM3
shortwave, the column of `examples/run_5day_from_files.py`) it prints
one JSON line a step with the distances of `chip_smoke.py`'s f32-vs-f64
budget (area, volume and enthalpy relative to their max, surface
temperature in K, u relative), and `chip_smoke.file_run_distances` (the
global totals; area, volume, enthalpy and surface temperature on the
categories with at least 1e-3 of ice area in both runs); and a last line
about the cells where the two runs differ most: their ice in each
category in both runs, and the steps at which the largest
surface-temperature distance first passed 0.27 K and 1 K. It decides
whether an f32 run outside BASELINE.md's budget drifts by rounding (a
growing distance everywhere) or by cells that take another branch (ice
in a category in one run and not in the other).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np


def report_abort(column, dtype, step, err, runner, mesh):
    """A runner's state check failed: print the step, the message and
    the first failing cells of its per-cell dump (every category's ice,
    snow, surface temperature, and the cell's latitude)."""
    import glob
    cells = []
    for path in glob.glob(os.path.join(
            os.path.dirname(err.dump_path), "cell_failure.*.npz")):
        with np.load(path) as z:
            for j, c in enumerate(z["cell_index"][:4]):
                cells.append({
                    "cell": int(c), "reason": str(z["reason"]),
                    "lat_deg": float(np.rad2deg(mesh.lat_cell[c])),
                    **{k[len("tracer_"):]: z[k][j].tolist() for k in (
                        "tracer_iceAreaCategory", "tracer_iceVolumeCategory",
                        "tracer_snowVolumeCategory",
                        "tracer_surfaceTemperature")}})
    print(json.dumps({"column": column, "abort": str(dtype), "step": step,
                      "clock": runner.clock.timestamp(), "message": str(err),
                      "cells": cells}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--column", nargs="+", default=["mushy", "bl99"])
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--device", default=None)
    ap.add_argument("--every", type=int, default=1,
                    help="print every n-th step")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from seaice_tpu_torch import config as C
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.error import SeaIceAbort
    from seaice_tpu_torch.run import RunStreams, StandaloneRunner

    cs.SUBDIV, cs.N_SUBCYCLES = args.subdiv, args.subcycles
    if torch.cuda.is_available():
        print(cs.card_line(), flush=True)
    workdir = tempfile.mkdtemp(prefix="file_run_drift_")
    try:
        mesh, atmos, ocean = cs.file_inputs(workdir)
        area_cell = np.asarray(mesh.area_cell)
        for column in args.column:
            cfg = cs.file_config()
            if column == "bl99":
                cfg = C.Config(run=cfg.run, velocity=cfg.velocity,
                               advection=cfg.advection,
                               column=C.ColumnConfig())
            runners = {}
            for dt in (torch.float32, torch.float64):
                model = SeaIceModel(mesh, cfg, dtype=dt, device=args.device)
                run_dir = os.path.join(workdir, f"{column}_{dt}")
                os.makedirs(run_dir)
                runners[dt] = StandaloneRunner(
                    model, initial_state_from_setup(
                        model, RunSetup(**cs.FILE_SETUP)),
                    atmos_forcing=atmos, ocean_forcing=ocean,
                    streams=RunStreams(restart_dir=run_dir,
                                       restart_interval=1e9))
            first = {0.27: None, 1.0: None}
            aborted = False
            for i in range(1, args.steps + 1):
                f = {}
                for dt, r in runners.items():
                    try:
                        r.run(1)
                    except SeaIceAbort as e:
                        report_abort(column, dt, i, e, r, mesh)
                        aborted = True
                        break
                    f[dt] = cs.global_fields(r.model, r.state)
                if aborted:
                    break
                a, b = f[torch.float32], f[torch.float64]
                row = {k: float(np.abs(a[k] - b[k]).max()) /
                       max(float(np.abs(b[k]).max()), 1e-300)
                       for k in ("iceAreaCategory", "iceVolumeCategory",
                                 "iceEnthalpy", "u")}
                ts = np.abs(a["surfaceTemperature"] -
                            b["surfaceTemperature"])
                row["surfaceTemperature_max_abs_K"] = float(ts.max())
                row.update(cs.file_run_distances(a, b, area_cell))
                for lim in first:
                    if first[lim] is None and ts.max() > lim:
                        first[lim] = i
                if i % args.every == 0 or i == args.steps:
                    print(json.dumps({"column": column, "step": i, **row}),
                          flush=True)
            if aborted:
                continue
            worst = []
            for key in ("surfaceTemperature", "iceEnthalpy"):
                d = np.abs(a[key] - b[key])
                while d.ndim > 1:
                    d = d.max(-1)
                c = int(d.argmax())
                worst.append({
                    "by": key, "cell": c,
                    "lat_deg": float(np.rad2deg(mesh.lat_cell[c])),
                    **{f"{k}_{t}": x[k][c].tolist() for t, x in
                       (("f32", a), ("f64", b)) for k in (
                           "iceAreaCategory", "iceVolumeCategory",
                           "surfaceTemperature")}})
            n_cat = a["iceAreaCategory"]
            flips = int(((n_cat > 1e-11) != (
                b["iceAreaCategory"] > 1e-11)).sum())
            print(json.dumps({"column": column, "steps": args.steps,
                              "first_step_tsfc_over_K": first,
                              "categories_with_ice_in_one_run_only": flips,
                              "worst_cells": worst}), flush=True)
            del runners
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
