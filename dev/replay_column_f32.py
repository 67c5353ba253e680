#!/usr/bin/env python3
"""Replay, on the CPU, the column thermodynamics of the cells that
`dev/column_f32_witness.py` caught unconverged on the card: their inputs
(DUMP.npz) go through the program's `step_thermodynamics` and through the
benchmark reference's (`benchmark/reference/column_thermo.py::thermo`),
each in float32 and in float64.

    python3 dev/replay_column_f32.py DUMP.npz [--config qu60_standard_physics]
        [--reference-layer-terms-f64]

Prints one JSON line a precision and side: the categories flagged, and for
the reference the flagged categories' Picard iterates: at each iteration
the largest temperature change dT (against DT_ERRMAX = 5e-4 C), the energy
closure ferr against its tolerance, whether the surface went above 0 C,
and the surface temperature.  --reference-layer-terms-f64 evaluates the
reference's delta-Eddington layer terms in float64 whatever its dtype, as
the program does (`column/dedd.py::solve_dedd_column`)."""

import argparse
import json
import os
import sys
import types

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dump")
    ap.add_argument("--config", default="qu60_standard_physics")
    ap.add_argument("--reference-layer-terms-f64", action="store_true")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    from benchmark.harness.manifest import BENCH_DIR, load_json
    from benchmark.harness.sides import make_config
    from benchmark.reference import column, column_shortwave, column_thermo
    from seaice_tpu_torch.column.driver import AtmosForcing, OceanForcing
    from seaice_tpu_torch.model import build_column_physics

    if args.reference_layer_terms_f64:
        terms = column_shortwave.layer_terms

        def wide(tau, w, g, mu):
            return tuple(x.to(tau.dtype) for x in terms(
                tau.double(), w.double(), g.double(), mu.double()))
        column_shortwave.layer_terms = wide
    conf = load_json(os.path.join(BENCH_DIR, "configs",
                                  args.config + ".json"))
    cfg = make_config(conf)
    with np.load(args.dump) as z:
        d = {k: z[k] for k in z.files}
    doy = int(d["day_of_year"])

    def part(prefix):
        return {k[len(prefix):]: v for k, v in d.items()
                if k.startswith(prefix)}

    tracers, atm, ocn = part("tracer_"), part("atmos_"), part("ocean_")
    out = {"step": int(d["step"]), "cells": d["cell_index"].tolist(),
           "lat_deg": np.rad2deg(d["lat"]).round(3).tolist(),
           "flags_on_the_card": d["flags"].astype(int).tolist()}
    print(json.dumps(out), flush=True)
    for name in ("float32", "float64"):
        dt_ = getattr(torch, name)

        def t(a):
            return torch.as_tensor(a).to(dt_)
        phys = build_column_physics(cfg, dt_, torch.device("cpu"))
        _, fl = phys.step_thermodynamics(
            cfg.run.dt, {k: t(v) for k, v in tracers.items()},
            AtmosForcing(**{k: t(v) for k, v in atm.items()}),
            OceanForcing(**{k: t(v) for k, v in ocn.items()}),
            coszen=t(d["coszen"]), day_of_year=doy, lat=t(d["lat"]))
        m = fl.warnings["thermo_unconverged"]
        print(json.dumps({"side": "program", "dtype": name,
                          "flagged": m.numpy().astype(int).tolist(),
                          "iterations": int(fl.thermo_iterations)}),
              flush=True)

        ref = types.SimpleNamespace(
            dt=cfg.run.dt, ni=cfg.run.n_ice_layers, ns=cfg.run.n_snow_layers,
            hin_max=column.category_bounds(cfg.run.n_categories),
            salin=torch.as_tensor(column.bl99_salinity(
                cfg.run.n_ice_layers)).to(dt_))
        f = {k: t(v) for k, v in {**atm, **ocn}.items()}
        f.update(coszen=t(d["coszen"]), lat=t(d["lat"]), day_of_year=doy)
        trace = []
        _, bad = column_thermo.thermo(ref, {k: t(v) for k, v in
                                            tracers.items()}, f, trace)
        where = torch.nonzero(bad | torch.as_tensor(d["flags"]))
        iterates = [{str(tuple(w.tolist())): [
            float(x[k][tuple(w)]) for k in ("dT", "ferr", "tol", "to_melt",
                                            "Tsf")] for w in where}
                    for x in trace]
        print(json.dumps({"side": "reference", "dtype": name,
                          "flagged": bad.numpy().astype(int).tolist(),
                          "iterations": len(trace),
                          "iterates_dT_ferr_tol_melt_Tsf": iterates}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
