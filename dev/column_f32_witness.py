#!/usr/bin/env python3
"""The columns that the mushy Picard solve leaves unconverged on the QU60
sphere, caught on the card and written out for a replay on the CPU.

    python3 dev/column_f32_witness.py --seeds 4142135623 11 \\
        [--workload qu60_standard_physics.winter] [--overrides FILE] \\
        [--dtype float32] [--max-steps 120] [--out-dir build/column_f32_witness]

The benchmark's `Side` (the cell's configuration and traffic with the
override groups merged over them) steps each seed from its initial state,
the warm-up steps included, until the state check fails or --max-steps
have run.  At a failed `column_thermo_unconverged` check it writes the
flagged cells' inputs of that step, from the state before it, to
OUT_DIR/seed_<n>.npz: every tracer ("tracer_<name>"), the atmosphere and
ocean forcing ("atmos_<field>", "ocean_<field>"), coszen, lat,
day_of_year, the step and the card's flags.  Then it steps those cells'
column thermodynamics again on the card, alone, in float32 and in
float64, and prints the categories each flags and its Picard iterations.
One JSON line a seed."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workload", default="qu60_standard_physics.winter")
    ap.add_argument("--overrides", default=None)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--max-steps", type=int, default=120)
    ap.add_argument("--out-dir", default="build/column_f32_witness")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--subdiv", type=int, default=None,
                    help="another mesh subdivision (a small CPU trial)")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    from benchmark.harness.cli import power_limit
    from benchmark.harness.manifest import Cell, load_json
    from benchmark.harness.sides import Side, make_config
    from seaice_tpu_torch.column.driver import AtmosForcing, OceanForcing
    from seaice_tpu_torch.model import build_column_physics

    cell = Cell(args.workload)
    if args.overrides:
        cell.apply(load_json(args.overrides))
    conf, traffic = dict(cell.config), cell.traffic
    conf["dtype"] = args.dtype
    if args.subdiv is not None:
        conf["mesh"] = dict(conf["mesh"], subdivisions=args.subdiv)
    dtype = getattr(torch, args.dtype)
    t0 = time.perf_counter()
    side = Side(conf, traffic, args.seeds[0], args.device, dtype)
    print(json.dumps({"card": power_limit(), "built_s":
                      time.perf_counter() - t0}), flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = make_config(conf)
    for seed in args.seeds:
        side.seed_inputs(seed)
        out = {"seed": seed, "dtype": args.dtype}
        t1 = time.perf_counter()
        for n in range(args.max_steps):
            col = side.column
            i = side.n_steps % col["inputs"].per_day
            pre = {k: v.detach().clone()
                   for k, v in side.state.tracers.items()}
            doy = col["inputs"].day_of_year(side.n_steps)
            side.step()
            flags = side.check()
            if all(flags.values()):
                continue
            out["failed_step"] = n + 1
            out["flags"] = {k: v for k, v in flags.items() if not v}
            mask = side.warnings.get("thermo_unconverged")
            if mask is None or not bool(mask.any()):
                break
            cells = torch.nonzero(mask.any(-1))[:, 0]
            d = {"step": np.int64(n + 1), "seed": np.int64(seed),
                 "day_of_year": np.int64(doy),
                 "cell_index": cells.cpu().numpy(),
                 "flags": mask[cells].cpu().numpy(),
                 "lat": col["lat"][cells].double().cpu().numpy(),
                 "coszen": col["coszen"][i][cells].double().cpu().numpy()}
            for k, t in pre.items():
                d["tracer_" + k] = t[cells].double().cpu().numpy()
            for tag, f in (("atmos", col["atmos"][i]),
                           ("ocean", col["ocean"])):
                for fld in dataclasses.fields(f):
                    d[f"{tag}_{fld.name}"] = getattr(
                        f, fld.name)[cells].double().cpu().numpy()
            path = os.path.join(args.out_dir, f"seed_{seed}.npz")
            np.savez(path, **d)
            out["dump"] = path
            out["cells"] = d["cell_index"].tolist()
            out["flagged"] = d["flags"].astype(int).tolist()
            # the flagged cells alone, again, in both precisions
            for name, dt_ in (("float32", torch.float32),
                              ("float64", torch.float64)):
                phys = build_column_physics(cfg, dt_, torch.device(
                    args.device))

                def t(a):
                    return torch.as_tensor(a).to(args.device, dt_)
                tr = {k[7:]: t(v) for k, v in d.items()
                      if k.startswith("tracer_")}
                atm = AtmosForcing(**{k[6:]: t(v) for k, v in d.items()
                                      if k.startswith("atmos_")})
                ocn = OceanForcing(**{k[6:]: t(v) for k, v in d.items()
                                      if k.startswith("ocean_")})
                _, fl = phys.step_thermodynamics(
                    cfg.run.dt, tr, atm, ocn, coszen=t(d["coszen"]),
                    day_of_year=doy, lat=t(d["lat"]))
                m = fl.warnings["thermo_unconverged"]
                out[f"replay_{name}"] = {
                    "flagged": m.cpu().numpy().astype(int).tolist(),
                    "iterations": int(fl.thermo_iterations)}
            break
        out["steps"] = side.n_steps
        out["seconds"] = time.perf_counter() - t1
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
