#!/usr/bin/env python3
"""Which tracer product the remap fails to conserve in the float32
file-driven run of `chip_smoke.py`, and by how much.

    python3 dev/file_run_conservation.py [--steps 240] [--limit 1e-5]
                                         [--subdiv 6] [--subcycles 120]
                                         [--device cuda|cpu]

Runs the f32 file-driven run (the subdiv-6 MPAS file of
`tests/mpas_fixture.py`, CORE and NCAR forcing, `StandaloneRunner`, the
north-star column) with a wrapper around the model's remap step that
computes, before and after every remap, the global sum of every tracer
product twice: in float32 as the model's own check does
(`transport/remap.py::global_conserved_sums`, relative change =
`ir_conservation_error`), and from the same float32 fields accumulated
in float64.  Prints one JSON line for every step whose float32 error
passes `--limit`: the product, both errors, the sums before and after,
and the sum of the product's absolute values (against which a sum that
cancels is small).  A last line gives each product's largest errors
over the run.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--limit", type=float, default=1e-5)
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import chip_smoke as cs
    from seaice_tpu_torch import model as model_mod
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu_torch.run import StandaloneRunner
    from seaice_tpu_torch.transport.remap import (mass_tracer_products,
                                                  to_transport_fields)

    cs.SUBDIV, cs.N_SUBCYCLES = args.subdiv, args.subcycles
    if torch.cuda.is_available():
        print(cs.card_line(), flush=True)
    records = []

    def sums(tree, tr, area):
        prods = mass_tracer_products(tree, to_transport_fields(tree, tr))
        out = {}
        for name, p in prods.items():
            a = area.reshape(area.shape + (1,) * (p.ndim - 1))
            out[name] = torch.stack([(p * a).sum().double(),
                                     (p.double() * a.double()).sum(),
                                     (p.double() * a.double()).abs().sum()])
        return out

    make = model_mod.make_remap_step

    def recording_make(tree, *a, **kw):
        step = make(tree, *a, **kw)

        def wrapped(remap_t, coc, cocm, area, tr, *rest):
            pre = sums(tree, tr, area)
            out = step(remap_t, coc, cocm, area, tr, *rest)
            post = sums(tree, out, area)
            records.append({k: torch.stack([pre[k], post[k]]).cpu()
                            for k in pre})
            return out
        return wrapped

    workdir = tempfile.mkdtemp(prefix="file_run_conservation_")
    model_mod.make_remap_step = recording_make
    try:
        mesh, atmos, ocean = cs.file_inputs(workdir)
        model = SeaIceModel(mesh, cs.file_config(), dtype=torch.float32,
                            device=args.device)
        runner = StandaloneRunner(
            model, initial_state_from_setup(model,
                                            RunSetup(**cs.FILE_SETUP)),
            atmos_forcing=atmos, ocean_forcing=ocean)
        worst = {}
        for i in range(1, args.steps + 1):
            records.clear()
            runner.run(1)
            for rec in records:
                for name, v in rec.items():
                    (p32, p64, pabs), (q32, q64, _) = v.tolist()
                    e32 = abs(q32 - p32) / max(abs(p32), 1e-30)
                    e64 = abs(q64 - p64) / max(abs(p64), 1e-30)
                    w = worst.setdefault(name, [0.0, 0.0, 0])
                    w[0], w[1] = max(w[0], e32), max(w[1], e64)
                    if e32 > args.limit:
                        w[2] += 1
                        print(json.dumps({
                            "step": i, "clock": runner.clock.timestamp(),
                            "product": name, "rel_err_f32_sum": e32,
                            "rel_err_f64_sum": e64, "sum_before": p64,
                            "sum_after": q64, "sum_abs_before": pabs}),
                            flush=True)
        print(json.dumps({"steps": args.steps, "worst_by_product": {
            k: {"f32_sum": v[0], "f64_sum": v[1], "steps_over_limit": v[2]}
            for k, v in worst.items()}}), flush=True)
    finally:
        model_mod.make_remap_step = make
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
