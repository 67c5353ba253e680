"""The readings that a column cell's limits are set from, in one process:

    python -m benchmark.calibrate_column --workload <name> --seeds 1 2 ...
        [--control-seeds 1 2] [--steps 6] [--out FILE]

As `calibrate.py` (the program, the reference in float64 and the control
built once; for each seed the inputs made anew, the warm-up, --steps
steps of which the middle one and the last are compared as a run of the
benchmark compares them), with the faults of the column beside the
generic ones: the same sampled step made again from the same state with
the program broken by each of `column_faults.COLUMN_FAULTS` (the mushy
Picard solve stopped after 2 iterations; the shortwave's absorption
zeroed).  The control is the reference in the nearest precision below
the configuration's (`calibrate.CONTROL`).  A broken step whose state
check fails (a column left unconverged, say) is listed under
"checks_failed": a run of the benchmark counts it failed.

Each seed prints one JSON line; the last line gives, for each number, the
largest sound reading ("lower") and the least reading of the control and
of each fault ("least")."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .calibrate import CONTROL, faults, held
from .column_faults import COLUMN_FAULTS
from .harness.compare import (Mapping, field_gaps, flat_spec, larger,
                               numbers, to_numpy, worst)
from .harness.manifest import Cell
from .harness.sides import Side, seed_reference, velocity_loop_cut_short
from .harness.window import sync
from .reference.model import Reference


def readings(name, seeds, control_seeds, steps, device, overrides=None,
             entry=None):
    """Yields one dict of readings a seed (overrides, entry: as
    `harness.cli.main`'s)."""
    cell = Cell(name, entry=entry)
    cell.apply(overrides)
    conf, traffic = cell.config, cell.traffic
    spec = cell.limits["amounts"]
    prog = Side(conf, traffic, seeds[0], device, getattr(torch,
                                                         conf["dtype"]))
    ref = Reference(conf, device, torch.float64)
    ctl_dtype, hold = CONTROL[conf["dtype"]]
    ctl = Reference(conf, device, ctl_dtype, mesh=ref.mesh) \
        if control_seeds else None
    to_ref = Mapping(prog.mesh, ref.mesh)
    nc, nv = ref.mesh.n_cells, ref.mesh.n_vertices
    broken_by = dict(COLUMN_FAULTS, loop_cut_short=velocity_loop_cut_short)
    for seed in seeds:
        out = {"seed": seed}
        prog.seed_inputs(seed)
        for side in (ref,) + ((ctl,) if seed in control_seeds else ()):
            seed_reference(side, conf, traffic, seed)
        out["start_gap"] = worst(field_gaps(
            to_ref(to_numpy(prog.initial)), to_numpy(ref.state),
            flat_spec(spec)), 0)
        for _ in range(traffic["warmup_steps"]):
            prog.step()
            prog.check()
        kinds = {}
        for i in range(steps):
            take = i in (steps // 2, steps - 1)
            pre = to_numpy(prog.snapshot()) if take else None
            prog.step()
            flags = prog.check()
            if not all(flags.values()):
                out["failed"] = {k: v for k, v in flags.items() if not v}
                break
            if not take:
                continue
            post = to_numpy(prog.snapshot())
            broken = {}
            for kind, fault in broken_by.items():
                prog.load(pre)
                with fault():
                    prog.step()
                broken[kind] = to_ref(to_numpy(prog.snapshot()))
                failed = [k for k, v in prog.check().items() if not v]
                if failed:
                    out.setdefault("checks_failed", {})[kind] = failed
            prog.load(post)
            pre_r, post_r = to_ref(pre), to_ref(post)
            ref.load(pre_r)
            ref.step()
            sync(device)
            R = to_numpy(ref.state)
            readings_of = {"program": post_r,
                           **faults(pre_r, post_r, nc, nv), **broken}
            if seed in control_seeds:
                ctl.load(pre_r)
                ctl.step()
                sync(device)
                readings_of["control"] = held(to_numpy(ctl.state), hold)
            for k, P in readings_of.items():
                kinds[k] = larger(kinds.get(k, {}),
                                  numbers(P, R, spec, pre_r))
        out.update(kinds)
        yield out


def summary(lines) -> dict:
    """The largest sound reading and the least reading of the control
    and of each fault, for each number."""
    lows, least = {}, {}
    for r in lines:
        lows["start_gap"] = max(lows.get("start_gap", 0.0),
                                r["start_gap"][0])
        for k, v in r.get("program", {}).items():
            lows[k] = max(lows.get(k, 0.0), v[0])
        for kind, got in r.items():
            if kind in ("seed", "start_gap", "program", "failed",
                        "checks_failed"):
                continue
            dst = least.setdefault(kind, {})
            for k, v in got.items():
                dst[k] = min(dst.get(k, np.inf), v[0])
    return {"lower": lows, "least": least}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate_column")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lines = []
    sink = open(args.out, "w") if args.out else None
    try:
        for r in readings(args.workload, args.seeds, args.control_seeds,
                          args.steps, "cuda"):
            lines.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
    finally:
        if sink:
            sink.close()
    print(json.dumps(summary(lines)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
