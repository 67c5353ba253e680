"""The readings that a cell's limits are set from, in one process:

    python -m benchmark.calibrate --workload <name> --seeds 1 2 3 ...
        [--control-seeds 1 2 3] [--steps 6] [--out FILE]

The program, the reference (float64) and the control are built once; for
each seed the inputs are made anew, the program warms up and takes
`--steps` steps (as many as a window of the cell takes), and two of them
(the middle one and the last) are compared with the reference exactly as
a run of the benchmark compares them.  The
readings of sound runs give each number's lower reading.

The control takes the program's place on the same steps: the reference
computed in the nearest precision below the one that the configuration
states.  For float64 that is float32.  For float32 (no matrix products on
the path, so no TF32 to turn on) it is bfloat16: the reference computed
in float32 with its result held in bfloat16, the step a later change
would take to halve the bytes of the state.  Its readings give the upper
ones.  Beside them, the readings of four planted faults of the program's
step, made from the same states: the step returning its state unchanged,
half of the cells left unstepped, one answer (the ice volume) altered by
1% where the step produces it, and the velocity solve alone broken (the
program's whole-loop kernel ended after half of its elastic subcycles).

Each seed prints one JSON line; the last line gives, for each number, the
largest sound reading ("lower") and the smallest reading of the control
and of each fault ("least")."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .harness.compare import (Mapping, field_gaps, flat_spec, larger,
                               numbers, to_numpy, worst)
from .harness.manifest import Cell
from .harness.sides import Side, seed_reference, velocity_loop_cut_short
from .harness.window import sync
from .reference.model import Reference


# the configuration's precision -> (the control's, the type its result is
# held in, or None)
CONTROL = {"float64": (torch.float32, None),
           "float32": (torch.float32, torch.bfloat16)}


def held(fields: dict, dtype) -> dict:
    """The array fields rounded to dtype."""
    if dtype is None:
        return fields
    return {k: (np.asarray(torch.as_tensor(v).to(dtype).double())
                if np.ndim(v) else v) for k, v in fields.items()}


def faults(pre: dict, post: dict, n_cells: int, n_vertices: int) -> dict:
    """The program's result broken three ways, from its own states."""
    half = {}
    for k, b in post.items():
        a = pre[k]
        if np.ndim(b) and np.shape(b)[0] in (n_cells, n_vertices):
            m = np.arange(np.shape(b)[0]) % 2 == 0
            c = np.array(b, copy=True)
            c[m] = np.asarray(a)[m]
            half[k] = c
        else:
            half[k] = b
    altered = dict(post)
    altered["tracers.iceVolumeCategory"] = \
        np.asarray(post["tracers.iceVolumeCategory"]) * 1.01
    return {"unchanged": dict(pre), "half_cells": half, "altered": altered}


def readings(name, seeds, control_seeds, steps, device, overrides=None,
             entry=None):
    """Yields one dict of readings a seed (overrides, entry: as
    `harness.cli.main`'s)."""
    cell = Cell(name, entry=entry)
    cell.apply(overrides)
    conf, traffic = cell.config, cell.traffic
    spec = cell.limits["amounts"]
    dtype = getattr(torch, conf["dtype"])
    prog = Side(conf, traffic, seeds[0], device, dtype)
    ref = Reference(conf, device, torch.float64)
    ctl_dtype, hold = CONTROL[conf["dtype"]]
    ctl = Reference(conf, device, ctl_dtype, mesh=ref.mesh) \
        if control_seeds else None
    to_ref = Mapping(prog.mesh, ref.mesh)
    nc, nv = ref.mesh.n_cells, ref.mesh.n_vertices
    for seed in seeds:
        out = {"seed": seed}
        prog.seed_inputs(seed)
        for side in (ref,) + ((ctl,) if seed in control_seeds else ()):
            seed_reference(side, conf, traffic, seed)
        out["start_gap"] = worst(field_gaps(
            to_ref(to_numpy(prog.initial)), to_numpy(ref.state),
            flat_spec(spec)), 0)
        if seed in control_seeds:
            out["control_start_gap"] = worst(field_gaps(
                held(to_numpy(ctl.state), hold), to_numpy(ref.state),
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
                out["failed"] = flags
                break
            if not take:
                continue
            post = to_numpy(prog.snapshot())
            # the velocity solve broken, from the same state
            prog.load(pre)
            with velocity_loop_cut_short():
                prog.step()
            broken = to_ref(to_numpy(prog.snapshot()))
            prog.load(post)
            pre_r, post_r = to_ref(pre), to_ref(post)
            ref.load(pre_r)
            ref.step()
            sync(device)
            R = to_numpy(ref.state)
            readings_of = {"program": post_r,
                           **faults(pre_r, post_r, nc, nv),
                           "loop_cut_short": broken}
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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lows, least = {}, {}
    sink = open(args.out, "w") if args.out else None
    try:
        for r in readings(args.workload, args.seeds, args.control_seeds,
                          args.steps, "cuda"):
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
            lows["start_gap"] = max(lows.get("start_gap", 0.0),
                                    r["start_gap"][0])
            for k, v in r.get("program", {}).items():
                lows[k] = max(lows.get(k, 0.0), v[0])
            for kind in ("control", "unchanged", "half_cells", "altered",
                         "loop_cut_short"):
                got = least.setdefault(kind, {})
                for k, v in r.get(kind, {}).items():
                    got[k] = min(got.get(k, np.inf), v[0])
            if "control_start_gap" in r:
                c = least.setdefault("control", {})
                c["start_gap"] = min(c.get("start_gap", np.inf),
                                     r["control_start_gap"][0])
    finally:
        if sink:
            sink.close()
    print(json.dumps({"lower": lows, "least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
