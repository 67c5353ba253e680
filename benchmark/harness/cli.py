"""One run of one cell:

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Before anything is built, the reference's phases check the
configuration (`reference/model.py::check_config`): a cell whose physics
no phase steps ends here.  Set-up (counted in `setup_s`, from the
process's start): the program's model on the configuration's mesh, the
seeded initial state and wind (with the column on, also the column
forcing and a day's table of the sun), and the warm-up steps that build
every table and load every kernel (the
kernels' build cache is in `benchmark/.cache/` in the checkout).  Then the window (see
`window.py`).  Once it has closed, the device's peak memory is read, the
program is freed, and the reference checks the sampled steps (see
`compare.py`).  The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from .manifest import BENCH_DIR, Cell, metric_reader

CACHE = os.path.join(BENCH_DIR, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "seaice_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def device_info(device, n_chips):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n_chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit():
    """The card's name and power limit as nvidia-smi prints them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None, device=None, overrides=None, t_start=None,
         fault=None, entry=None):
    """Run one cell once; returns the exit code.  device, overrides, fault
    and entry serve the benchmark's own tests: a device other than the
    card (the CPU, skipping the look for a card); groups merged over the
    configuration, traffic and workload files' ("config", "traffic",
    "workload": a smaller mesh); a function that breaks the program's step
    (`fault(side)`, called once the program is built); a workload entry
    for a cell the manifest does not list."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch
    cell = Cell(args.workload, entry=entry)
    cell.apply(overrides)
    conf, traffic = cell.config, cell.traffic
    if not cell.limits.get("limits"):
        print(f"no result: no limits for {cell.name} in benchmark/workloads",
              file=sys.stderr)
        return 4
    from ..reference.model import check_config
    from .sides import check_inputs
    try:
        check_config(conf)
        check_inputs(conf, traffic)
    except (NotImplementedError, ValueError) as e:
        print(f"no result: {e}", file=sys.stderr)
        return 5
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"no result: the cell needs {cell.chips} CUDA device(s); "
                  f"torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = "cuda"
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    from .compare import to_numpy, verdict
    from .sides import Side
    from .tracectx import TraceContext, percentile
    from .window import run_window, sync

    dtype = getattr(torch, conf["dtype"])
    prog = Side(conf, traffic, args.seed, device, dtype)
    if fault is not None:
        fault(prog)
    for _ in range(traffic["warmup_steps"]):
        prog.step()
        prog.check()
    sync(device)
    setup_s = time.perf_counter() - t_start

    samples = cell.limits["samples"]
    w = run_window(prog, args.seconds, args.seed, samples,
                   traffic["trace_steps"] if args.trace else None)
    dev = device_info(device, cell.chips)
    mesh = prog.mesh
    metrics = {}
    breakdown = None
    if args.trace:
        extra = {"layout_s": prog.timings["layout_s"],
                 "itemsize": torch.empty((), dtype=dtype).element_size()}
        ctx = TraceContext(w, conf, {
            "n_cells": mesh.n_cells, "n_vertices": mesh.n_vertices,
            "max_edges": mesh.max_edges,
            "vertex_degree": mesh.vertex_degree}, extra)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.window_s
        breakdown = ctx.breakdown()
        del ctx                     # it holds the K2 calls' inputs
    else:
        dt = conf["run"]["dt"]
        e2e = {
            "sypd": w.steps * dt / (365.0 * w.window_s),
            "step_ms_p90": percentile(w.step_ms, 90),
            "peak_device_gib": dev["memory_peak_bytes"] / 2 ** 30,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # what the comparison needs, on the host; then the program is freed
    attempted, failed, failures = w.steps, w.failed, w.failures
    initial = to_numpy(prog.initial)
    sampled = [(to_numpy(pre), to_numpy(post)) for _, pre, post in
               w.samples]
    del prog, w
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers = check_with_reference(conf, traffic, args.seed, device, mesh,
                                   initial, sampled, cell.limits["amounts"])
    limits = cell.limits["limits"]
    values = {k: v for k, (v, _) in numbers.items() if k in limits}
    correct = verdict(values, limits, failed, attempted)
    # what the program, the harness or the reference loaded, since
    # sys.modules never shrinks
    found = forbidden_modules()
    if found:
        print(f"no result: the process holds {found}", file=sys.stderr)
        return 3

    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in values.items()}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    for msg in failures[:5]:
        print(f"failed: {msg}", file=sys.stderr)
    if cuda:
        print(f"card: {power_limit()}", file=sys.stderr)
    for k, (v, field) in numbers.items():
        if k not in limits:
            print(f"reading {k} = {v!r} ({field}), not compared",
                  file=sys.stderr)
    for k, (v, field) in numbers.items():
        if k in limits:
            print(f"compared {k} = {v!r} ({field}) limit {limits[k]!r}",
                  file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def check_with_reference(conf, traffic, seed, device, prog_mesh, initial,
                         sampled, spec):
    """The reference's side of the comparison: built from the same
    configuration, traffic and seed in float64 on its own mesh, it checks
    the start, then makes each sampled step from the program's state
    before it.  Returns {name: (value, worst amount)}."""
    from .compare import (Mapping, field_gaps, flat_spec, larger, numbers,
                          to_numpy, worst)
    from .sides import reference_side
    from .window import sync
    t0 = time.perf_counter()
    ref = reference_side(conf, traffic, seed, device)
    to_ref = Mapping(prog_mesh, ref.mesh)
    t1 = time.perf_counter()
    out = {"start_gap": worst(field_gaps(
        to_ref(initial), to_numpy(ref.state), flat_spec(spec)), 0)}
    for i, (pre, post) in enumerate(sampled):
        pre_r, post_p = to_ref(pre), to_ref(post)
        ref.load(pre_r)
        ref.step()
        sync(device)
        R = to_numpy(ref.state)
        for k, (st, inc) in sorted(field_gaps(post_p, R, flat_spec(spec),
                                              pre_r).items()):
            print(f"sample {i} {k}: state {st:.3e} increment {inc!r}",
                  file=sys.stderr)
        out = larger(out, numbers(post_p, R, spec, pre_r))
    print(f"reference: built in {t1 - t0:.1f} s, {len(sampled)} steps "
          f"checked in {time.perf_counter() - t1:.1f} s", file=sys.stderr)
    return out
