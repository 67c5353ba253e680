"""One window of a configuration that no cell runs yet, through the
harness's own `Side` and `run_window`, with no comparison (for a
configuration whose reference phases are still to be written):

    python -m benchmark.probe --workload <name> --overrides FILE \\
        --seed <n> --seconds <s> [--out FILE]

The cell's configuration and traffic with the groups of FILE merged over
them (as `harness/cli.py::main`'s overrides: "config", "traffic").  The
set-up and warm-up are the benchmark's; then one untraced window.  It
prints one JSON line: the window's steps, the failed check and its step
(or the program's error and the step that raised it), the step times,
the span totals, calls and counters of the window by name, and the
device's peak memory."""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

T_START = time.perf_counter()


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(prog="python -m benchmark.probe")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--overrides", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from .harness.cli import CACHE, power_limit
    from .harness.manifest import Cell, load_json
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    import os
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    cell = Cell(args.workload)
    cell.apply(load_json(args.overrides))
    conf, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    from seaice_tpu_torch.diagnostics import RECORDER

    from .harness.sides import Side
    from .harness.tracectx import percentile
    from .harness.window import run_window, sync
    out = {"workload": args.workload, "overrides": args.overrides,
           "seed": args.seed, "config": {k: conf.get(k) for k in
                                         ("column", "tracer_tree", "dtype",
                                          "mesh")}}
    prog = Side(conf, traffic, args.seed, device, getattr(torch,
                                                          conf["dtype"]))
    out["cells"] = prog.mesh.n_cells
    before = RECORDER.snapshot()
    try:
        for _ in range(traffic["warmup_steps"]):
            prog.step()
            flags = prog.check()
        sync(device)
        out["setup_s"] = time.perf_counter() - T_START
        out["warmup_flags"] = flags
        before = RECORDER.snapshot()
        w = run_window(prog, args.seconds, args.seed, 0)
        out.update(steps=w.steps, failed=w.failed, failures=w.failures,
                   window_s=w.window_s,
                   step_ms_median=percentile(w.step_ms, 50),
                   step_ms_p90=percentile(w.step_ms, 90),
                   step_ms_max=max(w.step_ms),
                   sypd=w.steps * conf["run"]["dt"] / (365.0 * w.window_s))
    except Exception as e:      # the program's own abort: report where
        out["error"] = f"{type(e).__name__}: {e}"
        out["error_at_step"] = prog.n_steps
        traceback.print_exc()
    totals, counts, counters = RECORDER.snapshot()
    t0, c0, k0 = before
    out["spans"] = {k: {"total_s": totals[k] - t0.get(k, 0.0),
                        "calls": counts[k] - c0.get(k, 0)}
                    for k in sorted(counts) if counts[k] != c0.get(k, 0)}
    out["counters"] = {k: v - k0.get(k, 0) for k, v in
                       sorted(counters.items()) if v != k0.get(k, 0)}
    if cuda:
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        out["card"] = power_limit()
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
