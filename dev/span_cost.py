#!/usr/bin/env python3
"""What the program's spans cost on the card's host, on the benchmark's
cell `qu60_dycore.winter_caps` (the QU60 dynamical core, f32).

    python3 dev/span_cost.py [--seed N] [--steps 2000] [--loop 200000]
                             [--traced-rounds 2] [--traced-steps 10]
                             [--out FILE]

Builds the cell's program side as `benchmark/run.py` does and warms it
up, then:

  * loop: one span's enter and exit in a tight loop, `--loop` times, with
    the recorder (`seaice_tpu_torch.diagnostics.RECORDER`) enabled and
    disabled, and the profiler check alone; with the spans a step
    counted, the recorder's cost a step on this host;
  * untraced: `--steps` steps an arm, the recorder enabled and disabled
    step by step (on, off, off, on, ...), each step timed by CUDA events
    from its start to the end of its state check and fetch, as the
    benchmark's window times it: the median an arm and the median of
    the differences within each pair of neighbouring steps;
  * traced: `--traced-rounds` rounds of `--traced-steps` steps an arm
    under `torch.profiler` (host and device), in turns: the host clock a
    step, device kernels a step, and device operations named by a span.
    The first round with the recorder on is split by the program's spans
    (`benchmark/harness/spans.py`, paired by correlation id): device and
    idle ms a step by innermost span, their sum against the round's own
    idle (host clock less device busy), and where the step's
    synchronising calls are.

The per-layer metrics of a traced window come from the benchmark itself:
`python3 -m benchmark.run --workload qu60_dycore.winter_caps --trace 1`.
Prints one JSON line a part, the last one the summary; --out also writes
them to FILE."""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = []


def emit(obj):
    OUT.append(obj)
    print(json.dumps(obj), flush=True)


def step_ms(side):
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    side.step()
    side.check()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def loop_us(n):
    """us a call: a span's enter and exit, enabled and disabled, and the
    profiler check alone."""
    from seaice_tpu_torch.diagnostics import RECORDER, _profiling
    out = {}
    for on in (True, False):
        RECORDER.enabled = on
        t0 = time.perf_counter()
        for _ in range(n):
            with RECORDER.span("span_cost.loop"):
                pass
        out["span_on" if on else "span_off"] = \
            1e6 * (time.perf_counter() - t0) / n
    RECORDER.enabled = True
    t0 = time.perf_counter()
    for _ in range(n):
        _profiling()
    out["profiler_check"] = 1e6 * (time.perf_counter() - t0) / n
    return out


def traced_round(side, n):
    """n steps under the profiler: (wall ms a step, device ops, host ops),
    each op (name, start, end, correlation id)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            side.step()
            side.check()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        (dev if e.device_type == DeviceType.CUDA else host).append(
            (e.name, tr.start, tr.end, e.id))
    return wall, dev, host


def sync_sites(sp, host):
    """{(innermost span, innermost host operation around the call): n}
    for the synchronising calls inside `step` spans."""
    import bisect
    from benchmark.harness.spans import is_launch, is_sync
    segs = sp.segments()
    starts = [s for s, _, _ in segs]
    ops = sorted((op[1], op[2], op[0]) for op in host
                 if not (op[0].startswith(("seaice", "cu"))
                         or is_launch(op[0]) or is_sync(op[0])))
    out = {}
    for n, s, *_ in host:
        if not is_sync(n):
            continue
        i = segs[max(0, bisect.bisect_right(starts, s) - 1)][2]
        if i is None or not sp.within(i, "step"):
            continue
        around = [(oe - os_, on) for os_, oe, on in ops if os_ <= s < oe]
        key = f"{sp.spans[i].name} / {min(around)[1] if around else '-'}"
        out[key] = out.get(key, 0) + 1
    return out


def read_spans(dev, host, n, wall_ms):
    from benchmark.harness.spans import Spans
    sp = Spans(dev, host)
    out = {"paired": sp.ok, "launch_calls": sp.n_launches,
           "device_ops": sp.n_device, "launched_by": sorted(sp.launch_names),
           "unpaired": [[nm[:60], s] for nm, s in sp.unpaired[:5]],
           "spans": len(sp.spans)}
    if sp.ok:
        per = 1e3 * n
        idle = {str(k): v / per for k, v in sp.idle_by_innermost().items()}
        busy = sum(e - s for s, e in sp.busy) / per
        out["device_ms_by_innermost_span"] = {
            str(k): v / per for k, v in sp.device_by_innermost().items()}
        out["idle_ms_by_innermost_span"] = idle
        out["idle_split_sum_ms"] = sum(idle.values())
        out["round_idle_ms"] = wall_ms - busy
        out["busy_ms"] = busy
        out["host_sync_sites"] = sync_sites(sp, host)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2400000001)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--loop", type=int, default=200000)
    ap.add_argument("--traced-rounds", type=int, default=2)
    ap.add_argument("--traced-steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from benchmark.harness.cli import CACHE, power_limit
    from benchmark.harness.manifest import Cell
    from benchmark.harness.sides import Side
    from seaice_tpu_torch.diagnostics import RECORDER
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    torch.backends.cuda.matmul.allow_tf32 = False

    cell = Cell("qu60_dycore.winter_caps")
    t0 = time.perf_counter()
    side = Side(cell.config, cell.traffic, args.seed, "cuda",
                getattr(torch, cell.config["dtype"]))
    for _ in range(cell.traffic["warmup_steps"]):
        side.step()
        side.check()
    torch.cuda.synchronize()
    emit({"card": power_limit(), "torch": torch.__version__,
          "setup_s": time.perf_counter() - t0,
          "setup_spans_s": {k: v for k, v in RECORDER.totals.items()
                            if k.startswith("setup.")},
          "counters": dict(RECORDER.counters)})

    calls0 = sum(RECORDER.counts.values())
    for _ in range(5):
        step_ms(side)
    spans_a_step = (sum(RECORDER.counts.values()) - calls0) / 5
    loop = loop_us(args.loop)
    emit({"loop": dict(loop, loops=args.loop, spans_a_step=spans_a_step,
                       recorder_ms_a_step=spans_a_step * loop["span_on"]
                       / 1e3)})

    arms = {True: [], False: []}
    diffs = []
    for k in range(args.steps):
        pair = (True, False) if k % 2 == 0 else (False, True)
        ms = {}
        for on in pair:
            RECORDER.enabled = on
            ms[on] = step_ms(side)
            arms[on].append(ms[on])
        diffs.append(ms[True] - ms[False])
    RECORDER.enabled = True
    med = {on: statistics.median(v) for on, v in arms.items()}
    emit({"untraced": {"steps_an_arm": args.steps,
                       "median_ms_on": med[True], "median_ms_off": med[False],
                       "on_less_off_ms": med[True] - med[False],
                       "pair_differences_quartiles_ms":
                           statistics.quantiles(diffs, n=4),
                       "quartiles_on": statistics.quantiles(arms[True], n=4),
                       "quartiles_off": statistics.quantiles(arms[False],
                                                             n=4)}})

    traced = {True: [], False: []}
    kernels = {True: [], False: []}
    named = 0
    read = None
    order = []
    for r in range(args.traced_rounds):
        order += [True, False] if r % 2 == 0 else [False, True]
    for on in order:
        RECORDER.enabled = on
        n = args.traced_steps
        wall, dev, host = traced_round(side, n)
        traced[on].append(wall)
        kernels[on].append(sum(1 for d in dev if not d[0].startswith(
            ("Memcpy", "Memset"))) / n)
        named += sum(1 for d in dev if "seaice" in d[0])
        if on and read is None:
            read = read_spans(dev, host, n, wall)
            emit({"spans_read": read})
        del dev, host
    RECORDER.enabled = True
    emit({"summary": {
        "card": power_limit(),
        "loop_us": loop, "spans_a_step": spans_a_step,
        "untraced_median_ms": {"on": med[True], "off": med[False]},
        "traced_ms_a_step": {"on": traced[True], "off": traced[False]},
        "device_kernels_a_step": {"on": kernels[True],
                                  "off": kernels[False]},
        "device_ops_named_by_a_span": named,
        "paired": read["paired"] if read else None}})
    if args.out:
        with open(args.out, "w") as f:
            for o in OUT:
                f.write(json.dumps(o) + "\n")


if __name__ == "__main__":
    main()
