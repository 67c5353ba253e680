#!/usr/bin/env python3
"""One run of a benchmark cell with its configuration's precision
replaced, through the benchmark's own entry (`benchmark.harness.cli.main`):

    python3 dev/column_cell_trial.py --workload qu60_standard_physics.winter \\
        --dtype float64 --seed <n> --seconds 51 --trace 0

Everything else is the cell's: its files, its window, its comparison with
the reference.  Prints what `python3 -m benchmark.run` prints."""

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--dtype", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", default="51")
    ap.add_argument("--trace", default="0")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark.harness.cli import main as run
    return run(["--workload", args.workload, "--seed", args.seed,
                "--seconds", args.seconds, "--trace", args.trace],
               overrides={"config": {"dtype": args.dtype}})


if __name__ == "__main__":
    sys.exit(main())
