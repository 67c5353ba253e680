"""Entry point: `python -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout (see
`harness/cli.py`)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from benchmark.harness.cli import main

    sys.exit(main(t_start=T_START))
