#!/usr/bin/env python3
"""Run a cell's control on several seeds and print what it reads.

    python3 benchmarks/control.py --workload <name> --seeds 1,2,3

The control is the plain reference put in the program's place and
computed one precision below the configuration's (each driver's
``control``). Every number it reads has to fail its limit on some
check of the cell: that is what shows the comparison can fail. Runs at
the cell's own size, on the card where the cell's data lives there.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import runner, spec as S  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cell = S.find_cell(S.load_spec(), args.workload)
    traffic = S.load_traffic(cell["traffic"])
    runner.prepare_env(S.ROOT, traffic)
    config = S.load_config(cell["config"])
    driver = S.load_driver(traffic["driver"])
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        checks = driver.control(config, traffic, seed, args.device)
        fails = any(c["value"] > c["limit"] for c in checks)
        failed_all &= fails
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_fails": fails, "seconds":
                          time.perf_counter() - t, "checks": checks}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
