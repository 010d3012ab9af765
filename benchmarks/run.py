#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 benchmarks/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for. The last line of standard output is the result's
JSON; the numbers compared with the reference, each beside its limit,
are the last lines of standard error and the last key of the result.
Everything the cell needs is found by name from ``BENCHMARK.json``
(see ``benchmarks/README.md``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

from harness import runner, spec as S  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    spec = S.load_spec(ROOT)
    cell = S.find_cell(spec, args.workload)
    traffic = S.load_traffic(cell["traffic"])
    runner.prepare_env(ROOT, traffic)
    split = {}
    t = time.perf_counter()
    import torch
    split["torch_import_s"] = time.perf_counter() - t
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    split["cuda_init_s"] = time.perf_counter() - t
    line = runner.run_cell(spec, cell, args.seed, args.seconds,
                           bool(args.trace), "cuda", T0, split)
    bad = runner.forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}: the port's benchmark runs "
              "without JAX and the JAX package", file=sys.stderr)
        return 3
    runner.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
