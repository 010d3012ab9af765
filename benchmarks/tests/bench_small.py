"""Small sizes of the cells, for runs on the CPU."""

import copy
import time

from harness import runner, spec as S

SMALL = {"rows": 20_000}


def small(cell_name: str, spec=None, bench_dir=S.BENCH_DIR):
    """(spec, cell, config, traffic) of a cell at a size the CPU runs in
    seconds."""
    spec = spec or S.load_spec(bench_dir.parent)
    cell = S.find_cell(spec, cell_name)
    config = copy.deepcopy(S.load_config(cell["config"], bench_dir))
    traffic = copy.deepcopy(S.load_traffic(cell["traffic"], bench_dir))
    for k, v in SMALL.items():
        if k in config:
            config[k] = v
    return spec, cell, config, traffic


def run_small(cell_name: str, seconds: float = 1.0, trace: bool = False,
              seed: int = 2**31 + 7, bench_dir=S.BENCH_DIR) -> dict:
    """One CPU run of a cell at its small size; its result line."""
    spec, cell, config, traffic = small(cell_name, bench_dir=bench_dir)
    runner.prepare_env(bench_dir.parent, traffic)
    return runner.run_cell(spec, cell, seed, seconds, trace, "cpu",
                           time.perf_counter(), {}, config=config,
                           traffic=traffic, bench_dir=bench_dir)
