"""The control, the reference one precision below the configuration's
put in the program's place, comes out not correct: on three seeds at a
size the CPU holds (on the card it runs at the cell's own size through
``benchmarks/control.py``)."""

import pytest

from harness import spec as S

from bench_small import small

SEEDS = [1, 2, 2**31 + 5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [c["name"] for c in
                                  S.load_spec()["workloads"]])
def test_control_fails(cell, seed):
    _, c, config, traffic = small(cell)
    checks = S.load_driver(traffic["driver"]).control(config, traffic,
                                                      seed, "cpu")
    assert any(ch["value"] > ch["limit"] for ch in checks), checks
