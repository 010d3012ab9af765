"""``chip_smoke.py``'s kernel-alone timer, run small on the CPU.

Each of K1-K8 goes through ``chip_smoke.measure`` on its stress cases
(``stress_cases`` with every row count divided), with the CUDA event
timer and ``torch.cuda.synchronize`` stubbed and the card's SM count and
clock set. On the CPU each wrapper runs its plain version, so the
outputs agree by construction; what the cases hold is the timer itself:
every case builds, the wrapper and its plain version take the case's
arguments, and the byte count, the launch count and the bound come out
filled in. A changed kernel signature fails here before a chip run.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

DIVISOR = 10_000
KERNEL_WRAPPERS = dict(zip(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"),
                           (ws for _, ws in cs.KERNELS)))


@pytest.fixture(scope="module")
def cases():
    gen = torch.Generator().manual_seed(cs.SEED)
    with pytest.MonkeyPatch.context() as mp:
        # the row cases record the port's wrapper calls, which ask
        # whether a graph capture is running
        mp.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        return cs.stress_cases(torch.device("cpu"), gen, DIVISOR)


@pytest.mark.parametrize("kernel", list(KERNEL_WRAPPERS))
def test_timer_measures_each_kernel_on_its_stress_cases(kernel, cases,
                                                        monkeypatch):
    timed = []

    def time_ms(fn, reps):
        fn()
        timed.append(reps)
        return 1.0
    monkeypatch.setattr(cs, "time_ms", time_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs.Card, "sms", 132)
    monkeypatch.setattr(cs.Card, "sm_hz", 1.98e9)
    mine = [(name, args) for name, args in cases
            if name in KERNEL_WRAPPERS[kernel]]
    assert mine, f"{kernel} has no stress case"
    for name, args in mine:
        r = cs.measure(name, args)
        assert r["max_abs_err"] == 0, (name, r["shape"])
        assert r["bytes"] > 0 and r["launches"] >= 1, (name, r)
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes",
                                                       "operations")
        assert r["ms"] == r["plain_ms"] == 1.0
        assert (r["library_ms"] is None) == (cs.SPECS[name]["library"]
                                             is None)
        assert r["shape"]
    # the kernel, its plain version and (where one exists) its library
    # call ran once a case
    assert len(timed) == sum(2 + (cs.SPECS[n]["library"] is not None)
                             for n, _ in mine)
