#!/usr/bin/env python3
"""Where ``convert_from_rows`` spends the card's time, by caller.

    python3 tools/torch_profile_from_rows.py [--tree DIR] [--out FILE]

Builds the row-conversion tables of ``ROW_CASES`` (the 12M-row 32-column
case and the 1M-row 104-column case by default) on the card,
converts them to rows, and profiles one warm ``convert_from_rows`` of
every batch under ``torch.profiler`` with Python stacks. Each CUDA
kernel is charged to the PyTorch operator that launched it, under the
innermost frame of the PyTorch/CUDA port that called that operator
(``spark_rapids_jni_tpu_torch/...py(line): function / aten::op``), or
under ``(outside the port)`` where the profiler records no Python frame
for it (PyTorch 2.11 on the card records none: there the operator and
its launch count tell the callers apart); a kernel launched outside any
operator (the hand kernels, through ctypes) is charged to its own name.
It prints, per case, the warm wall time (median of 3, ending in a
synchronise), the device busy time and the split, largest first, with
each entry's launches.

The fixed-width columns come from ``chip_smoke.rows_table`` (the
timer's K6/K7 stress table), the STRING columns from ``string_column``
here, drawn after them from the same generator.

``--tree DIR`` imports ``chip_smoke.py`` and the port from another
checkout (for example an older commit unpacked beside this one), so two
trees are profiled by one script; that tree's ``rows_table`` must take
(device, generator, rows, null share, repeats). It needs a CUDA device
and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

PORT = "spark_rapids_jni_tpu_torch"
# (label, rows, null share per column, STRING columns, repeats of the
# 8-type schema); the third is chip_smoke.ROWS_32COL
ROW_CASES = [("1M rows, all valid", 1_000_000, 0.0, 0, 4),
             ("1M rows, 1% nulls", 1_000_000, 0.01, 0, 4),
             ("12M rows, 1% nulls", 12_000_000, 0.01, 0, 4),
             ("1M rows + 2 STRING columns", 1_000_000, 0.01, 2, 4),
             ("1M rows x 104 columns, 1% nulls", 1_000_000, 0.01, 0, 13)]
DEFAULT_CASES = ("12M rows, 1% nulls", "1M rows x 104 columns, 1% nulls")
# 2-byte UTF-8 units of the STRING column (ASCII pairs and é ü ж ß)
UTF8_UNITS = [b"ab", b"Zq", b"09", b"  ", "é".encode(), "ü".encode(),
              "ж".encode(), "ß".encode()]


def string_column(dev, gen, n: int, null_share: float):
    """0-32 bytes of UTF-8 a row (2-byte units, odd lengths end in an
    ASCII byte); a null row holds no bytes."""
    import torch
    from spark_rapids_jni_tpu_torch import types as T
    from spark_rapids_jni_tpu_torch.columnar import Column, bitmask
    valid = torch.rand(n, generator=gen, device=dev) >= null_share
    lens = torch.where(valid, torch.randint(0, 33, (n,), generator=gen,
                                            device=dev), 0)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offsets[1:])
    chars = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=dev)
    units = lens // 2
    row = torch.repeat_interleave(torch.arange(n, device=dev), units)
    first = torch.cumsum(units, 0) - units
    pos = offsets[row] + 2 * (torch.arange(row.numel(), device=dev)
                              - first[row])
    table = torch.tensor([list(u) for u in UTF8_UNITS], dtype=torch.uint8,
                         device=dev)
    pick = table[torch.randint(0, len(UTF8_UNITS), (row.numel(),),
                               generator=gen, device=dev)]
    chars[pos], chars[pos + 1] = pick[:, 0], pick[:, 1]
    odd = torch.nonzero(lens % 2 == 1)[:, 0]
    chars[offsets[odd + 1] - 1] = torch.randint(
        0x61, 0x7B, (odd.numel(),), generator=gen, device=dev,
        dtype=torch.uint8)
    return Column(T.STRING, n, None, bitmask.pack(valid), children=(
        Column(T.INT32, n + 1, offsets.to(torch.int32)),
        Column(T.UINT8, int(chars.numel()), chars)))


def rows_table(cs, dev, gen, n: int, null_share: float, strings: int,
               repeats: int):
    """``cs.rows_table``'s fixed-width columns plus ``strings`` STRING
    columns (10% null)."""
    from spark_rapids_jni_tpu_torch.columnar import Table
    t = cs.rows_table(dev, gen, n, null_share, repeats)
    return Table(list(t.columns) + [string_column(dev, gen, n, 0.1)
                                    for _ in range(strings)])


def _port_frame(name: str):
    """``package/path.py(line): function`` if ``name`` is a frame of the
    port, else None."""
    if PORT in name and ".py(" in name:
        return name[name.index(PORT):].strip()
    return None


def _where(e) -> str:
    """The innermost frame of the port that ran operator event ``e``,
    and the outermost PyTorch operator below that frame, as
    ``package/path.py(line): function / aten::op``. Where the profiler
    gives the operator its Python stack (innermost first), the frame
    comes from there (with the line of the call); else from the Python
    tracer's events, which parent the operators a call runs (named by
    the function's first line)."""
    op, p = e.name, e
    while p is not None:
        for frame in p.stack or ():
            found = _port_frame(frame)
            if found:
                return f"{found} / {op}"
        found = _port_frame(p.name)
        if found:
            return f"{found} / {op}"
        if p.name.startswith("aten::"):
            op = p.name
        p = p.cpu_parent
    return f"(outside the port) / {op}"


def split_by_caller(prof) -> "tuple[float, list]":
    """(busy ms, [(where, ms, launches)], largest first) of one profile
    (``_where``)."""
    from torch.autograd import DeviceType
    by: dict = {}
    owned = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        where = _where(e)
        ms, n = by.get(where, (0.0, 0))
        us = sum(k.duration for k in e.kernels)
        owned += us
        by[where] = (ms + us / 1e3, n + len(e.kernels))
    busy = 0.0
    loose: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy += e.time_range.elapsed_us()
            ms, n = loose.get(e.name, (0.0, 0))
            loose[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    # what no operator owns: the kernels launched through ctypes
    if busy - owned > 1.0:
        for name, (ms, n) in loose.items():
            if "_kernel" in name and "at::" not in name:
                by[f"kernel {name[:60]}"] = (ms, n)
    rows = sorted(((w, ms, n) for w, (ms, n) in by.items()),
                  key=lambda r: -r[1])
    return busy / 1e3, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="checkout whose chip_smoke.py and port to import")
    ap.add_argument("--cases", nargs="*", default=list(DEFAULT_CASES),
                    help="labels of ROW_CASES")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_from_rows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    rc = cs.rc
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"tree {tree}; card: {card}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    report = {"tree": tree, "card": card, "cases": []}
    for case in ROW_CASES:
        if case[0] not in args.cases:
            continue
        label = case[0]
        t = rows_table(cs, dev, gen, *case[1:])
        schema = t.schema()
        batches = rc.convert_to_rows(t)
        del t

        def run():
            return [rc.convert_from_rows(b, schema) for b in batches]
        run()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(times)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            run()
            torch.cuda.synchronize()
        busy, rows = split_by_caller(prof)
        print(f"{label}: convert_from_rows wall_ms={wall:.3f} "
              f"device_busy_ms={busy:.3f} [{card}]", flush=True)
        for where, ms, n in rows:
            print(f"  {ms:9.4f} ms  {n:5d} launches  {where}", flush=True)
        report["cases"].append({"case": label, "wall_ms": wall,
                                "device_busy_ms": busy,
                                "split": [{"where": w, "ms": ms,
                                           "launches": n}
                                          for w, ms, n in rows]})
        del batches
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
