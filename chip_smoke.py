#!/usr/bin/env python3
"""Kernel-alone timer of the PyTorch/CUDA port (spark_rapids_jni_tpu_torch)
on one GPU.

    python3 chip_smoke.py [--out DIR] [--queries-only]

In order, it:

1. prints the card (``nvidia-smi --query-gpu=name,power.limit``) and
   builds the CUDA kernels K1-K8 from ``spark_rapids_jni_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all started together), timing
   the build;
2. holds each kernel against its plain PyTorch version on the card at
   stress shapes (exact equality required) and times it alone: K1 with
   15,811 build and 10M probe rows, K2 with 10M rows at widths 8192 and
   10 and values near +-2^63, K3 with 10M + 7 rows (once from a 16-byte
   boundary, once 5 bytes past one) and its table form on the validity
   bytes of a 12M-row, 32-field row matrix and of a 1M-row, 1500-field
   one, K4 and K5 over 10M int32 blocks and 10M int64 values with
   per-row seeds (one column of a 10M-row table hash), K6 and K7 on the
   12M-row, 32-column ``TestTables`` batch with 1% nulls as
   ``convert_to_rows`` and ``convert_from_rows`` hand it to them (two
   launches each: 10,737,408 and 1,262,592 rows below 2 GB), and K8 at
   q19's shape (28,800,991 sorted rows, partitions of about 58 rows,
   RANK) and q16's (10,500,000 rows, partitions of about 103,000,
   ROW_NUMBER), each under a random permutation, beside the two
   ``torch.cummax`` calls it replaced;
3. generates the TPC-DS miniature at sf=1000, seed 7 (a 10,000,000-row
   store_sales), ingests it on the card once and runs q1-q10
   through ``run_fused``, with every kernel launch count set to 0 just
   before and read just after; per query it prints the time, the rows,
   the route counters, the counted host syncs and the synchronising CUDA
   calls that ``torch.cuda.set_sync_debug_mode("warn")`` reports, then
   the warm time (median of 3);
4. runs q1-q10 once more, recording the inputs of every kernel call,
   and holds each kernel against its plain version on exactly those
   inputs (exact equality required);
5. requires every result to equal the port's pandas oracle (integers
   and decimals exact, floats within rtol=1e-9, atol=1e-9: atomic float
   sums change the accumulation order), ``rel.fused_fallbacks == 0``, at
   most one counted host sync a query and at least one launch of each
   of K1-K3 during q1-q10; then steps 3-5 again for q11-q20 (string,
   decimal and window operators) on the same ingested tables, its own
   path; it also requires q15's ``rel.route.decimal.overflow`` to equal
   the oracle's count of rows whose DECIMAL32 product passes 2^31 - 1,
   and q11, q12 and q20 to equal their oracles once more on
   ``SRT_STRING_ROUTE=bytes``, and K8 launched once for each of q16,
   q17, q19 and q20 (their ROW_NUMBER and RANK windows);
6. prints the ``kernels`` JSON line (K1-K8, each with its calls and
   launches on q1-q10 and q11-q20 and its stress readings), the card
   again, and as the last line ``{"ok": true, "device": {...}}``.

Every kernel time is device time from CUDA events, the median of 10 runs
after two warm-ups, with the queue held by a device-side sleep so that
the host's enqueue does not count. Beside it stand the plain version's
time, one PyTorch library call's time where one computes the same
function, and the bound: the larger of the bytes the function must move
over the card's 3.35 TB/s and its operations over 67 T/s, or, for K2,
the updates of its busiest slot at one shared-memory atomic per SM
clock. The ``kernels`` line sums each kernel over its calls on q1-q10
and q11-q20, with its stress cases beside.

The on-card parity checks of the port's other entry points (hashing,
row conversion, the roster, strings, the mesh, morsels, serving, the
batched graphs, the native engine) are ``tests/test_torch_cuda.py``
(``pytest -m cuda``); where the time of a whole request goes is the
benchmark's traced windows (``benchmarks/run.py --trace 1``).

It uses the first visible card only. It imports nothing of JAX nor of
the JAX package. Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result. ``--out DIR`` also
writes the build log, this output (``chip_smoke.log``) and a JSON
report there. ``--queries-only`` builds the kernels, then only times
q1-q20 (``query_times``) and prints their warm medians as its last line:
run it in two trees in turns to compare their query times.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column, Table, bitmask
from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc
from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES, generate
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12     # H100 SXM rate outside the tensor cores
PALLAS = "spark_rapids_jni_tpu/ops/pallas_kernels.py"
SF, SEED, REPS = 1000, 7, 10  # the main path's scale, its seed, timing runs
Q1_10 = tuple(f"q{i}" for i in range(1, 11))
Q11_20 = tuple(f"q{i}" for i in range(11, 21))
BYTES_ROUTE = ("q11", "q12", "q20")  # run again on SRT_STRING_ROUTE=bytes
Q_NAMES = ("hash_join_probe", "ragged_groupby_sum_count", "bitmask_pack")
WINDOW_NAMES = ("window_numbering",)  # K8, in q16, q17, q19 and q20
WINDOW_QUERIES = ("q16", "q17", "q19", "q20")  # ROW_NUMBER or RANK windows
OPLIB_NAMES = Q_NAMES + WINDOW_NAMES  # the paths that run q11-q20
# the kernels line: each kernel and its wrappers (K3 in both forms)
KERNELS = (("hash_join_probe", ("hash_join_probe",)),
           ("ragged_groupby_sum_count", ("ragged_groupby_sum_count",)),
           ("bitmask_pack", ("bitmask_pack", "bitmask_pack_fields")),
           ("murmur3_int32", ("murmur3_int32",)),
           ("murmur3_int64", ("murmur3_int64",)),
           ("pack_rows", ("pack_rows",)),
           ("unpack_rows", ("unpack_rows",)),
           ("window_numbering", ("window_numbering",)))
NAMES = tuple(w for _, ws in KERNELS for w in ws)
PATHS = ("q1-q10", "q11-q20")
# the wrappers as the port defines them (the recording pass swaps the
# module's names for recorders that call these)
WRAPPERS = {name: getattr(K, name) for name in NAMES}


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


# device clocks the queue is held before each timed run: about 2.5 ms,
# longer than the host takes to enqueue one wrapper call of a wide table
# (a 104-column K6 call checks 208 tensors), so that the enqueue stays
# out of the kernel's time
HOLD_CYCLES = 5_000_000


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events,
    after two warm-up runs. A device-side sleep ahead of each start
    event keeps the host's enqueue of ``fn`` out of the time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Card:
    """What the bounds need of the card: its SM count and top SM clock."""
    sms = 0
    sm_hz = 0.0

    @classmethod
    def read(cls) -> None:
        cls.sms = torch.cuda.get_device_properties(0).multi_processor_count
        cls.sm_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def bound(nbytes: int, ops: int, serial: int = 0) -> "tuple[float, str]":
    """Least time for the work, in ms, and what bounds it: the bytes over
    the memory rate, or the operations, the larger of ``ops`` over the
    scalar rate and ``serial`` updates that must follow one another in
    one SM, at one per clock."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / SCALAR_OPS_PER_S, serial / Card.sm_hz) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# --------------------------------------------------------------------------
# Each kernel against its plain version, on given inputs
# --------------------------------------------------------------------------

def k1_cost(build, probe, build_live=None, probe_live=None):
    """Bytes: the live build keys, the live probe keys and both masks
    read once, (idx, found) written once; ~16 integer operations per
    key hashed."""
    nb = int(build.numel() if build_live is None else build_live.sum())
    n = int(probe.numel())
    npl = n if probe_live is None else int(probe_live.sum())
    masks = (0 if build_live is None else build.numel()) + \
        (0 if probe_live is None else n)
    return 8 * (nb + npl) + masks + 5 * n, 16 * (nb + npl), 0, \
        f"build {build.numel()} ({nb} live), probe {n} ({npl} live), " \
        f"capacity {K.hash_table_capacity(build.numel())}"


def k2_cost(slots, live, values, width):
    """Bytes: every live flag, the slots of live rows and the values of
    live in-range rows read once, sums and counts written once.
    Serial: the rows of the busiest slot, spread evenly over every SM's
    copy of it, follow one another at one shared-memory atomic per
    address per clock (an assumed rate: none is published)."""
    n = int(slots.numel())
    ok = live & (slots >= 0) & (slots < width)
    n_live, n_ok = int(live.sum()), int(ok.sum())
    busiest = (int(torch.bincount(slots[ok].to(torch.int64),
                                  minlength=width).max()) if n_ok else 0)
    return (n + 4 * n_live + 8 * n_ok + 12 * width, 4 * n_ok,
            -(-busiest // Card.sms),
            f"{n} rows ({n_ok} live in range, busiest slot {busiest}), "
            f"width {width}")


def k3_cost(valid):
    n = int(valid.numel())
    return n + 4 * ((n + 31) // 32), n, 0, \
        f"{n} bool -> {(n + 31) // 32} uint32 words" + (
            f" ({valid.data_ptr() % 16} B past a 16-byte boundary)"
            if valid.data_ptr() % 16 else "")


def k3_fields_cost(vbytes, n_fields):
    """Bytes: each row's validity bytes read once, every column's words
    written once; one operation a bit."""
    n, nbytes = vbytes.shape
    words = (n + 31) // 32
    return n * nbytes + 4 * n_fields * words, n * n_fields, 0, \
        f"{n} rows x {n_fields} fields (row stride {vbytes.stride(0)} B) " \
        f"-> {n_fields} x {words} uint32 words"


def k4_cost(blocks, seeds):
    """Bytes: block and seed read, hash written (12 B a row); about 16
    integer operations a row."""
    n = int(blocks.numel())
    return 12 * n, 16 * n, 0, f"{n} int32 blocks"


def k5_cost(values, seeds):
    """Bytes: value and seed read, hash written (16 B a row); about 24
    integer operations a row."""
    n = int(values.numel())
    return 16 * n, 24 * n, 0, f"{n} int64 values"


def k6_cost(columns, widths, validity):
    """Bytes: every column value and validity word read once, the row
    image written once; a few integer operations per output word."""
    n = int(columns[0].numel())
    size = K.pack_plan(tuple(widths)).size_per_row
    nullable = sum(v is not None for v in validity)
    return (n * sum(widths) + nullable * 4 * ((n + 31) // 32) + n * size,
            n * size, 0, f"{n} rows x {len(widths)} columns ({nullable} "
            f"with validity) -> {size} B rows")


def k7_cost(rows, widths, dtypes=None):
    """Bytes: every row read once, every column value and validity word
    written once; a few integer operations a value."""
    n, size = rows.shape
    words = 4 * len(widths) * ((n + 31) // 32)
    return (n * size + n * sum(widths) + words, n * len(widths), 0,
            f"{n} rows of {size} B -> {len(widths)} columns and their "
            "validity words")


def k8_cost(order, part_head, tie_head=None, want=K.WINDOW_OUTPUTS):
    """Bytes: the permutation and each flag vector read once, each output
    written once (a scattered int64 store moves a 32-byte sector: the
    reachable share of this bound is near 40%); a few integer operations
    a row."""
    n = int(order.numel())
    flags = 1 + ("rank" in want)
    return (n * (8 + flags + 8 * len(want)), 8 * n, 0,
            f"{n} sorted rows, {int(part_head.sum())} partitions, "
            f"{'+'.join(want)}")


def k8_library(order, part_head, tie_head=None, want=K.WINDOW_OUTPUTS):
    """The two ``torch.cummax`` calls the window operator made before K8
    (partition starts and tie-run starts: it computed both whatever it
    was asked for), on their inputs."""
    pos = torch.arange(order.numel(), dtype=torch.int64, device=order.device)
    heads = [torch.where(f, pos, 0)
             for f in (part_head, part_head if tie_head is None
                       else tie_head)]

    def library():
        for h in heads:
            torch.cummax(h, 0)
    return library


def k2_library(slots, live, values, width):
    """One int64 ``index_add_`` of the live in-range values (the sums
    only: no single call also counts)."""
    ok = live & (slots >= 0) & (slots < width)
    parked = torch.where(ok, slots.to(torch.int64), width)
    acc = torch.zeros(width + 1, dtype=torch.int64, device=slots.device)

    def library():
        acc.zero_()
        acc.index_add_(0, parked, values.to(torch.int64))
    return library


SPECS = {
    "hash_join_probe": dict(
        source="spark_rapids_jni_tpu_torch/csrc/hash_join_probe.cu",
        replaces=f"{PALLAS}:480", plain=K.hash_join_probe_plain,
        cost=k1_cost, library=None, plain_reps=3),
    "ragged_groupby_sum_count": dict(
        source="spark_rapids_jni_tpu_torch/csrc/ragged_groupby.cu",
        replaces=f"{PALLAS}:604", plain=K.ragged_groupby_sum_count_plain,
        cost=k2_cost, library=k2_library,
        library_note="int64 index_add_, sums only", plain_reps=REPS),
    "bitmask_pack": dict(
        source="spark_rapids_jni_tpu_torch/csrc/bitmask_pack.cu",
        replaces=f"{PALLAS}:184", plain=K.bitmask_pack_plain,
        cost=k3_cost, library=None, plain_reps=REPS),
    "bitmask_pack_fields": dict(
        source="spark_rapids_jni_tpu_torch/csrc/bitmask_pack.cu",
        replaces=f"{PALLAS}:184", plain=K.bitmask_pack_fields_plain,
        cost=k3_fields_cost, library=None, plain_reps=3),
    "murmur3_int32": dict(
        source="spark_rapids_jni_tpu_torch/csrc/murmur3.cu",
        replaces=f"{PALLAS}:81", plain=K.murmur3_int32_plain,
        cost=k4_cost, library=None, plain_reps=REPS),
    "murmur3_int64": dict(
        source="spark_rapids_jni_tpu_torch/csrc/murmur3.cu",
        replaces=f"{PALLAS}:144", plain=K.murmur3_int64_plain,
        cost=k5_cost, library=None, plain_reps=REPS),
    "pack_rows": dict(
        source="spark_rapids_jni_tpu_torch/csrc/pack_rows.cu",
        replaces=f"{PALLAS}:311", plain=K.pack_rows_plain,
        cost=k6_cost, library=None, plain_reps=3),
    "unpack_rows": dict(
        source="spark_rapids_jni_tpu_torch/csrc/unpack_rows.cu",
        replaces="none (the reference decodes rows with jnp slices)",
        plain=K.unpack_rows_plain, cost=k7_cost, library=None,
        plain_reps=3),
    "window_numbering": dict(
        source="spark_rapids_jni_tpu_torch/csrc/window_numbering.cu",
        replaces="none (the reference numbers windows with jnp cummax)",
        plain=K.window_numbering_plain, cost=k8_cost, library=k8_library,
        library_note="the two torch.cummax calls", plain_reps=3),
}


def _launches(name: str, args: tuple) -> int:
    """The ``__global__`` launches one wrapper call on ``args`` makes: K1
    launches once when its table fits in shared memory, else its build and
    its probe; K2 once a call; the others once a call with rows."""
    if name == "hash_join_probe":
        shared = K.probe_table_shared(args[0].numel())
        return 0 if not args[1].numel() else 1 if shared else 2
    if name == "ragged_groupby_sum_count":
        return 1
    first = args[0][0] if name == "pack_rows" else args[0]
    return 1 if first.numel() else 0


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _outputs(out) -> list:
    """A wrapper's output tensors as int64, float ones by their bits (K7's:
    its columns, then its words)."""
    if isinstance(out, tuple) and isinstance(out[0], list):
        out = (*out[0], out[1])
    return [(t.view(_INT_OF_SIZE[t.element_size()]) if t.is_floating_point()
             else t).to(torch.int64)
            for t in (out if isinstance(out, tuple) else (out,))]


def measure(name: str, args: tuple, reps: int = REPS) -> dict:
    """Run kernel ``name`` and its plain version on ``args``; require
    exact equality; time the kernel, the plain version and the library
    call; bound the work (its bytes, and the launches of one call)."""
    spec = SPECS[name]
    wrapper, plain = WRAPPERS[name], spec["plain"]
    got, want = _outputs(wrapper(*args)), _outputs(plain(*args))
    torch.cuda.synchronize()
    err = max((int((g - w).abs().max()) if g.numel() else 0)
              for g, w in zip(got, want))
    nbytes, ops, serial, shape = spec["cost"](*args)
    _require(all(torch.equal(g, w) for g, w in zip(got, want)),
             f"{name} differs from its plain version on {shape} "
             f"(max_abs_err {err})")
    b_ms, b_by = bound(nbytes, ops, serial)
    library = spec["library"] and spec["library"](*args)
    return {"shape": shape, "max_abs_err": err, "bytes": nbytes,
            "launches": _launches(name, args),
            "ms": time_ms(lambda: wrapper(*args), reps),
            "plain_ms": time_ms(lambda: plain(*args),
                                min(reps, spec["plain_reps"])),
            "library_ms": time_ms(library, reps) if library else None,
            "bound_ms": b_ms, "bound_by": b_by}


def stress_cases(dev, gen, divisor: int = 1) -> "list[tuple[str, tuple]]":
    """K1: the customer table's 15,811 unique keys as the build side (10%
    dead), a 10M-row probe of hits, in-range misses and out-of-range keys
    (5% dead). K2: 10M rows over 8192 and over 10 slots, values near
    +-2^63 (the sums wrap mod 2^64), 20% dead rows and a few
    out-of-range slots. K3: 10M + 7 rows (the last word has padding
    bits), from a 16-byte boundary and 5 bytes past one; its table form on
    the validity bytes of a 12M-row row matrix of the 32-field schema
    (200-byte rows, bytes 196-199) and of a 1M-row one of 1500 one-byte
    fields (1688-byte rows, bytes 1500-1687), random bytes in place. K8
    (``window_cases``), then K4 and K5 (``hash_cases``), then K6 and K7
    (``row_cases``). Every row count but K1's build side is divided by
    ``divisor``: a small run of the same cases off the card."""
    n_build, n = 15_811, 10_000_000 // divisor
    space = 4 * n_build
    build = torch.randperm(space, generator=gen, device=dev)[:n_build]
    build_live = torch.rand(n_build, generator=gen, device=dev) > 0.1
    pick = torch.randint(0, n_build, (n,), generator=gen, device=dev)
    wild = torch.randint(-space, 2 * space, (n,), generator=gen, device=dev)
    use_hit = torch.rand(n, generator=gen, device=dev) < 0.6
    probe = torch.where(use_hit, build[pick], wild)
    probe_live = torch.rand(n, generator=gen, device=dev) > 0.05
    cases = [("hash_join_probe", (build, probe, build_live, probe_live))]
    mag = torch.randint(2**62, 2**63 - 1, (n,), generator=gen, device=dev)
    sign = torch.rand(n, generator=gen, device=dev) < 0.5
    values = torch.where(sign, -mag, mag)
    live = torch.rand(n, generator=gen, device=dev) > 0.2
    for width in (8192, 10):
        slots = torch.randint(-8, width + 8, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
        cases.append(("ragged_groupby_sum_count",
                      (slots, live, values, width)))
    flags = torch.rand(n + 16, generator=gen, device=dev) > 0.3
    cases += [("bitmask_pack", (flags[:n + 7],)),
              ("bitmask_pack", (flags[5:n + 12],))]
    for rows, row_bytes, voff, fields in ((12_000_000, 200, 196, 32),
                                          (1_000_000, 1688, 1500, 1500)):
        mat = torch.randint(0, 256, (rows // divisor, row_bytes),
                            generator=gen, device=dev, dtype=torch.uint8)
        cases.append(("bitmask_pack_fields",
                      (mat[:, voff:voff + (fields + 7) // 8], fields)))
    return (cases + window_cases(dev, gen, divisor)
            + hash_cases(dev, gen, divisor) + row_cases(dev, gen, divisor))


# K8 at the queries' shapes: (sorted rows, rows a partition on the
# average, share of rows opening a tie run, outputs)
WINDOW_SHAPES = ((28_800_991, 58, 0.1, ("rank",)),        # q19
                 (10_500_000, 103_000, 0.0, ("row_number",)))  # q16


def window_cases(dev, gen, divisor: int = 1) -> "list[tuple[str, tuple]]":
    """K8 at q19's shape (store_sales ranked by ss_sold_date_sk within
    ss_customer_sk: 500,000 customers' partitions, ties on a ticket's
    date) and q16's (the (store, item) groupby's slot rows numbered
    within 102 stores), each under a random permutation."""
    cases = []
    for n, run, ties, want in WINDOW_SHAPES:
        n //= divisor
        part = torch.rand(n, generator=gen, device=dev) < 1.0 / run
        part[:1] = True
        tie = part | (torch.rand(n, generator=gen, device=dev) < ties)
        order = torch.randperm(n, generator=gen, device=dev)
        cases.append(("window_numbering",
                      (order, part, tie if "rank" in want else None, want)))
    return cases


def hash_cases(dev, gen, divisor: int = 1) -> "list[tuple[str, tuple]]":
    """K4 over 10M random int32 blocks and K5 over 10M random int64
    values, each with random per-row int32 seeds: one column of a
    10M-row table hash, the running hash of the columns before it as the
    seeds."""
    n = 10_000_000 // divisor
    seeds = _randint(dev, gen, n, -2**31, 2**31, torch.int32)
    blocks = _randint(dev, gen, n, -2**31, 2**31, torch.int32)
    values = _randint(dev, gen, n, -2**63, 2**63 - 1)
    return [("murmur3_int32", (blocks, seeds)),
            ("murmur3_int64", (values, seeds))]


def row_cases(dev, gen, divisor: int = 1) -> "list[tuple[str, tuple]]":
    """K6 and K7 on ``ROWS_32COL``, the 12M-row, 32-column batch with 1%
    nulls (the ``rows_32col`` cells' shape), each call as
    ``convert_to_rows`` and ``convert_from_rows`` make it: one a batch
    below 2 GB."""
    _, n, share, repeats = ROWS_32COL
    table = rows_table(dev, gen, n // divisor, share, repeats)
    calls: list = []
    with recording(calls, [None]):
        for batch in rc.convert_to_rows(table):
            rc.convert_from_rows(batch, table.schema())
    return [(name, args) for _, name, args in calls
            if name in ("pack_rows", "unpack_rows")]


def _clone(x):
    """A copy of tensor ``x`` with its shape, strides and address modulo
    16 (so a recorded call is timed on the layout it had); other values
    as they are."""
    if not torch.is_tensor(x):
        return x
    if x.numel() == 0 or 0 in x.stride():
        return x.clone()
    span = 1 + sum((d - 1) * st for d, st in zip(x.shape, x.stride()))
    off = x.data_ptr() % 16 // x.element_size()
    buf = torch.empty(off + span, dtype=x.dtype, device=x.device)
    y = buf.as_strided(x.shape, x.stride(), off)
    y.copy_(x)
    return y


@contextlib.contextmanager
def recording(calls: list, query: list):
    """Swap each wrapper in ``cuda_kernels`` for one that records a copy
    of its inputs (``_clone``; and the query running, ``query[0]``) in
    ``calls``, then calls the wrapper."""
    def recorder(name):
        sig = inspect.signature(WRAPPERS[name])

        def record(*a, **kw):
            # a clone taken while a stream captures a graph holds nothing
            _require(not torch.cuda.is_current_stream_capturing(),
                     f"{name} recorded inside a graph capture")
            bound_args = sig.bind(*a, **kw)
            bound_args.apply_defaults()
            calls.append((query[0], name, tuple(
                _clone(x) for x in bound_args.args)))
            return WRAPPERS[name](*a, **kw)
        return record
    try:
        for name in NAMES:
            setattr(K, name, recorder(name))
        yield
    finally:
        for name in NAMES:
            setattr(K, name, WRAPPERS[name])


def path_kernels(calls: list, launches: dict, names: tuple, log,
                 reps: int = REPS) -> dict:
    """Hold every recorded call of a path against its plain version; sum
    each kernel's times (medians of ``reps`` runs) and bounds over its
    calls."""
    per_call: dict = {name: [] for name in names}
    for q, name, args in calls:
        r = measure(name, args, reps) | {"query": q}
        per_call[name].append(r)
        lib = ("" if r["library_ms"] is None
               else f" library_ms={r['library_ms']:.4f}")
        log(f"  {q} {name} on {r['shape']}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f}{lib} "
            f"bound_ms={r['bound_ms']:.4g} ({r['bound_by']})")
    recorded = {name: sum(_launches(name, args)
                          for _, n, args in calls if n == name)
                for name in names}
    _require(all(recorded[n] == launches.get(n, 0) for n in names),
             f"recorded launches {recorded} != the path's {launches}")
    totals = {}
    for name, rs in per_call.items():
        by = {"bytes": 0.0, "operations": 0.0}
        for r in rs:
            by[r["bound_by"]] += r["bound_ms"]
        libs = [r["library_ms"] for r in rs]
        totals[name] = {
            "calls": len(rs),
            "max_abs_err": max((r["max_abs_err"] for r in rs), default=0),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(by.values()),
            "bound_by": max(by, key=by.get),
            "library_ms": (None if not libs or None in libs
                           else sum(libs)),
            "per_call": rs}
    return totals


# --------------------------------------------------------------------------
# q1-q20 through the port's entry points, against the oracle
# --------------------------------------------------------------------------

def frames_match(got, want, qname: str) -> None:
    """The repo's bound (tests/test_tpcds.py): integers exact, floats
    within rtol=1e-9, atol=1e-9."""
    _require(list(got.columns) == list(want.columns),
             f"{qname} columns {list(got.columns)} != {list(want.columns)}")
    _require(len(got) == len(want), f"{qname} has {len(got)} rows, "
                                    f"oracle {len(want)}")
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64), rtol=1e-9,
                atol=1e-9, equal_nan=True, err_msg=f"{qname}.{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{qname}.{c}")


def _count_syncs(fn):
    """Run ``fn`` under set_sync_debug_mode("warn"); return (result,
    synchronising calls reported)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own first-use notice ("Synchronization debug mode is a
    # prototype feature") is not a synchronising call
    return out, sum("synchroniz" in str(w.message).lower()
                    and "prototype" not in str(w.message) for w in caught)


# the route counters a query line shows
ROUTE_PREFIXES = ("rel.route.join.probe.", "rel.route.groupby.dense.",
                  "rel.route.groupby.cuda", "rel.route.string.",
                  "rel.route.decimal.", "rel.route.window.")


def run_queries(path: str, queries: tuple, rels: dict, data: dict, dev,
                log) -> "tuple[dict, list]":
    """One main path: ``queries`` through ``run_fused`` with every launch
    count set to 0 just before and read just after (the cold run), then
    the warm times (median of 3), a pass recording every
    kernel call's inputs, and the checks: each result equal to its
    pandas oracle, no fused fallback, at most one counted host sync a
    query, K1-K3 each launched."""
    results, per_query = {}, {}
    before_all = kernel_stats()
    K.reset_launch_counts()
    for q in queries:
        before = kernel_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, syncs = _count_syncs(
            lambda q=q: run_fused(PLANS[q], rels, device=dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        results[q] = out.to_df()
        st = stats_since(before)
        routes = {k: v for k, v in st.items()
                  if k.startswith(ROUTE_PREFIXES)}
        per_query[q] = {"ms": ms, "rows": len(results[q]), "routes": routes,
                        "host_syncs": st.get("rel.host_syncs", 0),
                        "cuda_sync_calls": syncs}
    launches = dict(K.LAUNCHES)
    stats = stats_since(before_all)
    for q, r in per_query.items():
        log(f"{q}: ms={r['ms']:.3f} rows={r['rows']} "
            f"host_syncs={r['host_syncs']} "
            f"cuda_sync_calls={r['cuda_sync_calls']} "
            f"routes={json.dumps(r['routes'], sort_keys=True)}")
    log(f"{path} launches: {json.dumps(launches, sort_keys=True)}")

    # warm timings (the launch counts above are already read)
    for q in queries:
        _, syncs = _count_syncs(lambda q=q: run_fused(PLANS[q], rels,
                                                      device=dev))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_fused(PLANS[q], rels, device=dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_query[q]["warm_ms"] = statistics.median(times)
        per_query[q]["warm_cuda_sync_calls"] = syncs
        log(f"{q}: warm_ms={per_query[q]['warm_ms']:.3f} "
            f"warm_cuda_sync_calls={syncs}")

    # one more pass, recording the inputs of every kernel call
    calls, query = [], [None]
    with recording(calls, query):
        for q in queries:
            query[0] = q
            run_fused(PLANS[q], rels, device=dev)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    oracles = {q: QUERIES[q][1](data) for q in queries}
    oracle_s = time.perf_counter() - t0
    for q in queries:
        frames_match(results[q], oracles[q], q)
    log(f"oracle: {path} equal the pandas oracle (oracle_s={oracle_s:.3f})")
    _require(stats.get("rel.fused_fallbacks", 0) == 0,
             f"fused fallbacks: {stats}")
    for q, r in per_query.items():
        _require(r["host_syncs"] <= 1,
                 f"{q} counted {r['host_syncs']} host syncs")
    for name in Q_NAMES:
        _require(launches.get(name, 0) > 0,
                 f"kernel {name} was not launched on the {path} path")
    return {"per_query": per_query, "launches": launches,
            "oracle_s": oracle_s, "oracles": oracles}, calls


def run_main_path(dev, sf: float, seed: int, log):
    """Generate and ingest the TPC-DS miniature, then the q1-q10 path."""
    t0 = time.perf_counter()
    data = generate(sf=sf, seed=seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rels = {name: rel_from_df(df, device=dev) for name, df in data.items()}
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    rows = {k: len(v) for k, v in data.items()}
    log(f"data: sf={sf} seed={seed} generate_s={gen_s:.3f} "
        f"ingest_s={ingest_s:.3f} rows={json.dumps(rows)}")
    out, calls = run_queries("q1-q10", Q1_10, rels, data, dev, log)
    oracles = out.pop("oracles")
    return out | {"rows": rows, "generate_s": gen_s,
                  "ingest_s": ingest_s}, calls, rels, data, oracles


def wall_ms(fn, reps: int = 3) -> float:
    """Median host time of ``fn()`` ending in a synchronise, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def query_times(dev) -> dict:
    """q1-q20's warm times as the main paths take them (step 3): the
    miniature generated and ingested, a cold pass over the queries, then
    each query's ``wall_ms``; no checks."""
    data = generate(sf=SF, seed=SEED)
    rels = {name: rel_from_df(df, device=dev) for name, df in data.items()}
    del data
    queries = Q1_10 + Q11_20
    for q in queries:
        run_fused(PLANS[q], rels, device=dev)
    return {q: wall_ms(lambda q=q: run_fused(PLANS[q], rels, device=dev))
            for q in queries}


def overflow_rows(data: dict) -> int:
    """Rows of q15's DECIMAL32 product over 2^31 - 1, the oracle's way
    (exact Python integers)."""
    ss = data["store_sales"]
    prod = ss.ss_list_price_cents.astype(object) * ss.ss_coupon_amt_cents
    return int((prod > 2**31 - 1).sum())


def run_oplib_path(dev, rels: dict, data: dict, log
                   ) -> "tuple[dict, list, dict]":
    """The q11-q20 path (string, decimal and window operators) on the
    rels q1-q10 ran on; then q15's overflow count against the oracle's,
    and q11, q12, q20 again on the ``bytes`` string route. Returns the
    path's report, its kernel calls and the oracles' frames."""
    out, calls = run_queries("q11-q20", Q11_20, rels, data, dev, log)
    oracles = out.pop("oracles")
    overflow = out["per_query"]["q15"]["routes"].get(
        "rel.route.decimal.overflow", 0)
    want = overflow_rows(data)
    log(f"q15: rel.route.decimal.overflow={overflow} (the oracle's rows "
        f"over 2^31 - 1: {want})")
    _require(overflow == want and want > 0,
             f"q15 counted {overflow} overflows, the oracle {want}")
    out["q15_overflow"] = {"counted": overflow, "oracle": want}
    k8 = out["launches"].get("window_numbering", 0)
    _require(k8 == len(WINDOW_QUERIES),
             f"K8 launched {k8} times over q11-q20, want one for each of "
             f"{WINDOW_QUERIES}")
    os.environ["SRT_STRING_ROUTE"] = "bytes"
    try:
        for q in BYTES_ROUTE:
            before = kernel_stats()
            got = run_fused(PLANS[q], rels, device=dev).to_df()
            st = stats_since(before)
            routes = {k: v for k, v in st.items()
                      if k.startswith("rel.route.string.")}
            frames_match(got, oracles[q], f"{q} (bytes route)")
            _require(any(k.endswith(".bytes") for k in routes)
                     and st.get("rel.fused_fallbacks", 0) == 0,
                     f"{q} did not run fused on the bytes route: {st}")
            log(f"{q}: bytes route equal to the oracle's result, routes="
                f"{json.dumps(routes, sort_keys=True)}")
    finally:
        del os.environ["SRT_STRING_ROUTE"]
    return out, calls, oracles


# --------------------------------------------------------------------------
# Seeded data on the card: K4-K7's stress inputs
# --------------------------------------------------------------------------

# +-0.0, +-inf, NaN 0x7ff8..., 0xfff8... and 0x7ff0...01, as int64 bits
F64_SPECIALS = (0, -2**63, 0x7FF0000000000000, -0x10000000000000,
                0x7FF8000000000000, -0x8000000000000, 0x7FF0000000000001)
F32_SPECIALS = (0, -2**31, 0x7F800000, -0x800000, 0x7FC00000, -0x400000,
                0x7F800001)  # +-0.0, +-inf, NaN 0x7fc00000, 0xffc00000, sNaN


def _valid_words(dev, gen, n: int, null_share: float):
    if not null_share:
        return None
    return bitmask.pack(torch.rand(n, generator=gen, device=dev)
                        >= null_share)


def _with_specials(x: torch.Tensor, bits, every: int) -> torch.Tensor:
    """``x`` with every ``every``-th row set to the IEEE patterns
    ``bits`` in turn."""
    ints = x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)
    at = torch.arange(0, x.numel(), every, device=x.device)
    pats = torch.tensor(bits, dtype=ints.dtype, device=x.device)
    ints[at] = pats[torch.arange(at.numel(), device=x.device) % len(bits)]
    return x


def _randint(dev, gen, n, lo, hi, dtype=torch.int64):
    return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                         dtype=dtype)


# (label, rows, null share per column, repeats of the 8-type schema):
# the rows_32col cells' shape; it splits into two batches below 2 GB:
# 10,737,408 and 1,262,592 rows of 200 B
ROWS_32COL = ("12M rows, 1% nulls", 12_000_000, 0.01, 4)
# TestTables.java's eight types
ROW_TYPES = [T.INT64, T.FLOAT64, T.INT32, T.BOOL8, T.FLOAT32, T.INT8,
             T.decimal32(-3), T.decimal64(-8)]


def rows_table(dev, gen, n: int, null_share: float, repeats: int) -> Table:
    """The TestTables types repeated ``repeats`` times (4: its 32-column
    schema); the floats carry NaN payloads, +-0.0 and +-inf."""
    def data(dt):
        if dt.id == T.TypeId.FLOAT64:
            return _with_specials(torch.randn(
                n, generator=gen, device=dev, dtype=torch.float64),
                F64_SPECIALS, 101)
        if dt.id == T.TypeId.FLOAT32:
            return _with_specials(torch.randn(
                n, generator=gen, device=dev, dtype=torch.float32),
                F32_SPECIALS, 103)
        if dt.id == T.TypeId.BOOL8:
            return _randint(dev, gen, n, 0, 2, torch.int8)
        info = torch.iinfo(dt.to_torch())
        return _randint(dev, gen, n, info.min, info.max, dt.to_torch())
    return Table([Column(dt, n, data(dt),
                         _valid_words(dev, gen, n, null_share))
                  for dt in ROW_TYPES * repeats])


def kernel_entries(totals: dict, launches: dict, card: str, stress: list,
                   log) -> list:
    """The ``kernels`` line: each kernel of ``KERNELS`` summed over its
    wrappers' calls on ``PATHS`` (``totals`` and ``launches`` keyed by
    path and then wrapper), with each part's calls, launches and times
    beside, and its stress cases."""
    out = []
    for name, wrappers in KERNELS:
        spec = SPECS[name]
        ts = [(p, w, totals[p][w], launches[p].get(w, 0))
              for p in PATHS for w in wrappers if w in totals[p]]
        ts = [x for x in ts if x[2]["calls"] or x[3]]
        mine = [r for r in stress if r["name"] in wrappers]
        by = {"bytes": 0.0, "operations": 0.0}
        for _, _, t, _ in ts:
            for r in t["per_call"]:
                by[r["bound_by"]] += r["bound_ms"]
        libs = [t["library_ms"] for _, _, t, _ in ts]
        entry = {
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": sum(n for *_, n in ts),
            "calls": sum(t["calls"] for _, _, t, _ in ts),
            "path": " + ".join(dict.fromkeys(p for p, *_ in ts)) or "none",
            "max_abs_err": max([t["max_abs_err"] for _, _, t, _ in ts]
                               + [r["max_abs_err"] for r in mine]),
            "ms": sum(t["ms"] for _, _, t, _ in ts),
            "plain_ms": sum(t["plain_ms"] for _, _, t, _ in ts),
            "bound_ms": sum(by.values()), "bound_by": max(by, key=by.get),
            "library_ms": None if not libs or None in libs else sum(libs),
            "parts": [{"path": p, "wrapper": w, "calls": t["calls"],
                       "launches": n, **{k: t[k] for k in (
                           "ms", "plain_ms", "bound_ms", "library_ms")}}
                      for p, w, t, n in ts],
            "stress": [{k: r[k] for k in (
                "shape", "launches", "bytes", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} for r in mine]}
        out.append(entry)
        lib = ("none (no single PyTorch call computes it)"
               if entry["library_ms"] is None
               else f"{entry['library_ms']:.4f} "
               f"({spec.get('library_note')})")
        each = "; ".join(f"{x['path']} {x['wrapper']}: calls={x['calls']} "
                         f"launches={x['launches']} ms={x['ms']:.4f}"
                         for x in entry["parts"])
        alone = "; ".join(f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4g} "
                          f"({r['bound_ms'] / r['ms']:.1%})" for r in mine)
        log(f"kernel {name}: {entry['path']} calls={entry['calls']} "
            f"launches={entry['launches']} kernel_ms={entry['ms']:.4f} "
            f"plain_ms={entry['plain_ms']:.4f} "
            f"bound_ms={entry['bound_ms']:.4g} ({entry['bound_by']}) "
            f"library_ms={lib} [{each}] stress [{alone}] [{card}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the build log and a JSON report")
    ap.add_argument("--queries-only", action="store_true",
                    help="only time q1-q20 as step 3 does (a cold pass, "
                    "then each query's warm median of 3), without the "
                    "stress cases, oracles and kernel checks; print the "
                    "times as the last line, and no result")
    args = ap.parse_args(argv)
    # one card: the device count printed at the end is the one used
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    _require(torch.cuda.device_count() == 1, "more than one card visible")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    logfile = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        logfile = open(os.path.join(args.out, "chip_smoke.log"), "w")

    def log(line: str) -> None:
        print(line, flush=True)
        if logfile:
            logfile.write(line + "\n")
            logfile.flush()

    t0 = time.perf_counter()
    K.kernels()
    build_s = time.perf_counter() - t0
    log(f"kernels built: {K.library_path()} build_s={build_s:.3f}")
    if args.out:
        with open(os.path.join(args.out, "chip_smoke_build.log"), "w") as f:
            f.write(K.library_path().with_suffix(".log").read_text())
    if args.queries_only:
        print(json.dumps({"queries_warm_ms": query_times(dev)}), flush=True)
        return 0
    Card.read()
    log(f"card: {Card.sms} SMs, max SM clock {Card.sm_hz / 1e6:.0f} MHz")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    stress = []
    for name, case in stress_cases(dev, gen):
        r = measure(name, case) | {"name": name}
        stress.append(r)
        lib = ("" if r["library_ms"] is None
               else f" library_ms={r['library_ms']:.4f}")
        log(f"stress {name} on {r['shape']}: equal to its plain version; "
            f"launches={r['launches']} kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f}{lib} "
            f"bound_ms={r['bound_ms']:.4g} ({r['bound_by']}) [{card}]")

    main_path, calls, rels, data, oracles = run_main_path(dev, SF, SEED, log)
    log("main-path kernel calls, each equal to its plain version on the "
        "inputs q1-q10 gave it:")
    totals = {"q1-q10": path_kernels(calls, main_path["launches"], Q_NAMES,
                                     log)}
    del calls
    oplib, calls, _ = run_oplib_path(dev, rels, data, log)
    del rels, data, oracles
    log("q11-q20 kernel calls, each equal to its plain version on the "
        "inputs q11-q20 gave it:")
    totals["q11-q20"] = path_kernels(calls, oplib["launches"], OPLIB_NAMES,
                                     log)
    del calls

    kernels = kernel_entries(
        totals, {"q1-q10": main_path["launches"],
                 "q11-q20": oplib["launches"]}, card, stress, log)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke_report.json"),
                  "w") as f:
            json.dump({"card": card, "sms": Card.sms, "sm_hz": Card.sm_hz,
                       "build_s": build_s, "stress": stress,
                       "path_kernels": totals, "main_path": main_path,
                       "q11_q20": oplib, "sf": SF, "seed": SEED}, f,
                      indent=1, sort_keys=True, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
