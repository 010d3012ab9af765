#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_jni_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR] [--profile]

In order, it:

1. prints the card (``nvidia-smi --query-gpu=name,power.limit``) and
   builds the CUDA kernels K1-K3 from ``spark_rapids_jni_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all started together), timing
   the build;
2. holds each kernel against its plain PyTorch version on the card at
   stress shapes (exact equality required): K1 with 15,811 build and 10M
   probe rows, K2 with 10M rows at widths 8192 and 10 and values near
   +-2^63, K3 with 10M + 7 rows;
3. generates the TPC-DS miniature at sf=1000, seed 7 (a 10,000,000-row
   store_sales), ingests it on the card and runs q1-q10
   through ``run_fused``, with every kernel launch count set to 0 just
   before and read just after; per query it prints the time, the rows,
   the route counters and the synchronising CUDA calls that
   ``torch.cuda.set_sync_debug_mode("warn")`` reports;
4. runs q1-q10 once more, recording the inputs of every kernel call,
   and holds each kernel against its plain version on exactly those
   inputs (exact equality required);
5. requires every result to equal the port's pandas oracle (integers
   exact, floats within rtol=1e-9, atol=1e-9: atomic float sums change
   the accumulation order), ``rel.fused_fallbacks == 0`` and at least one
   launch of each kernel during q1-q10;
6. prints the ``kernels`` JSON line, the card again, and as the last line
   ``{"ok": true, "device": {...}}``.

Every kernel time is device time from CUDA events, the median of 10 runs
after two warm-ups, with the queue held by a device-side sleep so that
the host's enqueue does not count. Beside it stand the plain version's
time, one PyTorch library call's time where one computes the same
function, and the bound: the larger of the bytes the function must move
over the card's 3.35 TB/s and its operations over 67 T/s, or, for K2,
the updates of its busiest slot at one shared-memory atomic per SM
clock. The ``kernels`` line sums each kernel over its q1-q10 calls.

``--profile`` adds one warm run per query under ``torch.profiler``: the
device time of its kernels, the device's idle share of the warm wall
time, and the kernels that took most of it.

It uses the first visible card only. It imports nothing of JAX nor of
the JAX package. Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result. ``--out DIR`` also
writes the build log and a JSON report there.
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

from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K
from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES, generate
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12     # H100 SXM rate outside the tensor cores
PALLAS = "spark_rapids_jni_tpu/ops/pallas_kernels.py"
SF, SEED, REPS = 1000, 7, 10  # the main path's scale, its seed, timing runs
NAMES = ("hash_join_probe", "ragged_groupby_sum_count", "bitmask_pack")
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
        torch.cuda._sleep(1_000_000)
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
        f"{n} bool -> {(n + 31) // 32} uint32 words"


def k2_library(slots, live, values, width):
    """One int64 ``index_add_`` of the live in-range values (the sums
    only: no single call also counts)."""
    ok = live & (slots >= 0) & (slots < width)
    parked = torch.where(ok, slots.to(torch.int64), width)
    acc = torch.zeros(width + 1, dtype=torch.int64, device=slots.device)

    def library():
        acc.zero_()
        acc.index_add_(0, parked, values)
    return library


SPECS = {
    "hash_join_probe": dict(
        source="spark_rapids_jni_tpu_torch/csrc/hash_join_probe.cu",
        replaces=f"{PALLAS}:480", plain=K.hash_join_probe_plain,
        cost=k1_cost, library=None, plain_reps=3),
    "ragged_groupby_sum_count": dict(
        source="spark_rapids_jni_tpu_torch/csrc/ragged_groupby.cu",
        replaces=f"{PALLAS}:604", plain=K.ragged_groupby_sum_count_plain,
        cost=k2_cost, library=k2_library, plain_reps=REPS),
    "bitmask_pack": dict(
        source="spark_rapids_jni_tpu_torch/csrc/bitmask_pack.cu",
        replaces=f"{PALLAS}:184", plain=K.bitmask_pack_plain,
        cost=k3_cost, library=None, plain_reps=REPS),
}


def _outputs(out) -> list:
    return [t.to(torch.int64) for t in (out if isinstance(out, tuple)
                                        else (out,))]


def measure(name: str, args: tuple, reps: int = REPS) -> dict:
    """Run kernel ``name`` and its plain version on ``args``; require
    exact equality; time the kernel, the plain version and the library
    call; bound the work."""
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
    return {"shape": shape, "max_abs_err": err,
            "ms": time_ms(lambda: wrapper(*args), reps),
            "plain_ms": time_ms(lambda: plain(*args), spec["plain_reps"]),
            "library_ms": time_ms(library, reps) if library else None,
            "bound_ms": b_ms, "bound_by": b_by}


def stress_cases(dev, gen) -> "list[tuple[str, tuple]]":
    """K1: the customer table's 15,811 unique keys as the build side (10%
    dead), a 10M-row probe of hits, in-range misses and out-of-range keys
    (5% dead). K2: 10M rows over 8192 and over 10 slots, values near
    +-2^63 (the sums wrap mod 2^64), 20% dead rows and a few
    out-of-range slots. K3: 10M + 7 rows (the last word has padding
    bits)."""
    n_build, n = 15_811, 10_000_000
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
    cases.append(("bitmask_pack",
                  (torch.rand(n + 7, generator=gen, device=dev) > 0.3,)))
    return cases


@contextlib.contextmanager
def recording(calls: list, query: list):
    """Swap each wrapper in ``cuda_kernels`` for one that records a copy
    of its inputs (and the query running, ``query[0]``) in ``calls``,
    then calls the wrapper."""
    def recorder(name):
        sig = inspect.signature(WRAPPERS[name])

        def record(*a, **kw):
            bound_args = sig.bind(*a, **kw)
            bound_args.apply_defaults()
            calls.append((query[0], name, tuple(
                x.clone() if torch.is_tensor(x) else x
                for x in bound_args.args)))
            return WRAPPERS[name](*a, **kw)
        return record
    try:
        for name in NAMES:
            setattr(K, name, recorder(name))
        yield
    finally:
        for name in NAMES:
            setattr(K, name, WRAPPERS[name])


def main_path_kernels(calls: list, launches: dict, log) -> dict:
    """Hold every recorded main-path call against its plain version;
    sum each kernel's times and bounds over its calls."""
    per_call: dict = {name: [] for name in NAMES}
    for q, name, args in calls:
        r = measure(name, args) | {"query": q}
        per_call[name].append(r)
        lib = ("" if r["library_ms"] is None
               else f" library_ms={r['library_ms']:.4f}")
        log(f"  {q} {name} on {r['shape']}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f}{lib} "
            f"bound_ms={r['bound_ms']:.4g} ({r['bound_by']})")
    recorded = {name: sum(2 if name == "hash_join_probe"
                          and args[0].numel() else 1
                          for _, n, args in calls if n == name)
                for name in NAMES}
    _require(all(recorded[n] == launches.get(n, 0) for n in NAMES),
             f"recorded launches {recorded} != main path's {launches}")
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
# q1-q10 through the port's entry points, against the oracle
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
    return out, sum("synchroniz" in str(w.message).lower() for w in caught)


def profile_queries(rels, dev, per_query: dict, log) -> None:
    """One warm run per query under ``torch.profiler``: the device time
    of its CUDA kernels, its share of the unprofiled warm wall time, and
    the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for q in QUERIES:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_fused(PLANS[q], rels, device=dev)
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us = e.time_range.elapsed_us()
                n, t = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, t + us)
        busy_ms = sum(t for _, t in by_name.values()) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        r = per_query[q]
        r["device_busy_ms"] = busy_ms if by_name else None
        r["device_kernels"] = sum(n for n, _ in by_name.values())
        r["top_kernels"] = [{"name": k[:90], "launches": n, "ms": t / 1e3}
                            for k, (n, t) in top]
        idle = (None if not by_name
                else max(0.0, 1.0 - busy_ms / r["warm_ms"]))
        r["device_idle_share"] = idle
        log(f"{q}: profile device_busy_ms="
            f"{'not measured' if not by_name else f'{busy_ms:.3f}'} "
            f"kernels={r['device_kernels']} idle_share="
            f"{'not measured' if idle is None else f'{idle:.3f}'} top="
            + json.dumps([(t['name'][:48], t['launches'], round(t['ms'], 3))
                          for t in r["top_kernels"]]))


def run_main_path(dev, sf: float, seed: int, log,
                  profile: bool = False) -> dict:
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

    # the main path: counts to 0 just before, read just after
    results, per_query = {}, {}
    before_all = kernel_stats()
    K.reset_launch_counts()
    for q in QUERIES:
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
                  if k.startswith(("rel.route.join.probe.",
                                   "rel.route.groupby.dense.",
                                   "rel.route.groupby.cuda"))}
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
    log(f"main path launches: {json.dumps(launches, sort_keys=True)}")

    # warm timings (the launch counts above are already read)
    for q in QUERIES:
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
    if profile:
        profile_queries(rels, dev, per_query, log)

    # one more pass, recording the inputs of every kernel call
    calls, query = [], [None]
    with recording(calls, query):
        for q in QUERIES:
            query[0] = q
            run_fused(PLANS[q], rels, device=dev)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for q, (_, oracle) in QUERIES.items():
        frames_match(results[q], oracle(data), q)
    log(f"oracle: q1-q10 equal the pandas oracle "
        f"(oracle_s={time.perf_counter() - t0:.3f})")
    _require(stats.get("rel.fused_fallbacks", 0) == 0,
             f"fused fallbacks: {stats}")
    for name in NAMES:
        _require(launches.get(name, 0) > 0,
                 f"kernel {name} was not launched on the main path")
    return {"per_query": per_query, "launches": launches, "rows": rows,
            "generate_s": gen_s, "ingest_s": ingest_s}, calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the build log and a JSON report")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm run of each query")
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
    log = lambda line: print(line, flush=True)  # noqa: E731

    t0 = time.perf_counter()
    K.kernels()
    build_s = time.perf_counter() - t0
    log(f"kernels built: {K.library_path()} build_s={build_s:.3f}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_build.log"), "w") as f:
            f.write(K.library_path().with_suffix(".log").read_text())
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
            f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}{lib} "
            f"bound_ms={r['bound_ms']:.4g} ({r['bound_by']}) [{card}]")

    main_path, calls = run_main_path(dev, SF, SEED, log,
                                     profile=args.profile)
    log("main-path kernel calls, each equal to its plain version on the "
        "inputs q1-q10 gave it:")
    totals = main_path_kernels(calls, main_path["launches"], log)
    del calls
    kernels = []
    for name in NAMES:
        t, spec = totals[name], SPECS[name]
        launches = main_path["launches"][name]
        lib = ("none (no single PyTorch call computes it)"
               if t["library_ms"] is None
               else f"{t['library_ms']:.4f} (int64 index_add_, sums only)")
        log(f"kernel {name}: q1-q10 calls={t['calls']} launches={launches} "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4g} ({t['bound_by']}) "
            f"library_ms={lib} [{card}]")
        kernels.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches,
            "calls": t["calls"],
            "max_abs_err": max([t["max_abs_err"]] + [
                r["max_abs_err"] for r in stress if r["name"] == name]),
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            "stress": [{k: r[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")} for r in stress if r["name"] == name]})
    if args.out:
        with open(os.path.join(args.out, "chip_smoke_report.json"),
                  "w") as f:
            json.dump({"card": card, "sms": Card.sms, "sm_hz": Card.sm_hz,
                       "build_s": build_s, "stress": stress,
                       "main_path_kernels": totals, "main_path": main_path,
                       "sf": SF, "seed": SEED}, f, indent=1, sort_keys=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
