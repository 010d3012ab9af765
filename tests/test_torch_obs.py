"""The port's obs layer against the reference's (``tests/test_obs.py``).

Held on the CPU, on the same inputs in both packages:

1. **Disabled no-ops**: with ``SRT_METRICS`` off, spans, timers and
   histograms record nothing; counters always count.
2. **Histogram buckets**: Prometheus ``le`` semantics, cumulative export,
   the same snapshot as the reference's for the same values.
3. **Spans**: nesting, attributes, ``span_mark``/``spans_since``,
   duration histograms, the Perfetto export; a span's start on
   ``torch.profiler``'s clock, in its record and in the export.
4. **Exposition**: the Prometheus text parses under both packages' strict
   parsers, names sanitized alike; concurrent writers never break it.
5. **Reports**: ``run_fused`` emits one ``ExecutionReport`` a query; on
   the in-core route its query, fused flag, dispatches, host syncs,
   ``rel.route.*`` counters and ``memory.ingest_bytes`` equal the
   reference's for q1-q20; the morsel route's ``morsel`` section and
   provenance; ``SRT_TRACE_EXPORT`` writes JSON.
6. **SLO windows**: fed one sample stream under one fake clock, the
   port's quantiles, counts and rates equal the reference's.
7. **Flight recorder**: ring order and bound, qid stamping, dumps.
8. **Scrape endpoint**: ``/metrics``, ``/metrics.json``, ``/healthz``,
   ``/reports`` on loopback (port 0, stopped in ``finally``).
9. **Memory probe**: unlimited without stats; from a fake stats source
   otherwise; agreed (the minimum) by 2 gloo ranks with unequal fake
   headroom, which then stage the same exchange rounds. The same group
   holds the mesh route's reports: the ``shuffle`` section equals on
   both ranks. (The reference's mesh needs a jax whose ``shard_map``
   takes ``check_rep=``; without one, the shuffle section is held
   against the port's own counters and across ranks.)

Every thread join, socket read and group wait has a timeout.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from spark_rapids_jni_tpu import obs as ref_obs
from spark_rapids_jni_tpu.config import set_config
from spark_rapids_jni_tpu.obs import slo as ref_slo
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds import queries as RQ
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df
from spark_rapids_jni_tpu.tpcds.rel import run_fused as ref_run_fused

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.exec import (HostTable, rel_append,
                                             reset_standing_state)
from spark_rapids_jni_tpu_torch.obs import flight, memory, recompile, slo
from spark_rapids_jni_tpu_torch.obs import server as obs_server
from spark_rapids_jni_tpu_torch.obs.metrics import _NOOP_TIMER
from spark_rapids_jni_tpu_torch.parallel import comm_plan
from spark_rapids_jni_tpu_torch.tpcds import PLANS
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused
from spark_rapids_jni_tpu_torch.utils.faults import FakeDeviceMemory

from torch_native_support import (native_libraries,  # noqa: F401
                                  port_dtype, reference_native)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
QS = [f"q{i}" for i in range(1, 21)]
SF, SEED = 0.3, 7


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    monkeypatch.delenv("SRT_METRICS", raising=False)
    monkeypatch.delenv("SRT_TRACE_EXPORT", raising=False)
    monkeypatch.delenv("SRT_SHUFFLE_SCRATCH_BYTES", raising=False)
    obs.reset_all()
    memory.set_stats_source_for_testing(None)
    yield
    obs.reset_all()
    memory.set_stats_source_for_testing(None)
    comm_plan.reset_scratch_override()
    obs_server.reset_health_sources()


@pytest.fixture(scope="module", autouse=True)
def _release_reference_plans():
    """The reference's plan cache is process-wide and bounded (64
    entries): empty it after this module, so a later module's
    cache-growth assertions in the same worker find free slots."""
    yield
    from spark_rapids_jni_tpu.tpcds import rel as ref_rel_module
    ref_rel_module._FUSED_CACHE.clear()


def _enable(monkeypatch):
    monkeypatch.setenv("SRT_METRICS", "1")


@pytest.fixture(scope="module")
def data():
    return ref_generate(sf=SF, seed=SEED)


@pytest.fixture(scope="module")
def rels(data):
    return {k: rel_from_df(v, device=CPU) for k, v in data.items()}


@pytest.fixture(scope="module")
def ref_rels(data):
    return {k: ref_rel_from_df(v) for k, v in data.items()}


# --------------------------------------------------------------------------
# 1. disabled mode
# --------------------------------------------------------------------------

def test_disabled_span_records_nothing():
    with obs.span("off.spans", a=1):
        obs.set_attrs(b=2)  # no live span: must not raise
    assert obs.span_records() == []
    assert obs.current_span_name() is None


def test_disabled_timer_is_shared_noop():
    assert obs.timer("off.timer") is _NOOP_TIMER
    with obs.timer("off.timer"):
        pass
    assert "off.timer" not in obs.REGISTRY.to_json()["histograms"]


def test_disabled_histogram_observe_is_noop():
    h = obs.histogram("off.hist")
    h.observe(123)
    assert h.snapshot()["count"] == 0


def test_counters_always_count_even_when_disabled():
    obs.count("off.calls", 3)
    obs.gauge("off.gauge").set(7)
    assert obs.kernel_stats()["off.calls"] == 3
    assert obs.gauge("off.gauge").value == 7


def test_disabled_traced_overhead_micro_benchmark():
    @obs.traced("bench.noop")
    def noop():
        return None

    n = 20_000
    noop()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        noop()
    per_call_ns = (time.perf_counter_ns() - t0) / n
    assert per_call_ns < 50_000, f"{per_call_ns:.0f} ns/call disabled"
    assert obs.span_records() == []


# --------------------------------------------------------------------------
# 2. histogram buckets, beside the reference's
# --------------------------------------------------------------------------

def test_histogram_le_buckets_equal_reference(monkeypatch):
    _enable(monkeypatch)
    set_config(metrics_enabled=True)
    h = obs.histogram("t.hist", bounds=(10, 100, 1000))
    rh = ref_obs.histogram("t.hist", bounds=(10, 100, 1000))
    for v in (5, 10, 11, 100, 999, 5000):
        h.observe(v)
        rh.observe(v)
    snap = h.snapshot()
    assert snap["buckets"] == [[10, 2], [100, 4], [1000, 5], ["+Inf", 6]]
    assert snap["count"] == 6 and snap["sum"] == 6125
    assert snap["min"] == 5 and snap["max"] == 5000
    assert snap == rh.snapshot()


def test_histogram_default_bounds_equal_reference(monkeypatch):
    _enable(monkeypatch)
    h = obs.histogram("t.default")
    assert list(h.bounds) == sorted(h.bounds) and h.bounds[0] == 1_000
    assert obs.DEFAULT_BOUNDS_NS == ref_obs.DEFAULT_BOUNDS_NS


def test_timer_records_ns_durations(monkeypatch):
    _enable(monkeypatch)
    with obs.timer("t.timer"):
        time.sleep(0.002)
    snap = obs.histogram("t.timer").snapshot()
    assert snap["count"] == 1 and snap["sum"] >= 2e6


# --------------------------------------------------------------------------
# 3. spans
# --------------------------------------------------------------------------

def test_span_nesting_parent_depth_and_attrs(monkeypatch):
    _enable(monkeypatch)
    with obs.span("outer", q="x"):
        assert obs.current_span_name() == "outer"
        with obs.span("inner"):
            obs.set_attrs(rows=7, route="dense")
            assert obs.current_span_name() == "inner"
    recs = {r.name: r for r in obs.span_records()}
    assert recs["inner"].parent == "outer" and recs["inner"].depth == 1
    assert recs["outer"].depth == 0 and recs["outer"].parent is None
    assert recs["inner"].attrs == {"rows": 7, "route": "dense"}
    assert recs["outer"].attrs == {"q": "x"}
    assert recs["inner"].dur_ns <= recs["outer"].dur_ns


def test_span_mark_scopes_a_region(monkeypatch):
    _enable(monkeypatch)
    with obs.span("before"):
        pass
    m = obs.span_mark()
    with obs.span("after"):
        pass
    assert [r.name for r in obs.spans_since(m)] == ["after"]


def test_traced_decorator_emits_named_span(monkeypatch):
    _enable(monkeypatch)

    @obs.traced("mod.myop")
    def op(x):
        return x * 2

    assert op(21) == 42
    assert [r.name for r in obs.span_records()] == ["mod.myop"]


def test_span_duration_feeds_histogram(monkeypatch):
    _enable(monkeypatch)
    with obs.span("hist.fed"):
        pass
    assert obs.histogram("span.hist.fed").snapshot()["count"] == 1


def test_perfetto_export_shape_and_json_roundtrip(monkeypatch):
    _enable(monkeypatch)
    with obs.span("p.outer", q="q1"):
        with obs.span("p.inner"):
            pass
    events = json.loads(json.dumps(obs.export_perfetto()))["traceEvents"]
    assert {e["name"] for e in events} == {"p.outer", "p.inner"}
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0 and e["ts"] > 0
        assert {"pid", "tid", "cat", "args"} <= set(e)
    inner = next(e for e in events if e["name"] == "p.inner")
    outer = next(e for e in events if e["name"] == "p.outer")
    assert outer["ts"] <= inner["ts"]


def _profiled_span(monkeypatch, name):
    """(the span's record, the profiler) of one span opened with both
    switches on under a CPU ``torch.profiler`` run."""
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_jni_tpu_torch import config as port_config
    monkeypatch.setattr(port_config, "_overrides", {})
    _enable(monkeypatch)
    monkeypatch.setenv("SRT_TRACE_ENABLED", "1")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a process's first profiler range takes about a millisecond
        # after its start is stamped: warm that path first
        with obs.span("clock.warm"):
            pass
        with obs.span(name):
            time.sleep(0.001)
    (rec,) = [r for r in obs.span_records() if r.name == name]
    return rec, prof


def test_span_start_is_on_the_profilers_clock(monkeypatch):
    rec, prof = _profiled_span(monkeypatch, "clock.events")
    (ev,) = [e for e in prof.events() if e.name == "srt::clock.events"]
    at = prof.profiler.kineto_results.trace_start_ns() \
        + ev.time_range.start * 1000
    assert abs(rec.start_ns - at) < 100_000


def test_perfetto_export_lays_over_the_profilers_trace(monkeypatch,
                                                       tmp_path):
    rec, prof = _profiled_span(monkeypatch, "clock.export")
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    chrome = json.loads(path.read_text())
    (ev,) = [e for e in chrome["traceEvents"]
             if e.get("name") == "srt::clock.export"]
    spans = json.loads(json.dumps(obs.export_perfetto()))
    (sp,) = [e for e in spans["traceEvents"] if e["name"] == "clock.export"]
    at_profiler = chrome["baseTimeNanoseconds"] + float(ev["ts"]) * 1000
    at_span = spans["baseTimeNanoseconds"] + sp["ts"] * 1000
    assert abs(at_span - at_profiler) < 100_000
    assert at_span == pytest.approx(rec.start_ns, abs=1)


# --------------------------------------------------------------------------
# 4. exposition
# --------------------------------------------------------------------------

def test_prometheus_exposition_parses_under_both_parsers(monkeypatch):
    _enable(monkeypatch)
    obs.count("regexp.host_fallback_rows", 4)
    obs.gauge("pool.in_use").set(1.5)
    obs.histogram("t.h", bounds=(10,)).observe(3)
    text = obs.REGISTRY.to_prometheus()
    samples = obs.parse_prometheus(text)
    assert samples == ref_obs.parse_prometheus(text)
    assert samples["srt_regexp_host_fallback_rows"] == 4
    assert samples["srt_pool_in_use"] == 1.5
    assert samples['srt_t_h_bucket{le="10"}'] == 1
    assert samples['srt_t_h_bucket{le="+Inf"}'] == 1
    assert samples["srt_t_h_count"] == 1
    for name in ("a.b-c/d", "serving.slo.x.p0.e2e.p99_ns", "mem.device.0"):
        assert obs.prom_name(name) == ref_obs.prom_name(name)


@pytest.mark.parametrize("bad", ["this is not a metric line\n",
                                 'name{unclosed="x} 1\n',
                                 "# BOGUS comment\n"])
def test_prometheus_parser_rejects_malformed(bad):
    with pytest.raises(ValueError):
        obs.parse_prometheus(bad)
    with pytest.raises(ValueError):
        ref_obs.parse_prometheus(bad)


def test_exposition_parses_under_concurrent_writers(monkeypatch):
    _enable(monkeypatch)
    stop = threading.Event()
    errors = []

    def writer(i):
        n = 0
        while not stop.is_set():
            obs.count(f"obs.stress.calls_{i}")
            obs.gauge(f"obs.stress.depth_{i}").set(n)
            obs.histogram("obs.stress.lat_ns").observe(n * 1000 + 1)
            n += 1

    def snapshotter():
        while not stop.is_set():
            try:
                obs.parse_prometheus(obs.REGISTRY.to_prometheus())
                body = json.loads(json.dumps(obs.REGISTRY.to_json()))
                snap = body["histograms"].get("obs.stress.lat_ns")
                if snap:
                    cums = [c for _, c in snap["buckets"]]
                    assert cums == sorted(cums), cums
            except Exception as e:  # surfaced after the join
                errors.append(e)
                return

    threads = ([threading.Thread(target=writer, args=(i,))
                for i in range(4)]
               + [threading.Thread(target=snapshotter) for _ in range(2)])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        time.sleep(0.4)
    finally:
        stop.set()
        sys.setswitchinterval(old)
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    stats = obs.kernel_stats()
    assert all(stats.get(f"obs.stress.calls_{i}", 0) > 0 for i in range(4))


def test_stats_since_returns_only_deltas():
    obs.count("a.calls", 2)
    before = obs.kernel_stats()
    obs.count("a.calls")
    obs.count("b.calls", 5)
    assert obs.stats_since(before) == {"a.calls": 1, "b.calls": 5}


def test_tracing_shim_reexports_the_counters():
    from spark_rapids_jni_tpu_torch.utils import tracing
    before = tracing.kernel_stats()
    tracing.count_dispatch("t.site")
    tracing.count_host_sync("t.site")
    assert tracing.dispatch_counts(tracing.stats_since(before)) == (1, 1)
    assert tracing.span is obs.span


def test_recompile_records_signature_and_event(monkeypatch):
    import torch
    sig = recompile.signature_of((torch.zeros(4, dtype=torch.int64), 3),
                                 {"k": [torch.ones(2, 2)]})
    assert sig[:3] == ("int64[4]", "3", "float32[2,2]")
    recompile.record_event("t.site", "compile", sig)  # metrics off
    assert obs.recompile_records() == []
    _enable(monkeypatch)
    m = obs.recompile_mark()
    with obs.span("build.span"):
        recompile.record_event("t.site", "compile", sig, duration_s=0.5)
    recs = obs.recompiles_since(m)
    assert [(r.site, r.kind, r.span) for r in recs] == [
        ("t.site", "compile", "build.span")]
    assert obs.kernel_stats()["jit.compiles"] == 1


# --------------------------------------------------------------------------
# 5. ExecutionReport from run_fused
# --------------------------------------------------------------------------

@pytest.mark.parametrize("q", QS)
def test_in_core_report_equals_reference(q, rels, ref_rels, monkeypatch):
    """The plan facts of one in-core run of each query, in both packages
    (the reference's first run of a plan reports its trace's routes;
    the eager port counts its routes on every run)."""
    _enable(monkeypatch)
    set_config(metrics_enabled=True)
    ref_run_fused(getattr(RQ, f"_{q}"), ref_rels)
    want = ref_obs.last_report(q)
    run_fused(PLANS[q], rels, device=CPU)
    got = obs.last_report(q)
    assert len(obs.recent_reports()) == 1
    assert (got.query, got.fused) == (want.query, want.fused) == (q, True)
    assert got.host_syncs == want.host_syncs <= 1
    assert got.dispatches == want.dispatches
    assert ({k: v for k, v in got.routes.items()
             if k.startswith("rel.route.")}
            == {k: v for k, v in want.routes.items()
                if k.startswith("rel.route.")})
    assert got.memory["ingest_bytes"] == want.memory["ingest_bytes"]
    assert got.memory["modeled_peak_bytes"] == got.memory["ingest_bytes"]
    assert got.provenance == "eager" and not got.cache_hit
    assert got.fallbacks() == {} and got.shuffle == {}
    names = {s["name"] for s in got.spans}
    assert {f"query.{q}", "rel.fused_program"} <= names


def test_report_renders_serializes_and_carries_the_qid(rels, monkeypatch):
    _enable(monkeypatch)
    with obs.qid_scope("q-test-1"):
        run_fused(PLANS["q3"], rels, device=CPU)
    rep = obs.last_report("q3")
    assert rep.qid == "q-test-1" and obs.current_qid() == ""
    text = rep.render()
    assert "q3" in text and "dispatches" in text and "memory (" in text
    d = json.loads(rep.to_json())
    assert d["qid"] == "q-test-1" and d["provenance"] == "eager"
    assert flight.snapshot()["reports"][-1]["qid"] == "q-test-1"


def test_trace_export_writes_report_json(rels, tmp_path, monkeypatch):
    _enable(monkeypatch)
    monkeypatch.setenv("SRT_TRACE_EXPORT", str(tmp_path))
    run_fused(PLANS["q1"], rels, device=CPU)
    files = sorted(tmp_path.glob("report_*_q1.json"))
    assert files, "SRT_TRACE_EXPORT did not write a report"
    d = json.loads(files[0].read_text())
    assert d["query"] == "q1"
    assert {"dispatches", "host_syncs", "spans", "routes", "counters",
            "memory"} <= set(d)


def test_native_report_fields_equal_reference(rels, ref_rels, monkeypatch,
                                              native_libraries,  # noqa: F811
                                              reference_native):  # noqa: F811
    """With both native libraries loaded on the CPU and the same native
    calls made in both, a q1 report's ``native_routes``,
    ``reliability``'s ``native.ra.*`` and ``memory.native_arena`` equal
    the reference's. Run on a fresh thread: the route sentinels are the
    thread's own."""
    from spark_rapids_jni_tpu.types import DType as RefDType, TypeId
    nat = native_libraries[0]
    _enable(monkeypatch)
    set_config(metrics_enabled=True)
    i64 = RefDType(TypeId.INT64)
    vals = np.arange(250_000, dtype=np.int64) % 977
    out: dict = {}

    def run():
        for mod in (nat, reference_native):
            dt = port_dtype(i64) if mod is nat else i64
            with mod.NativeTable([(dt, vals, None)] * 8) as t:
                mod.convert_to_rows(t)  # the arenas' new peak
                mod.murmur3_table(t)
                mod.sort_order(t)
            mod.ra_configure(1 << 20)
            mod.ra_task_register(41)
            mod.ra_alloc(41, 1000)
            try:
                mod.ra_alloc(41, 1 << 20)
            except RuntimeError as e:  # RetryOOM of either package
                out.setdefault("oom", []).append(type(e).__name__)
        ref_run_fused(RQ._q1, ref_rels)
        run_fused(PLANS["q1"], rels, device=CPU)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=300)
    try:
        got, want = obs.last_report("q1"), ref_obs.last_report("q1")
        assert out["oom"] == ["RetryOOM", "RetryOOM"]
        assert got.native_routes == want.native_routes
        assert got.native_routes["murmur3"] == 0
        assert got.native_routes["to_rows"] == 0
        assert got.native_routes["groupby"] == -1  # never ran on it
        assert got.memory["native_arena"] == want.memory["native_arena"]
        assert got.memory["native_arena"]["live_handles"] == 0
        ra = {k: v for k, v in got.reliability.items()
              if k.startswith("native.ra.")}
        assert ra == {k: v for k, v in want.reliability.items()
                      if k.startswith("native.ra.")}
        assert ra["native.ra.task.retry_oom"] == 1
        assert ra["native.ra.in_use"] == 1000
    finally:
        for mod in (nat, reference_native):
            mod.ra_task_done(41)


def test_reports_disabled_by_default(rels):
    run_fused(PLANS["q1"], rels, device=CPU)
    assert obs.recent_reports() == []


def test_morsel_route_report_and_delta_provenance(data, rels, monkeypatch):
    """Streamed facts: the report's morsel section and provenance
    ``eager``; after ``rel_append`` the standing re-run is ``delta``."""
    from spark_rapids_jni_tpu.exec import HostTable as RefHostTable
    from spark_rapids_jni_tpu.exec import \
        reset_standing_state as ref_reset_standing
    _enable(monkeypatch)
    set_config(metrics_enabled=True)
    monkeypatch.setenv("SRT_MORSEL_BYTES", "4096")  # both runs stream
    reset_standing_state()
    ref_reset_standing()
    sr = data["store_returns"]
    half = len(sr) // 2
    ht = HostTable.from_df(sr.iloc[:half].reset_index(drop=True))
    host = {**rels, "store_returns": ht}
    ref_ht = RefHostTable.from_df(sr.iloc[:half].reset_index(drop=True))
    ref_host = {k: ref_rel_from_df(v) for k, v in data.items()}
    ref_host["store_returns"] = ref_ht
    try:
        run_fused(PLANS["q1"], host, device=CPU)
        ref_run_fused(RQ._q1, ref_host)
        got, want = obs.last_report("q1"), ref_obs.last_report("q1")
        assert got.provenance == "eager" and got.fused
        assert got.host_syncs == want.host_syncs == 1
        for k in ("n_morsels", "capacity_rows", "streamed", "total_rows"):
            assert got.morsel[k] == want.morsel[k], k
        assert got.memory["ingest_bytes"] > 0
        rel_append(ht, sr.iloc[half:].reset_index(drop=True))
        run_fused(PLANS["q1"], host, device=CPU)
        got = obs.last_report("q1")
        assert got.provenance == "delta" and got.morsel["delta"]
        kinds = [e["kind"] for e in flight.events_tail(8)]
        assert "morsel_pump" in kinds and "morsel_merge" in kinds
    finally:
        reset_standing_state()
        ref_reset_standing()


# --------------------------------------------------------------------------
# 6. SLO windows
# --------------------------------------------------------------------------

def test_slo_quantiles_equal_reference(monkeypatch):
    _enable(monkeypatch)
    set_config(metrics_enabled=True)
    now = [1000.0]
    clock = lambda: now[0]  # noqa: E731
    mine = slo.SloTracker(window_s=10, n_windows=3, _clock=clock)
    ref = ref_slo.SloTracker(window_s=10, n_windows=3, _clock=clock)
    rng = np.random.default_rng(5)
    for step in range(400):
        now[0] += float(rng.uniform(0, 0.2))
        kind = slo.KINDS[step % len(slo.KINDS)]
        tenant = ("a", "b")[step % 2]
        dur = int(rng.lognormal(14, 2))
        mine.record(kind, tenant, step % 3, dur)
        ref.record(kind, tenant, step % 3, dur)
        ev = slo.EVENTS[int(rng.integers(0, 4))]
        mine.note(ev, tenant, step % 3)
        ref.note(ev, tenant, step % 3)
        if step % 97 == 0:
            assert mine.snapshot() == ref.snapshot()
    assert mine.snapshot() == ref.snapshot()
    assert (slo.KINDS, slo.EVENTS) == (ref_slo.KINDS, ref_slo.EVENTS)
    now[0] += 100.0  # every window ages out
    assert mine.snapshot() == ref.snapshot() == {}


def test_slo_publish_sets_and_zeroes_gauges(monkeypatch):
    _enable(monkeypatch)
    now = [50.0]
    t = slo.SloTracker(window_s=1, n_windows=2, _clock=lambda: now[0])
    t.record(slo.KIND_E2E, "x", 0, 5_000_000)
    t.note(slo.EVENT_SERVED, "x", 0)
    t.publish()
    g = obs.REGISTRY.to_json()["gauges"]
    assert g["serving.slo.x.p0.e2e.p99_ns"] == 1 << 23
    assert g["serving.slo.x.p0.served_per_s"] > 0
    now[0] += 10
    t.publish()
    g = obs.REGISTRY.to_json()["gauges"]
    assert g["serving.slo.x.p0.e2e.p99_ns"] == 0


def test_slo_latency_recording_rides_the_metrics_gate():
    t = slo.SloTracker(window_s=1, n_windows=1)
    t.record(slo.KIND_E2E, "x", 0, 1000)   # metrics off: dropped
    t.note(slo.EVENT_SHED, "x", 0)         # always counted
    snap = t.snapshot()
    assert snap[("x", 0)]["latency"] == {}
    assert snap[("x", 0)]["counts"] == {"shed": 1}


# --------------------------------------------------------------------------
# 7. flight recorder
# --------------------------------------------------------------------------

def test_flight_ring_order_bound_and_qid():
    n = flight.MAX_EVENTS + 10
    for i in range(n):
        if i == n - 1:
            with obs.qid_scope("q-last"):
                obs.flight_note("ev", i=i)
        else:
            obs.flight_note("ev", i=i)
    events = obs.flight_snapshot()["events"]
    assert len(events) == flight.MAX_EVENTS
    assert [e["i"] for e in events] == list(range(10, n))
    assert events[-1]["qid"] == "q-last" and "qid" not in events[0]
    assert [e["i"] for e in flight.events_tail(3)] == [n - 3, n - 2, n - 1]


def test_flight_dump_writes_and_rate_limits(tmp_path, monkeypatch):
    monkeypatch.setenv("SRT_FLIGHT_MIN_INTERVAL_S", "60")
    obs.flight_note("crash", worker=1)
    obs.count("serving.fault.injected.dispatch.raise")
    path = obs.flight_dump("unit", directory=str(tmp_path))
    body = json.loads(Path(path).read_text())
    assert body["reason"] == "unit" and body["events"][0]["kind"] == "crash"
    assert body["fault_counters"] == {
        "serving.fault.injected.dispatch.raise": 1}
    assert obs.flight_dump("unit", directory=str(tmp_path)) is None
    assert obs.kernel_stats()["obs.flight_dumps_suppressed"] == 1


# --------------------------------------------------------------------------
# 8. the scrape endpoint
# --------------------------------------------------------------------------

def _get(srv, path):
    url = f"http://127.0.0.1:{srv.port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_endpoints_on_loopback(rels, monkeypatch):
    _enable(monkeypatch)
    run_fused(PLANS["q3"], rels, device=CPU)
    run_fused(PLANS["q5"], rels, device=CPU)
    obs.SLO_TRACKER.record(slo.KIND_E2E, "t", 0, 123_456)
    srv = obs_server.start(0)
    try:
        assert srv.host == "127.0.0.1" and srv.port > 0
        assert obs_server.start() is srv  # the process singleton
        status, text = _get(srv, "/metrics")
        samples = obs.parse_prometheus(text)
        assert status == 200
        assert samples["srt_serving_slo_t_p0_e2e_count"] == 1
        assert samples["srt_mem_devices_reporting"] == 0
        status, body = _get(srv, "/metrics.json")
        assert status == 200 and "gauges" in json.loads(body)
        status, body = _get(srv, "/healthz")
        assert status == 200 and json.loads(body)["ok"]
        obs_server.add_health_source("bad", lambda: {"ok": False})
        status, body = _get(srv, "/healthz")
        assert status == 503 and not json.loads(body)["ok"]
        obs_server.remove_health_source("bad")
        status, body = _get(srv, "/reports?n=1")
        reps = json.loads(body)["reports"]
        assert status == 200 and [r["query"] for r in reps] == ["q5"]
        status, _ = _get(srv, "/nope")
        assert status == 404
    finally:
        obs_server.stop()
    assert obs_server.current() is None


def test_server_maybe_start_from_env(monkeypatch):
    monkeypatch.delenv("SRT_OBS_HTTP_PORT", raising=False)
    assert obs_server.maybe_start_from_env() is None
    monkeypatch.setenv("SRT_OBS_HTTP_PORT", "0")
    srv = obs_server.maybe_start_from_env()
    try:
        assert srv is not None and _get(srv, "/healthz")[0] == 200
    finally:
        obs_server.stop()


# --------------------------------------------------------------------------
# 9. the memory probe
# --------------------------------------------------------------------------

def test_probe_unlimited_without_device_stats():
    assert memory.probed_scratch_budget(CPU) is None
    assert memory.hbm_headroom_bytes(CPU) is None
    assert comm_plan.scratch_budget() is None
    assert memory.sample_device_memory() == {} or all(
        s is None for s in memory.sample_device_memory().values())
    assert "exchange scratch budget: unlimited" in memory.render_watermarks()


def test_probe_from_fake_stats_source(monkeypatch):
    fake = FakeDeviceMemory(n_devices=2, limit_bytes=1 << 30).install()
    try:
        fake.set_used_fraction(0.5)
        # (1 GiB - 512 MiB) x 1/4 = 128 MiB, a power of two already
        assert memory.probed_scratch_budget() == 128 << 20
        # un-agreed, the probe plans nothing: only a held agreement does
        assert comm_plan.scratch_budget() is None
        with comm_plan.agreed_probe_scope(memory.probed_scratch_budget()):
            assert comm_plan.scratch_budget() == 128 << 20
            held = []
            t = threading.Thread(
                target=lambda: held.append(comm_plan.scratch_budget()))
            t.start()
            t.join(timeout=30)
            assert held == [None]  # the scope is this thread's alone
        assert comm_plan.scratch_budget() is None
        monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "65536")
        assert comm_plan.scratch_budget() == 65536  # the knob wins
        monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "0")
        assert comm_plan.scratch_budget() is None   # explicit unlimited
        stats = memory.sample_device_memory()
        assert sorted(stats) == [0, 1]
        g = obs.REGISTRY.to_json()["gauges"]
        assert g["mem.device.1.bytes_in_use"] == 512 << 20
        assert g["mem.device.0.bytes_limit"] == 1 << 30
        assert memory.device_used_fraction() == 0.5
        fake.set_used_fraction(0.999999)
        memory.reset_memory_probe()
        assert memory.probed_scratch_budget() == comm_plan.MIN_SCRATCH_BYTES
    finally:
        fake.uninstall()


MESH_WORKER = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)
    from spark_rapids_jni_tpu_torch import obs
    from spark_rapids_jni_tpu_torch.parallel import (comm_plan, distributed,
                                                     make_mesh)
    from spark_rapids_jni_tpu_torch.tpcds import PLANS, generate, dist
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused
    from spark_rapids_jni_tpu_torch.utils.faults import FakeDeviceMemory

    rank, world, init, out = (int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5])
    queries, sf, seed = pickle.loads(bytes.fromhex(sys.argv[6]))
    distributed.initialize(init, world, rank, backend="gloo", timeout_s=60)
    mesh = make_mesh({"part": world}, device_type="cpu")
    data = generate(sf=sf, seed=seed)
    rels = {n: rel_from_df(df, device="cpu") for n, df in data.items()}
    res = {"reports": {}}
    for q in queries:
        got = run_fused(PLANS[q], rels, mesh=mesh).to_df()
        res["reports"][q] = obs.last_report(q).to_dict()
    # unequal fake headroom: rank r has 128 KiB >> r free of 256 KiB
    fake = FakeDeviceMemory(limit_bytes=256 << 10).install()
    fake.set_used_bytes((256 << 10) - ((128 << 10) >> rank))
    res["local"] = obs.probed_scratch_budget()
    res["agreed"] = dist.agreed_scratch_probe(mesh, None, "cpu")
    before = obs.kernel_stats()
    res["staged"] = run_fused(PLANS["q18"], rels, mesh=mesh).to_df()
    res["staged_counters"] = obs.stats_since(before)
    res["outside"] = comm_plan.scratch_budget()
    fake.uninstall()
    with open(os.path.join(out, f"r{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    distributed.shutdown()
""")

MESH_QS = tuple(QS)


@pytest.fixture(scope="module")
def mesh_ref_ingest_bytes():
    from spark_rapids_jni_tpu.obs.memory import rel_ingest_bytes
    return rel_ingest_bytes({k: ref_rel_from_df(v) for k, v in
                             ref_generate(sf=0.5, seed=SEED).items()})


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Two gloo ranks: reports of MESH_QS over the mesh with
    SRT_METRICS on, then the agreed probe under unequal fake headroom
    and q18 staged under it."""
    tmp = tmp_path_factory.mktemp("obs_mesh")
    script = tmp / "worker.py"
    script.write_text(MESH_WORKER)
    env = dict(os.environ, SRT_BROADCAST_THRESHOLD="8192", SRT_METRICS="1",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("SRT_SHUFFLE_SCRATCH_BYTES", None)
    args = pickle.dumps((MESH_QS, 0.5, SEED)).hex()
    procs = []
    for rank in range(2):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(script), str(ROOT), str(rank), "2",
             f"file://{tmp / 'init'}", str(tmp), args], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + 240
    failed = None
    try:
        for rank, (p, _) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed = (rank, rc)
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()
    if failed:
        logs = "\n".join((tmp / f"rank{r}.log").read_text()[-3000:]
                         for r in range(2))
        pytest.fail(f"rank {failed[0]} ended with {failed[1]}:\n{logs}")
    return [pickle.loads((tmp / f"r{r}.pkl").read_bytes()) for r in range(2)]


@pytest.mark.parametrize("q", MESH_QS)
def test_mesh_reports_agree_across_ranks(q, mesh_runs,
                                        mesh_ref_ingest_bytes):
    a, b = (r["reports"][q] for r in mesh_runs)
    for rep in (a, b):
        assert rep["query"] == q and rep["fused"] and rep["host_syncs"] <= 1
        assert rep["counters"].get("rel.dist_fallbacks", 0) == 0
        assert rep["shuffle"] == {k: v for k, v in rep["counters"].items()
                                  if k.startswith("shuffle.")}
        assert rep["memory"]["comm_scratch_bytes"] == rep["shuffle"].get(
            "shuffle.peak_scratch_bytes", 0)
        assert any(k.startswith("rel.route.dist.") for k in rep["routes"])
    assert a["shuffle"] == b["shuffle"] and a["routes"] == b["routes"]
    # every rank holds the global rels: the reference's ingest bytes
    assert a["memory"]["ingest_bytes"] == mesh_ref_ingest_bytes


def test_mesh_shuffle_section_counts_bytes_and_rounds(mesh_runs):
    rep = mesh_runs[0]["reports"]["q18"]
    sh = rep["shuffle"]
    assert sh["shuffle.bytes_exchanged"] > 0 and sh["shuffle.rounds"] >= 1
    assert sh["shuffle.peak_scratch_bytes"] > 0


def test_probe_agreed_by_two_ranks_with_unequal_headroom(mesh_runs):
    r0, r1 = mesh_runs
    # 128 KiB and 64 KiB free: local budgets 32 KiB and 16 KiB
    assert (r0["local"], r1["local"]) == (32 << 10, 16 << 10)
    assert r0["agreed"] == r1["agreed"] == 16 << 10
    # the staged run planned the same rounds on both ranks, under the
    # agreed budget, and gave the same rows; outside a run no rank
    # plans from its own probe: the budget is unlimited again
    c0, c1 = r0["staged_counters"], r1["staged_counters"]
    assert c0.get("rel.route.shuffle.staged", 0) >= 1
    assert c0["shuffle.rounds"] == c1["shuffle.rounds"]
    assert c0["shuffle.peak_scratch_bytes"] <= 16 << 10
    assert r0["staged"].equals(r1["staged"])
    assert (r0["outside"], r1["outside"]) == (None, None)
