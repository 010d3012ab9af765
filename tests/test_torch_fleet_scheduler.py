"""The port's ``FleetScheduler`` and batcher against the reference's
(``tests/test_fleet_scheduler.py`` and ``tests/test_reliability.py``, the
cases that need no mesh), on the CPU, with the reference's counters.

1. **Scheduler**: results equal the serial run and the pandas oracle
   through N workers; strict-priority dispatch; weighted-fair
   interleaving within a class; shed-lowest-priority-first under
   saturation, every shed counted and delivered (``QueryShed``);
   per-tenant budgets released at collection and at GC; ``close()``
   under load resolves every handle; the result cache answers at submit
   with no dispatch (q1-q20); the default worker count and the probe
   counter; ``mesh=`` and ``SRT_CONTROL_PLANE=1`` refused.
2. **Batcher**: the route-counted per-query fallback, the compatibility
   key, the scheduler coalescing queued submissions into one window
   (fixed and adaptive windows), the arrival estimator, a burst of
   q9/q17 from two tenants at capacity 16 beside the serial results and
   the reference's batched results.
3. **Reliability**: supervision (requeue, respawn, quarantine, close
   during a crash), retries with backoff, exhaustion, deadlines at
   dequeue, the scratch-budget shrink and its holders, the batch
   split-on-OOM ladder, handle timeouts, and injected faults on the real
   run path (``batch:raise``, ``batch:split_oom``, ``worker:crash``).

Every wait has a timeout.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds import queries as RQ
from spark_rapids_jni_tpu.tpcds import rel as ref_rel

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.obs import server as obs_server
from spark_rapids_jni_tpu_torch.parallel import comm_plan
from spark_rapids_jni_tpu_torch.serving import (FleetScheduler,
                                                QueryExpired, QueryPoisoned,
                                                QueryShed, TenantConfig,
                                                batcher, result_cache)
from spark_rapids_jni_tpu_torch.serving import scheduler as sched_mod
from spark_rapids_jni_tpu_torch.serving.executor import PendingQuery
from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES
from spark_rapids_jni_tpu_torch.tpcds import rel as R
from spark_rapids_jni_tpu_torch.utils import faults
from spark_rapids_jni_tpu_torch.utils.faults import (InjectedFault,
                                                     RetryOOM,
                                                     SplitAndRetryOOM)

CPU = "cpu"
SF, SEED = 0.3, 11
QS = [f"q{i}" for i in range(1, 21)]
T = 60  # every wait's timeout, seconds


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("SRT_METRICS", "SRT_CONTROL_PLANE", "SRT_BATCH_MAX",
              "SRT_BATCH_WINDOW_MS", "SRT_RESULT_CACHE_BYTES", "SRT_FAULTS",
              "SRT_QUERY_DEADLINE_MS", "SRT_SHUFFLE_SCRATCH_BYTES"):
        monkeypatch.delenv(k, raising=False)
    obs.reset_all()
    faults.reset()
    result_cache.reset()
    R.clear_batch_cache()
    yield
    faults.reset()
    result_cache.reset()
    R.clear_batch_cache()
    comm_plan.reset_scratch_override()
    obs.reset_all()


@pytest.fixture(scope="module", autouse=True)
def _release_reference_plans():
    yield
    ref_rel._FUSED_CACHE.clear()
    ref_rel._BATCH_CACHE.clear()


@pytest.fixture(scope="module")
def data():
    return ref_generate(sf=SF, seed=SEED)


@pytest.fixture(scope="module")
def rels(data):
    return {k: R.rel_from_df(v, device=CPU) for k, v in data.items()}


def _frames_equal(got, want, what=""):
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=1e-9,
                                       atol=1e-9, err_msg=f"{what}.{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{c}")


def _sched(**kw):
    kw.setdefault("device", CPU)
    return FleetScheduler(**kw)


def _gated_sched(tenants, **kw):
    """One worker blocked on a gate inside an injected run function,
    recording the dispatch order (no device work)."""
    gate = threading.Event()
    order = []

    def gated_run(plan, rels, mesh=None, axis=None):
        order.append(rels["tenant_tag"])
        gate.wait(T)
        return rels.get("out")

    sched = _sched(tenants=tenants, n_workers=1, batch_max=1, **kw,
                   _run=gated_run)
    return sched, gate, order


def _tag(tenant, out=None):
    return {"tenant_tag": tenant, "out": out}


def _noop_plan(t):  # never run: the injected run function answers
    raise AssertionError("should not run")


def _plan(t):  # never run in seam-injected tests
    pass


def _fast_sched(**kw):
    base = dict(n_workers=1, batch_max=1, max_retries=3,
                retry_backoff_ms=0)
    base.update(kw)
    return _sched(**base)


def _ok_run(plan, rels, mesh=None, axis=None):
    return ("ok", plan)


# --------------------------------------------------------------------------
# 1. scheduler
# --------------------------------------------------------------------------

def test_scheduler_results_match_serial(rels, data):
    want = QUERIES["q1"][1](data)
    serial = R.run_fused(PLANS["q1"], rels, device=CPU).to_df()
    with _sched(tenants=[TenantConfig("a", weight=2), TenantConfig("b")],
                n_workers=2) as sched:
        pend = [sched.submit(PLANS["q1"], rels,
                             tenant=("a" if i % 2 else "b"))
                for i in range(6)]
        frames = [p.to_df(timeout=T) for p in pend]
    for got in frames:
        _frames_equal(got, want)
        _frames_equal(got, serial)
    stats = obs.kernel_stats()
    assert stats.get("serving.completed") == 6
    assert stats.get("serving.tenant.a.completed") == 3
    assert stats.get("serving.tenant.b.completed") == 3


def test_scheduler_unknown_tenant_raises(rels):
    with _sched(tenants=[TenantConfig("a")]) as sched:
        with pytest.raises(KeyError, match="unknown tenant"):
            sched.submit(PLANS["q1"], rels, tenant="nope")


def test_duplicate_tenants_refused():
    with pytest.raises(ValueError, match="duplicate"):
        _sched(tenants=[TenantConfig("a"), TenantConfig("a")])


def test_priority_class_dispatches_first():
    sched, gate, order = _gated_sched(
        [TenantConfig("gold", priority=10), TenantConfig("bronze")])
    try:
        blocker = sched.submit(_noop_plan, _tag("gold"), tenant="gold")
        time.sleep(0.1)  # the worker now holds the blocker
        pend = [sched.submit(_noop_plan, _tag("bronze"), tenant="bronze")
                for _ in range(3)]
        pend += [sched.submit(_noop_plan, _tag("gold"), tenant="gold")
                 for _ in range(3)]
        gate.set()
        for p in pend + [blocker]:
            p.result(timeout=T)
    finally:
        sched.close()
    assert order[0] == "gold"
    assert order[1:4] == ["gold"] * 3
    assert order[4:] == ["bronze"] * 3


def test_weighted_fair_within_class():
    sched, gate, order = _gated_sched(
        [TenantConfig("a", weight=3), TenantConfig("b", weight=1)])
    try:
        blocker = sched.submit(_noop_plan, _tag("a"), tenant="a")
        time.sleep(0.1)
        pend = [sched.submit(_noop_plan, _tag("a"), tenant="a")
                for _ in range(6)]
        pend += [sched.submit(_noop_plan, _tag("b"), tenant="b")
                 for _ in range(6)]
        gate.set()
        for p in pend + [blocker]:
            p.result(timeout=T)
    finally:
        sched.close()
    window = order[1:9]
    assert window.count("a") == 6 and window.count("b") == 2, order


def test_shed_lowest_priority_first():
    sched, gate, order = _gated_sched(
        [TenantConfig("gold", priority=10, max_queue=16),
         TenantConfig("bronze", priority=0, max_queue=16)],
        max_queue=4)
    try:
        blocker = sched.submit(_noop_plan, _tag("gold"), tenant="gold")
        time.sleep(0.1)
        bronze = [sched.submit(_noop_plan, _tag("bronze"), tenant="bronze",
                               block=False) for _ in range(4)]
        golds = [sched.submit(_noop_plan, _tag("gold"), tenant="gold",
                              block=False) for _ in range(4)]
        with pytest.raises(QueryShed, match="saturated"):
            sched.submit(_noop_plan, _tag("bronze"), tenant="bronze",
                         block=False)
        gate.set()
        for p in golds + [blocker]:
            p.result(timeout=T)
        for p in bronze:  # sheds are delivered, not silent
            with pytest.raises(QueryShed, match="preempted"):
                p.result(timeout=T)
    finally:
        sched.close()
    stats = obs.kernel_stats()
    assert stats.get("serving.tenant.bronze.shed") == 5
    assert stats.get("serving.tenant.gold.shed", 0) == 0
    assert stats.get("serving.shed") == 5
    assert stats.get("serving.tenant.gold.completed") == 5


def test_equal_priority_arrival_sheds_itself_not_peers():
    sched, gate, order = _gated_sched(
        [TenantConfig("a", priority=5), TenantConfig("b", priority=5)],
        max_queue=2)
    try:
        blocker = sched.submit(_noop_plan, _tag("a"), tenant="a")
        time.sleep(0.1)
        queued = [sched.submit(_noop_plan, _tag("a"), tenant="a",
                               block=False) for _ in range(2)]
        with pytest.raises(QueryShed):
            sched.submit(_noop_plan, _tag("b"), tenant="b", block=False)
        assert all(not p.done() for p in queued)
        gate.set()
        for p in queued + [blocker]:
            p.result(timeout=T)
    finally:
        sched.close()
    assert obs.kernel_stats().get("serving.tenant.b.shed") == 1


def test_tenant_budget_sheds_and_releases(rels):
    sched = _sched(tenants=[TenantConfig("t", max_in_flight=1,
                                         max_queue=4)], n_workers=1)
    try:
        first = sched.submit(PLANS["q1"], rels, tenant="t")
        with pytest.raises(QueryShed, match="budget"):
            sched.submit(PLANS["q1"], rels, tenant="t", block=False)
        first.result(timeout=T)  # collection releases the budget
        sched.submit(PLANS["q1"], rels, tenant="t",
                     block=False).result(timeout=T)
    finally:
        sched.close()
    assert obs.kernel_stats().get("serving.tenant.t.shed") == 1


def test_submit_timeout_sheds(rels):
    sched, gate, _ = _gated_sched([TenantConfig("t", max_in_flight=1)])
    try:
        first = sched.submit(_noop_plan, _tag("t"), tenant="t")
        t0 = time.monotonic()
        with pytest.raises(QueryShed, match="timed out"):
            sched.submit(_noop_plan, _tag("t"), tenant="t", timeout=0.2)
        assert time.monotonic() - t0 < 10
        gate.set()
        first.result(timeout=T)
    finally:
        sched.close()


def test_abandoned_handle_releases_tenant_budget_at_gc(rels):
    sched = _sched(tenants=[TenantConfig("t", max_in_flight=1,
                                         max_queue=4)], n_workers=1)
    try:
        pq = sched.submit(PLANS["q1"], rels, tenant="t")
        assert pq._event.wait(T)
        del pq
        gc.collect()
        sched.submit(PLANS["q1"], rels, tenant="t",
                     block=False).result(timeout=T)
    finally:
        sched.close()


def test_scheduler_close_resolves_every_handle(monkeypatch, data):
    """close(wait=True) under load: queued, batched and cached handles
    all resolve."""
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", str(256 << 20))
    result_cache.reset()
    crels = {k: R.rel_from_df(v, device=CPU) for k, v in data.items()}
    sched = _sched(tenants=[TenantConfig("t", max_in_flight=64,
                                         max_queue=64)],
                   n_workers=1, batch_max=4, batch_window_ms=30)
    sched.submit(PLANS["q3"], crels, tenant="t").result(timeout=T)
    cached = sched.submit(PLANS["q3"], crels, tenant="t")  # a submit hit
    queued = [sched.submit(PLANS["q1"], crels, tenant="t")
              for _ in range(6)]
    sched.close(wait=True)
    for pq in [cached] + queued:
        assert pq.done(), "close(wait=True) left an unresolved handle"
        pq.result(timeout=5)
    stats = obs.kernel_stats()
    assert stats.get("serving.tenant.t.cache_hits") == 1
    assert stats.get("serving.completed") == 8


def test_scheduler_worker_survives_plan_errors(rels):
    def _exploding(t):
        raise ValueError("boom in plan")

    with _sched(tenants=[TenantConfig("t")], n_workers=1) as sched:
        bad = sched.submit(_exploding, rels, tenant="t")
        ok = sched.submit(PLANS["q1"], rels, tenant="t")
        with pytest.raises(ValueError, match="boom in plan"):
            bad.result(timeout=T)
        ok.result(timeout=T)
    stats = obs.kernel_stats()
    assert stats.get("serving.tenant.t.failed") == 1
    assert stats.get("serving.tenant.t.completed") == 1


@pytest.mark.parametrize("q", QS)
def test_scheduler_and_cache_every_query(q, data, monkeypatch):
    """Every query through the scheduler with the result cache on (the
    repeat is answered at submit: no dispatch, no sync) and off."""
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", str(256 << 20))
    result_cache.reset()
    want = QUERIES[q][1](data)
    crels = {k: R.rel_from_df(v, device=CPU) for k, v in data.items()}
    with _sched(tenants=[TenantConfig("t")], n_workers=2) as sched:
        _frames_equal(sched.submit(PLANS[q], crels,
                                   tenant="t").to_df(timeout=T), want, q)
        before = obs.kernel_stats()
        second = sched.submit(PLANS[q], crels, tenant="t")
        _frames_equal(second.to_df(timeout=T), want, q)
        assert obs.dispatch_counts(obs.stats_since(before)) == (0, 0)
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", "0")
    _frames_equal(R.run_fused(PLANS[q], crels, device=CPU).to_df(), want)


def test_cache_hit_report_under_metrics(data, monkeypatch):
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", str(256 << 20))
    monkeypatch.setenv("SRT_METRICS", "1")
    result_cache.reset()
    crels = {k: R.rel_from_df(v, device=CPU) for k, v in data.items()}
    with _sched(n_workers=1) as sched:
        sched.submit(PLANS["q9"], crels).result(timeout=T)
        pq = sched.submit(PLANS["q9"], crels)
        pq.result(timeout=T)
    rep = obs.last_report("q9")
    assert rep.provenance == "result_cache" and rep.cache_hit
    assert rep.qid == pq.qid and rep.dispatches == 0


def test_default_workers_and_probe_counter(monkeypatch):
    with _sched() as s:
        assert len(s._workers) == 1  # one CPU device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert sched_mod.default_workers(torch.device("cuda")) == 1
    assert obs.kernel_stats().get("serving.device_probe_errors") == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert sched_mod.default_workers(torch.device("cuda")) == 4


def test_mesh_and_control_plane_refused(monkeypatch):
    with pytest.raises(NotImplementedError, match="item 13"):
        _sched(mesh=object())
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    with pytest.raises(NotImplementedError, match="item 13"):
        _sched()


def test_health_source_follows_the_workers():
    s = _sched(name="fleet-health")
    try:
        snap = s._health_snapshot()
        assert snap["ok"] and snap["workers_alive"] == 1
        assert s in obs_server._health_sources
    finally:
        s.close()
    assert s not in obs_server._health_sources
    assert not s._health_snapshot()["ok"]


# --------------------------------------------------------------------------
# 2. micro-batching
# --------------------------------------------------------------------------

def test_execute_batch_falls_back_route_counted(rels):
    class Item:
        def __init__(self):
            self.pq = PendingQuery("q1", lambda: None)
            self.plan = PLANS["q1"]
            self.rels = rels
            self.mesh = None
            self.axis = None

        def resolve(self, out):
            self.pq._resolve(out)

        def reject(self, e):
            self.pq._reject(e)

    items = [Item(), Item()]
    ran = []

    def boom(plan, rels_list):
        raise R.BatchIncompatible("refused")

    def single(plan, r, mesh=None, axis=None):
        ran.append(1)
        return R.run_fused(plan, r, device=CPU)

    batcher.execute_batch(items, run_batched=boom, run_single=single)
    assert len(ran) == 2
    assert obs.kernel_stats().get("serving.batch.fallback") == 1
    for it in items:
        it.pq.result(timeout=5)


def test_batch_key_unbatchable_shapes(rels, data):
    from spark_rapids_jni_tpu_torch.exec import HostTable
    assert batcher.batch_key(PLANS["q1"], rels) is not None
    assert batcher.batch_key(PLANS["q1"], rels, mesh=object()) is None
    masked = dict(rels)
    sr = rels["store_returns"]
    masked["store_returns"] = sr.filter(sr.data("sr_store_sk") >= 0)
    assert batcher.batch_key(PLANS["q1"], masked) is None
    host = dict(rels, store_sales=HostTable.from_df(data["store_sales"]))
    assert batcher.batch_key(PLANS["q3"], host) is None
    # equal content, another ingest: the same key
    again = {k: R.rel_from_df(v, device=CPU) for k, v in data.items()}
    assert batcher.batch_key(PLANS["q1"], again) == \
        batcher.batch_key(PLANS["q1"], rels)


def test_scheduler_coalesces_compatible_submissions(rels):
    sizes = []
    gate = threading.Event()

    def slow_single(plan, r, mesh=None, axis=None):
        gate.wait(30)
        return R.run_fused(plan, r, device=CPU)

    def recording_batched(plan, rels_list):
        sizes.append(len(rels_list))
        return R.run_fused_batched(plan, rels_list, device=CPU)

    sched = _sched(tenants=[TenantConfig("t")], n_workers=1, batch_max=4,
                   batch_window_ms=500, _run=slow_single,
                   _run_batched=recording_batched)
    try:
        blocker = sched.submit(PLANS["q3"], rels, tenant="t")
        time.sleep(0.1)  # the worker holds the blocker (q3: its own key)
        pend = [sched.submit(PLANS["q1"], rels, tenant="t")
                for _ in range(4)]
        gate.set()
        blocker.result(timeout=T)
        want = R.run_fused(PLANS["q1"], rels, device=CPU).to_df()
        for p in pend:
            _frames_equal(p.to_df(timeout=T), want)
    finally:
        sched.close()
    assert sizes == [4], sizes
    stats = obs.kernel_stats()
    assert stats.get("serving.batch.formed") == 1
    assert stats.get("serving.batch.queries") == 4
    assert stats.get("serving.tenant.t.batched", 0) >= 3


def test_arrival_estimator_burst_sizes_a_window():
    est = batcher.ArrivalEstimator(max_window_s=0.005)
    assert est.window_s(16) == 0.0
    t = 100.0
    for _ in range(20):
        est.observe(now=t)
        t += 1e-4
    w = est.window_s(16)
    assert 0.0 < w <= 0.005
    assert w == pytest.approx(1e-4 * 15, rel=0.5)
    assert est.window_s(4) < est.window_s(16)


def test_arrival_estimator_idle_stream_pays_no_latency():
    est = batcher.ArrivalEstimator(max_window_s=0.005)
    t = 0.0
    for _ in range(5):
        est.observe(now=t)
        t += 1.0
    assert est.window_s(16) == 0.0
    burst = batcher.ArrivalEstimator(alpha=0.5, max_window_s=0.005)
    t = 0.0
    for _ in range(10):
        burst.observe(now=t)
        t += 1e-4
    assert burst.window_s(16) > 0.0
    for _ in range(3):
        burst.observe(now=t)
        t += 10.0
    assert burst.window_s(16) == 0.0


def test_scheduler_window_fixed_vs_adaptive(monkeypatch):
    with _sched(tenants=[TenantConfig("t")], n_workers=1,
                batch_max=4) as sched:
        assert sched._arrivals is not None
        assert sched._window_s() == 0.0
    monkeypatch.setenv("SRT_BATCH_WINDOW_MS", "7.5")
    with _sched(tenants=[TenantConfig("t")], n_workers=1,
                batch_max=4) as sched:
        assert sched._arrivals is None
        assert sched._window_s() == pytest.approx(7.5e-3)
    monkeypatch.delenv("SRT_BATCH_WINDOW_MS", raising=False)
    with _sched(tenants=[TenantConfig("t")], n_workers=1, batch_max=4,
                batch_window_ms=3.0) as sched:
        assert sched._arrivals is None
        assert sched._window_s() == pytest.approx(3e-3)


def test_batch_max_default_and_clamp(monkeypatch):
    with _sched() as s:
        assert s._batch_max == 1  # batching off unless SRT_BATCH_MAX
    monkeypatch.setenv("SRT_BATCH_MAX", "64")
    with _sched() as s:
        assert s._batch_max == 16
    assert obs.kernel_stats().get("serving.batch.max_clamped") == 1
    with _sched(batch_max=100) as s:
        assert s._batch_max == 16


def test_adaptive_burst_still_coalesces(rels):
    sizes = []
    gate = threading.Event()

    def slow_single(plan, r, mesh=None, axis=None):
        gate.wait(30)
        return R.run_fused(plan, r, device=CPU)

    def recording_batched(plan, rels_list):
        sizes.append(len(rels_list))
        return R.run_fused_batched(plan, rels_list, device=CPU)

    sched = _sched(tenants=[TenantConfig("t")], n_workers=1, batch_max=4,
                   _run=slow_single, _run_batched=recording_batched)
    try:
        assert sched._arrivals is not None
        blocker = sched.submit(PLANS["q3"], rels, tenant="t")
        time.sleep(0.1)
        pend = [sched.submit(PLANS["q1"], rels, tenant="t")
                for _ in range(4)]
        gate.set()
        blocker.result(timeout=T)
        for p in pend:
            p.result(timeout=T)
    finally:
        sched.close()
    assert sizes == [4], sizes


def test_adaptive_idle_submission_not_delayed(rels):
    done = threading.Event()

    def instant(plan, r, mesh=None, axis=None):
        done.set()
        return R.run_fused(plan, r, device=CPU)

    with _sched(tenants=[TenantConfig("t")], n_workers=1, batch_max=16,
                _run=instant) as sched:
        t0 = time.monotonic()
        pq = sched.submit(PLANS["q1"], rels, tenant="t")
        assert done.wait(5)
        dispatched_after = time.monotonic() - t0
        pq.result(timeout=T)
    assert dispatched_after < 1.0, dispatched_after


@pytest.fixture(scope="module")
def burst_reference(data):
    """The reference's batched q9 and q17 over its own ingest of the same
    frames, a window of 16."""
    ref_rels = {k: ref_rel.rel_from_df(v) for k, v in data.items()}
    return {q: ref_rel.run_fused_batched(getattr(RQ, f"_{q}"),
                                         [ref_rels] * 16)[0].to_df()
            for q in ("q9", "q17")}


def test_two_tenant_burst_at_capacity_16(rels, burst_reference):
    """32 submissions each of q9 and q17, half from each tenant, to two
    workers at SRT_BATCH_MAX=16 with a window long enough to fill."""
    serial = {q: R.run_fused(PLANS[q], rels, device=CPU).to_df()
              for q in ("q9", "q17")}
    sizes = []

    def recording_batched(plan, rels_list):
        sizes.append(len(rels_list))
        return R.run_fused_batched(plan, rels_list, device=CPU)

    gate = threading.Event()

    def gated_single(plan, r, mesh=None, axis=None):
        if not r:  # a blocker
            gate.wait(T)
            return "blocked"
        return R.run_fused(plan, r, device=CPU)

    def _blocker_a(t):
        pass

    def _blocker_b(t):
        pass

    with _sched(tenants=[TenantConfig("gold", priority=1, weight=3),
                         TenantConfig("bronze", priority=0, weight=1)],
                n_workers=2, batch_max=16, batch_window_ms=200,
                _run=gated_single, _run_batched=recording_batched) as s:
        # both workers parked on blockers (each its own batch key) while
        # the burst queues
        blockers = [s.submit(p, {}, tenant="gold")
                    for p in (_blocker_a, _blocker_b)]
        time.sleep(0.2)
        pend = [(q, s.submit(PLANS[q], rels,
                             tenant="gold" if i % 2 else "bronze"))
                for i in range(32) for q in ("q9", "q17")]
        gate.set()
        for b in blockers:
            b.result(timeout=T)
        for q, p in pend:
            got = p.to_df(timeout=T)
            _frames_equal(got, serial[q], q)
            _frames_equal(got, burst_reference[q], q)
    assert sorted(sizes) == [16] * 4, sizes
    st = obs.kernel_stats()
    assert st.get("serving.batch.formed") == 4
    assert st.get("serving.batch.queries") == 64
    assert st.get("serving.tenant.gold.completed") == 34
    assert st.get("serving.tenant.bronze.completed") == 32
    assert st.get("serving.tenant.gold.batched", 0) \
        + st.get("serving.tenant.bronze.batched", 0) == 60


# --------------------------------------------------------------------------
# 3. reliability: supervision, retries, deadlines, OOM degradation
# --------------------------------------------------------------------------

def test_worker_crash_detect_requeue_respawn():
    faults.configure("worker:crash:1")
    before = obs.kernel_stats()
    with _fast_sched(_run=_ok_run) as s:
        assert s.submit(_plan, {}).result(timeout=T)[0] == "ok"
    d = obs.stats_since(before)
    assert d.get("serving.fault.injected.worker.crash") == 1
    assert d.get("serving.fault.worker_crashes") == 1
    assert d.get("serving.fault.worker_restarts") == 1
    assert d.get("serving.fault.requeued") == 1
    assert not d.get("serving.fault.quarantined")
    assert faults.remaining() == {}


def test_crash_requeue_preserves_other_queries():
    faults.configure("worker:crash:1")
    with _fast_sched(_run=_ok_run) as s:
        handles = [s.submit(_plan, {i: i}) for i in range(5)]
        outs = [pq.result(timeout=T) for pq in handles]
    assert all(o[0] == "ok" for o in outs)


def test_quarantine_after_two_crashes():
    faults.configure("worker:crash:2")
    before = obs.kernel_stats()
    with _fast_sched(_run=_ok_run) as s:
        pq = s.submit(_plan, {})
        with pytest.raises(QueryPoisoned) as ei:
            pq.result(timeout=T)
    assert ei.value.crashes == 2
    d = obs.stats_since(before)
    assert d.get("serving.fault.worker_crashes") == 2
    assert d.get("serving.fault.quarantined") == 1
    assert d.get("serving.tenant.default.quarantined") == 1
    assert d.get("serving.fault.requeued") == 1
    assert d.get("serving.tenant.default.failed") == 1


def test_close_during_worker_crash_resolves_every_handle():
    faults.configure("worker:crash:1")
    before = obs.kernel_stats()
    s = _fast_sched(_run=_ok_run)
    handles = [s.submit(_plan, {i: i}) for i in range(6)]
    s.close(wait=True)
    assert all(pq.done() for pq in handles)
    assert all(pq.result(timeout=5)[0] == "ok" for pq in handles)
    d = obs.stats_since(before)
    assert d.get("serving.fault.worker_crashes") == 1
    assert d.get("serving.fault.worker_restarts") == 1
    assert d.get("serving.fault.requeued") == 1
    assert d.get("serving.tenant.default.completed") == 6
    st = s._tenants["default"]
    assert len(st.queue) == 0 and s._queued_total == 0


def test_close_resolves_stranded_handles_when_all_workers_dead(monkeypatch):
    s = _fast_sched(n_workers=1)
    try:
        monkeypatch.setattr(
            s, "_spawn_worker",
            lambda widx: (_ for _ in ()).throw(RuntimeError("no threads")))
        faults.configure("worker:crash:1")
        pq = s.submit(_plan, {})
        deadline = time.monotonic() + 30
        while obs.kernel_stats().get("serving.fault.respawn_errors",
                                     0) < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        s.close(wait=True)
        with pytest.raises(QueryShed, match="no live workers"):
            pq.result(timeout=5)
        assert obs.kernel_stats().get("serving.fault.unserviceable") == 1
    finally:
        faults.reset()
        s.close(wait=True)


def test_close_from_worker_thread_fails_loud():
    box = {}

    def closing_plan(plan, rels, mesh=None, axis=None):
        box["sched"].close(wait=True)
        return "unreachable"

    s = _fast_sched(_run=closing_plan)
    box["sched"] = s
    try:
        pq = s.submit(_plan, {})
        with pytest.raises(RuntimeError, match="worker thread"):
            pq.result(timeout=T)
    finally:
        s.close(wait=True)


def test_transient_failure_retries_to_success():
    calls = []

    def flaky(plan, rels, mesh=None, axis=None):
        calls.append(1)
        if len(calls) < 3:
            raise InjectedFault("dispatch", "raise")
        return "done"

    before = obs.kernel_stats()
    with _fast_sched(_run=flaky) as s:
        assert s.submit(_plan, {}).result(timeout=T) == "done"
    d = obs.stats_since(before)
    assert len(calls) == 3
    assert d.get("serving.fault.retries") == 2
    assert d.get("serving.tenant.default.retries") == 2
    assert not d.get("serving.fault.retry_exhausted")


def test_retry_exhaustion_delivers_underlying_error():
    def always(plan, rels, mesh=None, axis=None):
        raise InjectedFault("dispatch", "raise")

    before = obs.kernel_stats()
    with _fast_sched(max_retries=1, _run=always) as s:
        with pytest.raises(InjectedFault):
            s.submit(_plan, {}).result(timeout=T)
    d = obs.stats_since(before)
    assert d.get("serving.fault.retries") == 1
    assert d.get("serving.fault.retry_exhausted") == 1
    assert d.get("serving.tenant.default.failed") == 1


def test_nonretryable_error_fails_fast():
    def buggy(plan, rels, mesh=None, axis=None):
        raise ValueError("deterministic plan bug")

    before = obs.kernel_stats()
    with _fast_sched(_run=buggy) as s:
        with pytest.raises(ValueError):
            s.submit(_plan, {}).result(timeout=T)
    assert not obs.stats_since(before).get("serving.fault.retries")


def test_backoff_timer_parks_retry_and_close_collapses_it():
    calls = []

    def flaky(plan, rels, mesh=None, axis=None):
        calls.append(1)
        if len(calls) < 2:
            raise InjectedFault("dispatch", "raise")
        return "after-backoff"

    s = _fast_sched(retry_backoff_ms=60000, _run=flaky)
    pq = s.submit(_plan, {})
    deadline = time.monotonic() + 10
    while not s._retry_timers and time.monotonic() < deadline:
        time.sleep(0.01)
    assert s._retry_timers, "the retry was not parked in a backoff timer"
    assert not pq.done()
    t0 = time.monotonic()
    s.close(wait=True)
    assert time.monotonic() - t0 < 30
    assert pq.result(timeout=5) == "after-backoff"
    assert not s._retry_timers


def test_retry_env_knobs_reach_the_scheduler(monkeypatch):
    monkeypatch.setenv("SRT_QUERY_RETRIES", "0")
    with _sched(n_workers=1, _run=lambda *a, **k: (_ for _ in ()).throw(
            InjectedFault("dispatch", "raise"))) as s:
        with pytest.raises(InjectedFault):
            s.submit(_plan, {}).result(timeout=T)
    assert obs.kernel_stats().get("serving.fault.retry_exhausted") == 1


def _gated_run():
    gate = threading.Event()

    def gated(plan, rels, mesh=None, axis=None):
        gate.wait(T)
        return "g"

    return gate, gated


def test_deadline_expires_queued_query_at_dequeue():
    gate, gated = _gated_run()
    before = obs.kernel_stats()
    s = _fast_sched(_run=gated)
    blocker = s.submit(_plan, {}, deadline_ms=60000)
    time.sleep(0.2)
    victim = s.submit(_plan, {}, deadline_ms=50)
    time.sleep(0.3)
    gate.set()
    assert blocker.result(timeout=T) == "g"
    with pytest.raises(QueryExpired) as ei:
        victim.result(timeout=T)
    s.close()
    assert ei.value.late_by_s > 0
    d = obs.stats_since(before)
    assert d.get("serving.fault.expired") == 1
    assert d.get("serving.tenant.default.expired") == 1
    assert d.get("serving.shed") == 1
    assert d.get("serving.tenant.default.shed") == 1
    assert not d.get("serving.tenant.default.failed")
    assert d.get("serving.tenant.default.completed") == 1


def test_scheduler_deadline_policy_applies_to_all_submits(monkeypatch):
    gate, gated = _gated_run()
    monkeypatch.setenv("SRT_QUERY_DEADLINE_MS", "50")
    s = _fast_sched(_run=gated)
    blocker = s.submit(_plan, {}, deadline_ms=60000)  # per-submit override
    time.sleep(0.2)
    victim = s.submit(_plan, {})  # the 50 ms policy from the environment
    time.sleep(0.3)
    gate.set()
    assert blocker.result(timeout=T) == "g"
    with pytest.raises(QueryExpired):
        victim.result(timeout=T)
    s.close()


def test_unexpired_deadline_is_harmless():
    with _fast_sched(deadline_ms=60000, _run=_ok_run) as s:
        assert s.submit(_plan, {}).result(timeout=T)[0] == "ok"


def test_zero_deadline_means_no_deadline():
    gate, gated = _gated_run()
    s = _fast_sched(deadline_ms=50, _run=gated)
    blocker = s.submit(_plan, {}, deadline_ms=60000)
    time.sleep(0.2)
    survivor = s.submit(_plan, {}, deadline_ms=0)  # 0 = no deadline
    time.sleep(0.3)
    gate.set()
    assert blocker.result(timeout=T) == "g"
    assert survivor.result(timeout=T) == "g"
    s.close()
    with _fast_sched(deadline_ms=0, _run=_ok_run) as s2:
        assert s2.submit(_plan, {}).result(timeout=T)[0] == "ok"


def test_batch_window_deadline_sheds_inside_the_window(rels):
    """An expired item met while a batch window pulls its peers sheds
    there, without a dispatch."""
    gate = threading.Event()

    def gated(plan, r, mesh=None, axis=None):
        if not r:  # the blocker
            gate.wait(T)
            return "g"
        return R.run_fused(plan, r, device=CPU)

    s = _sched(n_workers=1, batch_max=4, batch_window_ms=300,
               _run=gated)
    try:
        blocker = s.submit(_plan, {})
        time.sleep(0.2)
        first = s.submit(PLANS["q9"], rels)
        late = s.submit(PLANS["q9"], rels, deadline_ms=30)
        time.sleep(0.2)
        gate.set()
        blocker.result(timeout=T)
        first.result(timeout=T)
        with pytest.raises(QueryExpired):
            late.result(timeout=T)
    finally:
        s.close()


def test_retry_oom_frees_and_retries():
    calls = []

    def oomy(plan, rels, mesh=None, axis=None):
        calls.append(1)
        if len(calls) == 1:
            raise RetryOOM("task 0: retry")
        return "fits-now"

    before = obs.kernel_stats()
    with _fast_sched(_run=oomy) as s:
        assert s.submit(_plan, {}).result(timeout=T) == "fits-now"
    d = obs.stats_since(before)
    assert d.get("serving.fault.oom.retry") == 1
    assert d.get("serving.fault.retries") == 1


def test_split_oom_shrinks_scratch_budget_one_tier(monkeypatch):
    monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "65536")
    comm_plan.reset_scratch_override()
    calls = []

    def oomy(plan, rels, mesh=None, axis=None):
        calls.append(1)
        if len(calls) == 1:
            raise SplitAndRetryOOM("task 0: split")
        return "smaller-now"

    before = obs.kernel_stats()
    with _fast_sched(_run=oomy) as s:
        assert s.submit(_plan, {}).result(timeout=T) == "smaller-now"
        assert comm_plan.scratch_budget() == 32768
    d = obs.stats_since(before)
    assert d.get("serving.fault.oom.split_query") == 1
    assert d.get("serving.fault.oom.scratch_shrunk") == 1
    assert comm_plan.scratch_budget() == 65536  # restored at close


def test_close_preserves_another_schedulers_scratch_shrink(monkeypatch):
    monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "65536")
    comm_plan.reset_scratch_override()
    assert comm_plan.shrink_scratch_budget() == 32768  # "scheduler A"
    with _fast_sched(_run=_ok_run) as s:  # "scheduler B": no OOM
        assert s.submit(_plan, {}).result(timeout=T)[0] == "ok"
    assert comm_plan.scratch_budget() == 32768


def test_close_without_wait_keeps_holder_until_drain(monkeypatch):
    monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "65536")
    comm_plan.reset_scratch_override()
    gate = threading.Event()

    def gated(plan, rels, mesh=None, axis=None):
        gate.wait(T)
        return ("ok", plan)

    s = _fast_sched(_run=gated)
    pq = s.submit(_plan, {})
    assert comm_plan.shrink_scratch_budget(holder=s) == 32768
    s.close(wait=False)
    assert comm_plan.scratch_budget() == 32768
    gate.set()
    assert pq.result(timeout=T)[0] == "ok"
    deadline = time.monotonic() + 30
    while comm_plan.scratch_budget() != 65536:
        assert time.monotonic() < deadline, comm_plan.scratch_budget()
        time.sleep(0.01)
    s.close(wait=True)
    assert comm_plan.scratch_budget() == 65536


def test_close_nowait_unregisters_atexit_at_drain(monkeypatch):
    unregistered = []
    real = sched_mod.atexit.unregister
    monkeypatch.setattr(
        sched_mod.atexit, "unregister",
        lambda fn: (unregistered.append(fn), real(fn))[1])
    s = _fast_sched(_run=_ok_run)
    assert s.submit(_plan, {}).result(timeout=T)[0] == "ok"
    s.close(wait=False)
    deadline = time.monotonic() + 30
    while s.close not in unregistered:
        assert time.monotonic() < deadline
        time.sleep(0.01)


class _FakeItem:
    def __init__(self):
        self.pq = type("PQ", (), {"query": "x"})()
        self.plan = _plan
        self.rels = {}
        self.mesh = None
        self.axis = None
        self.sched = None
        self.out = None
        self.err = None

    def resolve(self, out):
        self.out = out

    def reject(self, exc):
        self.err = exc


def test_batch_split_oom_halves_down_the_ladder():
    items = [_FakeItem() for _ in range(4)]
    seen = []

    def run_batched(plan, rels_list):
        seen.append(len(rels_list))
        if len(rels_list) == 4:
            raise SplitAndRetryOOM("batch too big")
        return [f"b{len(rels_list)}"] * len(rels_list)

    before = obs.kernel_stats()
    batcher.execute_batch(items, run_batched=run_batched,
                          run_single=_ok_run)
    d = obs.stats_since(before)
    assert seen == [4, 2, 2]
    assert [it.out for it in items] == ["b2"] * 4
    assert d.get("serving.fault.oom.split") == 1
    assert not d.get("serving.batch.fallback")


def test_batch_split_oom_bottoms_out_at_per_query():
    items = [_FakeItem() for _ in range(4)]

    def run_batched(plan, rels_list):
        raise SplitAndRetryOOM("never fits batched")

    before = obs.kernel_stats()
    batcher.execute_batch(items, run_batched=run_batched,
                          run_single=_ok_run)
    d = obs.stats_since(before)
    assert d.get("serving.fault.oom.split") == 3
    assert all(it.out is not None for it in items)
    assert all(it.err is None for it in items)


def test_batch_runtime_error_degrades_per_query():
    items = [_FakeItem() for _ in range(3)]

    def run_batched(plan, rels_list):
        raise RuntimeError("device fault in the batch")

    before = obs.kernel_stats()
    batcher.execute_batch(items, run_batched=run_batched,
                          run_single=_ok_run)
    d = obs.stats_since(before)
    assert d.get("serving.batch.fallback") == 1
    assert d.get("serving.batch.exec_errors") == 1
    assert all(it.out[0] == "ok" for it in items)


def test_result_timeout_leaves_handle_rewaitable():
    gate = threading.Event()

    def gated(plan, rels, mesh=None, axis=None):
        gate.wait(T)
        return "slow"

    with _fast_sched(_run=gated) as s:
        pq = s.submit(_plan, {})
        with pytest.raises(TimeoutError):
            pq.result(timeout=0.05)
        with pytest.raises(TimeoutError):
            pq.result(timeout=0.05)
        st = s._tenants["default"]
        assert st.in_flight == 1
        gate.set()
        assert pq.result(timeout=T) == "slow"
        deadline = time.monotonic() + 10
        while st.in_flight and time.monotonic() < deadline:
            time.sleep(0.01)
        assert st.in_flight == 0


def test_abandoned_timed_out_handle_releases_slot_once():
    gate = threading.Event()

    def gated(plan, rels, mesh=None, axis=None):
        gate.wait(T)
        return "slow"

    s = _fast_sched(_run=gated)
    st = s._tenants["default"]
    pq = s.submit(_plan, {})
    with pytest.raises(TimeoutError):
        pq.result(timeout=0.05)
    gate.set()
    deadline = time.monotonic() + 10
    while not pq.done() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pq.done()
    del pq
    gc.collect()
    deadline = time.monotonic() + 10
    while st.in_flight and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.01)
    assert st.in_flight == 0
    gc.collect()
    assert st.in_flight == 0
    s.close()


@pytest.mark.parametrize("spec,counter,want", [
    ("batch:raise:1", "serving.batch.fallback", 1),
    ("batch:split_oom:1", "serving.fault.oom.split", 1),
    ("worker:crash:1", "serving.fault.worker_restarts", 1),
])
def test_injected_faults_on_the_real_batched_path(spec, counter, want,
                                                  rels):
    """The scheduler's real run path, a queued burst of q9 batched at
    capacity 8 (no run seams): every query served and equal to its
    serial result, with the fault's counter."""
    serial = R.run_fused(PLANS["q9"], rels, device=CPU).to_df()
    gate = threading.Event()

    def _gated_plan(t):  # an unbatchable blocker holding the worker
        gate.wait(T)
        return PLANS["q9"](t)

    faults.configure(spec)
    before = obs.kernel_stats()
    with _sched(n_workers=1, batch_max=8, batch_window_ms=200,
                retry_backoff_ms=0) as s:
        if spec.startswith("worker"):
            pend = [s.submit(PLANS["q9"], rels) for _ in range(8)]
        else:
            blocker = s.submit(_gated_plan, rels)
            time.sleep(0.2)
            pend = [s.submit(PLANS["q9"], rels) for _ in range(8)]
            gate.set()
            blocker.result(timeout=T)
        for p in pend:
            _frames_equal(p.to_df(timeout=T), serial)
    d = obs.stats_since(before)
    assert d.get(counter) == want, d
    assert not d.get("serving.failed")
    assert faults.remaining() == {}


def test_combined_faults_every_query_exact(rels, data):
    """q1-q20 through one worker on the real run path under a worker
    crash, an injected dispatch error and a split OOM: every result
    equals its serial run, with the reference's counters."""
    want = {q: R.run_fused(PLANS[q], rels, device=CPU).to_df() for q in QS}
    faults.configure("worker:crash:1,dispatch:raise:1,alloc:split_oom:1")
    before = obs.kernel_stats()
    with _fast_sched() as s:
        handles = [(q, s.submit(PLANS[q], rels)) for q in QS]
        frames = [(q, pq.to_df(timeout=T)) for q, pq in handles]
    for q, f in frames:
        _frames_equal(f, want[q], q)
    d = obs.stats_since(before)
    assert d.get("serving.fault.worker_crashes") == 1
    assert d.get("serving.fault.worker_restarts") == 1
    assert d.get("serving.fault.requeued") == 1
    assert d.get("serving.fault.retries") == 2  # raise + split_oom
    assert d.get("serving.fault.oom.split_query") == 1
    assert d.get("serving.tenant.default.completed") == len(QS)
    assert not d.get("serving.tenant.default.failed")
    assert faults.remaining() == {}


def test_stress_many_workers_short_switch_interval(rels):
    """More workers than cores and a short switch interval: every
    handle resolves with its query's result, and the counters partition
    the submissions (a lost update would break either)."""
    import os
    import sys
    want = {q: R.run_fused(PLANS[q], rels, device=CPU).to_df()
            for q in ("q3", "q9", "q17")}
    n_workers = min(32, 2 * (os.cpu_count() or 4))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _sched(tenants=[TenantConfig("a", weight=2),
                             TenantConfig("b", priority=1)],
                    n_workers=n_workers, batch_max=4,
                    batch_window_ms=2) as s:
            pend = [(q, s.submit(PLANS[q], rels,
                                 tenant="a" if i % 3 else "b"))
                    for i in range(24) for q in want]
            for q, p in pend:
                _frames_equal(p.to_df(timeout=120), want[q], q)
        assert all(not w.is_alive() for w in s._workers)
    finally:
        sys.setswitchinterval(old)
    st = obs.kernel_stats()
    assert st.get("serving.submitted") == st.get("serving.completed") == 72
    assert (st.get("serving.tenant.a.completed", 0)
            + st.get("serving.tenant.b.completed", 0)) == 72
    assert st.get("serving.batch.queries", 0) <= 72

