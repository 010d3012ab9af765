"""The port's ``QueryExecutor`` against the reference's
(``tests/test_serving.py``, its executor cases).

- q1-q20 served by the port's executor on the CPU equal the reference's
  ``QueryExecutor`` on the same numpy inputs (integers exact, floats
  within rtol=1e-9, the reference's serving bound), and each served
  query emitted one report under its handle's qid;
- pipelined results equal the serial loop; distinct plans run in order;
- admission control: ``block=False`` sheds with ``queue.Full`` and is
  counted, a timeout bounds the whole submit, the submit lock is bounded
  too, brief contention does not shed;
- plan errors reach the caller and the worker survives; a closed
  executor refuses; bounds are validated; an abandoned handle returns
  its slot; concurrent ``result()`` calls release once; ``close()``
  resolves every handle; ``run()`` drains batches larger than the
  in-flight budget; the queue-depth gauge counts events;
- the executor serves streamed (``HostTable``) inputs, whose morsel
  runner builds its staging on the worker thread;

The reference's five AOT and warm-disk cases, which fail under the
installed jax, have no port. Every wait has a timeout.
"""

import gc
import queue
import threading
import time

import numpy as np
import pytest

from spark_rapids_jni_tpu import obs as ref_obs
from spark_rapids_jni_tpu.config import set_config
from spark_rapids_jni_tpu.serving import QueryExecutor as RefExecutor
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds import queries as RQ
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.exec import HostTable, reset_standing_state
from spark_rapids_jni_tpu_torch.serving import PendingQuery, QueryExecutor
from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused

CPU = "cpu"
SF, SEED = 0.4, 11
QS = [f"q{i}" for i in range(1, 21)]
T = 60  # every wait's timeout, seconds


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    monkeypatch.delenv("SRT_METRICS", raising=False)
    monkeypatch.delenv("SRT_CONTROL_PLANE", raising=False)
    obs.reset_all()
    yield
    obs.reset_all()


@pytest.fixture(scope="module", autouse=True)
def _release_reference_plans():
    """The reference's plan cache is process-wide and bounded (64
    entries): empty it after this module, so a later module's
    cache-growth assertions in the same worker find free slots."""
    yield
    from spark_rapids_jni_tpu.tpcds import rel as ref_rel_module
    ref_rel_module._FUSED_CACHE.clear()


@pytest.fixture(scope="module")
def data():
    return ref_generate(sf=SF, seed=SEED)


@pytest.fixture(scope="module")
def rels(data):
    return {k: rel_from_df(v, device=CPU) for k, v in data.items()}


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


def _gauge(name):
    return obs.REGISTRY.to_json()["gauges"][name]


@pytest.fixture(scope="module")
def served(data, rels):
    """q1-q20 through both packages' executors, submitted back to back
    and collected after; the port with SRT_METRICS on."""
    import os
    ref_rels = {k: ref_rel_from_df(v) for k, v in data.items()}
    with RefExecutor(max_queue=8, max_in_flight=20) as ex:
        pend = [ex.submit(getattr(RQ, f"_{q}"), ref_rels) for q in QS]
        want = {q: p.to_df(timeout=600) for q, p in zip(QS, pend)}
    os.environ["SRT_METRICS"] = "1"
    try:
        obs.reset_all()
        with QueryExecutor(device=CPU, max_queue=8,
                           max_in_flight=20) as ex:
            pend = [ex.submit(PLANS[q], rels) for q in QS]
            got = {q: p.to_df(timeout=T) for q, p in zip(QS, pend)}
        reports = {r.qid: r for r in obs.recent_reports()}
        stats = obs.kernel_stats()
    finally:
        del os.environ["SRT_METRICS"]
    return want, got, pend, reports, stats


@pytest.mark.parametrize("q", QS)
def test_served_results_equal_reference_executor(q, served):
    want, got, *_ = served
    _frames_equal(got[q], want[q], q)


@pytest.mark.parametrize("q", QS)
def test_served_query_emitted_one_report_under_its_qid(q, served):
    _, _, pend, reports, _ = served
    pq = pend[QS.index(q)]
    rep = reports[pq.qid]
    assert rep.query == q and pq.query == q
    assert rep.host_syncs <= 1 and rep.provenance == "eager" and rep.fused
    assert pq.latency_ns is not None and pq.latency_ns > 0


def test_served_counters_and_slo_windows(served):
    *_, reports, stats = served
    assert len(reports) == len(QS)
    assert stats["serving.submitted"] == stats["serving.completed"] == 20
    assert stats.get("serving.failed", 0) == 0


def test_executor_matches_serial_results(rels, data):
    want = QUERIES["q1"][1](data)
    serial = run_fused(PLANS["q1"], rels, device=CPU).to_df()
    with QueryExecutor(device=CPU, max_queue=4) as ex:
        pending = [ex.submit(PLANS["q1"], rels) for _ in range(3)]
        frames = [p.to_df(timeout=T) for p in pending]
    for got in frames:
        _frames_equal(got, want)
        _frames_equal(got, serial)
    assert all(p.latency_ns > 0 for p in pending)


def test_executor_runs_distinct_plans_in_order(rels, data):
    reqs = [(PLANS["q1"], rels), (PLANS["q3"], rels), (PLANS["q1"], rels)]
    with QueryExecutor(device=CPU) as ex:
        outs = ex.run(reqs, timeout=T)
    assert [o.names for o in outs] == [
        run_fused(p, r, device=CPU).names for p, r in reqs]
    _frames_equal(outs[2].to_df(), QUERIES["q1"][1](data))


def test_executor_admission_control_sheds_and_counts(rels):
    ex = QueryExecutor(device=CPU, max_queue=1, max_in_flight=1)
    try:
        first = ex.submit(PLANS["q1"], rels)
        # the in-flight slot stays held until the result is collected
        with pytest.raises(queue.Full):
            ex.submit(PLANS["q1"], rels, block=False)
        assert obs.kernel_stats().get("serving.rejected", 0) >= 1
        first.result(timeout=T)
        ex.submit(PLANS["q1"], rels, block=False).result(timeout=T)
    finally:
        ex.close(timeout=T)
    stats = obs.kernel_stats()
    assert stats.get("serving.submitted") == 2
    assert stats.get("serving.completed") == 2


def test_executor_propagates_plan_errors(rels):
    def _exploding(t):
        raise ValueError("boom in plan")

    with QueryExecutor(device=CPU) as ex:
        ok = ex.submit(PLANS["q1"], rels)
        bad = ex.submit(_exploding, rels)
        ok.result(timeout=T)
        with pytest.raises(ValueError, match="boom in plan"):
            bad.result(timeout=T)
    stats = obs.kernel_stats()
    assert stats.get("serving.failed", 0) == 1
    assert stats.get("serving.completed", 0) == 1
    kinds = [e["kind"] for e in obs.flight_snapshot()["events"]]
    assert "query_failed" in kinds


def test_executor_rejects_after_close_and_validates_bounds(rels):
    ex = QueryExecutor(device=CPU)
    ex.close(timeout=T)
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit(PLANS["q1"], rels)
    ex.close()  # idempotent
    with pytest.raises(ValueError, match="max_in_flight"):
        QueryExecutor(device=CPU, max_queue=8, max_in_flight=2)


def test_executor_abandoned_handle_releases_slot(rels):
    ex = QueryExecutor(device=CPU, max_queue=1, max_in_flight=1)
    try:
        pq = ex.submit(PLANS["q1"], rels)
        assert pq._event.wait(T)
        del pq
        gc.collect()
        ex.submit(PLANS["q1"], rels, block=False).result(timeout=T)
    finally:
        ex.close(timeout=T)


def test_executor_nonblocking_submit_with_timeout_sheds(rels):
    ex = QueryExecutor(device=CPU, max_queue=1, max_in_flight=1)
    try:
        first = ex.submit(PLANS["q1"], rels)
        with pytest.raises(queue.Full):
            ex.submit(PLANS["q1"], rels, block=False, timeout=0.5)
        first.result(timeout=T)
    finally:
        ex.close(timeout=T)


def test_executor_nonblocking_submit_tolerates_brief_contention(rels):
    ex = QueryExecutor(device=CPU, max_queue=4, max_in_flight=4)
    try:
        assert ex._submit_lock.acquire(timeout=T)  # simulate the holder
        timer = threading.Timer(0.1, ex._submit_lock.release)
        timer.start()
        ex.submit(PLANS["q1"], rels, block=False).result(timeout=T)
        timer.join(timeout=T)
    finally:
        ex.close(timeout=T)


def test_executor_nonblocking_grace_honors_caller_timeout(rels):
    ex = QueryExecutor(device=CPU, max_queue=4, max_in_flight=4)
    try:
        assert ex._submit_lock.acquire(timeout=T)
        try:
            t0 = time.monotonic()
            with pytest.raises(queue.Full, match="lock contended"):
                ex.submit(PLANS["q1"], rels, block=False, timeout=0.05)
            assert time.monotonic() - t0 < 0.5
        finally:
            ex._submit_lock.release()
    finally:
        ex.close(timeout=T)


def _gated_plan():
    gate, started = threading.Event(), threading.Event()

    def _gated(t):
        started.set()
        gate.wait(T)
        raise ValueError("gated probe done")

    return gate, started, _gated


def test_executor_submit_timeout_is_one_deadline(rels):
    gate, started, _gated = _gated_plan()
    ex = QueryExecutor(device=CPU, max_queue=1, max_in_flight=4)
    try:
        a = ex.submit(_gated, rels)      # the worker blocks inside it
        assert started.wait(T)
        b = ex.submit(_gated, rels)      # sits in the queue: queue full
        real_acquire, real_put = ex._inflight.acquire, ex._queue.put
        seen = {}

        def slow_acquire(blocking=True, timeout=None):
            time.sleep(0.25)
            return real_acquire(blocking=blocking, timeout=timeout)

        def spy_put(item, block=True, timeout=None):
            seen["timeout"] = timeout
            return real_put(item, block=block, timeout=timeout)

        ex._inflight.acquire, ex._queue.put = slow_acquire, spy_put
        try:
            with pytest.raises(queue.Full):
                ex.submit(PLANS["q1"], rels, timeout=0.5)
        finally:
            ex._inflight.acquire, ex._queue.put = real_acquire, real_put
        assert seen["timeout"] is not None and seen["timeout"] <= 0.35
        gate.set()
        for pq in (a, b):
            with pytest.raises(ValueError, match="gated probe"):
                pq.result(timeout=T)
    finally:
        gate.set()
        ex.close(timeout=T)


def test_executor_submit_timeout_covers_submit_lock(rels):
    gate, started, _gated = _gated_plan()
    ex = QueryExecutor(device=CPU, max_queue=1, max_in_flight=4)
    try:
        a = ex.submit(_gated, rels)
        assert started.wait(T)
        b = ex.submit(_gated, rels)      # the queue is now full
        holder = threading.Thread(       # parked in the untimed put
            target=lambda: ex.submit(_gated, rels), daemon=True)
        holder.start()
        deadline = time.monotonic() + T
        while not ex._submit_lock.locked():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        t0 = time.monotonic()
        with pytest.raises(queue.Full):
            ex.submit(PLANS["q1"], rels, timeout=0.3)
        assert time.monotonic() - t0 < 5.0
        t0 = time.monotonic()
        with pytest.raises(queue.Full):
            ex.submit(PLANS["q1"], rels, block=False)
        assert time.monotonic() - t0 < 5.0
        gate.set()
        for pq in (a, b):
            with pytest.raises(ValueError, match="gated probe"):
                pq.result(timeout=T)
        holder.join(timeout=T)
        assert not holder.is_alive()
    finally:
        gate.set()
        ex.close(timeout=T)


def test_executor_concurrent_result_releases_once(rels):
    from concurrent.futures import ThreadPoolExecutor

    with QueryExecutor(device=CPU) as ex:
        pq = ex.submit(PLANS["q1"], rels)
        with ThreadPoolExecutor(4) as tp:
            outs = list(tp.map(lambda _: pq.result(timeout=T), range(4)))
    assert all(o is outs[0] for o in outs)
    assert _gauge("serving.in_flight") == 0


def test_executor_submit_close_race_never_strands(rels):
    for _ in range(10):
        ex = QueryExecutor(device=CPU, max_queue=4)
        done = threading.Event()
        caught = []

        def spam():
            try:
                while not done.is_set():
                    ex.submit(PLANS["q1"], rels).result(timeout=T)
            except (RuntimeError, queue.Full) as e:
                caught.append(e)

        t = threading.Thread(target=spam)
        t.start()
        time.sleep(0.01)
        ex.close(timeout=T)
        done.set()
        t.join(timeout=120)
        assert not t.is_alive(), "submitter stranded after close()"


def test_executor_run_batch_larger_than_in_flight_completes(rels, data):
    with QueryExecutor(device=CPU, max_queue=2, max_in_flight=2) as ex:
        outs = ex.run([(PLANS["q1"], rels)] * 8, timeout=T)
    assert len(outs) == 8
    _frames_equal(outs[-1].to_df(), QUERIES["q1"][1](data))
    assert obs.kernel_stats().get("serving.completed") == 8
    assert obs.kernel_stats().get("serving.rejected", 0) == 0


def test_queue_depth_gauge_derives_from_counted_events(rels):
    entered, release = threading.Event(), threading.Event()

    def _blocking_plan(t):
        entered.set()
        release.wait(T)
        raise ValueError("done blocking")

    ex = QueryExecutor(device=CPU, max_queue=4)
    try:
        first = ex.submit(_blocking_plan, rels)
        assert entered.wait(T)
        queued = [ex.submit(PLANS["q1"], rels) for _ in range(3)]
        assert _gauge("serving.queue_depth") == 3
        release.set()
        with pytest.raises(ValueError, match="done blocking"):
            first.result(timeout=T)
        for p in queued:
            p.result(timeout=T)
        assert _gauge("serving.queue_depth") == 0
    finally:
        release.set()
        ex.close(timeout=T)


def test_executor_close_under_load_resolves_every_handle(rels):
    ex = QueryExecutor(device=CPU, max_queue=8, max_in_flight=16)
    pending = [ex.submit(PLANS["q1"], rels) for _ in range(8)]
    ex.close(wait=True, timeout=T)
    for p in pending:
        assert p.done(), "close(wait=True) left an unresolved handle"
        p.result(timeout=5)
    assert obs.kernel_stats().get("serving.completed") == 8
    assert _gauge("serving.in_flight") == 0


def test_executor_exports_queue_metrics(rels, monkeypatch):
    monkeypatch.setenv("SRT_METRICS", "1")
    with QueryExecutor(device=CPU) as ex:
        pq = ex.submit(PLANS["q1"], rels)
        pq.result(timeout=T)
    snap = obs.REGISTRY.to_json()
    assert snap["gauges"]["serving.queue_depth"] == 0
    assert snap["gauges"]["serving.in_flight"] == 0
    for h in ("serving.latency_ns", "serving.execute_ns",
              "serving.queue_wait_ns", "span.serving.execute"):
        assert snap["histograms"][h]["count"] >= 1, h
    prom = obs.REGISTRY.to_prometheus()
    assert "srt_serving_queue_depth" in prom
    obs.parse_prometheus(prom)
    snap = obs.SLO_TRACKER.snapshot()[("serving", 0)]
    assert snap["latency"]["e2e"]["count"] == 1
    assert snap["counts"] == {"served": 1}
    kinds = [(e["kind"], e.get("qid")) for e in
             obs.flight_snapshot()["events"]]
    assert kinds[:2] == [("query_admitted", pq.qid),
                         ("query_dispatch", pq.qid)]


def test_executor_pending_query_timeout_is_rewaitable(rels):
    gate, started, _gated = _gated_plan()
    with QueryExecutor(device=CPU) as ex:
        pq = ex.submit(_gated, rels)
        assert started.wait(T)
        with pytest.raises(TimeoutError, match="re-waitable"):
            pq.result(timeout=0.05)
        assert _gauge("serving.in_flight") == 1  # the slot stays held
        gate.set()
        with pytest.raises(ValueError, match="gated probe"):
            pq.result(timeout=T)
    assert _gauge("serving.in_flight") == 0
    assert isinstance(pq, PendingQuery)


def test_executor_serves_streamed_inputs(data, rels, monkeypatch):
    """HostTable inputs: the morsel runner's staging and pump run on the
    worker thread; results equal the in-core run."""
    monkeypatch.setenv("SRT_METRICS", "1")
    reset_standing_state()
    host = dict(rels)
    for f in ("store_sales", "store_returns"):
        host[f] = HostTable.from_df(data[f])
    try:
        with QueryExecutor(device=CPU) as ex:
            pend = [ex.submit(PLANS[q], host) for q in ("q1", "q3")]
            frames = [p.to_df(timeout=T) for p in pend]
        for q, got in zip(("q1", "q3"), frames):
            _frames_equal(got, run_fused(PLANS[q], rels,
                                         device=CPU).to_df(), q)
        assert obs.kernel_stats().get("exec.morsel.runs", 0) + \
            obs.kernel_stats().get("rel.route.morsel.incore", 0) == 2
    finally:
        reset_standing_state()


def test_reference_executor_still_serves_alongside(rels, data):
    """Both packages' executors live in one process: their counters are
    separate registries."""
    set_config(metrics_enabled=False)
    ref_rels = {k: ref_rel_from_df(v) for k, v in data.items()}
    with RefExecutor() as rex, QueryExecutor(device=CPU) as ex:
        a = rex.submit(RQ._q3, ref_rels)
        b = ex.submit(PLANS["q3"], rels)
        _frames_equal(b.to_df(timeout=T), a.to_df(timeout=600))
    assert ref_obs.kernel_stats().get("serving.completed") == 1
    assert obs.kernel_stats().get("serving.completed") == 1
