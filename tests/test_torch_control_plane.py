"""The port's SLO control plane against the reference's
(``tests/test_control_plane.py``), on the CPU.

1. **Verdicts, side by side.** Every unit scenario of the reference's
   suite runs through both packages' ``ControlPlane`` with the same
   private ``SloTracker`` samples, the same fake clock, the same fault
   specs and the same fake device memory; the verdicts, the latches,
   the scratch budgets and the ``serving.control.*`` counters must
   agree, and equal the values the reference's suite asserts.
2. **Wiring in the port.** The reference's integration cases through
   the port's ``FleetScheduler`` and ``QueryExecutor`` (their ``_run``
   seams, or real q3 runs at sf=0.2 on the CPU): predicted sheds
   replace dequeue expiries, a cold window admits everything, garbage
   telemetry latches to static policy, the shed storm carries the
   window's quantiles, autoscaling grows and retires workers, batch
   tuning, the memory loop on fake device memory, memory admission.
"""

import json
import queue
import time

import pytest

from spark_rapids_jni_tpu import obs as r_obs
from spark_rapids_jni_tpu.config import set_config as r_set_config
from spark_rapids_jni_tpu.obs import memory as r_memory
from spark_rapids_jni_tpu.obs import slo as r_slo
from spark_rapids_jni_tpu.parallel import comm_plan as r_comm
from spark_rapids_jni_tpu.serving import control_plane as r_cp
from spark_rapids_jni_tpu.utils import faults as r_faults

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.obs import memory, slo
from spark_rapids_jni_tpu_torch.parallel import comm_plan
from spark_rapids_jni_tpu_torch.serving import (FleetScheduler, QueryExecutor,
                                                QueryShed)
from spark_rapids_jni_tpu_torch.serving import control_plane as cp
from spark_rapids_jni_tpu_torch.utils import faults

MS = 1_000_000


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class _Side:
    """One package's control-plane surface."""

    def __init__(self, name, cp_mod, slo_mod, mem_mod, comm, flt, ob):
        self.name, self.cp, self.slo, self.mem = name, cp_mod, slo_mod, mem_mod
        self.comm, self.faults, self.obs = comm, flt, ob

    def tracker(self, clock, kind=None, ms=10.0, n=32, tenant="t", prio=0):
        t = self.slo.SloTracker(window_s=60, n_windows=3, _clock=clock)
        for _ in range(n):
            t.record(kind or self.slo.KIND_EXECUTE, tenant, prio,
                     int(ms * MS))
        return t

    def plane(self, clock, tracker, **pol):
        defaults = dict(min_samples=8, scale_interval_s=0.0,
                        mem_interval_s=0.0)
        defaults.update(pol)
        return self.cp.ControlPlane(name="test", n_workers=1,
                                    tracker=tracker,
                                    policy=self.cp.ControlPolicy(**defaults),
                                    _clock=clock)

    def stats(self, prefix="serving.control."):
        return {k: v for k, v in self.obs.kernel_stats().items()
                if k.startswith(prefix)}

    def fake_mem(self, frac, limit=1 << 30):
        self.mem.set_stats_source_for_testing(
            lambda: [{"bytes_in_use": int(frac * limit),
                      "peak_bytes_in_use": int(frac * limit),
                      "bytes_limit": limit}])


REF = _Side("ref", r_cp, r_slo, r_memory, r_comm, r_faults, r_obs)
PORT = _Side("port", cp, slo, memory, comm_plan, faults, obs)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("SRT_CONTROL_PLANE", "SRT_SHUFFLE_SCRATCH_BYTES", "SRT_FAULTS",
              "SRT_QUERY_DEADLINE_MS", "SRT_BATCH_MAX", "SRT_BATCH_WINDOW_MS",
              "SRT_RESULT_CACHE_BYTES", "SRT_CONTROL_MEM_ADMIT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SRT_METRICS", "1")
    r_set_config(metrics_enabled=True, control_plane_enabled=False)
    for s in (REF, PORT):
        s.obs.reset_all()
        s.faults.reset()
        s.mem.set_stats_source_for_testing(None)
        s.comm.reset_scratch_override()
    yield
    for s in (REF, PORT):
        s.faults.reset()
        s.mem.set_stats_source_for_testing(None)
        s.comm.reset_scratch_override()
        s.obs.reset_all()
    r_set_config(metrics_enabled=False, control_plane_enabled=False)


# --------------------------------------------------------------------------
# 1. verdicts, side by side
# --------------------------------------------------------------------------

def sc_latency_stats(S):
    clk = _Clock()
    t = S.slo.SloTracker(window_s=60, n_windows=3, _clock=clk)
    t.record(S.slo.KIND_QUEUE_WAIT, "a", 0, 10 * MS)
    t.record(S.slo.KIND_QUEUE_WAIT, "b", 5, 10 * MS)
    t.record(S.slo.KIND_EXECUTE, "a", 0, 10 * MS)
    out = [t.latency_stats(S.slo.KIND_QUEUE_WAIT),
           t.latency_stats(S.slo.KIND_QUEUE_WAIT, "a", 0),
           t.latency_stats(S.slo.KIND_QUEUE_WAIT, "c")]
    clk.t += 1000
    out.append(t.latency_stats(S.slo.KIND_QUEUE_WAIT))
    assert out[0]["count"] == 2 and out[1]["count"] == 1
    assert out[2] is None and out[3] is None
    return out


def sc_shed_cold_and_no_deadline(S):
    clk = _Clock()
    cold = S.plane(clk, S.tracker(clk, n=3))
    warm = S.plane(clk, S.tracker(clk))
    out = [cold.shed_verdict("t", 0, 0.001, 100, 1),
           warm.shed_verdict("t", 0, None, 100, 1)]
    assert out == [None, None]
    return out


def sc_shed_predicts_queue_plus_execute(S):
    clk = _Clock()
    plane = S.plane(clk, S.tracker(clk, ms=10))
    out = [plane.shed_verdict("t", 0, 1.0, 0, 1),
           plane.shed_verdict("t", 0, 0.1, 10, 1)]
    plane2 = S.plane(clk, S.tracker(clk, ms=10))
    out.append(plane2.shed_verdict("t", 0, 0.5, 10, 8))
    assert out[0] is None and out[1] > 100 * MS and out[2] is None
    return out


def sc_shed_hysteresis(S):
    clk = _Clock()
    plane = S.plane(clk, S.tracker(clk, ms=10), shed_enter=1.0,
                    shed_exit=0.5)
    out = [plane.shed_verdict("t", 0, 0.1, d, 1) for d in (0, 10, 3, 1, 3)]
    assert [o is not None for o in out] == [False, True, True, False, False]
    return out


def sc_shed_band_per_tenant(S):
    clk = _Clock()
    t = S.tracker(clk, ms=10, tenant="bronze", prio=0)
    for _ in range(32):
        t.record(S.slo.KIND_EXECUTE, "gold", 10, 10 * MS)
    plane = S.plane(clk, t)
    out = [plane.shed_verdict("bronze", 0, 0.05, 20, 1),
           plane.shed_verdict("gold", 10, 1.0, 0, 1)]
    assert out[0] is not None and out[1] is None
    return out


def sc_garbage_latches(S):
    clk = _Clock()
    plane = S.plane(clk, S.tracker(clk, ms=10), fault_cooldown_s=30.0)
    S.faults.configure("control:corrupt:1")
    out = [plane.shed_verdict("t", 0, 0.01, 50, 1),
           plane.latched(S.cp.LOOP_SHED), dict(S.faults.remaining()),
           plane.shed_verdict("t", 0, 0.01, 50, 1),
           S.stats("serving.")]
    clk.t += 31.0
    out += [plane.latched(S.cp.LOOP_SHED),
            plane.shed_verdict("t", 0, 0.01, 50, 1) is not None]
    assert out[0] is None and out[1] and out[3] is None
    assert out[4]["serving.control.telemetry_errors"] == 1
    assert out[4]["serving.fault.injected.control.corrupt"] == 1
    assert out[-2:] == [False, True]
    return out


def sc_latch_per_loop(S):
    clk = _Clock()
    plane = S.plane(clk, S.tracker(clk, ms=10))
    S.faults.configure("control:raise:1")
    out = [plane.shed_verdict("t", 0, 0.01, 50, 1),
           plane.latched(S.cp.LOOP_SHED)]
    out.append(plane.tune_batch("t", 0, 16, 0.005, 0.001, 0.005))
    out.append(plane.latched(S.cp.LOOP_BATCH))
    assert out[1] and not out[3]
    return out


def sc_tune_batch_static(S):
    clk = _Clock()
    out = [S.plane(clk, S.tracker(clk, n=2)).tune_batch(
               "t", 0, 16, 0.004, 0.001, 0.005),
           S.plane(clk, S.tracker(clk)).tune_batch(
               "t", 0, 16, 0.004, None, 0.005), S.stats()]
    assert out[:2] == [(16, 0.004), (16, 0.004)]
    return out


def sc_tune_batch_rungs(S):
    clk = _Clock()
    plane = S.plane(clk, S.tracker(clk, ms=10))
    out = [plane.tune_batch("t", 0, 16, 0.0, 0.002, 0.005),
           plane.tune_batch("t", 0, 16, 0.0, 0.050, 0.005),
           plane.tune_batch("t", 0, 4, 0.0, 0.001, 0.005), S.stats()]
    assert out[0][0] == 8 and out[1] == (1, 0.0) and out[2][0] == 4
    assert out[3]["serving.control.batch.tuned"] == 3
    return out


def sc_used_fraction(S):
    S.mem.set_stats_source_for_testing(
        lambda: [{"bytes_in_use": 100, "bytes_limit": 1000}, None,
                 {"bytes_in_use": 900, "bytes_limit": 1000}])
    out = [S.mem.device_used_fraction()]
    S.mem.set_stats_source_for_testing(lambda: [None])
    out.append(S.mem.device_used_fraction())
    assert out == [pytest.approx(0.9), None]
    return out


def sc_memory_shrink_restore(S, monkeypatch):
    monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "65536")
    S.fake_mem(0.95)
    clk = _Clock()
    plane = S.plane(clk, S.tracker(clk), mem_high=0.85, mem_low=0.5)
    holder = object()
    plane.check_memory(holder, static_cap=16)
    out = [S.comm.scratch_budget(), plane._mem_capped(16)]
    plane.check_memory(holder, static_cap=16)
    out += [S.comm.scratch_budget(), plane._mem_capped(16),
            S.comm.scratch_override_active()]
    S.fake_mem(0.2)
    plane.check_memory(holder, static_cap=16)
    out += [plane._mem_capped(16), S.comm.scratch_budget(),
            S.comm.scratch_override_active(), S.stats()]
    assert out[:8] == [32768, 8, 16384, 4, True, 16, 65536, False]
    assert out[8]["serving.control.mem.restored"] == 1
    return out


def sc_memory_inert(S, monkeypatch):
    monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "65536")
    S.mem.set_stats_source_for_testing(lambda: [None, None])
    clk = _Clock()
    S.plane(clk, S.tracker(clk)).check_memory(object(), static_cap=16)
    out = [S.stats(), S.comm.scratch_budget()]
    assert out[1] == 65536
    return out


def sc_memory_counters_distinct(S, monkeypatch):
    monkeypatch.setenv("SRT_SHUFFLE_SCRATCH_BYTES", "65536")
    S.fake_mem(0.95)
    clk = _Clock()
    S.plane(clk, S.tracker(clk)).check_memory(object(), static_cap=16)
    out = S.stats("serving.")
    assert out["serving.control.mem.scratch_shrunk"] == 1
    assert not any(k.startswith("serving.fault.oom.") for k in out)
    return out


def sc_autoscale_bounds(S):
    clk = _Clock()
    q = S.slo.KIND_QUEUE_WAIT
    plane = S.plane(clk, S.tracker(clk, kind=q, ms=500),
                    queue_wait_slo_ms=100.0, scale_min=1, scale_max=3)
    out = [plane.desired_workers(n, queued=5, last_crash_monotonic=0)
           for n in (1, 2, 3)]
    plane2 = S.plane(clk, S.tracker(clk, kind=q, ms=1),
                     queue_wait_slo_ms=100.0, scale_min=1, scale_max=3)
    out += [plane2.desired_workers(n, queued=0, last_crash_monotonic=0)
            for n in (3, 1)]
    plane3 = S.plane(clk, S.tracker(clk, kind=q, ms=500, n=2),
                     queue_wait_slo_ms=100.0, scale_max=3)
    out.append(plane3.desired_workers(1, queued=5, last_crash_monotonic=0))
    assert out == [2, 3, None, 2, None, None]
    return out


def sc_autoscale_cooldown(S):
    clk = _Clock()
    plane = S.plane(clk, S.tracker(clk, kind=S.slo.KIND_QUEUE_WAIT, ms=500),
                    queue_wait_slo_ms=100.0, scale_max=4,
                    crash_cooldown_s=10.0)
    crash_t = clk.t - 2.0
    out = [plane.desired_workers(1, queued=5, last_crash_monotonic=crash_t),
           S.stats()]
    clk.t += 9.0
    out.append(plane.desired_workers(1, queued=5,
                                     last_crash_monotonic=crash_t))
    assert out[0] is None and out[2] == 2
    assert out[1]["serving.control.scale.held"] == 1
    return out


def sc_autoscale_rate_limit(S):
    clk = _Clock()
    plane = S.plane(clk, S.tracker(clk, kind=S.slo.KIND_QUEUE_WAIT, ms=500),
                    queue_wait_slo_ms=100.0, scale_max=4,
                    scale_interval_s=5.0)
    out = [plane.desired_workers(1, queued=5, last_crash_monotonic=0),
           plane.desired_workers(1, queued=5, last_crash_monotonic=0)]
    clk.t += 6.0
    out.append(plane.desired_workers(1, queued=5, last_crash_monotonic=0))
    assert out == [2, None, 2]
    return out


def sc_memory_verdict(S, monkeypatch):
    monkeypatch.setenv("SRT_CONTROL_MEM_ADMIT", "1")
    clk = _Clock()
    plane = S.plane(clk, S.tracker(clk))
    S.fake_mem(0.999, limit=1 << 20)
    out = [plane.memory_verdict(1 << 16), plane.memory_verdict(0)]
    S.fake_mem(0.0, limit=1 << 30)
    out.append(plane.memory_verdict(1 << 16))
    S.mem.set_stats_source_for_testing(lambda: [None])
    out.append(plane.memory_verdict(1 << 16))
    out.append(S.stats())
    assert out[0] is not None and out[1:4] == [None, None, None]
    return out


def sc_policy_env(S, monkeypatch):
    monkeypatch.setenv("SRT_CONTROL_SHED", "0")
    monkeypatch.setenv("SRT_CONTROL_MIN_SAMPLES", "5")
    monkeypatch.setenv("SRT_CONTROL_SHED_ENTER", "0.9")
    monkeypatch.setenv("SRT_CONTROL_SCALE_MAX", "7")
    out = [S.cp.ControlPolicy.from_env()]
    monkeypatch.setenv("SRT_CONTROL_MIN_SAMPLES", "junk")
    monkeypatch.setenv("SRT_CONTROL_SHED_EXIT", "1.5")
    out.append(S.cp.ControlPolicy.from_env())
    assert not out[0].shed_on and out[0].min_samples == 5
    assert out[1].min_samples == 16 and out[1].shed_exit == out[1].shed_enter
    for k in ("SRT_CONTROL_SHED", "SRT_CONTROL_MIN_SAMPLES",
              "SRT_CONTROL_SHED_ENTER", "SRT_CONTROL_SCALE_MAX",
              "SRT_CONTROL_SHED_EXIT"):
        monkeypatch.delenv(k)
    return [vars(p) for p in out]


SCENARIOS = {
    "latency_stats": sc_latency_stats,
    "shed_cold_and_no_deadline": sc_shed_cold_and_no_deadline,
    "shed_predicts_queue_plus_execute": sc_shed_predicts_queue_plus_execute,
    "shed_hysteresis": sc_shed_hysteresis,
    "shed_band_per_tenant": sc_shed_band_per_tenant,
    "garbage_latches": sc_garbage_latches,
    "latch_per_loop": sc_latch_per_loop,
    "tune_batch_static": sc_tune_batch_static,
    "tune_batch_rungs": sc_tune_batch_rungs,
    "used_fraction": sc_used_fraction,
    "memory_shrink_restore": sc_memory_shrink_restore,
    "memory_inert": sc_memory_inert,
    "memory_counters_distinct": sc_memory_counters_distinct,
    "autoscale_bounds": sc_autoscale_bounds,
    "autoscale_cooldown": sc_autoscale_cooldown,
    "autoscale_rate_limit": sc_autoscale_rate_limit,
    "memory_verdict": sc_memory_verdict,
    "policy_env": sc_policy_env,
}


def _run_side(fn, side, monkeypatch):
    side.obs.reset_all()
    side.faults.reset()
    side.comm.reset_scratch_override()
    if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        return fn(side, monkeypatch)
    return fn(side)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_verdicts_match_reference(name, monkeypatch):
    fn = SCENARIOS[name]
    want = _run_side(fn, REF, monkeypatch)
    got = _run_side(fn, PORT, monkeypatch)
    assert got == want


def test_master_switch_and_recording(monkeypatch):
    assert cp.maybe_control_plane("x") is None
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    assert isinstance(cp.maybe_control_plane("x"), cp.ControlPlane)
    # with metrics off, the control plane keeps the sketches recording
    monkeypatch.setenv("SRT_METRICS", "0")
    t = slo.SloTracker(window_s=60, n_windows=2, _clock=_Clock())
    t.record(slo.KIND_EXECUTE, "a", 0, 5 * MS)
    assert t.latency_stats(slo.KIND_EXECUTE, "a", 0)["count"] == 1
    monkeypatch.setenv("SRT_CONTROL_PLANE", "0")
    t.record(slo.KIND_EXECUTE, "a", 0, 5 * MS)
    assert t.latency_stats(slo.KIND_EXECUTE, "a", 0)["count"] == 1


# --------------------------------------------------------------------------
# 2. wiring in the port's scheduler and executor
# --------------------------------------------------------------------------

def _noop_plan(t):
    raise AssertionError("never run: the seam answers")


def _slow_run(dt):
    def run(plan, rels, mesh=None, axis=None):
        time.sleep(dt)
        return "out"
    return run


def _burst(sched, n, deadline_ms, tenant=None):
    handles, sheds = [], 0
    for _ in range(n):
        try:
            handles.append(sched.submit(_noop_plan, {}, tenant=tenant,
                                        deadline_ms=deadline_ms))
        except QueryShed:
            sheds += 1
    return handles, sheds


def _sched(**kw):
    kw.setdefault("n_workers", 1)
    kw.setdefault("batch_max", 1)
    return FleetScheduler(device="cpu", **kw)


def test_scheduler_predictive_shed_replaces_expiry(monkeypatch):
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    monkeypatch.setenv("SRT_CONTROL_MIN_SAMPLES", "4")
    monkeypatch.setenv("SRT_CONTROL_SCALE", "0")
    with _sched(_run=_slow_run(0.01)) as sched:
        for _ in range(6):
            sched.submit(_noop_plan, {}).result(timeout=30)
        handles, sheds = _burst(sched, 30, deadline_ms=60)
        results = [pq.result(timeout=30) for pq in handles]
    stats = obs.kernel_stats()
    assert stats["serving.shed.predicted"] == sheds and sheds > 0
    assert stats["serving.tenant.default.shed_predicted"] == sheds
    assert stats.get("serving.fault.expired", 0) == 0
    assert results == ["out"] * len(handles)
    assert stats["serving.shed"] == sheds


def test_scheduler_without_control_plane_expires_at_dequeue():
    with _sched(_run=_slow_run(0.01)) as sched:
        for _ in range(6):
            sched.submit(_noop_plan, {}).result(timeout=30)
        handles, sheds = _burst(sched, 30, deadline_ms=60)
        outcomes = []
        for pq in handles:
            try:
                outcomes.append(pq.result(timeout=30))
            except Exception as e:
                outcomes.append(type(e).__name__)
    stats = obs.kernel_stats()
    assert sheds == 0 and "serving.shed.predicted" not in stats
    assert stats["serving.fault.expired"] > 0
    assert "QueryExpired" in outcomes


def test_scheduler_cold_window_admits_everything(monkeypatch):
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    monkeypatch.setenv("SRT_CONTROL_SCALE", "0")
    with _sched(_run=_slow_run(0.001)) as sched:
        handles, sheds = _burst(sched, 10, deadline_ms=10_000)
        assert sheds == 0
        assert [pq.result(timeout=30) for pq in handles] == ["out"] * 10
    assert "serving.shed.predicted" not in obs.kernel_stats()


def test_scheduler_garbage_telemetry_degrades_to_static(monkeypatch):
    for k, v in (("SRT_CONTROL_PLANE", "1"), ("SRT_CONTROL_MIN_SAMPLES", "4"),
                 ("SRT_CONTROL_SCALE", "0"), ("SRT_CONTROL_MEM", "0"),
                 ("SRT_CONTROL_BATCH", "0")):
        monkeypatch.setenv(k, v)
    faults.configure("control:corrupt:1")
    with _sched(_run=_slow_run(0.002)) as sched:
        for _ in range(6):
            sched.submit(_noop_plan, {}).result(timeout=30)
        handles, sheds = _burst(sched, 8, deadline_ms=10_000)
        results = [pq.result(timeout=30) for pq in handles]
    stats = obs.kernel_stats()
    assert sheds == 0 and results == ["out"] * 8
    assert stats["serving.control.telemetry_errors"] == 1
    assert stats["serving.control.fallback.shed"] == 1
    assert "serving.shed.predicted" not in stats


def test_predicted_shed_storm_dumps_with_window_quantiles(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    monkeypatch.setenv("SRT_CONTROL_MIN_SAMPLES", "4")
    monkeypatch.setenv("SRT_CONTROL_SCALE", "0")
    monkeypatch.setenv("SRT_TRACE_EXPORT", str(tmp_path))
    with _sched(_run=_slow_run(0.005)) as sched:
        for _ in range(6):
            sched.submit(_noop_plan, {}).result(timeout=30)
        _, sheds = _burst(sched, 35, deadline_ms=1)
        assert sheds == 35
        deadline = time.monotonic() + 10
        dumps = []
        while not dumps and time.monotonic() < deadline:
            dumps = sorted(tmp_path.glob("flight_*_shed_storm.json"))
            time.sleep(0.02)
    assert dumps, "the predicted-shed storm did not dump the recorder"
    body = json.loads(dumps[0].read_text(encoding="utf-8"))
    storms = [e for e in body["events"] if e["kind"] == "shed_storm"]
    assert storms and storms[0]["tenant"] == "default"
    wq = storms[0]["window_quantiles"]
    assert wq[slo.KIND_EXECUTE]["count"] >= 4
    assert wq[slo.KIND_EXECUTE]["p90_ns"] >= 5 * MS
    assert body["fault_counters"]["serving.shed.predicted"] >= 32


def test_scheduler_autoscales_up_under_backlog(monkeypatch):
    for k, v in (("SRT_CONTROL_PLANE", "1"), ("SRT_CONTROL_MIN_SAMPLES", "4"),
                 ("SRT_CONTROL_SHED", "0"),
                 ("SRT_CONTROL_SCALE_INTERVAL_S", "0"),
                 ("SRT_CONTROL_QUEUE_WAIT_SLO_MS", "2"),
                 ("SRT_CONTROL_SCALE_MAX", "3")):
        monkeypatch.setenv(k, v)
    sched = _sched(_run=_slow_run(0.01))
    try:
        handles = [sched.submit(_noop_plan, {}) for _ in range(24)]
        for pq in handles:
            assert pq.result(timeout=30) == "out"
        assert obs.kernel_stats().get("serving.control.scale.up", 0) >= 1
        with sched._cv:
            assert sched._live_workers >= 2
    finally:
        sched.close(wait=True)


def test_worker_retirement_mechanism(monkeypatch):
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    sched = _sched(n_workers=3, _run=_slow_run(0.001))
    try:
        with sched._cv:
            assert sched._live_workers == 3
            sched._target_workers = 1
            sched._cv.notify_all()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with sched._cv:
                if sched._live_workers == 1:
                    break
            time.sleep(0.01)
        with sched._cv:
            assert sched._live_workers == 1 and sched._retiring == 0
        assert obs.kernel_stats()["serving.control.scale.retired"] == 2
        assert sched.submit(_noop_plan, {}).result(timeout=30) == "out"
    finally:
        sched.close(wait=True)


def test_autoscaled_worker_survives_crash_supervision(monkeypatch):
    for k, v in (("SRT_CONTROL_PLANE", "1"), ("SRT_CONTROL_MIN_SAMPLES", "4"),
                 ("SRT_CONTROL_SHED", "0"),
                 ("SRT_CONTROL_SCALE_INTERVAL_S", "0"),
                 ("SRT_CONTROL_QUEUE_WAIT_SLO_MS", "2"),
                 ("SRT_CONTROL_SCALE_MAX", "2")):
        monkeypatch.setenv(k, v)
    faults.configure("worker:crash:1")
    sched = _sched(max_retries=2, retry_backoff_ms=0, _run=_slow_run(0.005))
    try:
        handles = [sched.submit(_noop_plan, {}) for _ in range(16)]
        for pq in handles:
            assert pq.result(timeout=30) == "out"
        stats = obs.kernel_stats()
        assert stats["serving.fault.worker_crashes"] == 1
        assert stats["serving.fault.worker_restarts"] == 1
    finally:
        sched.close(wait=True)


def test_scheduler_batch_tuning_counts(monkeypatch):
    for k, v in (("SRT_CONTROL_PLANE", "1"), ("SRT_CONTROL_MIN_SAMPLES", "4"),
                 ("SRT_CONTROL_SHED", "0"), ("SRT_CONTROL_SCALE", "0")):
        monkeypatch.setenv(k, v)

    def run_batched(plan, relss):
        time.sleep(0.005)
        return ["out"] * len(relss)

    sched = _sched(batch_max=8, _run=_slow_run(0.005),
                   _run_batched=run_batched)
    try:
        for _ in range(8):
            sched.submit(_noop_plan, {}).result(timeout=30)
        handles = [sched.submit(_noop_plan, {}) for _ in range(16)]
        for pq in handles:
            assert pq.result(timeout=30) == "out"
        assert obs.kernel_stats().get("serving.control.batch.tuned", 0) >= 1
    finally:
        sched.close(wait=True)


def test_scheduler_memory_pressure_wiring(monkeypatch):
    for k, v in (("SRT_CONTROL_PLANE", "1"),
                 ("SRT_SHUFFLE_SCRATCH_BYTES", "65536"),
                 ("SRT_CONTROL_MEM_INTERVAL_S", "0"),
                 ("SRT_CONTROL_SHED", "0"), ("SRT_CONTROL_SCALE", "0")):
        monkeypatch.setenv(k, v)
    PORT.fake_mem(0.95)
    sched = _sched(_run=_slow_run(0.001))
    try:
        sched.submit(_noop_plan, {}).result(timeout=30)
        assert obs.kernel_stats()["serving.control.mem.scratch_shrunk"] >= 1
        assert comm_plan.scratch_budget() < 65536
        PORT.fake_mem(0.1)
        sched.submit(_noop_plan, {}).result(timeout=30)
        assert obs.kernel_stats()["serving.control.mem.restored"] == 1
        assert comm_plan.scratch_budget() == 65536
    finally:
        sched.close(wait=True)


def test_executor_predictive_shed(monkeypatch):
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    monkeypatch.setenv("SRT_CONTROL_MIN_SAMPLES", "4")
    monkeypatch.setattr("spark_rapids_jni_tpu_torch.tpcds.rel.run_fused",
                        lambda plan, rels, device=None, mesh=None, axis=None:
                        (time.sleep(0.01), "out")[1])
    ex = QueryExecutor(max_queue=64, max_in_flight=64, deadline_ms=40,
                       device="cpu", name="exctl")
    try:
        for _ in range(6):
            ex.submit(_noop_plan, {}).result(timeout=30)
        handles, sheds = [], 0
        for _ in range(30):
            try:
                handles.append(ex.submit(_noop_plan, {}))
            except queue.Full as e:
                assert "serving.shed.predicted" in str(e)
                sheds += 1
        for pq in handles:
            assert pq.result(timeout=30) == "out"
    finally:
        ex.close(wait=True)
    assert sheds > 0
    assert obs.kernel_stats()["serving.shed.predicted"] == sheds


def test_executor_without_deadline_never_predict_sheds(monkeypatch):
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    monkeypatch.setattr("spark_rapids_jni_tpu_torch.tpcds.rel.run_fused",
                        lambda plan, rels, device=None, mesh=None, axis=None:
                        "out")
    ex = QueryExecutor(max_queue=64, max_in_flight=64, device="cpu",
                       name="exnone")
    try:
        for _ in range(8):
            ex.submit(_noop_plan, {}).result(timeout=30)
    finally:
        ex.close(wait=True)
    assert "serving.shed.predicted" not in obs.kernel_stats()


@pytest.fixture(scope="module")
def rels():
    from spark_rapids_jni_tpu_torch.tpcds import generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df
    return {k: rel_from_df(v, device="cpu")
            for k, v in generate(sf=0.2, seed=7).items()}


def test_proactive_degradation_end_to_end_real_queries(monkeypatch, rels):
    from spark_rapids_jni_tpu_torch.tpcds import PLANS
    for k, v in (("SRT_CONTROL_PLANE", "1"),
                 ("SRT_SHUFFLE_SCRATCH_BYTES", "65536"),
                 ("SRT_CONTROL_MEM_INTERVAL_S", "0"),
                 ("SRT_CONTROL_SHED", "0"), ("SRT_CONTROL_SCALE", "0")):
        monkeypatch.setenv(k, v)
    shim = faults.FakeDeviceMemory(limit_bytes=1 << 30).install()
    shim.set_used_fraction(0.95)
    sched = _sched(batch_max=4, name="memfleet")
    try:
        out1 = sched.submit(PLANS["q3"], rels).result(timeout=60)
        stats = obs.kernel_stats()
        assert stats.get("serving.control.mem.scratch_shrunk", 0) >= 1
        assert stats.get("serving.control.mem.batch_halved", 0) >= 1
        assert comm_plan.scratch_budget() < 65536
        shim.set_used_fraction(0.2)
        out2 = sched.submit(PLANS["q3"], rels).result(timeout=60)
        assert obs.kernel_stats().get("serving.control.mem.restored", 0) >= 1
        assert comm_plan.scratch_budget() == 65536
        assert out1.to_df().equals(out2.to_df())
    finally:
        sched.close(wait=True)
        shim.uninstall()


def test_memory_admission_sheds_on_modeled_bytes(monkeypatch, rels):
    from spark_rapids_jni_tpu_torch.tpcds import PLANS
    for k, v in (("SRT_CONTROL_PLANE", "1"), ("SRT_CONTROL_MEM_ADMIT", "1"),
                 ("SRT_CONTROL_MEM_INTERVAL_S", "0"),
                 ("SRT_CONTROL_SHED", "0"), ("SRT_CONTROL_SCALE", "0")):
        monkeypatch.setenv(k, v)
    shim = faults.FakeDeviceMemory(limit_bytes=1 << 20).install()
    shim.set_used_fraction(0.999)
    sched = _sched(name="admfleet")
    try:
        with pytest.raises(QueryShed) as e:
            sched.submit(PLANS["q3"], rels)
        assert "serving.shed.memory_predicted" in str(e.value)
        assert obs.kernel_stats().get("serving.shed.memory_predicted") == 1
        shim.set_used_fraction(0.0)
        shim.limit_bytes = 16 << 30
        sched.submit(PLANS["q3"], rels).result(timeout=60)
    finally:
        sched.close(wait=True)
        shim.uninstall()


def test_memory_admission_no_signal_admits(monkeypatch, rels):
    from spark_rapids_jni_tpu_torch.tpcds import PLANS
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    monkeypatch.setenv("SRT_CONTROL_MEM_ADMIT", "1")
    sched = _sched(name="nosig")
    try:
        sched.submit(PLANS["q3"], rels).result(timeout=60)
        assert "serving.shed.memory_predicted" not in obs.kernel_stats()
    finally:
        sched.close(wait=True)
