"""Fleet scheduler: multi-tenant serving over N workers on one device.

Port of ``spark_rapids_jni_tpu/serving/scheduler.py``, without its mesh
replica slices and its control plane (both raise at construction until
they are ported). ``QueryExecutor`` is one FIFO worker; this grows it
into a scheduler with the reference's disciplines:

- **Weighted-fair queues under priority classes.** Each tenant owns a
  FIFO queue with a ``priority`` (strict: a queued higher class always
  dispatches first) and a ``weight`` (virtual-time weighted fair queuing
  within a class: a weight-3 tenant gets about 3x the dispatches of a
  weight-1 peer when both are backlogged). N workers pull from the
  queues. Plan runs serialize on the planner lock (``tpcds/rel.py``
  ``_PLAN_LOCK``); the workers overlap the rest: a batch's host sync,
  the materializations, a replayed graph's device time.

- **Admission budgets and shed-lowest-priority-first.** Every tenant has
  a queue bound and an in-flight budget (queued + executing +
  uncollected results, released at collection or by the garbage
  collector). When the global queue saturates, a higher-priority arrival
  preempts the newest queued item of the lowest-priority backlogged
  tenant; otherwise the arrival sheds. Every shed is a
  :class:`QueryShed` delivered to exactly one caller and counted
  (``serving.shed``, ``serving.tenant.<t>.shed``).

- **Result cache and micro-batching.** Submission first consults the
  content-keyed result cache: a hit resolves at once, with no queueing
  and no dispatch. Workers then coalesce up to ``batch_max`` compatible
  queued submissions within a window (fixed, or adaptive to the arrival
  rate) into one batched dispatch (``serving/batcher.py``), replayed
  from a CUDA graph on the card, and hand each caller its own result.

- **Fault tolerance.** Workers are supervised: a worker thread that dies
  (the ``worker`` chaos seam, or any unexpected escape) has its
  in-flight queries requeued and a replacement spawned; a query present
  at two deaths is quarantined (:class:`~.reliability.QueryPoisoned`).
  Transient failures (injected faults, ``RetryOOM``,
  ``SplitAndRetryOOM``) retry under a bounded budget with jittered
  exponential backoff (``RetryPolicy``: ``SRT_QUERY_RETRIES``,
  ``SRT_RETRY_BACKOFF_MS``); deadlines (``SRT_QUERY_DEADLINE_MS`` or a
  per-submit ``deadline_ms``) are enforced at dequeue, where an expired
  query sheds as :class:`~.reliability.QueryExpired` before a dispatch.
  ``close()`` resolves every handle.

Obs: ``serving.submitted/completed/failed/shed``, per tenant
``serving.tenant.<t>.{submitted,completed,failed,shed,cache_hits,
batched,retries,expired,quarantined}``, the ``serving.fault.*`` family,
the ``serving.tenant.<t>.queue_depth`` / ``.in_flight`` and
``serving.sched.queue_depth`` gauges, the gated
``serving.queue_wait_ns`` / ``serving.latency_ns`` histograms, the SLO
windows (``obs/slo.py``) and a ``/healthz`` source (``obs/server.py``).
"""

from __future__ import annotations

import atexit
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import env_bool, env_str, metrics_enabled
from ..obs import count, gauge, histogram
from ..obs import flight as _flight
from ..obs import report as _obs_report
from ..obs import server as _obs_server
from ..obs import slo as _slo
from ..utils import faults as _faults
from ..utils.device import resolve_device
from . import batcher as _batcher
from . import reliability as _reliability
from .executor import PendingQuery
from .reliability import QueryExpired, QueryPoisoned, RetryPolicy
from .result_cache import result_cache


class QueryShed(RuntimeError):
    """Admission control dropped this query: the submission itself
    (raised from ``submit``) or a lower-priority queued query preempted
    to admit a higher-priority arrival (delivered through the victim's
    ``PendingQuery.result()``). Always counted against the shed
    tenant."""

    def __init__(self, tenant: str, reason: str):
        super().__init__(f"query shed for tenant {tenant!r}: {reason}")
        self.tenant = tenant
        self.reason = reason


@dataclass
class TenantConfig:
    """One tenant's scheduling contract: ``priority`` is the strict
    dispatch and shed class (higher dispatches first, sheds last),
    ``weight`` the fair share within a class, ``max_queue`` bounds the
    tenant's queued backlog, ``max_in_flight`` its admission budget
    (queued + executing + uncollected handles)."""

    name: str
    weight: float = 1.0
    priority: int = 0
    max_queue: int = 64
    max_in_flight: int = 256


class _TenantState:
    __slots__ = ("cfg", "queue", "vtime", "in_flight")

    def __init__(self, cfg: TenantConfig):
        self.cfg = cfg
        self.queue: "deque[_Item]" = deque()
        self.vtime = 0.0  # weighted-fair virtual finish time
        self.in_flight = 0


class _Item:
    """One queued submission: the handle and what a worker needs to
    execute, batch, retry and account it. ``attempts`` counts retries of
    transient failures, ``crashes`` the worker deaths it was in flight
    for, ``deadline`` the monotonic cutoff enforced at dequeue."""

    __slots__ = ("pq", "plan", "rels", "mesh", "axis", "tenant", "bkey",
                 "rtoken", "sched", "attempts", "crashes", "deadline",
                 "dequeue_ns", "dispatch_ns")

    def __init__(self, pq, plan, rels, tenant, bkey, rtoken, sched=None,
                 deadline=None):
        self.pq = pq
        self.plan = plan
        self.rels = rels
        self.mesh = None  # the batcher's per-query route passes it on
        self.axis = None
        self.tenant = tenant  # _TenantState
        self.bkey = bkey
        self.rtoken = rtoken
        self.sched = sched  # owning FleetScheduler (retry routing)
        self.attempts = 0
        self.crashes = 0
        self.deadline = deadline  # monotonic seconds, or None
        # SLO timestamps: stamped at dequeue and at dispatch, so queue
        # wait, batch wait and execute split per tenant and priority
        self.dequeue_ns = None
        self.dispatch_ns = None

    # the batcher's resolution hooks: per-tenant accounting and the
    # result-cache fill, the same on the batched and per-query routes
    def resolve(self, out) -> None:
        tname = self.tenant.cfg.name
        if self.rtoken is not None:
            rcache = result_cache()
            if rcache is not None:
                rcache.put(self.rtoken, out)
        if self.attempts or self.crashes:
            # the run's own counter delta cannot see scheduler retries
            _obs_report.annotate_reliability(self.pq.query, {
                "serving.fault.attempts": self.attempts,
                "serving.fault.crashes_survived": self.crashes})
        done = time.perf_counter_ns()
        self.pq._resolve(out)
        count("serving.completed")
        count(f"serving.tenant.{tname}.completed")
        histogram("serving.latency_ns").observe(done - self.pq.submit_ns)
        histogram(f"serving.tenant.{tname}.latency_ns").observe(
            done - self.pq.submit_ns)
        prio = self.tenant.cfg.priority
        if self.dispatch_ns is not None:
            _slo.record(_slo.KIND_EXECUTE, tname, prio,
                        done - self.dispatch_ns)
        _slo.record(_slo.KIND_E2E, tname, prio, done - self.pq.submit_ns)
        _slo.note(_slo.EVENT_SERVED, tname, prio)

    def reject(self, exc: BaseException) -> None:
        # the retry matrix gets first refusal: a retryable failure
        # requeues under the bounded budget instead of reaching the caller
        if self.sched is not None and self.sched._maybe_retry(self, exc):
            return
        self.fail(exc)

    def fail(self, exc: BaseException) -> None:
        """Deliver ``exc`` to the caller, bypassing retry (terminal)."""
        tname = self.tenant.cfg.name
        self.pq._reject(exc)
        count("serving.failed")
        count(f"serving.tenant.{tname}.failed")


DEFAULT_TENANT = TenantConfig("default")

# A shed storm, this many sheds inside the window, dumps the flight
# recorder (the dump itself is rate-limited per reason).
SHED_STORM_N = 32
SHED_STORM_WINDOW_S = 5.0


def default_workers(dev: torch.device) -> int:
    """The reference's rule over the port's devices: one worker a device
    of ``dev``'s kind, at most 4; when no device answers the probe, one
    worker, counted ``serving.device_probe_errors``."""
    if dev.type != "cuda":
        return 1
    try:
        n = torch.cuda.device_count()
    except Exception:
        n = 0
    if n < 1:
        count("serving.device_probe_errors")
        return 1
    return min(4, n)


class FleetScheduler:
    """N-worker multi-tenant scheduler over the fused runner::

        sched = FleetScheduler(
            tenants=[TenantConfig("interactive", weight=3, priority=10),
                     TenantConfig("batch", weight=1, priority=0)],
            n_workers=2, batch_max=8, device="cuda")
        pq = sched.submit(plan, rels, tenant="interactive")
        frame = pq.to_df()

    ``device`` is where the submitted rels live (``cuda`` unless the
    caller passes another). ``n_workers`` defaults to the device count
    of that kind, at most 4 (one on the CPU). ``batch_max`` defaults to
    1 (batching off) unless ``SRT_BATCH_MAX`` is set
    (``fused_pipeline.max_batch_queries``); it clamps to the capacity
    ladder. ``batch_window_ms=None`` with no ``SRT_BATCH_WINDOW_MS``
    takes the adaptive arrival-rate window.

    ``mesh=`` (replica slices over ranks) and ``SRT_CONTROL_PLANE=1``
    raise ``NotImplementedError``: ROADMAP Queue 1 item 13.
    ``_run`` / ``_run_batched`` are test seams (default ``run_fused`` /
    ``run_fused_batched`` on ``device``)."""

    def __init__(self, tenants=None, n_workers: Optional[int] = None, *,
                 device=None, mesh=None, axis: Optional[str] = None,
                 max_queue: int = 128, batch_max: Optional[int] = None,
                 batch_window_ms: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 retry_backoff_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None,
                 name: str = "fleet", _run=None, _run_batched=None):
        if mesh is not None or axis is not None:
            raise NotImplementedError(
                "FleetScheduler(mesh=...): the scheduler's replica slices "
                "over ranks are not ported yet (ROADMAP Queue 1, item 13)")
        if env_bool("SRT_CONTROL_PLANE", False):
            raise NotImplementedError(
                "SRT_CONTROL_PLANE=1: the SLO control plane is not ported "
                "yet (ROADMAP Queue 1, item 13); unset it to serve "
                "without one")
        cfgs = list(tenants) if tenants else [DEFAULT_TENANT]
        if len({c.name for c in cfgs}) != len(cfgs):
            raise ValueError("duplicate tenant names")
        self.name = name
        self.device = resolve_device(device)
        self._max_queue = max_queue
        self._tenants = {c.name: _TenantState(c) for c in cfgs}
        self._default_tenant = cfgs[0].name
        from ..ops.fused_pipeline import (BATCH_CAPACITIES,
                                          max_batch_queries)
        if batch_max is None:
            batch_max = (max_batch_queries()
                         if env_str("SRT_BATCH_MAX", "") else 1)
        # clamp to the ladder: a window above the top rung never batches
        self._batch_max = max(1, min(int(batch_max), BATCH_CAPACITIES[-1]))
        # an explicit batch_window_ms (or SRT_BATCH_WINDOW_MS) pins a fixed
        # window; otherwise the arrival-rate EWMA sizes it per batch
        self._arrivals = None
        if batch_window_ms is None:
            envw = env_str("SRT_BATCH_WINDOW_MS", "").strip()
            if envw:
                self._batch_window_s = float(envw) / 1e3
            else:
                self._arrivals = _batcher.ArrivalEstimator()
                self._batch_window_s = 0.0
        else:
            self._batch_window_s = batch_window_ms / 1e3
        self._run = _run
        self._run_batched = _run_batched
        # the scheduler lock: one Condition guards the queue, worker and
        # retry bookkeeping below
        self._cv = threading.Condition()
        self._queued_total = 0  # guarded-by: self._cv
        self._vclock = 0.0  # guarded-by: self._cv
        self._closed = False  # guarded-by: self._cv
        self._policy = RetryPolicy.from_env(
            max_retries=max_retries, backoff_ms=retry_backoff_ms,
            deadline_ms=deadline_ms)
        self._running: "dict[int, list[_Item]]" = {}  # guarded-by: self._cv
        self._retry_timers: "dict[int, tuple]" = {}  # guarded-by: self._cv
        # live (started, not yet exited) worker threads: the last one
        # leaving a closed scheduler runs the end-of-lifetime cleanup
        self._live_workers = 0  # guarded-by: self._cv
        if n_workers is None:
            n_workers = default_workers(self.device)
        n_workers = max(1, n_workers)
        # recent shed times (monotonic): SHED_STORM_N of them inside
        # SHED_STORM_WINDOW_S is a storm. guarded-by: none -- a heuristic;
        # the bounded deque's append is atomic under the GIL
        self._shed_times: "deque[float]" = deque(maxlen=SHED_STORM_N)
        self._last_storm = float("-inf")  # guarded-by: none
        self._workers: "list[threading.Thread]" = []  # guarded-by: self._cv
        for i in range(n_workers):
            self._spawn_worker(i)
        # the scrape endpoint (started iff SRT_OBS_HTTP_PORT is set); the
        # /healthz source registers unconditionally, so a server started
        # later sees this fleet
        self._obs_server = _obs_server.maybe_start_from_env()
        _obs_server.add_health_source(self, self._health_snapshot)
        # drain and join the workers before interpreter teardown when the
        # caller never closed the scheduler
        atexit.register(self.close)

    def _health_snapshot(self) -> dict:
        """This scheduler's /healthz part: ok iff a worker is alive."""
        with self._cv:
            return {"ok": self._live_workers > 0 and not self._closed,
                    "name": self.name,
                    "workers_alive": self._live_workers,
                    "queue_depth": self._queued_total,
                    "closed": self._closed}

    # -- submission / admission -------------------------------------------

    def submit(self, plan, rels, *, tenant: Optional[str] = None,
               block: bool = True, timeout: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> PendingQuery:
        """Admit one query for ``tenant``. A result-cache hit resolves at
        once (no budget, no queue). Otherwise admission applies, in
        order: the tenant's own queue and in-flight bounds (block or
        shed; a tenant's own backlog never preempts others), then the
        global queue bound (preempt the newest queued item of a strictly
        lower-priority tenant, else block or shed the arrival).
        ``block=False`` turns every wait into an immediate
        :class:`QueryShed`. ``deadline_ms`` (default: the
        ``SRT_QUERY_DEADLINE_MS`` policy; 0 or less means none) stamps an
        absolute deadline, enforced at dequeue."""
        tname = tenant or self._default_tenant
        st = self._tenants.get(tname)
        if st is None:
            raise KeyError(f"unknown tenant {tname!r}; configured: "
                           f"{sorted(self._tenants)}")
        qname = getattr(plan, "__name__", "plan").lstrip("_")

        rtoken = None
        rcache = result_cache()
        if rcache is not None:
            from ..tpcds.rel import result_cache_token
            rtoken = result_cache_token(plan, rels, device=self.device)
            if rtoken is not None:
                hit = rcache.get(rtoken)
                if hit is not None:
                    pq = PendingQuery(qname, lambda: None)
                    pq._resolve(hit)
                    count("serving.completed")
                    count(f"serving.tenant.{tname}.completed")
                    count(f"serving.tenant.{tname}.cache_hits")
                    _slo.note(_slo.EVENT_SERVED, tname, st.cfg.priority)
                    self._emit_cache_hit_report(qname, pq.qid)
                    return pq

        bkey = None
        if self._batch_max > 1:
            bkey = _batcher.batch_key(plan, rels)
            if bkey is None:
                count("serving.batch.unbatchable")

        eff_deadline_ms = (deadline_ms if deadline_ms is not None
                           else self._policy.deadline_ms)
        if eff_deadline_ms is not None and eff_deadline_ms <= 0:
            eff_deadline_ms = None  # the knob's contract: <=0 = none

        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            while True:
                if self._closed:
                    raise RuntimeError(f"{self.name}: scheduler is closed")
                if (st.in_flight >= st.cfg.max_in_flight
                        or len(st.queue) >= st.cfg.max_queue):
                    why = "tenant budget exhausted"
                elif self._queued_total >= self._max_queue:
                    victim = self._shed_victim_locked(st.cfg.priority)
                    if victim is not None:
                        self._shed_locked(
                            victim, reason=f"preempted by higher-priority "
                                           f"tenant {tname!r}")
                        continue  # re-check: one slot just freed
                    why = "scheduler saturated"
                else:
                    break  # admitted
                if not block:
                    self._count_shed(st)
                    raise QueryShed(tname, why)
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self._count_shed(st)
                    raise QueryShed(tname, f"{why} (timed out)")
                self._cv.wait(remaining)
            pq = PendingQuery(qname, lambda s=st: self._release_in_flight(s))
            st.in_flight += 1
            if not st.queue:
                # an idle tenant rejoins at the current virtual clock, not
                # at its stale past vtime (which would let it burst-starve
                # active peers)
                st.vtime = max(st.vtime, self._vclock)
            item = _Item(pq, plan, rels, st, bkey, rtoken, sched=self,
                         deadline=(None if eff_deadline_ms is None
                                   else time.monotonic()
                                   + eff_deadline_ms / 1e3))
            if self._arrivals is not None:
                self._arrivals.observe()
            st.queue.append(item)
            self._queued_total += 1
            count("serving.submitted")
            count(f"serving.tenant.{tname}.submitted")
            _flight.note("query_admitted", qid=pq.qid, query=qname,
                         tenant=tname, scheduler=self.name)
            self._publish_gauges_locked(st)
            self._cv.notify_all()
        return pq

    def run(self, requests, tenant: Optional[str] = None) -> list:
        """Submit every ``(plan, rels)`` pair and return the results in
        submission order, collecting as it goes so a batch larger than
        the tenant's budget completes."""
        st = self._tenants[tenant or self._default_tenant]
        pending: "deque[PendingQuery]" = deque()
        results = []
        for plan, rels in requests:
            while len(pending) >= st.cfg.max_in_flight:
                results.append(pending.popleft().result())
            pending.append(self.submit(plan, rels, tenant=tenant))
        while pending:
            results.append(pending.popleft().result())
        return results

    def _release_in_flight(self, st: _TenantState) -> None:
        with self._cv:
            st.in_flight -= 1
            self._publish_gauges_locked(st)
            self._cv.notify_all()

    def _count_shed(self, st: _TenantState) -> None:
        count("serving.shed")
        count(f"serving.tenant.{st.cfg.name}.shed")
        _slo.note(_slo.EVENT_SHED, st.cfg.name, st.cfg.priority)
        # storm detection: a full deque whose oldest entry is inside the
        # window is the storm; noted and dumped at most once a window
        now = time.monotonic()
        self._shed_times.append(now)
        if (len(self._shed_times) == SHED_STORM_N
                and now - self._shed_times[0] <= SHED_STORM_WINDOW_S
                and now - self._last_storm >= SHED_STORM_WINDOW_S):
            self._last_storm = now
            _flight.note("shed_storm", scheduler=self.name,
                         sheds=SHED_STORM_N,
                         window_s=round(now - self._shed_times[0], 3),
                         tenant=st.cfg.name, priority=st.cfg.priority)
            try:
                # the dump does file I/O: off the scheduler's lock
                threading.Thread(target=_flight.dump, args=("shed_storm",),
                                 name=f"{self.name}-flight-dump",
                                 daemon=True).start()
            except RuntimeError:
                count("obs.flight_dump_errors")

    def _shed_victim_locked(self, incoming_priority: int
                            ) -> Optional[_TenantState]:
        """The lowest-priority tenant with queued work, iff strictly below
        the arrival's class: equal-priority traffic sheds the arrival."""
        backlogged = [s for s in self._tenants.values() if s.queue]
        if not backlogged:
            return None
        victim = min(backlogged,
                     key=lambda s: (s.cfg.priority, -len(s.queue)))
        return victim if victim.cfg.priority < incoming_priority else None

    def _shed_locked(self, st: _TenantState, reason: str) -> None:
        """Preempt the newest queued item (the oldest is closest to its
        deadline); its handle resolves with QueryShed."""
        item = st.queue.pop()
        self._queued_total -= 1
        item.pq._reject(QueryShed(st.cfg.name, reason))
        self._count_shed(st)
        self._publish_gauges_locked(st)

    def _publish_gauges_locked(self, st: _TenantState) -> None:
        tname = st.cfg.name
        gauge(f"serving.tenant.{tname}.queue_depth").set(len(st.queue))
        gauge(f"serving.tenant.{tname}.in_flight").set(st.in_flight)
        gauge("serving.sched.queue_depth").set(self._queued_total)

    def _emit_cache_hit_report(self, qname: str, qid: str = "") -> None:
        if not metrics_enabled():
            return
        _obs_report.emit(_obs_report.ExecutionReport(
            query=qname, fused=True, cache_hit=True,
            provenance=_obs_report.PROVENANCE_RESULT_CACHE, dispatches=0,
            host_syncs=0, wall_ns=0, qid=qid))

    # -- the worker side ---------------------------------------------------

    def _expired(self, item: _Item) -> bool:
        return (item.deadline is not None
                and time.monotonic() > item.deadline)

    def _expire_locked(self, item: _Item) -> None:
        """Shed one queued query whose deadline passed, before it burns a
        dispatch: counted in the shed family (an expiry is a load shed,
        not a failure) and delivered as :class:`QueryExpired`."""
        st = item.tenant
        late = (time.monotonic() - item.deadline
                if item.deadline is not None else 0.0)
        count("serving.fault.expired")
        count(f"serving.tenant.{st.cfg.name}.expired")
        _slo.note(_slo.EVENT_EXPIRED, st.cfg.name, st.cfg.priority)
        self._count_shed(st)
        item.pq._reject(QueryExpired(st.cfg.name, item.pq.query, late))
        self._publish_gauges_locked(st)

    def _charge_locked(self, st: _TenantState, item: _Item) -> _Item:
        """Charge ``st`` one dispatch of virtual time and stamp the
        dequeue."""
        self._vclock = max(self._vclock, st.vtime)
        st.vtime += 1.0 / max(st.cfg.weight, 1e-9)
        self._publish_gauges_locked(st)
        self._cv.notify_all()  # queue space freed: wake submitters
        item.dequeue_ns = time.perf_counter_ns()
        return item

    def _pick_locked(self) -> Optional[_Item]:
        """Strict priority, then weighted-fair: among the backlogged
        tenants of the highest class present, the one with the least
        virtual time. Expired items shed here, at dequeue, without
        charging virtual time."""
        while True:
            backlogged = [s for s in self._tenants.values() if s.queue]
            if not backlogged:
                return None
            top = max(s.cfg.priority for s in backlogged)
            st = min((s for s in backlogged if s.cfg.priority == top),
                     key=lambda s: s.vtime)
            item = st.queue.popleft()
            self._queued_total -= 1
            if self._expired(item):
                self._expire_locked(item)
                self._cv.notify_all()
                continue
            return self._charge_locked(st, item)

    def _pop_matching_locked(self, bkey) -> Optional[_Item]:
        """One more same-key item for an open batch window, from any
        queue (batching crosses tenants; the pulled tenant is still
        charged its virtual time). Expired items met on the way shed."""
        for st in sorted((s for s in self._tenants.values() if s.queue),
                         key=lambda s: (-s.cfg.priority, s.vtime)):
            i = 0
            while i < len(st.queue):
                it = st.queue[i]
                if it.bkey != bkey:
                    i += 1
                    continue
                del st.queue[i]
                self._queued_total -= 1
                if self._expired(it):
                    self._expire_locked(it)
                    self._cv.notify_all()
                    continue  # same index: the deque shifted left
                count(f"serving.tenant.{st.cfg.name}.batched")
                return self._charge_locked(st, it)
        return None

    def _window_s(self) -> float:
        """The coalescing window: fixed, or the arrival-rate estimate
        (zero when traffic is too sparse for peers to arrive)."""
        if self._arrivals is not None:
            return self._arrivals.window_s(self._batch_max)
        return self._batch_window_s

    def _next_batch(self) -> "Optional[list[_Item]]":
        """Block for the next work: one item or, when it is batchable, up
        to ``batch_max`` compatible items within the window. None =
        closed and drained. Already-queued compatible items drain into
        the batch whatever the window; the window only bounds the wait
        for items not yet arrived."""
        with self._cv:
            while True:
                item = self._pick_locked()
                if item is not None:
                    break
                if self._closed:
                    return None
                self._cv.wait()
            if item.bkey is None or self._batch_max <= 1:
                return [item]
            window = _batcher.BatchWindow(item, self._batch_max,
                                          self._window_s())
            while len(window.items) < window.capacity:
                more = self._pop_matching_locked(window.key)
                if more is not None:
                    window.add(more)
                    continue
                if self._closed or not window.wants_more():
                    break  # closed: drain fast; else the window expired
                self._cv.wait(window.remaining())
            window.observe_fill()
            return window.items

    def _spawn_worker(self, widx: int) -> None:
        """Start (or, after a crash, restart) worker ``widx``. The thread
        list only grows, so ``close(wait=True)`` joins a respawn too."""
        t = threading.Thread(target=self._worker_main, args=(widx,),
                             name=f"{self.name}-worker-{widx}",
                             daemon=True)
        with self._cv:
            self._workers.append(t)
            self._live_workers += 1
        try:
            t.start()
        except BaseException:
            # a thread that never started must leave the list, or
            # close(wait=True) would wait on it forever
            with self._cv:
                self._workers.remove(t)
                self._live_workers -= 1
            raise

    def _worker_main(self, widx: int) -> None:
        """Supervision: a worker loop that dies (an injected
        ``WorkerCrash``, or any escape; per-query errors stay inside
        ``execute_batch``) has its in-flight queries requeued or
        quarantined and a replacement spawned."""
        try:
            if self.device.type == "cuda" and self.device.index is not None:
                torch.cuda.set_device(self.device)
            self._worker_loop(widx)
        except Exception:
            self._supervise_crash(widx)
        finally:
            self._note_worker_exit()

    def _note_worker_exit(self) -> None:
        """The drain is complete when the last live worker leaves a
        closed scheduler with no backoff pending: then the end-of-life
        cleanup runs."""
        with self._cv:
            self._live_workers -= 1
            drained = (self._closed and self._live_workers == 0
                       and not self._retry_timers)
        if drained:
            self._drain_complete()

    def _drain_complete(self) -> None:
        """End-of-lifetime cleanup once no worker remains in a closed
        scheduler: fail every still-queued handle (nothing will dequeue
        it; a :class:`QueryShed`, since the fleet lost its capacity),
        release this scheduler's scratch-budget hold, leave /healthz and
        drop the atexit hook. Idempotent."""
        stranded = []
        with self._cv:
            for st in self._tenants.values():
                while st.queue:
                    stranded.append(st.queue.popleft())
                    self._queued_total -= 1
                self._publish_gauges_locked(st)
        for it in stranded:
            st = it.tenant
            count("serving.fault.unserviceable")
            self._count_shed(st)
            it.pq._reject(QueryShed(
                st.cfg.name, "scheduler closed with no live workers"))
        from ..parallel import comm_plan as _comm
        _comm.release_scratch_override(self)
        _obs_server.remove_health_source(self)
        try:
            atexit.unregister(self.close)
        except Exception:  # interpreter finalizing: the registry may be gone
            pass

    def _supervise_crash(self, widx: int) -> None:
        count("serving.fault.worker_crashes")
        quarantined = []
        with self._cv:
            batch = self._running.pop(widx, None) or []
            _flight.note("worker_crash", scheduler=self.name, worker=widx,
                         in_flight=len(batch),
                         qids=[it.pq.qid for it in batch])
            for it in batch:
                if it.pq.done():
                    continue  # resolved before the crash landed
                it.crashes += 1
                if it.crashes >= _reliability.QUARANTINE_CRASHES:
                    # in flight for both deaths: fails fast, never again
                    # requeued, so one bad query cannot crash-loop the fleet
                    tname = it.tenant.cfg.name
                    count("serving.fault.quarantined")
                    count(f"serving.tenant.{tname}.quarantined")
                    _slo.note(_slo.EVENT_POISONED, tname,
                              it.tenant.cfg.priority)
                    quarantined.append(it)
                    it.fail(QueryPoisoned(tname, it.pq.query, it.crashes))
                else:
                    # requeue at the front: it waited its turn once, and a
                    # re-run is exact (the same plan over the same rels)
                    count("serving.fault.requeued")
                    _flight.note("query_requeued", qid=it.pq.qid,
                                 query=it.pq.query, scheduler=self.name,
                                 worker=widx, crashes=it.crashes)
                    self._requeue_locked(it)
            self._cv.notify_all()
        for it in quarantined:
            _flight.note("quarantine", scheduler=self.name, qid=it.pq.qid,
                         query=it.pq.query, tenant=it.tenant.cfg.name,
                         crashes=it.crashes)
        if quarantined:
            _flight.dump("quarantine")
        try:
            # chaos seam: an injected raise refuses the replacement (with
            # one worker, the all-workers-dead state /healthz shows)
            _faults.maybe_inject(_faults.SEAM_RESPAWN)
            self._spawn_worker(widx)
            count("serving.fault.worker_restarts")
        except Exception:
            count("serving.fault.respawn_errors")
            _flight.note("respawn_refused", scheduler=self.name,
                         worker=widx)
        _flight.dump("worker_crash")

    # -- retry / backoff ---------------------------------------------------

    def _maybe_retry(self, item: _Item, exc: BaseException) -> bool:
        """Route one failure through the retry matrix: True = requeued
        (after backoff), the caller must not deliver the error; False =
        terminal."""
        action = _reliability.retry_action(exc)
        if action is None:
            return False
        if item.attempts >= self._policy.max_retries:
            count("serving.fault.retry_exhausted")
            return False
        item.attempts += 1
        tname = item.tenant.cfg.name
        count("serving.fault.retries")
        count(f"serving.tenant.{tname}.retries")
        _flight.note("query_retry", qid=item.pq.qid, query=item.pq.query,
                     scheduler=self.name, tenant=tname,
                     attempt=item.attempts)
        if action == _reliability.ACTION_RETRY_OOM:
            count("serving.fault.oom.retry")
            _reliability.free_for_retry(self.device)
        elif action == _reliability.ACTION_SPLIT:
            # a per-query SplitAndRetryOOM (the batcher halves batched
            # windows before the error reaches here): shrink the other
            # capacity tier, the exchange scratch budget, one notch
            count("serving.fault.oom.split_query")
            from ..parallel import comm_plan as _comm
            if _comm.shrink_scratch_budget(holder=self) is not None:
                count("serving.fault.oom.scratch_shrunk")
        self._requeue_later(item, self._policy.backoff_s(item.attempts))
        return True

    def _requeue_locked(self, item: _Item) -> None:
        """Back to the front of its tenant's queue, past the admission
        bounds: it was admitted once and still holds its slot."""
        st = item.tenant
        if not st.queue:
            st.vtime = max(st.vtime, self._vclock)
        st.queue.appendleft(item)
        self._queued_total += 1
        self._publish_gauges_locked(st)

    def _requeue_later(self, item: _Item, delay_s: float) -> None:
        """Requeue after the backoff (a timer: workers stay free). During
        shutdown the backoff collapses to zero, so ``close(wait=True)``
        drains every retried handle."""
        with self._cv:
            if delay_s <= 0 or self._closed:
                self._requeue_locked(item)
                self._cv.notify_all()
                return
            timer = threading.Timer(delay_s, self._fire_retry, args=(item,))
            timer.daemon = True
            self._retry_timers[id(item)] = (timer, item)
        timer.start()

    def _fire_retry(self, item: _Item) -> None:
        with self._cv:
            if self._retry_timers.pop(id(item), None) is None:
                return  # close() beat the timer and already requeued
            self._requeue_locked(item)
            self._cv.notify_all()

    def _worker_loop(self, widx: int = 0) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            # register the in-flight batch first: if this worker dies past
            # here, supervision knows which queries to requeue
            with self._cv:
                self._running[widx] = batch
            # chaos seam: an injected WorkerCrash escapes this loop
            _faults.maybe_inject(_faults.SEAM_WORKER)
            t0 = time.perf_counter_ns()
            for it in batch:
                histogram("serving.queue_wait_ns").observe(
                    t0 - it.pq.submit_ns)
                it.dispatch_ns = t0
                tname = it.tenant.cfg.name
                prio = it.tenant.cfg.priority
                dq = it.dequeue_ns if it.dequeue_ns is not None else t0
                _slo.record(_slo.KIND_QUEUE_WAIT, tname, prio,
                            dq - it.pq.submit_ns)
                _slo.record(_slo.KIND_BATCH_WAIT, tname, prio, t0 - dq)
            _flight.note("query_dispatch", scheduler=self.name,
                         worker=widx, qids=[it.pq.qid for it in batch])
            _batcher.execute_batch(batch, run_batched=self._run_batched,
                                   run_single=self._run,
                                   device=self.device)
            with self._cv:
                self._running.pop(widx, None)
            # drop references before blocking again, so an abandoned
            # handle's finalizer can release its slot while idle
            del batch, it

    # -- lifecycle ---------------------------------------------------------

    def close(self, wait: bool = True) -> None:
        """Stop admitting; the workers drain every queued item (each
        handle resolves with its result or its error) and exit; ``wait``
        joins them. Pending backoffs collapse to immediate requeues, and
        workers respawned during the drain are joined too."""
        # a deliberately closed fleet is not an incident: leave /healthz
        # before the drain
        _obs_server.remove_health_source(self)
        with self._cv:
            self._closed = True
            for key, (timer, item) in list(self._retry_timers.items()):
                timer.cancel()
                del self._retry_timers[key]
                self._requeue_locked(item)
            self._cv.notify_all()
            already_drained = self._live_workers == 0
        if already_drained:
            # every worker is gone (crashed, respawn refused): no exit hook
            # will fire the cleanup, so fail the stranded handles here
            self._drain_complete()
        if not wait:
            return
        while True:
            with self._cv:
                snapshot = list(self._workers)
            unstarted = False
            for w in snapshot:
                if w is threading.current_thread():
                    raise RuntimeError(f"{self.name}: close(wait=True) "
                                       f"called from worker thread {w.name}")
                try:
                    w.join()
                except RuntimeError:
                    # a respawn appended before its start(): go around again
                    unstarted = True
            if unstarted:
                time.sleep(0.001)
            with self._cv:
                # a crash during the drain may have respawned a worker
                # after the snapshot: re-join until the list is stable
                if (not unstarted and len(self._workers) == len(snapshot)
                        and not self._retry_timers):
                    break
        # the backstop for a worker that died without its exit hook
        self._drain_complete()

    def __enter__(self) -> "FleetScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close(wait=True)
