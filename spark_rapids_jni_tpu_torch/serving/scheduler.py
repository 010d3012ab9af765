"""Fleet scheduler: multi-tenant serving over N workers.

Port of ``spark_rapids_jni_tpu/serving/scheduler.py``. ``QueryExecutor``
is one FIFO worker; this grows it into a scheduler with the reference's
disciplines:

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

- **Control plane** (``serving/control_plane.py``, with
  ``SRT_CONTROL_PLANE=1``): predictive shedding at admission
  (``serving.shed.predicted``), batch rung and window tuning in
  ``_next_batch``, memory-pressure degradation (scratch shrink and batch
  halving, ``serving.control.mem.*``) at submit and between batches,
  and worker autoscaling against the queue-wait SLO, held during crash
  cooldowns. Every loop falls back to the static policy on cold windows
  or faulted telemetry (the ``control`` fault seam).

- **Replica slices** (``mesh=``, one process a rank). A mesh splits into
  ``parallel.replica_submeshes``; each rank runs one worker, on the
  slice that holds it, and every query runs partitioned over one slice.
  Every rank runs the same program: the same ``submit`` and result
  collections in the same order. Whatever gates a collective is agreed,
  never read from one rank's timing:

  - admission (the bounds, the predicted shed, the slice a query is
    assigned to, autoscaling over the slices in service) is decided by
    the mesh's first rank and broadcast over a gloo group the callers
    alone use;
  - inside a slice its first rank picks what runs next (priority and
    weighted fair order, deadline expiry) and the memory loop's action,
    and broadcasts them to the slice's other ranks over the slice's gloo
    group, on the worker thread, before the run;
  - every attempt's outcome is agreed by a delivery thread on each rank,
    in admission order, with one ``all_gather_object`` over a third gloo
    group: a failure on any rank of the serving slice fails the attempt
    everywhere; a retryable one moves the query to the next slice on
    every rank alike; a result reaches the ranks outside the serving
    slice as the slice leader's frame (``DeliveredResult``).

  Batching does not apply on a mesh (a mesh submission has no batch
  key), nor does the result cache (one rank's hit would skip the
  collectives of the others).

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
from . import control_plane as _control_plane
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
    __slots__ = ("cfg", "queue", "vtime", "in_flight", "remote")

    def __init__(self, cfg: TenantConfig):
        self.cfg = cfg
        self.queue: "deque[_Item]" = deque()
        self.vtime = 0.0  # weighted-fair virtual finish time
        self.in_flight = 0
        # on a mesh: admitted items another slice serves, not yet
        # delivered (they count against the queue bounds)
        self.remote = 0


class DeliveredResult:
    """A query's result on a rank outside the slice that served it: the
    serving slice leader's frame. ``to_df()`` returns a copy, as a
    result ``Rel``'s does."""

    __slots__ = ("frame",)

    def __init__(self, frame):
        self.frame = frame

    def to_df(self):
        return self.frame.copy()


class RemoteQueryError(RuntimeError):
    """A query's terminal error as a rank outside the serving slice sees
    it: the error's type name and message (exceptions are not shipped
    between ranks)."""

    def __init__(self, type_name: str, message: str):
        super().__init__(f"{type_name}: {message}")
        self.type_name = type_name


class SliceFailed(RuntimeError):
    """An attempt lost because this rank's replica slice went out of
    service: an agreement that raised (a collective past the group's
    timeout) or a run that escaped its worker. Retryable: delivery
    agrees it on every rank and moves the query to the next slice."""

    retryable = True


class _Item:
    """One queued submission: the handle and what a worker needs to
    execute, batch, retry and account it. ``attempts`` counts retries of
    transient failures, ``crashes`` the worker deaths it was in flight
    for, ``deadline`` the monotonic cutoff enforced at dequeue."""

    __slots__ = ("pq", "plan", "rels", "mesh", "axis", "tenant", "bkey",
                 "rtoken", "sched", "attempts", "crashes", "deadline",
                 "dequeue_ns", "dispatch_ns", "seq", "slice", "outcome",
                 "outcome_ev")

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
        # on a mesh: the admission sequence number, the slice serving the
        # current attempt, and this rank's outcome of it (the delivery
        # thread agrees it across ranks before the handle resolves)
        self.seq = None
        self.slice = None
        self.outcome = None
        self.outcome_ev = None

    def _record(self, kind: str, value) -> bool:
        """On a mesh, hold this rank's outcome of the attempt for the
        delivery thread instead of resolving; False off a mesh."""
        if self.outcome_ev is None:
            return False
        self.outcome = (kind, value)
        self.outcome_ev.set()
        return True

    # the batcher's resolution hooks: per-tenant accounting and the
    # result-cache fill, the same on the batched and per-query routes
    def resolve(self, out) -> None:
        if self._record("ok", out):
            return
        self.finish(out)

    def finish(self, out) -> None:
        """Resolve the handle with ``out`` and account it."""
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
        if self._record("err", exc):
            return
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

# _next_batch's verdict for a worker the autoscaler retires: the worker
# returns cleanly (supervision respawns only crashed workers)
_RETIRE = object()


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

    With ``mesh=`` (every rank constructs its own scheduler over the
    same mesh) each rank serves on its replica slice
    (``parallel.replica_submeshes``; a mesh without a replica axis is one
    slice), with one worker; ``n_workers`` is ignored. ``_run`` /
    ``_run_batched`` are test seams (default ``run_fused`` /
    ``run_fused_batched`` on ``device``)."""

    def __init__(self, tenants=None, n_workers: Optional[int] = None, *,
                 device=None, mesh=None, axis: Optional[str] = None,
                 max_queue: int = 128, batch_max: Optional[int] = None,
                 batch_window_ms: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 retry_backoff_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None,
                 name: str = "fleet", _run=None, _run_batched=None):
        cfgs = list(tenants) if tenants else [DEFAULT_TENANT]
        if len({c.name for c in cfgs}) != len(cfgs):
            raise ValueError("duplicate tenant names")
        self.name = name
        self._mesh = mesh
        self._axis = axis
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
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
        if mesh is not None:
            n_workers = 1  # one worker a rank, on its replica slice
        elif n_workers is None:
            n_workers = default_workers(self.device)
        n_workers = max(1, n_workers)
        # recent shed times (monotonic): SHED_STORM_N of them inside
        # SHED_STORM_WINDOW_S is a storm. guarded-by: none -- a heuristic;
        # the bounded deque's append is atomic under the GIL
        self._shed_times: "deque[float]" = deque(maxlen=SHED_STORM_N)
        self._last_storm = float("-inf")  # guarded-by: none
        # the control plane (None unless SRT_CONTROL_PLANE is on) and the
        # autoscaler's state, kept even when it is off so the worker loop
        # stays simple
        self._slices = None
        if mesh is not None:
            from ..parallel import replica_submeshes
            self._slices = replica_submeshes(mesh)
        self._control = _control_plane.maybe_control_plane(
            name=name, n_workers=(len(self._slices) if self._slices
                                  else n_workers))
        self._target_workers: Optional[int] = (  # guarded-by: self._cv
            n_workers if self._control is not None and mesh is None
            else None)
        self._retiring = 0  # guarded-by: self._cv
        self._next_widx = n_workers  # guarded-by: self._cv
        self._last_crash = float("-inf")  # guarded-by: self._cv
        self._workers: "list[threading.Thread]" = []  # guarded-by: self._cv
        self._fleet: "Optional[_MeshFleet]" = None
        if mesh is not None:
            self._fleet = _MeshFleet(self, mesh, self._slices)
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
        absolute deadline, enforced at dequeue and, with the control
        plane, predicted at admission."""
        tname = tenant or self._default_tenant
        st = self._tenants.get(tname)
        if st is None:
            raise KeyError(f"unknown tenant {tname!r}; configured: "
                           f"{sorted(self._tenants)}")
        qname = getattr(plan, "__name__", "plan").lstrip("_")

        rtoken = None
        rcache = result_cache() if self._fleet is None else None
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
            bkey = _batcher.batch_key(plan, rels, self._mesh, self._axis)
            if bkey is None:
                count("serving.batch.unbatchable")

        eff_deadline_ms = (deadline_ms if deadline_ms is not None
                           else self._policy.deadline_ms)
        if eff_deadline_ms is not None and eff_deadline_ms <= 0:
            eff_deadline_ms = None  # the knob's contract: <=0 = none

        # the memory admission model (SRT_CONTROL_MEM_ADMIT): the ingest
        # walk is computed once, outside the lock; the live headroom is
        # read again on every admission retry
        modeled_bytes = None
        if self._control is not None and env_bool("SRT_CONTROL_MEM_ADMIT",
                                                  False):
            from ..obs import memory as _obs_memory
            modeled_bytes = _obs_memory.rel_ingest_bytes(rels)

        if self._fleet is not None:
            return self._fleet.submit(plan, rels, st, qname,
                                      eff_deadline_ms, modeled_bytes,
                                      block, timeout)

        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            while True:
                if self._closed:
                    raise RuntimeError(f"{self.name}: scheduler is closed")
                self._control_admission_locked(st, eff_deadline_ms,
                                               modeled_bytes)
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
        if self._control is not None:
            # loops 3 and 4 ride submission traffic (each rate-limited):
            # pressure is checked while load arrives, and the autoscaler
            # sees a backlog the moment it forms
            self._control.check_memory(self, self._batch_max)
            self._maybe_autoscale()
        return pq

    def _control_admission_locked(self, st: _TenantState,
                                  eff_deadline_ms: Optional[float],
                                  modeled_bytes: Optional[int],
                                  workers: Optional[int] = None) -> None:
        """The control plane's admission verdicts, re-evaluated on every
        admission retry (a parked submitter can become doomed while it
        waits): the predicted shed (loop 1) for a query with a deadline,
        then the memory admission model; raises ``QueryShed``. The queue
        ahead counts only the submitter's class and above (strict
        priority dispatch): a low class's backlog never predicts a high
        class into a shed."""
        if self._control is None:
            return
        tname = st.cfg.name
        if eff_deadline_ms is not None:
            depth_ahead = sum(
                len(s.queue) + s.remote for s in self._tenants.values()
                if s.cfg.priority >= st.cfg.priority)
            if workers is None:
                workers = self._live_workers
            pred = self._control.shed_verdict(
                tname, st.cfg.priority, eff_deadline_ms / 1e3,
                depth_ahead, max(1, workers))
            if pred is not None:
                raise self._predicted_shed(st, pred, eff_deadline_ms)
        if modeled_bytes is not None:
            mver = self._control.memory_verdict(modeled_bytes)
            if mver is not None:
                raise self._memory_shed(st, *mver)

    def _predicted_shed(self, st: _TenantState, pred: int,
                        eff_deadline_ms: float) -> "QueryShed":
        tname = st.cfg.name
        count("serving.shed.predicted")
        count(f"serving.tenant.{tname}.shed_predicted")
        self._count_shed(st)
        return QueryShed(
            tname, f"serving.shed.predicted: predicted {pred / 1e6:.0f} ms "
                   f"(queue + execute) exceeds the {eff_deadline_ms:.0f} ms "
                   f"deadline at admission")

    def _memory_shed(self, st: _TenantState, modeled: int,
                     headroom: int) -> "QueryShed":
        tname = st.cfg.name
        count("serving.shed.memory_predicted")
        count(f"serving.tenant.{tname}.shed_memory")
        self._count_shed(st)
        return QueryShed(
            tname, f"serving.shed.memory_predicted: modeled {modeled} B "
                   f"exceeds the live device headroom {headroom} B at "
                   f"admission; run out-of-core (morsels) instead")

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
            # the triggering tenant's live-window quantiles: what the
            # control plane was acting on
            quantiles = {
                kind: q for kind in _slo.KINDS
                if (q := _slo.TRACKER.latency_stats(
                    kind, st.cfg.name, st.cfg.priority)) is not None}
            _flight.note("shed_storm", scheduler=self.name,
                         sheds=SHED_STORM_N,
                         window_s=round(now - self._shed_times[0], 3),
                         tenant=st.cfg.name, priority=st.cfg.priority,
                         window_quantiles=quantiles)
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

    def _pick_locked(self, expired: "Optional[list]" = None
                     ) -> Optional[_Item]:
        """Strict priority, then weighted-fair: among the backlogged
        tenants of the highest class present, the one with the least
        virtual time. Expired items shed here, at dequeue, without
        charging virtual time (on a mesh they go to ``expired`` instead:
        the slice leader's expiry is delivered like an outcome)."""
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
                if expired is not None:
                    expired.append(item)
                else:
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
                if (self._target_workers is not None
                        and self._live_workers - self._retiring
                        > self._target_workers):
                    # autoscale shrink: an idle worker above the target
                    # retires, never one with work in hand; the retiring
                    # count keeps two idle workers from both leaving
                    self._retiring += 1
                    threading.current_thread()._srt_retiring = True
                    return _RETIRE
                self._cv.wait()
            if item.bkey is None or self._batch_max <= 1:
                return [item]
            cap, win = self._batch_max, self._window_s()
            if self._control is not None:
                # loop 2: the rung and window from the arrival EWMA and
                # the execute quantiles (static values on no signal)
                cap, win = self._control.tune_batch(
                    item.tenant.cfg.name, item.tenant.cfg.priority, cap, win,
                    self._arrivals.gap_s() if self._arrivals else None,
                    (self._arrivals.max_window_s if self._arrivals
                     else max(win, 0.0)))
                if cap <= 1:
                    return [item]
            window = _batcher.BatchWindow(item, cap, win)
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
        t = threading.current_thread()
        with self._cv:
            self._live_workers -= 1
            if getattr(t, "_srt_retiring", False):
                # this exit is the retirement _next_batch promised
                self._retiring -= 1
                t._srt_retiring = False
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
            # the autoscaler holds off within the crash cooldown
            self._last_crash = time.monotonic()
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

    # -- worker autoscaling (control plane loop 4) -------------------------

    def _maybe_autoscale(self) -> None:
        """Apply the control plane's scaling verdict: grow by spawning a
        worker at a fresh index (crash respawns keep their own), shrink
        by lowering the target and waking an idle worker to retire
        through ``_next_batch``. On a mesh the verdict is the fleet
        leader's and sizes the slices in service instead
        (``_MeshFleet``)."""
        c = self._control
        if c is None or self._fleet is not None:
            return
        with self._cv:
            if self._closed:
                return
            live = self._live_workers - self._retiring
            queued = self._queued_total
            last_crash = self._last_crash
        want = c.desired_workers(live, queued, last_crash)
        if want is None or want == live:
            return
        if want > live:
            with self._cv:
                widx = self._next_widx
                self._next_widx += 1
                self._target_workers = want
            try:
                self._spawn_worker(widx)
            except BaseException:
                # thread creation refused: the fleet keeps its size
                count("serving.control.scale.errors")
                return
            count("serving.control.scale.up")
            gauge("serving.control.scale.target").set(want)
            _flight.note("scale_up", scheduler=self.name, workers=want)
        else:
            with self._cv:
                self._target_workers = want
                self._cv.notify_all()  # wake an idle worker to retire
            count("serving.control.scale.down")
            gauge("serving.control.scale.target").set(want)
            _flight.note("scale_down", scheduler=self.name, workers=want)

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
        if self._fleet is not None:
            self._fleet.worker_loop(widx)
            return
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            if batch is _RETIRE:
                # autoscale shrink: a clean exit is a retirement
                count("serving.control.scale.retired")
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
            if self._control is not None:
                # loops 3 and 4 also run between batches (rate-limited):
                # a drained, pressured fleet restores, an idle one retires
                # its excess workers
                self._control.check_memory(self, self._batch_max)
                self._maybe_autoscale()
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
        if self._fleet is not None:
            self._fleet.delivery.join()
        # the backstop for a worker that died without its exit hook
        self._drain_complete()

    def __enter__(self) -> "FleetScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close(wait=True)


class _MeshFleet:
    """The replica-slice half of a ``FleetScheduler`` on one rank (see
    the module docstring). Three gloo groups over the mesh's ranks carry
    the agreements, one a thread, so no two threads ever share a group:
    ``admit`` (the callers: the fleet leader's admission verdict a
    submission), ``slice`` (the slice workers: the slice leader's pick),
    ``deliver`` (the delivery threads: one all-gather of outcomes an
    attempt, in admission order).

    Why it cannot hang, given the same program on every rank (every
    ``submit`` and result collection in the same order): the fleet
    leader's verdict for submission ``k`` waits only for earlier
    admitted queries to be served; a slice follower waits for an item
    its leader picked, which its own caller submits (the leader's caller
    got past every collection before that submission, so this rank's
    does too) or its delivery thread requeues (delivery is collective,
    so it reaches every rank); the delivery thread waits for the oldest
    undelivered query, which its slice's leader can always pick next,
    since that query's slice holds nothing older; and a slice leader
    stops only when the scheduler is closed and every admitted query is
    delivered, so a retry moved onto its slice is still served.

    No rank idles inside a collective past its group's timeout: a leader
    with nothing to say within ``idle_s`` (a quarter of the timeout, at
    most a second) broadcasts a no-op (the fleet leader a ``wait``
    verdict, a slice leader an empty pick), and delivery gathers in
    rounds of ``idle_s``, a serving rank posting ``wait`` until its
    outcome is in. A failure past a pick (an agreement that raised, a
    worker that escaped) takes this rank's slice out of service
    (``_break``): the held item and every item queued on the slice here
    record a ``SliceFailed`` outcome, as does every later placement
    there, so delivery agrees an error and retries it on the next slice.
    A delivery that raises fails every undelivered handle on its rank."""

    def __init__(self, sched: "FleetScheduler", mesh, slices):
        import torch.distributed as dist

        self.sched = sched
        self.slices = slices
        self.rank = dist.get_rank()
        self.ranks = [int(r) for r in mesh.ranks.reshape(-1)]
        if self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} is not on the mesh {mesh}")
        # every rank creates every group, in the same order
        self.admit = _control_plane.RankAgreement(mesh)
        self.leader = self.admit.leader
        self.deliver_group = _control_plane.new_gloo_group(self.ranks)
        # every rank plans under the first rank's tuned table
        from ..tune.store import agree_active_table
        agree_active_table(self.admit.group)
        agrees = [_control_plane.RankAgreement(sl) if sl.ranks.size > 1
                  else None for sl in slices]
        self.my_slice = next(i for i, sl in enumerate(slices)
                             if self.rank in sl.ranks.reshape(-1).tolist())
        self.slice_mesh = slices[self.my_slice]
        self.slice_agree = agrees[self.my_slice]
        self.slice_leader = (self.slice_agree is None
                             or self.slice_agree.leader)
        # the rank a slice's frames come from (ranks outside it need them)
        self.slice_srcs = [int(sl.ranks.reshape(-1)[0]) for sl in slices]
        self.need_frame = len(slices) > 1
        self.seq = 0  # the callers' submission counter (one caller thread)
        self.rr = 0  # the fleet leader's round robin over the slices
        self.active = len(slices)  # slices in service (autoscaling)
        # admitted, undelivered items in admission order
        self.pending: "deque[_Item]" = deque()  # guarded-by: sched._cv
        self.local: "dict[int, _Item]" = {}  # guarded-by: sched._cv
        self.pending_shrink = False  # guarded-by: sched._cv
        # this rank's slice out of service, or the delivery failed: the
        # error later attempts record (guarded-by: sched._cv)
        self.broken: Optional[SliceFailed] = None
        self.failed: Optional[SliceFailed] = None
        self.held: Optional[_Item] = None  # picked, not yet running
        from ..parallel.distributed import group_timeout
        timeout = group_timeout()
        self.idle_s = (1.0 if timeout is None
                       else min(1.0, timeout.total_seconds() / 4))
        self.delivery = threading.Thread(
            target=self._delivery_main, name=f"{sched.name}-delivery",
            daemon=True)
        self.delivery.start()

    # -- admission (the caller's thread) -----------------------------------

    def submit(self, plan, rels, st: _TenantState, qname: str,
               eff_deadline_ms, modeled_bytes, block: bool,
               timeout) -> PendingQuery:
        sched = self.sched
        if self.failed is not None:
            raise RuntimeError(f"{sched.name}: delivery failed") \
                from self.failed
        seq = self.seq
        self.seq += 1
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            verdict = None
            if self.leader:
                verdict = self._decide(st, eff_deadline_ms, modeled_bytes,
                                       block, deadline)
            verdict = self.admit.decide(verdict)
            if verdict[0] != "wait":
                break
        tname = st.cfg.name
        if verdict[0] == "closed":
            raise RuntimeError(f"{sched.name}: scheduler is closed")
        if verdict[0] == "shed":
            _, tag, reason = verdict
            if not self.leader:  # the leader counted as it decided
                if tag == "predicted":
                    count("serving.shed.predicted")
                    count(f"serving.tenant.{tname}.shed_predicted")
                elif tag == "memory":
                    count("serving.shed.memory_predicted")
                    count(f"serving.tenant.{tname}.shed_memory")
                sched._count_shed(st)
            raise QueryShed(tname, reason)
        _, slice_idx, active = verdict
        self._apply_scale(active)
        with sched._cv:
            pq = PendingQuery(qname,
                              lambda s=st: sched._release_in_flight(s))
            st.in_flight += 1
            item = _Item(pq, plan, rels, st, None, None, sched=sched,
                         deadline=(None if eff_deadline_ms is None
                                   else time.monotonic()
                                   + eff_deadline_ms / 1e3))
            item.axis = sched._axis
            item.seq = seq
            item.slice = slice_idx
            item.outcome_ev = threading.Event()
            self._place_locked(item, front=False)
            self.pending.append(item)
            count("serving.submitted")
            count(f"serving.tenant.{tname}.submitted")
            _flight.note("query_admitted", qid=pq.qid, query=qname,
                         tenant=tname, scheduler=sched.name, seq=seq,
                         slice=slice_idx)
            sched._publish_gauges_locked(st)
            sched._cv.notify_all()
        return pq

    def _decide(self, st, eff_deadline_ms, modeled_bytes, block, deadline):
        """The fleet leader's admission verdict: ``("closed",)``,
        ``("shed", tag, reason)``, ``("admit", slice, active)``, or
        ``("wait",)`` when it would still block after ``idle_s`` on a
        mesh of more than one rank. The bounds count this rank's queue
        and the undelivered queries of the other slices; a queued query
        is never preempted (another slice may be running it)."""
        sched = self.sched
        beat = (None if len(self.ranks) == 1
                else time.monotonic() + self.idle_s)
        with sched._cv:
            while True:
                if sched._closed:
                    return ("closed",)
                try:
                    sched._control_admission_locked(
                        st, eff_deadline_ms, modeled_bytes,
                        workers=self.active)
                except QueryShed as e:
                    tag = ("predicted"
                           if e.reason.startswith("serving.shed.predicted")
                           else "memory")
                    return ("shed", tag, e.reason)
                if (st.in_flight >= st.cfg.max_in_flight
                        or len(st.queue) + st.remote >= st.cfg.max_queue):
                    why = "tenant budget exhausted"
                elif sched._queued_total >= sched._max_queue:
                    why = "scheduler saturated"
                else:
                    break
                if not block:
                    sched._count_shed(st)
                    return ("shed", "plain", why)
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    sched._count_shed(st)
                    return ("shed", "plain", f"{why} (timed out)")
                if beat is not None:
                    left = beat - time.monotonic()
                    if left <= 0:
                        return ("wait",)
                    remaining = (left if remaining is None
                                 else min(remaining, left))
                sched._cv.wait(remaining)
            queued = sched._queued_total
            last_crash = sched._last_crash
        active = self.active
        if sched._control is not None:
            want = sched._control.desired_workers(active, queued, last_crash)
            if want is not None:
                active = max(1, min(len(self.slices), want))
        slice_idx = self.rr % active
        self.rr += 1
        return ("admit", slice_idx, active)

    def _apply_scale(self, active: int) -> None:
        """Every rank applies the leader's slice count alike."""
        if active == self.active:
            return
        count("serving.control.scale.up" if active > self.active
              else "serving.control.scale.down")
        gauge("serving.control.scale.target").set(active)
        _flight.note("scale_up" if active > self.active else "scale_down",
                     scheduler=self.sched.name, workers=active)
        self.active = active

    def _place_locked(self, item: _Item, front: bool) -> None:
        """Queue ``item`` here when this rank's slice serves it, else
        count it as another slice's until it is delivered."""
        sched = self.sched
        st = item.tenant
        if item.slice == self.my_slice and self.broken is not None:
            # out of service here: the attempt fails now, and delivery
            # moves it to the next slice
            item._record("err", self.broken)
            return
        if item.slice == self.my_slice:
            if not st.queue:
                st.vtime = max(st.vtime, sched._vclock)
            (st.queue.appendleft if front else st.queue.append)(item)
            self.local[item.seq] = item
        else:
            st.remote += 1
        sched._queued_total += 1

    # -- the slice worker --------------------------------------------------

    def worker_loop(self, widx: int) -> None:
        while True:
            # the worker seam fires before the pick: a crash holds no query
            _faults.maybe_inject(_faults.SEAM_WORKER)
            try:
                if self._serve_one(widx) is None:
                    return
            except Exception as e:
                self._break(widx, e)
                return

    def _serve_one(self, widx: int):
        """One agreed pick, taken and run; None once the fleet is done."""
        sched = self.sched
        choice, held = (self._leader_pick() if self.slice_leader
                        else (None, None))
        with sched._cv:
            self.held = held
        if self.slice_agree is not None:
            choice = self.slice_agree.decide(choice)
        if choice is None:
            return None
        seq, expired, action = choice
        item = held if self.slice_leader else self._take(seq, expired)
        with sched._cv:
            self.held = item
        _control_plane.ControlPlane.apply_memory_action(action, sched)
        if item is not None:
            with sched._cv:
                sched._running[widx] = [item]
                self.held = None
            item.mesh = self.slice_mesh
            t0 = time.perf_counter_ns()
            histogram("serving.queue_wait_ns").observe(t0 - item.pq.submit_ns)
            item.dispatch_ns = t0
            tname, prio = item.tenant.cfg.name, item.tenant.cfg.priority
            dq = item.dequeue_ns if item.dequeue_ns is not None else t0
            _slo.record(_slo.KIND_QUEUE_WAIT, tname, prio,
                        dq - item.pq.submit_ns)
            _slo.record(_slo.KIND_BATCH_WAIT, tname, prio, t0 - dq)
            _flight.note("query_dispatch", scheduler=sched.name,
                         worker=widx, qids=[item.pq.qid], slice=self.my_slice)
            _batcher.execute_batch([item], run_single=sched._run,
                                   device=sched.device)
            with sched._cv:
                sched._running.pop(widx, None)
        return True

    def _break(self, widx: int, exc: BaseException) -> None:
        """Take this rank's slice out of service after a failure past a
        pick: the item it held or ran and every item queued on the slice
        here record a ``SliceFailed`` outcome (delivery agrees it and
        retries on the next slice), and the worker exits."""
        sched = self.sched
        err = SliceFailed(f"slice {self.my_slice} failed on rank "
                          f"{self.rank}: {type(exc).__name__}: {exc}")
        count("serving.fault.slice_failed")
        with sched._cv:
            self.broken = err
            victims = list(sched._running.pop(widx, None) or [])
            if self.held is not None:
                victims.append(self.held)
                self.held = None
            for it in self.local.values():
                if it in it.tenant.queue:
                    it.tenant.queue.remove(it)
                    sched._queued_total -= 1
                victims.append(it)
            self.local.clear()
            victims = [it for it in victims if not it.outcome_ev.is_set()]
            for it in victims:
                it._record("err", err)
            sched._cv.notify_all()
        _flight.note("slice_failed", scheduler=sched.name,
                     slice=self.my_slice, rank=self.rank, error=repr(exc),
                     qids=[it.pq.qid for it in victims])

    def _leader_pick(self):
        """The slice leader's next choice, ``(seq or None, expired seqs,
        memory action)``, with the picked item; the choice is None once
        the scheduler is closed and every admitted query is delivered. A
        slice of more than one rank gets an empty choice after
        ``idle_s`` with nothing to pick (its followers' heartbeat)."""
        sched = self.sched
        beat = (None if self.slice_agree is None
                else time.monotonic() + self.idle_s)
        with sched._cv:
            while True:
                expired: list = []
                item = sched._pick_locked(expired)
                if item is not None or expired:
                    break
                if sched._closed and not self.pending:
                    return None, None
                if beat is None:
                    sched._cv.wait()
                    continue
                left = beat - time.monotonic()
                if left <= 0:
                    return (None, [], None), None
                sched._cv.wait(left)
            for it in expired + ([item] if item is not None else []):
                self.local.pop(it.seq, None)
            shrink, self.pending_shrink = self.pending_shrink, False
        action = (sched._control.memory_action(sched._batch_max)
                  if sched._control is not None else None)
        if shrink:
            action = "shrink"
        for it in expired:
            it._record("expired", None)
        return (None if item is None else item.seq,
                [it.seq for it in expired], action), item

    def _take(self, seq, expired) -> Optional[_Item]:
        """A follower takes its leader's choice out of its own queue,
        waiting for items its caller has not submitted yet."""
        sched = self.sched
        want = list(expired) + ([] if seq is None else [seq])
        taken = {}
        with sched._cv:
            for s in want:
                while s not in self.local:
                    sched._cv.wait()
                it = self.local.pop(s)
                it.tenant.queue.remove(it)
                sched._queued_total -= 1
                taken[s] = it
            for s in expired:
                taken[s]._record("expired", None)
                sched._publish_gauges_locked(taken[s].tenant)
            if seq is None:
                sched._cv.notify_all()
                return None
            item = taken[seq]
            return sched._charge_locked(item.tenant, item)

    # -- delivery (one thread a rank) ----------------------------------------

    def _delivery_main(self) -> None:
        try:
            self._deliver_all()
        except Exception as e:
            self._delivery_failed(e)

    def _delivery_failed(self, exc: BaseException) -> None:
        """A delivery that raised (a gather past its timeout) can agree
        nothing more: every undelivered handle on this rank fails, its
        queued attempts leave the queue, and later submissions raise."""
        sched = self.sched
        err = SliceFailed(f"delivery failed on rank {self.rank}: "
                          f"{type(exc).__name__}: {exc}")
        count("serving.fault.delivery_failed")
        with sched._cv:
            self.failed = err
            items = list(self.pending)
            self.pending.clear()
            for it in self.local.values():
                if it in it.tenant.queue:
                    it.tenant.queue.remove(it)
                    sched._queued_total -= 1
            self.local.clear()
            sched._cv.notify_all()
        _flight.note("delivery_failed", scheduler=sched.name,
                     rank=self.rank, error=repr(exc),
                     qids=[it.pq.qid for it in items])
        for it in items:
            if not it.pq.done():
                it.fail(err)

    def _deliver_all(self) -> None:
        sched = self.sched
        while True:
            with sched._cv:
                while not self.pending:
                    if sched._closed:
                        return
                    sched._cv.wait()
                item = self.pending[0]
            while not self._deliver_attempt(item):
                pass  # retried on the next slice: await that attempt
            with sched._cv:
                self.pending.popleft()
                sched._cv.notify_all()

    def _deliver_attempt(self, item: _Item) -> bool:
        """Agree one attempt's outcome across every rank; False when the
        query was requeued onto the next slice. The ranks gather in
        rounds of ``idle_s``: a serving rank whose outcome is not in yet
        posts ``wait``, and a round with a ``wait`` decides nothing."""
        import torch.distributed as dist

        mine = item.slice == self.my_slice
        wait_s = None if len(self.ranks) == 1 else self.idle_s
        payload = None
        while True:
            if mine and (payload is None or payload[0] == "wait"):
                payload = (self._payload(item)
                           if item.outcome_ev.wait(wait_s) else ("wait",))
            gathered = [None] * len(self.ranks)
            dist.all_gather_object(gathered, payload,
                                   group=self.deliver_group)
            if not any(p is not None and p[0] == "wait" for p in gathered):
                break
        outs = [p for p in gathered if p is not None]
        errs = [p for p in outs if p[0] == "err"]
        if errs:
            if self._retry(item, errs[0][3]):
                return False
            self._finish(item, errs[0])
        elif any(p[0] == "expired" for p in outs):
            self._finish(item, ("expired",))
        else:
            src = self.ranks.index(self.slice_srcs[item.slice])
            self._finish(item, ("ok", gathered[src][1]))
        return True

    def _payload(self, item: _Item) -> tuple:
        """This rank's outcome of the attempt, as delivery ships it."""
        kind, val = item.outcome
        if kind == "ok":
            frame = (val.to_df() if self.need_frame and self.slice_leader
                     else None)
            return ("ok", frame)
        if kind == "expired":
            return ("expired",)
        return ("err", type(val).__name__, str(val),
                _reliability.retry_action(val))

    def _unplace(self, item: _Item) -> None:
        """An attempt another slice served is over on this rank."""
        sched = self.sched
        if item.slice != self.my_slice:
            with sched._cv:
                item.tenant.remote -= 1
                sched._queued_total -= 1
                sched._publish_gauges_locked(item.tenant)
                sched._cv.notify_all()

    def _retry(self, item: _Item, action) -> bool:
        """The retry matrix on the agreed action, alike on every rank:
        True = requeued onto the next slice after the backoff."""
        sched = self.sched
        if action is None:
            return False
        if item.attempts >= sched._policy.max_retries:
            count("serving.fault.retry_exhausted")
            return False
        item.attempts += 1
        tname = item.tenant.cfg.name
        count("serving.fault.retries")
        count(f"serving.tenant.{tname}.retries")
        _flight.note("query_retry", qid=item.pq.qid, query=item.pq.query,
                     scheduler=sched.name, tenant=tname,
                     attempt=item.attempts)
        if action == _reliability.ACTION_RETRY_OOM:
            count("serving.fault.oom.retry")
            if item.slice == self.my_slice:
                _reliability.free_for_retry(sched.device)
        elif action == _reliability.ACTION_SPLIT:
            count("serving.fault.oom.split_query")
            with sched._cv:
                self.pending_shrink = True
        self._unplace(item)
        delay = sched._policy.backoff_s(item.attempts)
        if delay > 0 and not sched._closed:
            time.sleep(delay)
        with sched._cv:
            item.slice = (item.slice + 1) % len(self.slices)
            item.outcome = None
            item.outcome_ev.clear()
            item.dequeue_ns = item.dispatch_ns = None
            self._place_locked(item, front=True)
            sched._publish_gauges_locked(item.tenant)
            sched._cv.notify_all()
        return True

    def _finish(self, item: _Item, outcome) -> None:
        """Resolve the handle with the agreed outcome on this rank."""
        mine = item.slice == self.my_slice
        self._unplace(item)
        st = item.tenant
        if outcome[0] == "ok":
            item.finish(item.outcome[1] if mine
                        else DeliveredResult(outcome[1]))
        elif outcome[0] == "expired":
            count("serving.fault.expired")
            count(f"serving.tenant.{st.cfg.name}.expired")
            _slo.note(_slo.EVENT_EXPIRED, st.cfg.name, st.cfg.priority)
            self.sched._count_shed(st)
            late = (time.monotonic() - item.deadline
                    if item.deadline is not None else 0.0)
            item.pq._reject(QueryExpired(st.cfg.name, item.pq.query, late))
        else:
            local = item.outcome[1] if mine and item.outcome else None
            item.fail(local if isinstance(local, BaseException)
                      else RemoteQueryError(outcome[1], outcome[2]))
