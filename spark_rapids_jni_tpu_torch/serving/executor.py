"""The single-process serving executor: a bounded queue over ``run_fused``.

Port of ``spark_rapids_jni_tpu/serving/executor.py``.

- **One worker thread.** It owns the device pipeline and runs submitted
  queries in FIFO order through ``run_fused`` on the executor's explicit
  ``device`` (``torch.cuda.set_device`` is per thread, so the worker
  never relies on the caller's current device). The hand kernels launch
  on the worker's current stream of that device.
- **Pipelined host work.** ``submit`` returns a :class:`PendingQuery`
  at once; the caller's thread goes on ingesting the next request and
  decoding earlier results (``PendingQuery.to_df``). It reads a result
  only after ``run_fused``'s one host sync, on the worker. Eager
  dispatch holds the interpreter lock on the worker while it enqueues
  kernels, so the caller overlaps the device's work, not the worker's
  host work (the reference overlaps both, JAX dispatching
  asynchronously).
- **Admission control.** The queue is bounded (``max_queue``) and a
  semaphore bounds submitted-but-uncollected results (``max_in_flight``,
  released when a result is collected, or when an abandoned handle is
  collected by the garbage collector), so overload queues instead of
  growing device state. ``block=False`` sheds with ``queue.Full``.

Each dispatch runs inside ``qid_scope(pq.qid)``, so the report
``run_fused`` emits, every flight note and span carry the query's id.
Obs: ``serving.{submitted,completed,failed,rejected}`` counters,
``serving.{queue_depth,in_flight}`` gauges, the
``serving.{queue_wait,execute,latency}_ns`` histograms and the
``serving.execute`` span (with ``SRT_METRICS``), and the SLO windows
(``obs/slo.py``: the executor's name is the tenant, priority 0).

With ``SRT_CONTROL_PLANE=1`` the executor builds a control plane
(``serving/control_plane.py``): with a deadline (``deadline_ms``, else
``SRT_QUERY_DEADLINE_MS``), a submission whose predicted queue wait and
execute time, from this executor's own windows, already exceed it sheds
at once as ``queue.Full``, counted ``serving.shed.predicted``.
With ``mesh``, every rank runs its own executor and submits the same
queries in the same order (each is one collective program); the
predicted-shed verdict is then the mesh's first rank's, broadcast to
every rank over a gloo group of the mesh's ranks
(``control_plane.RankAgreement``), so every rank admits alike.
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
import weakref
from collections import deque
from typing import Optional

import torch

from ..obs import count, gauge, histogram, span
from ..obs import flight as _flight
from ..obs import report as _obs_report
from ..obs import slo as _slo
from ..utils.device import resolve_device
from . import control_plane as _control_plane

_STOP = object()


class _InflightSlot:
    """One admission slot, released exactly once: by the first collector
    or, for an abandoned handle, by the garbage collector. Holds no
    reference to the PendingQuery, so the finalizer can fire."""

    __slots__ = ("_release", "_lock", "_done")

    def __init__(self, release):
        self._release = release
        self._lock = threading.Lock()
        self._done = False  # guarded-by: self._lock

    def release_once(self) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
        self._release()


class PendingQuery:
    """Handle of a submitted query: resolves to the result ``Rel``.

    ``result()``/``to_df()`` wait for the worker, re-raise the query's
    error, and release the executor's in-flight slot once. ``to_df``
    decodes on the calling thread."""

    __slots__ = ("query", "qid", "submit_ns", "done_ns", "_event",
                 "_result", "_error", "_slot", "_finalizer", "__weakref__")

    def __init__(self, query: str, release):
        self.query = query
        self.qid = _obs_report.mint_qid()  # minted once, at admission
        self.submit_ns = time.perf_counter_ns()
        self.done_ns: Optional[int] = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._slot = _InflightSlot(release)
        self._finalizer = weakref.finalize(self, self._slot.release_once)

    def _resolve(self, rel) -> None:
        self._result = rel
        self.done_ns = time.perf_counter_ns()
        self._event.set()

    def _reject(self, exc: BaseException) -> None:
        self._error = exc
        self.done_ns = time.perf_counter_ns()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Wait up to ``timeout`` seconds for the result. A
        ``TimeoutError`` changes nothing: the handle stays re-waitable
        and keeps its slot (the query still holds queue or device
        budget)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"query {self.query} not done after "
                               f"{timeout}s (handle re-waitable)")
        self._slot.release_once()
        if self._error is not None:
            raise self._error
        return self._result

    def to_df(self, timeout: Optional[float] = None):
        return self.result(timeout).to_df()

    @property
    def latency_ns(self) -> Optional[int]:
        return None if self.done_ns is None else self.done_ns - self.submit_ns


class QueryExecutor:
    """Bounded-queue pipelined executor over ``run_fused``::

        with QueryExecutor(device="cuda", max_queue=8) as ex:
            pending = [ex.submit(plan, ingest(req)) for req in batch]
            frames = [p.to_df(timeout=60) for p in pending]

    Plan runs from other threads (another executor, a fleet scheduler's
    workers) serialize with this worker's on the planner lock
    (``tpcds/rel.py`` ``_PLAN_LOCK``)."""

    def __init__(self, max_queue: int = 8, max_in_flight: int = 16,
                 device=None, mesh=None, axis=None,
                 deadline_ms: Optional[float] = None,
                 name: str = "serving"):
        if max_in_flight < max_queue:
            raise ValueError("max_in_flight must be >= max_queue "
                             "(queued queries count as in flight)")
        self.name = name
        # the predictive-shed deadline (control plane only: without it the
        # single worker enforces no deadline)
        if deadline_ms is None:
            from .reliability import RetryPolicy
            deadline_ms = RetryPolicy.from_env().deadline_ms
        if deadline_ms is not None and deadline_ms <= 0:
            deadline_ms = None
        self._deadline_ms = deadline_ms
        self._control = _control_plane.maybe_control_plane(
            name=name, n_workers=1)
        self._agree = (_control_plane.RankAgreement(mesh)
                       if self._control is not None and mesh is not None
                       else None)
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        self._mesh = mesh
        self._axis = axis
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._inflight = threading.BoundedSemaphore(max_in_flight)
        self._max_in_flight = max_in_flight
        self._lock = threading.Lock()
        self._inflight_n = 0  # guarded-by: self._lock
        # queued items, counted from the enqueue/dequeue events
        self._depth = 0  # guarded-by: self._lock
        self._submit_lock = threading.Lock()
        self._closed = False  # guarded-by: self._submit_lock
        self._worker = threading.Thread(
            target=self._run, name=f"{name}-worker", daemon=True)
        self._worker.start()
        # drain and join before interpreter teardown if never closed
        atexit.register(self.close)

    # -- submission --------------------------------------------------------

    def submit(self, plan, rels, *, block: bool = True,
               timeout: Optional[float] = None) -> PendingQuery:
        """Enqueue ``run_fused(plan, rels)``. Blocks while the queue or
        the in-flight budget is full, up to ``timeout`` seconds for the
        whole call; ``block=False`` sheds with ``queue.Full`` at once when
        the budget or the queue is exhausted, and after a short grace
        (``timeout``, at most 1 s) when the submit lock is merely
        contended."""
        if self._closed:
            raise RuntimeError(f"{self.name}: executor is closed")
        qname = getattr(plan, "__name__", "plan").lstrip("_")
        if self._control is not None and self._deadline_ms is not None:
            # predictive shedding: this executor's own execute window,
            # before any admission cost; cold windows and faulted
            # telemetry never shed
            pred = None
            if self._agree is None or self._agree.leader:
                with self._lock:
                    depth = self._depth
                pred = self._control.shed_verdict(
                    self.name, 0, self._deadline_ms / 1e3, depth, 1)
            if self._agree is not None:
                pred = self._agree.decide(pred)
            if pred is not None:
                count("serving.rejected")
                count("serving.shed.predicted")
                _slo.note(_slo.EVENT_SHED, self.name, 0)
                raise queue.Full(
                    f"{self.name}: {qname} shed — predicted "
                    f"{pred / 1e6:.0f} ms exceeds the "
                    f"{self._deadline_ms:.0f} ms deadline "
                    f"(serving.shed.predicted)")
        deadline = (time.monotonic() + timeout
                    if block and timeout is not None else None)
        if not self._inflight.acquire(blocking=block,
                                      timeout=timeout if block else None):
            count("serving.rejected")
            _slo.note(_slo.EVENT_SHED, self.name, 0)
            raise queue.Full(f"{self.name}: {qname} rejected — "
                             f"in-flight budget exhausted")
        with self._lock:
            self._inflight_n += 1
            gauge("serving.in_flight").set(self._inflight_n)
        pq = PendingQuery(qname, self._release_inflight)
        # count the enqueue before the put: the worker may dequeue the
        # moment the item lands
        with self._lock:
            self._depth += 1
            gauge("serving.queue_depth").set(self._depth)
        try:
            # the submit lock orders enqueues against close(): nothing can
            # land behind the stop sentinel
            if block:
                acquired = self._submit_lock.acquire(
                    timeout=(max(0.0, deadline - time.monotonic())
                             if deadline is not None else -1))
            else:
                acquired = self._submit_lock.acquire(blocking=False)
                grace = time.monotonic() + (min(timeout, 1.0)
                                            if timeout is not None else 1.0)
                while (not acquired and not self._queue.full()
                       and time.monotonic() < grace):
                    acquired = self._submit_lock.acquire(timeout=0.01)
            if not acquired:
                cause = ("queue full" if self._queue.full()
                         else "submit lock contended")
                raise queue.Full(f"{self.name}: {qname} rejected — {cause}"
                                 + (" (submit timed out)" if block else ""))
            try:
                if self._closed:
                    raise RuntimeError(f"{self.name}: executor is closed")
                self._queue.put((pq, plan, rels), block=block,
                                timeout=(max(0.0, deadline - time.monotonic())
                                         if deadline is not None else None))
            finally:
                self._submit_lock.release()
        except queue.Full:
            self._undo_depth()
            pq._slot.release_once()
            count("serving.rejected")
            _slo.note(_slo.EVENT_SHED, self.name, 0)
            raise
        except RuntimeError:
            self._undo_depth()
            pq._slot.release_once()
            raise
        count("serving.submitted")
        _flight.note("query_admitted", qid=pq.qid, query=qname,
                     executor=self.name)
        return pq

    def _undo_depth(self) -> None:
        with self._lock:
            self._depth -= 1
            gauge("serving.queue_depth").set(self._depth)

    def run(self, requests, timeout: Optional[float] = None) -> list:
        """Submit every ``(plan, rels)`` pair and return the result rels in
        order, collecting as it goes so a batch larger than the in-flight
        budget drains instead of deadlocking."""
        pending: "deque[PendingQuery]" = deque()
        results = []
        for plan, rels in requests:
            while len(pending) >= self._max_in_flight:
                results.append(pending.popleft().result(timeout))
            pending.append(self.submit(plan, rels))
        while pending:
            results.append(pending.popleft().result(timeout))
        return results

    def _release_inflight(self) -> None:
        self._inflight.release()
        with self._lock:
            self._inflight_n -= 1
            gauge("serving.in_flight").set(self._inflight_n)

    # -- the worker --------------------------------------------------------

    def _run(self) -> None:
        from ..tpcds.rel import run_fused  # tpcds imports serving

        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            self._undo_depth()
            pq, plan, rels = item
            t0 = time.perf_counter_ns()
            histogram("serving.queue_wait_ns").observe(t0 - pq.submit_ns)
            _flight.note("query_dispatch", qid=pq.qid, query=pq.query,
                         executor=self.name)
            served = True
            try:
                with _obs_report.qid_scope(pq.qid), \
                        span("serving.execute", query=pq.query, qid=pq.qid):
                    out = run_fused(plan, rels, device=self.device,
                                    mesh=self._mesh, axis=self._axis)
                pq._resolve(out)
                count("serving.completed")
            except Exception as e:  # the worker survives any query
                pq._reject(e)
                count("serving.failed")
                _flight.note("query_failed", qid=pq.qid, query=pq.query,
                             error=type(e).__name__)
                served = False
            done = time.perf_counter_ns()
            histogram("serving.execute_ns").observe(done - t0)
            histogram("serving.latency_ns").observe(done - pq.submit_ns)
            _slo.record(_slo.KIND_QUEUE_WAIT, self.name, 0, t0 - pq.submit_ns)
            _slo.record(_slo.KIND_EXECUTE, self.name, 0, done - t0)
            _slo.record(_slo.KIND_E2E, self.name, 0, done - pq.submit_ns)
            if served:
                _slo.note(_slo.EVENT_SERVED, self.name, 0)
            # drop the loop's references before blocking in get(), so an
            # abandoned handle's finalizer can fire while the worker idles
            item = pq = out = plan = rels = None

    # -- lifecycle ---------------------------------------------------------

    def close(self, wait: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting work; queued queries still run and resolve. With
        ``wait``, join the worker (up to ``timeout`` seconds)."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_STOP)
        if wait:
            self._worker.join(timeout)
        atexit.unregister(self.close)

    def __enter__(self) -> "QueryExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close(wait=True)
