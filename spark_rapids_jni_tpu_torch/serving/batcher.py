"""Micro-query batching: coalesce small compatible submissions.

Port of ``spark_rapids_jni_tpu/serving/batcher.py``. Short queries
leave the card idle between dispatches: each plan is a few milliseconds
of kernels, and the host's per-query dispatch (queue handoff, the plan's
Python, hundreds of kernel launches) dominates. The fleet scheduler
(``serving/scheduler.py``) coalesces them:

- :func:`batch_key`: the host-side compatibility key. Two submissions
  may share one batch program iff they run the same plan over rels with
  equal fingerprints (schema, verified stats, column sizes, dictionary
  content) under the same planner knobs; mesh-partitioned, masked or
  non-fusable submissions are unbatchable (None).
- :func:`execute_batch`: run K compatible items through
  ``rel.run_fused_batched`` (one batch program at a static capacity,
  replayed from a CUDA graph on the card; one host sync for all K live
  counts) and hand each result to its caller's handle. When the batch
  cannot coalesce (``BatchIncompatible``) it falls back, route-counted
  (``serving.batch.fallback``), to per-query dispatch; a batching
  failure is never a query failure. Memory pressure
  (``SplitAndRetryOOM``) halves the window down the capacity ladder (4
  -> 2 + 2 -> per query), counted ``serving.fault.oom.split``.
- :class:`ArrivalEstimator`: the adaptive coalescing window, an EWMA of
  submission gaps sized to the expected time to fill the batch, capped
  (``SRT_BATCH_WINDOW_MAX_MS``, default 5) and zero when traffic is
  sparse; ``SRT_BATCH_WINDOW_MS`` pins a fixed window instead.

Counters: ``serving.batch.formed`` (batched dispatches),
``serving.batch.queries`` (queries served batched),
``serving.batch.fallback`` (windows degraded to per-query),
``serving.batch.exec_errors`` (runtime failures of a batched dispatch),
``serving.batch.unbatchable`` (submissions that never got a key).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..config import env_float
from ..obs import count, histogram, span
from ..obs import report as _obs_report

# Ceiling on the adaptive window (ms): the most latency coalescing may add
# to one query, and the horizon beyond which the estimator stops waiting.
DEFAULT_MAX_WINDOW_MS = 5.0


class ArrivalEstimator:
    """EWMA inter-arrival estimate driving the adaptive batch window.

    ``observe()`` runs on every submission; ``window_s(capacity)`` turns
    the estimate into a coalescing deadline: 0 with no history yet, 0
    when the estimated gap reaches the ceiling (a sparse stream pays no
    coalescing latency), else ``gap * (capacity - 1)`` capped at the
    ceiling. ``alpha`` weighs the newest gap, so one long idle gap after
    a burst lets the next lone query through unbatched."""

    __slots__ = ("alpha", "max_window_s", "_last", "_gap_s", "_lock")

    def __init__(self, alpha: float = 0.2,
                 max_window_s: Optional[float] = None):
        if max_window_s is None:
            max_window_s = env_float("SRT_BATCH_WINDOW_MAX_MS",
                                     DEFAULT_MAX_WINDOW_MS) / 1e3
        self.alpha = alpha
        self.max_window_s = max_window_s
        self._last: Optional[float] = None  # guarded-by: self._lock
        self._gap_s: Optional[float] = None  # guarded-by: self._lock
        self._lock = threading.Lock()

    def observe(self, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._last is not None:
                gap = max(0.0, now - self._last)
                self._gap_s = (gap if self._gap_s is None else
                               self.alpha * gap
                               + (1.0 - self.alpha) * self._gap_s)
            self._last = now

    def gap_s(self) -> Optional[float]:
        """The current EWMA gap (None = no history yet)."""
        with self._lock:
            return self._gap_s

    def window_s(self, capacity: int) -> float:
        with self._lock:
            gap = self._gap_s
        if gap is None or gap >= self.max_window_s:
            return 0.0
        return min(self.max_window_s, gap * max(1, capacity - 1))


def batch_key(plan, rels, mesh=None, axis: Optional[str] = None):
    """Compatibility key of one submission, or None when it cannot join
    any batch: mesh-partitioned plans dispatch per query (the batch
    program runs on one device), and only unmasked fusable resident
    ingests qualify, exactly the inputs ``run_fused_batched`` accepts."""
    from ..tpcds import rel as relmod

    if mesh is not None:
        return None
    order = tuple(sorted(rels))
    for name in order:
        r = rels[name]
        if (getattr(r, "is_host_table", False) or not relmod._fusable_rel(r)
                or r.mask is not None):
            return None
    fps = tuple(relmod._rel_fingerprint(rels[name]) for name in order)
    return (plan, order, fps, relmod.planner_env_key())


def execute_batch(items, run_batched=None, run_single=None,
                  device=None) -> None:
    """Execute compatible ``items`` (objects with ``pq``/``plan``/
    ``rels``/``mesh``/``axis`` attributes and ``resolve``/``reject``
    hooks) as one batched dispatch on ``device``, resolving every
    handle; degrade, route-counted, to per-query dispatch when the batch
    cannot coalesce. ``run_batched(plan, rels_list)`` and
    ``run_single(plan, rels, mesh=, axis=)`` are test seams defaulting to
    the fused runners.

    A ``SplitAndRetryOOM`` from the batched dispatch halves the window
    (each half re-enters here, so repeated pressure walks the capacity
    ladder rung by rung down to per-query dispatch), counted
    ``serving.fault.oom.split`` a halving. Per-query failures go through
    each item's ``reject`` hook, where the scheduler's bounded retries
    get first refusal."""
    from ..tpcds import rel as relmod
    from ..utils.faults import SplitAndRetryOOM

    run_batched = run_batched or (
        lambda plan, rels_list: relmod.run_fused_batched(
            plan, rels_list, device=device))
    if len(items) > 1:
        try:
            # the batched dispatch runs under its first member's qid with
            # every member's in batch_qids: the one batch report joins
            # each member's trail
            with _obs_report.qid_scope(
                    getattr(items[0].pq, "qid", ""),
                    batch_qids=[getattr(it.pq, "qid", "")
                                for it in items]):
                outs = run_batched(items[0].plan,
                                   [it.rels for it in items])
            count("serving.batch.formed")
            count("serving.batch.queries", len(items))
            for it, out in zip(items, outs):
                it.resolve(out)
            return
        except relmod.BatchIncompatible:
            # the plan or the shapes refused to coalesce: per query below
            count("serving.batch.fallback")
        except SplitAndRetryOOM:
            # the batch did not fit: halve the window and retry both
            # halves, one rung down the ladder a split
            count("serving.fault.oom.split")
            mid = len(items) // 2
            execute_batch(items[:mid], run_batched=run_batched,
                          run_single=run_single, device=device)
            execute_batch(items[mid:], run_batched=run_batched,
                          run_single=run_single, device=device)
            return
        except Exception:
            # a runtime failure of the batched dispatch must neither kill
            # the worker nor strand K handles: per query, where each
            # query's own error reaches its own caller
            count("serving.batch.fallback")
            count("serving.batch.exec_errors")
    run_single = run_single or (
        lambda plan, rels, mesh=None, axis=None: relmod.run_fused(
            plan, rels, device=device, mesh=mesh, axis=axis,
            skip_result_cache=True))
    for it in items:
        try:
            qid = getattr(it.pq, "qid", "")
            with _obs_report.qid_scope(qid), \
                    span("serving.execute", query=it.pq.query, qid=qid):
                out = run_single(it.plan, it.rels, mesh=it.mesh,
                                 axis=it.axis)
            it.resolve(out)
        except Exception as e:  # the worker survives any query
            it.reject(e)


class BatchWindow:
    """One coalescing window: the first item opens it, later compatible
    items join until the capacity or the deadline (``window_s``). The
    scheduler holds its queue lock while consulting it: plain host
    arithmetic, no blocking, no device work."""

    __slots__ = ("key", "items", "deadline", "capacity")

    def __init__(self, first, capacity: int, window_s: float):
        self.key = first.bkey
        self.items = [first]
        self.capacity = capacity
        self.deadline = time.monotonic() + window_s

    def wants_more(self) -> bool:
        return (len(self.items) < self.capacity
                and time.monotonic() < self.deadline)

    def remaining(self) -> float:
        return max(0.0, self.deadline - time.monotonic())

    def add(self, item) -> None:
        self.items.append(item)

    def observe_fill(self) -> None:
        histogram("serving.batch.fill").observe(len(self.items))
