"""Reliability policy: the retry matrix, backoff, deadlines, quarantine.

Port of ``spark_rapids_jni_tpu/serving/reliability.py`` (plain Python;
the port keeps its own copy). The retry matrix over the port's
``utils/faults.py`` exceptions, which stand in for the reference's
native bridge's:

- ``RetryOOM``         -> free + exponential backoff + retry
- ``SplitAndRetryOOM`` -> degrade one capacity tier + retry
- ``InjectedFault`` / any exception carrying ``retryable = True``
                       -> backoff + retry (transient by contract)
- ``WorkerCrash``      -> not retried in place (supervision's job)
- everything else      -> fail fast, typed, to the caller

Retries a query are bounded (``SRT_QUERY_RETRIES``); backoff is
exponential with full jitter, ``uniform(0.5, 1.0) * base * 2^(attempt -
1)`` capped at :data:`BACKOFF_CAP_MS`; ``SRT_QUERY_DEADLINE_MS`` (or a
per-submit deadline) stamps an absolute deadline at admission. The
single-process executor (``serving/executor.py``) retries nothing
itself: it delivers the failure, and a caller or the fleet's scheduler
consults this matrix.

The fleet scheduler (``serving/scheduler.py``) reads all of it: its
workers route each failure through ``retry_action``, requeue under
:class:`RetryPolicy`'s budget and backoff, shed expired queries at
dequeue as :class:`QueryExpired` and quarantine a query present at two
worker deaths as :class:`QueryPoisoned`. The single-process executor
still delivers every failure; its callers use ``retry_action`` and
``free_for_retry`` themselves.
"""

from __future__ import annotations

import gc
import random
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import env_float, env_int
from ..utils.faults import (InjectedFault, RetryOOM, SplitAndRetryOOM,
                            WorkerCrash)

# Ceiling on one backoff sleep.
BACKOFF_CAP_MS = 2000.0

# A query in flight for this many worker deaths is quarantined.
QUARANTINE_CRASHES = 2

ACTION_RETRY = "retry"          # backoff + requeue, same shape
ACTION_RETRY_OOM = "retry_oom"  # free + backoff + requeue
ACTION_SPLIT = "split"          # degrade one capacity tier + requeue


class QueryExpired(RuntimeError):
    """The query's deadline passed while it was still queued; it was shed
    at dequeue without a dispatch (``serving.fault.expired``)."""

    def __init__(self, tenant: str, query: str, late_by_s: float):
        super().__init__(
            f"query {query} for tenant {tenant!r} expired in queue "
            f"({late_by_s * 1e3:.1f} ms past deadline)")
        self.tenant = tenant
        self.query = query
        self.late_by_s = late_by_s


class QueryPoisoned(RuntimeError):
    """The query was in flight for ``QUARANTINE_CRASHES`` worker deaths
    and is quarantined: it fails fast and is never retried
    (``serving.fault.quarantined``)."""

    def __init__(self, tenant: str, query: str, crashes: int):
        super().__init__(
            f"query {query} for tenant {tenant!r} quarantined after "
            f"{crashes} worker crashes")
        self.tenant = tenant
        self.query = query
        self.crashes = crashes


@dataclass(frozen=True)
class RetryPolicy:
    """Retry, backoff and deadline knobs, from arguments with the
    environment as fallback."""

    max_retries: int = 2                 # SRT_QUERY_RETRIES
    backoff_ms: float = 10.0             # SRT_RETRY_BACKOFF_MS (base)
    deadline_ms: Optional[float] = None  # SRT_QUERY_DEADLINE_MS

    @staticmethod
    def from_env(max_retries: Optional[int] = None,
                 backoff_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None) -> "RetryPolicy":
        if max_retries is None:
            max_retries = env_int("SRT_QUERY_RETRIES", 2)
        if backoff_ms is None:
            backoff_ms = env_float("SRT_RETRY_BACKOFF_MS", 10.0)
        if deadline_ms is None:
            deadline_ms = env_float("SRT_QUERY_DEADLINE_MS", None)
            if deadline_ms is not None and deadline_ms <= 0:
                deadline_ms = None
        return RetryPolicy(max_retries=max(0, int(max_retries)),
                           backoff_ms=max(0.0, float(backoff_ms)),
                           deadline_ms=deadline_ms)

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter backoff for retry ``attempt`` (1-based), seconds."""
        return full_jitter_backoff_s(attempt, self.backoff_ms)


def full_jitter_backoff_s(attempt: int, base_ms: float,
                          cap_ms: float = BACKOFF_CAP_MS) -> float:
    """``uniform(0.5, 1.0) * base * 2^(attempt-1)`` capped at ``cap_ms``,
    in seconds: a retried burst does not re-arrive as one herd."""
    if base_ms <= 0:
        return 0.0
    raw = min(float(base_ms) * (2.0 ** max(0, int(attempt) - 1)),
              float(cap_ms))
    return random.uniform(0.5, 1.0) * raw / 1e3


def retry_action(exc: BaseException) -> Optional[str]:
    """Classify a failure: one of the ACTION_* verdicts, or None (not
    retryable: deliver to the caller)."""
    if isinstance(exc, WorkerCrash):
        return None
    if isinstance(exc, SplitAndRetryOOM):
        return ACTION_SPLIT
    if isinstance(exc, RetryOOM):
        return ACTION_RETRY_OOM
    if isinstance(exc, InjectedFault):
        return ACTION_RETRY
    if getattr(exc, "retryable", False):
        return ACTION_RETRY
    return None


def free_for_retry(device=None) -> None:
    """The "free" half of RetryOOM handling: collect the cycles that pin
    device buffers, then, on a CUDA device, release the caching
    allocator's unused blocks (``empty_cache``). The reference only
    collects (XLA frees a buffer when its last reference dies);
    PyTorch's allocator keeps freed blocks reserved for its own reuse,
    so a retry that needs a differently sized block, or memory another
    process or library allocates outside the allocator, would otherwise
    meet the same OOM. The retry pays for re-reserving what it needs."""
    gc.collect()
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.empty_cache()
