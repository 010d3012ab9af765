"""Counters: the route, dispatch and host-sync accounting of the path.

A minimal port of ``spark_rapids_jni_tpu/obs/metrics.py``: named integer
counters in one registry object, always on, with snapshot/delta helpers
that scope assertions to one region.
"""

from __future__ import annotations

import threading
from typing import Optional

DISPATCH_COUNTER = "rel.dispatches"
HOST_SYNC_COUNTER = "rel.host_syncs"


class CounterRegistry:
    """Thread-safe map of counter name -> int."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: "dict[str, int]" = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: v for k, v in self._counts.items() if v}


REGISTRY = CounterRegistry()


def count(name: str, n: int = 1) -> None:
    """Bump a named counter."""
    REGISTRY.inc(name, n)


def kernel_stats() -> dict:
    """Snapshot of all nonzero counters."""
    return REGISTRY.snapshot()


def stats_since(before: dict) -> dict:
    """Nonzero counter deltas since a ``kernel_stats()`` snapshot."""
    out = {}
    for k, v in kernel_stats().items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


def count_dispatch(site: str, n: int = 1) -> None:
    """Record ``n`` device-program dispatches from ``site``."""
    count(DISPATCH_COUNTER, n)
    count(f"{DISPATCH_COUNTER}.{site}", n)


def count_host_sync(site: str, n: int = 1) -> None:
    """Record ``n`` data-dependent device->host syncs from ``site``."""
    count(HOST_SYNC_COUNTER, n)
    count(f"{HOST_SYNC_COUNTER}.{site}", n)


def dispatch_counts(stats: Optional[dict] = None) -> "tuple[int, int]":
    """(dispatches, data-dependent host syncs) from ``stats`` or live."""
    if stats is None:
        stats = kernel_stats()
    return (stats.get(DISPATCH_COUNTER, 0), stats.get(HOST_SYNC_COUNTER, 0))
