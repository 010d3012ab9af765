"""Counters, gauges and histograms: the route, dispatch, host-sync and
streaming accounting of the path.

A minimal port of ``spark_rapids_jni_tpu/obs/metrics.py``: named integer
counters in one registry object, always on, with snapshot/delta helpers
that scope assertions to one region; last-write-wins gauges
(``exec.morsel.peak_model_bytes``, ``mem.pool.*``) and histograms of
observed values (``exec.morsel.overlap_ns``, ``io.disk.read_ns``), also
always on.
"""

from __future__ import annotations

import threading
from typing import Optional

DISPATCH_COUNTER = "rel.dispatches"
HOST_SYNC_COUNTER = "rel.host_syncs"


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0
        self._lock = lock

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Count, sum, min and max of the observed values."""

    __slots__ = ("name", "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._count, self._sum = 0, 0
            self._min = self._max = None

    def observe(self, v) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    def snapshot(self) -> dict:
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max}


class CounterRegistry:
    """Thread-safe map of counter name -> int, and the named gauges and
    histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: "dict[str, int]" = {}
        self._gauges: "dict[str, Gauge]" = {}
        self._histograms: "dict[str, Histogram]" = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: v for k, v in self._counts.items() if v}

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, threading.Lock())
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name,
                                                       threading.Lock())
            return h


REGISTRY = CounterRegistry()


def count(name: str, n: int = 1) -> None:
    """Bump a named counter."""
    REGISTRY.inc(name, n)


def gauge(name: str) -> Gauge:
    """The named gauge (created at first use)."""
    return REGISTRY.gauge(name)


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
