"""Typed metrics registry: counters, gauges and ns-resolution histograms.

Port of ``spark_rapids_jni_tpu/obs/metrics.py``, with its two cost
tiers:

- **Counters and gauges are always on.** They carry the route, fallback,
  dispatch and host-sync accounting every test and the card's smoke read
  with no setup, and fire a handful of times a query, never a row.
- **Histograms and timers record only when ``SRT_METRICS`` is on.** They
  sit on per-morsel and per-span paths, so the disabled path costs one
  environment read (``exec.morsel.overlap_ns`` and ``io.disk.*_ns``
  record only with the knob on).

Everything exports two ways: ``to_json()`` for the report machinery and
``to_prometheus()`` text exposition for scrapers; ``parse_prometheus``
is the validating parser the tests and the scrape check share. Names
are ``<layer>.<event>``; Prometheus names are the sanitized form
(``srt_`` prefix, non-``[a-zA-Z0-9_:]`` -> ``_``).
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Dict, Optional, Sequence

from ..config import metrics_enabled


def enabled() -> bool:
    """True when the gated (histogram/span/report) tier records."""
    return metrics_enabled()


class Counter:
    """Monotonic counter. Always on; thread-safe via the registry lock."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._value = 0  # guarded-by: self._lock
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value. Always on."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._value = 0  # guarded-by: self._lock
        self._lock = lock

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


# Default bounds: a decade grid from 1 us to 100 s, in ns; anything past
# the top bound lands in the +Inf bucket.
DEFAULT_BOUNDS_NS: tuple = (
    1_000, 10_000, 100_000, 1_000_000, 10_000_000,
    100_000_000, 1_000_000_000, 10_000_000_000, 100_000_000_000,
)


class Histogram:
    """Fixed-bound histogram with Prometheus ``le`` (<=) bucket semantics.

    Per-bound counts are stored non-cumulative and cumulated at export,
    so concurrent observes never produce a decreasing bucket run.
    ``observe`` records nothing unless ``SRT_METRICS`` is on."""

    __slots__ = ("name", "bounds", "_counts", "_sum", "_count",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, lock: threading.RLock,
                 bounds: Optional[Sequence[float]] = None):
        bounds = tuple(sorted(bounds if bounds is not None
                              else DEFAULT_BOUNDS_NS))
        self.name = name
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # guarded-by: self._lock (+1: +Inf)
        self._sum = 0.0  # guarded-by: self._lock
        self._count = 0  # guarded-by: self._lock
        self._min: Optional[float] = None  # guarded-by: self._lock
        self._max: Optional[float] = None  # guarded-by: self._lock
        self._lock = lock

    def observe(self, v: float) -> None:
        if not enabled():
            return
        i = bisect.bisect_left(self.bounds, v)  # le: v == bound stays in
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    def snapshot(self) -> dict:
        with self._lock:
            cum = 0
            buckets = []
            for b, c in zip(self.bounds, self._counts):
                cum += c
                buckets.append([b, cum])
            buckets.append(["+Inf", cum + self._counts[-1]])
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "buckets": buckets}


class _Timer:
    """Context manager feeding a histogram in ns (perf_counter_ns)."""

    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter_ns() - self._t0)
        return False


class _NoopTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_TIMER = _NoopTimer()


class MetricsRegistry:
    """Thread-safe name -> metric map with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.RLock()
        # unlocked .get() fast path, setdefault under the lock
        self._counters: Dict[str, Counter] = {}  # guarded-by: self._lock
        self._gauges: Dict[str, Gauge] = {}  # guarded-by: self._lock
        self._histograms: Dict[str, Histogram] = {}  # guarded-by: self._lock

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name, self._lock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self._lock))
        return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, self._lock, bounds))
        return h

    def timer(self, name: str):
        """ns timer into ``histogram(name)``; a shared no-op when metrics
        are off."""
        if not enabled():
            return _NOOP_TIMER
        return _Timer(self.histogram(name))

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {n: c._value for n, c in self._counters.items()
                    if c._value}

    def to_json(self) -> dict:
        with self._lock:
            return {
                "counters": {n: c._value for n, c in self._counters.items()},
                "gauges": {n: g._value for n, g in self._gauges.items()},
                "histograms": {n: h.snapshot()
                               for n, h in self._histograms.items()},
            }

    def to_prometheus(self) -> str:
        lines: list = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._histograms.items())
        for name, c in counters:
            pn = prom_name(name)
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {c.value}")
        for name, g in gauges:
            pn = prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_fmt(g.value)}")
        for name, h in hists:
            pn = prom_name(name)
            snap = h.snapshot()
            lines.append(f"# TYPE {pn} histogram")
            for le, cum in snap["buckets"]:
                le_s = "+Inf" if le == "+Inf" else _fmt(le)
                lines.append(f'{pn}_bucket{{le="{le_s}"}} {cum}')
            lines.append(f"{pn}_sum {_fmt(snap['sum'])}")
            lines.append(f"{pn}_count {snap['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
timer = REGISTRY.timer


def count(name: str, n: int = 1) -> None:
    """Bump a named counter."""
    REGISTRY.counter(name).inc(n)


def kernel_stats() -> dict:
    """Snapshot of all nonzero counters."""
    return REGISTRY.counters_snapshot()


def reset_kernel_stats() -> None:
    REGISTRY.reset()


def stats_since(before: dict) -> dict:
    """Nonzero counter deltas since a ``kernel_stats()`` snapshot."""
    out = {}
    for k, v in kernel_stats().items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


DISPATCH_COUNTER = "rel.dispatches"
HOST_SYNC_COUNTER = "rel.host_syncs"


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


_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    return "srt_" + _PROM_SANITIZE.sub("_", name)


def _fmt(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


_PROM_COMMENT = re.compile(
    r"^#\s*(HELP|TYPE)\s+[a-zA-Z_:][a-zA-Z0-9_:]*(\s.*)?$")
_PROM_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+"
    r"(?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|\.\d+|Inf|NaN))\s*$")
_PROM_LABEL = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')


def parse_prometheus(text: str) -> Dict[str, float]:
    """Strict parser for the exposition this module emits; raises
    ``ValueError`` on any malformed line. Returns {sample_key: value},
    the key being ``name`` or ``name{labels}``."""
    samples: Dict[str, float] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if not _PROM_COMMENT.match(line):
                raise ValueError(f"line {i}: malformed comment: {line!r}")
            continue
        m = _PROM_SAMPLE.match(line)
        if not m:
            raise ValueError(f"line {i}: malformed sample: {line!r}")
        labels = m.group("labels")
        if labels is not None:
            for part in filter(None, labels.split(",")):
                if not _PROM_LABEL.match(part.strip()):
                    raise ValueError(f"line {i}: malformed label {part!r}")
        key = m.group("name") if labels is None \
            else f"{m.group('name')}{{{labels}}}"
        samples[key] = float(m.group("value"))
    return samples
