"""Sliding-window SLO sketches: latency quantiles over recent time.

Port of ``spark_rapids_jni_tpu/obs/slo.py`` (plain Python; the port
keeps its own copy, and fed the same samples under the same clock its
quantiles equal the reference's exactly).

- **Sketch shape.** Per (kind, tenant, priority) a ring of fixed log2
  bucket histograms, one a window of ``SRT_SLO_WINDOW_S`` seconds
  (default 60), ``SRT_SLO_WINDOWS`` deep (default 5). Recording is O(1);
  a slot whose epoch is stale is reset on first touch, so there is no
  timer thread. Quantiles merge the live windows.
- **Kinds.** ``queue_wait`` (submit -> dequeue), ``batch_wait``,
  ``execute`` (dispatch -> resolve), ``e2e`` (submit -> resolve).
  Latency recording rides the ``SRT_METRICS`` gate.
- **Events.** ``served`` / ``shed`` / ``expired`` / ``poisoned`` are
  always counted and export as per-window rates.
- **Export.** ``publish()`` writes
  ``serving.slo.<tenant>.p<priority>.<kind>.{p50,p90,p99,count,mean}_ns``
  and ``...<event>_per_s`` gauges; the scrape endpoint
  (``obs/server.py``) calls it before every ``/metrics``.

Quantiles are bucket upper bounds (conservative by at most 2x).

- **Fleet exports.** ``export_sketches`` hands out the merged raw
  bucket vectors (served at ``/slo.json``); ``merge_sketches`` adds N
  such exports bucket by bucket (the fleet rollup, ``obs/rollup.py``),
  and ``sketch_quantiles`` reads quantiles off a merged vector: a p99 of
  p99s is not a fleet p99, a sum of buckets is.
- **Control reads.** ``latency_stats`` merges one kind's live windows,
  optionally for one tenant and priority, for the control plane
  (``serving/control_plane.py``); a cold window reads None, never zero.
  With ``SRT_CONTROL_PLANE=1`` latency samples record whatever
  ``SRT_METRICS`` says: the control plane's loops read them.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from ..config import env_float, env_int, get_config
from .metrics import enabled, gauge

KIND_QUEUE_WAIT = "queue_wait"
KIND_BATCH_WAIT = "batch_wait"
KIND_EXECUTE = "execute"
KIND_E2E = "e2e"
KINDS = (KIND_QUEUE_WAIT, KIND_BATCH_WAIT, KIND_EXECUTE, KIND_E2E)

EVENT_SERVED = "served"
EVENT_SHED = "shed"
EVENT_EXPIRED = "expired"
EVENT_POISONED = "poisoned"
EVENTS = (EVENT_SERVED, EVENT_SHED, EVENT_EXPIRED, EVENT_POISONED)

QUANTILES = (0.50, 0.90, 0.99)

# log2 ns buckets: index i covers (2^(i-1), 2^i] ns, clamped to
# [_MIN_EXP, _MAX_EXP]: a 1 us floor to a ~18 min ceiling, 32 buckets.
_MIN_EXP = 10
_MAX_EXP = 41
N_BUCKETS = _MAX_EXP - _MIN_EXP + 1

DEFAULT_WINDOW_S = 60.0
DEFAULT_WINDOWS = 5


def _bucket(dur_ns: int) -> int:
    exp = max(1, int(dur_ns)).bit_length()
    return min(max(exp, _MIN_EXP), _MAX_EXP) - _MIN_EXP


def bucket_upper_ns(index: int) -> int:
    return 1 << (index + _MIN_EXP)


def _quantiles(h: list) -> dict:
    """Quantiles of one merged histogram vector: bucket upper bounds,
    plus count and mean."""
    total = h[N_BUCKETS]
    q: dict = {}
    cum = 0
    targets = [(f"p{int(p * 100)}_ns", p) for p in QUANTILES]
    ti = 0
    for i in range(N_BUCKETS):
        cum += h[i]
        while ti < len(targets) and total \
                and cum >= targets[ti][1] * total:
            q[targets[ti][0]] = bucket_upper_ns(i)
            ti += 1
    for name, _ in targets[ti:]:
        q[name] = bucket_upper_ns(N_BUCKETS - 1) if total else 0
    q["count"] = total
    q["mean_ns"] = (h[N_BUCKETS + 1] // total) if total else 0
    return q


class _Window:
    """One time window's sketches and outcome counts."""

    __slots__ = ("epoch", "hists", "events")

    def __init__(self, epoch: int):
        self.epoch = epoch
        # (kind, tenant, priority) -> [bucket counts..., total, sum_ns]
        self.hists: Dict[Tuple[str, str, int], list] = {}
        # (tenant, priority, event) -> count
        self.events: Dict[Tuple[str, int, str], int] = {}


class SloTracker:
    """The sliding-window tracker; ``TRACKER`` is the process's, and
    tests build private ones with a fake clock."""

    def __init__(self, window_s: Optional[float] = None,
                 n_windows: Optional[int] = None, _clock=time.monotonic):
        if window_s is None:
            window_s = env_float("SRT_SLO_WINDOW_S", DEFAULT_WINDOW_S)
        if n_windows is None:
            n_windows = env_int("SRT_SLO_WINDOWS", DEFAULT_WINDOWS)
        self.window_s = max(0.001, float(window_s))
        self.n_windows = max(1, int(n_windows))
        self._clock = _clock
        self._lock = threading.Lock()
        self._ring: "list[Optional[_Window]]" = [None] * self.n_windows  # guarded-by: self._lock
        # gauges set by the previous publish(): those absent from the next
        # snapshot are zeroed, so a scrape never reports aged-out traffic
        self._published: "set[str]" = set()  # guarded-by: self._publish_lock
        self._publish_lock = threading.Lock()

    def _slot_locked(self) -> _Window:  # requires-lock: self._lock
        epoch = int(self._clock() // self.window_s)
        i = epoch % self.n_windows
        w = self._ring[i]
        if w is None or w.epoch != epoch:
            w = self._ring[i] = _Window(epoch)
        return w

    def record(self, kind: str, tenant: str, priority: int,
               dur_ns: int) -> None:
        """Record one latency sample; a no-op when metrics are off and the
        control plane (which reads these windows) is off too."""
        if not enabled() and not get_config().control_plane_enabled:
            return
        b = _bucket(dur_ns)
        key = (kind, tenant, int(priority))
        with self._lock:
            w = self._slot_locked()
            h = w.hists.get(key)
            if h is None:
                h = w.hists[key] = [0] * (N_BUCKETS + 2)
            h[b] += 1
            h[N_BUCKETS] += 1
            h[N_BUCKETS + 1] += dur_ns

    def note(self, event: str, tenant: str, priority: int) -> None:
        """Count one outcome event. Always on."""
        key = (tenant, int(priority), event)
        with self._lock:
            w = self._slot_locked()
            w.events[key] = w.events.get(key, 0) + 1

    def _live_windows_locked(self) -> "list[_Window]":  # requires-lock: self._lock
        epoch = int(self._clock() // self.window_s)
        lo = epoch - self.n_windows + 1
        return [w for w in self._ring
                if w is not None and lo <= w.epoch <= epoch]

    def snapshot(self) -> dict:
        """Merged view over the live windows: ``{(tenant, priority):
        {"latency": {kind: {p50_ns, p90_ns, p99_ns, count, mean_ns}},
        "rates": {event: per_s}, "counts": {event: n}}}``. The rate
        denominator is the span covered (epoch distance plus the elapsed
        part of the newest window)."""
        with self._lock:
            windows = [self._concat_locked(w)
                       for w in self._live_windows_locked()]
            now = self._clock()
        merged_h: Dict[Tuple[str, str, int], list] = {}
        merged_e: Dict[Tuple[str, int, str], int] = {}
        newest = oldest = -1
        for epoch, hists, events in windows:
            newest = max(newest, epoch)
            oldest = epoch if oldest < 0 else min(oldest, epoch)
            for k, h in hists.items():
                acc = merged_h.setdefault(k, [0] * (N_BUCKETS + 2))
                for i, v in enumerate(h):
                    acc[i] += v
            for k, v in events.items():
                merged_e[k] = merged_e.get(k, 0) + v
        span_s = 0.0
        if newest >= 0:
            span_s = self.window_s * (newest - oldest) \
                + max(0.001, now - newest * self.window_s)
        out: dict = {}
        for (kind, tenant, prio), h in merged_h.items():
            ent = out.setdefault((tenant, prio), {"latency": {}, "rates": {}})
            ent["latency"][kind] = _quantiles(h)
        for (tenant, prio, event), n in merged_e.items():
            ent = out.setdefault((tenant, prio), {"latency": {}, "rates": {}})
            ent["rates"][event] = n / max(span_s, 0.001)
            ent.setdefault("counts", {})[event] = n
        return out

    @staticmethod
    def _concat_locked(w: _Window) -> tuple:
        return (w.epoch, {k: list(h) for k, h in w.hists.items()},
                dict(w.events))

    def latency_stats(self, kind: str, tenant: Optional[str] = None,
                      priority: Optional[int] = None) -> Optional[dict]:
        """Merged quantiles of one latency kind over the live windows; a
        ``tenant``/``priority`` of None merges across that dimension.
        Returns ``{p50_ns, p90_ns, p99_ns, count, mean_ns}``, or None when
        the live windows hold no sample for the key (a cold window is no
        signal, never a zero). Only the matching histograms are summed,
        under the lock: this runs on the admission path."""
        want_prio = None if priority is None else int(priority)
        acc = [0] * (N_BUCKETS + 2)
        hit = False
        with self._lock:
            for w in self._live_windows_locked():
                for (k, t, p), h in w.hists.items():
                    if k != kind or (tenant is not None and t != tenant) \
                            or (want_prio is not None and p != want_prio):
                        continue
                    hit = True
                    for i, v in enumerate(h):
                        acc[i] += v
        if not hit or not acc[N_BUCKETS]:
            return None
        return _quantiles(acc)

    def publish(self) -> dict:
        """Flush the merged windows into ``serving.slo.*`` gauges; gauges
        of a previous publish whose key aged out are zeroed. Returns the
        snapshot published."""
        with self._publish_lock:
            snap = self.snapshot()
            published: "set[str]" = set()
            for (tenant, prio), ent in snap.items():
                base = f"serving.slo.{tenant}.p{prio}"
                for kind, q in ent["latency"].items():
                    for name in ("p50_ns", "p90_ns", "p99_ns", "count",
                                 "mean_ns"):
                        gname = f"{base}.{kind}.{name}"
                        gauge(gname).set(q[name])
                        published.add(gname)
                for event, rate in ent["rates"].items():
                    gname = f"{base}.{event}_per_s"
                    gauge(gname).set(round(rate, 6))
                    published.add(gname)
            for gname in self._published - published:
                gauge(gname).set(0)
            self._published = published
            gauge("serving.slo.window_s").set(self.window_s)
            gauge("serving.slo.windows").set(self.n_windows)
            return snap

    def export_sketches(self) -> dict:
        """The live windows' merged raw sketch vectors, JSON-shaped for
        ``/slo.json``: keys ``"tenant|priority|kind"`` (histograms) and
        ``"tenant|priority|event"`` (outcome counts)."""
        with self._lock:
            windows = [self._concat_locked(w)
                       for w in self._live_windows_locked()]
        hists: "dict[str, list]" = {}
        events: "dict[str, int]" = {}
        for _epoch, whists, wevents in windows:
            for (kind, tenant, prio), h in whists.items():
                acc = hists.setdefault(f"{tenant}|{prio}|{kind}",
                                       [0] * (N_BUCKETS + 2))
                for i, v in enumerate(h):
                    acc[i] += v
            for (tenant, prio, event), n in wevents.items():
                key = f"{tenant}|{prio}|{event}"
                events[key] = events.get(key, 0) + n
        return {"n_buckets": N_BUCKETS, "window_s": self.window_s,
                "windows": self.n_windows, "hists": hists,
                "events": events}

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self.n_windows
        with self._publish_lock:
            self._published = set()


def merge_sketches(exports) -> dict:
    """Merge N ``export_sketches()`` payloads by bucket addition. An
    export (or one of its vectors) whose length disagrees with this
    build's ``N_BUCKETS`` grid is skipped, counted in ``skipped``: a
    mixed-version fleet must not corrupt the sum."""
    hists: "dict[str, list]" = {}
    events: "dict[str, int]" = {}
    skipped = 0
    for exp in exports:
        if not isinstance(exp, dict) or exp.get("n_buckets") != N_BUCKETS:
            skipped += 1
            continue
        for key, h in (exp.get("hists") or {}).items():
            if not isinstance(h, list) or len(h) != N_BUCKETS + 2:
                skipped += 1
                continue
            acc = hists.setdefault(key, [0] * (N_BUCKETS + 2))
            for i, v in enumerate(h):
                acc[i] += int(v)
        for key, n in (exp.get("events") or {}).items():
            events[key] = events.get(key, 0) + int(n)
    return {"n_buckets": N_BUCKETS, "hists": hists, "events": events,
            "skipped": skipped}


def sketch_quantiles(h: list) -> dict:
    """Quantiles of one raw sketch vector (a merged one included)."""
    return _quantiles(h)


TRACKER = SloTracker()

record = TRACKER.record
note = TRACKER.note


def reset_slo() -> None:
    TRACKER.reset()
