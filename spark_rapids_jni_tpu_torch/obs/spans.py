"""Spans: nesting named wall-time ranges with attributes.

Port of ``spark_rapids_jni_tpu/obs/spans.py``. ``span("rel.join",
how="inner")`` opens a named range: it nests per thread, records start
and duration in ns plus host-side attributes, feeds the
``span.<name>`` histogram, and lands in a bounded ring. ``mark()`` /
``records_since()`` scope a region without resetting global state (a
query's report reads its own spans that way); ``export_perfetto()``
writes the ring as Chrome trace-event JSON.

``SpanRecord.start_ns`` is on the clock ``torch.profiler`` places host
ranges and device operations on: the epoch (CLOCK_REALTIME) in ns, where
a profiler event starts at ``kineto_results.trace_start_ns()`` plus its
``time_range.start`` (us) times 1000. Spans are timed on
``perf_counter_ns`` and moved to the epoch by one offset taken at
import. ``export_perfetto()``
writes ``baseTimeNanoseconds`` and ``ts = (start_ns - base) / 1000``, as
``export_chrome_trace`` does, so a span file laid over a profiler trace,
each file's base applied, puts every device-idle gap under the span the
host was in.

Under config ``trace_enabled`` (``SRT_TRACE_ENABLED``) every span and
``traced`` op also opens a ``torch.profiler.record_function`` range
``srt::<name>``, where the reference opens a
``jax.profiler.TraceAnnotation``: it shows in ``torch.profiler`` traces,
with the kernels launched inside it, and as an NVTX range under
``torch.autograd.profiler.emit_nvtx``. With both ``metrics_enabled`` and
``trace_enabled`` off, ``span()`` and ``traced`` cost two field reads
(each an environment read unless ``set_config`` gave the field) and
record nothing. A call that opens several spans reads the switches once
through ``span_opener()``, which hands back ``span`` or, with both off,
``no_span``: one shared no-op context, no span object built.

The times are host wall times: a span around queued device work
measures the enqueue unless the work inside ends in a synchronising
read, as ``run_fused``'s one host sync does.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from collections import deque
from typing import Optional

from torch.profiler import record_function

from ..config import get_config
from .metrics import REGISTRY

_records: "deque" = deque(maxlen=100_000)  # guarded-by: _rec_lock
_rec_lock = threading.Lock()
_seq = 0  # guarded-by: _rec_lock
_tls = threading.local()
# perf_counter_ns() + _EPOCH_NS is the epoch time in ns, the profiler's
# clock; the export's base is the whole second at or before
# perf_counter's zero, so every ts is positive
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()
_BASE_NS = _EPOCH_NS // 1_000_000_000 * 1_000_000_000
_OFF = contextlib.nullcontext()


class SpanRecord:
    """One finished span. ``seq`` is a process-wide monotonic id
    assigned when the span closes; ``start_ns`` is epoch ns, the
    profiler's clock."""

    __slots__ = ("seq", "name", "start_ns", "dur_ns", "tid", "depth",
                 "parent", "attrs")

    def __init__(self, seq, name, start_ns, dur_ns, tid, depth, parent,
                 attrs):
        self.seq = seq
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.depth = depth
        self.parent = parent
        self.attrs = attrs

    def to_dict(self) -> dict:
        return {"seq": self.seq, "name": self.name,
                "start_ns": self.start_ns, "dur_ns": self.dur_ns,
                "tid": self.tid, "depth": self.depth,
                "parent": self.parent, "attrs": self.attrs}


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _LiveSpan:
    __slots__ = ("name", "attrs", "start_ns", "parent")

    def __init__(self, name, attrs, parent):
        self.name = name
        self.attrs = attrs
        self.start_ns = time.perf_counter_ns() + _EPOCH_NS
        self.parent = parent


class _SpanCtx:
    """The context manager ``span()`` returns. One use."""

    __slots__ = ("name", "attrs", "_range", "_live")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._range = None
        self._live = None

    def __enter__(self):
        cfg = get_config()
        if cfg.trace_enabled:
            self._range = record_function(f"srt::{self.name}")
            self._range.__enter__()
        if cfg.metrics_enabled:
            st = _stack()
            parent = st[-1].name if st else None
            self._live = _LiveSpan(self.name, self.attrs, parent)
            st.append(self._live)
        return self

    def __exit__(self, *exc):
        global _seq
        live = self._live
        if live is not None:
            end = time.perf_counter_ns() + _EPOCH_NS
            st = _stack()
            # pop through any leaked children so one missed __exit__ never
            # skews every later record's depth
            while st and st[-1] is not live:
                st.pop()
            if st:
                st.pop()
            dur = end - live.start_ns
            with _rec_lock:
                _seq += 1
                _records.append(SpanRecord(
                    _seq, live.name, live.start_ns, dur,
                    threading.get_ident(), len(st), live.parent,
                    dict(live.attrs)))
            REGISTRY.histogram(f"span.{live.name}").observe(dur)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def set_attrs(self, **attrs) -> None:
        self.attrs.update(attrs)


def span(name: str, **attrs) -> _SpanCtx:
    """Open a named span; attributes must be host-side values."""
    return _SpanCtx(name, attrs)


def no_span(name: str, **attrs) -> contextlib.nullcontext:
    """``span``'s stand-in with both switches off: one shared no-op
    context."""
    return _OFF


def span_opener():
    """``span`` if ``metrics_enabled`` or ``trace_enabled`` is on, else
    ``no_span``: a call that opens several spans reads the switches once
    and passes the opener down."""
    cfg = get_config()
    return span if cfg.metrics_enabled or cfg.trace_enabled else no_span


def current_span_name() -> Optional[str]:
    st = getattr(_tls, "stack", None)
    return st[-1].name if st else None


def set_attrs(**attrs) -> None:
    """Merge attributes into the innermost live span; a no-op when
    metrics are off or no span is open."""
    st = getattr(_tls, "stack", None)
    if st:
        st[-1].attrs.update(attrs)


def traced(name: str):
    """Decorator: run the function inside ``span(name)`` (and, under
    ``trace_enabled``, its profiler range); with both switches off, two
    field reads and a direct call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            cfg = get_config()
            if not (cfg.metrics_enabled or cfg.trace_enabled):
                return fn(*args, **kwargs)
            with _SpanCtx(name, {}):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def mark() -> int:
    """Sequence watermark: pass to ``records_since`` to scope a region."""
    with _rec_lock:
        return _seq


def records_since(watermark: int = 0) -> list:
    # records append in increasing seq order: scan from the tail
    out = []
    with _rec_lock:
        for r in reversed(_records):
            if r.seq <= watermark:
                break
            out.append(r)
    out.reverse()
    return out


def span_records() -> list:
    return records_since(0)


def reset_spans() -> None:
    with _rec_lock:
        _records.clear()
    _tls.stack = []


def export_perfetto(records=None) -> dict:
    """Chrome trace-event JSON (what Perfetto and chrome://tracing load):
    complete ("X") events, ts/dur in microseconds, ts counted from
    ``baseTimeNanoseconds`` (epoch ns) as in ``export_chrome_trace``'s
    files: ``base + ts * 1000`` is on the profiler's clock."""
    if records is None:
        records = span_records()
    pid = os.getpid()
    return {"displayTimeUnit": "ns", "baseTimeNanoseconds": _BASE_NS,
            "traceEvents": [
                {"name": r.name, "cat": "srt", "ph": "X",
                 "ts": (r.start_ns - _BASE_NS) / 1e3, "dur": r.dur_ns / 1e3,
                 "pid": pid, "tid": r.tid, "args": r.attrs}
                for r in records]}


def aggregate(records) -> "list[dict]":
    """Per-name rollup of span records: calls, total and mean wall ns."""
    agg: dict = {}
    for r in records:
        a = agg.setdefault(r.name, {"name": r.name, "calls": 0,
                                    "total_ns": 0})
        a["calls"] += 1
        a["total_ns"] += r.dur_ns
    out = sorted(agg.values(), key=lambda a: -a["total_ns"])
    for a in out:
        a["mean_ns"] = a["total_ns"] // max(a["calls"], 1)
    return out
