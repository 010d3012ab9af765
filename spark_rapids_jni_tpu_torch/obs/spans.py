"""Spans: named wall-time ranges with attributes.

A minimal port of ``spark_rapids_jni_tpu/obs/spans.py``. With
``SRT_METRICS`` off a span costs one env read and records nothing; with
it on, each closed span appends a ``SpanRecord`` to a bounded ring. The
times are host wall times: a span around queued device work measures
the enqueue unless the work inside ends in a synchronising read.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from dataclasses import dataclass, field

from ..config import metrics_enabled

_RING_CAP = 4096


@dataclass
class SpanRecord:
    name: str
    start_ns: int
    dur_ns: int = 0
    attrs: dict = field(default_factory=dict)


_local = threading.local()
_ring: "collections.deque[SpanRecord]" = collections.deque(maxlen=_RING_CAP)
_ring_lock = threading.Lock()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time the enclosed block as span ``name`` (when metrics are on)."""
    if not metrics_enabled():
        yield None
        return
    rec = SpanRecord(name, time.perf_counter_ns(), attrs=dict(attrs))
    st = _stack()
    st.append(rec)
    try:
        yield rec
    finally:
        st.pop()
        rec.dur_ns = time.perf_counter_ns() - rec.start_ns
        with _ring_lock:
            _ring.append(rec)


def set_attrs(**attrs) -> None:
    """Attach attributes to the innermost open span, if any."""
    st = getattr(_local, "stack", None)
    if st:
        st[-1].attrs.update(attrs)


def traced(name: str):
    """Decorator: run the function inside ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def span_records() -> "list[SpanRecord]":
    with _ring_lock:
        return list(_ring)

