"""Flight recorder: an always-on bounded ring of recent serving events.

Port of ``spark_rapids_jni_tpu/obs/flight.py`` (plain Python; the port
keeps its own copy). The ring holds recent serving events (admissions,
dispatches, failures, sheds, morsel folds) and compact summaries of
emitted ExecutionReports, recording always: one lock and one deque
append an event. Events noted inside a worker's ``qid_scope`` carry the
query's correlation id.

``dump(reason)`` writes the ring, with the ``serving.fault.*`` /
``serving.shed*`` / ``obs.*`` counters and the ``mem.*`` gauges, as one
JSON file under ``SRT_TRACE_EXPORT`` (else ``target/flight-recorder``),
rate-limited per reason (``SRT_FLIGHT_MIN_INTERVAL_S``, default 5 s);
a failed write is counted (``obs.flight_dump_errors``), never raised.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from ..config import env_float, get_config
from .metrics import REGISTRY, count, kernel_stats

MAX_EVENTS = 512
MAX_REPORTS = 64
DEFAULT_MIN_INTERVAL_S = 5.0
DEFAULT_DUMP_DIR = os.path.join("target", "flight-recorder")

_lock = threading.Lock()
_events: "deque" = deque(maxlen=MAX_EVENTS)  # guarded-by: _lock
_reports: "deque" = deque(maxlen=MAX_REPORTS)  # guarded-by: _lock
_dump_seq = 0  # guarded-by: _lock
_last_dump: "dict[str, float]" = {}  # guarded-by: _lock


def note(kind: str, **fields) -> None:
    """Append one event; fields are JSON-serializable host values. ``t``
    (unix seconds) is stamped here, and the ambient qid when the caller
    passed none."""
    ev = {"t": time.time(), "kind": kind}
    ev.update(fields)
    if "qid" not in ev:
        from .report import current_qid
        qid = current_qid()
        if qid:
            ev["qid"] = qid
    with _lock:
        _events.append(ev)


def note_report(report) -> None:
    """Keep a compact summary of a just-emitted ExecutionReport."""
    summary = {"t": time.time(), "query": report.query, "qid": report.qid,
               "fused": report.fused, "provenance": report.provenance,
               "dispatches": report.dispatches, "wall_ns": report.wall_ns,
               "batch": report.batch}
    if report.batch_qids:
        summary["batch_qids"] = list(report.batch_qids)
    fb = report.fallbacks()
    if fb:
        summary["fallbacks"] = fb
    if report.reliability:
        summary["reliability"] = dict(report.reliability)
    if report.memory:
        summary["modeled_peak_bytes"] = report.memory.get(
            "modeled_peak_bytes")
    with _lock:
        _reports.append(summary)


def events_tail(n: int) -> list:
    """The newest ``n`` events, oldest first."""
    with _lock:
        return list(_events)[-n:] if n > 0 else []


def snapshot() -> dict:
    """The ring plus the live fault/obs counters and memory gauges:
    what a dump writes."""
    with _lock:
        events = list(_events)
        reports = list(_reports)
    counters = {k: v for k, v in kernel_stats().items()
                if k.startswith(("serving.fault.", "serving.shed", "obs."))}
    gauges = {k: v for k, v in REGISTRY.to_json()["gauges"].items()
              if k.startswith("mem.")}
    return {"events": events, "reports": reports,
            "fault_counters": counters, "memory_gauges": gauges}


def dump_dir() -> str:
    return (get_config().trace_export or "").strip() or DEFAULT_DUMP_DIR


def dump(reason: str, directory: Optional[str] = None) -> Optional[str]:
    """Write the ring to ``flight_<pid>_<seq>_<reason>.json`` and return
    the path; None when rate-limited or when the write failed."""
    global _dump_seq
    now = time.monotonic()
    with _lock:
        last = _last_dump.get(reason)
        if last is not None and now - last < env_float(
                "SRT_FLIGHT_MIN_INTERVAL_S", DEFAULT_MIN_INTERVAL_S):
            count("obs.flight_dumps_suppressed")
            return None
        _last_dump[reason] = now
        _dump_seq += 1
        seq = _dump_seq
    body = snapshot()
    body["reason"] = reason
    body["dumped_at"] = time.time()
    directory = directory or dump_dir()
    path = os.path.join(directory,
                        f"flight_{os.getpid()}_{seq:04d}_{reason}.json")
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(body, f, indent=2, default=str)
    except OSError:
        count("obs.flight_dump_errors")
        # a failed write must not suppress the next attempt
        with _lock:
            if _last_dump.get(reason) == now:
                del _last_dump[reason]
        return None
    count("obs.flight_dumps")
    return path


def reset_flight() -> None:
    """Clear the ring and the rate-limit memory."""
    global _dump_seq
    with _lock:
        _events.clear()
        _reports.clear()
        _last_dump.clear()
        _dump_seq = 0
