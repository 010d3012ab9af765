"""Per-query ExecutionReport: what one ``run_fused`` call did.

Port of ``spark_rapids_jni_tpu/obs/report.py``. With ``SRT_METRICS`` on,
``run_fused`` (``tpcds/rel.py``) builds one report a call on every
route (in-core, mesh, morsel): plan identity and provenance, the
planner's route counters, dispatch and host-sync counts, fallback
counters, the ``shuffle``, ``memory``, ``morsel`` and ``io`` sections,
per-span timings and compile events. Reports accumulate in a bounded
ring (``recent_reports``/``last_report``) and are also written as JSON
files when ``SRT_TRACE_EXPORT`` names a directory.

**Provenance.** The reference names where its compiled program came
from (``cold_compile``, ``warm_disk``, ``warm_memory``). Eager PyTorch
compiles no plan, so a ``run_fused`` report says ``eager`` (the plan
ran), ``result_cache`` (the content-keyed result cache answered; nothing
ran) or ``delta`` (the morsel runner's standing re-run folded only the
appended rows). The batched runner on the card captures its program
into a CUDA graph: a window that captured says ``cold_compile``, one
that replayed a graph ``warm_memory`` (there is no disk tier: a graph
has no serialized form); on the CPU it runs eagerly and says ``eager``.
``cache_hit`` is True for a result-cache hit, and for a batched window
that found its batch-cache entry.

**Query correlation.** ``mint_qid`` gives each admitted query an id
unique across processes; the serving worker enters ``qid_scope``
around a dispatch, and ``emit`` and the flight recorder stamp the
ambient id. A batched dispatch runs under its first member's qid with
every member's in ``batch_qids``, which the one batch report carries.

``native_route_sentinels`` and ``native_ra_snapshot`` read the native
bridge (``native.py``), which the port has not ported: both return
``{}``.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

from ..config import env_str
from . import spans

_reports: "deque" = deque(maxlen=256)  # guarded-by: _lock
_lock = threading.Lock()
_emit_seq = 0  # guarded-by: _lock

PROVENANCE_EAGER = "eager"
PROVENANCE_RESULT_CACHE = "result_cache"
PROVENANCE_DELTA = "delta"
PROVENANCE_COLD_COMPILE = "cold_compile"
PROVENANCE_WARM_MEMORY = "warm_memory"
PROVENANCE_WARM_DISK = "warm_disk"

_QID_SALT = os.urandom(2).hex()
_qid_seq = 0  # guarded-by: _lock
_qid_tls = threading.local()


def mint_qid() -> str:
    """A process-unique query correlation id (``q-<pid>-<salt>-<seq>``)."""
    global _qid_seq
    with _lock:
        _qid_seq += 1
        seq = _qid_seq
    return f"q-{os.getpid():x}-{_QID_SALT}-{seq:x}"


def current_qid() -> str:
    """The ambient qid on this thread ("" outside any ``qid_scope``)."""
    return getattr(_qid_tls, "qid", "")


def current_batch_qids() -> tuple:
    """Every member qid of the batched dispatch this thread runs (empty
    outside one)."""
    return getattr(_qid_tls, "batch_qids", ())


@contextmanager
def qid_scope(qid: str, batch_qids=None):
    """Make ``qid`` (and, for a batched dispatch, its members'
    ``batch_qids``) the ambient ids for everything this thread runs in
    the block: reports emitted and flight events noted inside inherit
    them. Nests; the outer ids come back on exit."""
    prev = getattr(_qid_tls, "qid", "")
    prev_batch = getattr(_qid_tls, "batch_qids", ())
    _qid_tls.qid = qid or ""
    _qid_tls.batch_qids = tuple(batch_qids) if batch_qids else ()
    try:
        yield
    finally:
        _qid_tls.qid = prev
        _qid_tls.batch_qids = prev_batch


# Counter-name fragments that mark a fallback route (correct but slow):
# the reference's list, the one source for ExecutionReport.fallbacks().
FALLBACK_COUNTER_MARKS = ("fused_fallbacks", "host_fallback",
                          "host_unescape", "python_walker",
                          "extract_host_rows", "stale_stats",
                          "dist_fallback", "overflow_rows",
                          "pallas_degraded", "budget_unmet",
                          "morsel_fallback", "general", "pool_degraded",
                          "tuned_stale", "zonemap_untrusted",
                          # the port's forced kernel route past its cap
                          # (rel.route.*.cuda_degraded)
                          "cuda_degraded")


def is_fallback_counter(name: str) -> bool:
    return any(m in name for m in FALLBACK_COUNTER_MARKS)


@dataclass
class ExecutionReport:
    query: str                     # plan name ("_q1" -> "q1")
    fused: bool                    # ran on the fused (one-sync) route
    cache_hit: bool                # the result cache answered
    dispatches: int                # counted device programs this run
    host_syncs: int                # data-dependent host syncs this run
    wall_ns: int                   # end-to-end wall time
    provenance: str = ""  # eager|result_cache|delta|cold_compile|warm_memory|warm_disk
    batch: int = 0                 # queries one batch dispatch served
    counters: dict = field(default_factory=dict)   # counter deltas
    routes: dict = field(default_factory=dict)     # planner decisions
    spans: list = field(default_factory=list)      # SpanRecord dicts
    recompiles: list = field(default_factory=list)
    native_routes: dict = field(default_factory=dict)
    shuffle: dict = field(default_factory=dict)    # mesh runs only
    reliability: dict = field(default_factory=dict)
    memory: dict = field(default_factory=dict)
    morsel: dict = field(default_factory=dict)     # morsel runs only
    io: dict = field(default_factory=dict)         # Parquet inputs only
    qid: str = ""
    batch_qids: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "query": self.query, "qid": self.qid,
            "batch_qids": list(self.batch_qids), "fused": self.fused,
            "cache_hit": self.cache_hit, "dispatches": self.dispatches,
            "host_syncs": self.host_syncs, "wall_ns": self.wall_ns,
            "provenance": self.provenance, "batch": self.batch,
            "counters": self.counters, "routes": self.routes,
            "spans": self.spans, "recompiles": self.recompiles,
            "native_routes": self.native_routes, "shuffle": self.shuffle,
            "reliability": self.reliability, "memory": self.memory,
            "morsel": self.morsel, "io": self.io,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), default=str, **kw)

    def fallbacks(self) -> dict:
        """Fallback-route counters in this run's delta."""
        return {k: v for k, v in self.counters.items()
                if is_fallback_counter(k)}

    def render(self) -> str:
        prov = f" [{self.provenance}]" if self.provenance else ""
        qid = f" qid={self.qid}" if self.qid else ""
        lines = [
            f"query {self.query}:{qid} "
            f"{'fused' if self.fused else 'GENERAL-PATH (fallback)'}"
            f"{' (result-cache hit)' if self.cache_hit else ''}"
            f"{prov} — {self.wall_ns / 1e6:.2f} ms, {self.dispatches} "
            f"dispatches, {self.host_syncs} host syncs",
        ]
        for title, section in (
                ("planner routes", self.routes),
                ("shuffle (partitioned execution)", self.shuffle),
                ("reliability (faults/retries)", self.reliability),
                ("morsel (out-of-core streaming)", self.morsel),
                ("io (disk-backed streaming)", self.io)):
            if section:
                lines.append(f"  {title}:")
                for k in sorted(section):
                    lines.append(f"    {k}: {section[k]}")
        if self.memory:
            lines.append("  memory (modeled peak + device watermarks):")
            for k in sorted(self.memory):
                v = self.memory[k]
                if k == "devices":
                    for di in sorted(v):
                        lines.append(f"    device {di}: {v[di]}")
                else:
                    lines.append(f"    {k}: {v}")
        fb = self.fallbacks()
        if fb:
            lines.append("  fallback routes:")
            for k in sorted(fb):
                lines.append(f"    {k}: {fb[k]}")
        else:
            lines.append("  fallback routes: none")
        agg = spans.aggregate([_AsRecord(s) for s in self.spans])
        if agg:
            lines.append("  spans (name  calls  total  mean):")
            for a in agg:
                lines.append(
                    f"    {a['name']:<32} {a['calls']:>5}  "
                    f"{a['total_ns'] / 1e6:>9.3f} ms  "
                    f"{a['mean_ns'] / 1e6:>8.3f} ms")
        if self.recompiles:
            lines.append("  compile events:")
            for r in self.recompiles:
                dur = r.get("duration_s")
                dur_s = f" ({dur * 1e3:.1f} ms)" if dur else ""
                lines.append(f"    [{r.get('kind')}] {r.get('site')}"
                             f"{dur_s} in span {r.get('span')}")
        return "\n".join(lines)


class _AsRecord:
    """A span dict in the attribute shape spans.aggregate reads."""

    __slots__ = ("name", "dur_ns")

    def __init__(self, d: dict):
        self.name = d["name"]
        self.dur_ns = d["dur_ns"]


def native_route_sentinels() -> dict:
    """The native bridge's per-kernel route sentinels: ``{}`` until
    ``native.py`` is ported."""
    return {}


def native_ra_snapshot() -> dict:
    """The native resource adaptor's state: ``{}`` until ``native.py``
    is ported."""
    return {}


def report_provenance(info: dict) -> str:
    """The report's provenance from a run's ``info``: the morsel
    runner's ``cold``/``warm_memory`` runs are plain eager runs; a
    batched window's capture and replay keep theirs."""
    p = info.get("provenance", "")
    return p if p in (PROVENANCE_RESULT_CACHE, PROVENANCE_DELTA,
                      PROVENANCE_COLD_COMPILE, PROVENANCE_WARM_MEMORY,
                      PROVENANCE_WARM_DISK) \
        else PROVENANCE_EAGER


def annotate_reliability(query: str, updates: dict) -> None:
    """Merge reliability facts into the newest report for ``query``,
    preferring one emitted by the calling thread (the worker resolves
    on the thread that ran the query); a no-op when none matches."""
    me = threading.get_ident()
    with _lock:
        fallback = None
        for r in reversed(_reports):
            if r.query != query:
                continue
            if getattr(r, "_emit_thread", None) == me:
                r.reliability.update(updates)
                return
            if fallback is None:
                fallback = r
        if fallback is not None:
            fallback.reliability.update(updates)


def emit(report: ExecutionReport) -> None:
    """Stamp the ambient qid, keep the report in the ring and the flight
    recorder, and write it under ``SRT_TRACE_EXPORT`` when set."""
    global _emit_seq
    report._emit_thread = threading.get_ident()
    if not report.qid:
        report.qid = current_qid()
    if not report.batch_qids:
        report.batch_qids = list(current_batch_qids())
    with _lock:
        _emit_seq += 1
        seq = _emit_seq
        _reports.append(report)
    from . import flight as _flight
    _flight.note_report(report)
    export_dir = env_str("SRT_TRACE_EXPORT", "").strip()
    if export_dir:
        try:
            os.makedirs(export_dir, exist_ok=True)
            path = os.path.join(export_dir,
                                f"report_{seq:04d}_{report.query}.json")
            with open(path, "w", encoding="utf-8") as f:
                f.write(report.to_json(indent=2))
        except OSError:
            # export is advisory: never fail the query over a bad path
            from .metrics import count
            count("obs.trace_export_errors")


def recent_reports(n: Optional[int] = None) -> list:
    with _lock:
        out = list(_reports)
    return out if n is None else out[-n:]


def last_report(query: Optional[str] = None) -> Optional[ExecutionReport]:
    with _lock:
        for r in reversed(_reports):
            if query is None or r.query == query:
                return r
    return None


def reset_reports() -> None:
    with _lock:
        _reports.clear()
