"""Bounded on-disk metric history and the regression watch over it.

Port of ``spark_rapids_jni_tpu/obs/history.py`` (plain Python; the port
keeps its own copy). A bounded ring of snapshots, so a new snapshot is
judged against a trailing baseline in O(ring):

- **Snapshots.** ``record_snapshot`` writes one ``{"t", "source",
  "counters", "gauges", "slo"}`` record under ``SRT_OBS_HISTORY_DIR``
  (default ``target/obs-history`` at the repository root, git-ignored)
  as ``snap_<ms>_<pid>_<seq>.json``, atomically (tmp + ``os.replace``),
  and prunes the ring to ``SRT_OBS_HISTORY_MAX`` files oldest first.
  ``maybe_record`` is the rate-limited gate (``SRT_OBS_HISTORY=1``, at
  most one a ``SRT_OBS_HISTORY_MIN_INTERVAL_S``). Corrupt snapshots are
  skipped on read, counted ``obs.history.corrupt_skipped``.
- **Bench ingestion.** ``ingest_records`` folds ``BENCH_*.json`` /
  ``MULTICHIP_*.json`` records into the ring (source ``bench`` /
  ``multichip``).
- **Regression watch.** ``regression_watch`` compares the newest
  snapshot with the mean of the trailing ``SRT_OBS_HISTORY_BASELINE``:
  p99 drift beyond ``SRT_OBS_HISTORY_P99_FACTOR`` a SLO key, fallback
  counter rate spikes (per-snapshot deltas of the
  ``FALLBACK_COUNTER_MARKS`` families) and the page pool's occupancy
  collapse (``mem.pool.utilization_pct`` below
  ``SRT_OBS_HISTORY_COLLAPSE_FACTOR`` x baseline). A clean window flags
  nothing. ``render_watch`` prints the findings; the fleet rollup serves
  them at ``/fleet/regressions``.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Optional

from ..config import env_bool, env_float, env_int, env_str
from .metrics import count
from .report import is_fallback_counter

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "target", "obs-history")
DEFAULT_MAX_SNAPSHOTS = 512
DEFAULT_MIN_INTERVAL_S = 10.0
DEFAULT_BASELINE_N = 8
DEFAULT_P99_FACTOR = 1.5
DEFAULT_RATE_FACTOR = 3.0
DEFAULT_COLLAPSE_FACTOR = 0.5

# gauges whose collapse (not growth) is the regression — the ragged
# paged route's occupancy story (exec/pages.py)
OCCUPANCY_GAUGES = ("mem.pool.utilization_pct",)

_lock = threading.Lock()
_seq = 0  # guarded-by: _lock
_last_record_monotonic: Optional[float] = None  # guarded-by: _lock


def history_dir() -> str:
    return env_str("SRT_OBS_HISTORY_DIR", DEFAULT_DIR)


def _max_snapshots() -> int:
    return max(1, env_int("SRT_OBS_HISTORY_MAX",
                          DEFAULT_MAX_SNAPSHOTS))


def record_snapshot(counters: Optional[dict] = None,
                    gauges: Optional[dict] = None,
                    slo: Optional[dict] = None,
                    source: str = "process",
                    extra: Optional[dict] = None,
                    directory: Optional[str] = None) -> Optional[str]:
    """Persist one snapshot atomically and prune the ring; returns the
    path, or None when the write failed (counted
    ``obs.history.write_errors`` — history is advisory, it never
    raises into whoever sampled it)."""
    global _seq
    directory = directory or history_dir()
    with _lock:
        _seq += 1
        seq = _seq
    body = {
        "t": time.time(),
        "source": source,
        "counters": dict(counters or {}),
        "gauges": dict(gauges or {}),
        "slo": dict(slo or {}),
    }
    if extra:
        body["extra"] = dict(extra)
    name = f"snap_{int(body['t'] * 1e3):013d}_{os.getpid()}_{seq:04d}"
    path = os.path.join(directory, name + ".json")
    tmp = path + ".tmp"
    try:
        os.makedirs(directory, exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(body, f)
        os.replace(tmp, path)  # atomic: readers never see a torn file
    except OSError:
        count("obs.history.write_errors")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    count("obs.history.snapshots")
    _prune(directory)
    return path


def _prune(directory: str) -> None:
    try:
        snaps = sorted(glob.glob(os.path.join(directory,
                                              "snap_*.json")))
        excess = len(snaps) - _max_snapshots()
        for path in snaps[:max(0, excess)]:
            os.unlink(path)
            count("obs.history.pruned")
    except OSError:
        count("obs.history.write_errors")


def maybe_record(counters: Optional[dict] = None,
                 gauges: Optional[dict] = None,
                 slo: Optional[dict] = None,
                 source: str = "process") -> Optional[str]:
    """The rate-limited gate periodic callers (the rollup's scrape
    path) use: records only when ``SRT_OBS_HISTORY`` is on AND at
    least ``SRT_OBS_HISTORY_MIN_INTERVAL_S`` passed since the last
    record from this process."""
    global _last_record_monotonic
    if not env_bool("SRT_OBS_HISTORY", False):
        return None
    min_interval = env_float("SRT_OBS_HISTORY_MIN_INTERVAL_S",
                             DEFAULT_MIN_INTERVAL_S)
    now = time.monotonic()
    with _lock:
        if _last_record_monotonic is not None \
                and now - _last_record_monotonic < min_interval:
            return None
        _last_record_monotonic = now
    return record_snapshot(counters=counters, gauges=gauges, slo=slo,
                           source=source)


def load_snapshots(directory: Optional[str] = None) -> list:
    """Every readable snapshot, oldest first. Corrupt files are
    skipped-and-counted (``obs.history.corrupt_skipped``) — one torn
    or truncated record must not blind the whole watch."""
    directory = directory or history_dir()
    out = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              "snap_*.json"))):
        try:
            with open(path, "r", encoding="utf-8") as f:
                body = json.load(f)
            if not isinstance(body, dict) or "t" not in body:
                raise ValueError("not a snapshot")
        except (OSError, ValueError):
            count("obs.history.corrupt_skipped")
            continue
        out.append(body)
    out.sort(key=lambda s: s.get("t", 0))
    return out


def ingest_records(paths, directory: Optional[str] = None) -> int:
    """Fold ``BENCH_*.json`` / ``MULTICHIP_*.json`` perf records into
    the ring as snapshots (source ``bench`` / ``multichip``); returns
    how many were ingested. Unreadable records are counted-skipped."""
    n = 0
    for path in paths:
        base = os.path.basename(path)
        try:
            with open(path, "r", encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            count("obs.history.corrupt_skipped")
            continue
        gauges: dict = {}
        source = "bench"
        if base.startswith("MULTICHIP"):
            source = "multichip"
            gauges["multichip.ok"] = 1 if rec.get("ok") else 0
            if rec.get("n_devices") is not None:
                gauges["multichip.n_devices"] = rec["n_devices"]
        else:
            parsed = rec.get("parsed") or {}
            metric = parsed.get("metric")
            if metric and parsed.get("value") is not None:
                gauges[f"bench.{metric}"] = parsed["value"]
            if parsed.get("vs_baseline") is not None:
                gauges["bench.vs_baseline"] = parsed["vs_baseline"]
        if record_snapshot(gauges=gauges, source=source,
                           extra={"record": base},
                           directory=directory) is not None:
            count("obs.history.ingested")
            n += 1
    return n


# ---------------------------------------------------------------------------
# The regression watch
# ---------------------------------------------------------------------------


def _counter_deltas(snaps: list) -> list:
    """Per-snapshot counter deltas for consecutive same-source pairs —
    cumulative counters only regress by RATE, and mixing sources
    (fleet vs bench) would fabricate giant negative/positive deltas."""
    deltas = []
    prev: Optional[dict] = None
    for s in snaps:
        if s.get("source") in ("bench", "multichip"):
            continue
        cur = s.get("counters") or {}
        if prev is not None:
            deltas.append({k: cur.get(k, 0) - prev.get(k, 0)
                           for k in set(cur) | set(prev)})
        prev = cur
    return deltas


def regression_watch(snapshots: Optional[list] = None,
                     directory: Optional[str] = None,
                     baseline_n: Optional[int] = None,
                     p99_factor: Optional[float] = None,
                     rate_factor: Optional[float] = None,
                     collapse_factor: Optional[float] = None) -> list:
    """Judge the newest snapshot against the trailing baseline;
    returns a list of finding dicts (empty = clean). Every finding
    carries ``kind``, ``key``, ``head``, ``baseline`` and ``why`` so
    the CLI and ``/fleet/regressions`` render without re-deriving."""
    if snapshots is None:
        snapshots = load_snapshots(directory)
    if baseline_n is None:
        baseline_n = env_int("SRT_OBS_HISTORY_BASELINE",
                             DEFAULT_BASELINE_N)
    if p99_factor is None:
        p99_factor = env_float("SRT_OBS_HISTORY_P99_FACTOR",
                               DEFAULT_P99_FACTOR)
    if rate_factor is None:
        rate_factor = env_float("SRT_OBS_HISTORY_RATE_FACTOR",
                                DEFAULT_RATE_FACTOR)
    if collapse_factor is None:
        collapse_factor = env_float("SRT_OBS_HISTORY_COLLAPSE_FACTOR",
                                    DEFAULT_COLLAPSE_FACTOR)
    count("obs.history.watch_runs")
    metric_snaps = [s for s in snapshots
                    if s.get("source") not in ("bench", "multichip")]
    if len(metric_snaps) < 3:
        return []  # nothing to baseline against
    head = metric_snaps[-1]
    base = metric_snaps[-1 - max(2, baseline_n):-1]
    findings: list = []

    # 1. p99 drift per SLO key
    head_slo = head.get("slo") or {}
    for key, q in head_slo.items():
        head_p99 = (q or {}).get("p99_ns", 0)
        if not head_p99 or (q or {}).get("count", 0) <= 0:
            continue
        base_vals = [s["slo"][key]["p99_ns"] for s in base
                     if (s.get("slo") or {}).get(key, {}).get("p99_ns")]
        if len(base_vals) < 2:
            continue
        base_mean = sum(base_vals) / len(base_vals)
        if base_mean > 0 and head_p99 > p99_factor * base_mean:
            findings.append({
                "kind": "p99_drift", "key": key,
                "head": head_p99, "baseline": base_mean,
                "why": f"p99 {head_p99 / 1e6:.2f} ms > "
                       f"{p99_factor:.2f}x trailing mean "
                       f"{base_mean / 1e6:.2f} ms"})

    # 2. fallback/degradation counter rate spikes
    deltas = _counter_deltas(metric_snaps)
    if len(deltas) >= 2:
        head_d, base_d = deltas[-1], deltas[:-1][-max(2, baseline_n):]
        names = {k for d in deltas for k in d if is_fallback_counter(k)}
        for name in sorted(names):
            hd = head_d.get(name, 0)
            if hd <= 0:
                continue
            bvals = [d.get(name, 0) for d in base_d]
            bmean = sum(bvals) / len(bvals) if bvals else 0.0
            # a clean baseline (all-zero deltas) makes ANY head
            # increment a spike; a noisy baseline needs rate_factor x
            if hd > rate_factor * bmean:
                findings.append({
                    "kind": "fallback_rate_spike", "key": name,
                    "head": hd, "baseline": bmean,
                    "why": f"+{hd} this snapshot vs trailing mean "
                           f"{bmean:.2f}/snapshot"})

    # 3. ragged-route occupancy collapse
    for gname in OCCUPANCY_GAUGES:
        hv = (head.get("gauges") or {}).get(gname)
        if hv is None:
            continue
        bvals = [s["gauges"][gname] for s in base
                 if gname in (s.get("gauges") or {})]
        if len(bvals) < 2:
            continue
        bmean = sum(bvals) / len(bvals)
        if bmean > 0 and hv < collapse_factor * bmean:
            findings.append({
                "kind": "occupancy_collapse", "key": gname,
                "head": hv, "baseline": bmean,
                "why": f"{gname} {hv:.1f} < "
                       f"{collapse_factor:.2f}x trailing mean "
                       f"{bmean:.1f}"})

    if findings:
        count("obs.history.regressions", len(findings))
    return findings


def render_watch(findings: list) -> str:
    """Human-readable regression table."""
    if not findings:
        return "regression watch: clean (no drift vs trailing baseline)"
    lines = [f"regression watch: {len(findings)} finding(s)"]
    for f in findings:
        lines.append(f"  [{f['kind']}] {f['key']}: {f['why']}")
    return "\n".join(lines)


def reset_history() -> None:
    """Forget the rate-limit latch (test harness; on-disk snapshots
    are the caller's to clean). The file sequence is kept: restarting
    it let a record in the same millisecond overwrite an earlier one."""
    global _last_record_monotonic
    with _lock:
        _last_record_monotonic = None
