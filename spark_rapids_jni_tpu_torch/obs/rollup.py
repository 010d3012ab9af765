"""Fleet rollup: a scrape-and-merge tier over N per-process obs servers.

Port of ``spark_rapids_jni_tpu/obs/rollup.py`` (plain Python; the port
keeps its own copy). Each process's scrape endpoint (``obs/server.py``)
speaks for itself; this tier scrapes every member's ``/metrics`` and
``/slo.json`` and serves the merged view:

- ``/fleet/metrics``: one Prometheus exposition. Counters sum across
  members, gauges are re-emitted per member (``{member="host:port"}``)
  with ``_min``/``_max``/``_sum`` rollups, histograms merge bucket-wise
  over the union of bounds (:func:`merge_histograms`, monotone by
  construction), and the fleet SLO quantiles (``fleet.slo.*``) come from
  the merged raw sketch vectors (``obs/slo.merge_sketches``).
- ``/fleet/metrics.json``: the same merge as JSON.
- ``/fleet/reports``: every member's recent reports and flight events,
  optionally narrowed to one query id (``?qid=``).
- ``/fleet/healthz``: 200 while at least ``SRT_FLEET_HEALTH_QUORUM``
  members (default all) answer their own ``/healthz`` with 200.
- ``/fleet/regressions``: the regression watch (``obs/history.py``) over
  the snapshot ring; each scrape also offers a snapshot to
  ``history.maybe_record``.

Member scrapes retry with full-jitter backoff
(``serving/reliability.full_jitter_backoff_s``) and never raise: an
unreachable member is "down", counted ``obs.rollup.member_down``; a
malformed exposition is refused by the strict ``parse_prometheus``,
counted ``obs.rollup.parse_errors``. The rollup holds no scheduler
state: it runs inside a member or as its own process
(``SRT_FLEET_HTTP_PORT`` and ``SRT_FLEET_MEMBERS``,
:func:`maybe_start_from_env`).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..config import env_float, env_int, env_str
from . import slo as _slo
from .metrics import REGISTRY, count, gauge, parse_prometheus

DEFAULT_SCRAPE_TIMEOUT_S = 2.0
DEFAULT_SCRAPE_RETRIES = 2
DEFAULT_SCRAPE_BACKOFF_MS = 50.0

_TYPE_LINE = re.compile(r"^#\s*TYPE\s+(?P<name>\S+)\s+(?P<type>\S+)\s*$")
_SAMPLE_KEY = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>[^}]*)\})?$")
_LE_LABEL = re.compile(r'le="(?P<le>[^"]*)"')


def _fleet_members() -> "list[str]":
    raw = env_str("SRT_FLEET_MEMBERS", "")
    return [m.strip() for m in raw.split(",") if m.strip()]


def _http_fetch(url: str, timeout: float) -> "tuple[int, str]":
    """Default fetcher (tests inject fakes via ``FleetRollup(fetch=)``).
    HTTP error statuses are RESULTS (a member's /healthz 503 is an
    answer, not a scrape failure); only transport errors raise."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.getcode(), r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        body = e.read().decode("utf-8", "replace")
        e.close()
        return e.code, body


# ---------------------------------------------------------------------------
# Merge math (pure functions — the unit-tested core)
# ---------------------------------------------------------------------------


def parse_exposition(text: str) -> dict:
    """Split one member's ``/metrics`` text into typed families:
    ``{"counters": {pn: v}, "gauges": {pn: v}, "histograms":
    {pn: {"buckets": [(le_str, cum)], "sum": s, "count": n}}}``.
    Values go through the strict :func:`parse_prometheus`; the ``#
    TYPE`` comments drive classification, so an untyped sample is a
    ``ValueError`` (this tier merges only what it understands)."""
    types: Dict[str, str] = {}
    for line in text.splitlines():
        m = _TYPE_LINE.match(line)
        if m:
            types[m.group("name")] = m.group("type")
    samples = parse_prometheus(text)
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for key, value in samples.items():
        km = _SAMPLE_KEY.match(key)
        if km is None:
            raise ValueError(f"unmergeable sample key {key!r}")
        name, labels = km.group("name"), km.group("labels")
        if name in types:
            t = types[name]
            if t == "counter":
                out["counters"][name] = value
            elif t == "gauge":
                out["gauges"][name] = value
            elif t == "histogram":
                # a histogram sample named exactly like its family
                # would be malformed; the suffixed forms are handled
                # below via their base name
                raise ValueError(
                    f"bare sample {key!r} for histogram {name}")
            else:
                raise ValueError(f"unknown TYPE {t!r} for {name}")
            continue
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) \
                    and types.get(name[: -len(suffix)]) == "histogram":
                base = name[: -len(suffix)]
                break
        if base is None:
            raise ValueError(f"untyped sample {key!r}")
        h = out["histograms"].setdefault(
            base, {"buckets": [], "sum": 0.0, "count": 0})
        if name.endswith("_sum"):
            h["sum"] = value
        elif name.endswith("_count"):
            h["count"] = int(value)
        else:
            lm = _LE_LABEL.search(labels or "")
            if lm is None:
                raise ValueError(f"bucket sample without le: {key!r}")
            h["buckets"].append((lm.group("le"), int(value)))
    return out


def _le_value(le_str: str) -> float:
    return float("inf") if le_str == "+Inf" else float(le_str)


def merge_histograms(members: "list[dict]") -> dict:
    """Merge per-member histogram snapshots bucket-wise over the UNION
    of their bounds. Each member's cumulative bucket run is a step
    function of ``le``; the fleet's cumulative count at a bound is the
    sum of every member's step evaluated there (the largest member
    bound <= the query bound — counts between two member bounds cannot
    be attributed below the upper one, so the merge is conservative
    and, critically, MONOTONE: each member's step function is
    non-decreasing, and a sum of non-decreasing functions is
    non-decreasing). Identities hold by construction: one member
    merges to itself, zero members to an empty histogram."""
    if not members:
        return {"buckets": [], "sum": 0.0, "count": 0}
    le_strs: Dict[float, str] = {}
    steps = []
    total_sum = 0.0
    total_count = 0
    for h in members:
        for le, _cum in h["buckets"]:
            le_strs.setdefault(_le_value(le), le)
        steps.append(sorted(((_le_value(le), int(cum))
                             for le, cum in h["buckets"]),
                            key=lambda b: b[0]))
        total_sum += float(h.get("sum", 0.0))
        total_count += int(h.get("count", 0))

    def step_at(bounds, le: float) -> int:
        cum = 0
        for v, c in bounds:
            if v <= le:
                cum = c
            else:
                break
        return cum

    union = sorted(v for v in le_strs if v != float("inf"))
    merged = []
    for v in union:
        merged.append((le_strs[v], sum(step_at(b, v) for b in steps)))
    merged.append(("+Inf", total_count))
    return {"buckets": merged, "sum": total_sum, "count": total_count}


def merge_expositions(parsed: "dict[str, dict]") -> dict:
    """Merge N members' :func:`parse_exposition` outputs:
    counters sum; gauges keep every per-member value plus
    min/max/sum rollups; histograms go through
    :func:`merge_histograms`."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, dict] = {}
    hist_members: Dict[str, list] = {}
    for member in sorted(parsed):
        p = parsed[member]
        for name, v in p["counters"].items():
            counters[name] = counters.get(name, 0) + v
        for name, v in p["gauges"].items():
            g = gauges.setdefault(
                name, {"members": {}, "min": v, "max": v, "sum": 0.0})
            g["members"][member] = v
            g["min"] = min(g["min"], v)
            g["max"] = max(g["max"], v)
            g["sum"] += v
        for name, h in p["histograms"].items():
            hist_members.setdefault(name, []).append(h)
    histograms = {name: merge_histograms(hs)
                  for name, hs in hist_members.items()}
    return {"counters": counters, "gauges": gauges,
            "histograms": histograms}


def _fmt_num(v: float) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


def render_fleet_prometheus(merged: dict) -> str:
    """Render one merged structure back to Prometheus text — the same
    grammar the member servers emit (``parse_prometheus`` round-trips
    it)."""
    lines: list = []
    for name in sorted(merged["counters"]):
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt_num(merged['counters'][name])}")
    for name in sorted(merged["gauges"]):
        g = merged["gauges"][name]
        lines.append(f"# TYPE {name} gauge")
        for member in sorted(g["members"]):
            lines.append(f'{name}{{member="{member}"}} '
                         f"{_fmt_num(g['members'][member])}")
        for agg in ("min", "max", "sum"):
            lines.append(f"# TYPE {name}_{agg} gauge")
            lines.append(f"{name}_{agg} {_fmt_num(g[agg])}")
    for name in sorted(merged["histograms"]):
        h = merged["histograms"][name]
        lines.append(f"# TYPE {name} histogram")
        for le, cum in h["buckets"]:
            lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
        lines.append(f"{name}_sum {_fmt_num(h['sum'])}")
        lines.append(f"{name}_count {h['count']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The rollup server
# ---------------------------------------------------------------------------


class FleetRollup:
    """One rollup endpoint over ``members`` (``host:port`` of each
    per-process obs server). ``fetch`` is the transport seam the tests
    and the merge-math suite inject fakes through; the default is a
    stdlib urllib GET."""

    def __init__(self, members, port: int = 0,
                 host: Optional[str] = None,
                 quorum: Optional[int] = None,
                 fetch: Optional[Callable] = None):
        self.members = [str(m) for m in members]
        self._quorum = quorum
        self._fetch = fetch or _http_fetch
        self._slo_lock = threading.Lock()
        # fleet.slo.* gauge names set by the previous merge — names
        # absent from the next one are zeroed, the TRACKER.publish
        # discipline (a quiet fleet must not scrape stale quantiles)
        self._published_slo: "set[str]" = set()  # guarded-by: self._slo_lock
        if host is None:
            host = env_str("SRT_FLEET_HTTP_HOST", "127.0.0.1")
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "srt-fleet"

            def log_message(self, *args):
                pass

            def do_GET(self):
                try:
                    outer._route(self)
                except ConnectionError:
                    count("obs.rollup.http_client_aborts")

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"srt-fleet-http-{self.port}", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    def quorum(self) -> int:
        if self._quorum is not None:
            return int(self._quorum)
        return env_int("SRT_FLEET_HEALTH_QUORUM", len(self.members))

    # -- scraping ----------------------------------------------------------

    def _scrape(self, member: str, path: str) -> "Optional[tuple[int, str]]":
        """One member GET with bounded full-jitter retries; None after
        the budget is spent (the member is down for this scrape).
        NEVER raises — this runs inside the serving path of every
        /fleet/* request."""
        retries = env_int("SRT_FLEET_SCRAPE_RETRIES",
                          DEFAULT_SCRAPE_RETRIES)
        timeout = env_float("SRT_FLEET_SCRAPE_TIMEOUT_S",
                            DEFAULT_SCRAPE_TIMEOUT_S)
        backoff_ms = env_float("SRT_FLEET_SCRAPE_BACKOFF_MS",
                               DEFAULT_SCRAPE_BACKOFF_MS)
        # lazy: the obs layer stays importable without the serving stack
        from ..serving.reliability import full_jitter_backoff_s
        for attempt in range(1, max(1, retries + 1) + 1):
            try:
                return self._fetch(f"http://{member}{path}", timeout)
            except Exception:
                count("obs.rollup.scrape_errors")
                if attempt <= retries:
                    time.sleep(full_jitter_backoff_s(
                        attempt, base_ms=backoff_ms))
        return None

    def collect(self) -> dict:
        """Scrape every member's metrics + SLO sketches and merge.
        Returns ``{"merged": ..., "slo": ..., "members": {m: "up" |
        "down" | "parse_error"}}``; down/garbled members are counted
        and EXCLUDED from the merge rather than failing it."""
        count("obs.rollup.scrapes")
        parsed: Dict[str, dict] = {}
        sketches = []
        states: Dict[str, str] = {}
        for member in self.members:
            got = self._scrape(member, "/metrics")
            if got is None or got[0] != 200:
                states[member] = "down"
                count("obs.rollup.member_down")
                continue
            try:
                parsed[member] = parse_exposition(got[1])
            except ValueError:
                states[member] = "parse_error"
                count("obs.rollup.parse_errors")
                continue
            states[member] = "up"
            got_slo = self._scrape(member, "/slo.json")
            if got_slo is not None and got_slo[0] == 200:
                try:
                    sketches.append(json.loads(got_slo[1]))
                except ValueError:
                    count("obs.rollup.parse_errors")
        merged = merge_expositions(parsed)
        slo = _slo.merge_sketches(sketches)
        up = sum(1 for s in states.values() if s == "up")
        gauge("fleet.members").set(len(self.members))
        gauge("fleet.members_up").set(up)
        self._publish_fleet_slo(slo)
        # the periodic history snapshot rides scrape traffic (gated and
        # rate-limited inside history.maybe_record)
        from . import history as _history
        _history.maybe_record(
            counters=merged["counters"],
            gauges={n: g["sum"] for n, g in merged["gauges"].items()},
            slo={key: _slo.sketch_quantiles(h)
                 for key, h in slo["hists"].items()},
            source="fleet")
        return {"merged": merged, "slo": slo, "members": states,
                "up": up}

    def _publish_fleet_slo(self, slo: dict) -> None:
        """Fleet-level quantiles from the merged sketches, as
        ``fleet.slo.<tenant>.p<prio>.<kind>.*`` gauges in the rollup's
        OWN registry (rendered into /fleet/metrics alongside the
        member merge)."""
        with self._slo_lock:
            published: "set[str]" = set()
            for key, h in slo["hists"].items():
                try:
                    tenant, prio, kind = key.split("|", 2)
                except ValueError:
                    continue
                q = _slo.sketch_quantiles(h)
                base = f"fleet.slo.{tenant}.p{prio}.{kind}"
                for name in ("p50_ns", "p90_ns", "p99_ns", "count",
                             "mean_ns"):
                    gname = f"{base}.{name}"
                    gauge(gname).set(q[name])
                    published.add(gname)
            for key, n in slo["events"].items():
                try:
                    tenant, prio, event = key.split("|", 2)
                except ValueError:
                    continue
                gname = f"fleet.slo.{tenant}.p{prio}.{event}_total"
                gauge(gname).set(n)
                published.add(gname)
            for gname in self._published_slo - published:
                gauge(gname).set(0)
            self._published_slo = published

    def _own_families_text(self) -> str:
        """The rollup's own ``fleet.*`` / ``obs.rollup.*`` families
        rendered from the LOCAL registry. Filtered by family — when the
        rollup runs inside a member process, re-emitting the whole
        local registry here would double-merge that member's metrics."""
        snap = REGISTRY.to_json()
        from .metrics import prom_name
        lines: list = []
        for name in sorted(snap["counters"]):
            if name.startswith("obs.rollup."):
                pn = prom_name(name)
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {snap['counters'][name]}")
        for name in sorted(snap["gauges"]):
            if name.startswith(("fleet.", "obs.rollup.")):
                pn = prom_name(name)
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {_fmt_num(snap['gauges'][name])}")
        return "\n".join(lines) + "\n" if lines else ""

    # -- health ------------------------------------------------------------

    def health(self) -> "tuple[bool, dict]":
        """Quorum verdict: poll every member's own ``/healthz``; ok
        while at least ``quorum()`` answer 200."""
        states: Dict[str, dict] = {}
        healthy = 0
        for member in self.members:
            got = self._scrape(member, "/healthz")
            if got is None:
                states[member] = {"ok": False, "error": "unreachable"}
                count("obs.rollup.member_down")
                continue
            ok = got[0] == 200
            try:
                body = json.loads(got[1])
            except ValueError:
                body = {}
            states[member] = {"ok": ok,
                              "quarantined": body.get("quarantined")}
            if ok:
                healthy += 1
            else:
                count("obs.rollup.member_down")
        q = self.quorum()
        ok = healthy >= q
        return ok, {"ok": ok, "healthy": healthy, "quorum": q,
                    "members": states}

    # -- reports -----------------------------------------------------------

    @staticmethod
    def _matches_qid(entry: dict, qid: str) -> bool:
        if entry.get("qid") == qid:
            return True
        for field in ("batch_qids", "qids"):
            v = entry.get(field)
            if isinstance(v, (list, tuple)) and qid in v:
                return True
        return False

    def reports(self, qid: str = "", n: int = 64) -> dict:
        """Every member's recent reports + flight tail, optionally
        narrowed to one correlation id: the cross-process join of one
        query's trail."""
        members: Dict[str, dict] = {}
        for member in self.members:
            got = self._scrape(member, f"/reports?n={int(n)}")
            if got is None or got[0] != 200:
                members[member] = {"error": "unreachable"}
                count("obs.rollup.member_down")
                continue
            try:
                body = json.loads(got[1])
            except ValueError:
                members[member] = {"error": "parse_error"}
                count("obs.rollup.parse_errors")
                continue
            reports = body.get("reports", [])
            flight = body.get("flight", [])
            if qid:
                reports = [r for r in reports
                           if self._matches_qid(r, qid)]
                flight = [ev for ev in flight
                          if self._matches_qid(ev, qid)]
            members[member] = {"reports": reports, "flight": flight}
        return {"qid": qid, "members": members}

    # -- request routing ---------------------------------------------------

    def _route(self, handler: BaseHTTPRequestHandler) -> None:
        url = urlparse(handler.path)
        count("obs.rollup.http_requests")
        if url.path == "/fleet/metrics":
            snap = self.collect()
            text = render_fleet_prometheus(snap["merged"]) \
                + self._own_families_text()
            self._send(handler, 200, text,
                       "text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/fleet/metrics.json":
            snap = self.collect()
            self._send_json(handler, 200, {
                "members": snap["members"],
                "up": snap["up"],
                "counters": snap["merged"]["counters"],
                "gauges": snap["merged"]["gauges"],
                "histograms": snap["merged"]["histograms"],
                "slo": snap["slo"],
            })
        elif url.path == "/fleet/healthz":
            ok, body = self.health()
            self._send_json(handler, 200 if ok else 503, body)
        elif url.path == "/fleet/reports":
            qs = parse_qs(url.query)
            qid = (qs.get("qid", [""])[0]).strip()
            try:
                n = int(qs.get("n", ["64"])[0])
            except (ValueError, IndexError):
                n = 64
            self._send_json(handler, 200,
                            self.reports(qid=qid, n=max(1, n)))
        elif url.path == "/fleet/regressions":
            from . import history as _history
            try:
                findings = _history.regression_watch()
                self._send_json(handler, 200, {
                    "regressions": findings,
                    "flagged": len(findings)})
            except Exception:
                # the watch is advisory; a broken snapshot dir must
                # not 500 the fleet pane (counted, never silent)
                count("obs.rollup.regression_errors")
                self._send_json(handler, 200,
                                {"regressions": [],
                                 "error": "regression watch failed"})
        else:
            self._send_json(handler, 404, {
                "error": f"unknown path {url.path!r}",
                "paths": ["/fleet/metrics", "/fleet/metrics.json",
                          "/fleet/healthz", "/fleet/reports",
                          "/fleet/regressions"]})

    @staticmethod
    def _send(handler, status: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    def _send_json(self, handler, status: int, body: dict) -> None:
        self._send(handler, status, json.dumps(body, default=str),
                   "application/json")

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_lock = threading.Lock()
_rollup: Optional[FleetRollup] = None  # guarded-by: _lock


def current() -> "Optional[FleetRollup]":
    return _rollup


def start(members=None, port: Optional[int] = None,
          host: Optional[str] = None,
          quorum: Optional[int] = None) -> FleetRollup:
    """Start (or return) the process-wide rollup. ``members`` defaults
    to ``SRT_FLEET_MEMBERS`` (comma-separated ``host:port`` list);
    ``port`` to ``SRT_FLEET_HTTP_PORT`` (0 = ephemeral)."""
    global _rollup
    with _lock:
        if _rollup is not None:
            return _rollup
        if members is None:
            members = _fleet_members()
        if port is None:
            port = env_int("SRT_FLEET_HTTP_PORT", 0)
        _rollup = FleetRollup(members, port=port, host=host,
                              quorum=quorum)
        count("obs.rollup.server_starts")
        return _rollup


def maybe_start_from_env() -> "Optional[FleetRollup]":
    """Start the singleton iff ``SRT_FLEET_HTTP_PORT`` is set; a bind
    failure is counted and degraded to None (the obs-server
    discipline — a busy port must not fail the host process)."""
    if _rollup is not None:
        return _rollup
    v = env_str("SRT_FLEET_HTTP_PORT", "").strip()
    if not v:
        return None
    try:
        return start(port=int(v))
    except (OSError, ValueError):
        count("obs.rollup.server_errors")
        return None


def stop() -> None:
    global _rollup
    with _lock:
        srv, _rollup = _rollup, None
    if srv is not None:
        srv.stop()
