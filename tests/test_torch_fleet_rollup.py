"""The port's fleet rollup (``obs/rollup.py``), ``/slo.json`` and the
SLO sketch merge against the reference's (``tests/test_fleet_rollup.py``),
on the CPU, over local HTTP only.

1. **Merge math, side by side**: ``parse_exposition``,
   ``merge_histograms``, ``merge_expositions``,
   ``render_fleet_prometheus``, ``merge_sketches`` and
   ``sketch_quantiles`` give the reference's results on the same inputs,
   and the reference suite's values.
2. **The port's own endpoints**: ``/metrics`` and ``/metrics.json``
   expose the same families, ``/slo.json`` the raw sketches; the merge
   holds under concurrent writers.
3. **The fleet endpoints** through the transport seam (quorum health,
   down and garbled members, the qid join, the env-gated singleton),
   and a rollup over two real scrape endpoints (this process's and a
   child process's) merging ``/slo.json`` and recording a history
   snapshot on the scrape.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from spark_rapids_jni_tpu.config import set_config as r_set_config
from spark_rapids_jni_tpu.obs import rollup as r_rollup
from spark_rapids_jni_tpu.obs import slo as r_slo

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.obs import history, rollup, server, slo
from spark_rapids_jni_tpu_torch.obs.rollup import (FleetRollup,
                                                   merge_expositions,
                                                   merge_histograms,
                                                   parse_exposition,
                                                   render_fleet_prometheus)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("SRT_METRICS", "1")
    for k in ("SRT_FLEET_HTTP_PORT", "SRT_FLEET_MEMBERS",
              "SRT_FLEET_HEALTH_QUORUM", "SRT_OBS_HISTORY"):
        monkeypatch.delenv(k, raising=False)
    obs.reset_all()
    r_set_config(metrics_enabled=True)
    yield
    r_set_config(metrics_enabled=False)
    obs.reset_all()


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=10)


# --------------------------------------------------------------------------
# 1. merge math, side by side
# --------------------------------------------------------------------------

EXPO = ("# TYPE srt_a counter\nsrt_a 3\n"
        "# TYPE srt_g gauge\nsrt_g 1.5\n"
        "# TYPE srt_h histogram\n"
        'srt_h_bucket{le="10"} 1\nsrt_h_bucket{le="+Inf"} 2\n'
        "srt_h_sum 11\nsrt_h_count 2\n")
HA = {"buckets": [("100", 1), ("1000", 4), ("+Inf", 6)], "sum": 5000.0,
      "count": 6}
HB = {"buckets": [("500", 2), ("2000", 3), ("+Inf", 3)], "sum": 2500.0,
      "count": 3}
PA = {"counters": {"srt_c": 3.0}, "gauges": {"srt_g": 1.0},
      "histograms": {"srt_h": {"buckets": [("10", 1), ("+Inf", 2)],
                               "sum": 15.0, "count": 2}}}
PB = {"counters": {"srt_c": 7.0, "srt_only_b": 1.0},
      "gauges": {"srt_g": 4.0},
      "histograms": {"srt_h": {"buckets": [("10", 3), ("+Inf", 3)],
                               "sum": 9.0, "count": 3}}}


def _sketch_exports(mod):
    """Two trackers' exports with the same samples on both packages."""
    outs = []
    for i, durs in enumerate(([3_000_000, 9_000_000], [70_000_000])):
        t = mod.SloTracker(window_s=60, n_windows=2,
                           _clock=lambda: 1000.0)
        for d in durs:
            t.record(mod.KIND_E2E, "gold", 10, d)
            t.record(mod.KIND_EXECUTE, "bronze", 0, d // 3)
        t.note(mod.EVENT_SERVED, "gold", 10)
        outs.append(t.export_sketches())
    return outs


CASES = {
    "parse_exposition": lambda m: m.parse_exposition(EXPO),
    "merge_histograms_unequal_bounds": lambda m: m.merge_histograms([HA, HB]),
    "merge_histograms_identity": lambda m: [m.merge_histograms([HA]),
                                            m.merge_histograms([])],
    "merge_expositions_empty": lambda m: m.merge_expositions({}),
    "merge_expositions_two": lambda m: m.merge_expositions(
        {"a:1": PA, "b:1": PB}),
    "render_roundtrip": lambda m: m.render_fleet_prometheus(
        m.merge_expositions({"a:1": PA, "b:1": PB})),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_math_matches_reference(name):
    assert CASES[name](rollup) == CASES[name](r_rollup)


def test_merge_values_are_the_reference_suites():
    m = merge_histograms([HA, HB])
    assert [le for le, _ in m["buckets"]] == ["100", "500", "1000", "2000",
                                              "+Inf"]
    assert dict(m["buckets"])["500"] == 3 and m["count"] == 9
    me = merge_expositions({"a:1": PA, "b:1": PB})
    assert me["counters"] == {"srt_c": 10.0, "srt_only_b": 1.0}
    samples = obs.parse_prometheus(render_fleet_prometheus(me))
    assert samples['srt_g{member="a:1"}'] == 1.0
    assert samples['srt_h_bucket{le="+Inf"}'] == 5
    with pytest.raises(ValueError):
        parse_exposition("srt_orphan 1\n")


def test_sketch_merge_matches_reference():
    mine, ref = _sketch_exports(slo), _sketch_exports(r_slo)
    for a, b in zip(mine, ref):
        assert {k: a[k] for k in ("n_buckets", "hists", "events")} == \
            {k: b[k] for k in ("n_buckets", "hists", "events")}
    got, want = slo.merge_sketches(mine), r_slo.merge_sketches(ref)
    assert got == want
    assert got["hists"]["gold|10|e2e"][slo.N_BUCKETS] == 3
    for key, h in got["hists"].items():
        assert slo.sketch_quantiles(h) == r_slo.sketch_quantiles(h)
    # a mixed-version export (another bucket grid) is skipped whole
    bad = dict(mine[0], n_buckets=slo.N_BUCKETS + 1)
    assert slo.merge_sketches([bad, mine[1]]) == \
        r_slo.merge_sketches([bad, ref[1]])
    assert slo.merge_sketches([]) == r_slo.merge_sketches([])


# --------------------------------------------------------------------------
# 2. the port's own endpoints
# --------------------------------------------------------------------------

def test_metrics_text_json_family_parity():
    obs.count("parity.hits", 3)
    obs.gauge("parity.depth").set(7)
    obs.histogram("parity.lat_ns").observe(12345)
    slo.record(slo.KIND_E2E, "gold", 10, 5_000_000)
    srv = server.ObsServer(0)
    try:
        with _get(srv.port, "/metrics") as r:
            text = r.read().decode()
        with _get(srv.port, "/metrics.json") as r:
            body = json.loads(r.read())
        with _get(srv.port, "/slo.json") as r:
            sketch = json.loads(r.read())
    finally:
        srv.stop()
    assert sketch["n_buckets"] == slo.N_BUCKETS
    assert sketch["hists"]["gold|10|e2e"][slo.N_BUCKETS] == 1
    typed = parse_exposition(text)

    def strip_labels(keys):
        return {k.split("{", 1)[0] for k in keys}

    assert strip_labels(typed["counters"]) == \
        {obs.prom_name(n) for n in body["counters"]}
    assert strip_labels(typed["gauges"]) == \
        {obs.prom_name(n) for n in body["gauges"]}
    assert set(typed["histograms"]) == \
        {obs.prom_name(n) for n in body["histograms"]}


def test_merge_under_concurrent_writers():
    stop = threading.Event()
    errors = []

    def writer(i):
        n = 0
        while not stop.is_set():
            obs.count(f"fleet.stress.calls_{i}")
            obs.gauge(f"fleet.stress.depth_{i}").set(n)
            obs.histogram("fleet.stress.lat_ns").observe(n * 1000 + 1)
            n += 1

    def scraper():
        while not stop.is_set():
            try:
                parsed = parse_exposition(obs.REGISTRY.to_prometheus())
                merged = merge_expositions({"a:1": parsed, "b:1": parsed})
                for h in merged["histograms"].values():
                    cums = [c for _, c in h["buckets"]]
                    assert cums == sorted(cums), cums
                obs.parse_prometheus(render_fleet_prometheus(merged))
            except Exception as e:
                errors.append(e)
                return

    threads = ([threading.Thread(target=writer, args=(i,)) for i in range(4)]
               + [threading.Thread(target=scraper) for _ in range(2)])
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errors, errors


# --------------------------------------------------------------------------
# 3. the fleet endpoints
# --------------------------------------------------------------------------

def _member_bodies(submitted: float, p99_ns: int = 4_000_000):
    t = slo.SloTracker()
    t.record(slo.KIND_E2E, "gold", 10, p99_ns)
    return {
        "/metrics": ("# TYPE srt_serving_submitted counter\n"
                     f"srt_serving_submitted {submitted}\n"
                     "# TYPE srt_queue_depth gauge\n"
                     f"srt_queue_depth {submitted}\n"),
        "/slo.json": json.dumps(t.export_sketches()),
        "/healthz": json.dumps({"ok": True}),
        "/reports": json.dumps({"reports": [], "flight": []}),
    }


class _FakeFleet:
    def __init__(self, members):
        self.bodies = {m: _member_bodies(i + 1.0)
                       for i, m in enumerate(members)}
        self.down = set()

    def fetch(self, url, timeout):
        member, _, path = url.split("://", 1)[1].partition("/")
        if member in self.down:
            raise ConnectionRefusedError(member)
        return 200, self.bodies[member]["/" + path.split("?")[0]]


@pytest.fixture()
def fleet(monkeypatch):
    monkeypatch.setenv("SRT_FLEET_SCRAPE_RETRIES", "0")
    members = ["m1:9", "m2:9"]
    fake = _FakeFleet(members)
    r = FleetRollup(members, port=0, fetch=fake.fetch)
    yield r, fake, members
    r.stop()


def test_fleet_metrics_merge_and_slo_over_http(fleet):
    r, fake, members = fleet
    with _get(r.port, "/fleet/metrics") as resp:
        assert resp.status == 200
        samples = obs.parse_prometheus(resp.read().decode())
    assert samples["srt_serving_submitted"] == 3
    assert samples['srt_queue_depth{member="m1:9"}'] == 1
    assert samples["srt_queue_depth_max"] == 2
    assert samples[obs.prom_name("fleet.members_up")] == 2
    assert samples[obs.prom_name("fleet.slo.gold.p10.e2e.count")] == 2
    with _get(r.port, "/fleet/metrics.json") as resp:
        body = json.loads(resp.read())
    assert body["up"] == 2
    assert body["slo"]["hists"]["gold|10|e2e"][slo.N_BUCKETS] == 2


def test_fleet_healthz_quorum_flip_counts_member_down(fleet, monkeypatch):
    r, fake, members = fleet
    with _get(r.port, "/fleet/healthz") as resp:
        assert json.loads(resp.read())["healthy"] == 2
    fake.down.add("m2:9")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(r.port, "/fleet/healthz")
    assert ei.value.code == 503
    body = json.loads(ei.value.read())
    assert body["healthy"] == 1 and body["quorum"] == 2
    assert body["members"]["m2:9"]["error"] == "unreachable"
    assert obs.kernel_stats()["obs.rollup.member_down"] >= 1
    monkeypatch.setenv("SRT_FLEET_HEALTH_QUORUM", "1")
    with _get(r.port, "/fleet/healthz") as resp:
        assert json.loads(resp.read())["quorum"] == 1


def test_collect_excludes_down_and_garbled_members(fleet):
    r, fake, members = fleet
    fake.down.add("m1:9")
    fake.bodies["m2:9"]["/metrics"] = "srt_untyped 1\n"
    snap = r.collect()
    assert snap["members"] == {"m1:9": "down", "m2:9": "parse_error"}
    assert snap["merged"]["counters"] == {}
    stats = obs.kernel_stats()
    assert stats["obs.rollup.scrape_errors"] >= 1
    assert stats["obs.rollup.parse_errors"] >= 1
    with _get(r.port, "/fleet/metrics") as resp:
        assert resp.status == 200


def test_fleet_reports_qid_join(fleet):
    r, fake, members = fleet
    qid = "q-aa-bbbb-1"
    fake.bodies["m1:9"]["/reports"] = json.dumps({
        "reports": [{"query": "q1", "qid": qid},
                    {"query": "q3", "qid": "q-other"}],
        "flight": [{"kind": "query_admitted", "qid": qid},
                   {"kind": "query_dispatch", "qids": [qid, "q-x"]},
                   {"kind": "noise"}]})
    fake.bodies["m2:9"]["/reports"] = json.dumps({
        "reports": [{"query": "q9", "batch_qids": [qid, "q-x"]}],
        "flight": []})
    with _get(r.port, f"/fleet/reports?qid={qid}") as resp:
        body = json.loads(resp.read())
    m1 = body["members"]["m1:9"]
    assert [d["query"] for d in m1["reports"]] == ["q1"]
    assert {e["kind"] for e in m1["flight"]} == {"query_admitted",
                                                 "query_dispatch"}
    assert [d["query"] for d in body["members"]["m2:9"]["reports"]] == ["q9"]


def test_rollup_singleton_env_gated(monkeypatch):
    assert rollup.maybe_start_from_env() is None
    monkeypatch.setenv("SRT_FLEET_HTTP_PORT", "0")
    monkeypatch.setenv("SRT_FLEET_MEMBERS", "127.0.0.1:1,127.0.0.1:2")
    s = rollup.maybe_start_from_env()
    try:
        assert s is not None and s.port > 0
        assert s.members == ["127.0.0.1:1", "127.0.0.1:2"]
        assert rollup.start() is s and rollup.current() is s
    finally:
        rollup.stop()
    assert rollup.current() is None


CHILD = """
import sys, time
sys.path.insert(0, sys.argv[1])
from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.obs import server, slo
obs.count("serving.submitted", 5)
for d in (2_000_000, 40_000_000):
    slo.record(slo.KIND_E2E, "gold", 10, d)
srv = server.start(0)
print(srv.port, flush=True)
sys.stdin.readline()
srv.stop()
"""


def test_rollup_over_two_real_scrape_endpoints(tmp_path, monkeypatch):
    """One member is this process's endpoint, the other a child
    process's: the counters sum, the sketches merge by buckets, and the
    scrape offers a snapshot to the history ring."""
    monkeypatch.setenv("SRT_OBS_HISTORY", "1")
    monkeypatch.setenv("SRT_OBS_HISTORY_DIR", str(tmp_path))
    monkeypatch.setenv("SRT_OBS_HISTORY_MIN_INTERVAL_S", "0")
    history.reset_history()
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(ROOT)], cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        port = int(child.stdout.readline())
        obs.count("serving.submitted", 2)
        slo.record(slo.KIND_E2E, "gold", 10, 9_000_000)
        mine = server.ObsServer(0)
        try:
            r = FleetRollup([f"127.0.0.1:{mine.port}", f"127.0.0.1:{port}"])
            try:
                snap = r.collect()
                with _get(r.port, "/fleet/metrics") as resp:
                    samples = obs.parse_prometheus(resp.read().decode())
            finally:
                r.stop()
        finally:
            mine.stop()
    finally:
        child.stdin.write("\n")
        child.stdin.close()
        child.wait(timeout=30)
    assert snap["up"] == 2
    assert snap["merged"]["counters"][obs.prom_name("serving.submitted")] \
        == 7
    merged = snap["slo"]["hists"]["gold|10|e2e"]
    assert merged[slo.N_BUCKETS] == 3
    assert slo.sketch_quantiles(merged)["p99_ns"] >= 40_000_000
    assert samples[obs.prom_name("fleet.slo.gold.p10.e2e.count")] == 3
    snaps = history.load_snapshots(str(tmp_path))
    assert snaps and snaps[-1]["source"] == "fleet"
    assert snaps[-1]["slo"]["gold|10|e2e"]["count"] == 3
