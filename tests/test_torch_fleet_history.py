"""The port's snapshot ring and regression watch (``obs/history.py``)
against the reference's (``tests/test_fleet_history.py``), on the CPU.

Each scenario runs through both packages on the same inputs: the ring
(atomic writes, pruning, corrupt files skipped and counted, failed
writes counted, the env gate and rate limit of ``maybe_record``), the
bench and multichip ingestion, and the regression watch (silent on a
clean window, p99 drift, fallback rate spikes, occupancy collapse, the
env factors, the rendering). Snapshots, findings, renderings and the
``obs.history.*`` counters must agree, and equal what the reference's
suite asserts.
"""

import copy
import json
import time

import pytest

from spark_rapids_jni_tpu import obs as r_obs
from spark_rapids_jni_tpu.obs import history as r_history

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.obs import history

SIDES = {"ref": (r_history, r_obs), "port": (history, obs)}
ENV = ("SRT_OBS_HISTORY", "SRT_OBS_HISTORY_MAX", "SRT_OBS_HISTORY_P99_FACTOR",
       "SRT_OBS_HISTORY_DIR", "SRT_OBS_HISTORY_MIN_INTERVAL_S")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for H, O in SIDES.values():
        O.reset_all()
        H.reset_history()
    yield
    for H, O in SIDES.values():
        O.reset_all()
        H.reset_history()


def _stats(O):
    return {k: v for k, v in O.kernel_stats().items()
            if k.startswith("obs.history.")}


def _strip(snaps):
    """Snapshots without their wall-clock stamp."""
    return [{k: v for k, v in s.items() if k != "t"} for s in snaps]


def _snap(t, counters=None, gauges=None, slo=None, source="process"):
    return {"t": t, "source": source, "counters": counters or {},
            "gauges": gauges or {}, "slo": slo or {}}


def _clean_window(n=6):
    return [_snap(100.0 + i,
                  counters={"exec.host_fallback": 2 * i,
                            "serving.submitted": 10 * i},
                  gauges={"mem.pool.utilization_pct": 80.0},
                  slo={"gold|10|e2e": {"p99_ns": 1_000_000, "count": 50}})
            for i in range(n)]


def sc_ring(H, O, tmp, mp):
    mp.setenv("SRT_OBS_HISTORY_MAX", "3")
    paths = [H.record_snapshot(counters={"c": i}, directory=str(tmp))
             for i in range(5)]
    snaps = H.load_snapshots(directory=str(tmp))
    out = [all(p is not None for p in paths), len(list(tmp.glob("*.tmp"))),
           _strip(snaps), _stats(O)]
    assert out[0] and out[1] == 0
    assert [s["counters"]["c"] for s in snaps] == [2, 3, 4]
    assert out[3]["obs.history.pruned"] == 2
    return out


def sc_corrupt(H, O, tmp, mp):
    H.record_snapshot(counters={"c": 1}, directory=str(tmp))
    (tmp / "snap_9999999999999_1_0001.json").write_text("{torn")
    (tmp / "snap_9999999999999_1_0002.json").write_text("[1,2]")
    out = [_strip(H.load_snapshots(directory=str(tmp))), _stats(O)]
    assert len(out[0]) == 1
    assert out[1]["obs.history.corrupt_skipped"] == 2
    return out


def sc_write_failure(H, O, tmp, mp):
    blocker = tmp / "not-a-dir"
    blocker.write_text("a file where the directory should go")
    out = [H.record_snapshot(counters={"c": 1}, directory=str(blocker)),
           _stats(O)]
    assert out[0] is None and out[1]["obs.history.write_errors"] >= 1
    return out


def sc_maybe_record(H, O, tmp, mp):
    mp.setenv("SRT_OBS_HISTORY_DIR", str(tmp))
    out = [H.maybe_record(counters={"c": 1}) is None]
    mp.setenv("SRT_OBS_HISTORY", "1")
    mp.setenv("SRT_OBS_HISTORY_MIN_INTERVAL_S", "3600")
    out += [H.maybe_record(counters={"c": 1}) is not None,
            H.maybe_record(counters={"c": 2}) is None]
    H.reset_history()
    # The reference restarts its file sequence on reset_history, so a
    # record in the same millisecond would overwrite the first one.
    time.sleep(0.002)
    out.append(H.maybe_record(counters={"c": 3}) is not None)
    out.append([s["counters"] for s in H.load_snapshots(str(tmp))])
    assert out[:4] == [True, True, True, True]
    return out


def sc_ingest(H, O, tmp, mp):
    (tmp / "BENCH_r01.json").write_text(json.dumps(
        {"parsed": {"metric": "speedup", "value": 2.5, "vs_baseline": 1.1}}))
    (tmp / "MULTICHIP_r01.json").write_text(json.dumps(
        {"ok": True, "n_devices": 8}))
    (tmp / "BENCH_bad.json").write_text("{nope")
    d = str(tmp / "ring")
    n = H.ingest_records([str(tmp / "BENCH_r01.json"),
                          str(tmp / "MULTICHIP_r01.json"),
                          str(tmp / "BENCH_bad.json")], directory=d)
    snaps = H.load_snapshots(directory=d)
    out = [n, sorted(map(json.dumps, _strip(snaps))), _stats(O),
           H.regression_watch(snapshots=snaps)]
    assert n == 2 and out[3] == []
    return out


def _p99_drift(w):
    w[-1]["slo"]["gold|10|e2e"] = {"p99_ns": 5_000_000, "count": 50}


def _rate_spike(w):
    w[-1]["counters"]["exec.host_fallback"] = \
        w[-2]["counters"]["exec.host_fallback"] + 50


def _clean_baseline_increment(w):
    for s in w:
        s["counters"]["exec.host_fallback"] = 0
    w[-1]["counters"]["exec.host_fallback"] = 1


def _collapse(w):
    w[-1]["gauges"]["mem.pool.utilization_pct"] = 20.0


WATCH = {
    "clean": (6, None, []),
    "too_few": (2, None, []),
    "p99_drift": (6, _p99_drift, ["p99_drift"]),
    "rate_spike": (6, _rate_spike, ["fallback_rate_spike"]),
    "clean_baseline_increment": (6, _clean_baseline_increment,
                                 ["fallback_rate_spike"]),
    "occupancy_collapse": (6, _collapse, ["occupancy_collapse"]),
}


def _watch(H, O, name):
    n, mutate, _ = WATCH[name]
    w = _clean_window(n)
    if mutate is not None:
        mutate(w)
    found = H.regression_watch(snapshots=copy.deepcopy(w))
    return [found, H.render_watch(found), _stats(O)]


SCENARIOS = {"ring": sc_ring, "corrupt": sc_corrupt,
             "write_failure": sc_write_failure,
             "maybe_record": sc_maybe_record, "ingest": sc_ingest}


def _side(fn, side, tmp_path, monkeypatch):
    H, O = SIDES[side]
    for k in ENV:  # each side starts from the same environment
        monkeypatch.delenv(k, raising=False)
    O.reset_all()
    H.reset_history()
    d = tmp_path / side
    d.mkdir()
    return fn(H, O, d, monkeypatch)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ring_matches_reference(name, tmp_path, monkeypatch):
    want = _side(SCENARIOS[name], "ref", tmp_path, monkeypatch)
    got = _side(SCENARIOS[name], "port", tmp_path, monkeypatch)
    assert got == want


@pytest.mark.parametrize("name", sorted(WATCH))
def test_watch_matches_reference(name):
    want = _watch(*SIDES["ref"], name)
    for O in (r_obs, obs):
        O.reset_all()
    got = _watch(*SIDES["port"], name)
    assert got == want
    assert [f["kind"] for f in got[0]] == WATCH[name][2]
    assert got[2]["obs.history.watch_runs"] == 1


def test_watch_factors_are_env_tunable(monkeypatch):
    w = _clean_window()
    w[-1]["slo"]["gold|10|e2e"] = {"p99_ns": 1_400_000, "count": 50}
    assert history.regression_watch(snapshots=w) == []
    monkeypatch.setenv("SRT_OBS_HISTORY_P99_FACTOR", "1.2")
    got = history.regression_watch(snapshots=w)
    assert got == r_history.regression_watch(snapshots=w)
    assert [f["kind"] for f in got] == ["p99_drift"]


def test_render_watch_clean_and_flagged():
    f = [{"kind": "p99_drift", "key": "k", "head": 1, "baseline": 2,
          "why": "because"}]
    assert history.render_watch([]) == r_history.render_watch([])
    assert history.render_watch(f) == r_history.render_watch(f)
    assert "[p99_drift] k: because" in history.render_watch(f)


def test_reset_all_forgets_the_rate_limit(tmp_path, monkeypatch):
    monkeypatch.setenv("SRT_OBS_HISTORY_DIR", str(tmp_path))
    monkeypatch.setenv("SRT_OBS_HISTORY", "1")
    monkeypatch.setenv("SRT_OBS_HISTORY_MIN_INTERVAL_S", "3600")
    assert history.maybe_record(counters={"c": 1}) is not None
    assert history.maybe_record(counters={"c": 2}) is None
    obs.reset_all()
    assert history.maybe_record(counters={"c": 3}) is not None


def test_reset_keeps_records_of_one_millisecond_apart(tmp_path):
    for c in range(3):
        history.reset_history()
        assert history.record_snapshot(counters={"c": c},
                                       directory=str(tmp_path)) is not None
    got = history.load_snapshots(str(tmp_path))
    assert sorted(s["counters"]["c"] for s in got) == [0, 1, 2]


def test_default_directory_is_the_repositorys_target():
    from pathlib import Path
    root = Path(history.__file__).resolve().parents[2]
    assert Path(history.DEFAULT_DIR) == root / "target" / "obs-history"
