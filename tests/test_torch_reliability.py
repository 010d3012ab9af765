"""The port's reliability policy against the reference's
(``tests/test_reliability.py``, its cases without the fleet scheduler).

- the retry matrix: each exception class gets the reference's verdict
  (the port's ``RetryOOM``/``SplitAndRetryOOM`` live in
  ``utils/faults.py``, the reference's in its native bridge);
- full-jitter backoff bounds and ``RetryPolicy.from_env``, as the
  reference resolves them;
- ``QueryExpired``/``QueryPoisoned`` carry the reference's messages and
  fields;
- both fault seams fire in the in-core run, after the result cache's
  consult and before any device work: the faulted query raises, the next
  one runs; over a 2-rank gloo mesh every rank raises before any
  collective (no hang) and the next query equals the one-device result;
- the executor rejects only the faulted requests, counts them
  ``serving.failed``, and serves the next;
- ``free_for_retry`` runs on the CPU; ``annotate_reliability`` stamps the
  newest matching report.
"""

import os
import pickle
import random
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pandas as pd
import pytest

from spark_rapids_jni_tpu.native import RetryOOM as RefRetryOOM
from spark_rapids_jni_tpu.native import SplitAndRetryOOM as RefSplitOOM
from spark_rapids_jni_tpu.serving import reliability as ref_rel
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.utils import faults as ref_faults

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.obs import report as report_mod
from spark_rapids_jni_tpu_torch.serving import (QueryExecutor, QueryExpired,
                                                QueryPoisoned, RetryPolicy,
                                                reliability)
from spark_rapids_jni_tpu_torch.tpcds import PLANS
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused
from spark_rapids_jni_tpu_torch.utils import faults

from torch_native_support import (native_libraries,  # noqa: F401
                                  reference_native)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
T = 60


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("SRT_METRICS", "SRT_FAULTS", "SRT_QUERY_RETRIES",
              "SRT_RETRY_BACKOFF_MS", "SRT_QUERY_DEADLINE_MS"):
        monkeypatch.delenv(k, raising=False)
    obs.reset_all()
    faults.reset()
    yield
    faults.reset()
    obs.reset_all()


@pytest.fixture(scope="module")
def rels():
    data = ref_generate(sf=0.3, seed=23)
    return {k: rel_from_df(v, device=CPU) for k, v in data.items()}


class _Flagged(RuntimeError):
    retryable = True


# (port exception, the reference's counterpart)
MATRIX = [
    (lambda: faults.WorkerCrash("worker", "crash"),
     lambda: ref_faults.WorkerCrash("worker", "crash")),
    (lambda: faults.SplitAndRetryOOM("x"), lambda: RefSplitOOM("x")),
    (lambda: faults.RetryOOM("x"), lambda: RefRetryOOM("x")),
    (lambda: faults.InjectedFault("dispatch", "raise"),
     lambda: ref_faults.InjectedFault("dispatch", "raise")),
    (lambda: _Flagged("x"), lambda: _Flagged("x")),
    (lambda: ValueError("plan bug"), lambda: ValueError("plan bug")),
    (lambda: MemoryError(), lambda: MemoryError()),
]


@pytest.mark.parametrize("i", range(len(MATRIX)))
def test_retry_matrix_equals_reference(i):
    mine, ref = MATRIX[i]
    assert reliability.retry_action(mine()) == ref_rel.retry_action(ref())


def test_retry_matrix_verdicts():
    assert reliability.retry_action(faults.RetryOOM("x")) == "retry_oom"
    assert reliability.retry_action(faults.SplitAndRetryOOM("x")) == "split"
    assert reliability.retry_action(
        faults.InjectedFault("alloc", "raise")) == "retry"
    assert reliability.retry_action(
        faults.WorkerCrash("worker", "crash")) is None
    assert (reliability.ACTION_RETRY, reliability.ACTION_RETRY_OOM,
            reliability.ACTION_SPLIT) == (ref_rel.ACTION_RETRY,
                                          ref_rel.ACTION_RETRY_OOM,
                                          ref_rel.ACTION_SPLIT)


@pytest.mark.parametrize("attempt", [1, 2, 3, 5, 8, 12])
def test_backoff_bounds_equal_reference(attempt):
    base = 10.0
    raw = min(base * 2 ** (attempt - 1), reliability.BACKOFF_CAP_MS) / 1e3
    random.seed(attempt)
    mine = [reliability.full_jitter_backoff_s(attempt, base)
            for _ in range(200)]
    random.seed(attempt)
    ref = [ref_rel.full_jitter_backoff_s(attempt, base) for _ in range(200)]
    assert mine == ref
    assert all(0.5 * raw <= d <= raw for d in mine)
    assert reliability.full_jitter_backoff_s(attempt, 0) == 0.0


def test_retry_policy_env_resolution(monkeypatch):
    assert RetryPolicy.from_env() == RetryPolicy(2, 10.0, None)
    monkeypatch.setenv("SRT_QUERY_RETRIES", "5")
    monkeypatch.setenv("SRT_RETRY_BACKOFF_MS", "3.5")
    monkeypatch.setenv("SRT_QUERY_DEADLINE_MS", "250")
    mine = RetryPolicy.from_env()
    ref = ref_rel.RetryPolicy.from_env()
    assert (mine.max_retries, mine.backoff_ms, mine.deadline_ms) == (
        ref.max_retries, ref.backoff_ms, ref.deadline_ms) == (5, 3.5, 250.0)
    monkeypatch.setenv("SRT_QUERY_DEADLINE_MS", "0")
    assert RetryPolicy.from_env().deadline_ms is None
    assert RetryPolicy.from_env(max_retries=-3).max_retries == 0
    assert 0.0 < RetryPolicy(backoff_ms=4.0).backoff_s(2) <= 0.008


def test_query_expired_and_poisoned_match_reference():
    for mine, ref in ((QueryExpired("t", "q1", 0.0125),
                       ref_rel.QueryExpired("t", "q1", 0.0125)),
                      (QueryPoisoned("t", "q3", 2),
                       ref_rel.QueryPoisoned("t", "q3", 2))):
        assert str(mine) == str(ref)
        assert mine.tenant == ref.tenant and mine.query == ref.query
    assert QueryPoisoned("t", "q", 2).crashes == 2
    assert QueryExpired("t", "q", 1.0).late_by_s == 1.0
    assert reliability.QUARANTINE_CRASHES == ref_rel.QUARANTINE_CRASHES


def test_free_for_retry_on_the_cpu():
    reliability.free_for_retry(CPU)  # collects; no card to empty


@pytest.mark.parametrize("spec,exc", [("dispatch:raise:1",
                                       faults.InjectedFault),
                                      ("alloc:retry_oom:1", faults.RetryOOM),
                                      ("alloc:split_oom:1",
                                       faults.SplitAndRetryOOM)])
def test_in_core_seams_fire_before_device_work(spec, exc, rels):
    faults.configure(spec)
    before = obs.kernel_stats()
    with pytest.raises(exc):
        run_fused(PLANS["q1"], rels, device=CPU)
    d = obs.stats_since(before)
    seam, kind, _ = spec.split(":")
    assert d == {f"serving.fault.injected.{seam}.{kind}": 1}  # no dispatch
    assert faults.remaining() == {}
    out = run_fused(PLANS["q1"], rels, device=CPU)
    assert out.num_rows > 0


def test_result_cache_hit_passes_the_seams(rels, monkeypatch):
    from spark_rapids_jni_tpu_torch.serving import result_cache
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", str(1 << 26))
    result_cache.reset()
    try:
        from spark_rapids_jni_tpu_torch.tpcds import generate
        cached = {k: rel_from_df(v, device=CPU)
                  for k, v in generate(sf=0.3, seed=23).items()}
        run_fused(PLANS["q3"], cached, device=CPU)
        faults.configure("dispatch:raise:1")
        run_fused(PLANS["q3"], cached, device=CPU)  # a hit: no seam
        assert faults.remaining() == {("dispatch", "raise"): 1}
    finally:
        result_cache.reset()


def test_executor_rejects_only_the_faulted_requests(rels, monkeypatch):
    monkeypatch.setenv("SRT_METRICS", "1")
    faults.configure("dispatch:raise:1,alloc:retry_oom:1")
    with QueryExecutor(device=CPU) as ex:
        pend = [ex.submit(PLANS[q], rels) for q in ("q1", "q3", "q5")]
        errs = []
        for p in pend[:2]:
            with pytest.raises((faults.InjectedFault, faults.RetryOOM)) as e:
                p.result(timeout=T)
            errs.append(e.value)
        assert pend[2].result(timeout=T).num_rows > 0
    assert [reliability.retry_action(e) for e in errs] == ["retry",
                                                          "retry_oom"]
    stats = obs.kernel_stats()
    assert stats["serving.failed"] == 2 and stats["serving.completed"] == 1
    # only the served query emitted a report, under its own qid
    assert [r.qid for r in obs.recent_reports()] == [pend[2].qid]
    failed = [e for e in obs.flight_snapshot()["events"]
              if e["kind"] == "query_failed"]
    assert [(e["qid"], e["error"]) for e in failed] == [
        (pend[0].qid, "InjectedFault"), (pend[1].qid, "RetryOOM")]


def test_annotate_reliability_stamps_newest_matching_report():
    for q in ("q1", "q2", "q1"):
        report_mod.emit(report_mod.ExecutionReport(q, True, False, 1, 1, 5))
    report_mod.annotate_reliability("q1", {"attempts": 3})
    reps = obs.recent_reports()
    assert reps[2].reliability == {"attempts": 3}
    assert reps[0].reliability == {} and reps[1].reliability == {}
    report_mod.annotate_reliability("q9", {"attempts": 1})  # no match


MESH_WORKER = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)
    from spark_rapids_jni_tpu_torch.parallel import distributed, make_mesh
    from spark_rapids_jni_tpu_torch.tpcds import PLANS, generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused
    from spark_rapids_jni_tpu_torch.utils import faults

    rank, world, init, out = (int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5])
    distributed.initialize(init, world, rank, backend="gloo", timeout_s=60)
    mesh = make_mesh({"part": world}, device_type="cpu")
    data = generate(sf=0.3, seed=23)
    rels = {n: rel_from_df(df, device="cpu") for n, df in data.items()}
    res = {}
    for spec in ("dispatch:raise:1", "alloc:retry_oom:1"):
        faults.configure(spec)
        try:
            run_fused(PLANS["q3"], rels, mesh=mesh)
            res[spec] = None
        except Exception as e:
            res[spec] = type(e).__name__
    res["after"] = run_fused(PLANS["q3"], rels, mesh=mesh).to_df()
    res["single"] = run_fused(PLANS["q3"], rels, device="cpu").to_df()
    with open(os.path.join(out, f"r{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    distributed.shutdown()
""")


def test_mesh_seams_fire_on_every_rank_before_collectives(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(MESH_WORKER)
    env = dict(os.environ, SRT_BROADCAST_THRESHOLD="8192",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("SRT_FAULTS", None)
    procs = []
    for rank in range(2):
        log = open(tmp_path / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(script), str(ROOT), str(rank), "2",
             f"file://{tmp_path / 'init'}", str(tmp_path)], cwd=ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + 180
    rcs = []
    try:
        for p, _ in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0,
                                              deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()
    logs = "\n".join((tmp_path / f"rank{r}.log").read_text()[-2000:]
                     for r in range(2))
    assert rcs == [0, 0], logs
    for r in range(2):
        res = pickle.loads((tmp_path / f"r{r}.pkl").read_bytes())
        assert res["dispatch:raise:1"] == "InjectedFault"
        assert res["alloc:retry_oom:1"] == "RetryOOM"
        pd.testing.assert_frame_equal(res["after"], res["single"],
                                      check_exact=False, rtol=1e-9)


# ---------------------------------------------------------------------------
# native resource adaptor (``native.ra.*``), both libraries loaded on the CPU
# ---------------------------------------------------------------------------

def test_native_ra_snapshot_equals_reference(native_libraries,  # noqa: F811
                                             reference_native):  # noqa: F811
    """The same retry escalation in both libraries: the port's native
    binding raises ``utils/faults``' classes, ``retry_action`` maps them
    as the reference maps its own, and the ``native.ra.*`` snapshots (and
    their gauges) are equal."""
    from spark_rapids_jni_tpu.obs import report as ref_report
    nat, ref = native_libraries[0], reference_native
    actions = []
    try:
        for mod, rel, retry, split in (
                (nat, reliability, faults.RetryOOM, faults.SplitAndRetryOOM),
                (ref, ref_rel, RefRetryOOM, RefSplitOOM)):
            mod.ra_configure(1000)
            mod.ra_task_register(77)
            mod.ra_alloc(77, 800)
            for exc in (retry, split):
                with pytest.raises(exc) as e:
                    mod.ra_alloc(77, 800)
                actions.append(rel.retry_action(e.value))
        assert actions == ["retry_oom", "split", "retry_oom", "split"]
        snap = report_mod.native_ra_snapshot()
        assert snap == ref_report.native_ra_snapshot()
        assert snap["native.ra.in_use"] == 800
        assert snap["native.ra.task.retry_oom"] == 1
        assert snap["native.ra.task.split_retry_oom"] == 1
        assert obs.gauge("native.ra.in_use").value == 800
        rep = report_mod.ExecutionReport(
            query="q1", fused=True, cache_hit=False, dispatches=1,
            host_syncs=1, wall_ns=1, reliability=snap)
        assert "native.ra.task.retry_oom: 1" in rep.render()
    finally:
        nat.ra_task_done(77)
        ref.ra_task_done(77)
    assert report_mod.native_ra_snapshot()["native.ra.in_use"] == 0


def test_native_ra_snapshot_broken_read_is_counted(monkeypatch,
                                                   native_libraries):  # noqa: F811
    nat = native_libraries[0]

    def boom():
        raise RuntimeError("library half-loaded")

    monkeypatch.setattr(nat, "ra_stats", boom)
    before = obs.kernel_stats()
    assert report_mod.native_ra_snapshot() == {}
    assert obs.stats_since(before).get("obs.native_ra_errors") == 1
