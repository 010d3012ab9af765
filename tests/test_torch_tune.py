"""The port's tuner (``tune/``) and tuned tier (``config.tuned_*``)
against the reference's (``tests/test_tune.py``), on the CPU.

1. **Store**: winners persist atomically under
   ``SRT_AOT_CACHE_DIR/tuned/<revision>.json`` and a fresh resolution
   (and a fresh process) reloads them with one disk read and no
   measurement; a wrong-revision, stale-format or corrupt table reads as
   empty under the marked ``tune.store.tuned_stale`` counter;
   ``SRT_TUNE_DISABLE`` escapes a table; the table digest equals the
   reference's for the same winners; on 2 gloo ranks every rank ends on
   the first rank's table.
2. **Resolution**: env > tuned winner > default for every tuned read;
   tuned values re-key ``planner_env_key`` and the batch key.
3. **Runner**: the ladders are the reference's (``pallas`` named
   ``cuda``); the A/B loop measures every candidate through the real
   ``run_fused`` on the CPU, its winners' results equal the reference's
   q3, env-pinned knobs are skipped, mesh workloads without a process
   group are skipped, and the byte oracle is the reference's.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from spark_rapids_jni_tpu.tune import space as r_space
from spark_rapids_jni_tpu.tune import store as r_store
from spark_rapids_jni_tpu.tune.runner import bytes_equal as r_bytes_equal

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.config import (tuned_float, tuned_int,
                                               tuned_str)
from spark_rapids_jni_tpu_torch.tune import space, store
from spark_rapids_jni_tpu_torch.tune.runner import bytes_equal, tune

ROOT = Path(__file__).resolve().parents[1]
KNOBS = [s.knob for s in space.SPECS]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in KNOBS + ["SRT_AOT_CACHE_DIR", "SRT_TUNE_DISABLE",
                      "SRT_TUNE_WARMUP", "SRT_TUNE_SAMPLES",
                      "SRT_RESULT_CACHE_BYTES"]:
        monkeypatch.delenv(k, raising=False)
    store.reset_active_table_for_testing()
    obs.reset_all()
    yield
    store.reset_active_table_for_testing()
    r_store.reset_active_table_for_testing()


@pytest.fixture()
def tuned_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SRT_AOT_CACHE_DIR", str(tmp_path))
    store.reset_active_table_for_testing()
    return tmp_path


def _stats():
    return obs.kernel_stats()


# --------------------------------------------------------------------------
# 1. store
# --------------------------------------------------------------------------

def test_store_roundtrip_and_memoization(tuned_dir):
    winners = {"SRT_JOIN_METHOD": "xla", "SRT_DENSE_GROUPBY": "scatter"}
    assert store.store_table(winners, measurements={"SRT_JOIN_METHOD":
                                                    {"xla": 1}})
    path = store.table_path()
    assert path.startswith(str(tuned_dir / "tuned")) and os.path.exists(path)
    assert not list((tuned_dir / "tuned").glob("*.tmp.*"))
    store.reset_active_table_for_testing()
    before = _stats()
    assert store.active_table() == winners
    assert store.active_table() == winners
    delta = obs.stats_since(before)
    assert delta.get("tune.store.loads", 0) == 1
    assert delta.get("tune.store.tuned_stale", 0) == 0


def test_revision_names_torch_cuda_card_and_library():
    import torch
    from spark_rapids_jni_tpu_torch.ops.cuda_kernels import library_path
    key = store.revision_key()
    assert key[0] == torch.__version__ and key[1] == torch.version.cuda
    assert key[2] == library_path().stem
    assert key[3] == ("cpu" if not torch.cuda.is_available()
                      else torch.cuda.get_device_name(0))
    assert len(store.revision_digest()) == 32


def test_revision_mismatch_degrades_to_defaults(tuned_dir):
    path = store.table_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"format": store.TUNE_FORMAT_VERSION,
                   "revision": repr(("other-torch", "other-cuda")),
                   "winners": {"SRT_JOIN_METHOD": "xla"}}, f)
    before = _stats()
    assert store.active_table() == {}
    assert tuned_str("SRT_JOIN_METHOD", "auto") == "auto"
    assert obs.stats_since(before).get("tune.store.tuned_stale") == 1
    assert not os.path.exists(path)


@pytest.mark.parametrize("blob", ["not json at all",
                                  '{"format": 999, "winners": {}}',
                                  '{"format": 1, "winners": "nope"}',
                                  "[1, 2]"])
def test_corrupt_table_degrades_to_defaults(tuned_dir, blob):
    path = store.table_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Path(path).write_text(blob)
    before = _stats()
    assert store.active_table() == {}
    assert obs.stats_since(before).get("tune.store.tuned_stale") == 1


def test_tuned_stale_is_a_marked_fallback():
    from spark_rapids_jni_tpu.obs.report import is_fallback_counter as ref
    from spark_rapids_jni_tpu_torch.obs.report import is_fallback_counter
    assert is_fallback_counter("tune.store.tuned_stale")
    assert ref("tune.store.tuned_stale")


def test_disable_kill_switch(tuned_dir, monkeypatch):
    store.store_table({"SRT_JOIN_METHOD": "xla"})
    store.reset_active_table_for_testing()
    monkeypatch.setenv("SRT_TUNE_DISABLE", "1")
    assert store.active_table() == {}
    assert tuned_str("SRT_JOIN_METHOD", "auto") == "auto"
    assert store.active_table_digest() == "untuned"


def test_fresh_process_reloads_without_measurement(tuned_dir):
    assert store.store_table({"SRT_JOIN_METHOD": "xla"})
    code = textwrap.dedent("""
        from spark_rapids_jni_tpu_torch import obs
        from spark_rapids_jni_tpu_torch.config import tuned_str
        from spark_rapids_jni_tpu_torch.tune import store
        assert store.active_table() == {'SRT_JOIN_METHOD': 'xla'}
        assert tuned_str('SRT_JOIN_METHOD', 'auto') == 'xla'
        s = obs.kernel_stats()
        assert s.get('tune.store.loads', 0) == 1, s
        assert s.get('tune.measurements', 0) == 0, s
    """)
    env = dict(os.environ, SRT_AOT_CACHE_DIR=str(tuned_dir),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("table", [{}, {"A": "1", "B": "2"},
                                   {"SRT_JOIN_METHOD": "xla"}])
def test_table_digest_equals_reference(table):
    store.set_active_table(table)
    r_store.set_active_table(table)
    assert store.active_table_digest() == r_store.active_table_digest()
    assert (store.active_table_digest() == "untuned") == (not table)


def test_table_digest_is_order_free():
    store.set_active_table({"A": "1", "B": "2"})
    d1 = store.active_table_digest()
    store.set_active_table({"B": "2", "A": "1"})
    assert store.active_table_digest() == d1
    store.set_active_table({"A": "1", "B": "3"})
    assert store.active_table_digest() != d1


AGREE_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    from spark_rapids_jni_tpu_torch.parallel import distributed
    from spark_rapids_jni_tpu_torch.tune import store
    rank, init, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
    distributed.initialize(init, 2, rank, backend="gloo", timeout_s=60)
    store.set_active_table({"SRT_JOIN_METHOD": ["xla", "auto"][rank]})
    digest = store.agree_active_table()
    with open(f"{out}/r{rank}.json", "w") as f:
        json.dump({"digest": digest, "table": store.active_table(),
                   "wrote": store.store_table({"X": "1"})}, f)
    distributed.shutdown()
""")


def test_mesh_ranks_agree_the_tuned_table(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(AGREE_WORKER)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", GLOO_SOCKET_IFNAME="lo",
               SRT_AOT_CACHE_DIR=str(tmp_path / "aot"))
    procs = [subprocess.Popen([sys.executable, str(script), str(ROOT),
                               str(r), f"file://{tmp_path / 'init'}",
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    res = [json.loads((tmp_path / f"r{r}.json").read_text())
           for r in range(2)]
    assert res[0]["table"] == res[1]["table"] == {"SRT_JOIN_METHOD": "xla"}
    assert res[0]["digest"] == res[1]["digest"] != "untuned"
    # one writer: rank 0
    assert [r["wrote"] for r in res] == [True, False]


# --------------------------------------------------------------------------
# 2. resolution
# --------------------------------------------------------------------------

def test_resolution_order(monkeypatch):
    store.set_active_table({"SRT_JOIN_METHOD": "xla",
                            "SRT_JOIN_CUDA_MAX_CAPACITY": "262144",
                            "SRT_MORSEL_HEADROOM_FRACTION": "0.25"})
    assert tuned_str("SRT_JOIN_METHOD", "auto") == "xla"
    assert tuned_int("SRT_JOIN_CUDA_MAX_CAPACITY", 999) == 262144
    assert tuned_float("SRT_MORSEL_HEADROOM_FRACTION", 0.5) == 0.25
    monkeypatch.setenv("SRT_JOIN_METHOD", "cuda")
    assert tuned_str("SRT_JOIN_METHOD", "auto") == "cuda"
    # a malformed env value falls through to the tuned tier
    monkeypatch.setenv("SRT_JOIN_CUDA_MAX_CAPACITY", "junk")
    assert tuned_int("SRT_JOIN_CUDA_MAX_CAPACITY", 999) == 262144
    store.set_active_table(None)
    monkeypatch.delenv("SRT_JOIN_METHOD")
    assert tuned_str("SRT_JOIN_METHOD", "auto") == "auto"


def test_every_tuned_read_takes_the_table(monkeypatch):
    from spark_rapids_jni_tpu_torch.config import (dense_groupby_mode,
                                                   join_method)
    from spark_rapids_jni_tpu_torch.exec import morsel
    from spark_rapids_jni_tpu_torch.ops import fused_pipeline as fp
    from spark_rapids_jni_tpu_torch.ops import join
    from spark_rapids_jni_tpu_torch.parallel import comm_plan
    store.set_active_table({
        "SRT_JOIN_METHOD": "xla", "SRT_DENSE_GROUPBY": "scatter",
        "SRT_JOIN_CUDA_MAX_CAPACITY": "262144",
        "SRT_BATCH_MAX": "4",
        "SRT_SHUFFLE_SCRATCH_BYTES": "65536", "SRT_SHUFFLE_INTRA": "flat",
        "SRT_SHUFFLE_NEIGHBORHOOD": "2"})
    assert join_method() == "xla" and dense_groupby_mode() == "scatter"
    assert join.join_cuda_max_capacity() == 262144
    assert join.join_probe_method(100, 1 << 20, backend="cuda") == "xla"
    assert fp.max_batch_queries() == 4
    assert comm_plan.scratch_budget() == 65536
    assert comm_plan.intra_exchange_route() == "flat"
    assert comm_plan.neighborhood_size() == 2
    # K1's cap: a table of 2^19 slots fits the default, not 262144
    store.set_active_table({"SRT_JOIN_CUDA_MAX_CAPACITY": "262144"})
    assert join.join_probe_method(200_000, 1 << 20, backend="cuda") == "xla"
    store.set_active_table(None)
    assert join.join_probe_method(200_000, 1 << 20, backend="cuda") == "cuda"
    assert morsel is not None


@pytest.fixture(scope="module")
def rels():
    from spark_rapids_jni_tpu_torch.tpcds import generate
    from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df
    return {k: rel_from_df(v, device="cpu")
            for k, v in generate(sf=0.25, seed=7).items()}


def test_two_tables_two_keys(rels):
    from spark_rapids_jni_tpu_torch.serving.batcher import batch_key
    from spark_rapids_jni_tpu_torch.tpcds import PLANS
    from spark_rapids_jni_tpu_torch.tpcds.rel import planner_env_key
    t_a = {"SRT_JOIN_CUDA_MAX_CAPACITY": "262144"}
    t_b = {"SRT_JOIN_CUDA_MAX_CAPACITY": "1048576"}
    store.set_active_table(t_a)
    key_a = planner_env_key()
    bkey_a = batch_key(PLANS["q3"], rels)
    store.set_active_table(t_b)
    assert planner_env_key() != key_a
    assert batch_key(PLANS["q3"], rels) != bkey_a
    store.set_active_table(t_a)
    assert planner_env_key() == key_a
    assert batch_key(PLANS["q3"], rels) == bkey_a


# --------------------------------------------------------------------------
# 3. runner
# --------------------------------------------------------------------------

def test_specs_are_the_references():
    # the reference's one-hot width tier selects no route in the port
    absent = {"SRT_GROUPBY_ONEHOT_MAX_WIDTH"}
    mine = {s.knob: s for s in space.SPECS}
    for r in r_space.SPECS:
        knob = r.knob.replace("PALLAS", "CUDA")
        if knob in absent:
            assert space.spec_by_knob(knob) is None
            continue
        s = mine[knob]
        assert (s.candidates, s.default, s.workload, s.planner, s.oracle) \
            == (r.candidates, r.default, r.workload, r.planner, r.oracle)
        assert space.spec_by_knob(knob) is s
    assert len(mine) == len(r_space.SPECS) - len(absent)
    assert space.spec_by_knob("SRT_NOPE") is None


def test_runner_converges_and_persists(tuned_dir, rels, monkeypatch):
    from spark_rapids_jni_tpu.tpcds import generate as ref_generate
    from spark_rapids_jni_tpu.tpcds import queries as RQ
    from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_ingest
    from spark_rapids_jni_tpu.tpcds.rel import run_fused as ref_run
    monkeypatch.setenv("SRT_TUNE_WARMUP", "0")
    monkeypatch.setenv("SRT_TUNE_SAMPLES", "1")
    before = _stats()
    seen = []
    report = tune(knobs=["SRT_JOIN_METHOD", "SRT_DENSE_GROUPBY"], sf=0.25,
                  save=True, device="cpu", log=seen.append)
    delta = obs.stats_since(before)
    rj, rg = report["SRT_JOIN_METHOD"], report["SRT_DENSE_GROUPBY"]
    assert rj["skipped"] is None and rj["winner"] in ("auto", "xla")
    assert set(rj["times_ns"]) == {"auto", "xla"}
    assert set(rg["times_ns"]) == {"auto", "scatter", "onehot"}
    assert delta.get("tune.measurements") == 5
    assert delta.get("tune.oracle_rejects", 0) == 0
    assert delta.get("tune.winners") == 2
    assert any("winner" in line for line in seen)
    winners = {"SRT_JOIN_METHOD": rj["winner"],
               "SRT_DENSE_GROUPBY": rg["winner"]}
    assert os.path.exists(store.table_path())
    assert store.active_table() == winners
    assert store.load_table() == winners
    # the winners' result is the reference's q3
    from spark_rapids_jni_tpu_torch.tpcds import PLANS
    from spark_rapids_jni_tpu_torch.tpcds.rel import run_fused
    got = run_fused(PLANS["q3"], rels, device="cpu",
                    skip_result_cache=True).to_df()
    ref_rels = {k: ref_ingest(v)
                for k, v in ref_generate(sf=0.25, seed=7).items()}
    want = ref_run(RQ._q3, ref_rels, _skip_result_cache=True).to_df()
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True),
                                  check_dtype=False)


def test_runner_skips_env_pinned_knobs(monkeypatch):
    monkeypatch.setenv("SRT_JOIN_METHOD", "xla")
    before = _stats()
    report = tune(knobs=["SRT_JOIN_METHOD"], save=False, device="cpu")
    assert report["SRT_JOIN_METHOD"] == {"winner": None, "times_ns": {},
                                         "skipped": "env_pinned"}
    assert obs.stats_since(before).get("tune.env_pinned") == 1


def test_runner_skips_mesh_workloads_without_a_group():
    before = _stats()
    report = tune(knobs=["SRT_SHUFFLE_SCRATCH_BYTES",
                         "SRT_SHUFFLE_NEIGHBORHOOD"], save=False,
                  device="cpu")
    assert {r["skipped"] for r in report.values()} == {"mesh_unavailable"}
    assert obs.stats_since(before).get("tune.mesh_unavailable") == 2


def test_runner_other_workloads_run(monkeypatch):
    monkeypatch.setenv("SRT_TUNE_WARMUP", "0")
    monkeypatch.setenv("SRT_TUNE_SAMPLES", "1")
    report = tune(knobs=["SRT_MORSEL_HEADROOM_FRACTION",
                         "SRT_DISK_PREFETCH_DEPTH", "SRT_BATCH_MAX"],
                  sf=0.25, save=False, device="cpu")
    for knob, r in report.items():
        spec = space.spec_by_knob(knob)
        assert set(r["times_ns"]) == set(spec.candidates), knob
        assert r["winner"] in spec.candidates
    assert store.active_table() == {}  # no trial table outlives the run


_A = pd.DataFrame({"x": np.array([1.0, np.nan]),
                   "s": np.array(["a", "b"], object)})
BYTES_CASES = {
    "equal_copy": (_A, _A.copy()),
    "nan_bitwise": (_A, pd.DataFrame({"x": np.array([1.0, np.nan]),
                                      "s": np.array(["a", "b"], object)})),
    "value_differs": (_A, pd.DataFrame({"x": np.array([1.0, 2.0]),
                                        "s": np.array(["a", "b"], object)})),
    "dtype_drift": (pd.DataFrame({"x": np.array([1, 2], np.int64)}),
                    pd.DataFrame({"x": np.array([1, 2], np.int32)})),
    "list_vs_frame": (_A, [_A, _A]),
    "columns_differ": (_A, _A[["s", "x"]]),
}


@pytest.mark.parametrize("name", sorted(BYTES_CASES))
def test_bytes_equal_is_the_references(name):
    a, b = BYTES_CASES[name]
    assert bytes_equal(a, b) == r_bytes_equal(a, b)
    assert bytes_equal(a, b) == (name in ("equal_copy", "nan_bitwise"))


def test_runner_measures_deterministically_on_the_card(monkeypatch):
    """The runner's deterministic block sets the mode and restores the
    previous one. On the card the oracle run alone goes under it (float
    atomics reorder sums run to run); the warm-up and the timed samples
    run with it off, as production does. On the CPU it stays off."""
    import torch
    from spark_rapids_jni_tpu_torch.tune import runner
    assert not torch.are_deterministic_algorithms_enabled()
    with runner._deterministic(True):
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
    with runner._deterministic(False):
        assert not torch.are_deterministic_algorithms_enabled()
    modes = []

    def body(inputs):
        modes.append(torch.are_deterministic_algorithms_enabled())
        return inputs

    result, times = runner._measure(lambda: "x", body, 1, 2, True)
    assert result == "x" and len(times) == 2
    assert modes == [True, False, False, False]
    assert not torch.are_deterministic_algorithms_enabled()
    seen = []
    real = runner._measure

    def spy(setup, body, warmup, samples, deterministic):
        seen.append(deterministic)
        return real(setup, body, warmup, samples, deterministic)

    monkeypatch.setattr(runner, "_measure", spy)
    monkeypatch.setenv("SRT_TUNE_WARMUP", "0")
    monkeypatch.setenv("SRT_TUNE_SAMPLES", "1")
    tune(knobs=["SRT_JOIN_METHOD"], sf=0.25, save=False, device="cpu")
    assert seen == [False, False]


@pytest.mark.parametrize("times,spreads,want", [
    ({"auto": 100, "xla": 90}, {"auto": 20, "xla": 5}, "auto"),
    ({"auto": 100, "xla": 90}, {"auto": 5, "xla": 20}, "auto"),
    ({"auto": 100, "xla": 70}, {"auto": 20, "xla": 5}, "xla"),
    ({"auto": 100, "xla": 120}, {"auto": 0, "xla": 0}, "auto"),
    ({"auto": 100, "xla": 99}, {"auto": 0, "xla": 0}, "xla"),
], ids=["within_default_spread", "within_candidate_spread",
        "beyond_spread", "default_fastest", "one_sample"])
def test_winner_must_beat_the_default_by_its_spread(times, spreads, want):
    from spark_rapids_jni_tpu_torch.tune import runner
    before = _stats()
    assert runner._pick_winner("auto", times, spreads) == want
    kept = obs.stats_since(before).get("tune.kept_incumbent", 0)
    assert kept == (1 if want == "auto" and min(times, key=times.get)
                    != "auto" else 0)


def test_runner_times_the_callers_rels(rels, monkeypatch):
    """``tune(rels=...)`` times q3 on the caller's tables: no data is
    generated, and the winner's result is q3 on those tables."""
    from spark_rapids_jni_tpu_torch.tpcds import PLANS
    from spark_rapids_jni_tpu_torch.tpcds.rel import run_fused
    from spark_rapids_jni_tpu_torch.tune import runner
    monkeypatch.setenv("SRT_TUNE_WARMUP", "0")
    monkeypatch.setenv("SRT_TUNE_SAMPLES", "2")

    def no_data(sf):
        raise AssertionError("the runner generated data")

    monkeypatch.setattr(runner, "_data", no_data)
    report = tune(knobs=["SRT_JOIN_METHOD"], save=False, device="cpu",
                  rels=rels)
    r = report["SRT_JOIN_METHOD"]
    assert r["winner"] in ("auto", "xla") and set(r["times_ns"]) == \
        set(r["spread_ns"]) == {"auto", "xla"}
    assert all(v >= 0 for v in r["spread_ns"].values())
    want = run_fused(PLANS["q3"], rels, device="cpu",
                     skip_result_cache=True).to_df()
    store.set_active_table({"SRT_JOIN_METHOD": r["winner"]})
    got = run_fused(PLANS["q3"], rels, device="cpu",
                    skip_result_cache=True).to_df()
    assert bytes_equal(got, want)
