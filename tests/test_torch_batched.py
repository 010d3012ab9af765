"""The port's ``run_fused_batched`` against the reference's
(``tests/test_fleet_scheduler.py``'s batching cases) on the CPU.

- q1-q20 through both packages' ``run_fused_batched`` on the window
  ``[rels, rels2, rels]`` (k=3 pads to capacity 4; ``rels2`` a second
  ingest of the same frames): every slot equal to the reference's slot
  (integers byte-equal, floats rtol=1e-12) and to the port's serial
  ``run_fused``; the reference's twenty batched results are computed once
  for the module;
- one batch program, one counted host sync and one materialization a
  slot a window, ``rel.route.serving.batched`` and the route counters
  equal to the reference's deltas, on the default, padded, ragged and
  degraded routes;
- every ``BatchIncompatible`` case with the reference's message;
- the report's ``batch``, ``cache_hit``, ``batch_qids`` and ``memory``
  fields, cold then warm, beside the reference's; the graph route's
  bookkeeping (static buffers for per-slot tables only, shared tables
  read in place and keyed on their storage, provenance ``cold_compile``
  then ``warm_memory``, the replay's launch count, eviction by count and
  by the device's headroom) through a stand-in for the capture, since
  the CPU has no CUDA graphs;
- a real ``torch.cuda.OutOfMemoryError`` in a window frees the cache and
  halves the window through the batcher;
- dictionary digests memoized only for frozen arrays, and the ingest
  freezing its dictionaries;
- fault seams fire before any cache bookkeeping and poison no entry; a
  body that fails marks its entry, and later windows raise without
  running it.
"""

import threading

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import obs as ref_obs
from spark_rapids_jni_tpu.config import set_config as ref_set_config
from spark_rapids_jni_tpu.exec import pages as ref_pages
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds import queries as RQ
from spark_rapids_jni_tpu.tpcds import rel as ref_rel
from spark_rapids_jni_tpu.utils import faults as ref_faults

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.exec import HostTable
from spark_rapids_jni_tpu_torch.exec import pages
from spark_rapids_jni_tpu_torch.obs import memory
from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K
from spark_rapids_jni_tpu_torch.serving import aot_cache
from spark_rapids_jni_tpu_torch.tpcds import PLANS
from spark_rapids_jni_tpu_torch.tpcds import rel as R
from spark_rapids_jni_tpu_torch.utils import faults

CPU = "cpu"
SF, SEED = 0.4, 11
QS = [f"q{i}" for i in range(1, 21)]
ROUTE_KEYS = ("rel.route.serving.batched", "rel.route.batch.padded",
              "rel.route.batch.ragged", "rel.batch.pool_degraded",
              "rel.dispatches.rel.fused_batch_program",
              "rel.dispatches.rel.materialize",
              "rel.host_syncs.rel.batch_mask_count")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("SRT_METRICS", "SRT_BATCH_ROUTE", "SRT_PAGE_POOL_BYTES",
              "SRT_PLAN_CACHE_SIZE", "SRT_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    obs.reset_all()
    faults.reset()
    pages.reset()
    R.clear_batch_cache()
    yield
    faults.reset()
    pages.reset()
    R.clear_batch_cache()
    obs.reset_all()


@pytest.fixture(scope="module", autouse=True)
def _release_reference_plans():
    """The reference's plan caches are process-wide and bounded: empty
    them after this module."""
    yield
    ref_rel._FUSED_CACHE.clear()
    ref_rel._BATCH_CACHE.clear()
    ref_faults.reset()
    ref_pages.reset()


@pytest.fixture(scope="module")
def data():
    return ref_generate(sf=SF, seed=SEED)


@pytest.fixture(scope="module")
def ref_rels(data):
    return ({k: ref_rel.rel_from_df(v) for k, v in data.items()},
            {k: ref_rel.rel_from_df(v) for k, v in data.items()})


@pytest.fixture(scope="module")
def rels(data):
    return ({k: R.rel_from_df(v, device=CPU) for k, v in data.items()},
            {k: R.rel_from_df(v, device=CPU) for k, v in data.items()})


@pytest.fixture(scope="module")
def ref_batched(ref_rels):
    """The reference's window of every query, once: {q: (frames, counter
    delta)}."""
    a, b = ref_rels
    out = {}
    ref_faults.reset()
    ref_pages.reset()
    for q in QS:
        before = ref_obs.kernel_stats()
        outs = ref_rel.run_fused_batched(getattr(RQ, f"_{q}"), [a, b, a])
        delta = ref_obs.stats_since(before)
        out[q] = ([o.to_df() for o in outs], delta)
    return out


def _frames_equal(got, want, what=""):
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=1e-12,
                                       atol=0, err_msg=f"{what}.{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{c}")


def _routes(delta):
    return {k: delta.get(k, 0) for k in ROUTE_KEYS}


@pytest.mark.parametrize("q", QS)
def test_batched_equals_reference_and_serial(q, rels, ref_batched):
    a, b = rels
    want, ref_delta = ref_batched[q]
    before = obs.kernel_stats()
    outs = R.run_fused_batched(PLANS[q], [a, b, a], device=CPU)
    delta = obs.stats_since(before)
    assert len(outs) == 3
    serial = R.run_fused(PLANS[q], a, device=CPU).to_df()
    for i, (o, w) in enumerate(zip(outs, want)):
        got = o.to_df()
        _frames_equal(got, w, f"{q} slot {i} vs reference")
        _frames_equal(got, serial, f"{q} slot {i} vs serial")
    # one batch program, one materialization a slot, one host sync
    disp, syncs = obs.dispatch_counts(delta)
    assert (disp, syncs) == (4, 1), delta
    assert delta.get("rel.dispatches.rel.fused_batch_program") == 1
    assert delta.get("rel.route.serving.batched") == 3
    assert _routes(delta) == _routes(ref_delta)


@pytest.mark.parametrize("route,pool,want_tag,degraded", [
    ("padded", None, "padded", 0),
    ("ragged", None, "ragged", 0),
    ("ragged", "0", "padded", 1),
    ("auto", "0", "padded", 0),
    ("auto", "4096", "padded", 1),
])
def test_batch_routes_match_reference(route, pool, want_tag, degraded,
                                      rels, ref_rels, monkeypatch):
    monkeypatch.setenv("SRT_BATCH_ROUTE", route)
    if pool is not None:
        monkeypatch.setenv("SRT_PAGE_POOL_BYTES", pool)
    pages.reset()
    ref_pages.reset()
    a, b = rels
    ra, rb = ref_rels
    before = obs.kernel_stats()
    outs = R.run_fused_batched(PLANS["q3"], [a, b, a], device=CPU)
    delta = obs.stats_since(before)
    rbefore = ref_obs.kernel_stats()
    ref_outs = ref_rel.run_fused_batched(RQ._q3, [ra, rb, ra])
    rdelta = ref_obs.stats_since(rbefore)
    assert delta.get(f"rel.route.batch.{want_tag}") == 3, delta
    assert delta.get("rel.batch.pool_degraded", 0) == degraded, delta
    assert _routes(delta) == _routes(rdelta)
    for o, w in zip(outs, ref_outs):
        _frames_equal(o.to_df(), w.to_df())
    # the lease goes back at the end of the window
    pool_now = pages.page_pool()
    assert pool_now is None or pool_now.leased_bytes == 0


def _ref_and_port_raise(ref_call, port_call):
    with pytest.raises(ref_rel.BatchIncompatible) as ref_e:
        ref_call()
    with pytest.raises(R.BatchIncompatible) as port_e:
        port_call()
    assert str(port_e.value) == str(ref_e.value)
    return str(port_e.value)


def test_incompatible_table_sets(rels, ref_rels):
    a, b = rels
    ra, rb = ref_rels
    short = {k: v for k, v in b.items() if k != "item"}
    rshort = {k: v for k, v in rb.items() if k != "item"}
    msg = _ref_and_port_raise(
        lambda: ref_rel.run_fused_batched(RQ._q1, [ra, rshort]),
        lambda: R.run_fused_batched(PLANS["q1"], [a, short], device=CPU))
    assert "table sets differ" in msg


def test_incompatible_streamed_table(rels, ref_rels, data):
    from spark_rapids_jni_tpu.exec import HostTable as RefHostTable
    a, _ = rels
    ra, _ = ref_rels
    host = dict(a, store_sales=HostTable.from_df(data["store_sales"]))
    rhost = dict(ra, store_sales=RefHostTable.from_df(data["store_sales"]))
    msg = _ref_and_port_raise(
        lambda: ref_rel.run_fused_batched(RQ._q3, [ra, rhost]),
        lambda: R.run_fused_batched(PLANS["q3"], [a, host], device=CPU))
    assert "streamed" in msg


def test_incompatible_masked_table(rels, ref_rels):
    a, _ = rels
    ra, _ = ref_rels

    def masked(r):
        sr = r["store_returns"]
        return dict(r, store_returns=sr.filter(sr.data("sr_store_sk") >= 0))

    msg = _ref_and_port_raise(
        lambda: ref_rel.run_fused_batched(RQ._q1, [ra, masked(ra)]),
        lambda: R.run_fused_batched(PLANS["q1"], [a, masked(a)],
                                    device=CPU))
    assert "not fusable" in msg


def test_incompatible_fingerprints(rels, ref_rels, data):
    a, _ = rels
    ra, _ = ref_rels
    sr = data["store_returns"].copy()
    sr["sr_store_sk"] = sr["sr_store_sk"] + 100  # shifts value_range
    bumped = dict(a, store_returns=R.rel_from_df(sr, device=CPU))
    rbumped = dict(ra, store_returns=ref_rel.rel_from_df(sr))
    msg = _ref_and_port_raise(
        lambda: ref_rel.run_fused_batched(RQ._q1, [ra, rbumped]),
        lambda: R.run_fused_batched(PLANS["q1"], [a, bumped], device=CPU))
    assert "fingerprints differ" in msg


def test_incompatible_above_the_ladder(rels, ref_rels):
    a, _ = rels
    ra, _ = ref_rels
    msg = _ref_and_port_raise(
        lambda: ref_rel.run_fused_batched(RQ._q9, [ra] * 17),
        lambda: R.run_fused_batched(PLANS["q9"], [a] * 17, device=CPU))
    assert "exceeds the capacity ladder" in msg
    # raised before any cache bookkeeping: no entry was made
    assert len(R._BATCH_CACHE) == 0


def test_single_submission_runs_serially(rels):
    a, _ = rels
    before = obs.kernel_stats()
    (out,) = R.run_fused_batched(PLANS["q9"], [a], device=CPU)
    delta = obs.stats_since(before)
    assert "rel.dispatches.rel.fused_batch_program" not in delta
    _frames_equal(out.to_df(), R.run_fused(PLANS["q9"], a,
                                           device=CPU).to_df())


def test_report_fields_cold_then_warm(rels, ref_rels, monkeypatch):
    from spark_rapids_jni_tpu_torch.obs import report as port_report
    monkeypatch.setenv("SRT_METRICS", "1")
    ref_set_config(metrics_enabled=True)
    try:
        a, b = rels
        ra, rb = ref_rels
        reps, ref_reps = [], []
        for _ in range(2):
            with port_report.qid_scope("q-lead", batch_qids=["q-lead",
                                                             "q-2"]):
                R.run_fused_batched(PLANS["q1"], [a, b], device=CPU)
            reps.append(obs.last_report("q1"))
            ref_rel.run_fused_batched(RQ._q1, [ra, rb])
            ref_reps.append(ref_obs.last_report("q1"))
    finally:
        ref_set_config(metrics_enabled=False)
    for rep, ref in zip(reps, ref_reps):
        assert rep.batch == ref.batch == 2
        assert rep.fused and ref.fused
        assert rep.cache_hit == ref.cache_hit
        assert (rep.dispatches, rep.host_syncs) == (ref.dispatches,
                                                    ref.host_syncs)
        assert rep.memory["batch_multiplier"] == \
            ref.memory["batch_multiplier"]
        assert ("padded_waste_bytes" in rep.memory) == \
            ("padded_waste_bytes" in ref.memory)
        assert rep.qid == "q-lead"
        assert rep.batch_qids == ["q-lead", "q-2"]
        assert rep.to_dict()["batch"] == 2
    assert [r.cache_hit for r in reps] == [False, True]
    # the CPU runs the program eagerly: no capture, no replay
    assert [r.provenance for r in reps] == ["eager", "eager"]
    assert [r.provenance for r in ref_reps] == ["cold_compile",
                                                "warm_memory"]


def _copy_into(dst, src):
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif dst is not None:
        for x, y in zip(dst, src):
            _copy_into(x, y)


class _StandInGraph:
    """What ``capture_graph`` returns, on the CPU: the warm-up and the
    captured run are real runs of the program over the static buffers; a
    replay runs it again and writes the results into the captured
    outputs, as a graph replay rewrites its static outputs."""

    captures = []
    pool_bytes = 0

    def __init__(self, fn, site, signature):
        fn()  # the warm-up
        with K.capture_launches() as launches:
            self.outputs = fn()
        self.fn = fn
        self.launches = dict(launches)
        self.capture_s = 0.0
        self.released = False
        self.replays = 0
        _StandInGraph.captures.append((site, signature, self))

    def replay(self):
        with K.capture_launches():
            _copy_into(self.outputs, self.fn())
        K.LAUNCHES.update(self.launches)
        self.replays += 1

    def release(self):
        self.released = True
        self.outputs = None


@pytest.fixture
def stand_in(monkeypatch):
    _StandInGraph.captures = []
    monkeypatch.setattr(
        aot_cache, "capture_graph",
        lambda fn, *, site, signature=(), device=None:
        _StandInGraph(fn, site, signature))
    return _StandInGraph


@pytest.mark.parametrize("q", ["q1", "q5", "q9", "q13", "q19"])
def test_graph_route_bookkeeping(q, rels, data, stand_in, monkeypatch):
    monkeypatch.setenv("SRT_METRICS", "1")
    a, _ = rels
    ss = data["store_sales"].copy()
    ss["ss_net_profit"] = np.roll(ss["ss_net_profit"].to_numpy(), 333)
    b = dict(a, store_sales=R.rel_from_df(ss, device=CPU))
    want = [R.run_fused(PLANS[q], r, device=CPU).to_df() for r in (a, b)]
    provs = []
    for _ in range(3):
        before = obs.kernel_stats()
        outs = R.run_fused_batched(PLANS[q], [a, b, a], device=CPU,
                                   _graph=True)
        delta = obs.stats_since(before)
        provs.append(obs.last_report(q).provenance)
        for o, w in zip(outs, (want[0], want[1], want[0])):
            _frames_equal(o.to_df(), w, q)
        assert obs.dispatch_counts(delta) == (4, 1)
    assert provs == ["cold_compile", "warm_memory", "warm_memory"]
    assert len(stand_in.captures) == 1
    site, signature, g = stand_in.captures[0]
    assert site == f"rel.fused_batch.{q}"
    assert g.replays == 3
    (st,) = R.batch_cache_stats()
    assert st["graph"] and st["capacity"] == 4
    # store_sales has a buffer a slot; every other table is shared, read
    # in place
    per_slot = sum(c.data.nbytes for c in a["store_sales"].table.columns)
    assert st["static_bytes"] == 4 * per_slot
    # the stand-in has no pool, and the CPU memoizes no upload
    assert st["bytes"] == st["static_bytes"]
    R.clear_batch_cache()
    assert g.released


def test_graph_reads_shared_tables_in_place(rels, data, stand_in):
    a, other = rels
    b = dict(a, store_sales=other["store_sales"])
    R.run_fused_batched(PLANS["q9"], [a, b, a], device=CPU, _graph=True)
    entry = next(iter(R._BATCH_CACHE.values()))
    # store_sales has 4 slot buffers (a, b, a and the pad), no other
    # table has one
    assert list(entry["static"]) == ["store_sales"]
    assert len(entry["static"]["store_sales"]) == 4
    # another ingest in slot 1 replays the same entry
    c = dict(a, store_sales=R.rel_from_df(data["store_sales"], device=CPU))
    for r in (c, b):
        outs = R.run_fused_batched(PLANS["q9"], [a, r, a], device=CPU,
                                   _graph=True)
        _frames_equal(outs[1].to_df(),
                      R.run_fused(PLANS["q9"], r, device=CPU).to_df())
    assert len(R._BATCH_CACHE) == 1 and len(stand_in.captures) == 1
    # a shared table at other storage is another key: a graph reads it
    # where it was captured
    moved = dict(other, store_sales=a["store_sales"])
    R.run_fused_batched(PLANS["q9"], [moved, b, moved], device=CPU,
                        _graph=True)
    assert len(R._BATCH_CACHE) == 2 and len(stand_in.captures) == 2


def test_capture_evicts_to_the_headroom(rels, stand_in, monkeypatch):
    """Before a capture the cache evicts, least recently used first,
    while its charge plus the new entry's static buffers exceed the
    device's headroom less the cached graphs' pools."""
    a, other = rels
    b = dict(a, store_sales=other["store_sales"])
    p = sum(c.data.nbytes for c in a["store_sales"].table.columns)
    monkeypatch.setattr(stand_in, "pool_bytes", p)  # a pool of one slot
    head = {"v": 10 ** 12}
    memory.set_stats_source_for_testing(
        lambda: [{"bytes_in_use": 0, "bytes_limit": head["v"]}])
    try:
        before = obs.kernel_stats()
        R.run_fused_batched(PLANS["q9"], [a, b], device=CPU, _graph=True)
        R.run_fused_batched(PLANS["q3"], [a, b], device=CPU, _graph=True)
        assert R._BATCH_CACHE.nbytes() == 2 * (2 * p + p)
        assert not obs.stats_since(before).get("rel.batch.budget_evictions")
        # charge 6p and capacity 4's 4p need 10p beside the pools' 2p:
        # at 11p the oldest entry (q9 at capacity 2) goes
        head["v"] = 11 * p
        R.run_fused_batched(PLANS["q9"], [a, b, a], device=CPU,
                            _graph=True)
        assert obs.stats_since(before).get("rel.batch.budget_evictions") == 1
        # at 6p both entries go before q3 at capacity 4 fits
        head["v"] = 6 * p
        R.run_fused_batched(PLANS["q3"], [a, b, a], device=CPU,
                            _graph=True)
        delta = obs.stats_since(before)
    finally:
        memory.set_stats_source_for_testing(None)
    assert delta.get("rel.batch.budget_evictions") == 3
    assert delta.get("rel.plan_cache_evictions.fused_batch") == 3
    assert [g.released for _, _, g in stand_in.captures] == [
        True, True, True, False]
    (st,) = R.batch_cache_stats()
    assert (st["query"], st["capacity"], st["bytes"]) == ("q3", 4, 5 * p)


def test_real_oom_splits_the_window(rels, monkeypatch):
    """A ``torch.cuda.OutOfMemoryError`` in a batched window frees the
    cache and reaches the batcher as ``SplitAndRetryOOM``: the window
    halves, and no entry is marked as a fallback."""
    from spark_rapids_jni_tpu_torch.serving import batcher
    a, b = rels
    real = R._batch_program
    seen = []

    def program(plan, slots, entry):
        seen.append(len(slots))
        if len(slots) == 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(plan, slots, entry)

    monkeypatch.setattr(R, "_batch_program", program)
    R.run_fused_batched(PLANS["q9"], [a, b], device=CPU)  # a cached entry

    class Item:
        def __init__(self, r):
            self.pq, self.plan, self.rels = None, PLANS["q9"], r
            self.mesh = self.axis = self.out = None

        def resolve(self, out):
            self.out = out

        def reject(self, e):
            raise AssertionError(e)

    items = [Item(r) for r in (a, b, a, b)]
    before = obs.kernel_stats()
    batcher.execute_batch(items, device=CPU)
    delta = obs.stats_since(before)
    assert seen == [2, 4, 2, 2]
    assert delta.get("rel.batch.oom") == 1
    assert delta.get("serving.fault.oom.split") == 1
    assert delta.get("serving.batch.formed") == 2
    assert not delta.get("serving.batch.fallback")
    # the OOM evicted the capacity-2 entry, which the halves then rebuilt
    assert delta.get("rel.plan_cache_evictions.fused_batch") == 1
    assert not any(st["fallback"] for st in R.batch_cache_stats())
    for it, r in zip(items, (a, b, a, b)):
        _frames_equal(it.out.to_df(),
                      R.run_fused(PLANS["q9"], r, device=CPU).to_df())


def test_dict_digest_memo_only_for_frozen_arrays():
    frozen = np.array(["a", "b"], dtype=object)
    frozen.flags.writeable = False
    assert R._dict_digest(frozen) == R._dict_digest(frozen.copy())
    assert id(frozen) in R._DICT_DIGESTS
    # an array that can be written is hashed on every call: an edit in
    # place changes its digest, and with it every key it is part of
    live = np.array(["a", "b"], dtype=object)
    d0 = R._dict_digest(live)
    live[1] = "c"
    assert R._dict_digest(live) != d0
    assert id(live) not in R._DICT_DIGESTS
    # a read-only view of a writable base is not trusted either
    base = np.array([1, 2, 3])
    view = base[:2]
    view.flags.writeable = False
    d0 = R._dict_digest(view)
    base[0] = 9
    assert R._dict_digest(view) != d0


def test_ingest_freezes_dictionaries(rels):
    a, _ = rels
    dicts = [v for r in a.values() for v in r.dicts.values()]
    assert dicts and all(not v.flags.writeable and v.flags.owndata
                         for v in dicts)


def test_replay_counts_the_captured_launches(stand_in):
    K.reset_launch_counts()
    with K.capture_launches() as rec:
        K._count_launch("hash_join_probe", 2)
        K._count_launch("ragged_groupby_sum_count")
    assert K.LAUNCHES == {}
    assert rec == {"hash_join_probe": 2, "ragged_groupby_sum_count": 1}

    class G:
        def replay(self):
            pass

    g = aot_cache.CapturedGraph(G(), None, dict(rec), 0.0)
    g.replay()
    g.replay()
    assert K.LAUNCHES == {"hash_join_probe": 4,
                          "ragged_groupby_sum_count": 2}
    K.reset_launch_counts()


def test_two_threads_share_one_entry(rels, stand_in):
    a, b = rels
    want = R.run_fused(PLANS["q3"], a, device=CPU).to_df()
    errors = []

    def window():
        try:
            for _ in range(3):
                outs = R.run_fused_batched(PLANS["q3"], [a, b], device=CPU,
                                           _graph=True)
                for o in outs:
                    _frames_equal(o.to_df(), want)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=window) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert len(stand_in.captures) == 1


def test_eviction_releases_the_graph(rels, stand_in, monkeypatch):
    monkeypatch.setenv("SRT_PLAN_CACHE_SIZE", "1")
    a, b = rels
    before = obs.kernel_stats()
    R.run_fused_batched(PLANS["q9"], [a, b], device=CPU, _graph=True)
    R.run_fused_batched(PLANS["q3"], [a, b], device=CPU, _graph=True)
    delta = obs.stats_since(before)
    assert delta.get("rel.plan_cache_evictions.fused_batch") == 1
    assert delta.get("rel.plan_cache_evictions") == 1
    assert len(R._BATCH_CACHE) == 1
    assert stand_in.captures[0][2].released
    assert not stand_in.captures[1][2].released


@pytest.mark.parametrize("spec,exc", [
    ("batch:raise:1", faults.InjectedFault),
    ("batch:split_oom:1", faults.SplitAndRetryOOM),
    ("alloc:retry_oom:1", faults.RetryOOM),
])
def test_fault_seams_poison_no_entry(spec, exc, rels):
    a, b = rels
    faults.configure(spec)
    with pytest.raises(exc):
        R.run_fused_batched(PLANS["q3"], [a, b], device=CPU)
    assert len(R._BATCH_CACHE) == 0  # fired before any bookkeeping
    outs = R.run_fused_batched(PLANS["q3"], [a, b], device=CPU)
    _frames_equal(outs[0].to_df(),
                  R.run_fused(PLANS["q3"], a, device=CPU).to_df())
    assert not any(s["fallback"] for s in R.batch_cache_stats())


def test_failed_body_marks_its_entry(rels):
    a, b = rels
    runs = []

    def _compacting(t):  # compaction inside a plan needs the general route
        runs.append(1)
        return t["store_sales"].filter(
            t["store_sales"].data("ss_quantity") > 10).compact()

    before = obs.kernel_stats()
    with pytest.raises(R.BatchIncompatible, match="FusedFallback"):
        R.run_fused_batched(_compacting, [a, b], device=CPU)
    n = len(runs)
    with pytest.raises(R.BatchIncompatible, match="FusedFallback"):
        R.run_fused_batched(_compacting, [a, b], device=CPU)
    assert len(runs) == n  # not run again
    delta = obs.stats_since(before)
    assert delta.get("rel.batch.fallbacks") == 1
    assert delta.get("rel.batch.fallbacks.compacting") == 1


def test_runtime_counters_sum_the_live_slots(rels):
    """q15 counts decimal overflow NULLs inside the plan: the window's
    count is the live slots' sum (the pad slot replicates slot 0)."""
    a, b = rels
    before = obs.kernel_stats()
    R.run_fused(PLANS["q15"], a, device=CPU)
    one = obs.stats_since(before).get("rel.route.decimal.overflow", 0)
    before = obs.kernel_stats()
    R.run_fused_batched(PLANS["q15"], [a, b, a], device=CPU)
    got = obs.stats_since(before).get("rel.route.decimal.overflow", 0)
    assert got == 3 * one
