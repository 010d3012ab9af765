"""The port's result cache against the reference's
(``serving/result_cache.py``, ``tpcds/rel.result_cache_token``).

The two packages' plan code differs, so tokens are compared by their
behaviour, not their strings: in both packages a fresh ingest of equal
content keys alike, a changed value keys apart, streamed and
undigested inputs are uncacheable.

- hit, miss and uncacheable counting; a hit reports provenance
  ``result_cache`` with no dispatch and no host sync, and equals the
  reference's ``run_fused`` result;
- the whole-entry tier's LRU eviction by bytes;
- the paged tier (``PagedResultCache``), the cache while the page pool
  (``exec/pages.py``) is on: the reference's four paged-cache cases
  (``tests/test_pages.py``) run side by side on both packages with the
  same counters, lengths and resident bytes; host pages only, no lease
  from the page ledger; a hit rebuilt as new tensors;
- ``result_cache()`` re-reads ``SRT_RESULT_CACHE_BYTES`` each call and
  picks the tier as the reference does;
- the executor in front of the cache builds a control plane under
  ``SRT_CONTROL_PLANE=1`` and none without it.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_jni_tpu.serving import result_cache as ref_rc
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_plain
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds import queries as RQ
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df
from spark_rapids_jni_tpu.tpcds.rel import \
    result_cache_token as ref_token
from spark_rapids_jni_tpu.tpcds.rel import run_fused as ref_run_fused

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.exec import HostTable, pages
from spark_rapids_jni_tpu_torch.serving import (QueryExecutor, aot_cache,
                                                result_cache)
from spark_rapids_jni_tpu_torch.tpcds import PLANS
from spark_rapids_jni_tpu_torch.tpcds.rel import (Rel, rel_from_df,
                                                  result_cache_token,
                                                  run_fused)

CPU = "cpu"
SF, SEED = 0.3, 7
CAP = str(1 << 28)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", CAP)
    monkeypatch.delenv("SRT_PAGE_POOL_BYTES", raising=False)
    monkeypatch.delenv("SRT_PAGE_BYTES", raising=False)
    monkeypatch.delenv("SRT_METRICS", raising=False)
    obs.reset_all()
    result_cache.reset()
    ref_rc.reset()
    pages.reset()
    yield
    result_cache.reset()
    ref_rc.reset()
    pages.reset()
    obs.reset_all()


@pytest.fixture(scope="module", autouse=True)
def _release_reference_plans():
    """The reference's plan cache is process-wide and bounded (64
    entries): empty it after this module, so a later module's
    cache-growth assertions in the same worker find free slots."""
    yield
    from spark_rapids_jni_tpu.tpcds import rel as ref_rel_module
    ref_rel_module._FUSED_CACHE.clear()


@pytest.fixture(scope="module")
def data():
    return ref_generate(sf=SF, seed=SEED)


def _ingest(data):
    return {k: rel_from_df(v, device=CPU) for k, v in data.items()}


def _ref_ingest(data):
    return {k: ref_rel_from_df(v) for k, v in data.items()}


def _frames_equal(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-9,
                                  atol=1e-9)


def _changed(data):
    """The same tables with one store_sales value changed."""
    out = dict(data)
    ss = data["store_sales"].copy()
    col = "ss_quantity"
    ss.loc[0, col] = ss.loc[0, col] + 1
    out["store_sales"] = ss
    return out


# --------------------------------------------------------------------------
# tokens: behaviour beside the reference's
# --------------------------------------------------------------------------

def test_token_behaviour_equals_reference(data):
    mine = [result_cache_token(PLANS["q3"], _ingest(d), device=CPU)
            for d in (data, data, _changed(data))]
    ref = [ref_token(RQ._q3, _ref_ingest(d))
           for d in (data, data, _changed(data))]
    for toks in (mine, ref):
        assert None not in toks
        assert toks[0] == toks[1] != toks[2]
    assert result_cache_token(PLANS["q1"], _ingest(data),
                              device=CPU) != mine[0]


def test_token_names_the_device(data):
    """A cached result's tensors live where it was computed: the same
    content run on another device keys apart."""
    rels = _ingest(data)
    cpu = result_cache_token(PLANS["q3"], rels, device=CPU)
    assert cpu == result_cache_token(PLANS["q3"], rels,
                                     device=torch.device("cpu"))
    assert cpu != result_cache_token(PLANS["q3"], rels, device="meta")
    on_meta = {n: Rel(Table([Column(c.dtype, c.size, c.data.to("meta"),
                                    None if c.validity is None
                                    else c.validity.to("meta"),
                                    value_range=c.value_range,
                                    unique=c.unique)
                             for c in r.table.columns]), r.names,
                      dicts=r.dicts)
               for n, r in rels.items()}
    for n, r in rels.items():
        for a, b in zip(r.table.columns, on_meta[n].table.columns):
            b._content_digest = a._content_digest
            if hasattr(a, "_stats_flags"):  # verified by the token above
                b._stats_flags = a._stats_flags
    assert cpu != result_cache_token(PLANS["q3"], on_meta, device=CPU)


def test_token_uncacheable_without_digests(data, monkeypatch):
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", "0")
    plain = _ingest(data)  # the tier off at ingest: no digests
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", CAP)
    before = obs.kernel_stats()
    assert result_cache_token(PLANS["q3"], plain) is None
    host = dict(_ingest(data))
    host["store_sales"] = HostTable.from_df(data["store_sales"])
    assert result_cache_token(PLANS["q3"], host) is None
    assert obs.stats_since(before) == {"serving.result_cache.uncacheable": 2}


def test_token_helpers_are_content_stable():
    assert aot_cache.token_digest(("a", 1)) == aot_cache.token_digest(
        ("a", 1))
    assert aot_cache.plan_code_digest(PLANS["q1"]) != \
        aot_cache.plan_code_digest(PLANS["q2"])
    key = aot_cache.environment_key()
    assert key[0] == torch.__version__ and key[2].startswith(
        "libsrt_torch_kernels-")
    assert aot_cache.result_token(PLANS["q1"], ("x",)) == \
        aot_cache.result_token(PLANS["q1"], ("x",))


def test_result_cache_rereads_the_env(monkeypatch):
    paged = result_cache.result_cache()
    assert isinstance(paged, result_cache.PagedResultCache)
    assert isinstance(ref_rc.result_cache(), ref_rc.PagedResultCache)
    assert paged.page_bytes == pages.page_bytes()
    monkeypatch.setenv("SRT_PAGE_BYTES", "4096")
    assert result_cache.result_cache().page_bytes == 4096
    monkeypatch.setenv("SRT_PAGE_POOL_BYTES", "0")
    c = result_cache.result_cache()
    assert type(c) is result_cache.ResultCache
    assert type(ref_rc.result_cache()) is ref_rc.ResultCache
    assert c.max_bytes == int(CAP)
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", "4096")
    assert result_cache.result_cache().max_bytes == 4096
    monkeypatch.setenv("SRT_RESULT_CACHE_BYTES", "0")
    assert result_cache.result_cache() is None


# --------------------------------------------------------------------------
# run_fused through the cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False], ids=["paged", "whole"])
@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q13", "q16"])
def test_hit_equals_reference_and_runs_nothing(q, paged, data,
                                               monkeypatch):
    monkeypatch.setenv("SRT_METRICS", "1")
    if not paged:
        monkeypatch.setenv("SRT_PAGE_POOL_BYTES", "0")
    rels = _ingest(data)
    first = run_fused(PLANS[q], rels, device=CPU).to_df()
    again = _ingest(data)  # a fresh ingest of equal content
    before = obs.kernel_stats()
    hit = run_fused(PLANS[q], again, device=CPU)
    d = obs.stats_since(before)
    assert d.get("serving.result_cache.hits") == 1
    assert d.get("rel.dispatches", 0) == 0 and d.get("rel.host_syncs", 0) == 0
    rep = obs.last_report(q)
    assert rep.provenance == "result_cache" and rep.cache_hit
    assert rep.dispatches == 0 and rep.host_syncs == 0 and rep.memory == {}
    want = ref_run_fused(getattr(RQ, f"_{q}"), _ref_ingest(data)).to_df()
    _frames_equal(hit.to_df(), want)
    _frames_equal(first, want)
    cache = result_cache.result_cache()
    assert isinstance(cache, result_cache.PagedResultCache) == paged
    if paged:  # host pages only: no device tensor, no ledger lease
        held = cache.resident_tensors()
        assert held and all(t.device.type == "cpu" for t in held)
        assert not ({c.data.data_ptr() for c in hit.table.columns}
                    & {t.data_ptr() for t in held})  # the hit's are new
        assert pages.page_pool() is None or pages.page_pool().n_leases == 0


def test_changed_ingest_misses(data):
    run_fused(PLANS["q3"], _ingest(data), device=CPU)
    before = obs.kernel_stats()
    run_fused(PLANS["q3"], _ingest(_changed(data)), device=CPU)
    d = obs.stats_since(before)
    assert d.get("serving.result_cache.misses") == 1
    assert d.get("serving.result_cache.hits", 0) == 0
    assert d.get("rel.host_syncs") == 1


def test_skip_result_cache_and_streamed_inputs_bypass(data):
    rels = _ingest(data)
    before = obs.kernel_stats()
    run_fused(PLANS["q3"], rels, device=CPU, skip_result_cache=True)
    assert not any("result_cache" in k for k in obs.stats_since(before))
    host = dict(rels)
    host["store_sales"] = HostTable.from_df(data["store_sales"])
    before = obs.kernel_stats()
    run_fused(PLANS["q3"], host, device=CPU)
    run_fused(PLANS["q3"], host, device=CPU)
    assert not any("result_cache" in k for k in obs.stats_since(before))


def test_hit_miss_counting_over_a_pass(data):
    rels = _ingest(data)
    for _ in range(2):
        for q in ("q1", "q2", "q9"):
            run_fused(PLANS[q], rels, device=CPU)
    st = obs.kernel_stats()
    assert st["serving.result_cache.misses"] == 3
    assert st["serving.result_cache.hits"] == 3
    assert obs.gauge("serving.result_cache.entries").value == 3


# --------------------------------------------------------------------------
# the tiers directly
# --------------------------------------------------------------------------

def _rel(n: int, seed: int = 0, nulls: bool = False) -> Rel:
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 40, n)
    valid = (rng.random(n) > 0.2) if nulls else None
    col = Column.from_numpy(vals, valid, device=CPU)
    f = Column.from_numpy(rng.random(n), device=CPU)
    return Rel(Table([col, f]), ["k", "v"],
               dicts={"k": np.array(["a", "b"], dtype=object)})


def test_whole_entry_lru_evicts_by_bytes():
    one = result_cache.rel_nbytes(_rel(100))
    cache = result_cache.ResultCache(3 * one)
    for i in range(3):
        assert cache.put(f"t{i}", _rel(100, i))
    assert cache.get("t0") is not None  # t0 is now the newest
    assert cache.put("t3", _rel(100, 3))  # evicts t1, the LRU
    assert cache.get("t1") is None and cache.get("t0") is not None
    assert len(cache) == 3 and cache.resident_bytes == 3 * one
    assert not cache.put("big", _rel(1000))
    st = obs.kernel_stats()
    assert st["serving.result_cache.evictions"] == 1
    assert st["serving.result_cache.too_large"] == 1
    assert st["serving.result_cache.hits"] == 2
    assert st["serving.result_cache.misses"] == 1


def _flat(n: int, seed: int = 0):
    """The reference test's flat result (``tests/test_pages.py``), as a
    frame both packages ingest."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": np.arange(n, dtype=np.int64),
                         "v": rng.integers(0, 1000, n).astype(np.int64)})


def _paged_pair(max_bytes: int, pbytes: int):
    return (result_cache.PagedResultCache(max_bytes, pbytes),
            ref_rc.PagedResultCache(max_bytes=max_bytes, pbytes=pbytes))


def _case_roundtrip(cache, mine: bool):
    rel = (rel_from_df(_flat(1000), device=CPU) if mine
           else ref_rel_plain(_flat(1000)))
    assert cache.put("a", rel)
    got = cache.get("a")
    assert got is not None and got is not rel  # rebuilt, not pinned
    _frames_equal(got.to_df(), rel.to_df())
    return {"len": len(cache), "bytes": cache.resident_bytes}


def _case_page_eviction(cache, mine: bool):
    # 4096 rows x 2 int64 columns: 16 data pages of 4096 bytes and one
    # page of (empty) dictionary charge, 17 pages an entry
    def rel(seed):
        df = _flat(4096, seed)
        return rel_from_df(df, device=CPU) if mine else ref_rel_plain(df)
    a, b = rel(1), rel(2)
    assert cache.put("a", a) and cache.put("b", b)
    out = {"len2": len(cache), "bytes2": cache.resident_bytes}
    assert cache.put("c", rel(3))  # admission needs 15 pages of a
    out.update(len3=len(cache), bytes3=cache.resident_bytes)
    assert cache.resident_bytes <= cache.max_bytes
    out["a"] = cache.get("a") is None  # dead: misses and refunds
    out.update(len_after=len(cache), bytes_after=cache.resident_bytes)
    _frames_equal(cache.get("b").to_df(), b.to_df())
    return out


def _case_too_large(cache, mine: bool):
    df = _flat(4096)
    assert not cache.put("big", rel_from_df(df, device=CPU) if mine
                         else ref_rel_plain(df))
    return {"len": len(cache), "bytes": cache.resident_bytes}


def _case_opaque(cache, mine: bool):
    df = _flat(64)
    rel = rel_from_df(df, device=CPU) if mine else ref_rel_plain(df)
    rel.limit = 5  # unflushed decoration: not pageable losslessly
    assert cache.put("a", rel)
    assert cache.get("a") is rel  # stored whole, page-rounded
    return {"len": len(cache), "bytes": cache.resident_bytes}


@pytest.mark.parametrize("case, caps, want", [
    (_case_roundtrip, (1 << 20, 4096),
     {"serving.result_cache.hits": 1}),
    (_case_page_eviction, (36 * 4096, 4096),
     {"serving.result_cache.page_evictions": 15,
      "serving.result_cache.misses": 1, "serving.result_cache.hits": 1}),
    (_case_too_large, (4096, 4096), {"serving.result_cache.too_large": 1}),
    (_case_opaque, (1 << 20, 4096), {"serving.result_cache.hits": 1}),
], ids=["roundtrip", "page_eviction", "too_large", "opaque_limit"])
def test_paged_cache_matches_reference(case, caps, want):
    """The reference's four paged-cache cases on both packages: the same
    counters (15 page evictions and no whole eviction where admission
    needs 15 pages), lengths and resident bytes."""
    from spark_rapids_jni_tpu import obs as ref_obs
    mine, ref = _paged_pair(*caps)
    ref_obs.reset_kernel_stats()
    got = case(mine, True)
    assert got == case(ref, False)
    for stats in (obs.kernel_stats(), ref_obs.kernel_stats()):
        assert {k: v for k, v in stats.items()
                if k.startswith("serving.result_cache.")
                and not k.endswith("uncacheable")} == want
    if case is _case_page_eviction:
        assert got == {"len2": 2, "bytes2": 34 * 4096, "len3": 3,
                       "bytes3": 36 * 4096, "a": True, "len_after": 2,
                       "bytes_after": 34 * 4096}
    ref_obs.reset_kernel_stats()


def test_paged_cache_keeps_nulls_and_stats():
    """A lossless round trip with nulls: validity, ``value_range``,
    ``unique`` and the dictionaries kept, every buffer a new tensor, and
    the charge the reference's for the same shapes."""
    from spark_rapids_jni_tpu.columnar import Column as RefColumn
    from spark_rapids_jni_tpu.columnar import Table as RefTable
    from spark_rapids_jni_tpu.tpcds.rel import Rel as RefRel
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 5000, 3000)
    valid = rng.random(3000) > 0.25
    codes = rng.integers(0, 2, 3000)
    dicts = {"s": np.array(["a", "b"], dtype=object)}
    rel = Rel(Table([Column.from_numpy(vals, valid, device=CPU),
                     Column.from_numpy(vals * 0.5, device=CPU),
                     Column.from_numpy(codes, device=CPU)]),
              ["k", "v", "s"], dicts=dicts)
    ref = RefRel(RefTable([RefColumn.from_numpy(vals, valid),
                           RefColumn.from_numpy(vals * 0.5),
                           RefColumn.from_numpy(codes)]), ["k", "v", "s"],
                 dicts=dicts)
    mine, theirs = _paged_pair(1 << 20, 4096)
    assert mine.put("a", rel) and theirs.put("a", ref)
    assert mine.resident_bytes == theirs.resident_bytes
    got, want = mine.get("a"), theirs.get("a")
    _frames_equal(got.to_df(), rel.to_df())
    _frames_equal(got.to_df(), want.to_df())
    assert got.dicts.keys() == dicts.keys()
    for g, c, w in zip(got.table.columns, rel.table.columns,
                       want.table.columns):
        assert (g.value_range, g.unique) == (c.value_range, c.unique) \
            == (w.value_range, w.unique)
        for a, b in ((g.data, c.data), (g.validity, c.validity)):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    # the pages are row-aligned views of at most a page each
    assert all(p.nbytes <= 4096 for p in mine.resident_pages())
    assert sum(p.nbytes for p in mine.resident_pages()) == \
        sum(c.data.nbytes + (0 if c.validity is None else c.validity.nbytes)
            for c in rel.table.columns)


def test_paged_cache_dead_entry_frees_its_pages():
    """The first stripped page kills the entry: its host buffers go at
    once (its remaining charge stays until its next get), and every
    later put and get keeps the reference's accounting."""
    cache = result_cache.PagedResultCache(36 * 4096, 4096)
    cache.put("a", rel_from_df(_flat(4096, 1), device=CPU))
    cache.put("b", rel_from_df(_flat(4096, 2), device=CPU))
    assert len(cache.resident_pages()) == 32
    cache.put("c", rel_from_df(_flat(4096, 3), device=CPU))
    assert len(cache.resident_pages()) == 32  # a's 16 gone, c's 16 came
    assert len(cache.resident_tensors()) == 4
    assert cache.resident_bytes == 36 * 4096 and len(cache) == 3
    # d needs 3 pages: a's last data page (its husk, with its dictionary
    # page, then drops whole) and one page of b, now dead too
    cache.put("d", rel_from_df(_flat(256, 4), device=CPU))
    st = obs.kernel_stats()
    assert st["serving.result_cache.page_evictions"] == 15 + 1 + 1
    assert st["serving.result_cache.evictions"] == 1
    assert len(cache.resident_pages()) == 16 + 2  # c's and d's
    assert cache.get("a") is None and len(cache) == 3
    assert cache.get("b") is None and len(cache) == 2
    assert cache.resident_bytes == 17 * 4096 + 3 * 4096


def test_paged_cache_thread_safety():
    """Puts, gets and evictions from many threads keep the byte total
    equal to the live entries' charges."""
    import sys
    import threading
    cache = result_cache.PagedResultCache(40 * 1024, 1024)
    rels = [rel_from_df(_flat(64 * (i % 5 + 1), i), device=CPU)
            for i in range(10)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors = []

    def work(t):
        try:
            for i in range(200):
                k = (t * 7 + i) % 10
                if i % 3:
                    cache.put(f"r{k}", rels[k])
                else:
                    got = cache.get(f"r{k}")
                    if got is not None:
                        assert got.num_rows == rels[k].num_rows
        except Exception as e:  # reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    with cache._lock:
        live = sum(result_cache._live_bytes(e, 1024)
                   for e in cache._entries.values())
        assert live == cache._bytes <= cache.max_bytes


def test_reference_tiers_share_the_accounting(monkeypatch):
    """The reference's whole-entry tier charges the same bytes for the
    same column shapes."""
    from spark_rapids_jni_tpu.columnar import Column as RefColumn
    from spark_rapids_jni_tpu.columnar import Table as RefTable
    from spark_rapids_jni_tpu.tpcds.rel import Rel as RefRel
    vals = np.arange(100, dtype=np.int64)
    ref = RefRel(RefTable([RefColumn.from_numpy(vals),
                           RefColumn.from_numpy(vals * 0.5)]), ["k", "v"],
                 dicts={"k": np.array(["a", "b"], dtype=object)})
    mine = Rel(Table([Column.from_numpy(vals, device=CPU),
                      Column.from_numpy(vals * 0.5, device=CPU)]),
               ["k", "v"], dicts={"k": np.array(["a", "b"], dtype=object)})
    assert result_cache.rel_nbytes(mine) == ref_rc.rel_nbytes(ref)


def test_executor_builds_the_control_plane(monkeypatch):
    # the switch builds a control plane, off builds none
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    ex = QueryExecutor(device=CPU)
    try:
        assert ex._control is not None
    finally:
        ex.close(timeout=60)
    monkeypatch.setenv("SRT_CONTROL_PLANE", "0")
    ex = QueryExecutor(device=CPU)
    assert ex._control is None
    ex.close(timeout=60)
