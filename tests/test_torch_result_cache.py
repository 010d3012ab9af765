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
- the paged tier, the cache while the page ledger (``exec/pages.py``)
  is on: page-rounded charging, the pool's lease, released when an
  entry is evicted; a refused lease still caches the result, counted;
- ``result_cache()`` re-reads ``SRT_RESULT_CACHE_BYTES`` each call;
- the executor in front of the cache refuses ``SRT_CONTROL_PLANE=1``
  (the control plane is not ported) instead of ignoring it.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_jni_tpu.serving import result_cache as ref_rc
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
    assert result_cache.result_cache().page_bytes == pages.page_bytes()
    monkeypatch.setenv("SRT_PAGE_POOL_BYTES", "0")
    c = result_cache.result_cache()
    assert c.page_bytes == 0 and c.max_bytes == int(CAP)
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
    assert (cache.page_bytes > 0) == paged
    assert (pages.page_pool() is not None
            and pages.page_pool().n_leases == 1) == paged


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


def test_paged_tier_charges_pages_and_leases_from_the_ledger(monkeypatch):
    monkeypatch.setenv("SRT_PAGE_BYTES", "1024")
    pb = 1024
    cache = result_cache.ResultCache(1 << 20, pb)
    r = _rel(1000, nulls=True)  # 8000-byte columns: 8 pages each
    assert cache.put("a", r)
    # two data columns of 8 pages, a 1-page validity, one dict page
    assert cache.resident_bytes == (8 + 8 + 1 + 1) * pb
    assert result_cache.paged_nbytes(r, pb) == (8 + 8 + 1 + 1) * pb
    pool = pages.page_pool()
    assert pool.n_leases == 1
    assert obs.gauge("mem.pool.bytes_leased").value >= 18 * pb
    assert cache.get("a") is r
    cache.clear()
    assert pool.n_leases == 0 and cache.resident_bytes == 0


def test_paged_tier_evicts_pages_then_refunds_a_dead_entry(monkeypatch):
    """An evicted entry gives its pages back to the ledger."""
    monkeypatch.setenv("SRT_PAGE_BYTES", "1024")
    pb = 1024
    one = (8 + 8 + 1) * pb  # 1000 rows, no nulls
    cache = result_cache.ResultCache(2 * one + 2 * pb, pb)
    assert cache.put("a", _rel(1000, 1))
    assert cache.put("b", _rel(1000, 2))
    pool = pages.page_pool()
    assert pool.n_leases == 2
    assert cache.put("c", _rel(200, 3))  # needs 2 + 2 + 1 pages: evicts a
    st = obs.kernel_stats()
    assert st["serving.result_cache.evictions"] == 1
    assert pool.n_leases == 2  # a's lease went back, c's came
    assert cache.get("a") is None
    assert cache.get("b") is not None and cache.get("c") is not None
    assert len(cache) == 2
    assert cache.resident_bytes == one + 5 * pb <= cache.max_bytes


def test_paged_tier_keeps_a_result_whole_when_the_pool_refuses(monkeypatch):
    monkeypatch.setenv("SRT_PAGE_BYTES", "1024")
    monkeypatch.setenv("SRT_PAGE_POOL_BYTES", "2048")  # too small a pool
    pages.reset()
    cache = result_cache.ResultCache(1 << 20, 1024)
    r = _rel(1000)
    assert cache.put("a", r)
    assert cache.get("a") is r
    st = obs.kernel_stats()
    assert st["serving.result_cache.pool_degraded"] == 1
    assert st["mem.pool.exhausted"] == 1


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


def test_executor_refuses_the_control_plane_switch(monkeypatch):
    monkeypatch.setenv("SRT_CONTROL_PLANE", "1")
    with pytest.raises(NotImplementedError, match="control plane"):
        QueryExecutor(device=CPU)
    monkeypatch.setenv("SRT_CONTROL_PLANE", "0")
    QueryExecutor(device=CPU).close(timeout=60)
