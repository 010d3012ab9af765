"""The page ledger of the PyTorch/CUDA port, against the JAX package.

The geometry (page size snap, bucket ladder, ``pages_for``,
``ragged_capacity``) and the occupancy masks must equal the reference's
over a grid; the pool's lease accounting, gauges, idempotent release
and exhaustion (``None``, counted, never an error) follow the
reference's tests (``tests/test_pages.py``); and the morsel pump's paged
staging route is counted and exact, and degrades, counted, to
whole-buffer staging when the pool is starved, with answers equal to
the reference's in-core run.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.exec import pages as ref_pages
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds import queries as RQ
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df
from spark_rapids_jni_tpu.tpcds.rel import run_fused as ref_run_fused

from spark_rapids_jni_tpu_torch import obs
from spark_rapids_jni_tpu_torch.exec import (HostTable, pages,
                                             reset_morsel_budget_probe,
                                             reset_standing_state)
from spark_rapids_jni_tpu_torch.exec.runner import run_morsels
from spark_rapids_jni_tpu_torch.tpcds import PLANS
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused

from test_torch_morsel import compare

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_pool():
    pages.reset()
    ref_pages.reset()
    reset_morsel_budget_probe()
    yield
    pages.reset()
    ref_pages.reset()
    reset_morsel_budget_probe()


@pytest.fixture(scope="module")
def data():
    return ref_generate(sf=0.2, seed=13)


@pytest.fixture(scope="module")
def rels(data):
    return {name: rel_from_df(df, device=CPU) for name, df in data.items()}


# --------------------------------------------------------------------------
# 1. geometry and masks against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [None, "7", "1024", "65000", "65536",
                                 "100000", "junk"])
def test_page_bytes_matches_reference(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("SRT_PAGE_BYTES", raising=False)
    else:
        monkeypatch.setenv("SRT_PAGE_BYTES", raw)
    assert pages.page_bytes() == ref_pages.page_bytes()


def test_bucket_ladder_and_pages_for_match_reference():
    for n in list(range(0, 200)) + [1000, 4097, 65535, 1 << 20]:
        assert pages.bucket_pages(n) == ref_pages.bucket_pages(n), n
        for pb in (1024, 4096, 65536):
            assert pages.pages_for(n, pb) == ref_pages.pages_for(n, pb)
    got, n = [], 1
    while len(got) < 10:
        b = pages.bucket_pages(n)
        if b not in got:
            got.append(b)
        n = b + 1
    assert got == [1, 2, 3, 4, 6, 8, 12, 16, 24, 32]


@pytest.mark.parametrize("page", ["4096", "65536"])
def test_ragged_capacity_matches_reference(page, monkeypatch):
    monkeypatch.setenv("SRT_PAGE_BYTES", page)
    for k in (1, 2, 3, 5, 7):
        for slot in (1, 1000, 65536, 100_000, 10_000_000):
            for cap in (k, k + 1, 2 * k, 8 * k):
                r = pages.ragged_capacity(k, slot, cap)
                assert r == ref_pages.ragged_capacity(k, slot, cap)
                assert k <= r <= max(k, cap)


@pytest.mark.parametrize("live,cap,prows", [
    (0, 8, 4), (1, 8, 4), (4, 8, 4), (5, 8, 4), (8, 8, 4),
    (3, 10, 4), (10, 10, 3), (7, 16, 16), (0, 0, 4)])
def test_masks_match_reference(live, cap, prows):
    got = pages.live_row_mask(live, cap, prows)
    np.testing.assert_array_equal(
        got, ref_pages.live_row_mask(live, cap, prows))
    np.testing.assert_array_equal(got, np.arange(cap) < live)
    np.testing.assert_array_equal(
        pages.occupancy_mask(live, cap, prows),
        ref_pages.occupancy_mask(live, cap, prows))
    assert pages.page_rows(8, 4096) == ref_pages.page_rows(8, 4096)


# --------------------------------------------------------------------------
# 2. the pool
# --------------------------------------------------------------------------

def test_pool_lease_accounting_and_gauges():
    pool = pages.PagePool(budget_bytes=12 * 4096, pbytes=4096)
    ref = ref_pages.PagePool(budget_bytes=12 * 4096, pbytes=4096)
    before = obs.kernel_stats()
    lease, rlease = pool.lease(5000, tag="t"), ref.lease(5000, tag="t")
    assert (lease.pages, lease.nbytes, lease.live_bytes,
            lease.padded_bytes) == (rlease.pages, rlease.nbytes,
                                    rlease.live_bytes, rlease.padded_bytes)
    assert lease.pages == 2 and lease.nbytes == 8192
    assert pool.leased_bytes == 8192 and pool.n_leases == 1
    assert obs.gauge("mem.pool.bytes_leased").value == 8192
    assert obs.gauge("mem.pool.bytes_padded").value == 3192
    assert obs.gauge("mem.pool.utilization_pct").value == 5000 * 100 // 8192
    lease.release()
    lease.release()  # idempotent: no double refund
    assert pool.leased_bytes == 0 and pool.n_leases == 0
    assert obs.gauge("mem.pool.bytes_leased").value == 0
    d = obs.stats_since(before)
    assert d.get("mem.pool.leases") == 1
    assert d.get("mem.pool.exhausted", 0) == 0


def test_pool_exhaustion_returns_none_counted_never_raises():
    pool = pages.PagePool(budget_bytes=3 * 4096, pbytes=4096)
    held = pool.lease(3 * 4096)  # fills the budget exactly (rung 3)
    assert held is not None
    before = obs.kernel_stats()
    assert pool.lease(1) is None
    assert obs.stats_since(before).get("mem.pool.exhausted") == 1
    assert pool.leased_bytes == 3 * 4096
    held.release()
    assert pool.lease(1) is not None


def test_zero_page_memoized():
    a = pages.zero_page_device(np.int64, (8,), CPU)
    assert pages.zero_page_device(np.int64, (8,), CPU) is a
    assert torch.equal(a, torch.zeros(8, dtype=torch.int64))
    assert pages.zero_page_device(np.int64, (4,), CPU) is not a


def test_singleton_follows_env(monkeypatch):
    monkeypatch.setenv("SRT_PAGE_POOL_BYTES", "0")
    assert pages.page_pool() is None
    monkeypatch.setenv("SRT_PAGE_POOL_BYTES", "8192")
    pool = pages.page_pool()
    assert pool is not None and pool.budget_bytes == 8192
    assert pages.page_pool() is pool
    monkeypatch.setenv("SRT_PAGE_POOL_BYTES", "16384")
    assert pages.page_pool().budget_bytes == 16384


# --------------------------------------------------------------------------
# 3. the morsel pump's paged route and its starved degradation
# --------------------------------------------------------------------------

def _q1_host(data, rels):
    host = dict(rels)
    host["store_returns"] = HostTable.from_df(data["store_returns"])
    return host


def _ref_q1(data):
    return ref_run_fused(RQ._q1, {n: ref_rel_from_df(df)
                                  for n, df in data.items()}).to_df()


@pytest.fixture(scope="module")
def ref_q1(data):
    return _ref_q1(data)


def test_morsel_paged_route_counted_and_exact(data, rels, ref_q1,
                                              monkeypatch):
    monkeypatch.setenv("SRT_PAGE_BYTES", "4096")  # several pages a chunk
    reset_standing_state()
    before = obs.kernel_stats()
    info = {}
    got = run_morsels(PLANS["q1"], _q1_host(data, rels), info, morsels=4,
                      device=CPU).to_df()
    d = obs.stats_since(before)
    assert d.get("exec.morsel.paged") == 1  # the default pool: paged on
    assert d.get("exec.morsel.paged_pages", 0) > 0
    assert d.get("exec.morsel.pool_degraded", 0) == 0
    assert info["morsel"]["paged"] is True
    compare(got, ref_q1, "paged q1")
    # the pages leased for the run went back
    assert pages.page_pool().n_leases == 0


def test_morsel_degrades_to_unpaged_when_pool_starved(data, rels, ref_q1,
                                                      monkeypatch):
    reset_standing_state()
    monkeypatch.setenv("SRT_PAGE_POOL_BYTES", "1")  # nothing ever fits
    before = obs.kernel_stats()
    got = run_fused(PLANS["q1"], _q1_host(data, rels), morsels=4,
                    device=CPU).to_df()
    d = obs.stats_since(before)
    assert d.get("exec.morsel.pool_degraded") == 1
    assert d.get("exec.morsel.paged", 0) == 0
    assert d.get("mem.pool.exhausted") == 1
    compare(got, ref_q1, "starved q1")


def test_paged_and_whole_buffer_staging_agree(data, rels, monkeypatch):
    """The two staging routes over one staging object in turns: a paged
    run after a whole-buffer one (and back) leaves no old rows live."""
    monkeypatch.setenv("SRT_PAGE_BYTES", "1024")
    host = _q1_host(data, rels)
    outs = []
    for pool in ("268435456", "0", "268435456"):
        monkeypatch.setenv("SRT_PAGE_POOL_BYTES", pool)
        reset_standing_state()
        outs.append(run_fused(PLANS["q1"], host, morsels=3,
                              device=CPU).to_df())
    compare(outs[1], outs[0], "whole-buffer vs paged", 0, 0)
    compare(outs[2], outs[0], "paged again", 0, 0)
