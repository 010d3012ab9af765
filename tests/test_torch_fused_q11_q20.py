"""The fused q11-q20 slice of the PyTorch/CUDA port against the JAX package.

q11-q20 run the string, decimal and window operator families. Each query
through the port's ``run_fused`` must equal the reference's
``QUERIES[q][0](rels)`` at sf 0.5 and sf 2, seed 7, both on the port's
own ingest (``rel_from_df``) and on the reference's ingested state
carried over (``carry.rel_from_arrays``): integers, strings and decimals
exact, floats within ``rtol=1e-12, atol=0``. Each fused run has no
fallback and at most one counted host sync. q11, q12 and q20 run again
on the ``bytes`` string route, and every query with the kernel routes
forced (their plain versions run on the CPU).
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.tpcds import QUERIES as REF_QUERIES
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df

from spark_rapids_jni_tpu_torch.obs import (dispatch_counts, kernel_stats,
                                            stats_since)
from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES
from spark_rapids_jni_tpu_torch.tpcds.carry import rel_from_arrays
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused

CPU = torch.device("cpu")
Q11_20 = [f"q{i}" for i in range(11, 21)]
BYTES_ROUTE = ["q11", "q12", "q20"]


def _carry(ref_rel):
    cols = ref_rel.table.columns
    return rel_from_arrays(
        list(ref_rel.names), [np.asarray(c.data) for c in cols],
        [None if c.validity is None else np.asarray(c.validity)
         for c in cols],
        [(c.value_range, c.unique, getattr(c, "_stats_flags", None))
         for c in cols],
        dict(ref_rel.dicts), device=CPU)


def assert_frames_match(got, want, qname, rtol=1e-12):
    assert list(got.columns) == list(want.columns), qname
    assert len(got) == len(want), qname
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64), rtol=rtol,
                atol=0, equal_nan=True, err_msg=f"{qname}.{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{qname}.{c}")


@pytest.fixture(scope="module", params=[0.5, 2], ids=["sf0.5", "sf2"])
def state(request):
    data = ref_generate(sf=request.param, seed=7)
    ref_rels = {n: ref_rel_from_df(df) for n, df in data.items()}
    want = {q: REF_QUERIES[q][0](ref_rels) for q in Q11_20}
    carried = {n: _carry(r) for n, r in ref_rels.items()}
    own = {n: rel_from_df(df, device=CPU) for n, df in data.items()}
    return data, {"carry": carried, "own": own}, want


def _run(rels, qname):
    before = kernel_stats()
    got = run_fused(PLANS[qname], rels, device="cpu").to_df()
    stats = stats_since(before)
    assert stats.get("rel.fused_fallbacks", 0) == 0, stats
    _, syncs = dispatch_counts(stats)
    assert syncs <= 1, f"{qname} host-sync budget blown: {stats}"
    return got, stats


@pytest.mark.parametrize("ingest", ["carry", "own"])
@pytest.mark.parametrize("qname", Q11_20)
def test_fused_query_equals_reference(state, qname, ingest):
    _, rels, want = state
    got, _ = _run(rels[ingest], qname)
    assert_frames_match(got, want[qname], qname)


@pytest.mark.parametrize("qname", BYTES_ROUTE)
def test_bytes_string_route_equals_reference(state, qname, monkeypatch):
    _, rels, want = state
    monkeypatch.setenv("SRT_STRING_ROUTE", "bytes")
    got, stats = _run(rels["own"], qname)
    assert_frames_match(got, want[qname], qname)
    assert any(k.startswith("rel.route.string.") and k.endswith(".bytes")
               for k in stats), stats


def test_forced_kernel_routes_run_the_plain_versions(state, monkeypatch):
    # SRT_*=cuda on CPU tensors: the planner takes the kernel routes and
    # each wrapper runs its plain version (the tensors lie on the CPU)
    _, rels, want = state
    monkeypatch.setenv("SRT_JOIN_METHOD", "cuda")
    monkeypatch.setenv("SRT_DENSE_GROUPBY", "cuda")
    before = kernel_stats()
    for q in Q11_20:
        got, _ = _run(rels["carry"], q)
        assert_frames_match(got, want[q], q)
    stats = stats_since(before)
    assert stats.get("rel.route.join.probe.cuda", 0) > 0, stats
    assert stats.get("rel.route.groupby.dense.cuda", 0) > 0, stats


def test_entry_points_and_oracles(state):
    # the port's own entry points, and its oracles, give the same frames
    data, rels, want = state
    for q in Q11_20:
        fn, oracle = QUERIES[q]
        assert_frames_match(fn(rels["own"], device="cpu"), want[q], q)
        assert_frames_match(oracle(data), want[q], q, rtol=1e-9)


def test_q15_overflow_counter_equals_the_oracle(state):
    data, rels, _ = state
    _, stats = _run(rels["own"], "q15")
    ss = data["store_sales"]
    over = int((ss.ss_list_price_cents.astype(object)
                * ss.ss_coupon_amt_cents > 2**31 - 1).sum())
    assert stats.get("rel.route.decimal.overflow") == over > 0
