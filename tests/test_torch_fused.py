"""The fused q1-q10 slice of the PyTorch/CUDA port against the JAX package.

Both packages get identical ingested state (the reference's ``Rel`` s,
exported to numpy and rebuilt with ``carry.rel_from_arrays``), and every
query of q1-q10 through the port's ``run_fused`` must equal the
reference's ``QUERIES[q][0](rels)`` at sf 0.5 and sf 2: integers exact,
floats within ``rtol=1e-12, atol=0``, the reference's own bound
(``tests/test_pallas_kernels.py``). Each fused run has no fallback and at
most one counted data-dependent host sync. The dense primitives are held
against the reference's on the same inputs, and a sweep with the kernel
routes forced runs K1/K2's plain versions through the planner on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.ops import fused_pipeline as ref_fp
from spark_rapids_jni_tpu.tpcds import QUERIES as REF_QUERIES
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.obs import (dispatch_counts, kernel_stats,
                                            stats_since)
from spark_rapids_jni_tpu_torch.ops import fused_pipeline as fp
from spark_rapids_jni_tpu_torch.tpcds import PLANS, QUERIES
from spark_rapids_jni_tpu_torch.tpcds.carry import rel_from_arrays
from spark_rapids_jni_tpu_torch.tpcds.rel import Rel, rel_from_df, run_fused

CPU = torch.device("cpu")
Q1_10 = [f"q{i}" for i in range(1, 11)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


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
    want = {q: REF_QUERIES[q][0](ref_rels) for q in Q1_10}
    rels = {n: _carry(r) for n, r in ref_rels.items()}
    return data, rels, want


# --------------------------------------------------------------------------
# q1-q10 against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qname", Q1_10)
def test_fused_query_equals_reference(state, qname):
    _, rels, want = state
    before = kernel_stats()
    got = run_fused(PLANS[qname], rels, device="cpu").to_df()
    stats = stats_since(before)
    assert_frames_match(got, want[qname], qname)
    assert stats.get("rel.fused_fallbacks", 0) == 0, stats
    _, syncs = dispatch_counts(stats)
    assert syncs <= 1, f"{qname} host-sync budget blown: {stats}"
    assert "rel.host_syncs.rel.verify_stats" not in stats  # trusted ingest


def test_own_ingest_gives_the_same_answers(state):
    data, _, want = state
    rels = {n: rel_from_df(df, device=CPU) for n, df in data.items()}
    for q in Q1_10:
        assert_frames_match(QUERIES[q][0](rels, device="cpu"), want[q], q)


def test_forced_kernel_routes_run_the_plain_versions(state, monkeypatch):
    # SRT_*=cuda on CPU tensors: the planner takes the kernel routes and
    # each wrapper runs its plain version (the tensors lie on the CPU)
    _, rels, want = state
    monkeypatch.setenv("SRT_JOIN_METHOD", "cuda")
    monkeypatch.setenv("SRT_DENSE_GROUPBY", "cuda")
    before = kernel_stats()
    for q in Q1_10:
        got = run_fused(PLANS[q], rels, device="cpu").to_df()
        assert_frames_match(got, want[q], q)
    stats = stats_since(before)
    assert stats.get("rel.fused_fallbacks", 0) == 0, stats
    assert stats.get("rel.route.join.probe.cuda", 0) > 0, stats
    assert stats.get("rel.route.groupby.dense.cuda", 0) > 0, stats
    assert stats.get("rel.route.join.cuda_degraded", 0) == 0, stats


@pytest.mark.parametrize("method", ["cuda", "xla"])
def test_only_the_gather_probe_builds_a_dense_map(state, monkeypatch,
                                                  method):
    # K1 builds its own hash table: on its route a build key proven
    # unique from trusted stats gets no direct-address map
    from spark_rapids_jni_tpu_torch.tpcds.oplib import relational
    _, rels, want = state
    built = []
    real = relational.build_dense_map
    monkeypatch.setattr(relational, "build_dense_map",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    monkeypatch.setenv("SRT_JOIN_METHOD", method)
    for q in ("q3", "q6", "q8"):
        got = run_fused(PLANS[q], rels, device="cpu").to_df()
        assert_frames_match(got, want[q], q)
    assert (len(built) == 0) == (method == "cuda"), built


def test_onehot_route_equals_reference(state, monkeypatch):
    _, rels, want = state
    monkeypatch.setenv("SRT_DENSE_GROUPBY", "onehot")
    for q in ("q3", "q6", "q10"):
        assert_frames_match(run_fused(PLANS[q], rels, device="cpu").to_df(),
                            want[q], q)


def test_run_fused_checks_the_device(state):
    _, rels, _ = state
    from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError
    with pytest.raises(CudfLikeError, match="lies on"):
        run_fused(PLANS["q9"], rels, device="meta")


def test_metrics_record_spans(state, monkeypatch):
    from spark_rapids_jni_tpu_torch.obs import span_records
    _, rels, _ = state
    monkeypatch.setenv("SRT_METRICS", "1")
    n0 = len(span_records())
    run_fused(PLANS["q5"], rels, device="cpu")
    recs = span_records()[n0:]
    names = {r.name for r in recs}
    assert {"rel.fused_program", "rel.materialize", "rel.join",
            "rel.groupby"} <= names
    join = next(r for r in recs if r.name == "rel.join")
    assert join.attrs["how"] == "left" and join.attrs["route"] == "dense"


# --------------------------------------------------------------------------
# FusedFallback: stale stats re-run the plan on the general kernels
# --------------------------------------------------------------------------

def _understate(rel: Rel, colname: str) -> Rel:
    cols = []
    for n in rel.names:
        c = rel.col(n)
        if n == colname:
            lo, hi = c.value_range
            c = dataclasses.replace(c, value_range=(lo, hi - 1))
        cols.append(c)
    return Rel(Table(cols), rel.names, dicts=rel.dicts)


@pytest.mark.parametrize("table,col,qname", [
    ("store_returns", "sr_store_sk", "q1"),
    ("customer", "c_customer_sk", "q1"),
    ("date_dim", "d_date_sk", "q3"),
])
def test_stale_stats_fall_back_to_general_path(table, col, qname):
    data = ref_generate(sf=0.5, seed=7)
    rels = {n: rel_from_df(df, device=CPU) for n, df in data.items()}
    rels[table] = _understate(rels[table], col)
    before = kernel_stats()
    got = QUERIES[qname][0](rels, device="cpu")
    stats = stats_since(before)
    assert stats.get("rel.fused_fallbacks", 0) == 1, stats
    assert stats.get("rel.stale_stats", 0) >= 1, stats
    # the general kernels order float sums differently from pandas: the
    # repo's oracle bound (tests/test_tpcds.py)
    want = QUERIES[qname][1](data)
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                   want[c].to_numpy(np.float64),
                                   rtol=1e-9, atol=1e-9)


# --------------------------------------------------------------------------
# the dense primitives against the reference's
# --------------------------------------------------------------------------

def test_build_dense_map_and_lookup_equal_reference():
    rng = np.random.default_rng(2)
    keys = rng.permutation(5000)[:1200].astype(np.int64) + 37
    mask = rng.random(1200) > 0.3
    probe = rng.integers(-50, 5100, 9000).astype(np.int64)
    pmask = rng.random(9000) > 0.5
    rmap = ref_fp.build_dense_map(RefColumn.from_numpy(keys),
                                  jnp.asarray(mask))
    gmap = fp.build_dense_map(Column.from_numpy(keys, device=CPU), _t(mask))
    assert (gmap.lo, gmap.width) == (rmap.lo, rmap.width)
    np.testing.assert_array_equal(gmap.rows.numpy(), np.asarray(rmap.rows))
    ri, rf = ref_fp.dense_lookup(rmap, jnp.asarray(probe), jnp.asarray(pmask))
    gi, gf = fp.dense_lookup(gmap, _t(probe), _t(pmask))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(rf))


def test_build_dense_map_checks():
    from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError
    dup = Column.from_numpy(np.array([1, 2, 2], np.int64), device=CPU)
    with pytest.raises(CudfLikeError, match="unique"):
        fp.build_dense_map(dup)
    stale = dataclasses.replace(
        Column.from_numpy(np.array([1, 2, 9], np.int64), device=CPU),
        value_range=(1, 5))
    with pytest.raises(CudfLikeError, match="value_range"):
        fp.build_dense_map(stale)


@pytest.mark.parametrize("method", ["scatter", "onehot", "cuda"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_dense_groupby_sum_count_equals_reference(method, kind):
    rng = np.random.default_rng(17)
    n, width = 3000, 300
    slots = rng.integers(-5, width + 5, n).astype(np.int32)
    live = rng.random(n) > 0.25
    vals = (rng.integers(-2**62, 2**62, n).astype(np.int64) if kind == "int"
            else np.round(rng.uniform(-100, 100, n), 2))
    rs, rc = ref_fp.dense_groupby_sum_count(
        jnp.asarray(slots), jnp.asarray(live), jnp.asarray(vals), width,
        "scatter")
    gs, gc = fp.dense_groupby_sum_count(_t(slots), _t(live), _t(vals), width,
                                        method)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    if kind == "int":
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    else:
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("take_min", [True, False])
def test_dense_groupby_extreme_equals_reference(take_min):
    rng = np.random.default_rng(4)
    n, width = 2000, 64
    slots = rng.integers(0, width + 3, n).astype(np.int32)
    live = rng.random(n) > 0.4
    vals = rng.integers(-10**12, 10**12, n).astype(np.int64)
    want = ref_fp.dense_groupby_extreme(jnp.asarray(slots),
                                        jnp.asarray(live),
                                        jnp.asarray(vals), width, take_min)
    got = fp.dense_groupby_extreme(_t(slots), _t(live), _t(vals), width,
                                   take_min)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_groupby_table_equals_reference():
    rng = np.random.default_rng(9)
    slots = rng.integers(0, 40, 500).astype(np.int32)
    live = rng.random(500) > 0.5
    vals = rng.integers(0, 1000, 500).astype(np.int64)
    want = ref_fp.dense_groupby_table(jnp.asarray(slots), jnp.asarray(live),
                                      jnp.asarray(vals), 40)
    got = fp.dense_groupby_table(_t(slots), _t(live), _t(vals), 40)
    for gc, wc in zip(got.columns, want.columns):
        np.testing.assert_array_equal(gc.data.numpy(), np.asarray(wc.data))
