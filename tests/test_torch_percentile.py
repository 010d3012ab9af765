"""Exact percentiles (histogram) and t-digests of the PyTorch/CUDA port
against the JAX package on the same numpy inputs (on the CPU).

Mirrors every case of ``test_histogram.py`` and ``test_tdigest.py``,
then holds seeded groups against the reference: nulls, empty and
all-null groups, null keys, -0.0, NaN and infinities.

- Histograms and exact percentiles are bit-equal to the reference
  (counts, offsets, values, the float64 interpolation).
- t-digest: weights and offsets exact; cluster ids equal on every row
  whose ``k(q) - k(0)`` lies more than 1e-9 from an integer (the rows
  within it are counted and bounded); centroid means within 1e-9 of the
  running sum of |w x| at the group's tail, over the centroid's weight
  (both packages read weighted sums off one float64 cumulative sum, in
  different summation orders).
- Merges take the reference's partials, carried over as LIST<STRUCT>
  columns by ``tpcds.carry.table_from_arrays``, so both packages merge
  the same inputs.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.ops import histogram as ref_hist
from spark_rapids_jni_tpu.ops import tdigest as ref_td

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops.histogram import (
    group_histogram, group_percentile, merge_histograms,
    percentile_from_histogram)
from spark_rapids_jni_tpu_torch.ops.tdigest import (
    clusters_from_quantiles, group_tdigest, merge_tdigests,
    percentile_approx)
from spark_rapids_jni_tpu_torch.tpcds.carry import table_from_arrays

CPU = torch.device("cpu")


def _mk(keys, vals, valid=None, kvalid=None):
    kt = Table([Column.from_numpy(np.asarray(keys, np.int64), kvalid,
                                  device=CPU)])
    vc = Column.from_numpy(np.asarray(vals, np.float64), valid, device=CPU)
    return kt, vc


def _rmk(keys, vals, valid=None, kvalid=None):
    kt = RefTable([RefColumn.from_numpy(np.asarray(keys, np.int64), kvalid)])
    vc = RefColumn.from_numpy(np.asarray(vals, np.float64), valid)
    return kt, vc


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------------------
# test_histogram.py
# --------------------------------------------------------------------------

def test_percentile_matches_numpy():
    rng = np.random.default_rng(41)
    keys = rng.integers(0, 8, 500)
    vals = rng.standard_normal(500) * 10
    out = group_percentile(*_mk(keys, vals), [0.0, 0.25, 0.5, 0.9, 1.0])
    for gi, g in enumerate(out.column(0).data.numpy()):
        grp = vals[keys == g]
        for pi, p in enumerate([0.0, 0.25, 0.5, 0.9, 1.0]):
            got = float(out.column(1 + pi).data[gi])
            exp = np.percentile(grp, p * 100, method="linear")
            np.testing.assert_allclose(got, exp, rtol=1e-12)


def test_percentile_nulls_ignored_and_empty_group_null():
    kt, vc = _mk([0, 0, 0, 1, 1, 2], [1.0, 2.0, 3.0, 5.0, 7.0, 9.0],
                 np.array([True, True, False, True, True, False]))
    assert group_percentile(kt, vc, [0.5]).column(1).to_pylist() == \
        [1.5, 6.0, None]


def test_histogram_runs_and_counts():
    out_keys, hist = group_histogram(*_mk([0, 0, 0, 0, 1, 1],
                                          [2.0, 1.0, 2.0, 2.0, 4.0, 4.0]))
    assert out_keys.column(0).to_pylist() == [0, 1]
    assert hist.offsets.data.tolist() == [0, 2, 3]
    assert hist.child.children[0].data.tolist() == [1.0, 2.0, 4.0]
    assert hist.child.children[1].data.tolist() == [1, 3, 2]


def test_percentile_from_histogram_equals_direct():
    rng = np.random.default_rng(43)
    keys = rng.integers(0, 5, 300)
    vals = rng.integers(0, 20, 300).astype(np.float64)
    pcts = [0.1, 0.5, 0.99]
    direct = group_percentile(*_mk(keys, vals), pcts)
    _, hist = group_histogram(*_mk(keys, vals))
    via = percentile_from_histogram(hist, pcts)
    for pi in range(len(pcts)):
        np.testing.assert_allclose(direct.column(1 + pi).data.numpy(),
                                   via.column(pi).data.numpy(), rtol=1e-12)


def _same_hist(got, want):
    (gk, gh), (wk, wh) = got, want
    assert gk.column(0).to_pylist() == wk.column(0).to_pylist()
    np.testing.assert_array_equal(gh.offsets.data.numpy(),
                                  np.asarray(wh.children[0].data))
    for k in range(2):
        np.testing.assert_array_equal(
            gh.child.children[k].data.numpy(),
            np.asarray(wh.children[1].children[k].data))


def test_merge_histograms_partial_aggregation():
    rng = np.random.default_rng(47)
    keys = rng.integers(0, 4, 400)
    vals = rng.integers(0, 10, 400).astype(np.float64)
    p1 = group_histogram(*_mk(keys[:200], vals[:200]))
    p2 = group_histogram(*_mk(keys[200:], vals[200:]))
    mk, mh = merge_histograms([p1, p2])
    fk, fh = group_histogram(*_mk(keys, vals))
    assert mk.column(0).to_pylist() == fk.column(0).to_pylist()
    assert torch.equal(mh.offsets.data, fh.offsets.data)
    for k in range(2):
        assert torch.equal(mh.child.children[k].data,
                           fh.child.children[k].data)
    via = percentile_from_histogram(mh, [0.5])
    direct = group_percentile(*_mk(keys, vals), [0.5])
    np.testing.assert_allclose(direct.column(1).data.numpy(),
                               via.column(0).data.numpy(), rtol=1e-12)


def test_merge_preserves_empty_groups_and_all_null_parts():
    p1 = group_histogram(*_mk([0, 1, 1], [5.0, 1.0, 2.0],
                              np.array([True, False, False])))
    p2 = group_histogram(*_mk([0], [7.0]))
    mk, mh = merge_histograms([p1, p2])
    assert mk.column(0).to_pylist() == [0, 1]
    assert mh.offsets.data.tolist() == [0, 2, 2]
    assert mh.child.children[0].data.tolist() == [5.0, 7.0]
    p3 = group_histogram(*_mk([3], [1.0], np.array([False])))
    mk2, mh2 = merge_histograms([p3])
    assert mk2.column(0).to_pylist() == [3]
    assert mh2.offsets.data.tolist() == [0, 0]


def test_merge_histograms_preserves_null_keys():
    def part(keys, kvalid, vals):
        return group_histogram(*_mk(keys, vals, None, np.asarray(kvalid)))
    mk, mh = merge_histograms([part([0, 0], [False, True], [10.0, 20.0]),
                               part([0], [False], [30.0])])
    assert mk.num_rows == 2
    kv = mk.column(0).to_pylist()
    assert sorted(kv, key=lambda x: (x is not None, x)) == [None, 0]
    offs = mh.offsets.data.numpy()
    vals = mh.child.children[0].data.numpy()
    by_key = {kv[i]: sorted(vals[offs[i]:offs[i + 1]].tolist())
              for i in range(2)}
    assert by_key[None] == [10.0, 30.0]
    assert by_key[0] == [20.0]


# --------------------------------------------------------------------------
# test_tdigest.py
# --------------------------------------------------------------------------

def test_accuracy_vs_exact():
    rng = np.random.default_rng(73)
    keys = rng.integers(0, 4, 20_000)
    vals = rng.standard_normal(20_000) * 100 + 50
    gk, dig = group_tdigest(*_mk(keys, vals), delta=200)
    pcts = [0.01, 0.25, 0.5, 0.75, 0.99]
    est = percentile_approx(dig, pcts)
    for gi, g in enumerate(gk.column(0).data.numpy()):
        grp = np.sort(vals[keys == g])
        for pi, p in enumerate(pcts):
            got = float(est.column(pi).data[gi])
            rank = np.searchsorted(grp, got) / len(grp)
            assert abs(rank - p) < 0.015, (g, p, rank)


def test_digest_size_bounded_by_delta():
    rng = np.random.default_rng(79)
    _, dig = group_tdigest(*_mk(np.zeros(50_000, np.int64),
                                rng.standard_normal(50_000)), delta=100)
    n_centroids = int(dig.offsets.data[-1])
    assert 30 < n_centroids <= 110


def test_merge_consistency():
    rng = np.random.default_rng(83)
    keys = rng.integers(0, 3, 10_000)
    vals = rng.exponential(10.0, 10_000)
    p1 = group_tdigest(*_mk(keys[:5000], vals[:5000]), delta=150)
    p2 = group_tdigest(*_mk(keys[5000:], vals[5000:]), delta=150)
    mk, md = merge_tdigests([p1, p2], delta=150)
    est = percentile_approx(md, [0.5])
    for gi, g in enumerate(mk.column(0).data.numpy()):
        grp = np.sort(vals[keys == g])
        got = float(est.column(0).data[gi])
        assert abs(np.searchsorted(grp, got) / len(grp) - 0.5) < 0.03


def test_weights_total_preserved():
    _, dig = group_tdigest(*_mk([0] * 100 + [1] * 50,
                                np.arange(150, dtype=float)), delta=50)
    w = dig.child.children[1].data.numpy()
    offs = dig.offsets.data.numpy()
    assert np.isclose(w[offs[0]:offs[1]].sum(), 100)
    assert np.isclose(w[offs[1]:offs[2]].sum(), 50)


def test_null_and_empty_groups():
    _, dig = group_tdigest(*_mk([0, 0, 1], [1.0, 2.0, 9.0],
                                 np.array([True, True, False])))
    est = percentile_approx(dig, [0.5]).column(0).to_pylist()
    assert est[1] is None
    assert abs(est[0] - 1.5) < 1.0


def test_exact_for_tiny_groups():
    _, dig = group_tdigest(*_mk([0, 0, 0], [1.0, 2.0, 3.0]), delta=100)
    est = percentile_approx(dig, [0.0, 0.5, 1.0])
    assert abs(est.column(1).to_pylist()[0] - 2.0) < 1e-9
    assert est.column(0).to_pylist()[0] == 1.0
    assert est.column(2).to_pylist()[0] == 3.0


def test_merge_tdigests_preserves_null_keys():
    def part(keys, kvalid, vals):
        return group_tdigest(*_mk(keys, vals, None, np.asarray(kvalid)))
    mk, _ = merge_tdigests([part([0, 0], [False, True], [10.0, 20.0]),
                            part([0], [False], [30.0])])
    assert mk.num_rows == 2
    assert sorted(mk.column(0).to_pylist(),
                  key=lambda x: (x is not None, x)) == [None, 0]


# --------------------------------------------------------------------------
# seeded groups against the reference
# --------------------------------------------------------------------------

def _case(name, n=2000, seed=5):
    """(keys, key validity, values, value validity) of a named case."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 37, n)
    vals = rng.integers(-20, 20, n).astype(np.float64)
    kvalid, valid = None, rng.random(n) > 0.1
    if name == "specials":
        vals[::7] = -0.0
        vals[::11] = 0.0
        vals[::13] = np.nan
        vals[::29] = np.inf
        vals[::31] = -np.inf
    elif name == "continuous":
        vals = rng.standard_normal(n) * 1e3
    elif name == "null_keys":
        kvalid = rng.random(n) > 0.2
    elif name == "empty_groups":
        valid &= keys % 5 != 0  # every fifth group all null
    elif name == "all_null":
        valid[:] = False
    elif name == "one_row_groups":
        keys = np.arange(n)
    return keys, kvalid, vals, valid


CASES = ["plain", "specials", "continuous", "null_keys", "empty_groups",
         "all_null", "one_row_groups"]
PCTS = [0.0, 0.25, 0.5, 0.99, 1.0]


@pytest.mark.parametrize("case", CASES)
def test_group_percentile_bit_equal_reference(case):
    keys, kvalid, vals, valid = _case(case)
    want = ref_hist.group_percentile(*_rmk(keys, vals, valid, kvalid), PCTS)
    got = group_percentile(*_mk(keys, vals, valid, kvalid), PCTS)
    assert got.column(0).to_pylist() == want.column(0).to_pylist()
    for g, w in zip(got.columns[1:], want.columns[1:]):
        ok = np.asarray(w.valid_bool())
        np.testing.assert_array_equal(g.valid_bool().numpy(), ok)
        np.testing.assert_array_equal(g.data.numpy()[ok],
                                      np.asarray(w.data)[ok])


@pytest.mark.parametrize("case", CASES)
def test_group_histogram_equals_reference(case):
    keys, kvalid, vals, valid = _case(case)
    _same_hist(group_histogram(*_mk(keys, vals, valid, kvalid)),
               ref_hist.group_histogram(*_rmk(keys, vals, valid, kvalid)))


def test_histogram_runs_follow_the_reference_rule():
    # -0.0 sorts first and 0.0 joins its run; every NaN is a run of its
    # own (Spark's Percentile would keep -0.0 and 0.0 apart and count
    # the NaNs as one value)
    _, hist = group_histogram(*_mk([0] * 6, [0.0, -0.0, np.nan, 1.0,
                                             np.nan, -0.0]))
    vals = hist.child.children[0].data.numpy()
    assert hist.child.children[1].data.tolist() == [3, 1, 1, 1]
    assert math.copysign(1.0, vals[0]) == -1.0
    assert np.isnan(vals[2:]).all()


def _carry_parts(parts, names):
    """Reference (keys, LIST<STRUCT>) partials -> port partials through
    ``table_from_arrays`` (keys INT64 with validity)."""
    out = []
    for kt, lst in parts:
        kc = kt.columns[0]
        offs = np.asarray(lst.children[0].data)
        fields = lst.children[1].children
        col = table_from_arrays(
            [(int(T.TypeId.INT64), 0), (int(T.TypeId.LIST), 0)],
            [np.asarray(kc.data),
             (offs, ([(int(f.dtype.id), 0) for f in fields],
                     [np.asarray(f.data) for f in fields],
                     [None] * len(fields), names),
              (int(T.TypeId.STRUCT), 0))],
            [np.asarray(kc.valid_bool()), None], device=CPU)
        out.append((Table([col.columns[0]]), col.columns[1]))
    return out


@pytest.mark.parametrize("case", ["plain", "specials", "null_keys",
                                  "empty_groups"])
def test_merge_histograms_of_carried_partials_equal_reference(case):
    keys, kvalid, vals, valid = _case(case, n=1500)
    cuts = [(0, 400), (400, 1100), (1100, 1500)]
    parts = [ref_hist.group_histogram(*_rmk(
        keys[a:b], vals[a:b], valid[a:b],
        None if kvalid is None else kvalid[a:b])) for a, b in cuts]
    want = ref_hist.merge_histograms(parts)
    got = merge_histograms(_carry_parts(parts, ("value", "count")))
    _same_hist(got, want)
    w = ref_hist.percentile_from_histogram(want[1], PCTS)
    g = percentile_from_histogram(got[1], PCTS)
    for gc, wc in zip(g.columns, w.columns):
        ok = np.asarray(wc.valid_bool())
        np.testing.assert_array_equal(gc.valid_bool().numpy(), ok)
        np.testing.assert_array_equal(gc.data.numpy()[ok],
                                      np.asarray(wc.data)[ok])


def test_percentile_from_histogram_bit_equal_group_percentile():
    keys, _, vals, valid = _case("plain")
    _, hist = group_histogram(*_mk(keys, vals, valid))
    via = percentile_from_histogram(hist, PCTS)
    direct = group_percentile(*_mk(keys, vals, valid), PCTS)
    for v, d in zip(via.columns, direct.columns[1:]):
        assert torch.equal(v.valid_bool(), d.valid_bool())
        ok = d.valid_bool()
        assert torch.equal(v.data[ok], d.data[ok])


def _boundary_rows(q, delta):
    k = (delta / (2.0 * math.pi)) * np.arcsin(2.0 * q - 1.0) + delta / 4.0
    return np.abs(k - np.round(k)) < 1e-9


@pytest.mark.parametrize("delta", [10, 100, 150, 1000])
def test_cluster_ids_equal_reference_off_boundaries(delta):
    rng = np.random.default_rng(delta)
    q = np.concatenate([(np.arange(20_000) + 0.5) / 20_000, rng.random(20_000),
                        [0.0, 1.0, 0.5]])
    want = np.asarray(ref_td._clusters_from_quantiles(jnp.asarray(q),
                                                      float(delta)))
    got = clusters_from_quantiles(torch.from_numpy(q), float(delta)).numpy()
    near = _boundary_rows(q, delta)
    np.testing.assert_array_equal(got[~near], want[~near])
    # q = 0, 0.5 and 1 sit on boundaries (k - k0 = 0, delta/4, delta/2)
    assert near.sum() <= 3 + 16, int(near.sum())


def _digest_arrays(dig):
    offs = _np(dig.offsets.data if hasattr(dig, "offsets") and isinstance(
        dig, Column) else dig.children[0].data)
    st = dig.children[1]
    return offs, _np(st.children[0].data), _np(st.children[1].data)


def _running_abs(keys, kvalid, vals, valid):
    """Per group (in key order, nulls first), the running sum of |x| over
    the valid values of every group up to and including it."""
    order = np.lexsort((keys, np.ones_like(keys) if kvalid is None
                        else kvalid))
    k = np.where(kvalid if kvalid is not None else True, keys, -1)[order]
    a = np.where(valid, np.abs(vals), 0.0)[order]
    c = np.cumsum(a)
    tails = np.flatnonzero(np.append(k[1:] != k[:-1], True))
    return c[tails]


def _same_digest(got, want, bound_per_group):
    (gk, gd), (wk, wd) = got, want
    assert gk.column(0).to_pylist() == wk.column(0).to_pylist()
    g_offs, g_mean, g_w = _digest_arrays(gd)
    w_offs, w_mean, w_w = _digest_arrays(wd)
    np.testing.assert_array_equal(g_offs, w_offs)
    np.testing.assert_array_equal(g_w, w_w)
    grp = np.searchsorted(g_offs, np.arange(g_w.size), side="right") - 1
    np.testing.assert_array_less(np.abs(g_mean - w_mean),
                                 1e-9 * bound_per_group[grp] / g_w + 1e-300)


@pytest.mark.parametrize("case", ["continuous", "plain", "null_keys",
                                  "empty_groups", "one_row_groups"])
@pytest.mark.parametrize("delta", [20, 100])
def test_group_tdigest_equals_reference(case, delta):
    keys, kvalid, vals, valid = _case(case, n=3000, seed=delta)
    want = ref_td.group_tdigest(*_rmk(keys, vals, valid, kvalid), delta)
    got = group_tdigest(*_mk(keys, vals, valid, kvalid), delta)
    _same_digest(got, want, _running_abs(keys, kvalid, vals, valid))


@pytest.mark.parametrize("case", ["continuous", "null_keys",
                                  "empty_groups"])
def test_merge_tdigests_of_carried_partials_equal_reference(case):
    keys, kvalid, vals, valid = _case(case, n=3000, seed=9)
    cuts = [(0, 1000), (1000, 3000)]
    parts = [ref_td.group_tdigest(*_rmk(
        keys[a:b], vals[a:b], valid[a:b],
        None if kvalid is None else kvalid[a:b]), 50) for a, b in cuts]
    want = ref_td.merge_tdigests(parts, 50)
    got = merge_tdigests(_carry_parts(parts, ("mean", "weight")), 50)
    # the merge's values are the centroid means, weighted
    cents = np.concatenate([_digest_arrays(d)[1] * _digest_arrays(d)[2]
                            for _, d in parts])
    _same_digest(got, want, np.full(got[0].num_rows,
                                    np.abs(cents).sum() + 1.0))
    # percentile_approx of the same digest: the same arithmetic
    carried = _carry_parts([want], ("mean", "weight"))[0][1]
    w = ref_td.percentile_approx(want[1], [0.01, 0.5, 0.9, 1.0])
    g = percentile_approx(carried, [0.01, 0.5, 0.9, 1.0])
    for gc, wc in zip(g.columns, w.columns):
        ok = np.asarray(wc.valid_bool())
        np.testing.assert_array_equal(gc.valid_bool().numpy(), ok)
        np.testing.assert_array_equal(gc.data.numpy()[ok],
                                      np.asarray(wc.data)[ok])


def test_carry_builds_list_of_struct_columns():
    rng = np.random.default_rng(3)
    kt, vc = _rmk(rng.integers(0, 5, 50), rng.integers(0, 4, 50) * 1.0)
    ref_keys, ref_h = ref_hist.group_histogram(kt, vc)
    (_, col), = _carry_parts([(ref_keys, ref_h)], ("value", "count"))
    assert col.dtype.id == T.TypeId.LIST
    assert col.child.field_names == ("value", "count")
    offs = np.asarray(ref_h.children[0].data)
    fields = [np.asarray(f.data).tolist() for f in ref_h.children[1].children]
    assert col.to_pylist() == [list(zip(*fields))[offs[i]:offs[i + 1]]
                               for i in range(ref_h.size)]
    # a MAP: LIST<STRUCT<STRING, STRING>> with null rows and values
    offs = np.array([0, 2, 2, 3], np.int32)
    kch = np.frombuffer(b"abc", np.uint8)
    vch = np.frombuffer(b"xy", np.uint8)
    t = table_from_arrays(
        [(int(T.TypeId.LIST), 0)],
        [(offs, ([(int(T.TypeId.STRING), 0)] * 2,
                 [(np.array([0, 1, 2, 3], np.int32), kch),
                  (np.array([0, 1, 1, 2], np.int32), vch)],
                 [None, np.array([True, False, True])], ("key", "value")),
          (int(T.TypeId.STRUCT), 0))],
        [np.array([True, False, True])], device=CPU)
    assert t.columns[0].to_pylist() == [
        [("a", "x"), ("b", None)], None, [("c", "y")]]
