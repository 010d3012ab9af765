"""The var/std/first/last/any/all/nunique aggregations of the PyTorch/CUDA
port's general groupby against the JAX package on the same numpy inputs
(on the CPU), with the reference's own cases.

Integers, bools and first/last values are byte-equal. var, std and
float sums are held at rtol=1e-9, not byte-equal: the reference sums by
cumulative-sum differences at the group boundaries, the port per group
(``index_add_``), so the last bits differ. nunique counts every NaN
as one value (Spark); the reference sorts NaNs by their raw bits there, so a group holding both a NaN and a
-NaN is held against a Python model of Spark's count instead.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_jni_tpu import types as ref_types
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.ops import groupby as ref_groupby

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import groupby

CPU = torch.device("cpu")
NEW_AGGS = ("var", "std", "first", "last", "any", "all", "nunique")


def _both(arrays, valids=None, dtypes=None):
    """The same host columns as a reference and a port table."""
    valids = valids or [None] * len(arrays)
    dtypes = dtypes or [None] * len(arrays)
    ref = RefTable([RefColumn.from_numpy(
        a, v, None if d is None else ref_types.DType(ref_types.TypeId(
            int(d.id)), d.scale)) for a, v, d in zip(arrays, valids, dtypes)])
    got = Table([Column.from_numpy(a, v, d, device=CPU)
                 for a, v, d in zip(arrays, valids, dtypes)])
    return ref, got


def _run(keys, vals, aggs):
    """(port result, reference result) of one groupby."""
    return (groupby.groupby_aggregate(keys[1], vals[1], aggs),
            ref_groupby.groupby_aggregate(keys[0], vals[0], aggs))


def _check(got, want, aggs):
    assert got.num_rows == want.num_rows
    n_keys = got.num_columns - len(aggs)
    for g, w in zip(got.columns[:n_keys], want.columns[:n_keys]):
        assert g.to_pylist() == w.to_pylist()
    for (_, agg), g, w in zip(aggs, got.columns[n_keys:],
                              want.columns[n_keys:]):
        gv, gok = g.to_numpy()
        wv, wok = w.to_numpy()
        np.testing.assert_array_equal(gok, wok, err_msg=agg)
        assert g.dtype.id == int(w.dtype.id), agg
        if agg in ("var", "std", "sum", "mean") and gv.dtype.kind == "f":
            np.testing.assert_allclose(gv[gok], wv[wok], rtol=1e-9,
                                       err_msg=agg)
        else:
            np.testing.assert_array_equal(gv[gok], wv[wok], err_msg=agg)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("key_nulls", [False, True])
def test_new_aggs_equal_reference(seed, key_nulls):
    rng = np.random.default_rng(seed)
    n = 2000
    k = rng.integers(0, 40, n).astype(np.int64)
    kv = rng.random(n) > 0.05 if key_nulls else None
    x = rng.standard_normal(n) * 100 + 1e6
    xv = rng.random(n) > 0.15
    i = rng.integers(-5, 5, n).astype(np.int32)
    iv = rng.random(n) > 0.3
    b = rng.integers(0, 2, n).astype(np.int8)
    bv = rng.random(n) > 0.2
    keys = _both([k], [kv])
    vals = _both([x, i, b], [xv, iv, bv], [None, None, T.BOOL8])
    aggs = [(0, "var"), (0, "std"), (0, "first"), (0, "last"),
            (0, "nunique"), (1, "first"), (1, "last"), (1, "nunique"),
            (1, "var"), (2, "any"), (2, "all"), (2, "nunique"),
            (0, "sum"), (1, "min"), (1, "count")]
    _check(*_run(keys, vals, aggs), aggs)


def test_two_keys_sparse_groups_equal_reference():
    # many one- and two-row groups: var/std NULL below two values
    rng = np.random.default_rng(9)
    n = 700
    k1 = rng.integers(0, 300, n).astype(np.int32)
    k2 = rng.integers(0, 3, n).astype(np.int64)
    x = np.round(rng.standard_normal(n), 3)
    aggs = [(0, a) for a in NEW_AGGS if a not in ("any", "all")]
    _check(*_run(_both([k1, k2]), _both([x]), aggs), aggs)


def test_first_last_any_all_nunique_reference_case():
    # test_sort_join_groupby.py's case
    k = np.array([1, 0, 1, 0, 1, 2], np.int64)
    v = np.array([10, 20, 30, 40, 30, 7], np.int64)
    vv = np.array([False, True, True, True, True, False])
    b = np.array([1, 0, 1, 1, 0, 0], np.int8)
    bv = np.array([True, True, True, True, True, False])
    aggs = [(0, "first"), (0, "last"), (0, "nunique"), (1, "any"),
            (1, "all")]
    got, want = _run(_both([k]), _both([v, b], [vv, bv], [None, T.BOOL8]),
                     aggs)
    _check(got, want, aggs)
    assert got.columns[1].to_pylist() == [20, 30, None]
    assert got.columns[2].to_pylist() == [40, 30, None]
    assert got.columns[3].to_pylist() == [2, 1, 0]
    assert got.columns[4].to_pylist() == [1, 1, None]
    assert got.columns[5].to_pylist() == [0, 0, None]


def test_all_null_group_yields_null():
    # test_sort_join_groupby.py's all-null group, with the new aggs
    k = np.array([7, 7, 8], np.int32)
    v = np.array([0, 0, 5], np.int32)
    vv = np.array([False, False, True])
    aggs = [(0, "sum"), (0, "count"), (0, "mean"), (0, "first"),
            (0, "last"), (0, "var"), (0, "nunique")]
    got, want = _run(_both([k]), _both([v], [vv]), aggs)
    _check(got, want, aggs)
    assert [c.to_pylist() for c in got.columns[1:]] == [
        [None, 5], [0, 1], [None, 5.0], [None, 5], [None, 5], [None, None],
        [0, 1]]


def test_nunique_nan_counts_once():
    k = np.zeros(4, np.int64)
    v = np.array([np.nan, np.nan, 1.0, 1.0])
    got, want = _run(_both([k]), _both([v]), [(0, "nunique")])
    assert got.columns[1].to_pylist() == want.columns[1].to_pylist() == [2]


def test_nunique_every_nan_is_one_value():
    """NaNs of both signs and payloads, and -0.0 with 0.0, count once
    (Spark normalizes both); the reference's raw-bit sort splits a NaN
    from a -NaN, so this case is held against that model only."""
    bits = np.array([0x7FF8000000000000, 0xFFF8000000000000,
                     0x7FF0000000000001, 0x8000000000000000, 0,
                     0x3FF0000000000000], np.uint64)
    v = bits.view(np.float64)
    k = np.array([0, 0, 0, 1, 1, 1], np.int64)
    out = groupby.groupby_aggregate(
        Table([Column.from_numpy(k, device=CPU)]),
        Table([Column.from_numpy(v, device=CPU)]), [(0, "nunique")])
    assert out.columns[1].to_pylist() == [1, 2]


@pytest.mark.parametrize("data,valid,want", [
    ([0, 0], [False, True], 1),
    ([5, 0, 5], [True, False, True], 1),
    ([5, 5, 5], [True, False, True], 1),
    ([0, 0, 1], [False, False, True], 1),
    ([0, 0], [False, False], 0)])
def test_nunique_null_data_collision(data, valid, want):
    # test_sort_join_groupby.py's cases: a null row whose stored value
    # equals a valid value neither joins nor swallows its run
    k = np.zeros(len(data), np.int64)
    got, ref = _run(_both([k]), _both([np.asarray(data, np.int64)],
                                      [np.asarray(valid)]),
                    [(0, "nunique")])
    assert got.columns[1].to_pylist() == ref.columns[1].to_pylist() == [want]


def test_var_std_against_pandas():
    # test_bloom_groupby_ext.py's case
    rng = np.random.default_rng(33)
    k = rng.integers(0, 20, 3000)
    v = rng.standard_normal(3000) * 10
    out = groupby.groupby_aggregate(
        Table([Column.from_numpy(k.astype(np.int32), device=CPU)]),
        Table([Column.from_numpy(v, device=CPU)]), [(0, "var"), (0, "std")])
    exp = pd.DataFrame({"k": k, "v": v}).groupby("k").v.agg(["var", "std"])
    np.testing.assert_array_equal(out.columns[0].to_numpy()[0],
                                  exp.index.to_numpy())
    np.testing.assert_allclose(out.columns[1].to_numpy()[0],
                               exp["var"].to_numpy(), rtol=1e-9)
    np.testing.assert_allclose(out.columns[2].to_numpy()[0],
                               exp["std"].to_numpy(), rtol=1e-9)


def test_var_single_row_group_is_null():
    out = groupby.groupby_aggregate(
        Table([Column.from_numpy(np.array([1, 2, 2], np.int32), device=CPU)]),
        Table([Column.from_numpy(np.array([5.0, 1.0, 3.0]), device=CPU)]),
        [(0, "var")])
    assert out.columns[1].to_pylist() == [None, 2.0]


def test_var_no_catastrophic_cancellation():
    out = groupby.groupby_aggregate(
        Table([Column.from_numpy(np.array([1, 1], np.int32), device=CPU)]),
        Table([Column.from_numpy(np.array([1e9, 1e9 + 1]), device=CPU)]),
        [(0, "var"), (0, "std")])
    np.testing.assert_allclose(out.columns[1].to_numpy()[0], [0.5],
                               rtol=1e-12)
    np.testing.assert_allclose(out.columns[2].to_numpy()[0], [0.5 ** 0.5],
                               rtol=1e-12)


def test_result_types_equal_reference():
    for agg in groupby.SUPPORTED_AGGS:
        for dt in (T.INT32, T.FLOAT64, T.BOOL8, T.decimal64(-2)):
            want = ref_groupby._result_dtype(
                agg, ref_types.DType(ref_types.TypeId(int(dt.id)), dt.scale))
            got = groupby.result_dtype(agg, dt)
            assert (int(got.id), got.scale) == (int(want.id), want.scale)
    assert groupby.SUPPORTED_AGGS == ref_groupby.SUPPORTED_AGGS


def test_empty_input_gives_empty_columns():
    out = groupby.groupby_aggregate(
        Table([Column.from_numpy(np.zeros(0, np.int64), device=CPU)]),
        Table([Column.from_numpy(np.zeros(0), device=CPU)]),
        [(0, a) for a in NEW_AGGS])
    assert out.num_rows == 0 and out.num_columns == 1 + len(NEW_AGGS)
    assert [c.dtype for c in out.columns[1:]] == [
        T.FLOAT64, T.FLOAT64, T.FLOAT64, T.FLOAT64, T.BOOL8, T.BOOL8,
        T.INT64]


def test_first_last_follow_input_order_within_group():
    rng = np.random.default_rng(4)
    n = 1000
    k = rng.integers(0, 30, n).astype(np.int64)
    v = rng.integers(0, 10**6, n).astype(np.int64)
    vv = rng.random(n) > 0.3
    out = groupby.groupby_aggregate(
        Table([Column.from_numpy(k, device=CPU)]),
        Table([Column.from_numpy(v, vv, device=CPU)]),
        [(0, "first"), (0, "last")])
    df = pd.DataFrame({"k": k, "v": np.where(vv, v, np.nan)})
    exp = df.groupby("k").v.agg(["first", "last"])
    np.testing.assert_array_equal(out.columns[1].to_numpy()[0],
                                  exp["first"].to_numpy().astype(np.int64))
    np.testing.assert_array_equal(out.columns[2].to_numpy()[0],
                                  exp["last"].to_numpy().astype(np.int64))
