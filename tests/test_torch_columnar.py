"""Columnar layer, general kernels and ingest of the PyTorch/CUDA port,
held against the JAX package on the same numpy inputs (on the CPU).

- bitmask words and ingest stats equal the reference's;
- ``generate`` returns frames equal to the reference's;
- ``carry.rel_from_arrays`` over an exported reference ``Rel`` equals
  the port's own ``rel_from_df`` on the same frame;
- the general sort, join and groupby kernels equal the reference's
  (integers exact; float sums within rtol=1e-9, because the reference
  reads group sums as cumulative-sum differences, which carry about
  eps x |global prefix| of rounding, where the port adds per group).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.columnar import bitmask as ref_bitmask
from spark_rapids_jni_tpu.ops import groupby as ref_groupby
from spark_rapids_jni_tpu.ops import join as ref_join
from spark_rapids_jni_tpu.ops.sort import sorted_order as ref_sorted_order
from spark_rapids_jni_tpu.tpcds import generate as ref_generate
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df

from spark_rapids_jni_tpu_torch.columnar import Column, Table, bitmask
from spark_rapids_jni_tpu_torch.ops import groupby, join
from spark_rapids_jni_tpu_torch.ops.sort import sorted_order
from spark_rapids_jni_tpu_torch.tpcds import generate
from spark_rapids_jni_tpu_torch.tpcds.carry import rel_from_arrays
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

CPU = torch.device("cpu")


def export_rel(rel):
    """A reference Rel as the host arrays ``rel_from_arrays`` takes."""
    cols = rel.table.columns
    return dict(
        names=list(rel.names),
        datas=[np.asarray(c.data) for c in cols],
        validity_words=[None if c.validity is None else np.asarray(c.validity)
                        for c in cols],
        stats=[(c.value_range, c.unique, getattr(c, "_stats_flags", None))
               for c in cols],
        dicts=dict(rel.dicts))


def _pair(values, valid=None):
    ref = RefColumn.from_numpy(values, valid)
    got = Column.from_numpy(values, valid, device=CPU)
    return ref, got


# --------------------------------------------------------------------------
# bitmask + columns
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 32, 77, 4099])
def test_bitmask_pack_unpack_equal_reference(n):
    valid = np.random.default_rng(n).random(n) > 0.5
    ref = np.asarray(ref_bitmask.pack(jnp.asarray(valid)))
    got = bitmask.pack(torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(bitmask.pack_host(valid), ref)
    np.testing.assert_array_equal(bitmask.unpack(got, n).numpy(), valid)


@pytest.mark.parametrize("values", [
    np.arange(100, dtype=np.int64),
    np.array([5, 3, 5, 9], np.int64),
    np.array([-7, 2**40, 3], np.int64),
    np.array([1.5, -2.0], np.float64),
    np.arange(10, dtype=np.int32),
    np.array([], np.int64),
])
def test_column_ingest_stats_equal_reference(values):
    ref, got = _pair(values)
    assert got.value_range == ref.value_range
    assert got.unique == ref.unique
    assert got.dtype.id == ref.dtype.id
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))


def test_column_validity_words_equal_reference():
    values = np.arange(70, dtype=np.int64)
    valid = np.random.default_rng(1).random(70) > 0.3
    ref, got = _pair(values, valid)
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(ref.validity))
    assert got.value_range == ref.value_range and got.unique == ref.unique
    assert got.to_pylist() == ref.to_pylist()


# --------------------------------------------------------------------------
# generate, rel_from_df, rel_from_arrays
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sf,seed", [(0.5, 7), (2, 7), (1.3, 11)])
def test_generate_equals_reference(sf, seed):
    got, want = generate(sf=sf, seed=seed), ref_generate(sf=sf, seed=seed)
    assert list(got) == list(want)
    for name in want:
        pd.testing.assert_frame_equal(got[name], want[name], check_exact=True)


@pytest.fixture(scope="module")
def frames():
    return generate(sf=0.5, seed=7)


@pytest.mark.parametrize("table", ["store_sales", "item", "store",
                                   "customer_address", "date_dim"])
def test_rel_from_arrays_equals_rel_from_df(frames, table):
    df = frames[table]
    carried = rel_from_arrays(**export_rel(ref_rel_from_df(df)), device=CPU)
    own = rel_from_df(df, device=CPU)
    assert carried.names == own.names
    assert set(carried.dicts) == set(own.dicts)
    for k in own.dicts:
        np.testing.assert_array_equal(carried.dicts[k], own.dicts[k])
    for a, b in zip(carried.table.columns, own.table.columns):
        assert a.dtype == b.dtype and a.size == b.size
        assert torch.equal(a.data, b.data)
        assert (a.validity is None) == (b.validity is None)
        assert a.value_range == b.value_range and a.unique == b.unique
        assert getattr(a, "_stats_flags", None) == \
            getattr(b, "_stats_flags", None)


def test_rel_from_arrays_carries_validity_words():
    words = np.array([0b1011], np.uint32)
    rel = rel_from_arrays(["v"], [np.arange(4, dtype=np.int64)], [words],
                          [(None, None, None)], {}, device=CPU)
    assert rel.col("v").to_pylist() == [0, 1, None, 3]


def test_entry_points_need_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = pd.DataFrame({"k": np.arange(3)})
    with pytest.raises(CudfLikeError, match="CUDA"):
        rel_from_df(df)
    with pytest.raises(CudfLikeError, match="CUDA"):
        rel_from_df(df, device="cuda")
    assert rel_from_df(df, device="cpu").device.type == "cpu"


def test_null_strings_raise_until_the_string_column_is_ported():
    # the STRING column is ported: a string column with nulls now ingests
    # as one, as the reference's does, instead of raising
    df = pd.DataFrame({"s": ["a", None]})
    rel = rel_from_df(df, device=CPU)
    ref = ref_rel_from_df(df)
    assert rel.col("s").dtype.id == ref.col("s").dtype.id
    assert "s" not in rel.dicts and "s" not in ref.dicts
    assert rel.col("s").to_pylist() == ref.col("s").to_pylist() == ["a", None]


def test_dictionary_codes_round_trip(frames):
    df = frames["store"]
    out = rel_from_df(df, device=CPU).to_df()
    pd.testing.assert_frame_equal(out, df.reset_index(drop=True))


# --------------------------------------------------------------------------
# general sort / join / groupby kernels
# --------------------------------------------------------------------------

def _tables(cols_np, valids=None):
    valids = valids or [None] * len(cols_np)
    ref = RefTable([RefColumn.from_numpy(c, v)
                    for c, v in zip(cols_np, valids)])
    got = Table([Column.from_numpy(c, v, device=CPU)
                 for c, v in zip(cols_np, valids)])
    return ref, got


def test_sorted_order_equals_reference():
    rng = np.random.default_rng(21)
    n = 3000
    a = rng.integers(0, 20, n).astype(np.int64)
    f = rng.standard_normal(n)
    f[::97] = np.nan
    f[::89] = -0.0
    f[::83] = np.inf
    u = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    b = rng.integers(-3, 3, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    ref, got = _tables([a, f, u, b], [None, None, None, valid])
    for desc in ([False, False, False, False], [True, False, True, False],
                 [False, True, False, True]):
        want = np.asarray(ref_sorted_order(ref, desc))
        np.testing.assert_array_equal(
            sorted_order(got, desc).numpy(), want)
    want = np.asarray(ref_sorted_order(ref, None, [False] * 4))
    np.testing.assert_array_equal(
        sorted_order(got, None, [False] * 4).numpy(), want)


def _join_inputs(seed, nullable=False):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, 300, 2000).astype(np.int64)
    rk = rng.integers(100, 500, 700).astype(np.int64)
    lk2 = rng.integers(0, 3, 2000).astype(np.int64)
    rk2 = rng.integers(0, 3, 700).astype(np.int64)
    lv = (rng.random(2000) > 0.1) if nullable else None
    rv = (rng.random(700) > 0.1) if nullable else None
    lref, lgot = _tables([lk, lk2], [lv, None])
    rref, rgot = _tables([rk, rk2], [rv, None])
    return lref, lgot, rref, rgot


@pytest.mark.parametrize("nullable", [False, True])
def test_general_joins_equal_reference(nullable):
    lref, lgot, rref, rgot = _join_inputs(5, nullable)
    for fn in ("inner_join", "left_join"):
        want = [np.asarray(x) for x in getattr(ref_join, fn)(lref, rref)]
        got = [x.numpy() for x in getattr(join, fn)(lgot, rgot)]
        assert got[0].dtype == np.int32 and got[1].dtype == np.int32
        np.testing.assert_array_equal(got[0], want[0], err_msg=fn)
        np.testing.assert_array_equal(got[1], want[1], err_msg=fn)
    for fn in ("left_semi_join", "left_anti_join"):
        want = np.asarray(getattr(ref_join, fn)(lref, rref))
        np.testing.assert_array_equal(getattr(join, fn)(lgot, rgot).numpy(),
                                      want, err_msg=fn)


def test_general_joins_with_an_empty_side():
    lref, lgot, _, _ = _join_inputs(6)
    eref, egot = _tables([np.zeros(0, np.int64), np.zeros(0, np.int64)])
    li, ri = join.left_join(lgot, egot)
    assert (ri.numpy() == -1).all() and li.shape[0] == lgot.num_rows
    assert join.inner_join(lgot, egot)[0].shape == (0,)
    assert join.left_anti_join(egot, lgot).shape == (0,)


def test_groupby_aggregate_equals_reference():
    rng = np.random.default_rng(8)
    n = 4000
    k1 = rng.integers(0, 12, n).astype(np.int64)
    k2 = rng.integers(0, 4, n).astype(np.int64)
    kv = rng.random(n) > 0.05
    iv = rng.integers(-2**62, 2**62, n).astype(np.int64)
    fv = np.round(rng.uniform(-50, 150, n), 2)
    vvalid = rng.random(n) > 0.2
    kref, kgot = _tables([k1, k2], [kv, None])
    vref, vgot = _tables([iv, fv, fv], [None, None, vvalid])
    aggs = [(0, "sum"), (0, "count"), (0, "min"), (0, "max"),
            (1, "sum"), (1, "mean"), (1, "min"), (1, "max"),
            (2, "count"), (2, "count_all"), (2, "sum"), (2, "mean")]
    want = ref_groupby.groupby_aggregate(kref, vref, aggs)
    got = groupby.groupby_aggregate(kgot, vgot, aggs)
    assert got.num_columns == want.num_columns
    for gc, wc in zip(got.columns, want.columns):
        assert gc.dtype.id == wc.dtype.id
        gv, gok = gc.to_numpy()
        wv, wok = np.asarray(wc.data), np.asarray(wc.valid_bool())
        np.testing.assert_array_equal(gok, wok)
        if gv.dtype.kind == "f":
            np.testing.assert_allclose(gv[gok], wv[wok], rtol=1e-9, atol=0)
        else:
            np.testing.assert_array_equal(gv[gok], wv[wok])


def test_groupby_empty_input():
    kref, kgot = _tables([np.zeros(0, np.int64)])
    out = groupby.groupby_aggregate(kgot, kgot, [(0, "sum")])
    assert out.num_rows == 0 and out.num_columns == 2
