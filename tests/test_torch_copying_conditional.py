"""Copying (filter, slice, concatenate), sorts and conditionals of the
PyTorch/CUDA port against the JAX package on the same numpy inputs (on
the CPU).

Mirrors the copying cases of ``test_io_copying.py`` (its Arrow and
Parquet cases wait for the port's ``io``) and every case of
``test_conditional.py``, then holds seeded tables of fixed-width,
STRING, DECIMAL128 and STRUCT columns with nulls against the reference:
values and validity equal, row for row.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as RT
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.ops import conditional as ref_cond
from spark_rapids_jni_tpu.ops import copying as ref_copy
from spark_rapids_jni_tpu.ops.sort import sort as ref_sort
from spark_rapids_jni_tpu.ops.sort import sort_by_key as ref_sort_by_key

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import (
    apply_boolean_mask, case_when, coalesce, concat_columns, concatenate,
    if_else, slice_rows, sort, sort_by_key)
from spark_rapids_jni_tpu_torch.ops import copying
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

CPU = torch.device("cpu")


def _pylists(table):
    return [c.to_pylist() for c in table.columns]


# --------------------------------------------------------------------------
# test_io_copying.py's copying cases
# --------------------------------------------------------------------------

def test_apply_boolean_mask_and_slice():
    t = Table([Column.from_numpy(np.arange(10, dtype=np.int64), device=CPU),
               Column.from_numpy(np.arange(10, dtype=np.float32),
                                 device=CPU)])
    mask = Column.from_numpy(np.array([i % 2 == 0 for i in range(10)]),
                             np.array([True] * 9 + [False]), device=CPU)
    out = apply_boolean_mask(t, mask)
    assert out.columns[0].to_pylist() == [0, 2, 4, 6, 8]
    sl = slice_rows(t, 3, 6)
    assert sl.columns[0].to_pylist() == [3, 4, 5]


def test_concatenate():
    a = Table([Column.from_numpy(np.array([1, 2], np.int32),
                                 np.array([True, False]), device=CPU)])
    b = Table([Column.from_numpy(np.array([3, 4], np.int32), device=CPU)])
    out = concatenate([a, b])
    assert out.columns[0].to_pylist() == [1, None, 3, 4]
    with pytest.raises(CudfLikeError):
        concatenate([a, Table([Column.from_numpy(np.array([1], np.int64),
                                                 device=CPU)])])


# --------------------------------------------------------------------------
# seeded tables against the reference
# --------------------------------------------------------------------------

def _strings(rng, n, share=0.2):
    return [None if rng.random() < share else
            "x" * int(rng.integers(0, 5)) + str(int(rng.integers(1000)))
            for _ in range(n)]


def _tables(seed, n, null_share=0.2):
    """(reference Table, port Table) of INT64, FLOAT32, STRING,
    DECIMAL128 and a named STRUCT<INT32, FLOAT64>, nulls everywhere."""
    rng = np.random.default_rng(seed)

    def valid():
        return rng.random(n) >= null_share
    i64 = rng.integers(-2**62, 2**62, n)
    f32 = rng.standard_normal(n).astype(np.float32)
    strs = _strings(rng, n, null_share)
    dec = [None if rng.random() < null_share else
           int(rng.integers(-2**62, 2**62)) * 10**9 for _ in range(n)]
    s_i = rng.integers(-100, 100, n).astype(np.int32)
    s_f = rng.standard_normal(n)
    vi, vf, vi2, vf2 = valid(), valid(), valid(), valid()
    ref = RefTable([
        RefColumn.from_numpy(i64, vi), RefColumn.from_numpy(f32, vf),
        RefColumn.strings_from_list(strs),
        RefColumn.decimal128_from_ints(dec, -3),
        RefColumn.struct_from_children(
            [RefColumn.from_numpy(s_i, vi2), RefColumn.from_numpy(s_f, vf2)],
            valid(), field_names=("a", "b"))])
    sv = np.asarray(ref.columns[4].valid_bool())
    got = Table([
        Column.from_numpy(i64, vi, device=CPU),
        Column.from_numpy(f32, vf, device=CPU),
        Column.strings_from_list(strs, device=CPU),
        Column.decimal128_from_ints(dec, -3, device=CPU),
        Column.struct_from_children(
            [Column.from_numpy(s_i, vi2, device=CPU),
             Column.from_numpy(s_f, vf2, device=CPU)], sv,
            field_names=("a", "b"))])
    return ref, got


def _same_tables(got, want):
    assert got.num_rows == want.num_rows
    assert _pylists(got) == _pylists(want)
    for g, w in zip(got.columns, want.columns):
        assert g.type_signature() == w.type_signature()
        assert getattr(g, "field_names", None) == getattr(
            w, "field_names", None)


@pytest.mark.parametrize("seed,null_share", [(1, 0.2), (2, 0.0), (3, 0.9)])
def test_apply_boolean_mask_equals_reference(seed, null_share):
    ref, got = _tables(seed, 517, null_share)
    rng = np.random.default_rng(seed + 100)
    bits = rng.random(517) < 0.4
    mvalid = rng.random(517) > 0.1
    want = ref_copy.apply_boolean_mask(ref, RefColumn.from_numpy(bits, mvalid))
    _same_tables(apply_boolean_mask(
        got, Column.from_numpy(bits, mvalid, device=CPU)), want)
    # a bare tensor mask keeps exactly its True rows
    _same_tables(apply_boolean_mask(got, torch.from_numpy(bits)),
                 ref_copy.apply_boolean_mask(ref, np.asarray(bits)))


def test_apply_boolean_mask_keeps_nothing_or_everything():
    ref, got = _tables(4, 65)
    for bits in (np.zeros(65, bool), np.ones(65, bool)):
        _same_tables(apply_boolean_mask(got, torch.from_numpy(bits)),
                     ref_copy.apply_boolean_mask(ref, np.asarray(bits)))
    with pytest.raises(CudfLikeError):
        apply_boolean_mask(got, torch.ones(64, dtype=torch.bool))


@pytest.mark.parametrize("start,end", [(0, 0), (3, 17), (31, 65), (0, 200),
                                       (199, 200)])
def test_slice_rows_equals_reference(start, end):
    ref, got = _tables(5, 200)
    _same_tables(slice_rows(got, start, end),
                 ref_copy.slice_rows(ref, start, end))


def test_slice_rows_bad_bounds_raise():
    _, got = _tables(6, 10)
    for a, b in ((-1, 3), (4, 3), (0, 11)):
        with pytest.raises(CudfLikeError):
            slice_rows(got, a, b)


@pytest.mark.parametrize("sizes", [(40, 0, 33), (1, 1), (100,)])
def test_concatenate_equals_reference(sizes):
    pairs = [_tables(10 + i, n) for i, n in enumerate(sizes)]
    want = ref_copy.concatenate([r for r, _ in pairs])
    got = concatenate([g for _, g in pairs])
    _same_tables(got, want)
    # STRING offsets rebased onto the running byte count
    assert got.columns[2].offsets.data.tolist() == \
        np.asarray(want.columns[2].offsets.data).tolist()


def test_concat_struct_field_names_merge_like_reference():
    def struct(names, lib):
        col = (lib.from_numpy(np.arange(3, dtype=np.int32)) if lib is
               RefColumn else Column.from_numpy(np.arange(3, dtype=np.int32),
                                                device=CPU))
        return lib.struct_from_children([col], field_names=names)
    for names in ((None, ("k",)), (("k",), None), (None, None)):
        want = ref_copy.concat_columns([struct(n, RefColumn) for n in names])
        got = concat_columns([struct(n, Column) for n in names])
        assert got.field_names == want.field_names
        assert got.to_pylist() == want.to_pylist()
    with pytest.raises(Exception):
        ref_copy.concat_columns([struct(("k",), RefColumn),
                                 struct(("j",), RefColumn)])
    with pytest.raises(CudfLikeError):
        concat_columns([struct(("k",), Column), struct(("j",), Column)])


def test_concat_caps_raise(monkeypatch):
    # the 2 GB caps, scaled down: offsets, chars and fixed-width bytes
    short = Column.strings_from_list(["a"] * 8, device=CPU)
    long = Column.strings_from_list(["abcdefghij"] * 2, device=CPU)
    monkeypatch.setattr(copying, "SIZE_TYPE_MAX", 30)
    with pytest.raises(CudfLikeError, match="offsets"):
        concat_columns([short, short])  # (16 + 1) x 4 offset bytes
    with pytest.raises(CudfLikeError, match="chars"):
        concat_columns([long, long])  # 40 chars
    f = Column.from_numpy(np.zeros(2, np.int64), device=CPU)
    with pytest.raises(CudfLikeError, match="size_type"):
        concat_columns([f, f])  # 32 bytes


def test_concat_lists_rebase_offsets():
    a = Column.list_from_arrays(np.array([0, 2, 2, 5], np.int32),
                                np.arange(5, dtype=np.int64), device=CPU)
    b = Column.list_from_arrays(np.array([0, 1], np.int32),
                                np.array([9], np.int64),
                                np.array([False]), device=CPU)
    out = concat_columns([a, b])
    assert out.to_pylist() == [[0, 1], [], [2, 3, 4], None]
    assert out.offsets.data.tolist() == [0, 2, 2, 5, 6]


@pytest.mark.parametrize("descending", [None, [True, False]])
def test_sort_by_key_and_sort_equal_reference(descending):
    rng = np.random.default_rng(21)
    n = 300
    k1 = rng.integers(0, 7, n)
    k2 = rng.standard_normal(n)
    k2[::13] = np.nan
    k2[::17] = -0.0
    v1 = rng.random(n) > 0.2
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    rkeys = RefTable([RefColumn.from_numpy(k1, v1), RefColumn.from_numpy(k2)])
    keys = Table([Column.from_numpy(k1, v1, device=CPU),
                  Column.from_numpy(k2, device=CPU)])
    rvals = RefTable([RefColumn.from_numpy(vals)])
    pvals = Table([Column.from_numpy(vals, device=CPU)])
    for nulls_first in (None, [False, True]):
        want = ref_sort_by_key(rvals, rkeys, descending, nulls_first)
        got = sort_by_key(pvals, keys, descending, nulls_first)
        assert _pylists(got) == _pylists(want)
    want = ref_sort(rkeys, descending=descending)
    got = sort(keys, descending=descending)
    for g, w in zip(got.columns, want.columns):
        np.testing.assert_array_equal(g.valid_bool().numpy(),
                                      np.asarray(w.valid_bool()))
        ok = g.valid_bool().numpy()
        np.testing.assert_array_equal(g.to_numpy()[0][ok],
                                      np.asarray(w.data)[ok])


# --------------------------------------------------------------------------
# test_conditional.py
# --------------------------------------------------------------------------

def _b(vals, valid=None):
    return Column.from_numpy(np.asarray(vals, np.int8), valid=valid,
                             dtype=T.BOOL8, device=CPU)


def _i(vals, valid=None):
    return Column.from_numpy(np.asarray(vals, np.int64), valid=valid,
                             device=CPU)


def test_if_else_null_cond_takes_else():
    cond = _b([1, 0, 1], valid=np.array([True, True, False]))
    out = if_else(cond, _i([10, 11, 12]), _i([20, 21, 22]))
    assert out.to_pylist() == [10, 21, 22]


def test_if_else_branch_validity():
    cond = _b([1, 0])
    a = _i([1, 2], valid=np.array([False, True]))
    b = _i([3, 4], valid=np.array([True, False]))
    assert if_else(cond, a, b).to_pylist() == [None, None]


def test_case_when_first_true_wins():
    c1 = _b([1, 0, 0, 0])
    c2 = _b([1, 1, 0, 0])
    out = case_when([(c1, _i([1, 1, 1, 1])), (c2, _i([2, 2, 2, 2]))],
                    default=_i([9, 9, 9, 9]))
    assert out.to_pylist() == [1, 2, 9, 9]


def test_case_when_no_default_gives_null():
    out = case_when([(_b([0, 1]), _i([5, 6]))])
    assert out.to_pylist() == [None, 6]


def test_coalesce():
    a = _i([1, 2, 3], valid=np.array([False, True, False]))
    b = _i([4, 5, 6], valid=np.array([True, False, False]))
    c = _i([7, 8, 9])
    assert coalesce([a, b, c]).to_pylist() == [4, 2, 9]
    assert coalesce([a, b]).to_pylist() == [4, 2, None]


def _cond_inputs(seed, n, dtype, share):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(5):
        if dtype == np.float64:
            vals = rng.standard_normal(n)
        else:
            vals = rng.integers(-1000, 1000, n).astype(dtype)
        valid = rng.random(n) >= share
        out.append((vals, valid))
    conds = [(rng.integers(0, 2, n).astype(np.int8), rng.random(n) > 0.15)
             for _ in range(4)]
    return out, conds


def _ref_bool(c):
    return RefColumn.from_numpy(c[0], c[1], dtype=RT.BOOL8)


def _port_bool(c):
    return Column.from_numpy(c[0], c[1], dtype=T.BOOL8, device=CPU)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
@pytest.mark.parametrize("share", [0.0, 0.3])
def test_conditionals_equal_reference(dtype, share):
    vals, conds = _cond_inputs(int(share * 10) + 3, 777, dtype, share)
    rv = [RefColumn.from_numpy(v, ok) for v, ok in vals]
    pv = [Column.from_numpy(v, ok, device=CPU) for v, ok in vals]
    rc = [_ref_bool(c) for c in conds]
    pc = [_port_bool(c) for c in conds]
    pairs = [
        (ref_cond.if_else(rc[0], rv[0], rv[1]), if_else(pc[0], pv[0], pv[1])),
        (ref_cond.case_when(list(zip(rc, rv[:4])), rv[4]),
         case_when(list(zip(pc, pv[:4])), pv[4])),
        (ref_cond.case_when(list(zip(rc[:2], rv[:2]))),
         case_when(list(zip(pc[:2], pv[:2])))),
        (ref_cond.coalesce(rv[:3]), coalesce(pv[:3])),
    ]
    for want, got in pairs:
        assert got.dtype == T.DType(T.TypeId(int(want.dtype.id)),
                                    want.dtype.scale)
        # no mask exactly where the reference keeps none
        assert (got.validity is None) == (want.validity is None)
        assert got.to_pylist() == want.to_pylist()


def test_conditionals_check_types_and_sizes():
    with pytest.raises(CudfLikeError):
        if_else(_b([1]), _i([1]), Column.from_numpy(
            np.array([1], np.int32), device=CPU))
    with pytest.raises(CudfLikeError):
        if_else(_i([1]), _i([1]), _i([2]))  # condition must be BOOL8
    with pytest.raises(CudfLikeError):
        case_when([])
    with pytest.raises(CudfLikeError):
        coalesce([_i([1, 2]), _i([1])])


def test_conditionals_on_decimal128_rows():
    a = Column.decimal128_from_ints([10**30, None, -5], -2, device=CPU)
    b = Column.decimal128_from_ints([1, 2, None], -2, device=CPU)
    cond = _b([0, 1, 1])
    assert if_else(cond, a, b).to_pylist() == \
        b.to_pylist()[:1] + a.to_pylist()[1:]
    assert coalesce([a, b]).to_pylist() == \
        [a.to_pylist()[0], b.to_pylist()[1], a.to_pylist()[2]]
