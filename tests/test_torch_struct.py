"""STRUCT columns of the PyTorch/CUDA port against the JAX package on the
same numpy inputs (on the CPU): the type helpers, the column helpers,
``carry.table_from_arrays`` for STRUCT (recursively), LIST and
timestamps, STRUCT and LIST gathers, STRUCT sort keys, and STRUCT keys
in a groupby and a join. Results are byte-equal to the reference's.

The float64 key repair: the port canonicalizes every float64 NaN before
the total-order transform, as the reference's TPU route does
(``utils.floatbits._f64_bits_arithmetic``, the route the reference's
``ops/keys.py`` takes on the TPU). Its order and groups are held against
a lexsort of those bits, computed on the CPU. The reference's CPU route
is a bitcast and orders NaNs by their raw bits, which differs on these
inputs (a -NaN sorts below -inf there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as ref_types
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.ops import groupby as ref_groupby
from spark_rapids_jni_tpu.ops import join as ref_join
from spark_rapids_jni_tpu.ops.sort import gather as ref_gather
from spark_rapids_jni_tpu.ops.sort import sorted_order as ref_sorted_order
from spark_rapids_jni_tpu.utils.floatbits import _f64_bits_arithmetic

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import groupby, join
from spark_rapids_jni_tpu_torch.ops.sort import gather, sorted_order
from spark_rapids_jni_tpu_torch.tpcds.carry import table_from_arrays
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

CPU = torch.device("cpu")
I32, I64, F64 = (int(T.TypeId.INT32), 0), (int(T.TypeId.INT64), 0), \
    (int(T.TypeId.FLOAT64), 0)
STRUCT = (int(T.TypeId.STRUCT), 0)


# --------------------------------------------------------------------------
# types and column helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tid", list(T.TypeId))
def test_dtype_helpers_equal_reference(tid):
    scale = -2 if tid in (T.TypeId.DECIMAL32, T.TypeId.DECIMAL64,
                          T.TypeId.DECIMAL128) else 0
    got = T.DType.from_ids(int(tid), scale)
    want = ref_types.DType.from_ids(int(tid), scale)
    assert (got.id, got.scale) == (int(want.id), want.scale)
    assert got.is_nested == want.is_nested
    assert got.is_timestamp == want.is_timestamp
    assert got.is_fixed_width == want.is_fixed_width


def _pair_struct(ints, floats, valid=None, int_valid=None, names=None):
    ints = np.asarray(ints, np.int32)
    floats = np.asarray(floats, np.float64)
    ref = RefColumn.struct_from_children(
        [RefColumn.from_numpy(ints, int_valid), RefColumn.from_numpy(floats)],
        valid, names)
    data = ([I32, F64], [ints, floats], [int_valid, None])
    if names is not None:
        data += (names,)
    got = table_from_arrays([STRUCT], [data], [valid], device=CPU).columns[0]
    return ref, got


@pytest.mark.parametrize("valid,int_valid", [
    (None, None), ([True, False, True], None),
    (None, [False, True, True]), ([False, True, True], [True, False, True])])
def test_struct_column_helpers_equal_reference(valid, int_valid):
    valid = None if valid is None else np.array(valid)
    int_valid = None if int_valid is None else np.array(int_valid)
    ref, got = _pair_struct([1, 2, 3], [1.5, 2.5, 3.5], valid, int_valid,
                            names=("a", "b"))
    assert got.dtype == T.STRUCT and got.size == 3
    assert got.to_pylist() == ref.to_pylist()
    assert got.has_nulls == ref.has_nulls
    assert got.null_count() == ref.null_count()
    assert got.children[0].null_count() == ref.children[0].null_count()
    assert got.type_signature() == ref.type_signature()
    assert got.field_names == ref.field_names == ("a", "b")


def test_struct_helpers_refuse_bad_children():
    a = Column.from_numpy(np.arange(3, dtype=np.int32), device=CPU)
    b = Column.from_numpy(np.arange(4, dtype=np.int32), device=CPU)
    with pytest.raises(CudfLikeError):
        Column.struct_from_children([a, b])
    with pytest.raises(CudfLikeError):
        Column.struct_from_children([a], field_names=("x", "y"))
    with pytest.raises(CudfLikeError):
        Column.struct_from_children([])


def test_type_signature_tells_structs_apart():
    _, s1 = _pair_struct([1], [1.0])
    s2 = Column.struct_from_children(
        [Column.from_numpy(np.array([1], np.int64), device=CPU)])
    assert s1.dtype == s2.dtype and s1.type_signature() != s2.type_signature()
    with pytest.raises(CudfLikeError, match="struct fields"):
        join.inner_join(Table([s1]), Table([s2]))


def test_table_from_arrays_nested_list_and_timestamps():
    """A STRUCT holding a STRUCT and a LIST<INT64>, and a timestamp
    column, through ``table_from_arrays``, equal to the same columns
    built with the reference's constructors."""
    inner_valid = np.array([True, False, True, True])
    offs = np.array([0, 2, 2, 3, 5], np.int32)
    elems = np.array([1, -2, 3, 4, 5], np.int64)
    lvalid = np.array([True, True, False, True])
    ts = np.array([-1, 0, 86_400_000_001, -62135596800000000], np.int64)
    tsd = (int(T.TypeId.TIMESTAMP_MICROSECONDS), 0)
    inner = ([I64, F64], [np.arange(4, dtype=np.int64),
                          np.linspace(0, 1, 4)], [None, inner_valid],
             ("x", "y"))
    lst = (offs, elems, I64)
    outer = ([STRUCT, (int(T.TypeId.LIST), 0)], [inner, lst],
             [inner_valid, lvalid])
    got = table_from_arrays([STRUCT, tsd], [outer, ts],
                            [np.array([True, True, False, True]), None],
                            device=CPU)
    s, t = got.columns
    assert s.children[0].field_names == ("x", "y")
    assert s.children[1].to_pylist() == [[1, -2], [], None, [4, 5]]
    assert t.dtype == T.TIMESTAMP_MICROSECONDS
    assert t.to_numpy()[0].tolist() == ts.tolist()
    ref_inner = RefColumn.struct_from_children(
        [RefColumn.from_numpy(np.arange(4, dtype=np.int64)),
         RefColumn.from_numpy(np.linspace(0, 1, 4), inner_valid)],
        inner_valid, ("x", "y"))
    assert s.children[0].to_pylist() == ref_inner.to_pylist()
    assert s.to_pylist()[2] is None
    assert [r is None for r in s.to_pylist()] == [False, False, True, False]


# --------------------------------------------------------------------------
# gathers
# --------------------------------------------------------------------------

def test_struct_gather_equals_reference():
    rng = np.random.default_rng(3)
    n = 300
    ints = rng.integers(-50, 50, n).astype(np.int32)
    floats = rng.standard_normal(n)
    valid = rng.random(n) > 0.2
    int_valid = rng.random(n) > 0.2
    ref, got = _pair_struct(ints, floats, valid, int_valid, ("i", "f"))
    idx = rng.integers(0, n, 500)
    want = ref_gather(RefTable([ref]), jnp.asarray(idx)).columns[0]
    out = gather(Table([got]), torch.from_numpy(idx)).columns[0]
    assert out.to_pylist() == want.to_pylist()
    assert out.field_names == want.field_names


def test_list_gather_keeps_rows():
    lists = [[1, 2, 3], None, [], [7], [-5, 10**12], None, [0, 0, 8]]
    offs = np.zeros(len(lists) + 1, np.int32)
    np.cumsum([len(x) if x else 0 for x in lists], out=offs[1:])
    elems = np.array([v for x in lists if x for v in x], np.int64)
    col = Column.list_from_arrays(offs, elems,
                                  np.array([x is not None for x in lists]),
                                  device=CPU)
    idx = [6, 0, 1, 2, 4, 4, 3, 5]
    out = gather(Table([col]), torch.tensor(idx)).columns[0]
    assert out.to_pylist() == [lists[i] for i in idx]


# --------------------------------------------------------------------------
# sort keys, groupby and join keys
# --------------------------------------------------------------------------

def _random_struct(rng, n, nested=False):
    a = rng.integers(0, 4, n).astype(np.int32)
    b = rng.integers(-3, 3, n).astype(np.int64)
    f = np.round(rng.standard_normal(n), 1)
    f[::17] = np.nan
    f[::13] = -0.0
    va, vb, vs = (rng.random(n) > 0.2 for _ in range(3))
    ref_children = [RefColumn.from_numpy(a, va), RefColumn.from_numpy(b, vb)]
    dtypes, datas, valids = [I32, I64], [a, b], [va, vb]
    if nested:
        vi = rng.random(n) > 0.3
        ref_children.append(RefColumn.struct_from_children(
            [RefColumn.from_numpy(f)], vi))
        dtypes.append(STRUCT)
        datas.append(([F64], [f], [None]))
        valids.append(vi)
    ref = RefColumn.struct_from_children(ref_children, vs)
    got = table_from_arrays([STRUCT], [(dtypes, datas, valids)], [vs],
                            device=CPU).columns[0]
    return ref, got


@pytest.mark.parametrize("nested", [False, True])
@pytest.mark.parametrize("desc,nulls_first", [
    (None, None), ([True, False], None), ([False, True], [False, True])])
def test_struct_sorted_order_equals_reference(nested, desc, nulls_first):
    rng = np.random.default_rng(7 + nested)
    n = 400
    ref_s, got_s = _random_struct(rng, n, nested)
    k = rng.integers(0, 3, n).astype(np.int64)
    ref = RefTable([ref_s, RefColumn.from_numpy(k)])
    got = Table([got_s, Column.from_numpy(k, device=CPU)])
    want = np.asarray(ref_sorted_order(ref, desc, nulls_first))
    np.testing.assert_array_equal(
        sorted_order(got, desc, nulls_first).numpy(), want)


def test_struct_sort_key_field_order():
    # field by field, the first field primary; a field's nulls first
    col = Column.struct_from_children(
        [Column.from_numpy(np.array([2, 1, 1, 1], np.int32),
                           np.array([True, True, True, False]), device=CPU),
         Column.from_numpy(np.array([0.0, 5.0, -1.0, 9.0]), device=CPU)])
    assert sorted_order(Table([col])).tolist() == [3, 2, 1, 0]


@pytest.mark.parametrize("nested", [False, True])
def test_struct_groupby_key_equals_reference(nested):
    rng = np.random.default_rng(11 + nested)
    n = 500
    ref_s, got_s = _random_struct(rng, n, nested)
    v = rng.integers(-100, 100, n).astype(np.int64)
    vv = rng.random(n) > 0.1
    aggs = [(0, "sum"), (0, "count"), (0, "count_all"), (0, "min"),
            (0, "first"), (0, "nunique")]
    want = ref_groupby.groupby_aggregate(
        RefTable([ref_s]), RefTable([RefColumn.from_numpy(v, vv)]), aggs)
    out = groupby.groupby_aggregate(
        Table([got_s]), Table([Column.from_numpy(v, vv, device=CPU)]), aggs)
    assert out.num_rows == want.num_rows
    for g, w in zip(out.columns, want.columns):
        assert _same(g.to_pylist(), w.to_pylist())


def test_struct_groupby_equals_flat_keys():
    rng = np.random.default_rng(5)
    n = 1000
    a = rng.integers(0, 5, n).astype(np.int64)
    b = rng.integers(0, 7, n).astype(np.int64)
    v = Table([Column.from_numpy(np.ones(n, np.int64), device=CPU)])
    flat = groupby.groupby_aggregate(
        Table([Column.from_numpy(a, device=CPU),
               Column.from_numpy(b, device=CPU)]), v, [(0, "count_all")])
    s = table_from_arrays([STRUCT], [([I64, I64], [a, b], [None, None])],
                          [None], device=CPU)
    nested = groupby.groupby_aggregate(s, v, [(0, "count_all")])
    assert nested.columns[0].to_pylist() == list(zip(
        flat.columns[0].to_pylist(), flat.columns[1].to_pylist()))
    assert nested.columns[1].to_pylist() == flat.columns[2].to_pylist()


def test_struct_join_key_equals_reference():
    rng = np.random.default_rng(9)
    ref_l, got_l = _random_struct(rng, 200)
    ref_r, got_r = _random_struct(rng, 150)
    for fn in ("inner_join", "left_join"):
        want = [np.asarray(x) for x in getattr(ref_join, fn)(
            RefTable([ref_l]), RefTable([ref_r]))]
        got = [x.numpy() for x in getattr(join, fn)(Table([got_l]),
                                                   Table([got_r]))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=fn)


def test_struct_key_refuses_string_field():
    s = Column.struct_from_children(
        [Column.strings_from_list(["a", "b"], device=CPU)])
    with pytest.raises(CudfLikeError, match="STRING fields"):
        sorted_order(Table([s]))


# --------------------------------------------------------------------------
# the float64 NaN key repair
# --------------------------------------------------------------------------

def _same(a, b) -> bool:
    """Equal host values, NaN equal to NaN, recursing into tuples and
    lists."""
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and isinstance(b, float):
        return (a != a and b != b) or (a == b and str(a) == str(b))
    return a == b


def _f64(bits):
    return np.array(bits, np.uint64).view(np.float64)


# NaNs of several payloads and both signs, +-0.0, +-inf, normal values
SPECIAL_BITS = [0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001,
                0xFFF0000000000123, 0x7FFFFFFFFFFFFFFF, 0x0000000000000000,
                0x8000000000000000, 0x7FF0000000000000, 0xFFF0000000000000]


def _key_values(seed, n=600):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(n) * 4, 0)
    at = rng.choice(n, n // 3, replace=False)
    x[at] = _f64([SPECIAL_BITS[i % len(SPECIAL_BITS)]
                  for i in range(at.size)])
    return x


def _tpu_route_keys(x):
    """Total-order keys of the reference's TPU-route bits: NaN canonical,
    -0.0 kept below 0.0."""
    bits = np.asarray(_f64_bits_arithmetic(jnp.asarray(x))).astype(np.uint64)
    sign = bits >> np.uint64(63)
    return np.where(sign == 1, ~bits, bits | np.uint64(1 << 63))


def test_float64_nan_keys_order_like_the_tpu_route():
    x = _key_values(1)
    want = np.argsort(_tpu_route_keys(x), kind="stable")
    col = Column.from_numpy(x, device=CPU)
    np.testing.assert_array_equal(sorted_order(Table([col])).numpy(), want)
    desc = np.argsort(~_tpu_route_keys(x), kind="stable")
    np.testing.assert_array_equal(
        sorted_order(Table([col]), [True]).numpy(), desc)
    got = x[sorted_order(Table([col])).numpy()]
    assert np.isnan(got[-(np.isnan(x).sum()):]).all()  # every NaN last
    # the reference's CPU route bitcasts: -NaN sorts below -inf there
    ref_cpu = np.asarray(ref_sorted_order(RefTable([RefColumn.from_numpy(x)])))
    assert not np.array_equal(ref_cpu, want)
    assert np.isnan(x[ref_cpu[0]])


def test_float64_nan_keys_group_like_the_tpu_route():
    x = _key_values(2)
    keys = _tpu_route_keys(x)
    uniq, counts = np.unique(keys, return_counts=True)
    out = groupby.groupby_aggregate(
        Table([Column.from_numpy(x, device=CPU)]),
        Table([Column.from_numpy(np.ones(x.size, np.int64), device=CPU)]),
        [(0, "count_all")])
    assert out.num_rows == uniq.size
    np.testing.assert_array_equal(out.columns[1].to_numpy()[0], counts)
    rep = out.columns[0].to_numpy()[0]
    np.testing.assert_array_equal(_tpu_route_keys(rep), uniq)
    assert np.isnan(rep).sum() == 1  # one NaN group, the last
    assert np.isnan(rep[-1])
    # -0.0 and 0.0 stay two groups, as on both of the reference's routes
    assert ((rep == 0) & np.signbit(rep)).sum() == 1
    assert ((rep == 0) & ~np.signbit(rep)).sum() == 1


def test_float64_nan_keys_join_as_one_value():
    left = _f64([0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001])
    right = _f64([0xFFF0000000000123, 0x3FF0000000000000])
    li, ri = join.inner_join(Table([Column.from_numpy(left, device=CPU)]),
                             Table([Column.from_numpy(right, device=CPU)]))
    assert sorted(zip(li.tolist(), ri.tolist())) == [(0, 0), (1, 0), (2, 0)]
