"""The port's native relational kernels and casts against the reference's
binding, both loaded on the CPU.

Mirrors ``test_native_relational.py``: sort orders, inner, left, semi and
anti joins, groupby sums/min/max/means/counts, STRING keys with and
without nulls, the string casts, STRING hashing and HiveHash, all on the
same seeded data through both bindings: permutations, join pairs, group
reps, sizes and integral sums byte-equal, float sums and means within
rtol=1e-12 (they are equal here: both libraries run the same host loop),
and the route sentinels equal the reference's on the host route.
"""

import numpy as np
import pytest

from spark_rapids_jni_tpu.types import DType as RefDType, TypeId as RefTypeId

from torch_native_support import (native_libraries,  # noqa: F401
                                  pack_valid, port_specs, reference_native,
                                  string_buffers)

I64 = RefDType(RefTypeId.INT64)
I32 = RefDType(RefTypeId.INT32)
F64 = RefDType(RefTypeId.FLOAT64)
STR = RefDType(RefTypeId.STRING)


@pytest.fixture
def both(native_libraries, reference_native):  # noqa: F811
    return native_libraries[0], reference_native


def _specs(cols):
    """(DType, values, valid bool or None) -> reference column specs."""
    return [(dt, vals, None if valid is None else pack_valid(valid))
            for dt, vals, valid in cols]


def _pair(both, cols):
    """The same columns as a port and a reference NativeTable."""
    nat, ref = both
    specs = _specs(cols)
    return nat.NativeTable(port_specs(specs)), ref.NativeTable(specs)


def _same_groupby(got: dict, want: dict) -> None:
    for k in ("rep_rows", "sizes"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("sums", "mins", "maxs", "counts", "means"):
        assert len(got[k]) == len(want[k])
        for g, w in zip(got[k], want[k]):
            assert g.dtype == w.dtype, k
            if g.dtype == np.float64:
                np.testing.assert_allclose(g, w, rtol=1e-12, equal_nan=True)
            else:
                np.testing.assert_array_equal(g, w)


def _close(*tables):
    for t in tables:
        t.close()


def test_sort_order_matches_reference(both):
    nat, ref = both
    rng = np.random.default_rng(11)
    n = 500
    k1 = rng.integers(0, 20, n).astype(np.int64)
    k2 = rng.normal(size=n)
    k2[rng.random(n) < 0.05] = np.nan
    nt, rt = _pair(both, [(I64, k1, rng.random(n) > 0.15), (F64, k2, None)])
    for asc, nf in [(None, None), ([False, True], [False, True]),
                    ([True, False], [True, True])]:
        got = nat.sort_order(nt, ascending=asc, nulls_first=nf)
        np.testing.assert_array_equal(
            got, ref.sort_order(rt, ascending=asc, nulls_first=nf))
        assert nat.kernel_was_device("sort_order") == \
            ref.kernel_was_device("sort_order") == 0
    # the device route's shape on the host route: non-null integral keys,
    # descending
    nk, rk = _pair(both, [(I32, rng.integers(-50, 50, n).astype(np.int32),
                           None), (I64, k1, None)])
    np.testing.assert_array_equal(nat.sort_order(nk, [False, True]),
                                  ref.sort_order(rk, [False, True]))
    _close(nt, rt, nk, rk)


def test_inner_join_matches_reference(both):
    nat, ref = both
    rng = np.random.default_rng(12)
    nl, nr = 400, 300
    lk = rng.integers(0, 60, nl).astype(np.int64)
    rk = rng.integers(0, 60, nr).astype(np.int64)
    nt_l, rt_l = _pair(both, [(I64, lk, rng.random(nl) > 0.1)])
    nt_r, rt_r = _pair(both, [(I64, rk, rng.random(nr) > 0.1)])
    li, ri = nat.inner_join(nt_l, nt_r)
    wli, wri = ref.inner_join(rt_l, rt_r)
    # pair ORDER too: the device route must reproduce it
    np.testing.assert_array_equal(li, wli)
    np.testing.assert_array_equal(ri, wri)
    assert nat.kernel_was_device("inner_join") == \
        ref.kernel_was_device("inner_join") == 0
    assert nat.kernel_was_device("no_such_kernel") == -1
    _close(nt_l, rt_l, nt_r, rt_r)


def test_groupby_matches_reference(both):
    nat, ref = both
    rng = np.random.default_rng(13)
    n = 600
    keys = rng.integers(0, 25, n).astype(np.int64)
    nk, rk = _pair(both, [(I64, keys, rng.random(n) > 0.08)])
    nv, rv = _pair(both, [(I64, rng.integers(-1000, 1000, n)
                           .astype(np.int64), None),
                          (F64, rng.normal(size=n), rng.random(n) > 0.12)])
    _same_groupby(nat.groupby_sum_count(nk, nv),
                  ref.groupby_sum_count(rk, rv))
    assert nat.kernel_was_device("groupby") == \
        ref.kernel_was_device("groupby") == 0
    _close(nk, rk, nv, rv)


def test_string_keys_sort_join_groupby_match_reference(both):
    nat, ref = both
    lk = ["store_b", "store_a", "store_b", "", "store_c", "store_a",
          "store_aa", "x"]
    rkeys = ["store_a", "store_c", "store_b", "zzz"]
    rev = np.random.default_rng(5).integers(0, 100, len(lk)).astype(np.int64)
    nl, rl = _pair(both, [(STR, string_buffers(lk), None)])
    nr, rr = _pair(both, [(STR, string_buffers(rkeys), None)])
    nv, rv = _pair(both, [(I64, rev, None)])
    order = nat.sort_order(nl)
    np.testing.assert_array_equal(order, ref.sort_order(rl))
    assert [lk[i] for i in order] == sorted(lk)
    for g, w in zip(nat.inner_join(nl, nr), ref.inner_join(rl, rr)):
        np.testing.assert_array_equal(g, w)
    _same_groupby(nat.groupby_sum_count(nl, nv), ref.groupby_sum_count(rl, rv))
    _close(nl, rl, nr, rr, nv, rv)


def test_string_keys_with_nulls_match_reference(both):
    nat, ref = both
    lk = ["a", "b", None, "a", None, "c"]
    rkeys = ["a", None, "c"]
    nl, rl = _pair(both, [(STR, string_buffers([s or "" for s in lk]),
                           np.array([s is not None for s in lk]))])
    nr, rr = _pair(both, [(STR, string_buffers([s or "" for s in rkeys]),
                           np.array([s is not None for s in rkeys]))])
    li, ri = nat.inner_join(nl, nr)
    wli, wri = ref.inner_join(rl, rr)
    np.testing.assert_array_equal(li, wli)
    np.testing.assert_array_equal(ri, wri)
    # SQL nulls never match: only 'a' x 'a' and 'c' x 'c'
    assert sorted(zip(li.tolist(), ri.tolist())) == [(0, 0), (3, 0), (5, 2)]
    _close(nl, rl, nr, rr)


def test_groupby_min_max_mean_match_reference(both):
    nat, ref = both
    rng = np.random.default_rng(9)
    n = 300
    keys = rng.integers(0, 20, n).astype(np.int64)
    vi = rng.integers(-1000, 1000, n).astype(np.int64)
    vf = rng.normal(size=n)
    vf[::37] = np.nan  # Spark's float order: NaN greatest
    nk, rk = _pair(both, [(I64, keys, None)])
    nv, rv = _pair(both, [(I64, vi, None), (F64, vf, None),
                          (I32, vi.astype(np.int32), None)])
    g = nat.groupby_sum_count(nk, nv)
    _same_groupby(g, ref.groupby_sum_count(rk, rv))
    for gi, rep in enumerate(g["rep_rows"]):
        mask = keys == keys[rep]
        assert g["mins"][0][gi] == vi[mask].min()
        assert g["maxs"][0][gi] == vi[mask].max()
        assert g["means"][0][gi] == vi[mask].sum() / mask.sum()
    _close(nk, rk, nv, rv)


def test_cast_strings_match_reference(both):
    nat, ref = both
    rows = ["42", " -7 ", "1.9", "+005", "", "abc", "1e3",
            "9223372036854775807", "9223372036854775808",
            "-9223372036854775808", "  12  ", "3.99", "-0.5", "0"]
    for got, want in zip(nat.cast_string_to_int64(rows),
                         ref.cast_string_to_int64(rows)):
        np.testing.assert_array_equal(got, want)
    frows = ["3.5", " -0.25e2 ", "inf", "-Infinity", "NaN", "1e", ".5",
             "5.", "x", "1.75e-3", "+2"]
    gv, gok = nat.cast_string_to_float64(frows)
    wv, wok = ref.cast_string_to_float64(frows)
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(gv.view(np.int64), wv.view(np.int64))
    from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError
    with pytest.raises(CudfLikeError, match="row 1: 'x'"):
        nat.cast_string_to_int64(["1", "x"], ansi=True)
    with pytest.raises(CudfLikeError, match="row 1: 'x'"):
        nat.cast_string_to_float64(["1", "x"], ansi=True)


def test_native_string_hashing_matches_reference(both):
    """murmur3/xxhash64 over STRING columns (hashUnsafeBytes and full
    XXH64), chained through a mixed int/string schema with nulls."""
    nat, ref = both
    rng = np.random.default_rng(23)
    words = ["", "a", "spark", "rapids-tpu", "x" * 37, "naïve",
             "日本語テキスト", "tail1", "tail12", "tail123",
             "0123456789abcdef" * 4]
    n = 300
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    cols = [(I64, rng.integers(-2**62, 2**62, n, dtype=np.int64), None),
            (STR, string_buffers(strs), rng.random(n) > 0.15)]
    nt, rt = _pair(both, cols)
    for seed in (42, 0):
        np.testing.assert_array_equal(nat.murmur3_table(nt, seed),
                                      ref.murmur3_table(rt, seed))
        np.testing.assert_array_equal(nat.xxhash64_table(nt, seed),
                                      ref.xxhash64_table(rt, seed))
    _close(nt, rt)


def test_left_semi_anti_joins_match_reference(both):
    nat, ref = both
    rng = np.random.default_rng(41)
    nl, nr = 300, 200
    nt_l, rt_l = _pair(both, [(I64, rng.integers(0, 80, nl).astype(np.int64),
                               rng.random(nl) > 0.12)])
    nt_r, rt_r = _pair(both, [(I64, rng.integers(0, 80, nr).astype(np.int64),
                               rng.random(nr) > 0.12)])
    for g, w in zip(nat.left_join(nt_l, nt_r), ref.left_join(rt_l, rt_r)):
        np.testing.assert_array_equal(g, w)
    semi = nat.left_semi_join(nt_l, nt_r)
    anti = nat.left_anti_join(nt_l, nt_r)
    np.testing.assert_array_equal(semi, ref.left_semi_join(rt_l, rt_r))
    np.testing.assert_array_equal(anti, ref.left_anti_join(rt_l, rt_r))
    assert sorted(semi.tolist() + anti.tolist()) == list(range(nl))
    _close(nt_l, rt_l, nt_r, rt_r)


def test_native_hive_hash_strings_matches_reference(both):
    nat, ref = both
    rng = np.random.default_rng(53)
    words = ["", "hive", "naïve", "日本語", "q" * 29, "Spark SQL"]
    n = 150
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    nt, rt = _pair(both, [
        (I32, rng.integers(-10**6, 10**6, n).astype(np.int32), None),
        (STR, string_buffers(strs), rng.random(n) > 0.2)])
    np.testing.assert_array_equal(nat.hive_hash_table(nt),
                                  ref.hive_hash_table(rt))
    _close(nt, rt)
