"""The q11-q20 operator families of the PyTorch/CUDA port against the JAX
package, on the CPU: 128-bit lane arithmetic, Spark decimal arithmetic,
the string operators on both routes, window functions, the runtime
overflow counter, and the ingest of nullable strings and decimals.

Every case feeds the same numpy inputs, made from a seed, to the JAX
function and to its port (``device="cpu"``). Integers, decimals,
strings and booleans must be equal; floats within ``rtol=1e-12,
atol=0``.
"""

import decimal

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_jni_tpu import obs as ref_obs
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.ops import decimal_utils as ref_dec
from spark_rapids_jni_tpu.ops import string_ops as ref_sops
from spark_rapids_jni_tpu.tpcds.oplib import decimals as RD
from spark_rapids_jni_tpu.tpcds.oplib import strings as RS
from spark_rapids_jni_tpu.tpcds.rel import Rel as RefRel
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df
from spark_rapids_jni_tpu.types import DType as RefDType
from spark_rapids_jni_tpu.types import TypeId as RefTypeId
from spark_rapids_jni_tpu.utils import int128 as ref_i128

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.obs import (dispatch_counts, kernel_stats,
                                            stats_since)
from spark_rapids_jni_tpu_torch.ops import decimal_utils as dec
from spark_rapids_jni_tpu_torch.ops import string_ops as sops
from spark_rapids_jni_tpu_torch.tpcds.oplib import decimals as D
from spark_rapids_jni_tpu_torch.tpcds.oplib import registry
from spark_rapids_jni_tpu_torch.tpcds.oplib import strings as S
from spark_rapids_jni_tpu_torch.tpcds.oplib import windows as W
from spark_rapids_jni_tpu_torch.tpcds.rel import Rel, rel_from_df, run_fused
from spark_rapids_jni_tpu_torch.utils import int128 as i128
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

CPU = torch.device("cpu")
MASK64 = (1 << 64) - 1


# --------------------------------------------------------------------------
# utils/int128: lane arithmetic against Python ints and the reference
# --------------------------------------------------------------------------

EDGE = [0, 1, 2, 0xFFFFFFFF, 1 << 32, (1 << 63) - 1, 1 << 63,
        (1 << 63) + 1, MASK64 - 1, MASK64, 10**18, 10**19,
        0x8000000080000000, 0x00000000FFFFFFFF, 0xFFFFFFFF00000000]


def _u64(vals):
    return np.array([v & MASK64 for v in vals], dtype=np.uint64)


def _lane(a_u64: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a_u64.view(np.int64).copy())


def _ints(v: i128.U128) -> list:
    hi = v.hi.numpy().view(np.uint64)
    lo = v.lo.numpy().view(np.uint64)
    return [(int(h) << 64) | int(lo_) for h, lo_ in zip(hi, lo)]


def _ref_ints(v) -> list:
    hi, lo = np.asarray(v.hi), np.asarray(v.lo)
    return [(int(h) << 64) | int(lo_) for h, lo_ in zip(hi, lo)]


def _pairs(seed, n=200):
    rng = np.random.default_rng(seed)
    edge = _u64(EDGE)
    a = np.concatenate([np.repeat(edge, len(edge)),
                        rng.integers(0, 2**64, n, dtype=np.uint64)])
    b = np.concatenate([np.tile(edge, len(edge)),
                        rng.integers(0, 2**64, n, dtype=np.uint64)])
    return a, b


def _u128_of(ints):
    hi = _u64([v >> 64 for v in ints])
    lo = _u64(ints)
    return hi, lo


def test_mul_u64_edges_equal_python_and_reference():
    a, b = _pairs(1)
    got = _ints(i128.mul_u64(_lane(a), _lane(b)))
    want = [int(x) * int(y) for x, y in zip(a, b)]
    assert got == want
    assert got == _ref_ints(ref_i128.mul_u64(jnp.asarray(a), jnp.asarray(b)))
    assert _ints(i128.mul_u64(_lane(_u64([MASK64])), _lane(_u64([MASK64])))
                 ) == [MASK64 * MASK64]


def test_mul_i64_signed_edges():
    vals = [0, 1, -1, 2**63 - 1, -2**63, -2**63 + 1, 3037000499,
            -3037000500, 10**18, -10**18]
    a = np.repeat(np.array(vals, np.int64), len(vals))
    b = np.tile(np.array(vals, np.int64), len(vals))
    got = _ints(i128.mul_i64(torch.from_numpy(a), torch.from_numpy(b)))
    want = [(int(x) * int(y)) & ((1 << 128) - 1) for x, y in zip(a, b)]
    assert got == want
    assert got == _ref_ints(ref_i128.mul_i64(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_carry_out_of_lo(op):
    rng = np.random.default_rng(2)
    xs = [0, 1, MASK64, (1 << 64), (1 << 127) - 1, 1 << 127,
          (1 << 128) - 1, (5 << 64) | MASK64] + \
        [int(v) for v in rng.integers(0, 2**62, 20)] + \
        [(int(h) << 64) | int(lo) for h, lo in
         zip(rng.integers(0, 2**64, 20, dtype=np.uint64),
             rng.integers(0, 2**64, 20, dtype=np.uint64))]
    a_ints = [x for x in xs for _ in xs]
    b_ints = [y for _ in xs for y in xs]
    ah, al = _u128_of(a_ints)
    bh, bl = _u128_of(b_ints)
    fn, rfn = getattr(i128, op), getattr(ref_i128, op)
    got = _ints(fn(i128.U128(_lane(ah), _lane(al)),
                   i128.U128(_lane(bh), _lane(bl))))
    sign = 1 if op == "add" else -1
    want = [(x + sign * y) & ((1 << 128) - 1)
            for x, y in zip(a_ints, b_ints)]
    assert got == want
    ref = rfn(ref_i128.U128(jnp.asarray(ah), jnp.asarray(al)),
              ref_i128.U128(jnp.asarray(bh), jnp.asarray(bl)))
    assert got == _ref_ints(ref)


@pytest.mark.parametrize("d", [1, 7, 10**18, (1 << 63) + 5, MASK64])
def test_divmod_u64(d):
    rng = np.random.default_rng(3)
    nums = [0, 1, d - 1 if d > 1 else 0, d, MASK64, 1 << 64,
            (1 << 128) - 1, 10**38 - 1] + \
        [(int(h) << 64) | int(lo) for h, lo in
         zip(rng.integers(0, 2**64, 30, dtype=np.uint64),
             rng.integers(0, 2**64, 30, dtype=np.uint64))]
    hi, lo = _u128_of(nums)
    q, r = i128.divmod_u64(i128.U128(_lane(hi), _lane(lo)),
                           i128.as_lane(d))
    assert _ints(q) == [v // d for v in nums]
    assert [int(x) for x in r.numpy().view(np.uint64)] == \
        [v % d for v in nums]
    rq, rr = ref_i128.divmod_u64(
        ref_i128.U128(jnp.asarray(hi), jnp.asarray(lo)),
        jnp.uint64(d))
    assert _ints(q) == _ref_ints(rq)
    np.testing.assert_array_equal(r.numpy().view(np.uint64), np.asarray(rr))


def test_divmod_round_half_up_and_mul_small():
    nums = [0, 4, 5, 14, 15, 10**20 + 5 * 10**17, (1 << 100) + 12345]
    hi, lo = _u128_of(nums)
    d = 10**18
    q, ok = i128.divmod_round_half_up(i128.U128(_lane(hi), _lane(lo)),
                                      torch.tensor([d, 10, 10, 10, 10, d, 0]))
    rq, rok = ref_i128.divmod_round_half_up(
        ref_i128.U128(jnp.asarray(hi), jnp.asarray(lo)),
        jnp.asarray(np.array([d, 10, 10, 10, 10, d, 0], np.uint64)))
    assert _ints(q) == _ref_ints(rq)
    assert ok.tolist() == np.asarray(rok).tolist()
    vals = [1, 10**20, (1 << 124), (1 << 127) // 10**18 + 1, MASK64]
    hi, lo = _u128_of(vals)
    for k in (1, 9, 18):
        p, ovf = i128.mul_small(i128.U128(_lane(hi), _lane(lo)),
                                i128.pow10_u64(k))
        rp, rovf = ref_i128.mul_small(
            ref_i128.U128(jnp.asarray(hi), jnp.asarray(lo)),
            ref_i128.pow10_u64(k))
        assert _ints(p) == _ref_ints(rp)
        assert ovf.tolist() == np.asarray(rovf).tolist()
        assert ovf.tolist() == [v * 10**k >= (1 << 128) for v in vals]


def test_compare_neg_fits_and_shifts():
    vals = [0, 1, (1 << 63) - 1, 1 << 63, MASK64, 1 << 64,
            (1 << 127), (1 << 128) - 1]
    a_ints = [x for x in vals for _ in vals]
    b_ints = [y for _ in vals for y in vals]
    ah, al = _u128_of(a_ints)
    bh, bl = _u128_of(b_ints)
    a = i128.U128(_lane(ah), _lane(al))
    b = i128.U128(_lane(bh), _lane(bl))
    assert i128.geq(a, b).tolist() == [x >= y for x, y in
                                       zip(a_ints, b_ints)]
    assert _ints(i128.neg(a)) == [(-x) & ((1 << 128) - 1) for x in a_ints]
    assert _ints(i128.shl1(a)) == [(x << 1) & ((1 << 128) - 1)
                                   for x in a_ints]
    signed = [x - (1 << 128) if x >> 127 else x for x in a_ints]
    assert i128.fits_i64(a).tolist() == [-2**63 <= v < 2**63 for v in signed]
    x = _lane(_u64(EDGE))
    for k in (0, 1, 31, 32, 63):
        assert [int(v) for v in i128.srl(x, k).numpy().view(np.uint64)] == \
            [(v & MASK64) >> k for v in EDGE]


# --------------------------------------------------------------------------
# ops/decimal_utils: Spark decimal arithmetic, overflow and /0 -> NULL
# --------------------------------------------------------------------------

def _dec_inputs(seed, n, scale_a, scale_b, wide=False):
    rng = np.random.default_rng(seed)
    hi = 2**62 if wide else 10**9
    a = rng.integers(-hi, hi, n)
    b = rng.integers(-hi, hi, n)
    a[:6] = [2**63 - 1, -2**63, 0, 1, -1, 60_000]
    b[:6] = [2, 3, 0, 0, -7, 60_000]
    b[rng.random(n) < 0.05] = 0
    va = rng.random(n) > 0.1
    vb = rng.random(n) > 0.1
    return (a, va, T.decimal64(scale_a)), (b, vb, T.decimal64(scale_b))


def _both_cols(values, valid, dt):
    port = Column.from_numpy(values, valid, dt, device=CPU)
    ref = RefColumn.from_numpy(values, valid=valid)
    ref = RefColumn(RefDType(RefTypeId(int(dt.id)), dt.scale), ref.size,
                    ref.data, ref.validity)
    return port, ref


def _ref_dtype(dt):
    return RefDType(RefTypeId(int(dt.id)), dt.scale)


def _assert_decimal_equal(got: Column, want):
    gv = got.valid_bool().numpy()
    wv = np.asarray(want.valid_bool())
    np.testing.assert_array_equal(gv, wv)
    gd, wd = got.data.numpy(), np.asarray(want.data)
    if gd.ndim == 2:  # DECIMAL128 [lo, hi] words
        wd = wd.view(np.int64)
    np.testing.assert_array_equal(gd[gv], wd[wv])


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide"])
@pytest.mark.parametrize("out", [("dec32", -2), ("dec64", -2),
                                 ("dec64", -4), ("dec64", 0),
                                 ("dec128", -4), ("dec128", -2)])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_decimal_arith_equals_reference(op, out, wide):
    (a, va, da), (b, vb, db) = _dec_inputs(4, 500, -2, -2, wide)
    kind, scale = out
    dt = {"dec32": T.decimal32, "dec64": T.decimal64,
          "dec128": T.decimal128}[kind](scale)
    if op == "divide" and not 0 <= da.scale - db.scale - scale <= 18:
        dt = {"dec32": T.decimal32, "dec64": T.decimal64,
              "dec128": T.decimal128}[kind](-2)
    pa, ra = _both_cols(a, va, da)
    pb, rb = _both_cols(b, vb, db)
    got = getattr(dec, op)(pa, pb, dt)
    want = getattr(ref_dec, op)(ra, rb, _ref_dtype(dt))
    _assert_decimal_equal(got, want)
    if op in ("multiply",) and kind == "dec32":
        # real overflow -> NULL rows among valid inputs
        assert bool((va & vb & ~got.valid_bool().numpy()).any())
    if op == "divide":
        # division by zero -> NULL
        assert not got.valid_bool().numpy()[(b == 0) & va & vb].any()


@pytest.mark.parametrize("to", [("dec64", -4), ("dec64", 0), ("dec32", -1),
                                ("dec128", -20), ("dec64", 2)])
def test_decimal_round_and_cast_equal_reference(to):
    (a, va, da), _ = _dec_inputs(5, 300, -2, -2, wide=True)
    pa, ra = _both_cols(a, va, da)
    kind, scale = to
    dt = {"dec32": T.decimal32, "dec64": T.decimal64,
          "dec128": T.decimal128}[kind](scale)
    if scale == -20:
        dt = T.decimal128(-18)  # a rescale shift of 16
    _assert_decimal_equal(dec.cast_decimal(pa, dt),
                          ref_dec.cast_decimal(ra, _ref_dtype(dt)))


def test_decimal128_operands_add_equal_reference():
    ints = [0, 1, -1, 10**38 - 1, -(10**38 - 1), 2**100, -(2**90), None,
            5 * 10**37]
    pa = Column.decimal128_from_ints(ints, scale=-2, device=CPU)
    pb = Column.decimal128_from_ints(list(reversed(ints)), scale=-2,
                                     device=CPU)
    ra = RefColumn.decimal128_from_ints(ints, scale=-2)
    rb = RefColumn.decimal128_from_ints(list(reversed(ints)), scale=-2)
    for op in ("add", "subtract"):
        _assert_decimal_equal(
            getattr(dec, op)(pa, pb, T.decimal128(-2)),
            getattr(ref_dec, op)(ra, rb, _ref_dtype(T.decimal128(-2))))


# --------------------------------------------------------------------------
# oplib decimals: cmp, to_double, as_decimal, the overflow counter
# --------------------------------------------------------------------------

def _dec128_rels(ints, scale=0):
    port = Rel(Table([Column.decimal128_from_ints(ints, scale, device=CPU)]),
               ["d"])
    ref = RefRel(RefTable([RefColumn.decimal128_from_ints(ints, scale)]),
                 ["d"])
    return port, ref


BIG = 93 * 10**20  # beyond int64


@pytest.mark.parametrize("op", ["eq", "ne", "lt", "le", "gt", "ge"])
@pytest.mark.parametrize("literal", [BIG, -BIG, 0, 10**38 - 2,
                                     -(10**38 - 2), 2**64, "-1.5"])
def test_decimal128_cmp_equals_reference(op, literal):
    ints = [BIG, BIG + 1, -BIG, 10**38 - 1, -(10**38 - 1), 0, 2**64,
            2**64 - 1, -15, None]
    port, ref = _dec128_rels(ints, scale=-1 if literal == "-1.5" else 0)
    got = D.cmp(port, "d", op, literal).numpy()
    want = np.asarray(RD.cmp(ref, "d", op, literal))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["eq", "ne", "lt", "le", "gt", "ge"])
def test_decimal64_cmp_equals_reference(op):
    df = pd.DataFrame({"a": np.array([10_000, 10_001, 9_999, -5, 0],
                                     np.int64)})
    port = rel_from_df(df, decimals={"a": -2}, device=CPU)
    ref = ref_rel_from_df(df, decimals={"a": -2})
    for lit in ("100.00", "-0.05", 0, "99.99"):
        np.testing.assert_array_equal(D.cmp(port, "a", op, lit).numpy(),
                                      np.asarray(RD.cmp(ref, "a", op, lit)))
    with pytest.raises(ValueError, match="not representable"):
        D.unscaled("1.005", -2)
    assert D.unscaled("1.50", -2) == RD.unscaled("1.50", -2) == 150


def test_decimal128_cmp_refuses_literals_past_128_bits():
    port, _ = _dec128_rels([1, 2])
    with pytest.raises(CudfLikeError, match="128 bits"):
        D.cmp(port, "d", "gt", 10**40)


def test_to_double_equals_reference():
    big = 3 * 10**21
    ints = [big, -big, 7, None, 10**38 - 1, -(2**64 + 3), 2**53 + 1]
    port, ref = _dec128_rels(ints, scale=-4)
    got = D.to_double(port, "d", "f").to_df()["f"].to_numpy(np.float64)
    want = RD.to_double(ref, "d", "f").to_df()["f"].to_numpy(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                               equal_nan=True)
    np.testing.assert_allclose(got[0], float(decimal.Decimal(big)
                                             .scaleb(-4)), rtol=1e-12)
    df = pd.DataFrame({"a": np.array([123, -4567, 2**53 + 3], np.int64)})
    p = D.to_double(rel_from_df(df, decimals={"a": -2}, device=CPU),
                    "a", "f").to_df()["f"].to_numpy()
    r = RD.to_double(ref_rel_from_df(df, decimals={"a": -2}), "a",
                     "f").to_df()["f"].to_numpy()
    np.testing.assert_allclose(p.astype(np.float64), r.astype(np.float64),
                               rtol=1e-12, atol=0)


def _product_plan(t):
    x = D.as_decimal(t["x"], "a", -2)
    x = D.as_decimal(x, "b", -2)
    x = D.arith(x, "mul", "a", "b", ("dec32", -4), "p")
    x = x.filter(x.data("keep") > 0)
    return x.select("a", "p").sort(["a"])


def _ref_product_plan(t):
    x = RD.as_decimal(t["x"], "a", -2)
    x = RD.as_decimal(x, "b", -2)
    x = RD.arith(x, "mul", "a", "b", ("dec32", -4), "p")
    x = x.filter(x.data("keep") > 0)
    return x.select("a", "p").sort(["a"])


def test_overflow_counter_eager_and_fused_agree():
    rng = np.random.default_rng(6)
    n = 2000
    df = pd.DataFrame({"a": rng.integers(100, 60_001, n),
                       "b": rng.integers(0, 60_001, n),
                       "keep": rng.integers(0, 2, n)})
    # eagerly the arith counts at once; the mask is applied later, so
    # every overflowing row counts
    before = kernel_stats()
    eager_df = _product_plan({"x": rel_from_df(df, device=CPU)}).to_df()
    eager = stats_since(before).get("rel.route.decimal.overflow", 0)
    before = kernel_stats()
    fused_df = run_fused(_product_plan, {"x": rel_from_df(df, device=CPU)},
                         device="cpu").to_df()
    st = stats_since(before)
    fused = st.get("rel.route.decimal.overflow", 0)
    want = int((df.a.astype(object) * df.b > 2**31 - 1).sum())
    assert eager == fused == want > 0
    _, syncs = dispatch_counts(st)
    assert syncs == 1 and st.get("rel.fused_fallbacks", 0) == 0, st
    pd.testing.assert_frame_equal(eager_df, fused_df)
    rb = ref_obs.kernel_stats()
    ref_df = _ref_product_plan({"x": ref_rel_from_df(df)}).to_df()
    assert ref_obs.stats_since(rb).get("rel.route.decimal.overflow") == want
    assert eager_df["a"].tolist() == ref_df["a"].tolist()
    assert [None if pd.isna(v) else v for v in eager_df["p"]] == \
        [None if pd.isna(v) else v for v in ref_df["p"]]


def test_overflow_counter_alone_is_the_one_sync():
    # a plan with no mask: the counter is read by itself, one sync
    df = pd.DataFrame({"a": np.array([50_000, 60_000, 10], np.int64),
                       "b": np.array([50_000, 60_000, 20], np.int64)})

    def plan(t):
        x = D.as_decimal(t["x"], "a", -2)
        x = D.as_decimal(x, "b", -2)
        return D.arith(x, "mul", "a", "b", ("dec32", -4), "p")

    before = kernel_stats()
    out = run_fused(plan, {"x": rel_from_df(df, device=CPU)}, device="cpu")
    st = stats_since(before)
    assert st.get("rel.route.decimal.overflow") == 2
    assert st.get("rel.host_syncs.rel.aux_count") == 1
    assert dispatch_counts(st)[1] == 1
    assert [None if v is None else str(v)
            for v in out.to_df()["p"]] == [None, None, "0.0200"]


def test_as_decimal_keeps_an_ingested_decimal_and_refuses_others():
    df = pd.DataFrame({"a": np.array([1, 2], np.int64),
                       "f": np.array([1.5, 2.5])})
    rel = rel_from_df(df, decimals={"a": -2}, device=CPU)
    assert D.as_decimal(rel, "a", -2) is rel
    with pytest.raises(CudfLikeError, match="already"):
        D.as_decimal(rel, "a", -3)
    with pytest.raises(CudfLikeError, match="integer"):
        D.as_decimal(rel, "f", -2)
    out = D.as_decimal(rel_from_df(df, device=CPU), "a", 0, out="a0")
    assert out.col("a0").dtype == T.decimal64(0)


def test_decimal128_aggregation_refuses_with_reason():
    df = pd.DataFrame({"k": np.array([0, 1, 0], np.int64),
                       "a": np.array([10, 20, 30], np.int64),
                       "b": np.array([3, 4, 5], np.int64)})

    def wide(t):
        x = D.as_decimal(t["x"], "a", -2)
        x = D.as_decimal(x, "b", -2)
        return D.arith(x, "mul", "a", "b", ("dec128", -4), "w")

    with pytest.raises(CudfLikeError, match="DECIMAL128"):
        run_fused(lambda t: wide(t).groupby(["k"], [("w", "sum", "s")]),
                  {"x": rel_from_df(df, device=CPU)}, device="cpu")
    with pytest.raises(CudfLikeError, match="DECIMAL128"):
        run_fused(lambda t: wide(t).window(["k"], [], [("sum", "w", "s")]),
                  {"x": rel_from_df(df, device=CPU)}, device="cpu")


# --------------------------------------------------------------------------
# strings: the operators on both routes, the eager STRING-column ops
# --------------------------------------------------------------------------

WORDS = ["alpha", "Beta", "alphabet", "gamma_ray", "Álpha", "", "beta",
         "ALPHA", "a_b%c", "日本語テキスト", "alp", "xyz", "ßü", "a%b"]


def _word_df():
    return pd.DataFrame({"w": [WORDS[i % len(WORDS)] for i in range(64)],
                         "v": np.arange(64, dtype=np.int64)})


PREDICATES = [
    ("contains", ("alp",)), ("contains", ("ph",)), ("contains", ("",)),
    ("contains", ("語テ",)), ("starts_with", ("al",)),
    ("starts_with", ("Á",)), ("like", ("alp%",)), ("like", ("%a_e%",)),
    ("like", ("_lpha",)), ("like", ("_lpha%",)),   # '_' on a 2-byte Á
    ("like", ("日__テ%",)),                       # '_' on 3-byte chars
    ("like", ("%語テ%",)), ("like", ("a\\_b\\%c",)),  # escaped literals
    ("like", ("a!%b", "!")), ("like", ("%",)), ("like", ("",)),
    ("like", ("__",)),
]


@pytest.mark.parametrize("route", ["dict", "bytes"])
@pytest.mark.parametrize("op,args", PREDICATES,
                         ids=[f"{o}{a}" for o, a in PREDICATES])
def test_string_predicate_equals_reference(op, args, route, monkeypatch):
    monkeypatch.setenv("SRT_STRING_ROUTE", route)
    df = _word_df()
    before = kernel_stats()
    got = getattr(S, op)(rel_from_df(df, device=CPU), "w", *args).numpy()
    assert stats_since(before).get(f"rel.route.string.{op}.{route}") == 1
    want = np.asarray(getattr(RS, op)(ref_rel_from_df(df), "w", *args))
    np.testing.assert_array_equal(got, want)
    host = {"contains": lambda s, p: p in s,
            "starts_with": lambda s, p: s.startswith(p),
            "like": S._host_like}[op]
    np.testing.assert_array_equal(got, [host(w, *args) for w in df.w])


@pytest.mark.parametrize("proj,args", [
    ("substr", (1, 3)), ("substr", (0, 1)), ("substr", (4, 10)),
    ("upper", ()), ("lower", ()), ("char_length", ())])
def test_string_projection_equals_reference(proj, args):
    df = _word_df()
    got = getattr(S, proj)(rel_from_df(df, device=CPU), "w", *args,
                           "o").to_df()
    want = getattr(RS, proj)(ref_rel_from_df(df), "w", *args, "o").to_df()
    assert got["o"].tolist() == want["o"].tolist()
    out = getattr(S, proj)(rel_from_df(df, device=CPU), "w", *args, "o")
    if proj != "char_length":
        cats = list(out.dicts["o"])
        assert cats == sorted(cats)  # code order stays string order
    assert out.col("o").value_range is not None  # trusted by construction


def test_string_concat_cross_product_dictionary():
    df = pd.DataFrame({"a": ["x", "y", "x", "z"], "b": ["1", "2", "2", "1"]})
    for sep in ("", "-"):
        out = S.concat(rel_from_df(df, device=CPU), "a", "b", "ab", sep=sep)
        ref = RS.concat(ref_rel_from_df(df), "a", "b", "ab", sep=sep)
        assert out.to_df()["ab"].tolist() == ref.to_df()["ab"].tolist() \
            == [f"x{sep}1", f"y{sep}2", f"x{sep}2", f"z{sep}1"]
        assert list(out.dicts["ab"]) == list(ref.dicts["ab"])
        assert len(out.dicts["ab"]) == 6  # the 3 x 2 cross product


def test_string_projection_preserves_nulls_general_path():
    # a string column with nulls stays a STRING column (the ingest
    # repair); the operators take the eager route and keep NULLs
    df = pd.DataFrame({"s": ["ab", None, "cd", "ÁB", None, "a_b"]})
    rel, ref = rel_from_df(df, device=CPU), ref_rel_from_df(df)
    assert rel.col("s").dtype.id == T.TypeId.STRING and "s" not in rel.dicts
    before = kernel_stats()
    for proj, args in (("upper", ()), ("lower", ()), ("substr", (1, 1)),
                       ("char_length", ())):
        got = getattr(S, proj)(rel, "s", *args, "u").to_df()["u"]
        want = getattr(RS, proj)(ref, "s", *args, "u").to_df()["u"]
        assert [None if pd.isna(v) else v for v in got] == \
            [None if pd.isna(v) else v for v in want], proj
    got, want = (
        [None if pd.isna(v) else v for v in f(r, "s", "s", "ss").to_df()["ss"]]
        for f, r in ((S.concat, rel), (RS.concat, ref)))
    assert got == want and got[0] == "abab" and got[1] is None
    for op, args in (("contains", ("b",)), ("like", ("_b",)),
                     ("starts_with", ("Á",))):
        np.testing.assert_array_equal(
            getattr(S, op)(rel, "s", *args).numpy(),
            np.asarray(getattr(RS, op)(ref, "s", *args)))
    st = stats_since(before)
    assert st.get("rel.route.string.upper.general") == 1
    assert st.get("rel.route.string.like.general") == 1
    # a filter on the STRING column compacts through the row gathers
    f = rel.filter(S.contains(rel, "s", "b"))
    assert f.to_df()["s"].tolist() == ["ab", "a_b"]
    assert run_fused(lambda t: t["x"].filter(S.contains(t["x"], "s", "B")),
                     {"x": rel}, device="cpu").to_df()["s"].tolist() == ["ÁB"]


def test_string_operators_fall_back_in_a_fused_plan():
    df = pd.DataFrame({"s": ["ab", None], "k": np.array([1, 2], np.int64)})
    before = kernel_stats()
    out = run_fused(lambda t: S.upper(t["x"], "s", "u").sort(["k"]),
                    {"x": rel_from_df(df, device=CPU)}, device="cpu")
    assert stats_since(before).get("rel.fused_fallbacks") == 1
    assert out.to_df()["u"].tolist()[0] == "AB"


def _string_cols(values):
    return (Column.strings_from_list(values, device=CPU),
            RefColumn.strings_from_list(values))


def _assert_strings_equal(got: Column, want):
    assert got.to_pylist() == want.to_pylist()


UTF8 = ["hello", "", None, "Ünïcödé", "日本語テキスト", "a.b.c.d", "..",
        "x", "ABCxyz", "a..b...c", "ßü ß", "mixed Case 12"]


@pytest.mark.parametrize("fn,args", [
    ("upper", ()), ("lower", ()), ("substring", (0, 3)),
    ("substring", (2, 4)), ("substring", (1, 0)),
    ("substring_index", (".", 2)), ("substring_index", (".", -1)),
    ("substring_index", ("..", 1)), ("substring_index", ("..", -2)),
    ("substring_index", (".", 0))])
def test_eager_string_ops_equal_reference(fn, args):
    port, ref = _string_cols(UTF8)
    _assert_strings_equal(getattr(sops, fn)(port, *args),
                          getattr(ref_sops, fn)(ref, *args))


@pytest.mark.parametrize("fn,args", [
    ("char_lengths", ()), ("contains", ("c",)), ("contains", ("語テ",)),
    ("starts_with", ("a",)), ("like", ("%c%",)), ("like", ("_本%",)),
    ("like", ("a\\.b%",))])
def test_eager_string_predicates_equal_reference(fn, args):
    port, ref = _string_cols(UTF8)
    got, want = getattr(sops, fn)(port, *args), getattr(ref_sops, fn)(
        ref, *args)
    np.testing.assert_array_equal(got.valid_bool().numpy(),
                                  np.asarray(want.valid_bool()))
    v = got.valid_bool().numpy()
    np.testing.assert_array_equal(got.data.numpy()[v],
                                  np.asarray(want.data)[v])


def test_eager_concat_and_like_tokens_equal_reference():
    pa, ra = _string_cols(UTF8)
    pb, rb = _string_cols(list(reversed(UTF8)))
    _assert_strings_equal(sops.concat(pa, pb), ref_sops.concat(ra, rb))
    for pat in ("a\\_b%", "%%_", "x!%", ""):
        assert sops.like_tokens(pat) == ref_sops.like_tokens(pat)
    assert sops.like_tokens("x!%", "!") == ref_sops.like_tokens("x!%", "!")


# --------------------------------------------------------------------------
# windows
# --------------------------------------------------------------------------

def _window_df():
    rng = np.random.default_rng(23)
    n = 500
    return pd.DataFrame({"g": rng.integers(0, 7, n),
                         "o": rng.integers(0, 9, n),   # ties for rank
                         "u": np.arange(n, dtype=np.int64),
                         "v": rng.integers(-50, 50, n)})


WINDOWS = [
    (["g"], ["o", "u"], [("row_number", None, "rn"), ("rank", None, "rk"),
                         ("sum", "v", "vs"), ("count", "v", "vc")], None),
    (["g"], ["o"], [("rank", None, "rk"), ("row_number", None, "rn")],
     [True]),
    (["g"], ["o", "u"], [("rank", None, "rk")], [True, False]),
    (["g", "o"], ["v"], [("rank", None, "rk"), ("sum", "v", "vs")], None),
    (["g"], [], [("sum", "v", "vs"), ("count", "v", "vc")], None),
]


@pytest.mark.parametrize("part,order,funcs,desc", WINDOWS)
def test_window_equals_reference(part, order, funcs, desc):
    df = _window_df()
    got = rel_from_df(df, device=CPU).window(part, order, funcs, desc) \
        .to_df()
    want = ref_rel_from_df(df).window(part, order, funcs, desc).to_df()
    for _, _, name in funcs:
        assert got[name].tolist() == want[name].tolist(), name
    oracle = W.window_oracle(df, part, order, funcs, desc)
    for _, _, name in funcs:
        assert got[name].tolist() == oracle[name].tolist(), name


def test_window_masked_rows_do_not_shift_numbering():
    df = _window_df()
    funcs = [("row_number", None, "rn"), ("rank", None, "rk"),
             ("sum", "v", "vs")]
    rel = rel_from_df(df, device=CPU)
    got = rel.filter(rel.data("v") >= 0).window(["g"], ["o"], funcs,
                                                [True]).to_df()
    ref = ref_rel_from_df(df)
    want = ref.filter(ref.data("v") >= 0).window(["g"], ["o"], funcs,
                                                 [True]).to_df()
    for _, _, name in funcs:
        assert got[name].tolist() == want[name].tolist(), name


def test_window_null_order_keys_tie():
    g = np.zeros(5, np.int64)
    o = np.array([5, 17, 99, 5, 1], np.int64)
    valid = np.array([True, False, False, True, True])
    rel = Rel(Table([Column.from_numpy(g, device=CPU),
                     Column.from_numpy(o, valid, device=CPU)]), ["g", "o"])
    ref = RefRel(RefTable([RefColumn.from_numpy(g),
                           RefColumn.from_numpy(o, valid=valid)]), ["g", "o"])
    for desc in (None, [True]):
        got = rel.window(["g"], ["o"], [("rank", None, "rk")], desc).to_df()
        want = ref.window(["g"], ["o"], [("rank", None, "rk")],
                          desc).to_df()
        assert got["rk"].tolist() == want["rk"].tolist()
    # nulls first, one tie run whatever lies under them
    assert rel.window(["g"], ["o"], [("rank", None, "rk")]) \
        .to_df()["rk"].tolist() == [4, 1, 1, 4, 3]


def test_window_untrusted_keys_take_the_general_route():
    df = _window_df()
    df = df.assign(gf=df.g.astype(np.float64))
    funcs = [("sum", "v", "vs"), ("row_number", None, "rn")]
    before = kernel_stats()
    rel = rel_from_df(df, device=CPU)
    got = rel.filter(rel.data("v") > -40).window(["gf"], ["o", "u"],
                                                 funcs).to_df()
    assert stats_since(before).get("rel.route.window.general") == 1
    ref = ref_rel_from_df(df)
    want = ref.filter(ref.data("v") > -40).window(["gf"], ["o", "u"],
                                                  funcs).to_df()
    for _, _, name in funcs:
        assert got[name].tolist() == want[name].tolist(), name
    before = kernel_stats()
    run_fused(lambda t: t["x"].window(["gf"], ["o", "u"], funcs)
              .sort(["u"]), {"x": rel_from_df(df, device=CPU)},
              device="cpu")
    assert stats_since(before).get("rel.fused_fallbacks") == 1


def test_window_decimal128_order_keys():
    ints = [5, -(2**70), 2**70, 5, None, -1, 2**64]
    g = np.zeros(len(ints), np.int64)
    rel = Rel(Table([Column.from_numpy(g, device=CPU),
                     Column.decimal128_from_ints(ints, device=CPU)]),
              ["g", "d"])
    for desc, want in ((None, [4, 2, 7, 4, 1, 3, 6]),
                       ([True], [4, 7, 2, 4, 1, 6, 3])):
        got = rel.window(["g"], ["d"], [("rank", None, "rk")], desc)
        assert got.to_df()["rk"].tolist() == want


# --------------------------------------------------------------------------
# ingest, to_df and the registry
# --------------------------------------------------------------------------

def test_rel_from_df_decimals_and_to_df_equal_reference():
    df = pd.DataFrame({"a": np.array([12345, -7, 0, 2**62], np.int64),
                       "b": np.array([1, 2, 3, 4], np.int32),
                       "s": ["x", "y", "x", "z"]})
    decs = {"a": -2, "b": 3}
    rel = rel_from_df(df, decimals=decs, device=CPU)
    ref = ref_rel_from_df(df, decimals=decs)
    for c in ("a", "b"):
        assert rel.col(c).dtype == T.decimal64(decs[c])
        assert int(rel.col(c).dtype.id) == int(ref.col(c).dtype.id)
    got, want = rel.to_df(), ref.to_df()
    for c in df.columns:
        assert got[c].tolist() == want[c].tolist(), c
    assert got["a"][0] == decimal.Decimal("123.45")
    # DECIMAL32 decodes too (an arithmetic result)
    x = D.arith(rel, "add", "a", "a", ("dec32", -2), "d32")
    rx = RD.arith(ref, "add", "a", "a", ("dec32", -2), "d32")
    assert [None if pd.isna(v) else v for v in x.to_df()["d32"]] == \
        [None if pd.isna(v) else v for v in rx.to_df()["d32"]]
    with pytest.raises(CudfLikeError, match="integer"):
        rel_from_df(pd.DataFrame({"f": [1.5]}), decimals={"f": -2},
                    device=CPU)


def test_registry_contracts():
    specs = registry.registered()
    assert {"join", "groupby", "window", "string.contains", "string.like",
            "string.starts_with", "string.substr", "string.upper",
            "string.lower", "string.concat", "string.char_length",
            "decimal.arith", "decimal.cmp", "decimal.as_decimal",
            "decimal.to_double"} <= set(specs)
    for name, spec in specs.items():
        assert spec.mask_class in registry.MASK_CLASSES, name
        assert spec.partition in registry.PARTITION_BEHAVIORS, name
        assert callable(spec.oracle) and callable(spec.lowering), name
    spec = specs["string.contains"]

    def contains(rel):  # a different lowering under a taken name
        return rel

    with pytest.raises(ValueError, match="duplicate"):
        registry.register_operator(registry.OperatorSpec(
            "string.contains", "rowwise", "local", contains, spec.oracle))
    registry.register_operator(spec)  # the same lowering again is fine
    assert registry.registered()["string.contains"] is spec
    with pytest.raises(ValueError, match="partition"):
        registry.OperatorSpec("x", "rowwise", "everywhere",
                              lambda r: r, lambda s: s)
    with pytest.raises(ValueError, match="oracle"):
        registry.OperatorSpec("x", "rowwise", "local", lambda r: r, None)
