"""CastStrings of the PyTorch/CUDA port against the JAX package on the same
numpy inputs (on the CPU): string -> integer, float, decimal, date and
timestamp, integer and decimal -> string, ``conv`` and ``format_number``.

Strings and integers are byte-equal to the reference, and so is every
validity bit. string -> float is bit-equal to the reference and to a
Python model of its arithmetic; where the reference flushed a subnormal
on the CPU (which the port does not), the row is held against the model
alone.
"""

import datetime as pydt
import math
import os
import re

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as ref_types
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.ops import cast_strings as ref_cs

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops import cast_strings as cs

CPU = torch.device("cpu")
EPOCH = pydt.date(1970, 1, 1)
# every string input has N rows, its last W bytes wide, so that the
# reference compiles its operators once for the whole file
N, W = 2048, 48
FILLER = "x" * W


def _sized(strs, last=FILLER):
    """``strs`` cycled to N - 1 rows, then ``last`` (W bytes)."""
    assert len(last) == W
    return [strs[i % len(strs)] for i in range(N - 1)] + [last]


def _ref_dtype(dt):
    return ref_types.DType.from_ids(int(dt.id), dt.scale)


def _strings(strs):
    assert len(strs) == N
    return (RefColumn.strings_from_list(strs),
            Column.strings_from_list(strs, device=CPU))


def _fixed(values, valid, dt):
    return (RefColumn.from_numpy(values, valid, _ref_dtype(dt)),
            Column.from_numpy(values, valid, dt, device=CPU))


def _same_fixed(got: Column, want) -> None:
    """Validity equal, and every valid value byte-equal."""
    ok = np.asarray(want.valid_bool())
    np.testing.assert_array_equal(got.valid_bool().numpy(), ok)
    assert got.dtype.id == T.TypeId(int(want.dtype.id))
    np.testing.assert_array_equal(got.data.numpy()[ok],
                                  np.asarray(want.data)[ok])


def _same_strings(got: Column, want) -> None:
    assert got.to_pylist() == want.to_pylist()


def _mutate(rng, base, alphabet, n):
    """``n`` strings: members of ``base`` with up to three byte edits."""
    out = []
    for _ in range(n):
        s = list(str(rng.choice(base)))
        for _ in range(int(rng.integers(0, 4))):
            k = int(rng.integers(0, len(s) + 1))
            op = int(rng.integers(0, 3))
            if op == 0:
                s.insert(k, str(rng.choice(alphabet)))
            elif s and op == 1:
                s.pop(min(k, len(s) - 1))
            elif s:
                s[min(k, len(s) - 1)] = str(rng.choice(alphabet))
        out.append("".join(s))
    return out


INT_STRINGS = [
    "123", "-45", "+7", "  42  ", "1.9", "0", "", "abc", "12a", None,
    "9223372036854775807", "9223372036854775808", "-9223372036854775808",
    "-9223372036854775809", "1.", ".5", "-", "+", " \t-12.300 ", "-0",
    "99999999999999999999999", "12.9a", "1e5", "127", "128", "-128",
    "-129", "32767", "32768", "2147483647", "2147483648", "-2147483649",
    "00000000000000000000000012", "+-1", "1 2"]


def int_strings():
    rng = np.random.default_rng(11)
    return _sized(INT_STRINGS + _mutate(rng, INT_STRINGS[:25],
                                        list("0123456789+-. e\tx"), 2000))


@pytest.mark.parametrize("dt", [T.INT64, T.INT32, T.DType(T.TypeId.INT16),
                                T.INT8],
                         ids=lambda d: d.id.name)
def test_cast_to_integer_matches_reference(dt):
    ref, col = _strings(int_strings())
    _same_fixed(cs.cast_to_integer(col, dt),
                ref_cs.cast_to_integer(ref, _ref_dtype(dt)))


def test_cast_to_integer_ansi():
    valid = _sized([" 1", "-2", None, "9223372036854775807", "+0"],
                   "9223372036854775807".center(W))
    ref, col = _strings(valid)
    _same_fixed(cs.cast_to_integer(col, ansi=True),
                ref_cs.cast_to_integer(ref, ansi=True))
    for bad, row in (("1.9", 1), ("abc", 0), ("", 2)):
        strs = list(valid)
        strs[row] = bad
        ref, col = _strings(strs)
        with pytest.raises(Exception, match=f"ANSI cast.*row {row}"):
            ref_cs.cast_to_integer(ref, ansi=True)
        with pytest.raises(Exception, match=f"ANSI cast.*row {row}"):
            cs.cast_to_integer(col, ansi=True)


def test_integer_round_trip():
    rng = np.random.default_rng(21)
    vals = np.concatenate([rng.integers(-2**63, 2**63 - 1, 3000,
                                        dtype=np.int64, endpoint=True),
                           [-2**63, 2**63 - 1, 0, -1]]).astype(np.int64)
    s = cs.cast_integer_to_string(Column.from_numpy(vals, device=CPU))
    assert s.to_pylist() == [str(v) for v in vals.tolist()]
    np.testing.assert_array_equal(cs.cast_to_integer(s).data.numpy(), vals)


FLOAT_STRINGS = [
    "1.5", "-2.25", "3", "1e3", "-1.5e-2", "inf", "-Infinity", "NaN", "",
    "x", "1e", ".5", "5.", None, "3.14159265358979", "2.718281828e10",
    "-1.23456789e-30", "987654321.123456789", "1e308", "1e-300",
    "12345678901234567890123", "1e400", "-0", "+inF", " nan ", "1e-307",
    "1E+5", "0.1", "0.30000000000000004", "9007199254740993", "1e23",
    "1.7976931348623157e308", "1.7976931348623159e308",
    "2.2250738585072011e-308", "2.2250738585072012e-308",
    "1.00000000000000011102230246251565404236316680908203125",
    "1.00000000000000011102230246251565404236316680908203124",
    "1.00000000000000011102230246251565404236316680908203126",
    "1e-310", "4.9e-324", "2.4e-324", "2.5e-324", "123456e-313",
    "0.000000000000000000000012345678901234567890", "0e500", "1e-40",
    "3.4028235e38", "3.4028236e38", "1.4e-45", "7e-46", " -1.5E-3 ",
    "1.5e", "1.5e+", "e5", "1..5", "1.5.5", "infinity", "infinit",
    "nana", "-nan"]


def float_strings():
    rng = np.random.default_rng(13)
    out = list(FLOAT_STRINGS)
    for _ in range(1300):
        nd = int(rng.integers(1, 26))
        ds = "".join(rng.choice(list("0123456789"), nd))
        k = int(rng.integers(0, nd + 1))
        sign = "-" if rng.random() < 0.3 else ""
        out.append(f"{sign}{ds[:k]}.{ds[k:]}e{int(rng.integers(-340, 310))}")
    return _sized(out + _mutate(rng, FLOAT_STRINGS[:40],
                                list("0123456789+-.eE n"), 650))


def _reference_model(s):
    """The reference's arithmetic in Python floats, which do not flush
    subnormals: the first 19 mantissa digits accumulated as acc * 10 + d,
    times the C library's 10.0 ** e."""
    t = s.strip(" \t\n\r\f\v")
    neg = t[:1] == "-"
    t = t[1:] if t[:1] in "+-" else t
    if t.lower() in ("inf", "infinity"):
        return -math.inf if neg else math.inf
    if t.lower() == "nan":
        return math.nan
    mant, _, exp = t.lower().partition("e")
    ints, _, frac = mant.partition(".")
    acc = 0.0
    for d in (ints + frac)[:19]:
        acc = acc * 10.0 + int(d)
    e = (int(exp or 0) + max(len(ints) - 19, 0)
         - min(len(frac), max(19 - len(ints), 0)))
    p10 = 0.0 if e < -323 else math.inf if e > 308 else 10.0 ** e
    v = acc * p10
    return -v if neg else v


def _same_bits(a, b):
    """Bit for bit, NaN as one value."""
    ints = np.int64 if a.dtype == np.float64 else np.int32
    return (a.view(ints) == b.view(ints)) | (np.isnan(a) & np.isnan(b))


@pytest.mark.parametrize("dt", ["FLOAT64", "FLOAT32"])
def test_cast_to_float_bit_equal_to_reference(dt):
    strs = float_strings()
    ref, col = _strings(strs)
    got = cs.cast_to_float(col, getattr(T, dt))
    want = ref_cs.cast_to_float(ref, getattr(ref_types, dt))
    ok = got.valid_bool().numpy()
    np.testing.assert_array_equal(ok, np.asarray(want.valid_bool()))
    g = got.data.numpy()
    r = np.asarray(want.data)
    with np.errstate(over="ignore", invalid="ignore"):
        model = np.array([_reference_model(s) if v else 0.0
                          for s, v in zip(strs, ok)]).astype(g.dtype)
    # every valid row: the Python model of the reference's arithmetic
    assert _same_bits(g, model)[ok].all()
    # and the reference bit for bit, but where it flushed a subnormal on
    # the CPU (a power of ten below 1e-307, a float32 below 2^-126)
    tiny = np.finfo(g.dtype).tiny
    flushed = ok & (r == 0) & (g != 0) & (np.abs(g) < tiny) if dt == \
        "FLOAT32" else ok & (r == 0) & (g != 0)
    assert _same_bits(g, r)[ok & ~flushed].all()
    assert (ok & ~flushed).sum() > 0.9 * ok.sum()
    if dt == "FLOAT64":
        # the reference's 0.0 comes from a subnormal power of ten
        exps = [_total_exp(s) for s, f in zip(strs, flushed) if f]
        assert exps and all(-323 <= e <= -308 for e in exps)


def _total_exp(s):
    mant, _, exp = s.strip().lstrip("+-").lower().partition("e")
    ints, _, frac = mant.partition(".")
    return (int(exp or 0) + max(len(ints) - 19, 0)
            - min(len(frac), max(19 - len(ints), 0)))


def test_cast_to_float_keeps_the_reference_deviations():
    # an inexact power of ten, leading zeros among the 19 digits, 0 * inf
    # and a subnormal power of ten, which the port does not flush
    strs = ["0.1e-1", "1e23", "0." + "0" * 21 + "1", "0e500", "1e-310",
            "-123456e-313", "4.9e-324", "1e-324", "1.5", "-0e500", "-nan"]
    got = cs.cast_to_float(Column.strings_from_list(strs, device=CPU))
    want = np.array([_reference_model(s) for s in strs])
    assert _same_bits(got.data.numpy(), want).all()
    v = got.data.numpy()
    assert v[1] == 1.0000000000000001e23 and v[2] == 0.0
    assert v[4] == 1e-310 and v[7] == 0.0
    # every NaN is the one quiet NaN, whichever device made it
    nan = np.isnan(v)
    assert nan.sum() == 3
    assert (v[nan].view(np.int64) == 0x7FF8000000000000).all()


DEC_STRINGS = [
    "12.345", "12.3456", "12.3444", "-1.005", "12", "0.5", "", "x",
    "99999999999999999999", "2147483.647", "2147483.648", "-0.0005", ".5",
    "5.", " -7.25 ", "+3.999", "1.2.3", "-", None, "922337203685477.5807",
    "92233720368547758.08", "0.0000000001", "21474836.47", "-21474836.48"]


def dec_strings():
    rng = np.random.default_rng(17)
    return _sized(DEC_STRINGS + _mutate(rng, DEC_STRINGS[:16],
                                        list("0123456789+-. x"), 1500))


@pytest.mark.parametrize("scale", [-3, -2, 0, 2, -8])
@pytest.mark.parametrize("dt", [T.decimal32, T.decimal64],
                         ids=["DECIMAL32", "DECIMAL64"])
def test_cast_to_decimal_matches_reference(dt, scale):
    ref, col = _strings(dec_strings())
    _same_fixed(cs.cast_to_decimal(col, dt(scale)),
                ref_cs.cast_to_decimal(ref, _ref_dtype(dt(scale))))


def _edge_integers():
    """Every sign and digit count: 0, +-(10^k), +-(10^k - 1) and the
    int64 extremes."""
    v = [0, -2**63, 2**63 - 1]
    for k in range(1, 19):
        v += [10 ** k, 10 ** k - 1, -(10 ** k), -(10 ** k - 1)]
    return np.array(v, np.int64)


def _integers(seed):
    """N int64 values: the edge values, then seeded ones."""
    edges = _edge_integers()
    rng = np.random.default_rng(seed)
    return np.concatenate([edges, rng.integers(
        -2**63, 2**63 - 1, N - len(edges), dtype=np.int64)])


@pytest.mark.parametrize("dt", [T.INT64, T.INT32, T.DType(T.TypeId.INT16),
                                T.INT8, T.BOOL8],
                         ids=lambda d: d.id.name)
def test_cast_integer_to_string_matches_reference(dt):
    rng = np.random.default_rng(23)
    vals = _integers(23)
    if dt.id == T.TypeId.BOOL8:
        vals = vals & 1
    vals = vals.astype(dt.storage_dtype)
    valid = rng.random(len(vals)) > 0.1
    valid[:len(_edge_integers())] = True
    ref, col = _fixed(vals, valid, dt)
    _same_strings(cs.cast_integer_to_string(col),
                  ref_cs.cast_integer_to_string(ref))


def test_integer_string_assembly_every_branch():
    # the device assembly against the reference's per-row host loop on
    # every sign and digit count, one row each
    ref, col = _fixed(_edge_integers(), None, T.INT64)
    got = cs.cast_integer_to_string(col)
    _same_strings(got, ref_cs.cast_integer_to_string(ref))
    assert got.to_pylist() == [str(v) for v in _edge_integers().tolist()]


CONV_STRINGS = [
    "ff", "-ff", "FFFFFFFFFFFFFFFF", "1FFFFFFFFFFFFFFFF", "zz", "", None,
    "12x3", "-0", "x", "-9223372036854775808", "18446744073709551615",
    "18446744073709551616", "7fffffffffffffff", "8000000000000000", "-1",
    " 12", "0", "z1", "-z"]


@pytest.mark.parametrize("bases", [(10, 16), (16, -10), (16, 10), (36, 2),
                                   (2, -36), (10, -10), (8, 3)],
                         ids=lambda b: f"{b[0]}to{b[1]}")
def test_conv_matches_reference(bases):
    rng = np.random.default_rng(29)
    strs = _sized(CONV_STRINGS + ["".join(rng.choice(
        list("0123456789abcdefABCDEF-xz"), int(rng.integers(0, 22))))
        for _ in range(1500)])
    ref, col = _strings(strs)
    _same_strings(cs.conv(col, *bases), ref_cs.conv(ref, *bases))


@pytest.mark.parametrize("dt,scale", [(T.decimal32, -2), (T.decimal32, 3),
                                      (T.decimal64, 0), (T.decimal64, -5),
                                      (T.decimal64, -18)],
                         ids=["DECIMAL32-2", "DECIMAL32+3", "DECIMAL64+0",
                              "DECIMAL64-5", "DECIMAL64-18"])
def test_cast_decimal_to_string_matches_reference(dt, scale):
    rng = np.random.default_rng(31)
    vals = _integers(31).astype(dt(scale).storage_dtype)
    valid = rng.random(len(vals)) > 0.1
    ref, col = _fixed(vals, valid, dt(scale))
    _same_strings(cs.cast_decimal_to_string(col),
                  ref_cs.cast_decimal_to_string(ref))


@pytest.mark.parametrize("d", [0, 2, 5, -1])
def test_format_number_matches_reference(d):
    rng = np.random.default_rng(37)
    f = np.concatenate([rng.standard_normal(300) * 10.0 ** rng.integers(
        -10, 12, 300), [0.005, 2.675, 0.125, 0.375, -0.5, 1e20, 1234.5,
                        1235.5, np.nan, np.inf, -np.inf, -0.0, 1e300]])
    ints = rng.integers(-2**63, 2**63 - 1, 300, dtype=np.int64)
    with np.errstate(over="ignore"):
        f32 = f.astype(np.float32)
    for vals, dt in ((f, T.FLOAT64), (f32, T.FLOAT32),
                     (ints, T.INT64), (ints, T.decimal64(-3)),
                     (ints.astype(np.int32), T.decimal32(-2))):
        valid = rng.random(len(vals)) > 0.1
        ref, col = _fixed(vals, valid, dt)
        _same_strings(cs.format_number(col, d), ref_cs.format_number(ref, d))


# --------------------------------------------------------------------------
# string -> DATE / TIMESTAMP
# --------------------------------------------------------------------------

DT_STRINGS = [
    "2015", "2015-03", "2015-03-18", "2015-03-18 12",
    "2015-03-18 12:03:17.", "2015-03-18 12:03:17.123456789",
    "2015-03-18 12:03:17.1234567891", "2015-03-18 12:03:17 GMT",
    "2015-03-18 12:03:17 UT", "2015-03-18 12:03:17UTC+01:00",
    "2015-03-18 12:03:17-0130", "2015-03-18 12:03:17+5",
    "2015-03-18 12:03:17+19:00", "2015-03-18 12:03:17 PST",
    "2015-03-18 12:+05:00", "2015-03-18 12:03:+05:00",
    "999999-01-01 00:00:00", "2015555-01-01 00:00:00",
    "2015-03-18 24:00:00", "2015-03-18 12:60:00", "junk",
    "2015-03-18 12:03:17Z+01:00", "2015-03-18 12:03:17+05:3", "1234:56",
    "2026-03-08 02:30:00", "2026-11-01 01:30:00", "+2015-03-18",
    "-0010-01-01", "9999999-01-01", "20150318", "2015-02-29",
    "2016-02-29", "  2015-03-18\t", "2015-03-18Tjunk",
    "2015-03-18T12:03:17.5Z", "2015-03-18 12:03:17 America/Los_Angeles",
    "", None, "2015-3-8 1:2:3.4+01:30:15", "2015-03-18 12:03:17 +0130",
    "0001-01-01 00:00:00", "9999-12-31 23:59:59.999999",
    "1582-10-04T23:59:59Z", "294247-01-10 04:00:54.775807"]
# Spark's justTime shapes: a leading 'T', or 1-2 digits then ':'
TIME_ONLY = re.compile(r"^[ \t\n\r\f\v]*(T|\d{1,2}:)")


def dt_strings():
    """The grammar table and byte edits of it, without time-only rows
    (their date is today's, which two calls may read on either side of
    midnight)."""
    rng = np.random.default_rng(41)
    out = DT_STRINGS + _mutate(rng, DT_STRINGS[:28],
                               list("0123456789-:. TZ+UTCGMz"), 2200)
    return _sized([s for s in out if s is None or not TIME_ONLY.match(s)])


def test_cast_to_date_matches_reference():
    ref, col = _strings(dt_strings())
    _same_fixed(cs.cast_to_date(col), ref_cs.cast_to_date(ref))


def _zones():
    return [z for z in ("UTC", "America/Los_Angeles", "Asia/Kolkata")
            if z == "UTC" or os.path.isfile(os.path.join(config.tzdir(), z))]


@pytest.mark.parametrize("zone", ["UTC", "America/Los_Angeles",
                                  "Asia/Kolkata"])
def test_cast_to_timestamp_matches_reference(zone):
    if zone not in _zones():
        pytest.skip(f"no TZif file for {zone}")
    ref, col = _strings(dt_strings())
    _same_fixed(cs.cast_to_timestamp(col, zone),
                ref_cs.cast_to_timestamp(ref, zone))


def test_cast_to_timestamp_time_only_rows_take_today():
    strs = ["12:30:00", "T12:30", "12:30:00+01:00", "1:2", "T1:02:03.5Z",
            "2015-03-18 12:03:17", "12:61"]
    ref, col = _strings(strs + dt_strings()[len(strs):])
    for _ in range(2):  # a second try if the two calls straddle midnight
        today = (pydt.datetime.now(pydt.timezone.utc).date() - EPOCH).days
        got = cs.cast_to_timestamp(col)
        want = ref_cs.cast_to_timestamp(ref)
        if (pydt.datetime.now(pydt.timezone.utc).date() - EPOCH).days \
                == today:
            break
    _same_fixed(got, want)
    base = today * 86_400_000_000
    assert got.to_pylist()[:4] == [
        base + (12 * 3600 + 30 * 60) * 10**6,
        base + (12 * 3600 + 30 * 60) * 10**6,
        base + (11 * 3600 + 30 * 60) * 10**6,
        base + (3600 + 2 * 60) * 10**6]
