"""Float -> string (Ryu) of the PyTorch/CUDA port against the JAX package
on the same numpy inputs (on the CPU), byte-equal: random float64 and
float32 bit patterns of every exponent (subnormals, NaN payloads and
infinities among them), values on every branch of Java's layout, and
the round trip through the port's ``cast_to_float`` against the
reference's.

Each width goes through the reference once (a module fixture over its
cases' rows laid end to end); each test reads its own case's rows.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as ref_types
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.ops.cast_strings import (
    cast_to_float as ref_cast_to_float)
from spark_rapids_jni_tpu.ops.float_to_string import (
    cast_float_to_string as ref_cast)

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops.cast_strings import cast_to_float
from spark_rapids_jni_tpu_torch.ops.float_to_string import (
    cast_float_to_string)

from test_torch_cast_strings import (_reference_model, _same_bits,
                                     _total_exp)

CPU = torch.device("cpu")

DOUBLES = [0.0, -0.0, 1.0, -1.5, 3.14159, 1e7, 9999999.0, 1e-3, 1e-4,
           123456789.0, 0.3, 1 / 3, 100.0, 12345.6789, 1e16, 1e15,
           7.2057594037927933e16, 2.2250738585072014e-308,
           1.7976931348623157e308, float("nan"), float("inf"),
           float("-inf"), 2.0 ** -1074, 1.23e-290, 9.87e305, 1e23,
           9007199254740993.0, 5e-324, -2.2250738585072009e-308]
FLOATS = [0.0, -0.0, 1.0, -1.5, 3.14159, 1e7, 9999999.0, 1e-3, 1e-4, 0.3,
          1 / 3, 1e38, 1.17549435e-38, 1.4e-45, np.nan, np.inf, -np.inf,
          3.4028235e38, 16777216.0]


def _bit_patterns(n, bits, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << bits, n, dtype=np.uint64)
    if bits == 64:
        return raw.view(np.float64)
    return raw.astype(np.uint32).view(np.float32)


def _layout_values():
    """1 to 17 digits at every scientific exponent from -20 to 20 and at
    the ends of the range, both signs: every branch of the layout (plain
    with and without a fraction, leading zeros, scientific with one or
    more fraction digits and one- to three-digit exponents)."""
    rng = np.random.default_rng(5)
    out = []
    for e in list(range(-20, 21)) + [-324, -310, -100, 99, 100, 308]:
        for nd in (1, 2, 4, 7, 9, 12, 16, 17):
            digits = int(rng.integers(10 ** (nd - 1), 10 ** nd))
            v = float(f"{digits}e{e - nd + 1}")
            out += [v, -v]
    return out + [-1.2345678901234567e-100]  # the 24-byte form


def _run(cases):
    """Both packages over the cases' rows laid end to end -> name ->
    (values, the port's strings, the reference's)."""
    vals = np.concatenate([v for v, _ in cases.values()])
    valid = np.concatenate([np.ones(len(v), bool) if ok is None else ok
                            for v, ok in cases.values()])
    got = cast_float_to_string(
        Column.from_numpy(vals, valid, device=CPU)).to_pylist()
    want = ref_cast(RefColumn.from_numpy(vals, valid)).to_pylist()
    out, start = {}, 0
    for name, (v, _) in cases.items():
        end = start + len(v)
        out[name] = (v, got[start:end], want[start:end])
        start = end
    return out


@pytest.fixture(scope="module")
def doubles():
    n = 12_000
    return _run({
        "curated": (np.array(DOUBLES), None),
        "random": (_bit_patterns(n, 64, 81),
                   np.random.default_rng(64).random(n) > 0.05),
        "layout": (np.array(_layout_values()), None),
        "nulls": (np.array([1.5, 2.5]), np.array([True, False]))})


@pytest.fixture(scope="module")
def floats():
    n = 8_000
    return _run({
        "curated": (np.array(FLOATS, np.float32), None),
        "random": (_bit_patterns(n, 32, 49),
                   np.random.default_rng(32).random(n) > 0.05)})


def _same(case):
    vals, got, want = case
    bad = [(i, float(vals[i]), a, b)
           for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not bad, bad[:10]
    return got


def test_double_curated(doubles):
    _same(doubles["curated"])


def test_float_curated(floats):
    _same(floats["curated"])


def test_double_random_bit_patterns(doubles):
    _same(doubles["random"])


def test_float_random_bit_patterns(floats):
    _same(floats["random"])


def test_every_layout_branch_matches_host_loop(doubles):
    # the device assembly against the reference's per-row host loop
    got = _same(doubles["layout"])
    assert {len(s) for s in got} >= set(range(3, 25))


def test_null_passthrough(doubles):
    assert _same(doubles["nulls"]) == ["1.5", None]


@pytest.mark.parametrize("bits", [64, 32], ids=["float64", "float32"])
def test_round_trip_through_cast_to_float(bits):
    """The port's strings back through the port's cast_to_float equal the
    reference's cast_to_float of the same strings bit for bit, and the
    Python model of its arithmetic where the reference flushed a
    subnormal; exact where that arithmetic is (a mantissa below 2^53
    times an exact power of ten, 10^0 to 10^22)."""
    vals = _bit_patterns(4000, bits, bits)
    dt = T.FLOAT64 if bits == 64 else T.FLOAT32
    s = cast_float_to_string(Column.from_numpy(vals, device=CPU))
    strs = s.to_pylist()
    back = cast_to_float(s, dt).data.numpy()
    want = np.asarray(ref_cast_to_float(RefColumn.strings_from_list(strs),
                                        getattr(ref_types, dt.id.name)).data)
    with np.errstate(over="ignore"):
        model = np.array([_reference_model(x) for x in strs]).astype(
            back.dtype)
    assert _same_bits(back, model).all()
    flushed = (want == 0) & (back != 0)
    assert _same_bits(back, want)[~flushed].all()
    # the reference read 0.0: a subnormal power of ten, or for FLOAT32 a
    # subnormal float32
    if bits == 64:
        assert all(-323 <= _total_exp(x) <= -308
                   for x, f in zip(strs, flushed) if f)
    else:
        assert (np.abs(back[flushed]) < np.finfo(np.float32).tiny).all()
    exact = np.array([_exact_path(x) for x in strs])
    assert exact.sum() > 50
    assert _same_bits(back, vals)[exact].all()


def _exact_path(s):
    """True where the reference's arithmetic rounds once: digits below
    2^53 times 10^0 to 10^22 (both exact doubles)."""
    if s[-1:].isalpha():
        return False  # NaN, Infinity
    mant, _, exp = s.lstrip("-").partition("E")
    ints, _, frac = mant.partition(".")
    e = int(exp or 0) - len(frac)
    return int(ints + frac) <= 2 ** 53 and 0 <= e <= 22
