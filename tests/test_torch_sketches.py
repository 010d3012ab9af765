"""Bloom filter and HLL++ sketches of the PyTorch/CUDA port against the JAX
package on the same numpy inputs (on the CPU).

Filter words, probe results, packed sketch words and group keys are
byte-equal to the reference's; estimates are equal as the int64s both
return (the float estimate before rounding agrees to 1e-12 relative).
The int64-lane clz and logical shift that stand in for unsigned 64-bit
arithmetic are held against Python ints on every bit position, and the
sketch registers against a Python model of them over the scalar
XXH64 oracle (``reference_hashes.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_hashes import spark_xxhash_long, xxh64
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.ops import bloom_filter as ref_bloom
from spark_rapids_jni_tpu.ops import hllpp as ref_hllpp

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import bloom_filter, hllpp

CPU = torch.device("cpu")
M64 = (1 << 64) - 1


def _pair(values, valid=None):
    return (RefColumn.from_numpy(values, valid),
            Column.from_numpy(values, valid, device=CPU))


def _strings(n, rng):
    vals = [None if rng.random() < 0.1 else f"user-{int(rng.integers(700))}"
            * int(rng.integers(1, 4)) for _ in range(n)]
    return RefColumn.strings_from_list(vals), \
        Column.strings_from_list(vals, device=CPU)


# --------------------------------------------------------------------------
# bloom filter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_bits,num_hashes", [(1 << 16, 6), (96, 1)])
@pytest.mark.parametrize("kind", ["int64", "int32", "string"])
def test_bloom_words_and_probe_equal_reference(num_bits, num_hashes, kind):
    rng = np.random.default_rng(num_bits + num_hashes)
    n = 3000
    if kind == "string":
        ref, got = _strings(n, rng)
        pref, pgot = _strings(n, rng)
    else:
        dt = np.int64 if kind == "int64" else np.int32
        hi = 2**62 if kind == "int64" else 2**31 - 1
        valid = rng.random(n) > 0.1
        ref, got = _pair(rng.integers(-hi, hi, n).astype(dt), valid)
        pref, pgot = _pair(rng.integers(-hi, hi, n).astype(dt),
                           rng.random(n) > 0.1)
    want = np.asarray(ref_bloom.build(ref, num_bits, num_hashes))
    words = bloom_filter.build(got, num_bits, num_hashes)
    assert words.dtype == torch.uint32 and words.shape == (num_bits // 32,)
    np.testing.assert_array_equal(words.numpy(), want)
    for r, g in ((ref, got), (pref, pgot)):
        np.testing.assert_array_equal(
            bloom_filter.probe(words, g, num_hashes).numpy(),
            np.asarray(ref_bloom.probe(jnp.asarray(want), r, num_hashes)))


def test_bloom_positions_wrap_like_the_reference():
    # keys whose hashes have the top bit set: h2 near 2^32 and the
    # largest k keep h1 + i * h2 positive; both fold and take mod alike
    rng = np.random.default_rng(3)
    keys = rng.integers(-2**63, 2**63 - 1, 20_000, dtype=np.int64)
    ref, got = _pair(keys)
    want = np.asarray(ref_bloom._positions(ref, 8_388_608, 6))
    np.testing.assert_array_equal(
        bloom_filter._positions(got, 8_388_608, 6).numpy(), want)


def test_bloom_no_false_negatives_and_few_false_positives():
    rng = np.random.default_rng(31)
    present = rng.integers(0, 2**40, 2000, dtype=np.int64)
    absent = rng.integers(2**41, 2**42, 2000, dtype=np.int64)
    f = bloom_filter.build(Column.from_numpy(present, device=CPU), 1 << 18)
    assert bloom_filter.probe(
        f, Column.from_numpy(present, device=CPU)).all()
    hits = bloom_filter.probe(f, Column.from_numpy(absent, device=CPU))
    assert hits.float().mean() < 0.05


def test_bloom_nulls_and_merge_equal_reference():
    a = (np.array([1, 2, 0], np.int64), np.array([True, True, False]))
    b = (np.array([100, 200], np.int64), None)
    ra, ga = _pair(*a)
    rb, gb = _pair(*b)
    fa, fb = bloom_filter.build(ga, 1 << 12), bloom_filter.build(gb, 1 << 12)
    merged = bloom_filter.merge([fa, fb])
    want = ref_bloom.merge([ref_bloom.build(ra, 1 << 12),
                            ref_bloom.build(rb, 1 << 12)])
    assert merged.dtype == torch.uint32
    np.testing.assert_array_equal(merged.numpy(), np.asarray(want))
    _, probe = _pair(np.array([1, 100, 0], np.int64),
                     np.array([True, True, False]))
    assert bloom_filter.probe(merged, probe).tolist() == [True, True, False]


# --------------------------------------------------------------------------
# HLL++: the 64-bit lane arithmetic
# --------------------------------------------------------------------------

def _as_i64(u):
    return u - (1 << 64) if u >= (1 << 63) else u


def _bit_cases():
    rng = np.random.default_rng(8)
    vals = []
    for b in range(64):  # every top-bit position, alone and with noise
        noise = int(rng.integers(0, 2**62)) & ((1 << b) - 1)
        vals += [1 << b, (1 << b) | noise]
    return vals


def test_clz64_on_every_bit_position():
    vals = _bit_cases()
    x = torch.tensor([_as_i64(v) for v in vals], dtype=torch.int64)
    want = [64 - v.bit_length() for v in vals]
    assert hllpp.clz64(x).tolist() == want


@pytest.mark.parametrize("r", [0, 1, 9, 32, 55, 60, 63])
def test_lsr64_equals_python(r):
    vals = _bit_cases() + [M64, 1 << 63, 0]
    x = torch.tensor([_as_i64(v) for v in vals], dtype=torch.int64)
    assert hllpp.lsr64(x, r).tolist() == [_as_i64(v >> r) for v in vals]


def _oracle_registers(hashes_u64, p):
    regs = np.zeros(1 << p, np.int64)
    for h in hashes_u64:
        w = ((h << p) & M64) | (1 << (p - 1))
        regs[h >> (64 - p)] = max(regs[h >> (64 - p)],
                                  64 - w.bit_length() + 1)
    return regs


def test_registers_match_oracle():
    vals = np.random.default_rng(0).integers(-10**9, 10**9, 3000, np.int64)
    for p in (4, 9, 12):
        sk = hllpp.reduce(Column.from_numpy(vals, device=CPU), p)
        want = _oracle_registers(
            [spark_xxhash_long(int(v), 42) & M64 for v in vals], p)
        np.testing.assert_array_equal(hllpp._unpack(sk, p).numpy(), want)
    strs = [f"user-{i % 700}" for i in range(2000)]
    sk = hllpp.reduce(Column.strings_from_list(strs, device=CPU), 9)
    np.testing.assert_array_equal(
        hllpp._unpack(sk, 9).numpy(),
        _oracle_registers([xxh64(s.encode(), 42) for s in strs], 9))


# --------------------------------------------------------------------------
# HLL++: sketches and estimates against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [4, 9, 18])
def test_reduce_and_estimate_equal_reference(p):
    rng = np.random.default_rng(p)
    for n in (0, 3000):
        vals = rng.integers(0, 3 * n + 1, n, dtype=np.int64)
        valid = rng.random(n) > 0.1
        ref, got = _pair(vals, valid)
        want = np.asarray(ref_hllpp.reduce(ref, p))
        sk = hllpp.reduce(got, p)
        assert sk.dtype == torch.int64 and sk.shape == (hllpp.num_words(p),)
        np.testing.assert_array_equal(sk.numpy(), want)
        assert int(hllpp.estimate(sk, p)) == \
            int(ref_hllpp.estimate(jnp.asarray(want), p))


def test_packed_layout_is_sparks():
    regs = torch.arange(1, 17, dtype=torch.int64)
    words = hllpp._pack(regs).tolist()
    for j in range(16):
        assert (words[j // 10] >> (6 * (j % 10))) & 0x3F == j + 1
    np.testing.assert_array_equal(
        hllpp._pack(regs).numpy(),
        np.asarray(ref_hllpp._pack(jnp.arange(1, 17, dtype=jnp.int32))))


def test_nulls_do_not_touch_sketch():
    vals = np.arange(100, dtype=np.int64)
    valid = np.ones(100, bool)
    valid[::3] = False
    with_nulls = hllpp.reduce(Column.from_numpy(vals, valid, device=CPU), 9)
    dense = hllpp.reduce(Column.from_numpy(vals[valid], device=CPU), 9)
    assert torch.equal(with_nulls, dense)


def test_merge_equals_reference_and_is_union():
    a = np.arange(0, 3000, dtype=np.int64)
    b = np.arange(2000, 6000, dtype=np.int64)
    ra, ga = _pair(a)
    rb, gb = _pair(b)
    merged = hllpp.merge([hllpp.reduce(ga, 9), hllpp.reduce(gb, 9)], 9)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(ref_hllpp.merge(
        [ref_hllpp.reduce(ra, 9), ref_hllpp.reduce(rb, 9)], 9)))
    union = hllpp.reduce(Column.from_numpy(np.concatenate([a, b]),
                                           device=CPU), 9)
    assert torch.equal(merged, union)


@pytest.mark.parametrize("key_nulls", [False, True])
def test_groupby_reduce_and_estimate_column_equal_reference(key_nulls):
    rng = np.random.default_rng(1 + key_nulls)
    n = 3000
    keys = rng.integers(0, 12, n, np.int64)
    kv = rng.random(n) > 0.1 if key_nulls else None
    vals = rng.integers(0, 50 * (keys + 1), n, np.int64)
    vv = rng.random(n) > 0.05
    p = 9
    rk, gk = _pair(keys, kv)
    rv, gv = _pair(vals, vv)
    keys_out, sketches = hllpp.groupby_reduce(Table([gk]), gv, p)
    ref_keys, ref_sk = ref_hllpp.groupby_reduce(RefTable([rk]), rv, p)
    assert keys_out.columns[0].to_pylist() == ref_keys.columns[0].to_pylist()
    np.testing.assert_array_equal(sketches.numpy(), np.asarray(ref_sk))
    est = hllpp.estimate_column(sketches, p)
    want = ref_hllpp.estimate_column(ref_sk, p)
    assert est.to_pylist() == want.to_pylist()
    for gi, k in enumerate(keys_out.columns[0].to_pylist()):
        in_group = ~kv if k is None else (keys == k) & (
            kv if kv is not None else True)
        sel = in_group & vv
        true = len(set(vals[sel].tolist()))
        assert abs(est.to_pylist()[gi] - true) <= 0.2 * true + 2


def _ref_raw_estimate(words, p):
    """The reference's ``estimate`` before it rounds: its body, on its
    own helpers."""
    regs = ref_hllpp._unpack(jnp.asarray(words), p)
    m, q = 1 << p, 64 - p
    hist = [jnp.sum(regs == k, axis=-1).astype(jnp.float64)
            for k in range(q + 2)]
    z = (m * ref_hllpp._sigma(hist[0] / m)
         + sum(hist[k] * (2.0 ** -k) for k in range(1, q + 1))
         + m * ref_hllpp._tau(1.0 - hist[q + 1] / m) * (2.0 ** -q))
    return np.asarray(1.0 / (2.0 * math.log(2.0)) * m * m / z)


@pytest.mark.parametrize("n", [25, 700, 50_000])
def test_estimate_before_rounding_agrees(n):
    vals = np.arange(n, dtype=np.int64) * 7919
    p = 11
    sk = hllpp.reduce(Column.from_numpy(vals, device=CPU), p)
    raw = hllpp.raw_estimate(sk, p).item()
    np.testing.assert_allclose(raw, _ref_raw_estimate(sk.numpy(), p),
                               rtol=1e-12)
    assert abs(raw - n) / n < 4 * 1.04 / math.sqrt(1 << p)


def test_precision_and_sizes_equal_reference():
    for rsd in (0.05, 0.01, 0.2, 0.3):
        assert hllpp.precision_for_rsd(rsd) == ref_hllpp.precision_for_rsd(rsd)
    for p in range(4, 19):
        assert hllpp.num_words(p) == ref_hllpp.num_words(p)
    assert hllpp.precision_for_rsd(0.05) == 9  # Spark's default
