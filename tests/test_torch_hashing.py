"""Spark hashing of the PyTorch/CUDA port against the JAX package.

The same numpy columns (values, validity, STRING offsets and chars,
DECIMAL128 [lo, hi] words) reach both packages: the reference through
its column constructors, the port through ``carry.table_from_arrays``.
Murmur3 (K4 and K5 on their plain versions here), XXHash64 and HiveHash
of every supported type, with nulls, empty strings and DECIMAL128 values
whose ``BigInteger.toByteArray`` is 1-16 bytes long, and the row hashes
over mixed tables, must equal the reference exactly.

Three kinds of rows are held against the scalar oracles of
``tests/reference_hashes.py`` instead, because there the reference's CPU
route departs from Spark and the port follows Spark:

- float64 NaNs with a payload other than the canonical one: the
  reference hashes their raw bits, Spark's ``doubleToLongBits`` the
  canonical NaN;
- float32 subnormals: XLA on the CPU flushes them to zero, so the
  reference hashes them as 0.0; Java keeps their bits;
- the timestamp -2^63 us under HiveHash: the reference negates it
  before dividing, which overflows; Java's truncating division does not.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.columnar.column import _pack_host
from spark_rapids_jni_tpu.ops import hashing as ref_hashing
from spark_rapids_jni_tpu.ops import hive_hash as ref_hive
from spark_rapids_jni_tpu.types import DType as RefDType
from spark_rapids_jni_tpu.types import TypeId as RefTypeId

from spark_rapids_jni_tpu_torch.obs import kernel_stats, stats_since
from spark_rapids_jni_tpu_torch.ops import cuda_kernels as K
from spark_rapids_jni_tpu_torch.ops import hashing, hive_hash
from spark_rapids_jni_tpu_torch.tpcds.carry import table_from_arrays
from spark_rapids_jni_tpu_torch.types import DType, TypeId
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

from reference_hashes import (hive_hash_double, hive_hash_float,
                              hive_hash_long, hive_hash_string,
                              hive_hash_timestamp_us, murmur3_32,
                              spark_hash_int, spark_hash_long,
                              spark_xxhash_int, spark_xxhash_long, xxh64)

FIXED = [t for t in TypeId if DType(t).is_fixed_width
         and t != TypeId.DECIMAL128]
HIVE = {TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.UINT8,
        TypeId.UINT16, TypeId.UINT32, TypeId.TIMESTAMP_DAYS, TypeId.BOOL8,
        TypeId.FLOAT32, TypeId.FLOAT64, TypeId.INT64, TypeId.UINT64,
        TypeId.TIMESTAMP_MICROSECONDS, TypeId.STRING}
_SCALE = {TypeId.DECIMAL32: -3, TypeId.DECIMAL64: -8, TypeId.DECIMAL128: -2}


def _values(rng, tid, n):
    """n values of type ``tid`` in its storage dtype, extremes included."""
    st = DType(tid).storage_dtype
    if tid == TypeId.BOOL8:
        return rng.integers(0, 2, n).astype(np.int8)
    if st.kind == "f":
        v = (rng.standard_normal(n) * 1e3).astype(st)
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40,
                            -1e-42], dtype=st)[:n]
        v[:special.shape[0]] = special
        return v
    info = np.iinfo(st)
    v = rng.integers(info.min, info.max, n, dtype=st, endpoint=True)
    v[:3] = [info.min, info.max, 0][:n]
    return v


def _spark_only_rows(tid, data, hive: bool) -> np.ndarray:
    """Rows where the reference's CPU route departs from Spark."""
    if tid == TypeId.FLOAT32:
        return (data != 0) & (np.abs(data) < np.finfo(np.float32).tiny)
    if hive and tid == TypeId.TIMESTAMP_MICROSECONDS:
        return data == np.iinfo(np.int64).min
    return np.zeros(data.shape[0], bool)


def _spark_oracle(tid, value, seed, kind):
    """Spark's hash of one float32 or timestamp value (``kind`` murmur3,
    xxhash64 or hive)."""
    if tid == TypeId.TIMESTAMP_MICROSECONDS:
        return hive_hash_timestamp_us(int(value))
    bits = int(np.float32(value).view(np.uint32))
    return {"murmur3": lambda: spark_hash_int(bits, seed),
            "xxhash64": lambda: spark_xxhash_int(bits, seed),
            "hive": lambda: hive_hash_float(float(value))}[kind]()


def _decimal128_values():
    """Unscaled values whose toByteArray takes every length 1..16."""
    vals = [0, 1, -1, 255, 256, -256]
    for length in range(1, 17):
        top = 1 << (8 * length - 1)
        vals += [top - 1, -top, top // 3, -(top // 3) - 1]
    return vals


def _strings(rng, n):
    """STRING offsets and chars: empty strings, ASCII, multi-byte UTF-8,
    lengths 0-45 (past one 32-byte XXH64 stripe)."""
    alphabet = ["a", "Z", "0", " ", "é", "ü", "€", "字", "🙂"]
    strs = ["", "a", "hello world", "x" * 32, "y" * 45]
    while len(strs) < n:
        k = int(rng.integers(0, 16))
        strs.append("".join(rng.choice(alphabet, k)))
    bufs = [s.encode("utf-8") for s in strs[:n]]
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    return offsets, np.frombuffer(b"".join(bufs), np.uint8).copy()


def _column_arrays(rng, tid, n):
    """(type id, scale), data, valid: the host arrays of one column."""
    valid = rng.random(n) > 0.15
    if tid == TypeId.STRING:
        offsets, chars = _strings(rng, n)
        # a null holds no bytes, as strings_from_list builds it
        lens = np.where(valid, np.diff(offsets), 0)
        keep = np.repeat(valid, np.diff(offsets))
        new_offs = np.zeros(n + 1, np.int32)
        np.cumsum(lens, out=new_offs[1:])
        return (int(tid), 0), (new_offs, chars[keep]), valid
    if tid == TypeId.DECIMAL128:
        vals = _decimal128_values()
        vals = [vals[i % len(vals)] for i in range(n)]
        u = [v & ((1 << 128) - 1) for v in vals]
        words = np.array([[x & (2**64 - 1), x >> 64] for x in u],
                         np.uint64).reshape(n, 2)
        return (int(tid), _SCALE[tid]), words, valid
    return (int(tid), _SCALE.get(tid, 0)), _values(rng, tid, n), valid


def _ref_column(dtype, data, valid):
    tid, scale = dtype
    rdt = RefDType(RefTypeId(tid), scale)
    vwords = None if valid.all() else jnp.asarray(_pack_host(valid))
    if tid == TypeId.STRING:
        offsets, chars = data
        n = offsets.shape[0] - 1
        return RefColumn(rdt, n, None, vwords, children=(
            RefColumn(RefDType(RefTypeId.INT32), n + 1,
                      jnp.asarray(offsets)),
            RefColumn(RefDType(RefTypeId.UINT8), chars.shape[0],
                      jnp.asarray(chars))))
    if tid == TypeId.DECIMAL128:
        return RefColumn(rdt, data.shape[0], jnp.asarray(data), vwords)
    return RefColumn.from_numpy(data, valid, rdt)


def _both(arrays):
    """(reference Table, port Table) of the same host arrays."""
    dtypes, datas, valids = zip(*arrays)
    ref = RefTable([_ref_column(*a) for a in arrays])
    return ref, table_from_arrays(dtypes, datas, valids, device="cpu")


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == {np.dtype(np.int32): torch.int32,
                         np.dtype(np.int64): torch.int64}[want.dtype]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tid", FIXED + [TypeId.DECIMAL128, TypeId.STRING],
                         ids=lambda t: t.name)
def test_column_hashes_equal_reference(tid):
    rng = np.random.default_rng(int(tid))
    n = 300
    ref, got = _both([_column_arrays(rng, tid, n)])
    rc, pc = ref.columns[0], got.columns[0]
    running = rng.integers(-2**31, 2**31, n, dtype=np.int32)
    data, valid = (pc.data.numpy() if pc.data is not None
                   else np.zeros(n)), pc.valid_bool().numpy()

    def check(kind, got_h, want_h, seed):
        got_h, want_h = got_h.numpy(), np.asarray(want_h)
        assert got_h.dtype == want_h.dtype
        spark = _spark_only_rows(tid, data, kind == "hive") & valid
        np.testing.assert_array_equal(got_h[~spark], want_h[~spark])
        for i in np.flatnonzero(spark):
            s_i = seed if seed is None or np.isscalar(seed) else int(seed[i])
            assert got_h[i] == _spark_oracle(tid, data[i], s_i, kind), i
    check("murmur3", hashing.murmur3_column(pc),
          ref_hashing.murmur3_column(rc), 42)
    h = hashing.murmur3_column(pc, running=torch.from_numpy(running))
    np.testing.assert_array_equal(h.numpy()[~valid], running[~valid])
    check("murmur3", h, ref_hashing.murmur3_column(
        rc, running=jnp.asarray(running)), running)
    check("xxhash64", hashing.xxhash64_column(pc, seed=7),
          ref_hashing.xxhash64_column(rc, seed=7), 7)
    if tid in HIVE:
        check("hive", hive_hash.hive_hash_column(pc),
              ref_hive.hive_hash_column(rc), None)
    else:
        with pytest.raises(Exception):
            ref_hive.hive_hash_column(rc)
        with pytest.raises(CudfLikeError, match="hive_hash"):
            hive_hash.hive_hash_column(pc)


def _to_signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _java_bits(value) -> int:
    """floatToIntBits / doubleToLongBits, -0.0 as 0.0, NaN canonical."""
    if np.isnan(value):
        return 0x7FC00000 if value.dtype == np.float32 else 0x7FF8000000000000
    value = value.dtype.type(0) if value == 0 else value
    return int(value.view(np.uint32 if value.dtype == np.float32
                          else np.uint64))


def _spark_row_hash(kind, arrays, i):
    """Spark's row hash of row ``i`` (``kind`` murmur3, xxhash64 or hive),
    chained value by value through the scalar oracles."""
    h = {"murmur3": 42, "xxhash64": 42, "hive": 0}[kind]
    for (tid, _), data, valid in arrays:
        if tid == TypeId.STRING:
            offsets, chars = data
            blob = bytes(chars[offsets[i]:offsets[i + 1]])
        elif tid == TypeId.DECIMAL128:
            lo, hi = (int(x) for x in data[i])
            v = _to_signed(lo | hi << 64, 128)
            blob = v.to_bytes((v if v >= 0 else ~v).bit_length() // 8 + 1,
                              "big", signed=True)  # BigInteger.toByteArray
        elif tid in (TypeId.FLOAT32, TypeId.FLOAT64):
            bits = _java_bits(data[i])
        else:
            bits = int(data[i])
        if kind == "hive":
            ch = 0
            if valid[i]:
                ch = {TypeId.STRING: lambda: hive_hash_string(blob),
                      TypeId.INT64: lambda: hive_hash_long(bits),
                      TypeId.FLOAT32: lambda: hive_hash_float(data[i]),
                      TypeId.FLOAT64: lambda: hive_hash_double(data[i]),
                      }.get(tid, lambda: bits)()
            h = _to_signed(31 * h + ch, 32)
        elif valid[i]:
            wide = tid in (TypeId.INT64, TypeId.FLOAT64, TypeId.DECIMAL64)
            if kind == "murmur3":
                h = _to_signed(murmur3_32(blob, h), 32) if tid in (
                    TypeId.STRING, TypeId.DECIMAL128) else (
                    spark_hash_long if wide else spark_hash_int)(bits, h)
            else:
                h = _to_signed(xxh64(blob, h & (2**64 - 1)), 64) if tid in (
                    TypeId.STRING, TypeId.DECIMAL128) else (
                    spark_xxhash_long if wide else spark_xxhash_int)(bits, h)
    return h


def test_row_hashes_equal_reference():
    rng = np.random.default_rng(5)
    n = 2000
    tids = [TypeId.INT32, TypeId.INT64, TypeId.FLOAT64, TypeId.FLOAT32,
            TypeId.BOOL8, TypeId.TIMESTAMP_DAYS, TypeId.DECIMAL64,
            TypeId.DECIMAL128, TypeId.STRING]
    arrays = [_column_arrays(rng, t, n) for t in tids]
    ref, got = _both(arrays)
    # float32 subnormals: Spark's hash, not the reference's (see above);
    # those rows are held to the scalar oracles chained through the row
    keep = ~_spark_only_rows(TypeId.FLOAT32, arrays[3][1], False)
    spark_rows = np.flatnonzero(~keep)
    assert spark_rows.size
    for kind, fn, rfn in (
            ("murmur3", hashing.murmur3_table, ref_hashing.murmur3_table),
            ("xxhash64", hashing.xxhash64_table, ref_hashing.xxhash64_table)):
        got_h, want_h = fn(got).numpy(), np.asarray(rfn(ref))
        assert got_h.dtype == want_h.dtype
        np.testing.assert_array_equal(got_h[keep], want_h[keep])
        for i in spark_rows:
            assert got_h[i] == _spark_row_hash(kind, arrays, i), (kind, i)
    hive_cols = [i for i, t in enumerate(tids) if t in HIVE]
    got_h = hive_hash.hive_hash_table(type(got)(
        [got.columns[i] for i in hive_cols])).numpy()
    want_h = np.asarray(ref_hive.hive_hash_table(
        RefTable([ref.columns[i] for i in hive_cols])))
    np.testing.assert_array_equal(got_h[keep], want_h[keep])
    for i in spark_rows:
        assert got_h[i] == _spark_row_hash(
            "hive", [arrays[c] for c in hive_cols], i), ("hive", i)


def test_murmur3_routes_through_k4_and_k5():
    """Each single-block column is one K4 call, each long or double
    column one K5 call; DECIMAL128 and STRING columns call neither."""
    rng = np.random.default_rng(6)
    tids = [TypeId.INT32, TypeId.INT64, TypeId.FLOAT64, TypeId.FLOAT32,
            TypeId.BOOL8, TypeId.TIMESTAMP_DAYS, TypeId.DECIMAL64,
            TypeId.DECIMAL128, TypeId.STRING]
    _, got = _both([_column_arrays(rng, t, 64) for t in tids])
    calls = []
    real = {name: getattr(K, name) for name in ("murmur3_int32",
                                                 "murmur3_int64")}

    def recorder(name):
        def record(*args):
            calls.append(name)
            return real[name](*args)
        return record
    try:
        for name in real:
            setattr(K, name, recorder(name))
        hashing.murmur3_table(got)
    finally:
        for name, fn in real.items():
            setattr(K, name, fn)
    assert sorted(calls) == ["murmur3_int32"] * 4 + ["murmur3_int64"] * 3


def test_float64_nan_payloads_hash_as_canonical_nan():
    # 0x7ff8... (the canonical NaN), 0xfff8... (its negative) and a
    # signalling payload: Spark's doubleToLongBits maps all three to
    # 0x7ff8000000000000; so does the port, on every device
    bits = np.array([0x7FF8000000000000, 0xFFF8000000000000,
                     0x7FF0000000000001, 0x7FFFFFFFFFFFFFFF], np.uint64)
    vals = bits.view(np.float64)
    assert np.isnan(vals).all()
    t = table_from_arrays([(int(TypeId.FLOAT64), 0)], [vals], [None],
                          device="cpu")
    col = t.columns[0]
    m = hashing.murmur3_column(col).numpy()
    x = hashing.xxhash64_column(col).numpy()
    h = hive_hash.hive_hash_column(col).numpy()
    canonical = 0x7FF8000000000000
    assert (m == spark_hash_long(canonical, 42)).all()
    assert (x == spark_xxhash_long(canonical, 42)).all()
    assert (h == hive_hash_double(float("nan"))).all()
    # float32 NaNs are canonical in both packages
    f32 = np.array([0x7FC00000, 0xFFC00000, 0x7F800001], np.uint32) \
        .view(np.float32)
    ref, got = _both([((int(TypeId.FLOAT32), 0), f32, np.ones(3, bool))])
    for fn, rfn in ((hashing.murmur3_column, ref_hashing.murmur3_column),
                    (hashing.xxhash64_column, ref_hashing.xxhash64_column),
                    (hive_hash.hive_hash_column, ref_hive.hive_hash_column)):
        out = fn(got.columns[0]).numpy()
        _eq(fn(got.columns[0]), rfn(ref.columns[0]))
        assert (out == out[0]).all()


def test_decimal128_byte_lengths_cover_1_to_16():
    vals = _decimal128_values()
    t = table_from_arrays(
        [(int(TypeId.DECIMAL128), 0)],
        [np.array([[v & (2**64 - 1), (v & (2**128 - 1)) >> 64]
                   for v in vals], np.uint64)], [None], device="cpu")
    _, lens = hashing.decimal128_be_bytes(t.columns[0])
    want = [v.bit_length() // 8 + 1 if v >= 0 else (~v).bit_length() // 8 + 1
            for v in vals]  # BigInteger.toByteArray().length
    np.testing.assert_array_equal(lens.numpy(), want)
    assert set(want) == set(range(1, 17))


def test_empty_and_all_null_columns():
    for tid in (TypeId.INT32, TypeId.INT64, TypeId.STRING,
                TypeId.DECIMAL128):
        rng = np.random.default_rng(1)
        arrays = [_column_arrays(rng, tid, 0)]
        ref, got = _both(arrays)
        assert hashing.murmur3_table(got).shape == (0,)
        assert hashing.xxhash64_table(got).shape == (0,)
        nulls = [_column_arrays(rng, tid, 40)]
        nulls = [(d, data, np.zeros(40, bool)) for d, data, _ in nulls]
        ref, got = _both(nulls)
        _eq(hashing.murmur3_table(got), ref_hashing.murmur3_table(ref))
        assert (hashing.murmur3_table(got).numpy() == 42).all()


def test_hashing_rejects_unsupported_and_counts_no_launch_on_cpu():
    from spark_rapids_jni_tpu_torch.columnar import Column
    lst = Column.list_of_int8(torch.zeros(4, dtype=torch.int8),
                              torch.tensor([0, 2, 4], dtype=torch.int32))
    with pytest.raises(CudfLikeError, match="murmur3"):
        hashing.murmur3_column(lst)
    with pytest.raises(CudfLikeError, match="xxhash64"):
        hashing.xxhash64_column(lst)
    before, launches = kernel_stats(), dict(K.LAUNCHES)
    rng = np.random.default_rng(2)
    _, got = _both([_column_arrays(rng, TypeId.INT64, 50)])
    hashing.murmur3_table(got)
    assert dict(K.LAUNCHES) == launches
    assert not stats_since(before)


def test_string_byte_matrix_helpers_equal_reference():
    from spark_rapids_jni_tpu.columnar import strings as ref_strings
    from spark_rapids_jni_tpu_torch.columnar import strings
    rng = np.random.default_rng(8)
    arrays = [_column_arrays(rng, TypeId.STRING, 200)]
    ref, got = _both(arrays)
    rc, pc = ref.columns[0], got.columns[0]
    assert strings.max_length(pc) == ref_strings.max_length(rc)
    for width in (0, 5, strings.max_length(pc)):
        mat, lens = strings.byte_matrix(pc, width)
        rmat, rlens = ref_strings.byte_matrix(rc, width)
        np.testing.assert_array_equal(mat.numpy(), np.asarray(rmat))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(rlens))
    valid = arrays[0][2]
    back = strings.from_byte_matrix(mat.numpy(), lens.numpy(), valid,
                                    device="cpu")
    assert back.to_pylist() == ref_strings.from_byte_matrix(
        np.asarray(rmat), np.asarray(rlens), valid).to_pylist()
