"""ZOrder (interleave_bits, hilbert_index) of the PyTorch/CUDA port against
the JAX package on the same numpy inputs (on the CPU).

Mirrors ``test_zorder_conv.py``'s z-order cases (its ``conv`` cases are
``test_torch_cast_strings.py``'s): Delta's InterleaveBits bit walk and
Skilling's scalar Hilbert transform as oracles, and the curve's own
properties (a bijection with unit steps). Then every input type at
k = 1-4 columns with nulls, and num_bits 1-32, against the reference:
bytes and indices equal.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as RT
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.columnar import Table as RefTable
from spark_rapids_jni_tpu.ops import zorder as ref_zorder

from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.ops import zorder
from spark_rapids_jni_tpu_torch.utils.errors import CudfLikeError

CPU = torch.device("cpu")


def _col(values, valid=None, dtype=None):
    return Column.from_numpy(values, valid, dtype, device=CPU)


def _interleave_oracle(vals):
    """Delta InterleaveBits: bit t of the output stream (MSB-first) is bit
    t // k (from MSB) of column t % k."""
    k = len(vals)
    out = bytearray(4 * k)
    bit = 0
    for i in range(32):
        for j in range(k):
            b = (int(vals[j]) >> (31 - i)) & 1
            out[bit >> 3] |= b << (7 - (bit & 7))
            bit += 1
    return bytes(out)


def _binary_rows(col):
    offs = col.offsets.data.numpy()
    chars = col.child.data.numpy().astype(np.uint8).tobytes()
    return [chars[offs[i]:offs[i + 1]] for i in range(col.size)]


def test_interleave_bits_matches_oracle():
    rng = np.random.default_rng(5)
    for k in (1, 2, 3, 5):
        cols = [rng.integers(-2**31, 2**31, 50).astype(np.int32)
                for _ in range(k)]
        out = zorder.interleave_bits(Table([_col(c) for c in cols]))
        rows = _binary_rows(out)
        for r in range(50):
            exp = _interleave_oracle([np.uint32(cols[j][r])
                                      for j in range(k)])
            assert rows[r] == exp, (k, r)


def test_interleave_bits_null_is_zero():
    a = _col(np.array([7, 7], np.int32), np.array([True, False]))
    b = _col(np.array([3, 3], np.int32))
    rows = _binary_rows(zorder.interleave_bits(Table([a, b])))
    assert rows[1] == _interleave_oracle([np.uint32(0), np.uint32(3)])
    assert rows[0] == _interleave_oracle([np.uint32(7), np.uint32(3)])


def test_interleave_bits_orders_like_z_curve():
    xs, ys = np.meshgrid(np.arange(4, dtype=np.int32),
                         np.arange(4, dtype=np.int32))
    t = Table([_col(xs.ravel()), _col(ys.ravel())])
    keys = [int.from_bytes(r, "big")
            for r in _binary_rows(zorder.interleave_bits(t))]
    order = np.argsort(keys, kind="stable")
    morton = sorted(range(16), key=lambda i: _interleave_oracle(
        [np.uint32(xs.ravel()[i]), np.uint32(ys.ravel()[i])]))
    assert order.tolist() == morton


def _hilbert_oracle(coords, nbits):
    x = [int(c) for c in coords]
    k = len(x)
    q = 1 << (nbits - 1)
    while q > 1:
        p = q - 1
        for i in range(k):
            if x[i] & q:
                x[0] ^= p
            else:
                t = (x[0] ^ x[i]) & p
                x[0] ^= t
                x[i] ^= t
        q >>= 1
    for i in range(1, k):
        x[i] ^= x[i - 1]
    t = 0
    q = 1 << (nbits - 1)
    while q > 1:
        if x[k - 1] & q:
            t ^= q - 1
        q >>= 1
    for i in range(k):
        x[i] ^= t
    idx = 0
    for b in range(nbits - 1, -1, -1):
        for i in range(k):
            idx = (idx << 1) | ((x[i] >> b) & 1)
    return idx


def test_hilbert_index_matches_oracle():
    rng = np.random.default_rng(6)
    for k, nbits in ((2, 8), (3, 10), (4, 4)):
        cols = [rng.integers(0, 1 << nbits, 64).astype(np.int32)
                for _ in range(k)]
        got = zorder.hilbert_index(Table([_col(c) for c in cols]),
                                   nbits).data.numpy()
        for r in range(64):
            assert int(got[r]) == _hilbert_oracle(
                [cols[j][r] for j in range(k)], nbits), (k, nbits, r)


def test_hilbert_curve_properties_2d():
    for nbits in (1, 2, 3, 4):
        side = 1 << nbits
        xs, ys = np.meshgrid(np.arange(side, dtype=np.int32),
                             np.arange(side, dtype=np.int32))
        xs, ys = xs.ravel(), ys.ravel()
        idx = zorder.hilbert_index(Table([_col(xs), _col(ys)]),
                                   nbits).data.numpy()
        assert sorted(idx.tolist()) == list(range(side * side))
        order = np.argsort(idx)
        dx = np.abs(np.diff(xs[order])) + np.abs(np.diff(ys[order]))
        assert (dx == 1).all()


# --------------------------------------------------------------------------
# every input type against the reference
# --------------------------------------------------------------------------

TYPES = [("int8", np.int8, None), ("int16", np.int16, None),
         ("int32", np.int32, None), ("uint8", np.uint8, None),
         ("uint16", np.uint16, None), ("uint32", np.uint32, None),
         ("bool8", np.int8, "BOOL8")]


def _typed(rng, n, kind, np_dtype):
    if kind == "bool8":
        return rng.integers(0, 2, n).astype(np.int8)
    info = np.iinfo(np_dtype)
    vals = rng.integers(info.min, int(info.max) + 1, n, dtype=np.int64)
    vals[:4] = [info.min, info.max, 0, -1 if info.min < 0 else 1]
    return vals.astype(np_dtype)


def _pair_table(seed, k, kind, n=97, null_share=0.2):
    rng = np.random.default_rng(seed)
    _, np_dtype, name = next(t for t in TYPES if t[0] == kind)
    ref_cols, cols = [], []
    for _ in range(k):
        vals = _typed(rng, n, kind, np_dtype)
        valid = rng.random(n) >= null_share
        ref_cols.append(RefColumn.from_numpy(
            vals, valid, dtype=getattr(RT, name) if name else None))
        cols.append(_col(vals, valid, getattr(T, name) if name else None))
    return RefTable(ref_cols), Table(cols)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", [t[0] for t in TYPES])
def test_interleave_bits_equals_reference(kind, k):
    ref, got = _pair_table(11 * k, k, kind)
    want = ref_zorder.interleave_bits(ref)
    out = zorder.interleave_bits(got)
    assert out.dtype.id == T.TypeId.LIST and out.size == ref.num_rows
    np.testing.assert_array_equal(out.offsets.data.numpy(),
                                  np.asarray(want.children[0].data))
    np.testing.assert_array_equal(
        out.child.data.numpy().view(np.uint8),
        np.asarray(want.children[1].data).astype(np.uint8))


@pytest.mark.parametrize("num_bits", [1, 2, 5, 8, 13, 16, 21, 31, 32])
@pytest.mark.parametrize("kind", ["int32", "int8", "uint32"])
def test_hilbert_index_equals_reference(num_bits, kind):
    k = min(4, 63 // num_bits)
    ref, got = _pair_table(num_bits, k, kind, n=129)
    want = np.asarray(ref_zorder.hilbert_index(ref, num_bits).data)
    out = zorder.hilbert_index(got, num_bits)
    assert out.dtype == T.INT64
    np.testing.assert_array_equal(out.data.numpy(), want)
    assert (out.data >= 0).all()


def test_zorder_rejects_what_the_reference_rejects():
    t64 = Table([_col(np.arange(4, dtype=np.int64))])
    with pytest.raises(CudfLikeError):
        zorder.interleave_bits(t64)
    t32 = Table([_col(np.arange(4, dtype=np.int32))] * 2)
    with pytest.raises(CudfLikeError):
        zorder.hilbert_index(t32, 32)  # 2 x 32 > 63
    with pytest.raises(CudfLikeError):
        zorder.hilbert_index(t32, 0)
    with pytest.raises(CudfLikeError):
        zorder.interleave_bits(Table([]))
