"""DecimalUtils: Spark decimal arithmetic with overflow -> NULL.

Port of ``spark_rapids_jni_tpu/ops/decimal_utils.py``. The 128-bit
intermediates are the (hi, lo) int64 lane pairs of ``utils/int128.py``:

- operands are DECIMAL32/64 columns (int32/int64 unscaled values with a
  cudf-style scale: value = unscaled * 10^scale; Spark's Decimal(p, s)
  has scale -s), DECIMAL128 too where the operation allows it;
- the caller names the result type; a result that does not fit the
  result type's unscaled storage, or a division by zero, is NULL (Spark's
  non-ANSI CheckOverflow);
- rounding is HALF_UP, as Spark rounds in casts and division.

Result validity is packed by ``columnar.bitmask.pack``: K3 on a CUDA
tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..columnar import Column, bitmask
from ..types import DType, TypeId
from ..utils.errors import expects
from ..utils import int128 as i128
from ..obs import traced


def _check_decimal(col: Column, name: str, allow128: bool = True):
    ok = (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128) \
        if allow128 else (TypeId.DECIMAL32, TypeId.DECIMAL64)
    expects(col.dtype.id in ok, f"{name} does not support {col.dtype!r}")


def _storage_limit(dt: DType) -> int:
    return (2**31 - 1) if dt.id == TypeId.DECIMAL32 else (2**63 - 1)


# Spark's Decimal(38) bound: DECIMAL128 magnitudes stay <= 10^38 - 1.
_DEC128_MAX = 10**38 - 1
_DEC128_MAX_HI = i128.as_lane(_DEC128_MAX >> 64)
_DEC128_MAX_LO = i128.as_lane(_DEC128_MAX)


def _to_u128(col: Column) -> i128.U128:
    """A column's unscaled values as 128-bit lanes (sign-extending
    DECIMAL32/64)."""
    if col.dtype.id == TypeId.DECIMAL128:
        return i128.U128(col.data[:, 1], col.data[:, 0])  # (hi, lo)
    return i128.from_i64(col.data)


def _no_overflow(v128: i128.U128) -> torch.Tensor:
    return torch.zeros(v128.lo.shape, dtype=torch.bool,
                       device=v128.lo.device)


def _signed(mag: i128.U128, was_neg: torch.Tensor) -> i128.U128:
    return i128.select(was_neg, i128.neg(mag), mag)


def _rescale_to(v128: i128.U128, from_scale: int, to_scale: int):
    """Rescale a 128-bit unscaled value between scales, HALF_UP. Returns
    (value, overflow): to_scale < from_scale multiplies by
    10^(from - to), to_scale > from_scale divides with rounding."""
    if to_scale == from_scale:
        return v128, _no_overflow(v128)
    k = abs(from_scale - to_scale)
    expects(k <= 18, "rescale shift too large")
    mag, was_neg = i128.abs_(v128)
    if to_scale < from_scale:
        scaled, ovf = i128.mul_small(mag, i128.pow10_u64(k))
        ovf = ovf | i128.is_neg(scaled)  # magnitude must stay below 2^127
        return _signed(scaled, was_neg), ovf
    q, _ = i128.divmod_round_half_up(mag, i128.pow10_u64(k))
    return _signed(q, was_neg), _no_overflow(v128)


def _finish(v128: i128.U128, valid: torch.Tensor, out_dtype: DType,
            n: int) -> Column:
    """The result column: values that fit ``out_dtype`` and were valid,
    NULL elsewhere; the validity packed by K3 on the card."""
    mag, _ = i128.abs_(v128)
    if out_dtype.id == TypeId.DECIMAL128:
        fits = i128.ult(mag.hi, _DEC128_MAX_HI) | (
            (mag.hi == _DEC128_MAX_HI) & i128.uge(_DEC128_MAX_LO, mag.lo))
        data = torch.stack([v128.lo, v128.hi], dim=1)
        return Column(out_dtype, n, data, bitmask.pack(valid & fits))
    fits = (mag.hi == 0) & i128.uge(_storage_limit(out_dtype), mag.lo)
    data = i128.to_i64(v128).to(out_dtype.to_torch())
    return Column(out_dtype, n, data, bitmask.pack(valid & fits))


def _operands(a: Column, b: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    return a.data.to(torch.int64), b.data.to(torch.int64)


def _add_like(a: Column, b: Column, out_dtype: DType, fn) -> Column:
    a128, aov = _rescale_to(_to_u128(a), a.dtype.scale, out_dtype.scale)
    b128, bov = _rescale_to(_to_u128(b), b.dtype.scale, out_dtype.scale)
    valid = a.valid_bool() & b.valid_bool() & ~aov & ~bov
    return _finish(fn(a128, b128), valid, out_dtype, a.size)


@traced("decimal_utils.add")
def add(a: Column, b: Column, out_dtype: DType) -> Column:
    """a + b at out_dtype's scale; overflow and nulls as in Spark."""
    _check_decimal(a, "add")
    _check_decimal(b, "add")
    expects(out_dtype.is_decimal, "decimal result type required")
    return _add_like(a, b, out_dtype, i128.add)


@traced("decimal_utils.subtract")
def subtract(a: Column, b: Column, out_dtype: DType) -> Column:
    _check_decimal(a, "subtract")
    _check_decimal(b, "subtract")
    return _add_like(a, b, out_dtype, i128.sub)


@traced("decimal_utils.multiply")
def multiply(a: Column, b: Column, out_dtype: DType) -> Column:
    """a * b: the exact 128-bit product at scale sa + sb, rescaled to
    out_dtype. Operands are DECIMAL32/64 (a 128 x 128 product needs 256
    bits); DECIMAL128 results are supported."""
    _check_decimal(a, "multiply", allow128=False)
    _check_decimal(b, "multiply", allow128=False)
    av, bv = _operands(a, b)
    out, ovf = _rescale_to(i128.mul_i64(av, bv),
                           a.dtype.scale + b.dtype.scale, out_dtype.scale)
    valid = a.valid_bool() & b.valid_bool() & ~ovf
    return _finish(out, valid, out_dtype, a.size)


@traced("decimal_utils.divide")
def divide(a: Column, b: Column, out_dtype: DType) -> Column:
    """a / b rounded HALF_UP at out_dtype's scale; b == 0 -> NULL.

    result = round(ua * 10^k / ub) with k = sa - sb - st (st the result
    scale); Spark's result-scale rules give k >= 0, and k <= 18 is
    required (one 10^k factor must fit 64 bits)."""
    _check_decimal(a, "divide", allow128=False)
    _check_decimal(b, "divide", allow128=False)
    k = a.dtype.scale - b.dtype.scale - out_dtype.scale
    expects(0 <= k <= 18, f"divide: unsupported scale combination (k={k})")
    av, bv = _operands(a, b)
    amag, aneg = i128.abs_(i128.from_i64(av))
    num, novf = i128.mul_small(amag, i128.pow10_u64(k))
    q, nonzero = i128.divmod_round_half_up(num, torch.where(bv < 0, -bv, bv))
    out = _signed(q, aneg ^ (bv < 0))
    valid = a.valid_bool() & b.valid_bool() & nonzero & ~novf
    return _finish(out, valid, out_dtype, a.size)


@traced("decimal_utils.round_decimal")
def round_decimal(col: Column, out_dtype: DType) -> Column:
    """Rescale a decimal column to another scale, HALF_UP (Spark round)."""
    _check_decimal(col, "round_decimal")
    v128, ovf = _rescale_to(_to_u128(col), col.dtype.scale, out_dtype.scale)
    return _finish(v128, col.valid_bool() & ~ovf, out_dtype, col.size)


@traced("decimal_utils.cast_decimal")
def cast_decimal(col: Column, out_dtype: DType) -> Column:
    """Cast between decimal widths and scales (Spark CAST, non-ANSI
    overflow -> NULL), HALF_UP on scale reduction: one rescale through
    the 128-bit lanes."""
    expects(out_dtype.is_decimal, "cast_decimal needs a decimal target")
    return round_decimal(col, out_dtype)
