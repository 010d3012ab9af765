"""Decimal operators: Spark decimal arithmetic inside the fused plan.

Port of ``spark_rapids_jni_tpu/tpcds/oplib/decimals.py``, over
``ops/decimal_utils.py`` and the int64 lane pairs of
``utils/int128.py``.

Semantics (Spark, non-ANSI): operands are DECIMAL32/64 columns (unscaled
integers with a cudf-style scale: value = unscaled * 10^scale); the
caller names the result type; a result that does not fit the result
type's storage, or a division by zero, is NULL (``CheckOverflow``), and
every live row nulled that way is counted ``rel.route.decimal.overflow``.
That count depends on the data, so inside ``run_fused`` it goes through
the runtime-counter channel (``rel.note_runtime_count``) and is read in
the query's one host sync. DECIMAL128 results flow through the plan
((N, 2) int64 [lo, hi] columns) and ``to_df`` decodes them.

DECIMAL32/64 sums take the dense groupby unchanged (int64 accumulation
is exact mod 2^64, Spark's long wrap), and overflow NULLs fold into the
accumulation's live mask, so sums and counts skip them. DECIMAL128
columns cannot be aggregated ((N, 2) lanes do not scatter into slots):
the groupby and window operators refuse them with that reason.
"""

from __future__ import annotations

import decimal
from typing import Optional, Union

import torch

from ...columnar import Column, Table
from ...obs import count
from ...ops import decimal_utils as _dec
from ...types import FLOAT64, DType, TypeId, decimal32, decimal64, decimal128
from ...utils import int128 as i128
from ...utils.errors import CudfLikeError
from .. import rel as _rel
from .registry import operator

_OPS = {"add": _dec.add, "sub": _dec.subtract, "mul": _dec.multiply,
        "div": _dec.divide}
_CMP = ("eq", "ne", "lt", "le", "gt", "ge")


def _as_dtype(spec) -> DType:
    """A DType, or a ('dec32'|'dec64'|'dec128', scale) shorthand."""
    if isinstance(spec, DType):
        return spec
    kind, scale = spec
    return {"dec32": decimal32, "dec64": decimal64,
            "dec128": decimal128}[kind](scale)


def unscaled(value: Union[str, int, float, decimal.Decimal],
             scale: int) -> int:
    """A literal's exact unscaled integer at ``scale`` (value = unscaled
    * 10^scale). An inexact literal is refused. A 60-digit context keeps
    38-digit DECIMAL128 literals exact."""
    with decimal.localcontext(decimal.Context(prec=60)):
        d = decimal.Decimal(str(value))
        shifted = d.scaleb(-scale)
        if shifted != shifted.to_integral_value():
            raise ValueError(f"literal {value!r} is not representable "
                             f"at scale {scale}")
        return int(shifted)


# -- oracles (pandas over unscaled int columns, exact) ---------------------

def arith_oracle(a_unscaled, b_unscaled, op, a_scale, b_scale, out_scale):
    """Decimal arithmetic over unscaled int Series in exact Python
    Decimals, HALF_UP at ``out_scale``, None for a division by zero."""
    import pandas as pd

    def one(a, b):
        if pd.isna(a) or pd.isna(b):
            return None
        da = decimal.Decimal(int(a)).scaleb(a_scale)
        db = decimal.Decimal(int(b)).scaleb(b_scale)
        if op == "add":
            r = da + db
        elif op == "sub":
            r = da - db
        elif op == "mul":
            r = da * db
        else:
            if db == 0:
                return None
            with decimal.localcontext(decimal.Context(prec=60)):
                r = da / db
        q = r.scaleb(-out_scale).quantize(
            decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP)
        return int(q)

    return a_unscaled.combine(b_unscaled, one)


def cmp_oracle(a_unscaled, op, literal_unscaled):
    import operator as _op
    f = {"eq": _op.eq, "ne": _op.ne, "lt": _op.lt, "le": _op.le,
         "gt": _op.gt, "ge": _op.ge}[op]
    return a_unscaled.map(lambda v: f(int(v), literal_unscaled))


def as_decimal_oracle(s, scale):
    return s.map(lambda v: decimal.Decimal(int(v)).scaleb(scale))


def to_double_oracle(s, scale):
    return s.astype("float64") * (10.0 ** scale)


# -- operators -------------------------------------------------------------

@operator("decimal.as_decimal", mask_class="rowwise", partition="local",
          oracle=as_decimal_oracle)
def as_decimal(rel, col: str, scale: int, out: Optional[str] = None):
    """Reinterpret an integer column as DECIMAL64 unscaled values at
    ``scale``: metadata only, no device work. A column already ingested
    as a decimal at that scale (``rel_from_df(decimals=)``) is left as
    it is, so a plan runs on either ingest."""
    c = rel.col(col)
    if c.dtype.is_decimal:
        if c.dtype.scale == scale and (out is None or out == col):
            return rel
        raise CudfLikeError(
            f"as_decimal({col!r}): column is already {c.dtype!r}")
    if not c.dtype.is_integral:
        raise CudfLikeError(
            f"as_decimal needs an integer column, got {c.dtype!r}")
    nc = Column(decimal64(scale), c.size, c.data.to(torch.int64),
                c.validity)
    if out is not None and out != col:
        return rel.with_column(out, nc)
    plain = rel._flush_sort()
    cols = [nc if n == col else plain.table.columns[i]
            for i, n in enumerate(plain.names)]
    return _rel._inherit_part(_rel.Rel(Table(cols), plain.names,
                                       mask=plain.mask, dicts=plain.dicts),
                              plain)


@operator("decimal.arith", mask_class="rowwise", partition="local",
          oracle=arith_oracle)
def arith(rel, op: str, a: str, b: str, out_dtype, out: str):
    """``out = a <op> b`` at ``out_dtype`` (``ops/decimal_utils``: HALF_UP
    rescale, overflow and division by zero -> NULL). Live rows nulled
    here are counted ``rel.route.decimal.overflow``."""
    if op not in _OPS:
        raise CudfLikeError(f"unknown decimal op {op!r}")
    dt = _as_dtype(out_dtype)
    ca, cb = rel.col(a), rel.col(b)
    res = _OPS[op](ca, cb, dt)
    count(f"rel.route.decimal.{op}")
    # a live row whose inputs were valid and whose result is null
    # overflowed (or divided by zero) here
    nulled = ca.valid_bool() & cb.valid_bool() & ~res.valid_bool()
    if rel.mask is not None:
        nulled = nulled & rel.mask
    _rel.note_runtime_count("rel.route.decimal.overflow",
                            nulled.sum(dtype=torch.int64), rel=rel)
    return rel.with_column(out, res)


@operator("decimal.cmp", mask_class="rowwise", partition="local",
          oracle=cmp_oracle)
def cmp(rel, col: str, op: str, literal):
    """Compare a decimal column with an exact literal -> (N,) bool, null
    rows False (the SQL predicate contract). The literal converts to the
    column's scale on the host; the comparison is integer algebra on the
    unscaled values."""
    if op not in _CMP:
        raise CudfLikeError(f"unknown comparison {op!r}")
    c = rel.col(col)
    if not c.dtype.is_decimal:
        raise CudfLikeError(f"decimal.cmp needs a decimal column, "
                            f"got {c.dtype!r}")
    count("rel.route.decimal.cmp")
    lit = unscaled(literal, c.dtype.scale)
    if c.dtype.id == TypeId.DECIMAL128:
        if not -(1 << 127) <= lit < (1 << 127):
            raise CudfLikeError(
                f"decimal.cmp literal {literal!r} exceeds 128 bits at "
                f"scale {c.dtype.scale}")
        # the literal as two's-complement lanes (it may pass int64):
        # compare lane-wise, the hi lane signed and the lo lane unsigned
        # (a subtraction could wrap: two 10^38 magnitudes may differ by
        # more than 2^127)
        l_hi, l_lo = i128.as_lane(lit >> 64), i128.as_lane(lit)
        v_hi, v_lo = c.data[:, 1], c.data[:, 0]
        hi_eq = v_hi == l_hi
        lt = (v_hi < l_hi) | (hi_eq & i128.ult(v_lo, l_lo))
        eq = hi_eq & (v_lo == l_lo)
    else:
        data = c.data.to(torch.int64)
        lt = data < lit
        eq = data == lit
    res = {"eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq,
           "gt": ~(lt | eq), "ge": ~lt}[op]
    return res & c.valid_bool()


@operator("decimal.to_double", mask_class="rowwise", partition="local",
          oracle=to_double_oracle)
def to_double(rel, col: str, out: str):
    """Decimal -> FLOAT64 projection (Spark CastDecimalToFloat), the lossy
    way out to float math. A DECIMAL128 keeps its full magnitude (both
    lanes count; float64 loses precision past 2^53, never wraps)."""
    c = rel.col(col)
    count("rel.route.decimal.to_double")
    if c.dtype.id == TypeId.DECIMAL128:
        mag, neg = i128.abs_(i128.U128(c.data[:, 1], c.data[:, 0]))
        f = _u64_to_f64(mag.hi) * 2.0 ** 64 + _u64_to_f64(mag.lo)
        v = torch.where(neg, -f, f)
    else:
        v = c.data.to(torch.int64).to(torch.float64)
    data = v * (10.0 ** c.dtype.scale)
    return rel.with_column(out, Column(FLOAT64, c.size, data, c.validity))


def _u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """uint64 bit patterns (int64 lanes) as float64, rounded to nearest
    as a uint64 -> double conversion rounds."""
    # the top 53 bits and the rest, each exact in float64, summed once
    top = i128.srl(x, 11).to(torch.float64) * 2048.0
    return top + (x & 2047).to(torch.float64)
