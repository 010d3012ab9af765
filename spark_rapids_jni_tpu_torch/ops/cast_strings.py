"""CastStrings: string <-> numeric, date and timestamp casts with Spark
semantics.

Port of ``spark_rapids_jni_tpu/ops/cast_strings.py``. Every cast parses
the padded byte matrix (``columnar/strings.byte_matrix``) with Horner
scans over its columns, every row in lock step, so there is no per-row
control flow: an invalid byte clears the row's validity, which K3 packs
(``bitmask.pack``). Spark's non-ANSI semantics (failures -> NULL):

- surrounding ASCII whitespace is trimmed;
- string -> integral: sign and decimal digits; a '.' and digits after
  them are truncated ("1.9" -> 1; ANSI rejects them and raises on any
  invalid row); overflow -> NULL;
- string -> float: sign, digits, fraction, exponent, "inf"/"infinity"/
  "nan" (any case), the reference's grammar and arithmetic;
- string -> decimal(scale): HALF_UP to the target scale, overflow ->
  NULL;
- integral and decimal -> string, ``conv`` (base conversion) and the
  date/timestamp grammar (a vectorized DFA) as in the reference;
  ``format_number`` is the reference's exact host ``decimal`` code.

torch has no unsigned 64-bit arithmetic: magnitudes that reach 2^63 are
int64 lanes holding the uint64 bits, compared with ``int128.ult`` and
divided with ``int128.udiv10``/``udivmod_small``. torch's ``argmax`` of
a bool mask does not run on CUDA, so a first or last position is the
``amin``/``amax`` of the positions where the mask holds. The output bytes
of the to-string casts are built with tensor ops on the column's device.

string -> float keeps the reference's deviations from Java's correctly
rounded parser: it multiplies 19 digits by an inexact power of ten (an
ulp off in about a third of random doubles), counts leading zeros among
the 19 ("0.0...01" with 21 zeros reads 0.0) and reads "0e500" as NaN.
It does not flush subnormals, as the reference does on the CPU: there
a power below 1e-307 and a float32 result below 2^-126 read 0.0.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..columnar import Column, bitmask
from ..columnar.strings import byte_matrix, max_length, strings_from_matrix
from ..obs import traced
from ..types import (DType, FLOAT64, INT64, TIMESTAMP_DAYS,
                     TIMESTAMP_MICROSECONDS, TypeId)
from ..utils import int128 as i128
from ..utils.errors import expects, fail
from .datetime import civil_from_days, days_from_civil



def _positions(m: int, dev) -> torch.Tensor:
    return torch.arange(m, dtype=torch.int32, device=dev)[None, :]


def _first(mask: torch.Tensor, default) -> torch.Tensor:
    """Per row: the first column where ``mask`` holds, else ``default``."""
    m = mask.shape[1]
    first = torch.where(mask, _positions(m, mask.device), m).amin(dim=1)
    return torch.where(first < m, first, default)


def _last(mask: torch.Tensor, default) -> torch.Tensor:
    """Per row: the last column where ``mask`` holds, else ``default``."""
    last = torch.where(mask, _positions(mask.shape[1], mask.device),
                       -1).amax(dim=1)
    return torch.where(last >= 0, last, default)


def _at(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mat[i, idx[i]]`` for every row."""
    return torch.gather(mat, 1, idx.to(torch.int64)[:, None])[:, 0]


def _between(pos, lo, hi):
    return (pos >= lo[:, None]) & (pos < hi[:, None])


def _trim_bounds(mat, lens):
    """Start/end (exclusive) of the non-whitespace core per row."""
    pos = _positions(mat.shape[1], mat.device)
    # the ASCII whitespace Spark's UTF8String.trim removes: 9-13 and 32
    is_ws = ((mat >= 9) & (mat <= 13)) | (mat == 32)
    content = (pos < lens[:, None]) & ~is_ws
    start = _first(content, 0)
    end = _last(content, -1) + 1
    return start, end


def _sign(mat, start):
    """(first core byte, has a sign, is negative)."""
    m = mat.shape[1]
    first = _at(mat, start.clamp(max=m - 1))
    neg = first == ord("-")
    return first, neg | (first == ord("+")), neg


def _is_digit(mat):
    return (mat >= ord("0")) & (mat <= ord("9"))


@traced("cast_strings.cast_to_integer")
def cast_to_integer(col: Column, out_dtype: DType = INT64,
                    ansi: bool = False) -> Column:
    """STRING -> integral column.

    Non-ANSI (default): invalid -> NULL, and a trailing fractional part is
    truncated ("1.9" -> 1, Spark's UTF8String.toLong). ANSI: fractional
    parts are rejected too (UTF8String.toLongExact), and any invalid
    non-null row raises, Spark's ansiEnabled cast exception.
    """
    expects(col.dtype.id == TypeId.STRING, "cast_to_integer needs STRING")
    expects(out_dtype.is_integral, "integral target required")
    m = max(max_length(col), 1)
    mat, lens = byte_matrix(col, m)
    start, end = _trim_bounds(mat, lens)
    pos = _positions(m, mat.device)
    _, has_sign, neg = _sign(mat, start)
    digit_start = start + has_sign.to(torch.int32)

    is_digit = _is_digit(mat)
    # integer part: digits from digit_start until the first non-digit
    nondigit = _between(pos, digit_start, end) & ~is_digit
    int_end = torch.minimum(_first(nondigit, end), end)
    in_int = _between(pos, digit_start, int_end)
    # Horner over the columns on uint64 bit patterns, so that
    # "-9223372036854775808" (magnitude 2^63) survives, with exact
    # overflow tracking
    acc = torch.zeros(col.size, dtype=torch.int64, device=mat.device)
    overflow = torch.zeros(col.size, dtype=torch.bool, device=mat.device)
    boundary = 2**63 // 10  # 922337203685477580
    for c in range(m):
        d = mat[:, c].to(torch.int64) - ord("0")
        active = in_int[:, c]
        would = i128.ult(boundary, acc) | ((acc == boundary) & (d > 8))
        overflow = overflow | (active & would)
        acc = torch.where(active, acc * 10 + d, acc)

    # fraction: '.' then digits only until the end is truncated, else
    # the row is invalid
    has_frac = (int_end < end) & (_at(mat, int_end.clamp(max=m - 1))
                                  == ord("."))
    in_frac = (pos > int_end[:, None]) & (pos < end[:, None])
    frac_ok = torch.where(has_frac, ~(in_frac & ~is_digit).any(dim=1),
                          int_end == end)
    if ansi:
        frac_ok = frac_ok & ~has_frac  # toLongExact: "1.9" is an error

    has_digits = int_end > digit_start
    # unsigned acc <= 2^63 when negative, acc <= 2^63 - 1 otherwise
    in_range64 = torch.where(neg, ~i128.ult(-2**63, acc), acc >= 0)
    valid_parse = has_digits & frac_ok & (end > start) & ~overflow & \
        in_range64
    value = torch.where(neg, -acc, acc)  # -(2^63) wraps to itself

    if out_dtype.id != TypeId.INT64:
        info = np.iinfo(out_dtype.storage_dtype)
        valid_parse = valid_parse & (value >= int(info.min)) & \
            (value <= int(info.max))
    if ansi:
        bad = ~valid_parse & col.valid_bool()
        if bool(bad.any()):
            row = int(_first(bad[None, :], 0)[0])
            fail(f"ANSI cast to integral failed at row {row}")
    out_valid = valid_parse & col.valid_bool()
    return Column(out_dtype, col.size, value.to(out_dtype.to_torch()),
                  bitmask.pack(out_valid))


# 10^k as the reference's ``power(10.0, k)`` gives it (the C library's
# pow, which is 1e23 and 1e210 an ulp high), for k in [_P10_MIN, _P10_MAX];
# past either end the power is 0.0 or inf, as pow's is
_P10_MIN, _P10_MAX = -330, 310
_POW10 = [0.0] * (-_P10_MIN - 323) + \
    [10.0 ** k for k in range(-323, 309)] + [float("inf")] * (_P10_MAX - 308)


@traced("cast_strings.cast_to_float")
def cast_to_float(col: Column, out_dtype: DType = FLOAT64) -> Column:
    """STRING -> float column (sign/digits/fraction/exponent/inf/nan).

    The reference's arithmetic, in its order: the first 19 mantissa
    digits (leading zeros among them) accumulate as ``acc * 10.0 + d``
    in float64, one op each, and the value is ``acc * 10^e`` in one
    multiply, so the CPU and the card give the same bits. FLOAT32 rounds
    that double to float32."""
    expects(col.dtype.id == TypeId.STRING, "cast_to_float needs STRING")
    m = max(max_length(col), 1)
    mat, lens = byte_matrix(col, m)
    n, dev = col.size, mat.device
    start, end = _trim_bounds(mat, lens)
    upper = (mat >= ord("A")) & (mat <= ord("Z"))
    lower = torch.where(upper, mat + 32, mat)

    def match_at(word: bytes, at):
        ok = (end - at) == len(word)
        for i, ch in enumerate(word):
            ok = ok & (_at(lower, (at + i).clamp(max=m - 1)) == ch)
        return ok

    pos = _positions(m, dev)
    _, has_sign, neg = _sign(mat, start)
    body = start + has_sign.to(torch.int32)
    is_inf = match_at(b"inf", body) | match_at(b"infinity", body)
    is_nan = match_at(b"nan", body)

    is_digit = _is_digit(mat)
    in_core = _between(pos, body, end)
    dot_pos = _first(in_core & (mat == ord(".")), end)
    e_pos = _first(in_core & (lower == ord("e")), end)
    has_e = e_pos < end
    mant_end = torch.minimum(e_pos, end)
    int_end = torch.minimum(dot_pos, mant_end)
    in_int = _between(pos, body, int_end)
    in_frac = (pos > dot_pos[:, None]) & (pos < mant_end[:, None])

    e_body = e_pos + 1
    efirst = _at(mat, e_body.clamp(max=m - 1))
    e_neg = efirst == ord("-")
    e_start = e_body + (e_neg | (efirst == ord("+"))).to(torch.int32)
    in_exp = _between(pos, e_start, end)

    # the mantissa's first 19 digits (the double's limit) as one float64,
    # and the exponent's digits
    acc = torch.zeros(n, dtype=torch.float64, device=dev)
    n_mant = torch.zeros(n, dtype=torch.int32, device=dev)
    eacc = torch.zeros(n, dtype=torch.int32, device=dev)
    active = in_int | in_frac
    for c in range(m):
        d = mat[:, c].to(torch.int32) - ord("0")
        take = active[:, c] & (n_mant < 19)
        acc = torch.where(take, acc * 10.0 + d.to(torch.float64), acc)
        n_mant = n_mant + take.to(torch.int32)
        eacc = torch.where(in_exp[:, c],
                           torch.clamp(eacc * 10 + d, max=100000), eacc)
    int_digits = (in_int & is_digit).sum(dim=1)
    frac_digits = (in_frac & is_digit).sum(dim=1)
    # integer digits past the 19th shift the exponent; fraction digits
    # past it are dropped
    taken_frac = torch.minimum(frac_digits, (19 - int_digits).clamp(min=0))
    extra_int = (int_digits - 19).clamp(min=0)
    exp_val = torch.where(e_neg, -eacc, eacc)

    # validity: digits present, every core byte consumed legally
    bad = ((active | in_exp) & ~is_digit).any(dim=1)
    exp_ok = torch.where(has_e, (in_exp & is_digit).any(dim=1), True)
    parse_ok = (int_digits + frac_digits > 0) & ~bad & exp_ok & (end > start)

    total_exp = exp_val + extra_int - taken_frac
    p10 = torch.tensor(_POW10, dtype=torch.float64, device=dev)[
        (total_exp.clamp(_P10_MIN, _P10_MAX) - _P10_MIN).to(torch.int64)]
    value = torch.where(is_inf, float("inf"), acc * p10)
    value = torch.where(neg, -value, value)
    # one NaN: a NaN the device makes (0 x inf) has its own sign and
    # payload on each device
    value = torch.where(is_nan | torch.isnan(value), float("nan"), value)
    parse_ok = parse_ok | is_inf | is_nan

    out_valid = parse_ok & col.valid_bool()
    if out_dtype.id == TypeId.FLOAT32:
        value = value.to(torch.float32)
    return Column(out_dtype, n, value, bitmask.pack(out_valid))


@traced("cast_strings.cast_to_decimal")
def cast_to_decimal(col: Column, out_dtype: DType) -> Column:
    """STRING -> DECIMAL32/64 with HALF_UP rounding to the target scale."""
    expects(col.dtype.id == TypeId.STRING, "cast_to_decimal needs STRING")
    expects(out_dtype.id in (TypeId.DECIMAL32, TypeId.DECIMAL64),
            "DECIMAL32 or DECIMAL64 target required")
    target_scale = out_dtype.scale  # value = unscaled * 10^scale
    m = max(max_length(col), 1)
    mat, lens = byte_matrix(col, m)
    n, dev = col.size, mat.device
    start, end = _trim_bounds(mat, lens)
    pos = _positions(m, dev)
    _, has_sign, neg = _sign(mat, start)
    body = start + has_sign.to(torch.int32)

    is_digit = _is_digit(mat)
    dot_pos = _first(_between(pos, body, end) & (mat == ord(".")), end)
    int_end = torch.minimum(dot_pos, end)
    in_int = _between(pos, body, int_end)
    in_frac = (pos > dot_pos[:, None]) & (pos < end[:, None])

    # a digit at 10^k scales into the unscaled value when k >= scale; the
    # first digit below is the HALF_UP guard. Digits come in order of
    # decreasing power, so Horner accumulates the unscaled value directly.
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    guard = torch.zeros(n, dtype=torch.int64, device=dev)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    limit = (2**63 - 1) // 10
    for c in range(m):
        d = mat[:, c].to(torch.int64) - ord("0")
        active = in_int[:, c] | in_frac[:, c]
        power = torch.where(in_int[:, c], int_end - 1 - c, dot_pos - c)
        rel = power - target_scale
        take = active & (rel >= 0)
        overflow = overflow | (take & ((acc > limit) |
                                       ((acc == limit) & (d > 7))))
        acc = torch.where(take, acc * 10 + d, acc)
        guard = torch.where(active & (rel == -1), d, guard)
    acc = acc + (guard >= 5).to(torch.int64)  # HALF_UP, away from zero

    # fewer fraction digits than the scale asks for: scale the value up
    # ("12" at scale -2 -> unscaled 1200)
    frac_digits = (in_frac & is_digit).sum(dim=1, dtype=torch.int32)
    shift = (-frac_digits - target_scale).clamp(min=0)
    for _ in range(max(-target_scale, 0) or 1):
        do = shift > 0
        overflow = overflow | (do & (acc > (2**63 - 1) // 10))
        acc = torch.where(do, acc * 10, acc)
        shift = shift - do.to(torch.int32)

    bad = ((in_int | in_frac) & ~is_digit).any(dim=1)
    digits = ((in_int | in_frac) & is_digit).any(dim=1)
    parse_ok = digits & ~bad & (end > start) & ~overflow
    if out_dtype.id == TypeId.DECIMAL32:
        parse_ok = parse_ok & (acc <= np.iinfo(np.int32).max)
    value = torch.where(neg, -acc, acc)
    out_valid = parse_ok & col.valid_bool()
    return Column(out_dtype, n, value.to(out_dtype.to_torch()),
                  bitmask.pack(out_valid))


_MAX_I64_DIGITS = 20


def _digit_matrix_and_sign(v: torch.Tensor):
    """int64 vector -> (digit values most-significant-first (N, 20)
    uint8, negative flags). The magnitude is a uint64 bit pattern, so
    INT64_MIN survives the negation."""
    neg = v < 0
    rem = torch.where(neg, -v, v)
    digits = []
    for _ in range(_MAX_I64_DIGITS):
        q = i128.udiv10(rem)
        digits.append((rem - q * 10).to(torch.uint8))
        rem = q
    return torch.stack(digits[::-1], dim=1), neg


def _digit_count(dmat: torch.Tensor) -> torch.Tensor:
    """Significant digits of each row of a right-aligned digit matrix
    (1 for zero)."""
    md = dmat.shape[1]
    return (md - _first(dmat != 0, md - 1)).to(torch.int32)


@traced("cast_strings.cast_integer_to_string")
def cast_integer_to_string(col: Column) -> Column:
    """Integral -> STRING (minimal decimal form), built on the column's
    device: byte p of a row is '-' or one gather from its digits."""
    expects(col.dtype.is_integral or col.dtype.id == TypeId.BOOL8,
            "integral input required")
    dmat, neg = _digit_matrix_and_sign(col.data.to(torch.int64))
    nd = _digit_count(dmat)
    sw = neg.to(torch.int32)
    p = _positions(_MAX_I64_DIGITS + 1, dmat.device) - sw[:, None]
    src = (_MAX_I64_DIGITS - nd)[:, None] + p
    dig = torch.gather(dmat, 1, src.clamp(0, _MAX_I64_DIGITS - 1)
                       .to(torch.int64)) + ord("0")
    out = torch.where(p < 0, ord("-"), dig)
    return strings_from_matrix(out, nd + sw, col.valid_bool())


# ---------------------------------------------------------------------------
# conv: base conversion (Spark's conv / Hive NumberConverter)
# ---------------------------------------------------------------------------

def _digit_values(mat: torch.Tensor) -> torch.Tensor:
    """Per-byte digit value (0..35), 255 for non-digits."""
    m = mat.to(torch.int32)
    d = torch.full_like(m, 255)
    d = torch.where(_is_digit(mat), m - ord("0"), d)
    d = torch.where((mat >= ord("a")) & (mat <= ord("z")),
                    m - ord("a") + 10, d)
    d = torch.where((mat >= ord("A")) & (mat <= ord("Z")),
                    m - ord("A") + 10, d)
    return d


def _digits_for_u64(base: int) -> int:
    """Digits of 2^64 - 1 in ``base``."""
    k = 1
    while base ** k < 2 ** 64:
        k += 1
    return k


@traced("cast_strings.conv")
def conv(col: Column, from_base: int, to_base: int) -> Column:
    """STRING -> STRING base conversion, Spark ``conv`` semantics:

    - bases in [2, 36] (|to_base|); to_base < 0 means signed output,
    - optional leading '-', then the longest valid-digit prefix (an invalid
      first digit yields value 0, like NumberConverter, not NULL),
    - arithmetic is unsigned 64-bit; overflow clamps to 2^64 - 1,
    - '-' input with positive to_base reinterprets the negated value as
      unsigned (two's complement), negative to_base prints a signed result,
    - output digits are uppercase; NULL and empty inputs -> NULL.
    """
    expects(col.dtype.id == TypeId.STRING, "conv needs STRING")
    expects(2 <= from_base <= 36, "from_base must be in [2, 36]")
    expects(2 <= abs(to_base) <= 36, "|to_base| must be in [2, 36]")
    n = col.size
    m = max(max_length(col), 1)
    mat, lens = byte_matrix(col, m)
    dev = mat.device

    neg = (mat[:, 0] == ord("-")) & (lens > 0)
    digit_start = neg.to(torch.int32)
    dv = _digit_values(mat)
    pos = _positions(m, dev)
    after_sign = pos >= digit_start[:, None]
    is_valid_digit = (dv < from_base) & (pos < lens[:, None]) & after_sign
    # the longest valid prefix: the digits before the first bad position
    # (the reference's running count of bad positions, as one minimum)
    first_bad = _first(~is_valid_digit & after_sign, m)
    in_num = is_valid_digit & (pos < first_bad[:, None])

    v = torch.zeros(n, dtype=torch.int64, device=dev)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in range(m):
        active = in_num[:, c]
        nv, over = i128.mul_add_u64(v, from_base, dv[:, c].to(torch.int64))
        overflow = overflow | (active & over)
        v = torch.where(active, nv, v)
    v = torch.where(overflow, -1, v)  # 2^64 - 1

    # sign handling, as NumberConverter.convert:
    #   if (negative && toBase > 0) v = (v < 0 signed) ? -1 : -v
    #   if (toBase < 0 && v < 0 signed) { v = -v; negative = true }
    #   '-' is printed only when toBase < 0 (unsigned print otherwise)
    b_out = abs(to_base)
    is_neg_signed = v < 0
    if to_base > 0:
        mag = torch.where(neg, torch.where(is_neg_signed, -1, -v), v)
        neg_out = torch.zeros_like(neg)
    else:
        mag = torch.where(is_neg_signed, -v, v)
        neg_out = neg | is_neg_signed

    # digits least significant first; past the first they fit int64
    width = _digits_for_u64(b_out)
    rem, d0 = i128.udivmod_small(mag, b_out)
    digits = [d0]
    for _ in range(width - 1):
        digits.append(torch.remainder(rem, b_out))
        rem = rem // b_out
    dmat = torch.stack(digits, dim=1).to(torch.uint8)  # (N, width)
    ndig = _last(dmat != 0, 0) + 1
    sw = neg_out.to(torch.int32)
    t = _positions(width + 1, dev)
    src = ndig[:, None] - 1 - (t - sw[:, None])
    dig = torch.gather(dmat, 1, src.clamp(0, width - 1).to(torch.int64)) \
        .to(torch.int32)
    ch = torch.where(dig < 10, dig + ord("0"), dig - 10 + ord("A"))
    out = torch.where(t < sw[:, None], ord("-"), ch)
    return strings_from_matrix(out, ndig + sw, col.valid_bool() & (lens > 0))


# ---------------------------------------------------------------------------
# string -> DATE / TIMESTAMP (Spark DateTimeUtils.stringToDate/-Timestamp)
# ---------------------------------------------------------------------------
#
# Accepted shapes (after whitespace trim; failures -> NULL, non-ANSI):
#   [+-]y{1,7}                          -> Jan 1 of that year
#   [+-]y{1,7}-m[m]                     -> first of month
#   [+-]y{1,7}-m[m]-d[d]                (date cast ignores a ' '/'T' tail)
#   ... d[d][ T]h[h][:m[m][:s[s][.f{0,9}]]][zone]   (timestamp)
# zone: 'Z' | 'UTC' | 'GMT' | 'UT' (optionally followed by an offset) or a
# numeric offset [+-]h[h][:mm[:ss]] / [+-]hhmm[ss]. Named region zones
# (e.g. America/Los_Angeles) are resolved via the default_tz argument only;
# per-row region ids are NULLed, as in the mainline GPU cast.
#
# The parser is a vectorized DFA: one pass over byte-matrix columns, a state
# vector per row, every transition a masked select. No per-row control flow.

_ST_YEAR, _ST_MON, _ST_DAY, _ST_HOUR, _ST_MIN, _ST_SEC, _ST_FRAC = range(7)
_ST_ZSTART, _ST_ZH, _ST_ZM, _ST_ZS, _ST_ZLET, _ST_DONE = 7, 8, 9, 10, 11, 12
_ST_BAD = 99
_ZPATS = ("Z", "UTC", "GMT", "UT")
_UTC_IDS = ("UTC", "Z", "GMT", "UT")
_US_PER_DAY = 86_400_000_000


def _parse_datetime_matrix(mat, lens, date_only: bool) -> dict:
    n, m = mat.shape
    dev = mat.device
    start, end = _trim_bounds(mat, lens)

    def i32(v):
        return torch.full((n,), v, dtype=torch.int32, device=dev)

    def false():
        return torch.zeros(n, dtype=torch.bool, device=dev)

    first, has_sign, _ = _sign(mat, start)
    ysign = torch.where(first == ord("-"), -1, 1).to(torch.int32)
    # Spark's justTime path: 'T12:30' / '12:30' carry no date at all
    first_t = (first == ord("T")) & (not date_only)
    time_only = first_t

    st = torch.where(first_t, _ST_HOUR, _ST_YEAR).to(torch.int32)
    acc = [i32(0) for _ in range(7)]   # y mo dy hh mi ss frac
    cnt = [i32(0) for _ in range(7)]
    zsign = i32(1)
    zacc = [i32(0) for _ in range(3)]  # zh zm zs
    zcnt = [i32(0) for _ in range(3)]
    zm_colon = false()  # ':'-separated minutes
    # zone-letter pattern match: Z, UTC, GMT, UT
    zposs = [~false() for _ in _ZPATS]
    zlen = i32(0)

    pos0 = start + (has_sign | first_t).to(torch.int32)
    for j in range(m):
        ch = mat[:, j].to(torch.int32)
        inside = (j >= pos0) & (j < end) & (st != _ST_BAD) & \
            (st != _ST_DONE)
        digit = (ch >= ord("0")) & (ch <= ord("9"))
        dv = ch - ord("0")
        is_letter = ((ch >= ord("A")) & (ch <= ord("Z"))) | \
                    ((ch >= ord("a")) & (ch <= ord("z")))
        new_st = st
        handled = false()

        # digits advance the current field's accumulator
        for f in range(7):
            m_f = inside & (st == f) & digit
            take = m_f & (cnt[f] < 6) if f == _ST_FRAC else m_f
            acc[f] = torch.where(take, acc[f] * 10 + dv, acc[f])
            cnt[f] = torch.where(m_f, cnt[f] + 1, cnt[f])
            handled = handled | m_f
        for zf in range(3):
            m_z = inside & (st == _ST_ZH + zf) & digit
            # compact offsets overflow into the next field after 2 digits
            nxt = m_z & (zcnt[zf] >= 2) & (zf < 2)
            stay = m_z & ~nxt
            zacc[zf] = torch.where(stay, zacc[zf] * 10 + dv, zacc[zf])
            zcnt[zf] = torch.where(stay, zcnt[zf] + 1, zcnt[zf])
            if zf < 2:
                zacc[zf + 1] = torch.where(nxt, dv, zacc[zf + 1])
                zcnt[zf + 1] = torch.where(nxt, 1, zcnt[zf + 1])
                new_st = torch.where(nxt, _ST_ZH + zf + 1, new_st)
            handled = handled | m_z

        def goto(mask, target):
            nonlocal new_st, handled
            new_st = torch.where(mask & ~handled, target, new_st)
            handled = handled | mask

        dash, colon, dot = ch == ord("-"), ch == ord(":"), ch == ord(".")
        sep_t = (ch == ord(" ")) | (ch == ord("T"))
        plusminus = (ch == ord("+")) | dash

        if not date_only:
            # '12:' while still reading the year: the string is time-only,
            # its digits move into the hour field (Spark justTime)
            ycolon = inside & (st == _ST_YEAR) & colon & ~has_sign & \
                (cnt[0] >= 1) & (cnt[0] <= 2) & ~handled
            acc[3] = torch.where(ycolon, acc[0], acc[3])
            cnt[3] = torch.where(ycolon, cnt[0], cnt[3])
            acc[0] = torch.where(ycolon, 0, acc[0])
            cnt[0] = torch.where(ycolon, 0, cnt[0])
            time_only = time_only | ycolon
            goto(ycolon, _ST_MIN)
        goto(inside & (st == _ST_YEAR) & dash & (cnt[0] > 0), _ST_MON)
        goto(inside & (st == _ST_MON) & dash & (cnt[1] > 0), _ST_DAY)
        if date_only:
            goto(inside & (st == _ST_DAY) & sep_t & (cnt[2] > 0), _ST_DONE)
        else:
            goto(inside & (st == _ST_DAY) & sep_t & (cnt[2] > 0), _ST_HOUR)
            goto(inside & (st == _ST_HOUR) & colon & (cnt[3] > 0), _ST_MIN)
            goto(inside & (st == _ST_MIN) & colon & (cnt[4] > 0), _ST_SEC)
            goto(inside & (st == _ST_SEC) & dot & (cnt[5] > 0), _ST_FRAC)
            # zone entry from any time state (hour..frac): sign / letter /
            # space, but only once the current field has its digits
            # (Spark rejects '12:+05:00': a started segment can't be empty)
            in_time = (((st == _ST_HOUR) & (cnt[3] > 0)) |
                       ((st == _ST_MIN) & (cnt[4] > 0)) |
                       ((st == _ST_SEC) & (cnt[5] > 0)) |
                       (st == _ST_FRAC))
            zs_mask = inside & in_time & plusminus
            zsign = torch.where(zs_mask & dash, -1, zsign)
            goto(zs_mask, _ST_ZH)
            goto(inside & in_time & (ch == ord(" ")), _ST_ZSTART)
            zl_entry = inside & (in_time | (st == _ST_ZSTART)) & is_letter
            for p, pat in enumerate(_ZPATS):
                zposs[p] = torch.where(zl_entry, ch == ord(pat[0]), zposs[p])
            zlen = torch.where(zl_entry, 1, zlen)
            goto(zl_entry, _ST_ZLET)
            # ZSTART: skip spaces, a sign starts an offset
            goto(inside & (st == _ST_ZSTART) & (ch == ord(" ")), _ST_ZSTART)
            zs2 = inside & (st == _ST_ZSTART) & plusminus
            zsign = torch.where(zs2 & dash, -1, zsign)
            goto(zs2, _ST_ZH)
            # ZLET: more letters, or a sign after a complete pattern
            zl_more = inside & (st == _ST_ZLET) & is_letter
            for p, pat in enumerate(_ZPATS):
                ok_here = false()
                for k in range(1, len(pat)):
                    ok_here = ok_here | ((zlen == k) & (ch == ord(pat[k])))
                zposs[p] = torch.where(zl_more, zposs[p] & ok_here, zposs[p])
            zlen = torch.where(zl_more, zlen + 1, zlen)
            goto(zl_more, _ST_ZLET)
            # only UT/UTC/GMT may carry a trailing offset: ZoneId.of
            # rejects 'Z+01:00'
            zcomplete = false()
            for p, pat in enumerate(_ZPATS):
                if pat != "Z":
                    zcomplete = zcomplete | (zposs[p] & (zlen == len(pat)))
            zs3 = inside & (st == _ST_ZLET) & plusminus & zcomplete
            zsign = torch.where(zs3 & dash, -1, zsign)
            goto(zs3, _ST_ZH)
            # offset separators
            zm_c = inside & (st == _ST_ZH) & colon & (zcnt[0] > 0)
            zm_colon = zm_colon | zm_c
            goto(zm_c, _ST_ZM)
            goto(inside & (st == _ST_ZM) & colon & (zcnt[1] > 0), _ST_ZS)

        # any unhandled byte in an active row is a parse failure
        st = torch.where(inside & ~handled, _ST_BAD, new_st)

    empty = end <= start
    y, mo, dy, hh, mi, ss, frac = acc
    cy, cmo, cdy, chh, cmi, css, cfrac = cnt

    # structural validity: where the DFA may legally stop
    ok_end = ((st == _ST_YEAR) & (cy > 0)) | \
             ((st == _ST_MON) & (cmo > 0)) | \
             ((st == _ST_DAY) & (cdy > 0))
    if date_only:
        ok_end = ok_end | (st == _ST_DONE)
    else:
        zlet_done = false()
        for p, pat in enumerate(_ZPATS):
            zlet_done = zlet_done | (zposs[p] & (zlen == len(pat)))
        ok_end = ok_end | \
            ((st == _ST_HOUR) & (chh > 0)) | \
            ((st == _ST_MIN) & (cmi > 0)) | \
            ((st == _ST_SEC) & (css > 0)) | \
            (st == _ST_FRAC) | \
            ((st == _ST_ZLET) & zlet_done) | \
            ((st == _ST_ZH) & (zcnt[0] >= 1) & (zcnt[0] <= 2)) | \
            ((st == _ST_ZM) & ((zcnt[1] == 2) |
                               (zm_colon & (zcnt[1] == 1)))) | \
            ((st == _ST_ZS) & (zcnt[2] == 2))

    # field ranges. Spark's isValidDigits: the year needs 4..7 digits for
    # dates, 4..6 for timestamps (a long holds about +-300k years of
    # micros); every other field 1..2 digits
    ok_year = (cy >= 4) & (cy <= (7 if date_only else 6))
    if not date_only:
        ok_year = ok_year | (time_only & (cnt[3] > 0))
    ok_counts = ok_year & (cmo <= 2) & (cdy <= 2) & (chh <= 2) & \
        (cmi <= 2) & (css <= 2)
    mo_f = torch.where(cmo > 0, mo, 1)
    dy_f = torch.where(cdy > 0, dy, 1)
    ok_ranges = (mo_f >= 1) & (mo_f <= 12) & (dy_f >= 1) & \
        (hh <= 23) & (mi <= 59) & (ss <= 59)
    # day-of-month check through the civil calendar (leap-exact)
    yy = (ysign * y).to(torch.int64)
    days = days_from_civil(yy, mo_f.to(torch.int64), dy_f.to(torch.int64))
    ry, rm, rd = civil_from_days(days)
    ok_day = (ry == yy) & (rm == mo_f) & (rd == dy_f)

    has_zone = (st >= _ST_ZH) & (st <= _ST_ZLET)
    zoff_us = (zsign.to(torch.int64) *
               (zacc[0].to(torch.int64) * 3600 +
                zacc[1].to(torch.int64) * 60 + zacc[2].to(torch.int64))
               * 1_000_000)
    ok_zone = torch.where(has_zone, zoff_us.abs() <= 18 * 3600 * 1_000_000,
                          True)

    pow10 = torch.tensor([10 ** k for k in range(7)], dtype=torch.int32,
                         device=dev)
    frac_us = (frac * pow10[(6 - cfrac.clamp(max=6)).clamp(min=0)
                            .to(torch.int64)]).to(torch.int64)
    tod_us = (hh.to(torch.int64) * 3_600_000_000 +
              mi.to(torch.int64) * 60_000_000 +
              ss.to(torch.int64) * 1_000_000 + frac_us)
    # overflow guards (Spark's overflow exceptions surface as NULL): a
    # date's days must fit int32, a timestamp's micros int64, bounded
    # 8192 us inside the limit by a float64 shadow computation so that
    # the +-18 h zone offset cannot wrap either
    if date_only:
        ok_range = (days >= -(2**31)) & (days <= 2**31 - 1)
    else:
        approx = (days.to(torch.float64) * 86_400_000_000.0
                  + tod_us.to(torch.float64)
                  - zoff_us.to(torch.float64))
        ok_range = approx.abs() <= (2.0**63 - 1.0) - 8192.0
    ok = ~empty & ok_end & ok_counts & ok_ranges & ok_day & ok_zone & \
        (cfrac <= 9) & ok_range
    if not date_only:
        ok = ok & torch.where(time_only, cnt[3] > 0, True)
    return dict(ok=ok, days=days, tod_us=tod_us, has_zone=has_zone,
                zoff_us=zoff_us,
                time_only=false() if date_only else time_only)


@traced("cast_strings.cast_to_date")
def cast_to_date(col: Column) -> Column:
    """STRING -> DATE (TIMESTAMP_DAYS), Spark stringToDate semantics."""
    expects(col.dtype.id == TypeId.STRING, "cast_to_date needs STRING")
    mat, lens = byte_matrix(col, max(max_length(col), 1))
    p = _parse_datetime_matrix(mat, lens, date_only=True)
    out_valid = p["ok"] & col.valid_bool()
    return Column(TIMESTAMP_DAYS, col.size, p["days"].to(torch.int32),
                  bitmask.pack(out_valid))


def _today(default_tz: str) -> int:
    """Days since the epoch of today's date in ``default_tz``."""
    import datetime as pydt
    from zoneinfo import ZoneInfo
    tz = pydt.timezone.utc if default_tz in _UTC_IDS else ZoneInfo(default_tz)
    return (pydt.datetime.now(tz).date() - pydt.date(1970, 1, 1)).days


@traced("cast_strings.cast_to_timestamp")
def cast_to_timestamp(col: Column, default_tz: str = "UTC") -> Column:
    """STRING -> TIMESTAMP_MICROSECONDS, Spark stringToTimestamp semantics.

    Rows with an explicit offset/UTC marker use it; rows without one are
    interpreted in ``default_tz`` (the session timezone) through the
    zone's local -> UTC table (gaps and overlaps as java.time resolves
    them). Time-only rows take today's date in ``default_tz``.
    """
    from .timezone import load_zone, local_to_utc_us
    expects(col.dtype.id == TypeId.STRING, "cast_to_timestamp needs STRING")
    mat, lens = byte_matrix(col, max(max_length(col), 1))
    p = _parse_datetime_matrix(mat, lens, date_only=False)
    days = p["days"]
    if bool(p["time_only"].any()):
        days = torch.where(p["time_only"], _today(default_tz), days)
    local_us = days * _US_PER_DAY + p["tod_us"]
    utc_explicit = local_us - p["zoff_us"]
    if default_tz in _UTC_IDS:
        utc_default = local_us
    else:
        utc_default = local_to_utc_us(local_us,
                                      load_zone(default_tz, col.device))
    out = torch.where(p["has_zone"], utc_explicit, utc_default)
    out_valid = p["ok"] & col.valid_bool()
    return Column(TIMESTAMP_MICROSECONDS, col.size, out,
                  bitmask.pack(out_valid))


# ---------------------------------------------------------------------------
# DECIMAL -> string, and format_number (grouped formatting)
# ---------------------------------------------------------------------------

@traced("cast_strings.cast_decimal_to_string")
def cast_decimal_to_string(col: Column) -> Column:
    """DECIMAL32/64 -> STRING, Spark Decimal.toString semantics: plain
    decimal with exactly ``-scale`` fraction digits (value = unscaled *
    10**scale), minus sign, no grouping; positive scales multiply out to
    trailing zeros."""
    expects(col.dtype.id in (TypeId.DECIMAL32, TypeId.DECIMAL64),
            "cast_decimal_to_string needs a DECIMAL32/64")
    scale = col.dtype.scale
    v = col.data.to(torch.int64)
    dmat, neg = _digit_matrix_and_sign(v)
    frac = max(-scale, 0)
    md = _MAX_I64_DIGITS

    # each row is [sign][int digits]['.'][frac digits], frac a constant
    ndig = _digit_count(dmat)
    if scale > 0:
        ndig = torch.where(v != 0, ndig + scale, ndig)
    int_digits = (ndig - frac).clamp(min=1)   # zero-pads "0.xx" forms
    sw = neg.to(torch.int32)
    total = sw + int_digits + (1 + frac if frac else 0)

    w = max(int(total.max()), 1) if col.size else 1
    pos = _positions(w, v.device)
    digit_idx = pos - sw[:, None]  # 0 = the most significant digit
    in_int = (pos >= sw[:, None]) & (digit_idx < int_digits[:, None])
    dot_col = sw[:, None] + int_digits[:, None]
    # output digit position -> column of the right-aligned 20-wide matrix
    # (the dot takes one slot; scale > 0 reads virtual zeros past the end)
    k = torch.where(in_int, digit_idx, digit_idx - 1)
    src = md - (int_digits[:, None] + frac) + k + max(scale, 0)
    src_ok = (src >= 0) & (src < md)
    gathered = torch.gather(dmat, 1, src.clamp(0, md - 1).to(torch.int64))
    gathered = torch.where(src_ok, gathered + ord("0"), ord("0"))
    out = torch.where(in_int, gathered, 0)
    if frac:
        out = torch.where(pos == dot_col, ord("."), out)
        out = torch.where((pos > dot_col) & (pos < total[:, None]),
                          gathered, out)
    out = torch.where((pos == 0) & neg[:, None], ord("-"), out)
    return strings_from_matrix(out, total, col.valid_bool())


def _group_thousands(int_digits: str) -> str:
    out = []
    for i, ch in enumerate(reversed(int_digits)):
        if i and i % 3 == 0:
            out.append(",")
        out.append(ch)
    return "".join(reversed(out))


@traced("cast_strings.format_number")
def format_number(col: Column, d: int) -> Column:
    """Spark ``format_number(expr, d)``: HALF_EVEN rounding to ``d`` places
    with comma thousands grouping (java.text.DecimalFormat semantics).

    Java 8+ DecimalFormat rounds by the EXACT binary value of the double
    (ties only exist when the binary expansion terminates at the tie
    digit), so the host rounding here uses decimal.Decimal(float), the
    exact expansion, with ROUND_HALF_EVEN, which reproduces it bit for
    bit. The rows are formatted on the host."""
    import decimal as _dec
    dev = col.device
    if d < 0:  # Spark: negative d yields NULL rows, not an error
        return Column.strings_from_list([None] * col.size, device=dev)
    tid = col.dtype.id

    def fmt(exact: "_dec.Decimal") -> str:
        # enough precision for a full float64 expansion (~767 digits) plus
        # the requested places: the default 28-digit context would raise
        # InvalidOperation on wide values
        with _dec.localcontext() as ctx:
            ctx.prec = 800 + d
            q = exact.quantize(_dec.Decimal(1).scaleb(-d),
                               rounding=_dec.ROUND_HALF_EVEN)
        sign, digits, exp = q.as_tuple()
        ds = "".join(map(str, digits)).rjust(max(d + 1, 1), "0")
        ipart = ds[:len(ds) + exp] if exp else ds
        fpart = ds[len(ds) + exp:] if exp else ""
        body = _group_thousands(ipart or "0") + ("." + fpart if d else "")
        # Java DecimalFormat keeps the operand's sign even on a rounded
        # zero ("-0.00"), so no is-zero suppression here
        return ("-" if sign else "") + body

    valid = col.valid_bool().cpu().numpy()
    rows: List[Optional[str]] = []
    if tid in (TypeId.FLOAT32, TypeId.FLOAT64):
        vals = col.data.cpu().numpy().astype(np.float64)
        for i, v in enumerate(vals):
            if not valid[i]:
                rows.append(None)
            elif np.isnan(v):
                rows.append("NaN")
            elif np.isinf(v):
                rows.append("-Infinity" if v < 0 else "Infinity")
            else:
                rows.append(fmt(_dec.Decimal(float(v))))
    elif col.dtype.is_integral or tid in (TypeId.DECIMAL32,
                                          TypeId.DECIMAL64):
        vals = col.data.to(torch.int64).cpu().numpy()
        scale = col.dtype.scale if col.dtype.is_decimal else 0
        for i, v in enumerate(vals):
            rows.append(fmt(_dec.Decimal(int(v)).scaleb(scale))
                        if valid[i] else None)
    else:
        fail(f"format_number does not support {col.dtype!r}")
    return Column.strings_from_list(rows, device=dev)
