"""Float -> string with Java ``Double.toString``/``Float.toString`` semantics.

Port of ``spark_rapids_jni_tpu/ops/float_to_string.py``: Ryu's shortest
round-tripping digits (Adams 2018) as branch-free vector algebra, with
the 128-bit fixed-point tables generated at import from exact Python
integers, and Java's layout:

- plain decimal when the scientific exponent is in [-3, 6], otherwise
  ``d.dddE±x`` with at least one fraction digit ("1.0E10");
- ``0.0`` / ``-0.0`` / ``NaN`` / ``Infinity`` / ``-Infinity``.

torch has no unsigned 64-bit arithmetic, so every 64-bit magnitude is an
int64 lane holding the uint64 bits (``utils/int128.py``): logical shifts
are masked arithmetic ones, a 19-digit ``vr`` (past 2^63) divides by ten
as ``udiv10``, and the 64 x 64 -> 128 products ride ``mul_u64``. Specials
are classified from the bit pattern, so subnormals print exactly.

The output bytes are built on the tensor's device: each row's length
follows from its sign, digit count and exponent, and each output byte is
one gather from the digit matrix or a masked select of '-', '.', 'E', an
exponent digit or a special's letters (the reference assembles each row
in a host loop).
"""

from __future__ import annotations

import torch

from ..columnar import Column
from ..columnar.strings import strings_from_matrix
from ..obs import traced
from ..types import TypeId
from ..utils import int128 as i128
from ..utils.errors import expects
from ..utils.floatbits import float32_to_bits, float64_to_bits

# ---------------------------------------------------------------------------
# Table generation (exact integer math, once at import)
# ---------------------------------------------------------------------------

_D_POW5_BITS = 125        # DOUBLE_POW5_BITCOUNT
_D_POW5_INV_BITS = 125    # DOUBLE_POW5_INV_BITCOUNT
_F_POW5_BITS = 61
_F_POW5_INV_BITS = 59
_M64 = (1 << 64) - 1


def _pow5bits(e: int) -> int:
    return ((e * 1217359) >> 19) + 1


def _gen_double_tables():
    inv_lo, inv_hi, p_lo, p_hi = [], [], [], []
    for q in range(292):
        v = (1 << (_pow5bits(q) - 1 + _D_POW5_INV_BITS)) // (5 ** q) + 1
        inv_lo.append(i128.as_lane(v & _M64))
        inv_hi.append(i128.as_lane(v >> 64))
    for i in range(326):
        shift = _pow5bits(i) - _D_POW5_BITS
        v = (5 ** i) >> shift if shift >= 0 else (5 ** i) << -shift
        p_lo.append(i128.as_lane(v & _M64))
        p_hi.append(i128.as_lane(v >> 64))
    return inv_lo, inv_hi, p_lo, p_hi


def _gen_float_tables():
    inv, pow_ = [], []
    for q in range(31):
        inv.append((1 << (_pow5bits(q) - 1 + _F_POW5_INV_BITS))
                   // (5 ** q) + 1)
    for i in range(48):
        shift = _pow5bits(i) - _F_POW5_BITS
        pow_.append((5 ** i) >> shift if shift >= 0 else (5 ** i) << -shift)
    return inv, pow_


_TABLES = dict(zip(("d_inv_lo", "d_inv_hi", "d_p_lo", "d_p_hi"),
                   _gen_double_tables()))
_TABLES.update(zip(("f_inv", "f_pow"), _gen_float_tables()))
_TABLES["pow5"] = [5 ** k for k in range(23)]


def _table(name: str, dev: torch.device) -> torch.Tensor:
    return torch.tensor(_TABLES[name], dtype=torch.int64, device=dev)


# ---------------------------------------------------------------------------
# Ryu core, float64
# ---------------------------------------------------------------------------

def _log10pow2(e):
    return (e * 78913) >> 18


def _log10pow5(e):
    return (e * 732923) >> 20


def _pow5bits_v(e):
    return ((e * 1217359) >> 19) + 1


def _mul_shift64(m, mul_lo, mul_hi, j):
    """(m * (hi:lo)) >> j for 64 <= j < 128, per-row uint64 lanes."""
    b0 = i128.mul_u64(m, mul_lo)
    b2 = i128.mul_u64(m, mul_hi)
    lo = b2.lo + b0.hi
    hi = b2.hi + i128.ult(lo, b0.hi).to(torch.int64)
    s = j - 64
    return i128.sll_v(hi, 64 - s) | i128.srl_v(lo, s)


def _multiple_of_pow5(v, q, pow5):
    """v % 5^q == 0 with per-row q (q <= 22; v below 2^63)."""
    return torch.remainder(v, pow5[q.clamp(0, 22)]) == 0


def _remove_digits(vr, vp, vm, vr_tz, vm_tz, last_removed, e10, accept,
                   rounds: int):
    """Ryu's digit-removal loop as a fixed masked loop of ``rounds``
    steps, then the final rounding -> (digits, exp10 of the last
    digit)."""
    any_tz = vm_tz | vr_tz
    removed = torch.zeros_like(e10)
    for _ in range(rounds):
        vp10, vm10, vr10 = (i128.udiv10(vp), i128.udiv10(vm),
                            i128.udiv10(vr))
        vm_zero = (vm - vm10 * 10) == 0
        go = vp10 > vm10
        go_tz = any_tz & vm_tz & ~go & vm_zero
        act = go | go_tz
        vm_tz = torch.where(act, vm_tz & vm_zero, vm_tz)
        vr_tz = torch.where(act, vr_tz & (last_removed == 0), vr_tz)
        last_removed = torch.where(act, vr - vr10 * 10, last_removed)
        vr = torch.where(act, vr10, vr)
        vp = torch.where(act, vp10, vp)
        vm = torch.where(act, vm10, vm)
        removed = removed + act.to(torch.int64)

    # round-to-even tweak for exactly-half cases
    last_removed = torch.where(
        any_tz & vr_tz & (last_removed == 5) & ((vr & 1) == 0),
        4, last_removed)
    round_up_tz = ((vr == vm) & (~accept | ~vm_tz)) | (last_removed >= 5)
    out_tz = vr + round_up_tz.to(torch.int64)
    out_plain = vr + ((vr == vm) | (last_removed >= 5)).to(torch.int64)
    return torch.where(any_tz, out_tz, out_plain), e10 + removed


def _d2d(bits):
    """Ryu shortest-decimal for float64 bit patterns (sign clear, int64).

    Returns (digits, exp10 of the LAST digit) for finite nonzero inputs
    (specials are the caller's)."""
    dev = bits.device
    pow5 = _table("pow5", dev)
    ieee_m = bits & ((1 << 52) - 1)
    ieee_e = (bits >> 52) & 0x7FF

    subnormal = ieee_e == 0
    e2 = torch.where(subnormal, 1, ieee_e) - 1075 - 2
    m2 = torch.where(subnormal, ieee_m, ieee_m | (1 << 52))
    accept = (m2 & 1) == 0
    mv = m2 * 4
    mm_shift = ((ieee_m != 0) | (ieee_e <= 1)).to(torch.int64)
    mm = mv - 1 - mm_shift

    # --- positive-exponent path (e2 >= 0) -------------------------------
    e2p = e2.clamp(min=0)
    q_p = _log10pow2(e2p) - (e2p > 3).to(torch.int64)
    k_p = _D_POW5_INV_BITS + _pow5bits_v(q_p) - 1
    j_p = -e2p + q_p + k_p
    qc = q_p.clamp(0, 291)
    lo, hi = _table("d_inv_lo", dev)[qc], _table("d_inv_hi", dev)[qc]
    vr_p = _mul_shift64(mv, lo, hi, j_p)
    vp_p = _mul_shift64(mv + 2, lo, hi, j_p)
    vm_p = _mul_shift64(mm, lo, hi, j_p)
    small_p = q_p <= 21
    mv_mod5 = torch.remainder(mv, 5)
    vr_tz_p = small_p & (mv_mod5 == 0) & _multiple_of_pow5(mv, q_p, pow5)
    vm_tz_p = small_p & (mv_mod5 != 0) & accept & \
        _multiple_of_pow5(mm, q_p, pow5)
    vp_dec_p = small_p & (mv_mod5 != 0) & ~accept & \
        _multiple_of_pow5(mv + 2, q_p, pow5)
    vp_p = vp_p - vp_dec_p.to(torch.int64)

    # --- negative-exponent path (e2 < 0) --------------------------------
    e2n = (-e2).clamp(min=0)
    q_n = _log10pow5(e2n) - (e2n > 1).to(torch.int64)
    i_n = (e2n - q_n).clamp(min=0)
    k_n = _pow5bits_v(i_n) - _D_POW5_BITS
    j_n = q_n - k_n
    ic = i_n.clamp(0, 325)
    lo, hi = _table("d_p_lo", dev)[ic], _table("d_p_hi", dev)[ic]
    vr_n = _mul_shift64(mv, lo, hi, j_n)
    vp_n = _mul_shift64(mv + 2, lo, hi, j_n)
    vm_n = _mul_shift64(mm, lo, hi, j_n)
    q_le1 = q_n <= 1
    low_bits = (torch.ones_like(q_n) << q_n.clamp(0, 62)) - 1
    vr_tz_n = q_le1 | ((q_n < 63) & ((mv & low_bits) == 0))
    vm_tz_n = q_le1 & accept & (mm_shift == 1)
    vp_n = vp_n - (q_le1 & ~accept).to(torch.int64)

    pos = e2 >= 0
    return _remove_digits(
        torch.where(pos, vr_p, vr_n), torch.where(pos, vp_p, vp_n),
        torch.where(pos, vm_p, vm_n), torch.where(pos, vr_tz_p, vr_tz_n),
        torch.where(pos, vm_tz_p, vm_tz_n), torch.zeros_like(mv),
        torch.where(pos, q_p, q_n + e2), accept, 18)  # 19 digits: 18 steps


def _f2d(bits32):
    """Ryu shortest-decimal for float32 bit patterns (sign clear) ->
    (digits, exp10 of the last digit)."""
    dev = bits32.device
    pow5 = _table("pow5", dev)
    f_inv, f_pow = _table("f_inv", dev), _table("f_pow", dev)
    bits = bits32.to(torch.int64)
    ieee_m = bits & ((1 << 23) - 1)
    ieee_e = (bits >> 23) & 0xFF

    subnormal = ieee_e == 0
    e2 = torch.where(subnormal, 1, ieee_e) - 150 - 2
    m2 = torch.where(subnormal, ieee_m, ieee_m | (1 << 23))
    accept = (m2 & 1) == 0
    mv = m2 * 4
    mm_shift = ((ieee_m != 0) | (ieee_e <= 1)).to(torch.int64)
    mm = mv - 1 - mm_shift

    def mul_shift32(m, factor, shift):
        # m < 2^26 and factor < 2^62: both partial products fit int64
        f_lo = factor & 0xFFFFFFFF
        f_hi = factor >> 32
        s = (shift - 32).clamp(0, 63)
        return (((m * f_lo) >> 32) + m * f_hi) >> s

    e2p = e2.clamp(min=0)
    q_p = _log10pow2(e2p) - (e2p > 3).to(torch.int64)
    k_p = _F_POW5_INV_BITS + _pow5bits_v(q_p) - 1
    j_p = -e2p + q_p + k_p
    inv = f_inv[q_p.clamp(0, 30)]
    vr_p = mul_shift32(mv, inv, j_p)
    vp_p = mul_shift32(mv + 2, inv, j_p)
    vm_p = mul_shift32(mm, inv, j_p)
    # f2s extra: if q != 0 and (vp-1)/10 <= vm/10, the last removed digit
    # comes from the q-1 tables
    q_p1 = (q_p - 1).clamp(min=0)
    j_p1 = -e2p + q_p1 + _F_POW5_INV_BITS + _pow5bits_v(q_p1) - 1
    need_fix_p = (q_p != 0) & ((vp_p - 1) // 10 <= vm_p // 10)
    vr_fix_p = mul_shift32(mv, f_inv[q_p1.clamp(0, 30)], j_p1)
    last_p = torch.where(need_fix_p, torch.remainder(vr_fix_p, 10), 0)
    small_p = q_p <= 9
    mv_mod5 = torch.remainder(mv, 5)
    vr_tz_p = small_p & (mv_mod5 == 0) & _multiple_of_pow5(mv, q_p, pow5)
    vm_tz_p = small_p & (mv_mod5 != 0) & accept & \
        _multiple_of_pow5(mm, q_p, pow5)
    vp_dec_p = small_p & (mv_mod5 != 0) & ~accept & \
        _multiple_of_pow5(mv + 2, q_p, pow5)
    vp_p = vp_p - vp_dec_p.to(torch.int64)

    e2n = (-e2).clamp(min=0)
    q_n = _log10pow5(e2n) - (e2n > 1).to(torch.int64)
    i_n = (e2n - q_n).clamp(min=0)
    j_n = q_n - (_pow5bits_v(i_n) - _F_POW5_BITS)
    fp = f_pow[i_n.clamp(0, 47)]
    vr_n = mul_shift32(mv, fp, j_n)
    vp_n = mul_shift32(mv + 2, fp, j_n)
    vm_n = mul_shift32(mm, fp, j_n)
    q_n1 = (q_n - 1).clamp(min=0)
    i_n1 = i_n + 1
    j_n1 = q_n1 - (_pow5bits_v(i_n1) - _F_POW5_BITS)
    need_fix_n = (q_n != 0) & ((vp_n - 1) // 10 <= vm_n // 10)
    vr_fix_n = mul_shift32(mv, f_pow[i_n1.clamp(0, 47)], j_n1)
    last_n = torch.where(need_fix_n, torch.remainder(vr_fix_n, 10), 0)
    q_le1 = q_n <= 1
    low_bits = (torch.ones_like(q_n) << q_n.clamp(0, 30)) - 1
    vr_tz_n = q_le1 | ((q_n < 31) & ((mv & low_bits) == 0))
    vm_tz_n = q_le1 & accept & (mm_shift == 1)
    vp_n = vp_n - (q_le1 & ~accept).to(torch.int64)

    pos = e2 >= 0
    return _remove_digits(
        torch.where(pos, vr_p, vr_n), torch.where(pos, vp_p, vp_n),
        torch.where(pos, vm_p, vm_n), torch.where(pos, vr_tz_p, vr_tz_n),
        torch.where(pos, vm_tz_p, vm_tz_n), torch.where(pos, last_p, last_n),
        torch.where(pos, q_p, q_n + e2), accept, 10)


# ---------------------------------------------------------------------------
# Java formatting + column entry point
# ---------------------------------------------------------------------------

_MAXD = 17
_WIDTH = 26  # the longest form, "-1.2345678901234567E-308", has 24 bytes
# the specials' bodies: NaN, Infinity, 0.0 (a sign goes before the last two)
_SPECIALS = (b"NaN", b"Infinity", b"0.0")


def _extract_digits(v):
    """Digits (< 10^17, int64) -> (digit matrix most-significant-first
    (N, 17) uint8, count)."""
    ds = []
    rem = v
    for _ in range(_MAXD):
        ds.append(torch.remainder(rem, 10).to(torch.uint8))
        rem = rem // 10
    mat = torch.stack(ds[::-1], dim=1)
    cnt = torch.ones_like(v, dtype=torch.int32)
    for k in range(1, _MAXD):
        cnt = cnt + (v >= 10 ** k).to(torch.int32)
    return mat, cnt


def _java_layout(sign, special, dmat, dcnt, exp):
    """Java's Double.toString bytes of every row, built with tensor ops
    -> ((N, 26) uint8, lengths).

    ``special`` is -1 for a finite nonzero row, else the index of its
    body in ``_SPECIALS``. A finite row is [sign] mantissa [E exponent]:
    the mantissa is the plain decimal expansion of the digits at
    exponent ``e`` (``e = 0`` in scientific form) with at least one
    digit each side of the '.', so its byte p holds digit
    ``e - L_int + 1 + p - (p > L_int)`` of the digit string (a '0' off
    either end), where L_int = max(e, 0) + 1 is the integer part's
    length."""
    dev = dmat.device
    n = dmat.shape[0]
    sci = (exp < -3) | (exp > 6)
    e = torch.where(sci, 0, exp)
    l_int = e.clamp(min=0) + 1
    l_mant = l_int + 1 + (dcnt - 1 - e).clamp(min=1)
    e_neg = (exp < 0).to(torch.int32)
    e_abs = exp.abs()
    e_digits = 1 + (e_abs >= 10).to(torch.int32) + \
        (e_abs >= 100).to(torch.int32)
    body = l_mant + torch.where(sci, 1 + e_neg + e_digits, 0)

    is_special = special >= 0
    spec_idx = special.clamp(min=0)
    spec_len = torch.tensor([len(s) for s in _SPECIALS], dtype=torch.int32,
                            device=dev)[spec_idx]
    body = torch.where(is_special, spec_len, body)
    signed = sign & (special != 0)  # NaN prints no sign
    sw = signed.to(torch.int32)

    p = torch.arange(_WIDTH, dtype=torch.int32, device=dev)[None, :] - \
        sw[:, None]
    # mantissa digits
    i = (e - l_int + 1)[:, None] + p - (p > l_int[:, None]).to(torch.int32)
    have = (i >= 0) & (i < dcnt[:, None])
    src = (_MAXD - dcnt)[:, None] + i
    dig = torch.gather(dmat, 1, src.clamp(0, _MAXD - 1).to(torch.int64))
    out = torch.where(have, dig, 0) + ord("0")
    out = torch.where(p == l_int[:, None], ord("."), out)
    # scientific suffix: 'E', '-', the exponent's digits
    sci2 = sci[:, None]
    at_e = p == l_mant[:, None]
    out = torch.where(sci2 & at_e, ord("E"), out)
    out = torch.where(sci2 & (p == (l_mant + 1)[:, None]) & (exp < 0)[:, None],
                      ord("-"), out)
    first_ed = (l_mant + 1 + e_neg)[:, None]
    k = (e_digits[:, None] - 1 - (p - first_ed)).clamp(0, 2)
    pow10 = torch.tensor([1, 10, 100], dtype=torch.int32, device=dev)
    ed = torch.remainder(e_abs[:, None] // pow10[k.to(torch.int64)], 10)
    out = torch.where(sci2 & (p >= first_ed), ed + ord("0"), out)
    # specials
    table = torch.zeros((len(_SPECIALS), 8), dtype=torch.int32, device=dev)
    for r, s in enumerate(_SPECIALS):
        table[r, :len(s)] = torch.tensor(list(s), dtype=torch.int32)
    spec = table[spec_idx[:, None].to(torch.int64),
                 p.clamp(0, 7).to(torch.int64)]
    out = torch.where(is_special[:, None], spec, out)
    out = torch.where(p < 0, ord("-"), out)
    return out.to(torch.uint8), sw + body


@traced("float_to_string.cast_float_to_string")
def cast_float_to_string(col: Column) -> Column:
    """FLOAT32/FLOAT64 -> STRING, Java toString formatting (Spark cast)."""
    expects(col.dtype.id in (TypeId.FLOAT32, TypeId.FLOAT64),
            "cast_float_to_string needs FLOAT32/FLOAT64")
    if col.dtype.id == TypeId.FLOAT64:
        bits = float64_to_bits(col.data)
        sign = bits < 0
        mag = bits & ((1 << 63) - 1)
        exp_field = mag >> 52
        frac_field = mag & ((1 << 52) - 1)
        is_inf_or_nan = exp_field == 0x7FF
        digits, e10 = _d2d(mag)
    else:
        bits = float32_to_bits(col.data).to(torch.int64)
        sign = bits < 0
        mag = bits & ((1 << 31) - 1)
        exp_field = mag >> 23
        frac_field = mag & ((1 << 23) - 1)
        is_inf_or_nan = exp_field == 0xFF
        digits, e10 = _f2d(mag)
    special = torch.full_like(mag, -1, dtype=torch.int32)
    special = torch.where(mag == 0, 2, special)
    special = torch.where(is_inf_or_nan, (frac_field == 0).to(torch.int32),
                          special)
    # a special's digits are garbage: give it a small valid number
    digits = torch.where(special >= 0, 1, digits)
    dmat, dcnt = _extract_digits(digits)
    # scientific exponent of the value: the first digit is 10^exp
    exp = torch.where(special >= 0, 0, e10 + dcnt - 1).to(torch.int32)
    mat, lens = _java_layout(sign, special, dmat, dcnt, exp)
    return strings_from_matrix(mat, lens, col.valid_bool())
