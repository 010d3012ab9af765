"""128-bit integer arithmetic on (hi, lo) lane pairs.

Port of ``spark_rapids_jni_tpu/utils/int128.py``. Spark decimal math
needs 128-bit intermediates (the product of two 64-bit unscaled values,
a numerator scaled by 10^k). The reference keeps the lanes as uint64;
torch's uint64 tensors have no ``>>``, ``<<`` or ``+``, so here each
lane is an int64 tensor holding the uint64 BIT PATTERN, and:

- an unsigned compare flips the sign bit of both sides, then compares
  signed (:func:`ult`, :func:`uge`);
- an unsigned carry out of a lane sum is ``ult(a + b, a)`` (int64 adds
  wrap mod 2^64, the bit pattern of the uint64 sum);
- a logical right shift masks off the sign bits an arithmetic shift
  drags in (:func:`srl`);
- ``mul_u64`` multiplies 32-bit halves in int64; a partial product of
  two halves can pass 2^63 and wraps, which is its uint64 bit pattern.

Everything is elementwise and branch-free; ``divmod_u64`` is a Python
loop of 128 shift-subtract steps of tensor ops. ``udiv10`` and
``udivmod_small`` divide a uint64 by a small constant in two int64
divisions (the logical half, then the dropped bit), and ``srl_v`` /
``sll_v`` shift by per-lane amounts, for Ryu and the casts.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

_SIGN = -(1 << 63)       # int64 with only the sign bit set
_LO32 = 0xFFFFFFFF

IntLike = Union[int, torch.Tensor]


class U128(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def as_lane(u: int) -> int:
    """A uint64 Python int as the int64 holding its bit pattern."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= (1 << 63) else u


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the uint64 bit patterns by ``0 <= k < 64``."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def srl_v(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Logical right shift by per-lane amounts ``0 <= k < 64``."""
    k = k.clamp(0, 63)
    return (x >> k) & ~(torch.full_like(x, _SIGN) >> k << 1)


def sll_v(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Left shift by per-lane amounts ``0 <= k <= 64``; 64 gives 0."""
    return torch.where(k >= 64, 0, x << k.clamp(0, 63))


def udiv10(x: torch.Tensor) -> torch.Tensor:
    """Unsigned floor(x / 10) of uint64 bit patterns: halve logically,
    then the half (below 2^63) divides by 5 as int64."""
    return srl(x, 1) // 5


def udivmod_small(x: torch.Tensor, d: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned (x // d, x % d) of uint64 bit patterns by ``1 <= d < 2^62``:
    divide the logical half, then the dropped bit and twice the remainder
    give at most one more unit of the quotient."""
    h = srl(x, 1)
    q, r = h // d, h % d
    r2 = 2 * r + (x & 1)
    up = r2 >= d
    return 2 * q + up.to(torch.int64), torch.where(up, r2 - d, r2)


def mul_add_u64(a: IntLike, b: IntLike, c: IntLike
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned a * b + c over uint64 bit patterns: (the low 64 bits,
    True where the exact result passes 2^64 - 1)."""
    p = mul_u64(a, b)
    lo = p.lo + c
    return lo, (p.hi != 0) | ult(lo, p.lo)


def ult(a: IntLike, b: IntLike) -> torch.Tensor:
    """Unsigned a < b over uint64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def uge(a: IntLike, b: IntLike) -> torch.Tensor:
    """Unsigned a >= b over uint64 bit patterns."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


def from_i64(x: torch.Tensor) -> U128:
    """Sign-extend int64 lanes to 128-bit two's complement."""
    x = x.to(torch.int64)
    return U128(x >> 63, x)


def to_i64(v: U128) -> torch.Tensor:
    return v.lo


def fits_i64(v: U128) -> torch.Tensor:
    """True where the 128-bit value is representable in int64."""
    return v.hi == (v.lo >> 63)


def add(a: U128, b: U128) -> U128:
    lo = a.lo + b.lo
    carry = ult(lo, a.lo).to(torch.int64)
    return U128(a.hi + b.hi + carry, lo)


def neg(a: U128) -> U128:
    lo = ~a.lo + 1
    return U128(~a.hi + (lo == 0).to(torch.int64), lo)


def is_neg(a: U128) -> torch.Tensor:
    return a.hi < 0


def select(cond: torch.Tensor, a: U128, b: U128) -> U128:
    """Lane-wise ``a`` where ``cond``, else ``b``."""
    return U128(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def abs_(a: U128) -> Tuple[U128, torch.Tensor]:
    n = is_neg(a)
    return select(n, neg(a), a), n


def mul_u64(a: IntLike, b: IntLike) -> U128:
    """Unsigned 64 x 64 -> 128 via 32-bit schoolbook partial products."""
    ah, al = srl(a, 32) if torch.is_tensor(a) else a >> 32, a & _LO32
    bh, bl = srl(b, 32) if torch.is_tensor(b) else b >> 32, b & _LO32
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = srl(ll, 32) + (lh & _LO32) + (hl & _LO32)
    lo = (ll & _LO32) | (mid << 32)
    hi = hh + srl(lh, 32) + srl(hl, 32) + srl(mid, 32)
    return U128(hi, lo)


def mul_i64(a: torch.Tensor, b: torch.Tensor) -> U128:
    """Signed 64 x 64 -> 128 (two's complement result). The magnitude of
    -2^63 is its own bit pattern, 2^63 unsigned."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    mag = mul_u64(torch.where(a < 0, -a, a), torch.where(b < 0, -b, b))
    return select((a < 0) ^ (b < 0), neg(mag), mag)


def mul_small(a: U128, m: IntLike) -> Tuple[U128, torch.Tensor]:
    """Unsigned multiply by a u64 scalar or vector; returns (product,
    overflowed)."""
    p_lo = mul_u64(a.lo, m)
    p_hi = mul_u64(a.hi, m)
    hi = p_lo.hi + p_hi.lo
    overflow = (p_hi.hi != 0) | ult(hi, p_lo.hi)
    return U128(hi, p_lo.lo), overflow


def shl1(a: U128) -> U128:
    return U128((a.hi << 1) | srl(a.lo, 63), a.lo << 1)


def geq(a: U128, b: U128) -> torch.Tensor:
    """Unsigned a >= b."""
    return ult(b.hi, a.hi) | ((a.hi == b.hi) & uge(a.lo, b.lo))


def sub(a: U128, b: U128) -> U128:
    return add(a, neg(b))


def divmod_u64(a: U128, d: IntLike) -> Tuple[U128, torch.Tensor]:
    """Unsigned 128 / 64 -> (128-bit quotient, 64-bit remainder), binary
    long division: 128 shift-subtract steps."""
    d = torch.as_tensor(d, dtype=torch.int64, device=a.lo.device)
    zeros = torch.zeros_like(a.lo)
    q_hi, q_lo, rem, a_hi, a_lo = zeros, zeros, zeros, a.hi, a.lo
    for _ in range(128):
        bit = srl(a_hi, 63)
        a_hi = (a_hi << 1) | srl(a_lo, 63)
        a_lo = a_lo << 1
        # rem < d before the shift, so the shifted value has 65 bits: a
        # set top bit means it is >= 2^64 > d, and the wrapped
        # subtraction below is then exact
        top = rem < 0
        rem = (rem << 1) | bit
        take = top | uge(rem, d)
        rem = torch.where(take, rem - d, rem)
        q_hi = (q_hi << 1) | srl(q_lo, 63)
        q_lo = (q_lo << 1) | take.to(torch.int64)
    return U128(q_hi, q_lo), rem


def divmod_round_half_up(a: U128, d: IntLike
                         ) -> Tuple[U128, torch.Tensor]:
    """Unsigned (a / d) rounded HALF_UP; returns (q, valid), valid False
    where d == 0."""
    d = torch.as_tensor(d, dtype=torch.int64, device=a.lo.device)
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    q, r = divmod_u64(a, safe_d)
    round_up = uge(r * 2, safe_d).to(torch.int64)
    q = add(q, U128(torch.zeros_like(round_up), round_up))
    return q, d != 0


_POW10 = [10**k for k in range(19)]


def pow10_u64(k: int) -> int:
    if not 0 <= k <= 18:
        raise ValueError("pow10_u64 supports 0..18")
    return _POW10[k]
