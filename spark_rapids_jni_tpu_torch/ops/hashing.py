"""Spark-compatible hashing: Murmur3_x86_32 and XXHash64.

Mirrors ``spark_rapids_jni_tpu/ops/hashing.py`` (the semantics of
Spark's ``Murmur3HashFunction`` and ``XxHash64Function``):

- every fixed-width value is hashed as one or two 4-byte little-endian
  blocks (murmur3) or one 4- or 8-byte block (xxhash64): 1/2/4-byte
  integrals, bool and dates as an int32, 8-byte values and decimals of
  precision <= 18 (DECIMAL32 sign-extended) as a long;
- floats hash their IEEE bits with -0.0 as 0.0 and every NaN as the
  canonical NaN (Java's ``doubleToLongBits``/``floatToIntBits``), float64
  included on every device;
- DECIMAL128 hashes ``BigInteger.toByteArray()`` of its unscaled value,
  strings their UTF-8 bytes (``hashUnsafeBytes``);
- a row hash chains the running hash through the columns as the next
  column's seed; a null leaves it unchanged; the default seed is 42.

Routes: murmur3 of a single-block type goes to K4
(``cuda_kernels.murmur3_int32``) and of a two-block type to K5
(``cuda_kernels.murmur3_int64``), one launch per column at every row
count; their plain versions run on CPU tensors. DECIMAL128 and string
murmur3 and all of xxhash64 are torch ops. torch has no uint32/uint64
shifts, so murmur3 lanes are int64 holding uint32 values and xxhash64
lanes are int64 holding the uint64 bits (multiplies and adds wrap mod
2^64 alike).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..columnar import Column, Table
from ..columnar.strings import byte_matrix, max_length
from ..types import TypeId
from ..utils.errors import expects, fail
from . import cuda_kernels as K

DEFAULT_SEED = 42

_U32 = 0xFFFFFFFF

# one 4-byte block: sign-extended (or, unsigned, zero-extended) to int32
SINGLE_BLOCK = frozenset((
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.BOOL8, TypeId.UINT8,
    TypeId.UINT16, TypeId.UINT32, TypeId.TIMESTAMP_DAYS,
    TypeId.DURATION_DAYS))
# one 8-byte value (Spark hashes Decimal(p <= 18) as its unscaled long)
LONG = frozenset((
    TypeId.INT64, TypeId.UINT64, TypeId.DECIMAL32, TypeId.DECIMAL64,
    TypeId.TIMESTAMP_SECONDS, TypeId.TIMESTAMP_MILLISECONDS,
    TypeId.TIMESTAMP_MICROSECONDS, TypeId.TIMESTAMP_NANOSECONDS,
    TypeId.DURATION_SECONDS, TypeId.DURATION_MILLISECONDS,
    TypeId.DURATION_MICROSECONDS, TypeId.DURATION_NANOSECONDS))

CANONICAL_NAN32 = 0x7FC00000
CANONICAL_NAN64 = 0x7FF8000000000000


def float32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bits of float32 values, -0.0 as 0.0, NaN canonical."""
    bits = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int32)
    return torch.where(torch.isnan(x), CANONICAL_NAN32, bits)


def float64_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 bits of float64 values, -0.0 as 0.0, NaN canonical."""
    bits = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int64)
    return torch.where(torch.isnan(x), CANONICAL_NAN64, bits)


def int_block(col: Column) -> torch.Tensor:
    """The int32 block of a single-block or FLOAT32 column."""
    tid, data = col.dtype.id, col.data
    if tid == TypeId.FLOAT32:
        return float32_bits(data)
    if tid == TypeId.UINT32:
        return data.view(torch.int32)
    return data.to(torch.int32)


def long_block(col: Column) -> torch.Tensor:
    """The int64 value (its uint64 bits) of a long or FLOAT64 column."""
    tid, data = col.dtype.id, col.data
    if tid == TypeId.FLOAT64:
        return float64_bits(data)
    if tid == TypeId.UINT64:
        return data.view(torch.int64)
    return data.to(torch.int64)


def _keep_nulls(col: Column, h: torch.Tensor, h0: torch.Tensor
                ) -> torch.Tensor:
    """Null rows keep the incoming hash."""
    return h if col.validity is None else torch.where(col.valid_bool(), h, h0)


def decimal128_be_bytes(col: Column):
    """Minimal big-endian two's-complement bytes of each DECIMAL128
    value, ``BigInteger.toByteArray()``: ((N, 16) int64 byte values
    left-aligned and zero-padded, (N,) int64 lengths in 1..16)."""
    dev = col.device
    shifts = torch.arange(56, -1, -8, device=dev)
    full = torch.cat([(col.data[:, 1:2] >> shifts) & 0xFF,
                      (col.data[:, 0:1] >> shifts) & 0xFF], dim=1)
    # a leading byte is redundant iff it only sign-extends the next
    nxt_top = full[:, 1:] >= 0x80
    red = (((full[:, :15] == 0) & ~nxt_top)
           | ((full[:, :15] == 0xFF) & nxt_top))
    # the redundant bytes are those before the first byte that is not
    # (an argmax, not a cumprod: torch's scan over a short inner
    # dimension is slow on the card)
    nred = torch.where(red.all(dim=1), 15,
                       (~red).to(torch.int8).argmax(dim=1))
    lens = 16 - nred
    pos = torch.arange(16, device=dev)
    mat = torch.gather(full, 1, (nred[:, None] + pos).clamp_(max=15))
    return torch.where(pos < lens[:, None], mat, 0), lens


# --------------------------------------------------------------------------
# Murmur3
# --------------------------------------------------------------------------

def _signed_byte(b: torch.Tensor) -> torch.Tensor:
    """A byte value as the uint32 lane of its sign extension."""
    return ((b ^ 0x80) - 0x80) & _U32


def murmur3_bytes(mat: torch.Tensor, lens: torch.Tensor, h0: torch.Tensor
                  ) -> torch.Tensor:
    """Spark ``hashUnsafeBytes`` over a zero-padded (N, L) byte matrix
    with per-row lengths, from uint32 lanes ``h0``: 4-byte little-endian
    blocks, then each tail byte as a signed int block; int32 out."""
    m = mat.to(torch.int64)
    lens = lens.to(torch.int64)
    h = h0
    for b in range(m.shape[1] // 4):
        word = (m[:, 4 * b] | m[:, 4 * b + 1] << 8 | m[:, 4 * b + 2] << 16
                | m[:, 4 * b + 3] << 24)
        h = torch.where(4 * b + 4 <= lens, K.murmur3_mix(h, word), h)
    tail = (lens // 4) * 4
    for t in range(3):
        pos = tail + t
        byte = torch.gather(m, 1, pos.clamp(max=m.shape[1] - 1)[:, None])[:, 0]
        h = torch.where(pos < lens, K.murmur3_mix(h, _signed_byte(byte)), h)
    return K.as_int32(K.fmix32(h ^ lens))


def murmur3_string_column(col: Column, seed: int = DEFAULT_SEED,
                          running: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Spark murmur3 of a STRING column's UTF-8 bytes -> int32 (N,)."""
    expects(col.dtype.id == TypeId.STRING,
            "murmur3_string_column needs STRING")
    h0 = _seeds(col, seed, running, torch.int32)
    mat, lens = byte_matrix(col, max_length(col))  # host sync: max_len
    h = murmur3_bytes(mat, lens, h0.to(torch.int64) & _U32)
    return _keep_nulls(col, h, h0)


def _seeds(col: Column, seed: int, running: Optional[torch.Tensor],
           dtype: torch.dtype) -> torch.Tensor:
    if running is None:
        return torch.full((col.size,), seed, dtype=dtype, device=col.device)
    return running.to(dtype).contiguous()


def murmur3_column(col: Column, seed: int = DEFAULT_SEED,
                   running: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Spark murmur3 of one column -> int32 (N,). ``running`` is the
    per-row seed of a row hash; null rows return their seed."""
    tid = col.dtype.id
    if tid == TypeId.STRING:
        return murmur3_string_column(col, seed, running)
    h0 = _seeds(col, seed, running, torch.int32)
    if tid == TypeId.DECIMAL128:
        mat, lens = decimal128_be_bytes(col)
        h = murmur3_bytes(mat, lens, h0.to(torch.int64) & _U32)
    elif tid in SINGLE_BLOCK or tid == TypeId.FLOAT32:
        h = K.murmur3_int32(int_block(col).contiguous(), h0)
    elif tid in LONG or tid == TypeId.FLOAT64:
        h = K.murmur3_int64(long_block(col).contiguous(), h0)
    else:
        fail(f"murmur3 does not support {col.dtype!r}")
    return _keep_nulls(col, h, h0)


def murmur3_table(table: Table, seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Spark row hash: the running hash through every column -> int32."""
    expects(table.num_columns > 0, "need at least one column to hash")
    running = None
    for col in table.columns:
        running = murmur3_column(col, seed, running)
    return running


# --------------------------------------------------------------------------
# XXHash64 (every value one 4- or 8-byte block; strings the full XXH64)
# --------------------------------------------------------------------------

def _i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


P1 = _i64(0x9E3779B185EBCA87)
P2 = _i64(0xC2B2AE3D27D4EB4F)
P3 = _i64(0x165667B19E3779F9)
P4 = _i64(0x85EBCA77C2B2AE63)
P5 = _i64(0x27D4EB2F165667C5)


def _lsr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr64(x, 64 - r)


def _xx_fmix(h: torch.Tensor) -> torch.Tensor:
    h = (h ^ _lsr64(h, 33)) * P2
    h = (h ^ _lsr64(h, 29)) * P3
    return h ^ _lsr64(h, 32)


def _xx_hash_long(block: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark ``XXH64.hashLong``."""
    h = seed + P5 + 8
    h = h ^ (_rotl64(block * P2, 31) * P1)
    return _xx_fmix(_rotl64(h, 27) * P1 + P4)


def _xx_hash_int(block: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark ``XXH64.hashInt`` of a zero-extended 4-byte block."""
    h = seed + P5 + 4
    h = h ^ ((block & _U32) * P1)
    return _xx_fmix(_rotl64(h, 23) * P2 + P3)


def xxhash64_bytes(mat: torch.Tensor, lens: torch.Tensor, h0: torch.Tensor
                   ) -> torch.Tensor:
    """Full XXH64 (Spark ``hashUnsafeBytes``) over a zero-padded (N, L)
    byte matrix, L a multiple of 8, with per-row lengths: 32-byte stripes,
    8-byte blocks, one 4-byte block, tail bytes."""
    n, pad_len = mat.shape
    m = mat.to(torch.int64)
    lens = lens.to(torch.int64)
    le = torch.arange(0, 64, 8, device=mat.device)
    words = (m.reshape(n, pad_len // 8, 8) << le).sum(dim=2)

    def stripe_round(v, w):
        return _rotl64(v + w * P2, 31) * P1

    v1, v2, v3, v4 = h0 + P1 + P2, h0 + P2, h0, h0 - P1
    for s in range(pad_len // 32):
        active = (s + 1) * 32 <= lens
        v1 = torch.where(active, stripe_round(v1, words[:, 4 * s]), v1)
        v2 = torch.where(active, stripe_round(v2, words[:, 4 * s + 1]), v2)
        v3 = torch.where(active, stripe_round(v3, words[:, 4 * s + 2]), v3)
        v4 = torch.where(active, stripe_round(v4, words[:, 4 * s + 3]), v4)
    merged = _rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) \
        + _rotl64(v4, 18)
    for v in (v1, v2, v3, v4):
        merged = (merged ^ stripe_round(torch.zeros_like(v), v)) * P1 + P4
    h = torch.where(lens >= 32, merged, h0 + P5) + lens

    stripe_end = (lens // 32) * 32
    for b in range(pad_len // 8):
        active = (b * 8 >= stripe_end) & (b * 8 + 8 <= lens)
        k1 = _rotl64(words[:, b] * P2, 31) * P1
        h = torch.where(active, _rotl64(h ^ k1, 27) * P1 + P4, h)

    i4 = (lens // 8) * 8
    idx = (i4[:, None] + torch.arange(4, device=mat.device)) \
        .clamp_(max=pad_len - 1)
    b4 = torch.gather(m, 1, idx)
    w32 = b4[:, 0] | b4[:, 1] << 8 | b4[:, 2] << 16 | b4[:, 3] << 24
    has4 = lens % 8 >= 4
    h = torch.where(has4, _rotl64(h ^ (w32 * P1), 23) * P2 + P3, h)

    tail = i4 + torch.where(has4, 4, 0)
    for t in range(3):
        pos = tail + t
        byte = torch.gather(m, 1, pos.clamp(max=pad_len - 1)[:, None])[:, 0]
        h = torch.where(pos < lens, _rotl64(h ^ (byte * P5), 11) * P1, h)
    return _xx_fmix(h)


def xxhash64_string_column(col: Column, seed: int = DEFAULT_SEED,
                           running: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Spark XXHash64 of a STRING column's UTF-8 bytes -> int64 (N,)."""
    expects(col.dtype.id == TypeId.STRING,
            "xxhash64_string_column needs STRING")
    h0 = _seeds(col, seed, running, torch.int64)
    pad_len = max(-(-max_length(col) // 8) * 8, 8)  # host sync: max_len
    mat, lens = byte_matrix(col, pad_len)
    return _keep_nulls(col, xxhash64_bytes(mat, lens, h0), h0)


def xxhash64_column(col: Column, seed: int = DEFAULT_SEED,
                    running: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Spark XXHash64 of one column -> int64 (N,); null rows return
    their seed."""
    tid = col.dtype.id
    if tid == TypeId.STRING:
        return xxhash64_string_column(col, seed, running)
    h0 = _seeds(col, seed, running, torch.int64)
    if tid == TypeId.DECIMAL128:
        mat, lens = decimal128_be_bytes(col)
        h = xxhash64_bytes(mat, lens, h0)
    elif tid in SINGLE_BLOCK or tid == TypeId.FLOAT32:
        h = _xx_hash_int(int_block(col).to(torch.int64), h0)
    elif tid in LONG or tid == TypeId.FLOAT64:
        h = _xx_hash_long(long_block(col), h0)
    else:
        fail(f"xxhash64 does not support {col.dtype!r}")
    return _keep_nulls(col, h, h0)


def xxhash64_table(table: Table, seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Spark row hash via XXHash64 chaining -> int64."""
    expects(table.num_columns > 0, "need at least one column to hash")
    running = None
    for col in table.columns:
        running = xxhash64_column(col, seed, running)
    return running
