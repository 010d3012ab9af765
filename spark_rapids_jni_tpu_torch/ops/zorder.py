"""ZOrder: multi-dimensional clustering keys (Delta OPTIMIZE ZORDER BY).

Port of ``spark_rapids_jni_tpu/ops/zorder.py`` (the mainline ZOrderJni
``interleaveBits`` and ``hilbertIndex``):

- ``interleave_bits``: Delta's InterleaveBits. k inputs of up to 32 bits
  give a 4k-byte binary (LIST<INT8>) a row whose bit stream (bytes in
  order, MSB first in a byte) takes bit t from column ``t % k``, bit
  ``t // k`` from the MSB of the 32-bit value. NULL inputs give 0.
- ``hilbert_index``: the Hilbert curve index of k coordinates at
  ``num_bits`` bits each, an INT64 column (k * num_bits <= 63), by
  Skilling's transpose ("Programming the Hilbert curve", AIP 2004).

torch has no shifts or adds on uint32, so every value is an int64 lane
masked to 32 bits: an INT8/16/32 sign-extends first (the reference's
int32 -> uint32 cast), unsigned and BOOL8 storage widens as it is.
``k * num_bits <= 63`` keeps the Hilbert index non-negative in int64.
"""

from __future__ import annotations

import torch

from ..columnar import Column, Table
from ..types import INT64, TypeId
from ..utils.errors import expects
from ..obs import traced

_SUPPORTED = (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.UINT8,
              TypeId.UINT16, TypeId.UINT32, TypeId.BOOL8)
_MASK32 = 0xFFFFFFFF


def _as_u32(col: Column) -> torch.Tensor:
    """Column -> int64 lanes holding its uint32 bits; NULL rows become 0
    (they cluster first)."""
    expects(col.dtype.id in _SUPPORTED,
            f"zorder input must be a <=32-bit integral, got {col.dtype!r}")
    bits = col.data.to(torch.int64) & _MASK32
    if col.validity is not None:
        bits = torch.where(col.valid_bool(), bits, 0)
    return bits


@traced("zorder.interleave_bits")
def interleave_bits(table: Table) -> Column:
    """Delta InterleaveBits over k int columns -> binary (LIST<INT8>)
    column of 4k bytes a row."""
    k = table.num_columns
    expects(k > 0, "interleave_bits needs at least one column")
    n = table.num_rows
    expects(n * 4 * k < 2**31,
            "interleave_bits output chars buffer must stay below 2GB")
    data = torch.stack([_as_u32(c) for c in table.columns], dim=1)
    dev = data.device
    # output byte j, bit b (MSB first) is stream bit t = 8j + b: bit
    # t // k from the MSB of column t % k; one (N, 4k) pass a bit b
    j = torch.arange(4 * k, device=dev)
    out = torch.zeros((n, 4 * k), dtype=torch.int64, device=dev)
    for b in range(8):
        t = 8 * j + b
        bit = (data[:, t % k] >> (31 - t // k)) & 1
        out |= bit << (7 - b)
    offsets = torch.arange(n + 1, dtype=torch.int32, device=dev) * (4 * k)
    return Column.list_of_int8(out.to(torch.uint8).reshape(-1), offsets)


@traced("zorder.hilbert_index")
def hilbert_index(table: Table, num_bits: int) -> Column:
    """Hilbert curve index of k coordinate columns at num_bits bits each
    -> INT64 column. Coordinates are masked to num_bits; NULLs map to 0."""
    k = table.num_columns
    expects(k > 0, "hilbert_index needs at least one column")
    expects(1 <= num_bits <= 32, "num_bits must be in [1, 32]")
    expects(k * num_bits <= 63, "k * num_bits must fit in int64")
    n = table.num_rows
    mask = (1 << num_bits) - 1
    x = [_as_u32(c) & mask for c in table.columns]

    # Skilling: coordinates -> transposed Hilbert form
    q = 1 << (num_bits - 1)
    while q > 1:
        p = q - 1
        for i in range(k):
            hi = (x[i] & q) != 0
            if i == 0:
                # the exchange is a no-op for i == 0 (x[0] ^ x[0] == 0)
                x[0] = torch.where(hi, x[0] ^ p, x[0])
            else:
                # bit set: invert low bits of x[0]; else swap x[0]/x[i] lows
                t = (x[0] ^ x[i]) & p
                x0_new = torch.where(hi, x[0] ^ p, x[0] ^ t)
                x[i] = torch.where(hi, x[i], x[i] ^ t)
                x[0] = x0_new
        q >>= 1

    # Gray encode
    for i in range(1, k):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = 1 << (num_bits - 1)
    while q > 1:
        t = torch.where((x[k - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(k):
        x[i] = x[i] ^ t

    # interleave the transposed form: x[0] holds the most significant bits
    idx = torch.zeros(n, dtype=torch.int64, device=x[0].device)
    for b in range(num_bits - 1, -1, -1):
        for i in range(k):
            idx = (idx << 1) | ((x[i] >> b) & 1)
    return Column(INT64, n, idx)
