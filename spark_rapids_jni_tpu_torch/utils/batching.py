"""Shape bucketing: a bounded geometric grid of row counts, and padding
to it.

Port of ``spark_rapids_jni_tpu/utils/batching.py``:

- ``bucket_sizes(n, floor)`` / ``bucket_rows(n)``: round a row count up
  to the grid of powers of two and 1.5x powers of two at or above the
  floor (``SHAPE_BUCKET_FLOOR``, 1024, unless the caller passes another;
  0 turns it off), so
  the worst-case padding is about a third;
- ``pad_column`` / ``pad_table``: pad columns to a bucketed count with
  NULL rows (fixed-width data pads with zeros, STRING columns with empty
  strings, STRUCT columns field by field).

The reference pads the hot ops' inputs to the grid (row conversion, the
joins, the groupbys) because XLA compiles one program per shape. The
port's ops run eagerly and compile nothing per shape, so it wires the
padding into none of them: it would cost copies and buy nothing. The
batched runner's graphs need none either, since every slot of one batch
key has the same shapes (the fingerprint holds each column's size).
"""

from __future__ import annotations

import torch

from ..columnar import Column, Table, bitmask
from ..types import TypeId

# the reference's default floor; no knob, since no path of the port pads
SHAPE_BUCKET_FLOOR = 1024


def bucket_sizes(n: int, floor: int) -> int:
    """Round ``n`` up to the {2^k, 1.5 * 2^k} grid at or above ``floor``."""
    if floor <= 0 or n <= 0:
        return n
    b = max(floor, 1)
    if n <= b:
        return b
    p = 1 << (n - 1).bit_length()
    three_q = 3 * (p >> 2)
    return three_q if three_q >= max(n, b) else max(p, b)


def bucket_rows(n: int, floor: int = SHAPE_BUCKET_FLOOR) -> int:
    return bucket_sizes(n, floor)


def pad_column(col: Column, target: int) -> Column:
    """Pad a column to ``target`` rows; pad rows are NULL.

    Fixed-width data pads with zeros (DECIMAL128's two lanes included);
    STRING columns pad with empty strings (offsets extended flat, the
    bytes untouched); STRUCT columns pad each field."""
    if target <= col.size:
        return col
    pad = target - col.size
    dev = col.device
    valid = torch.cat([col.valid_bool(),
                       torch.zeros(pad, dtype=torch.bool, device=dev)])
    vwords = bitmask.pack(valid)
    if col.dtype.id == TypeId.STRING:
        offs = col.offsets.data
        new_offs = torch.cat([offs, offs[-1:].expand(pad)]).to(torch.int32)
        return Column(col.dtype, target, None, vwords,
                      children=(Column(col.offsets.dtype, target + 1,
                                       new_offs), col.child))
    if col.dtype.id == TypeId.STRUCT:
        return Column(col.dtype, target, None, vwords,
                      children=tuple(pad_column(c, target)
                                     for c in col.children),
                      field_names=col.field_names)
    data = torch.cat([col.data,
                      torch.zeros((pad,) + tuple(col.data.shape[1:]),
                                  dtype=col.data.dtype, device=dev)])
    return Column(col.dtype, target, data, vwords)


def pad_table(table: Table, target: int) -> Table:
    return Table([pad_column(c, target) for c in table.columns])
