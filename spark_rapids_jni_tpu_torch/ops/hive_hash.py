"""Spark-compatible HiveHash.

Mirrors ``spark_rapids_jni_tpu/ops/hive_hash.py`` (Spark's ``HiveHash``,
Hive's ``ObjectInspectorUtils.hashCode``): null is 0; bool 1/0; byte,
short, int and date their int value; long ``(int)(v ^ (v >>> 32))``;
float ``floatToIntBits`` and double ``doubleToLongBits`` folded like a
long, with -0.0 as 0.0 and every NaN canonical (float64 included);
string ``h = 31 * h + signed_byte`` over its UTF-8 bytes from 0;
timestamp(us) Spark's ``hashTimestamp``; a row ``h = 31 * h +
column_hash`` from 0, with no seed. Torch ops on every device, in int64
lanes wrapped to int32 (no kernel: the reference has no Pallas kernel
here).
"""

from __future__ import annotations

import torch

from ..columnar import Column, Table
from ..columnar.strings import byte_matrix, max_length
from ..types import TypeId
from ..utils.errors import expects, fail
from .cuda_kernels import as_int32
from .hashing import float32_bits, float64_bits

_INT_VALUED = frozenset((
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.UINT8, TypeId.UINT16,
    TypeId.TIMESTAMP_DAYS))


def _fold_long(bits: torch.Tensor) -> torch.Tensor:
    """Java's ``(int)(v ^ (v >>> 32))`` of int64 lanes."""
    return as_int32(bits ^ (bits >> 32))


def _hive_hash_fixed(col: Column) -> torch.Tensor:
    tid, data = col.dtype.id, col.data
    if tid in _INT_VALUED:
        return data.to(torch.int32)
    if tid == TypeId.UINT32:
        return data.view(torch.int32)
    if tid == TypeId.BOOL8:
        return (data != 0).to(torch.int32)
    if tid == TypeId.FLOAT32:
        return float32_bits(data)
    if tid == TypeId.FLOAT64:
        return _fold_long(float64_bits(data))
    if tid == TypeId.INT64:
        return _fold_long(data)
    if tid == TypeId.UINT64:
        return _fold_long(data.view(torch.int64))
    if tid == TypeId.TIMESTAMP_MICROSECONDS:
        # Java truncating division, sign-following remainder; the negative
        # nanos of a pre-epoch row sign-extend into the OR
        us = data.to(torch.int64)
        seconds = torch.div(us, 1_000_000, rounding_mode="trunc")
        nanos = (us - seconds * 1_000_000) * 1000
        return _fold_long((seconds << 30) | nanos)
    fail(f"hive_hash does not support {col.dtype!r}")


def _hive_hash_string(col: Column) -> torch.Tensor:
    mat, lens = byte_matrix(col, max_length(col))  # host sync: max_len
    m = mat.to(torch.int64)
    h = torch.zeros(col.size, dtype=torch.int64, device=col.device)
    for t in range(m.shape[1]):
        sbyte = (m[:, t] ^ 0x80) - 0x80
        h = torch.where(t < lens, as_int32(h * 31 + sbyte).to(torch.int64),
                        h)
    return h.to(torch.int32)


def hive_hash_column(col: Column) -> torch.Tensor:
    """HiveHash of one column -> int32 (N,); null rows hash to 0."""
    h = (_hive_hash_string(col) if col.dtype.id == TypeId.STRING
         else _hive_hash_fixed(col))
    if col.validity is not None:
        h = torch.where(col.valid_bool(), h, 0)
    return h


def hive_hash_table(table: Table) -> torch.Tensor:
    """Spark HiveHash row hash ``h = 31 * h + column_hash`` from 0."""
    expects(table.num_columns > 0, "need at least one column to hash")
    h = torch.zeros(table.num_rows, dtype=torch.int64,
                    device=table.columns[0].device)
    for col in table.columns:
        h = as_int32(h * 31 + hive_hash_column(col).to(torch.int64)) \
            .to(torch.int64)
    return h.to(torch.int32)
