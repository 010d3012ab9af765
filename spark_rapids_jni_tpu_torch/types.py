"""Column type system.

Mirrors ``spark_rapids_jni_tpu/types.py``: a type id laid out like cudf's
``type_id`` enum plus an integer scale for decimals. Device storage maps
every fixed-width logical type to a torch dtype (BOOL8 -> int8 storage
like cudf's one-byte bool, DECIMAL32/64 -> int32/int64 with the scale on
the DType). DECIMAL128 is fixed-width with two int64 lanes per row: data
of shape (N, 2) holding the [lo, hi] words of the two's-complement value
(the bits of the reference's (N, 2) uint64). STRING and LIST have no data
of their own: an int32 offsets child plus a uint8 chars child (STRING)
or an element child (LIST: int8 bytes for a row batch, any fixed-width
type for a column). STRUCT has no data either: a validity mask and one
child column per field, all of the parent's row count.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class TypeId(enum.IntEnum):
    """Native type ids, numbered like cudf's ``type_id`` enum."""

    EMPTY = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    UINT8 = 5
    UINT16 = 6
    UINT32 = 7
    UINT64 = 8
    FLOAT32 = 9
    FLOAT64 = 10
    BOOL8 = 11
    TIMESTAMP_DAYS = 12
    TIMESTAMP_SECONDS = 13
    TIMESTAMP_MILLISECONDS = 14
    TIMESTAMP_MICROSECONDS = 15
    TIMESTAMP_NANOSECONDS = 16
    DURATION_DAYS = 17
    DURATION_SECONDS = 18
    DURATION_MILLISECONDS = 19
    DURATION_MICROSECONDS = 20
    DURATION_NANOSECONDS = 21
    DICTIONARY32 = 22
    STRING = 23
    LIST = 24
    DECIMAL32 = 25
    DECIMAL64 = 26
    DECIMAL128 = 27
    STRUCT = 28


# Storage dtype (numpy, the host interchange type) per fixed-width id.
_STORAGE: dict = {
    TypeId.INT8: np.dtype(np.int8),
    TypeId.INT16: np.dtype(np.int16),
    TypeId.INT32: np.dtype(np.int32),
    TypeId.INT64: np.dtype(np.int64),
    TypeId.UINT8: np.dtype(np.uint8),
    TypeId.UINT16: np.dtype(np.uint16),
    TypeId.UINT32: np.dtype(np.uint32),
    TypeId.UINT64: np.dtype(np.uint64),
    TypeId.FLOAT32: np.dtype(np.float32),
    TypeId.FLOAT64: np.dtype(np.float64),
    TypeId.BOOL8: np.dtype(np.int8),
    TypeId.TIMESTAMP_DAYS: np.dtype(np.int32),
    TypeId.TIMESTAMP_SECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_MILLISECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_MICROSECONDS: np.dtype(np.int64),
    TypeId.TIMESTAMP_NANOSECONDS: np.dtype(np.int64),
    TypeId.DURATION_DAYS: np.dtype(np.int32),
    TypeId.DURATION_SECONDS: np.dtype(np.int64),
    TypeId.DURATION_MILLISECONDS: np.dtype(np.int64),
    TypeId.DURATION_MICROSECONDS: np.dtype(np.int64),
    TypeId.DURATION_NANOSECONDS: np.dtype(np.int64),
    TypeId.DECIMAL32: np.dtype(np.int32),
    TypeId.DECIMAL64: np.dtype(np.int64),
}

_TORCH = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


@dataclass(frozen=True)
class DType:
    """A logical column type: ``(type id, scale)``; ``scale`` follows
    cudf (stored ``v`` represents ``v * 10**scale``)."""

    id: TypeId
    scale: int = 0

    def __post_init__(self):
        if self.scale != 0 and self.id not in (
                TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128):
            raise ValueError(
                f"scale is only valid for decimal types, got {self.id!r}")

    @property
    def is_fixed_width(self) -> bool:
        """``cudf::is_fixed_width``: DECIMAL128 is 16 fixed bytes."""
        return self.id in _STORAGE or self.id == TypeId.DECIMAL128

    @property
    def is_decimal(self) -> bool:
        return self.id in (TypeId.DECIMAL32, TypeId.DECIMAL64,
                           TypeId.DECIMAL128)

    @property
    def is_nested(self) -> bool:
        """Types whose data lives in child columns."""
        return self.id in (TypeId.STRING, TypeId.LIST, TypeId.STRUCT)

    @property
    def is_timestamp(self) -> bool:
        return TypeId.TIMESTAMP_DAYS <= self.id <= TypeId.TIMESTAMP_NANOSECONDS

    @property
    def is_integral(self) -> bool:
        return TypeId.INT8 <= self.id <= TypeId.UINT64

    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)

    @property
    def storage_dtype(self) -> np.dtype:
        """Host (numpy) storage dtype; per lane for DECIMAL128."""
        if self.id == TypeId.DECIMAL128:
            return np.dtype(np.int64)
        if not self.is_fixed_width:
            raise ValueError(f"{self.id!r} has no fixed-width storage dtype")
        return _STORAGE[self.id]

    @property
    def storage_lanes(self) -> int:
        """int64 lanes per row: 2 for DECIMAL128 ([lo, hi]), else 1."""
        return 2 if self.id == TypeId.DECIMAL128 else 1

    @property
    def size_bytes(self) -> int:
        """``cudf::size_of``: bytes per row of a fixed-width type."""
        return self.storage_dtype.itemsize * self.storage_lanes

    def to_torch(self) -> torch.dtype:
        """Device (torch) storage dtype."""
        return _TORCH[self.storage_dtype]

    @staticmethod
    def from_ids(type_id: int, scale: int = 0) -> "DType":
        """Rebuild from the (type id, scale) wire encoding."""
        return DType(TypeId(type_id), scale)

    def __repr__(self) -> str:
        if self.is_decimal:
            return f"DType({self.id.name}, scale={self.scale})"
        return f"DType({self.id.name})"


BOOL8 = DType(TypeId.BOOL8)
INT8 = DType(TypeId.INT8)
INT16 = DType(TypeId.INT16)
INT32 = DType(TypeId.INT32)
INT64 = DType(TypeId.INT64)
UINT8 = DType(TypeId.UINT8)
FLOAT32 = DType(TypeId.FLOAT32)
FLOAT64 = DType(TypeId.FLOAT64)
TIMESTAMP_DAYS = DType(TypeId.TIMESTAMP_DAYS)
TIMESTAMP_MICROSECONDS = DType(TypeId.TIMESTAMP_MICROSECONDS)
STRING = DType(TypeId.STRING)
LIST = DType(TypeId.LIST)
STRUCT = DType(TypeId.STRUCT)


def decimal32(scale: int) -> DType:
    return DType(TypeId.DECIMAL32, scale)


def decimal64(scale: int) -> DType:
    return DType(TypeId.DECIMAL64, scale)


def decimal128(scale: int) -> DType:
    return DType(TypeId.DECIMAL128, scale)


# ``size_type`` discipline: row indices and offsets are int32, so one
# buffer stays below 2 GiB, as in cudf.
SIZE_TYPE = np.dtype(np.int32)
SIZE_TYPE_MAX = np.iinfo(np.int32).max
