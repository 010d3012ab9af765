"""Device-resident columns: a data tensor, optional packed validity,
optional children.

Mirrors ``spark_rapids_jni_tpu/columnar/column.py``: fixed-width columns
hold ``data`` ((N, 2) int64 [lo, hi] for DECIMAL128); STRING and LIST
columns hold no data and two children, int32 offsets (N + 1) and an
element child (uint8 chars for STRING; for LIST int8 bytes in a row
batch, any fixed-width type in a column), like cudf's strings and lists
columns. A STRUCT column holds no data and one child per field, each of
the parent's row count; a null struct row leaves its children as they
are (readers consult the parent's mask first), and ``field_names`` is
schema metadata. ``value_range``/``unique`` are the
host-side ingest stats (Parquet-chunk-style min/max and a primary-key
signal) that the dense planner trusts once verified; ``_stats_flags``
memoizes that verification as (range_ok, unique_ok).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..types import (DType, TypeId, SIZE_TYPE, SIZE_TYPE_MAX, INT8, INT32,
                     LIST, STRING, STRUCT, UINT8, decimal128)
from ..utils.errors import expects
from . import bitmask

# Cap on the dense-range width the ingest uniqueness stat counts over
# (the reference's _UNIQUE_STAT_MAX_WIDTH).
_UNIQUE_STAT_MAX_WIDTH = 1 << 22


def host_ingest_stats(values: np.ndarray, valid=None) -> tuple:
    """(value_range, unique) over the valid values of an integer host
    array; ``unique`` only where the range is dense enough to matter."""
    if values.dtype.kind not in "iu" or not values.shape[0]:
        return None, None
    vv = values if valid is None else values[valid]
    if not vv.shape[0]:
        return None, None
    vrange = (int(vv.min()), int(vv.max()))
    width = vrange[1] - vrange[0] + 1
    uniq = None
    if width <= _UNIQUE_STAT_MAX_WIDTH and width <= 32 * vv.shape[0]:
        if vv.dtype.kind == "u":
            offs = (vv - np.asarray(vrange[0], vv.dtype)).astype(np.int64)
        else:
            offs = vv.astype(np.int64) - vrange[0]
        uniq = bool(np.bincount(offs, minlength=width).max() <= 1)
    return vrange, uniq


_NP_TO_ID = {
    "int8": TypeId.INT8, "int16": TypeId.INT16, "int32": TypeId.INT32,
    "int64": TypeId.INT64, "uint8": TypeId.UINT8, "uint16": TypeId.UINT16,
    "uint32": TypeId.UINT32, "uint64": TypeId.UINT64,
    "float32": TypeId.FLOAT32, "float64": TypeId.FLOAT64,
    "bool": TypeId.BOOL8,
}


def np_to_dtype(np_dtype) -> DType:
    key = np.dtype(np_dtype).name
    expects(key in _NP_TO_ID, f"unsupported numpy dtype {np_dtype}")
    return DType(_NP_TO_ID[key])


@dataclass
class Column:
    """A device column: ``data`` (N,) in the storage dtype (None for
    STRING, LIST and STRUCT), optional ``validity`` (packed uint32 words;
    None = all valid), ``children`` ((offsets, elements) for STRING and
    LIST, the fields for STRUCT) and a STRUCT's ``field_names``."""

    dtype: DType
    size: int
    data: Optional[torch.Tensor]
    validity: Optional[torch.Tensor] = None
    value_range: Optional[Tuple[int, int]] = None
    unique: Optional[bool] = None
    children: Tuple["Column", ...] = field(default_factory=tuple)
    field_names: Optional[Tuple[str, ...]] = None

    @staticmethod
    def from_numpy(values: np.ndarray, valid: Optional[np.ndarray] = None,
                   dtype: Optional[DType] = None, *,
                   device: torch.device) -> "Column":
        """Host -> device, with the exact host ingest stats. ``dtype``
        names the logical type (BOOL8, a date, a decimal with its scale)
        where the numpy dtype does not."""
        values = np.asarray(values)
        dt = dtype if dtype is not None else np_to_dtype(values.dtype)
        expects(dt.is_fixed_width and dt.storage_lanes == 1,
                f"from_numpy builds single-lane fixed-width columns, not "
                f"{dt!r} (DECIMAL128: decimal128_from_ints)")
        expects(values.ndim == 1, "columns are 1-D")
        expects(values.nbytes <= SIZE_TYPE_MAX,
                "single column buffer must stay below 2GB")
        host = np.ascontiguousarray(values.astype(dt.storage_dtype,
                                                  copy=False))
        if not host.flags.writeable:  # torch tensors need writable memory
            host = host.copy()
        data = torch.from_numpy(host).to(device)
        if valid is not None:
            valid = np.asarray(valid, dtype=bool)
            expects(valid.shape == values.shape, "validity shape mismatch")
        vrange, uniq = host_ingest_stats(values, valid)
        return Column(dt, int(values.shape[0]), data,
                      pack_validity(valid, device),
                      value_range=vrange, unique=uniq)

    @staticmethod
    def from_numpy_batch(arrays: Sequence[np.ndarray], *,
                         device: torch.device) -> "list[Column]":
        """Host -> device ingest of non-null 1-D arrays in one copy: the
        arrays are packed into one host buffer (pinned when the device is
        the card), 64-byte-aligned each, that goes to the device at once;
        each column is a view of its segment. Stats as ``from_numpy``."""
        staged, at = [], 0
        for values in arrays:
            values = np.asarray(values)
            dt = np_to_dtype(values.dtype)
            expects(dt.is_fixed_width and dt.storage_lanes == 1,
                    "from_numpy_batch supports single-lane fixed widths")
            expects(values.ndim == 1, "columns are 1-D")
            expects(values.nbytes <= SIZE_TYPE_MAX,
                    "single column buffer must stay below 2GB")
            host = np.ascontiguousarray(values.astype(dt.storage_dtype,
                                                      copy=False))
            staged.append((values, dt, host, at))
            at += -(-host.nbytes // 64) * 64
        dev = torch.device(device)
        buf = torch.empty(at, dtype=torch.uint8,
                          pin_memory=dev.type == "cuda")
        flat = buf.numpy()
        for _, _, host, off in staged:
            flat[off:off + host.nbytes] = host.reshape(-1).view(np.uint8)
        moved = buf.to(dev, non_blocking=True)
        cols = []
        for values, dt, host, off in staged:
            data = moved[off:off + host.nbytes].view(dt.to_torch())
            vrange, uniq = host_ingest_stats(values, None)
            cols.append(Column(dt, int(values.shape[0]), data,
                               value_range=vrange, unique=uniq))
        return cols

    @staticmethod
    def decimal128_from_ints(values: Sequence[Optional[int]], scale: int = 0,
                             *, device: torch.device) -> "Column":
        """DECIMAL128 from unscaled Python ints (``v * 10**scale``); None
        is null. Storage is (N, 2) int64 [lo, hi] two's-complement words."""
        n = len(values)
        data = np.zeros((n, 2), np.uint64)
        valid = np.ones(n, bool)
        for i, v in enumerate(values):
            if v is None:
                valid[i] = False
                continue
            expects(-(1 << 127) <= v < (1 << 127),
                    "decimal128 unscaled value out of 128-bit range")
            u = v & ((1 << 128) - 1)
            data[i, 0] = u & 0xFFFFFFFFFFFFFFFF
            data[i, 1] = u >> 64
        return Column(decimal128(scale), n,
                      torch.from_numpy(data.view(np.int64)).to(device),
                      pack_validity(valid, device))

    @staticmethod
    def strings_from_list(strings: Sequence[Optional[Union[bytes, str]]],
                          *, device: torch.device) -> "Column":
        """STRING from host values (str as UTF-8, or bytes); None is
        null and holds no bytes."""
        bufs = [b"" if s is None else
                s.encode("utf-8") if isinstance(s, str) else bytes(s)
                for s in strings]
        valid = np.array([s is not None for s in strings], bool)
        offsets = np.zeros(len(bufs) + 1, dtype=SIZE_TYPE)
        np.cumsum([len(b) for b in bufs], out=offsets[1:])
        chars = np.frombuffer(b"".join(bufs), dtype=np.uint8)
        return Column.strings_from_arrays(offsets, chars, valid,
                                          device=device)

    @staticmethod
    def strings_from_arrays(offsets: np.ndarray, chars: np.ndarray,
                            valid: Optional[np.ndarray] = None, *,
                            device: torch.device) -> "Column":
        """STRING from host int32 offsets (N + 1), uint8 chars and an
        optional bool validity."""
        offsets = np.asarray(offsets)
        expects(offsets.ndim == 1 and offsets.shape[0] >= 1,
                "offsets need N + 1 entries")
        expects(int(offsets[-1]) <= SIZE_TYPE_MAX,
                "chars buffer must stay below 2GB")
        n = int(offsets.shape[0]) - 1
        off = torch.from_numpy(offsets.astype(SIZE_TYPE)).to(device)
        chr_ = torch.from_numpy(np.array(chars, dtype=np.uint8)).to(device)
        return Column(STRING, n, None, pack_validity(valid, device),
                      children=(Column(INT32, n + 1, off),
                                Column(UINT8, int(chr_.shape[0]), chr_)))

    @staticmethod
    def struct_from_children(children: Sequence["Column"],
                             valid: Optional[np.ndarray] = None,
                             field_names: Optional[Sequence[str]] = None
                             ) -> "Column":
        """STRUCT over equal-length child columns, on their device, with
        an optional host bool validity and one name per field."""
        expects(len(children) > 0, "struct needs at least one field")
        n = children[0].size
        for c in children:
            expects(c.size == n, "struct children must share a row count")
        if valid is not None:
            valid = np.asarray(valid, dtype=bool)
            expects(valid.shape == (n,), "validity shape mismatch")
        if field_names is not None:
            expects(len(field_names) == len(children),
                    "one field name per struct child")
            field_names = tuple(field_names)
        return Column(STRUCT, n, None,
                      pack_validity(valid, children[0].device),
                      children=tuple(children), field_names=field_names)

    @staticmethod
    def list_from_arrays(offsets: np.ndarray, elements: np.ndarray,
                         valid: Optional[np.ndarray] = None,
                         elem_dtype: Optional[DType] = None, *,
                         device: torch.device) -> "Column":
        """LIST of a fixed-width element type from host int32 offsets
        (N + 1), the elements and an optional bool validity; a null row's
        offsets may span elements, which readers then ignore."""
        offsets = np.asarray(offsets)
        expects(offsets.ndim == 1 and offsets.shape[0] >= 1,
                "offsets need N + 1 entries")
        n = int(offsets.shape[0]) - 1
        elems = Column.from_numpy(np.asarray(elements), None, elem_dtype,
                                  device=device)
        off = torch.from_numpy(offsets.astype(SIZE_TYPE)).to(device)
        return Column(LIST, n, None, pack_validity(valid, device),
                      children=(Column(INT32, n + 1, off), elems))

    @staticmethod
    def list_of_int8(child_bytes: torch.Tensor,
                     offsets: torch.Tensor) -> "Column":
        """``list<int8>``, the row-batch type of ``convert_to_rows``, on
        the device of its tensors."""
        child = Column(INT8, int(child_bytes.shape[0]),
                       child_bytes.view(torch.int8))
        off = Column(INT32, int(offsets.shape[0]), offsets.to(torch.int32))
        return Column(LIST, int(offsets.shape[0]) - 1, None,
                      children=(off, child))

    @property
    def offsets(self) -> "Column":
        expects(self.dtype.id in (TypeId.LIST, TypeId.STRING),
                "no offsets child")
        return self.children[0]

    @property
    def child(self) -> "Column":
        expects(self.dtype.id in (TypeId.LIST, TypeId.STRING),
                "no element child")
        return self.children[1]

    @property
    def device(self) -> torch.device:
        return (self.data.device if self.data is not None
                else self.children[0].device)

    @property
    def has_nulls(self) -> bool:
        return self.validity is not None

    def type_signature(self) -> tuple:
        """Structural type identity: (id, scale), and for STRUCT the
        fields' signatures (a DType alone makes every struct equal)."""
        if self.dtype.id == TypeId.STRUCT:
            return (int(self.dtype.id), self.dtype.scale,
                    tuple(c.type_signature() for c in self.children))
        return (int(self.dtype.id), self.dtype.scale)

    def null_count(self) -> int:
        """Null rows (a host sync)."""
        if self.validity is None:
            return 0
        return self.size - int(self.valid_bool().sum())

    def valid_bool(self) -> torch.Tensor:
        """Validity as a dense bool vector (all-True if no mask)."""
        if self.validity is None:
            return torch.ones(self.size, dtype=torch.bool, device=self.device)
        return bitmask.unpack(self.validity, self.size)

    def to_numpy(self) -> "tuple[np.ndarray, np.ndarray]":
        """Device -> host: (values, valid_bool). Null slots hold junk;
        DECIMAL128 values are (N, 2) int64 [lo, hi]."""
        expects(self.data is not None,
                f"to_numpy reads fixed-width columns, not {self.dtype!r}")
        values = self.data.cpu().numpy()
        valid = (np.ones(self.size, np.bool_) if self.validity is None
                 else self.valid_bool().cpu().numpy())
        return values, valid

    def to_pylist(self) -> list:
        """Host values, None for nulls: str for STRING, bytes for a LIST
        of int8 (a row batch), a list of element values for another
        LIST, a tuple of field values for STRUCT, ``decimal.Decimal``
        for DECIMAL128."""
        valid = self.valid_bool().cpu().numpy()
        if self.dtype.id == TypeId.STRUCT:
            fields = [c.to_pylist() for c in self.children]
            return [tuple(f[i] for f in fields) if ok else None
                    for i, ok in enumerate(valid)]
        if self.dtype.id in (TypeId.STRING, TypeId.LIST):
            offs = self.offsets.data.cpu().numpy()
            if self.dtype.id == TypeId.LIST \
                    and self.child.dtype.id != TypeId.INT8:
                elems = self.child.to_pylist()
                items = [elems[offs[i]:offs[i + 1]]
                         for i in range(self.size)]
                return [v if ok else None for v, ok in zip(items, valid)]
            raw = self.child.data.cpu().numpy().tobytes()
            items = [raw[offs[i]:offs[i + 1]] for i in range(self.size)]
            if self.dtype.id == TypeId.STRING:
                items = [b.decode("utf-8") for b in items]
            return [v if ok else None for v, ok in zip(items, valid)]
        if self.dtype.id == TypeId.DECIMAL128:
            import decimal
            ctx = decimal.Context(prec=45)  # 38 digits must not round
            words = self.data.cpu().numpy().view(np.uint64)
            out = []
            for (lo, hi), ok in zip(words, valid):
                u = (int(hi) << 64) | int(lo)
                u = u - (1 << 128) if u >= (1 << 127) else u
                out.append(decimal.Decimal(u).scaleb(self.dtype.scale, ctx)
                           if ok else None)
            return out
        values, valid = self.to_numpy()
        return [v.item() if ok else None for v, ok in zip(values, valid)]

    def __repr__(self) -> str:
        return (f"Column({self.dtype!r}, size={self.size}, "
                f"nulls={self.validity is not None})")


def pack_validity(valid: Optional[np.ndarray], device: torch.device
           ) -> Optional[torch.Tensor]:
    """Packed validity words of a host bool mask on ``device``; None when
    there is no mask or every row is valid."""
    if valid is None:
        return None
    valid = np.asarray(valid, dtype=bool)
    if valid.all():
        return None
    return torch.from_numpy(bitmask.pack_host(valid)).to(device)
