"""Arrow interchange: pyarrow tables to and from the port's ``Table``.

Port of ``spark_rapids_jni_tpu/io/arrow.py``. The validity layout is
already Arrow's (LSB-first packed bits), so masks convert through a
host bool vector only. Decimals of precision up to 9 become DECIMAL32,
up to 18 DECIMAL64, past 18 DECIMAL128 in the port's (N, 2) int64
lanes; STRUCT keeps its field names. Columns land on ``device``
(``cuda`` unless the caller passes another), one host-to-device copy a
buffer.
"""

from __future__ import annotations

import numpy as np

from ..columnar import Column, Table
from ..types import DType, TypeId, decimal32, decimal64
from ..utils.device import resolve_device
from ..utils.errors import expects

_ARROW_TO_ID = {
    "int8": TypeId.INT8, "int16": TypeId.INT16, "int32": TypeId.INT32,
    "int64": TypeId.INT64, "uint8": TypeId.UINT8, "uint16": TypeId.UINT16,
    "uint32": TypeId.UINT32, "uint64": TypeId.UINT64,
    "float": TypeId.FLOAT32, "double": TypeId.FLOAT64,
    "bool": TypeId.BOOL8, "date32[day]": TypeId.TIMESTAMP_DAYS,
    "timestamp[s]": TypeId.TIMESTAMP_SECONDS,
    "timestamp[ms]": TypeId.TIMESTAMP_MILLISECONDS,
    "timestamp[us]": TypeId.TIMESTAMP_MICROSECONDS,
    "timestamp[ns]": TypeId.TIMESTAMP_NANOSECONDS,
    "string": TypeId.STRING, "large_string": TypeId.STRING,
}


def from_arrow(table, device=None) -> Table:
    """pyarrow.Table -> ``Table`` on ``device``."""
    dev = resolve_device(device)
    cols = []
    for col in table.columns:
        arr = col.combine_chunks() if col.num_chunks != 1 else col.chunk(0)
        cols.append(_array_to_column(arr, dev))
    return Table(cols)


def _array_to_column(arr, dev) -> Column:
    import pyarrow as pa

    t = arr.type
    valid = None
    if arr.null_count:
        valid = np.asarray(arr.is_valid())
    if pa.types.is_decimal(t):
        pyvals = arr.to_pylist()
        if t.precision > 18:  # DECIMAL128 (Spark precision 19..38)
            ints = [None if v is None else
                    int(v.scaleb(t.scale).to_integral_value())
                    for v in pyvals]
            return Column.decimal128_from_ints(ints, -t.scale, device=dev)
        vals = np.array(
            [0 if v is None else int(v.scaleb(t.scale).to_integral_value())
             for v in pyvals], np.int64)
        dt = decimal32(-t.scale) if t.precision <= 9 else decimal64(-t.scale)
        return Column.from_numpy(vals.astype(dt.storage_dtype), valid, dt,
                                 device=dev)
    if pa.types.is_struct(t):
        children = [_array_to_column(arr.field(i), dev)
                    for i in range(t.num_fields)]
        return Column.struct_from_children(
            children, valid,
            field_names=[t.field(i).name for i in range(t.num_fields)])
    name = str(t)
    if name in ("string", "large_string"):
        return Column.strings_from_list(arr.to_pylist(), device=dev)
    tid = _ARROW_TO_ID.get(name)
    expects(tid is not None, f"unsupported arrow type {name}")
    dt = DType(tid)
    if valid is not None:
        # fill nulls so to_numpy keeps the exact storage dtype (with nulls
        # present pyarrow otherwise widens ints to float64/object)
        import pyarrow.compute as pc
        arr = pc.fill_null(arr, _zero_scalar(pa, t))
    np_arr = arr.to_numpy(zero_copy_only=False)
    if name == "bool":
        np_arr = np_arr.astype(np.int8)
    if np_arr.dtype.kind == "M":  # datetime64 -> int64 storage
        np_arr = np_arr.view(np.int64)
    np_arr = np_arr.astype(dt.storage_dtype, copy=False)
    return Column.from_numpy(np.ascontiguousarray(np_arr), valid, dt,
                             device=dev)


def _zero_scalar(pa, t):
    if pa.types.is_boolean(t):
        return pa.scalar(False, t)
    if str(t) == "date32[day]":
        # pyarrow casts int32, not int64, to date32
        return pa.scalar(0, pa.int32()).cast(t)
    if pa.types.is_timestamp(t):
        return pa.scalar(0, pa.int64()).cast(t)
    return pa.scalar(0, t)


def to_arrow(table: Table, names=None):
    """``Table`` -> pyarrow.Table (one device-to-host copy a buffer)."""
    import pyarrow as pa

    names = names or [f"c{i}" for i in range(table.num_columns)]
    arrays = []
    for col in table.columns:
        if col.dtype.id == TypeId.STRUCT:
            arrays.append(_struct_to_arrow(pa, col))
            continue
        if col.dtype.id == TypeId.STRING:
            arrays.append(pa.array(col.to_pylist(), pa.string()))
            continue
        if col.dtype.id == TypeId.DECIMAL128:
            typ = pa.decimal128(38, -col.dtype.scale)
            arrays.append(pa.array(col.to_pylist(), typ))
            continue
        values, valid = col.to_numpy()
        mask = None if col.validity is None else ~valid
        if col.dtype.is_decimal:
            scale = -col.dtype.scale
            typ = pa.decimal128(18, scale)
            pyvals = [None if (mask is not None and mask[i]) else
                      _dec(values[i], scale) for i in range(col.size)]
            arrays.append(pa.array(pyvals, typ))
            continue
        if col.dtype.id == TypeId.BOOL8:
            values = values.astype(bool)
        arrays.append(pa.array(values, mask=mask))
    return pa.table(dict(zip(names, arrays)))


def _struct_to_arrow(pa, col: Column):
    """STRUCT column -> pa.StructArray; fields without names read f0,
    f1, ..."""
    names = (list(col.field_names) if col.field_names is not None
             else [f"f{i}" for i in range(len(col.children))])
    child_arrays = []
    for i, ch in enumerate(col.children):
        sub = to_arrow(Table([ch]), names=[names[i]])
        child_arrays.append(sub.column(0).combine_chunks())
    mask = None
    if col.validity is not None:
        mask = pa.array(~col.valid_bool().cpu().numpy())
    return pa.StructArray.from_arrays(child_arrays, names=names, mask=mask)


def _dec(unscaled: int, scale: int):
    import decimal
    return decimal.Decimal(int(unscaled)).scaleb(-scale)
