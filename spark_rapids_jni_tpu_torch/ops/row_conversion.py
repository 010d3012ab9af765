"""Row <-> column conversion in the reference's row format.

Mirrors ``spark_rapids_jni_tpu/ops/row_conversion.py``, itself a
byte-exact reimplementation of the reference library's only compute
component (``src/main/cpp/src/row_conversion.cu``). The row format is
the spec (``RowConversion.java:40-99``):

- each column's bytes sit at an offset aligned to its own size,
- one validity byte per 8 columns follows the last column, byte-aligned
  with no padding before it; bit ``c % 8`` of byte ``c / 8``, 1 = valid,
- the row is padded to a 64-bit boundary,
- multi-byte values are little-endian, float bytes raw (NaN payloads
  included).

STRING columns take the variable-width layout of ``RowLayout``: an
8-byte (offset, length) slot in the fixed section, the bytes after it.

Routes: a table whose columns all have widths 1, 2, 4 or 8 goes to K6
(``cuda_kernels.pack_rows``, any number of columns), which on a CPU
tensor is its plain version; a table with a DECIMAL128 or STRING column
is built from torch ops. The route is counted
(``row_conversion.route.pack_rows`` / ``row_conversion.route.torch``).
Each call opens the reference's span (``row_conversion.convert_to_rows``,
``row_conversion.convert_from_rows``) and, on the fixed-width routes,
one span per step inside it, so a profiler trace taken with
``SRT_TRACE_ENABLED`` names the step the host was in at each
device-idle gap. The switches are read once a call.
``convert_from_rows`` is torch slicing and views for the data, and one
K3 launch (``cuda_kernels.bitmask_pack_fields``) a batch for every
column's validity words.

Batches keep each output ``list<int8>`` column below 2 GB, in multiples
of 32 rows so validity words never split across batches
(``row_conversion.cu:476-479``). The port runs eagerly, so there is no
shape bucketing.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..columnar import Column, Table, bitmask
from ..columnar.strings import byte_matrix, lengths, max_length
from ..obs import count, no_span, set_attrs, span_opener
from ..types import DType, TypeId, SIZE_TYPE_MAX, INT32, UINT8
from ..utils.errors import expects
from . import cuda_kernels as K
from .row_layout import align_offset, fixed_width_layout


def compute_fixed_width_layout(schema: Sequence[DType]
                               ) -> Tuple[int, List[int], List[int]]:
    """(size_per_row, column_start, column_size) of a fixed-width
    schema."""
    for dt in schema:
        expects(dt.is_fixed_width,
                "Only fixed width types are currently supported")
    sizes = [dt.size_bytes for dt in schema]
    size_per_row, starts, _ = fixed_width_layout(sizes)
    return size_per_row, starts, sizes


class RowLayout:
    """Row layout of a fixed- and variable-width (STRING) schema: every
    column owns a fixed-section slot (a STRING's is 8 bytes, 4-aligned:
    int32 offset from the row start, int32 length), validity bytes
    follow the last slot, the variable section starts at the next 8-byte
    boundary and holds the strings in column order (nulls add no bytes),
    and each row is padded to 8 bytes. Without STRING columns
    ``var_start`` is the fixed-width ``size_per_row``."""

    def __init__(self, schema: Sequence[DType]):
        self.schema = tuple(schema)
        self.starts: List[int] = []
        self.sizes: List[int] = []
        at = 0
        for dt in self.schema:
            if dt.id == TypeId.STRING:
                align, size = 4, 8
            else:
                expects(dt.is_fixed_width,
                        f"row format does not support {dt!r}")
                align = size = dt.size_bytes
            at = align_offset(at, align)
            self.starts.append(at)
            self.sizes.append(size)
            at += size
        self.validity_offset = at
        self.validity_bytes = (len(self.schema) + 7) // 8
        self.var_start = align_offset(at + self.validity_bytes, 8)
        self.has_var = any(dt.id == TypeId.STRING for dt in self.schema)

    @property
    def fixed_size_per_row(self) -> int:
        """Row size when the schema has no variable-width columns."""
        return self.var_start


def max_rows_per_batch(row_bytes: int) -> int:
    """Rows of ``row_bytes`` each that keep a batch below 2 GB, a
    multiple of 32."""
    rows = (SIZE_TYPE_MAX // row_bytes) // 32 * 32
    expects(rows > 0, "row size too large for a 2GB batch")
    return rows


def slice_rows(col: Column, start: int, end: int) -> Column:
    """Rows [start, end) of a column; ``start`` is a multiple of 32 so the
    validity words split cleanly."""
    validity = (None if col.validity is None
                else col.validity[start // 32:(end + 31) // 32])
    if col.dtype.id == TypeId.STRING:
        offs = col.offsets.data
        lo, hi = int(offs[start]), int(offs[end])  # host sync: byte range
        return Column(col.dtype, end - start, None, validity, children=(
            Column(INT32, end - start + 1, offs[start:end + 1] - lo),
            Column(UINT8, hi - lo, col.child.data[lo:hi])))
    return Column(col.dtype, end - start, col.data[start:end], validity)


def _kernel_route(schema: Sequence[DType]) -> bool:
    return all(dt.id != TypeId.STRING and dt.size_bytes in (1, 2, 4, 8)
               for dt in schema)


def convert_to_rows(table: Table) -> List[Column]:
    """Columns -> packed rows: one or more ``list<int8>`` columns
    (``spark_rapids_jni::convert_to_rows``, row_conversion.cu:458-517).

    Spans: ``row_conversion.convert_to_rows`` over the call, with attrs
    ``rows``, ``columns``, ``batches`` and ``route``; on K6's route, for
    each batch, ``row_conversion.to_rows.slice`` (a batch cut from a
    larger table), ``.pack`` (K6 and its pointer table) and ``.offsets``
    inside it."""
    expects(table.num_columns > 0, "table must have at least one column")
    schema = table.schema()
    for dt in schema:
        expects(dt.is_fixed_width or dt.id == TypeId.STRING,
                "Only fixed width and STRING types are currently supported")
    sp = span_opener()
    kernel = _kernel_route(schema)
    count("row_conversion.route.pack_rows" if kernel
          else "row_conversion.route.torch")
    with sp("row_conversion.convert_to_rows", rows=table.num_rows,
            columns=table.num_columns,
            route="pack_rows" if kernel else "torch"):
        out = (_convert_to_rows_fixed(table, schema, sp) if kernel
               else _convert_to_rows_var(table))
        set_attrs(batches=len(out))
    return out


def _convert_to_rows_fixed(table: Table, schema: Sequence[DType],
                           sp) -> List[Column]:
    """K6's route: one launch a batch."""
    widths = [dt.size_bytes for dt in schema]
    size_per_row, _, _ = compute_fixed_width_layout(schema)
    num_rows = table.num_rows
    step = max_rows_per_batch(size_per_row)
    out: List[Column] = []
    for row_start in range(0, max(num_rows, 1), step):
        row_count = min(num_rows - row_start, step)
        # a table of one batch goes to K6 unsliced (host time per column);
        # pack_rows checks each column's length
        if row_count == num_rows:
            batch = table.columns
        else:
            with sp("row_conversion.to_rows.slice"):
                batch = [slice_rows(c, row_start, row_start + row_count)
                         for c in table.columns]
        with sp("row_conversion.to_rows.pack"):
            words = K.pack_rows([c.data for c in batch], widths,
                                [c.validity for c in batch])
        with sp("row_conversion.to_rows.offsets"):
            offsets = torch.arange(0, (row_count + 1) * size_per_row,
                                   size_per_row, dtype=torch.int64,
                                   device=words.device)
            out.append(Column.list_of_int8(
                words.view(torch.int8).reshape(-1), offsets))
    return out


# --------------------------------------------------------------------------
# The torch route: variable-width (STRING) and DECIMAL128 schemas
# --------------------------------------------------------------------------

def _to_row_images_var(table: Table, max_lens: Tuple[int, ...]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, W) uint8 row images, zero past each row's end, and (N,) int32
    row sizes. ``max_lens`` are the STRING columns' longest lengths."""
    lay = RowLayout(table.schema())
    n = table.num_rows
    dev = table.columns[0].device
    str_cols = [c for c in table.columns if c.dtype.id == TypeId.STRING]
    lens = [torch.where(c.valid_bool(), lengths(c), 0) for c in str_cols]
    run = torch.zeros(n, dtype=torch.int32, device=dev)
    str_off = []
    for ln in lens:
        str_off.append(run)
        run = run + ln

    fixed = torch.zeros((n, lay.var_start), dtype=torch.uint8, device=dev)
    si = 0
    for col, start, size in zip(table.columns, lay.starts, lay.sizes):
        if col.dtype.id == TypeId.STRING:
            fixed[:, start:start + 4] = K.as_bytes(lay.var_start
                                                   + str_off[si])
            fixed[:, start + 4:start + 8] = K.as_bytes(lens[si])
            si += 1
        else:
            fixed[:, start:start + size] = K.as_bytes(col.data)
    valid = torch.stack([c.valid_bool() for c in table.columns], dim=1)
    fixed[:, lay.validity_offset:lay.validity_offset + lay.validity_bytes] \
        = bitmask.pack_bytes(valid, table.num_columns)

    sum_max = sum(max_lens)
    images = fixed
    if sum_max:
        # the columns' padded byte panels side by side, then a stable
        # per-row left-compaction of the bytes each row keeps
        panels, keeps = [], []
        for c, ml, ln in zip(str_cols, max_lens, lens):
            mat, _ = byte_matrix(c, ml)
            panels.append(mat[:, :ml])
            keeps.append(torch.arange(ml, device=dev) < ln[:, None])
        block = torch.cat(panels, dim=1)
        drop = ~torch.cat(keeps, dim=1)
        order = torch.sort(drop.to(torch.int8), dim=1, stable=True).indices
        var = torch.gather(block, 1, order)
        # the dropped bytes (a null string may still hold some) read as 0
        var = torch.where(torch.gather(drop, 1, order), 0, var)
        pad = align_offset(sum_max, 8) - sum_max
        images = torch.cat([fixed, var, torch.zeros(
            (n, pad), dtype=torch.uint8, device=dev)], dim=1)
    sizes = lay.var_start + ((run + 7) & ~7)
    return images, sizes


def compact_images(images: torch.Tensor, sizes: torch.Tensor) -> Column:
    """Bytes [0, sizes[i]) of each row image, row after row, as one
    ``list<int8>`` column."""
    n, w = images.shape
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=images.device)
    torch.cumsum(sizes, 0, out=offsets[1:])
    if n and bool((sizes == w).all()):  # host sync: every row full width
        return Column.list_of_int8(images.reshape(-1), offsets)
    keep = torch.arange(w, device=images.device) < sizes[:, None]
    return Column.list_of_int8(images[keep], offsets)


def _convert_to_rows_var(table: Table) -> List[Column]:
    """Batches by the worst-case row size, so every output column stays
    below 2 GB without a per-row size sync."""
    lay = RowLayout(table.schema())
    num_rows = table.num_rows
    is_str = [c.dtype.id == TypeId.STRING for c in table.columns]
    max_lens = tuple(max_length(c) for c, s in zip(table.columns, is_str)
                     if s)  # host syncs, one per STRING column
    step = max_rows_per_batch(lay.var_start
                              + align_offset(sum(max_lens), 8))
    out: List[Column] = []
    for row_start in range(0, max(num_rows, 1), step):
        row_count = min(num_rows - row_start, step)
        batch = Table([slice_rows(c, row_start, row_start + row_count)
                       for c in table.columns])
        bmax = max_lens if row_count == num_rows else tuple(
            max_length(c) for c, s in zip(batch.columns, is_str) if s)
        out.append(compact_images(*_to_row_images_var(batch, bmax)))
    return out


# --------------------------------------------------------------------------
# Rows -> columns
# --------------------------------------------------------------------------

def dense(x: torch.Tensor) -> torch.Tensor:
    """A packed copy of a strided slot view (``contiguous`` keeps the
    stride of a one-row view, which byte views then refuse)."""
    return x.clone(memory_format=torch.contiguous_format)


def _decode_fixed(mat: torch.Tensor, lay: RowLayout, sp=no_span):
    """Per column of a (N, >= var_start) uint8 fixed-section matrix: its
    data (or the (offset, length) int32 pair of a STRING) and its
    validity words. ``sp`` opens the ``row_conversion.from_rows.decode``
    and ``.validity`` spans."""
    datas = []
    # every slot is aligned to its own size and rows to 8 bytes, so the
    # matrix viewed as the slot's type holds each value in one element
    with sp("row_conversion.from_rows.decode"):
        for dt, start, size in zip(lay.schema, lay.starts, lay.sizes):
            if dt.id == TypeId.STRING:
                words = mat.view(torch.int32)[:, start // 4:start // 4 + 2]
                datas.append((dense(words[:, 0]), dense(words[:, 1])))
            elif dt.id == TypeId.DECIMAL128:
                datas.append(dense(
                    mat.view(torch.int64)[:, start // 8:start // 8 + 2]))
            else:
                datas.append(dense(mat.view(dt.to_torch())[:,
                                                           start // size]))
    # every column's validity words in one K3 launch, read in place
    with sp("row_conversion.from_rows.validity"):
        words = bitmask.pack_fields(
            mat[:, lay.validity_offset:lay.validity_offset
                + lay.validity_bytes], len(lay.schema))
    return datas, list(words)


def _convert_from_rows_var(rows: Column, lay: RowLayout) -> Table:
    """Variable-width rows -> columns, with host syncs at the ragged
    steps (each STRING column's longest string and byte total)."""
    n = rows.size
    child = rows.child.data.view(torch.uint8)
    dev = child.device
    base = rows.offsets.data[:-1].to(torch.int64)
    cmax = max(int(child.shape[0]) - 1, 0)
    if n:
        pos = base[:, None] + torch.arange(lay.var_start, device=dev)
        fixed = child[pos.clamp_(0, cmax)]
    else:
        fixed = torch.zeros((0, lay.var_start), dtype=torch.uint8,
                            device=dev)
    datas, vwords = _decode_fixed(fixed, lay)
    cols: List[Column] = []
    for dt, data, vw in zip(lay.schema, datas, vwords):
        if dt.id != TypeId.STRING:
            cols.append(Column(dt, n, data, vw))
            continue
        off, ln = data
        ln = ln.clamp(min=0)
        new_offs = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        torch.cumsum(ln, 0, out=new_offs[1:])
        max_len = int(ln.max()) if n else 0  # host sync: widest string
        if max_len:
            pos = (base + off)[:, None] + torch.arange(max_len, device=dev)
            mat = child[pos.clamp_(0, cmax)]
            chars = mat[torch.arange(max_len, device=dev) < ln[:, None]]
        else:
            chars = torch.zeros(0, dtype=torch.uint8, device=dev)
        cols.append(Column(dt, n, None, vw, children=(
            Column(INT32, n + 1, new_offs),
            Column(UINT8, int(chars.shape[0]), chars))))
    return Table(cols)


def convert_from_rows(rows: Column, schema: Sequence[DType]) -> Table:
    """Packed rows -> columns (``spark_rapids_jni::convert_from_rows``,
    row_conversion.cu:519-575). Every column gets validity words.

    Spans: ``row_conversion.convert_from_rows`` over the call, with attrs
    ``rows``, ``columns`` and ``route``; on the fixed-width route
    ``row_conversion.from_rows.decode`` (the columns' copies) and
    ``.validity`` (K3) inside it."""
    expects(rows.dtype.id == TypeId.LIST, "input must be a list column")
    child = rows.child
    expects(child.dtype.id in (TypeId.INT8, TypeId.UINT8),
            "Only a list of bytes is supported as input")
    lay = RowLayout(schema)
    n = rows.size
    sp = span_opener()
    with sp("row_conversion.convert_from_rows", rows=n,
            columns=len(lay.schema),
            route="torch" if lay.has_var else "fixed_width"):
        if lay.has_var:
            expects(int(rows.offsets.data[-1]) == child.size,
                    "The layout of the data appears to be off")
            return _convert_from_rows_var(rows, lay)
        expects(lay.var_start * n == child.size,
                "The layout of the data appears to be off")
        mat = child.data.view(torch.uint8).reshape(n, lay.var_start)
        datas, vwords = _decode_fixed(mat, lay, sp)
        return Table([Column(dt, n, d, v)
                      for dt, d, v in zip(lay.schema, datas, vwords)])
