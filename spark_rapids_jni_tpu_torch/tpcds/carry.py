"""Carrying ingested state across packages.

``rel_from_arrays`` builds the port's ``Rel`` from a relation exported
to host arrays: per column its data, packed validity words, ingest
stats (``value_range``, ``unique``) and verification flags, plus the
dictionary categories. A test that exports a reference ``Rel`` this way
feeds both packages identical ingested state.

``table_from_arrays`` builds the port's ``Table`` from the host arrays a
caller hands the reference's column constructors: values, bool validity,
STRING offsets with chars, DECIMAL128 [lo, hi] words, LIST offsets with
elements (fixed-width, or a STRUCT's fields), and STRUCT fields,
recursively.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar.column import np_to_dtype, pack_validity
from ..types import INT32, DType, TypeId
from ..utils.device import resolve_device
from ..utils.errors import expects
from .rel import Rel

# per column: (value_range, unique, (range_ok, unique_ok) or None)
ColumnStats = Tuple[Optional[Tuple[int, int]], Optional[bool],
                    Optional[Tuple[bool, bool]]]


def rel_from_arrays(names: Sequence[str], datas: Sequence[np.ndarray],
                    validity_words: Sequence[Optional[np.ndarray]],
                    stats: Sequence[ColumnStats],
                    dicts: Dict[str, np.ndarray], device=None) -> Rel:
    """Host arrays -> a port ``Rel`` on ``device`` (``cuda`` unless the
    caller passes another)."""
    expects(len(names) == len(datas) == len(validity_words) == len(stats),
            "one data array, validity entry and stats entry per name")
    dev = resolve_device(device)
    cols = []
    for data, words, (vrange, unique, flags) in zip(datas, validity_words,
                                                    stats):
        data = np.array(data, copy=True, order="C")  # torch needs writable
        vt = None
        if words is not None:
            vt = torch.from_numpy(
                np.ascontiguousarray(words, dtype=np.uint32)).to(dev)
        col = Column(np_to_dtype(data.dtype), int(data.shape[0]),
                     torch.from_numpy(data).to(dev), vt,
                     value_range=None if vrange is None
                     else (int(vrange[0]), int(vrange[1])),
                     unique=unique)
        if flags is not None:
            col._stats_flags = (bool(flags[0]), bool(flags[1]))
        cols.append(col)
    return Rel(Table(cols), list(names),
               dicts={k: np.asarray(v) for k, v in dicts.items()})


def table_from_arrays(dtypes: Sequence[Tuple[int, int]], datas: Sequence,
                      valids: Sequence[Optional[np.ndarray]],
                      device=None) -> Table:
    """Host arrays -> a port ``Table`` on ``device`` (``cuda`` unless the
    caller passes another). Per column: its (type id, scale); its data;
    and its bool validity (None = all valid). The data is the values for
    a single-lane fixed-width type (timestamps and durations included),
    the (N, 2) [lo, hi] 64-bit words for DECIMAL128, (int32 offsets,
    uint8 chars) for STRING, (int32 offsets, elements, the elements'
    (type id, scale)) for LIST (for a LIST of STRUCT the elements are
    the STRUCT's data as below), and for STRUCT the fields' (dtypes,
    datas, valids), the same three lists again, optionally followed by
    the field names."""
    expects(len(dtypes) == len(datas) == len(valids),
            "one dtype, data entry and validity entry per column")
    dev = resolve_device(device)
    return Table([_column_from_arrays(dt, data, valid, dev)
                  for dt, data, valid in zip(dtypes, datas, valids)])


def _column_from_arrays(dtype: Tuple[int, int], data, valid,
                        dev: torch.device) -> Column:
    dt = DType.from_ids(int(dtype[0]), int(dtype[1]))
    if dt.id == TypeId.STRING:
        offsets, chars = data
        return Column.strings_from_arrays(offsets, chars, valid, device=dev)
    if dt.id == TypeId.LIST:
        offsets, elements, elem = data
        if DType.from_ids(int(elem[0]), int(elem[1])).is_nested:
            # a LIST of STRUCT (a MAP, a histogram, a digest): the
            # elements are the STRUCT's (dtypes, datas, valids[, names])
            offsets = np.asarray(offsets)
            child = _column_from_arrays(elem, elements, None, dev)
            expects(offsets.ndim == 1 and int(offsets[-1]) <= child.size,
                    "LIST offsets run past the elements")
            return Column(dt, int(offsets.shape[0]) - 1, None,
                          pack_validity(valid, dev), children=(
                              Column(INT32, int(offsets.shape[0]),
                                     torch.from_numpy(offsets.astype(
                                         np.int32)).to(dev)), child))
        return Column.list_from_arrays(
            offsets, elements, valid,
            DType.from_ids(int(elem[0]), int(elem[1])), device=dev)
    if dt.id == TypeId.STRUCT:
        child_dtypes, child_datas, child_valids, *names = data
        expects(len(child_dtypes) == len(child_datas) == len(child_valids),
                "one dtype, data entry and validity entry per field")
        children = [_column_from_arrays(d, x, v, dev) for d, x, v in
                    zip(child_dtypes, child_datas, child_valids)]
        return Column.struct_from_children(
            children, valid, names[0] if names else None)
    if dt.id == TypeId.DECIMAL128:
        words = np.ascontiguousarray(data)
        expects(words.ndim == 2 and words.shape[1] == 2
                and words.dtype.itemsize == 8,
                "DECIMAL128 data is (N, 2) 64-bit [lo, hi] words")
        return Column(dt, int(words.shape[0]),
                      torch.from_numpy(words.view(np.int64).copy()).to(dev),
                      pack_validity(valid, dev))
    return Column.from_numpy(data, valid, dt, device=dev)
