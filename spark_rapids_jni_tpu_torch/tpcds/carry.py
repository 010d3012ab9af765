"""Carrying ingested state across packages.

``rel_from_arrays`` builds the port's ``Rel`` from a relation exported
to host arrays: per column its data, packed validity words, ingest
stats (``value_range``, ``unique``) and verification flags, plus the
dictionary categories. A test that exports a reference ``Rel`` this way
feeds both packages identical ingested state.

``table_from_arrays`` builds the port's ``Table`` from the host arrays a
caller hands the reference's column constructors: values, bool validity,
STRING offsets with chars, DECIMAL128 [lo, hi] words.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar.column import np_to_dtype, pack_validity
from ..types import DType, TypeId
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
    caller passes another). Per column: its (type id, scale); its data,
    which is the values for a single-lane fixed-width type, the (N, 2)
    [lo, hi] 64-bit words for DECIMAL128 and (int32 offsets, uint8 chars)
    for STRING; and its bool validity (None = all valid)."""
    expects(len(dtypes) == len(datas) == len(valids),
            "one dtype, data entry and validity entry per column")
    dev = resolve_device(device)
    cols = []
    for (tid, scale), data, valid in zip(dtypes, datas, valids):
        dt = DType(TypeId(int(tid)), int(scale))
        if dt.id == TypeId.STRING:
            offsets, chars = data
            cols.append(Column.strings_from_arrays(offsets, chars, valid,
                                                   device=dev))
        elif dt.id == TypeId.DECIMAL128:
            words = np.ascontiguousarray(data)
            expects(words.ndim == 2 and words.shape[1] == 2
                    and words.dtype.itemsize == 8,
                    "DECIMAL128 data is (N, 2) 64-bit [lo, hi] words")
            cols.append(Column(dt, int(words.shape[0]),
                               torch.from_numpy(words.view(np.int64).copy())
                               .to(dev), pack_validity(valid, dev)))
        else:
            cols.append(Column.from_numpy(data, valid, dt, device=dev))
    return Table(cols)
