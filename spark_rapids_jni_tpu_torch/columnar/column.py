"""Device-resident columns: a data tensor, optional packed validity.

Mirrors ``spark_rapids_jni_tpu/columnar/column.py`` for the fixed-width
single-lane types this slice carries. ``value_range``/``unique`` are the
host-side ingest stats (Parquet-chunk-style min/max and a primary-key
signal) that the dense planner trusts once verified; ``_stats_flags``
memoizes that verification as (range_ok, unique_ok).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..types import DType, TypeId, SIZE_TYPE_MAX
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
    """A device column: ``data`` (N,) in the storage dtype and optional
    ``validity`` (packed uint32 words; None = all valid)."""

    dtype: DType
    size: int
    data: Optional[torch.Tensor]
    validity: Optional[torch.Tensor] = None
    value_range: Optional[Tuple[int, int]] = None
    unique: Optional[bool] = None

    @staticmethod
    def from_numpy(values: np.ndarray, valid: Optional[np.ndarray] = None,
                   *, device: torch.device) -> "Column":
        """Host -> device, with the exact host ingest stats."""
        values = np.asarray(values)
        dt = np_to_dtype(values.dtype)
        expects(values.ndim == 1, "columns are 1-D")
        expects(values.nbytes <= SIZE_TYPE_MAX,
                "single column buffer must stay below 2GB")
        host = np.ascontiguousarray(values.astype(dt.storage_dtype,
                                                  copy=False))
        if not host.flags.writeable:  # torch tensors need writable memory
            host = host.copy()
        data = torch.from_numpy(host).to(device)
        vwords = None
        if valid is not None:
            valid = np.asarray(valid, dtype=bool)
            expects(valid.shape == values.shape, "validity shape mismatch")
            if not valid.all():
                vwords = torch.from_numpy(bitmask.pack_host(valid)).to(device)
        vrange, uniq = host_ingest_stats(values, valid)
        return Column(dt, int(values.shape[0]), data, vwords,
                      value_range=vrange, unique=uniq)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_bool(self) -> torch.Tensor:
        """Validity as a dense bool vector (all-True if no mask)."""
        if self.validity is None:
            return torch.ones(self.size, dtype=torch.bool, device=self.device)
        return bitmask.unpack(self.validity, self.size)

    def to_numpy(self) -> "tuple[np.ndarray, np.ndarray]":
        """Device -> host: (values, valid_bool). Null slots hold junk."""
        values = self.data.cpu().numpy()
        valid = (np.ones(self.size, np.bool_) if self.validity is None
                 else self.valid_bool().cpu().numpy())
        return values, valid

    def to_pylist(self) -> list:
        values, valid = self.to_numpy()
        return [v.item() if ok else None for v, ok in zip(values, valid)]

    def __repr__(self) -> str:
        return (f"Column({self.dtype!r}, size={self.size}, "
                f"nulls={self.validity is not None})")
