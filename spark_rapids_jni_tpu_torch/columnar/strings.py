"""String columns: dictionary codes for the relational path, byte
matrices for the byte-level kernels.

The reference ingests non-null string columns as int64 codes into a
host-side sorted dictionary (``rel.py`` ``rel_from_df``, the Parquet
dictionary-page idiom): code order equals lexicographic string order, so
sorts and groupbys on codes match string semantics and no string bytes
reach the device plan.

The byte-level STRING column (int32 offsets + uint8 chars, see
``Column.strings_from_list``) feeds the hashing and row-conversion
kernels through a padded byte matrix: one gather turns the ragged chars
into (N, max_len) uint8 plus lengths, after which every string op is
tensor algebra over the matrix (``spark_rapids_jni_tpu/columnar/
strings.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..types import INT32, SIZE_TYPE_MAX, STRING, UINT8, TypeId
from ..utils.errors import expects
from . import bitmask
from .column import Column


def dictionary_encode(values) -> "tuple[np.ndarray, np.ndarray]":
    """(int64 codes, sorted categories) of a pandas Series; a null
    value gets code -1."""
    import pandas as pd
    codes, cats = pd.factorize(values, sort=True)
    return codes.astype(np.int64), np.asarray(cats)


def lengths(col: Column) -> torch.Tensor:
    """(N,) int32 byte length of each row (0 for nulls)."""
    offs = col.offsets.data
    return (offs[1:] - offs[:-1]).to(torch.int32)


def byte_matrix(col: Column, max_len: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, max(max_len, 1)) uint8 matrix, zero-padded, and (N,) int32
    lengths of a STRING column; rows longer than ``max_len`` are cut."""
    expects(col.dtype.id == TypeId.STRING, "byte_matrix needs a STRING column")
    chars = col.child.data
    dev = col.device
    n = col.size
    lens = lengths(col)
    width = max(max_len, 1)
    if n == 0 or max_len == 0 or chars.shape[0] == 0:
        return torch.zeros((n, width), dtype=torch.uint8, device=dev), lens
    pos = torch.arange(max_len, dtype=torch.int64, device=dev)
    idx = col.offsets.data[:-1].to(torch.int64)[:, None] + pos
    mat = chars[idx.clamp_(0, int(chars.shape[0]) - 1)]
    return torch.where(pos < lens[:, None], mat, 0).to(torch.uint8), lens


def max_length(col: Column) -> int:
    """Host sync: the longest string's byte length."""
    if col.size == 0:
        return 0
    return int(lengths(col).max())


def from_byte_matrix(mat: np.ndarray, lens: np.ndarray,
                     valid: Optional[np.ndarray] = None, *,
                     device: torch.device) -> Column:
    """Host-side assembly of a STRING column from a byte matrix and
    per-row lengths."""
    mat = np.asarray(mat, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    n = mat.shape[0]
    expects(n == 0 or lens.max(initial=0) <= mat.shape[1],
            "row length exceeds byte-matrix width")
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    # row-major boolean selection lands row i's bytes at offsets[i]
    chars = mat[np.arange(mat.shape[1])[None, :] < lens[:, None]]
    return Column.strings_from_arrays(offsets, chars, valid, device=device)


def strings_from_matrix(mat: torch.Tensor, lens: torch.Tensor,
                        valid: Optional[torch.Tensor] = None) -> Column:
    """A STRING column assembled on ``mat``'s device from a uint8 byte
    matrix and per-row lengths: the offsets are the lengths' running
    sum and the chars each row's first ``lens`` bytes in row-major
    order (host syncs: the widest row, the byte count and whether any
    row is null). A validity with nulls is packed by K3
    (``bitmask.pack``); with none the column has no mask, as
    :func:`from_byte_matrix` gives it."""
    n, width = mat.shape
    lens = lens.to(torch.int64)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=mat.device)
    torch.cumsum(lens, 0, out=offsets[1:])
    expects(n == 0 or int(lens.max()) <= width,
            "row length exceeds byte-matrix width")
    expects(int(offsets[-1]) <= SIZE_TYPE_MAX,
            "chars buffer must stay below 2GB")
    pos = torch.arange(width, device=mat.device)
    chars = mat.to(torch.uint8)[pos < lens[:, None]]
    words = None
    if valid is not None and not bool(valid.all()):
        words = bitmask.pack(valid)
    return Column(STRING, n, None, words, children=(
        Column(INT32, n + 1, offsets.to(torch.int32)),
        Column(UINT8, int(chars.shape[0]), chars)))
