"""Sortable-key normalization, stable multi-key sorts and row ranking.

Port of ``spark_rapids_jni_tpu/ops/keys.py``. The reference maps every
column to uint32 sort lanes for XLA's multi-operand ``lax.sort``. torch
sorts one key at a time and lacks unsigned 32/64-bit arithmetic, so here
each column maps to ONE int64 key whose SIGNED order equals the value
order (the unsigned lane order with the sign bit flipped):

- signed integers widen to int64; uint64 flips its sign bit;
- floats take the IEEE total-order transform on their bit patterns. A
  float64 NaN first becomes the canonical ``0x7FF8000000000000``, as on
  the reference's TPU route (``utils/floatbits._f64_bits_arithmetic``),
  so every float64 NaN is one value, after +inf (Spark's order); -0.0
  stays below 0.0 and float32 keys keep their raw bits, as in the
  reference;
- a STRUCT maps to several keys, per field a validity plane (always,
  so the key count is a function of the type) and then the field's keys
  masked to 0 on its null rows (the reference's ``key_lanes``);
- descending order is ``~key`` (bitwise not is an order-reversing
  bijection on int64).

``key_lanes`` is the reference's lane form, kept for callers that need
its exact lanes: uint32 lane values (held in int64 tensors, torch having
no uint32 arithmetic) whose joint unsigned order is the value order,
STRING columns included (big-endian byte lanes and a length lane, at a
pad width ``string_pad_widths`` can make common across tables).

A multi-column order is a least-significant-first chain of stable sorts
(``torch.sort(stable=True)``), which equals the reference's
lexicographic sort with its trailing row-index tiebreak: ties keep input
order, so ``head(k)`` after a sort with ties picks the same rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import Column, Table
from ..types import TypeId
from ..utils.errors import expects, fail
from ..utils.floatbits import float32_to_bits, float64_to_bits
from ..obs import traced

_SIGN64 = -(1 << 63)  # int64 with only the sign bit set
_MAX64 = (1 << 63) - 1
_MAX32 = (1 << 31) - 1
CANONICAL_NAN64 = 0x7FF8000000000000


@traced("keys.sort_key")
def sort_key(col: Column, *, descending: bool = False) -> torch.Tensor:
    """One int64 key per row whose signed order is a leaf column's value
    order (null slots carry storage junk; callers add a null plane)."""
    tid = col.dtype.id
    data = col.data
    if tid == TypeId.FLOAT64:
        b = torch.where(torch.isnan(data), CANONICAL_NAN64,
                        float64_to_bits(data))
        key = torch.where(b < 0, b ^ _MAX64, b)
    elif tid == TypeId.FLOAT32:
        b = float32_to_bits(data)
        key = torch.where(b < 0, b ^ _MAX32, b).to(torch.int64)
    elif not col.dtype.is_fixed_width or col.dtype.storage_lanes != 1:
        fail(f"sort_key does not support {col.dtype!r}")
    elif data.dtype == torch.uint64:
        key = data.view(torch.int64) ^ _SIGN64
    else:
        key = data.to(torch.int64)
    return ~key if descending else key


def key_columns(col: Column, *, descending: bool = False
                ) -> List[torch.Tensor]:
    """int64 keys, most significant first, whose joint order is the
    column's value order: one for a leaf, and for a STRUCT per field its
    validity plane (nulls first) and its keys masked to 0 on null rows."""
    if col.dtype.id != TypeId.STRUCT:
        return [sort_key(col, descending=descending)]
    keys: List[torch.Tensor] = []
    for ch in col.children:
        # a STRING field's key count would depend on its data, which
        # breaks the count-is-a-function-of-the-type rule row_ranks needs
        expects(ch.dtype.id != TypeId.STRING,
                "STRING fields inside STRUCT keys are not supported")
        valid = ch.valid_bool()
        keys.append(valid.to(torch.int64))
        keys.extend(torch.where(valid, k, 0) for k in key_columns(ch))
    return [~k for k in keys] if descending else keys


_U32 = 0xFFFFFFFF


def _split64(bits: torch.Tensor) -> List[torch.Tensor]:
    """int64 bit patterns -> [high, low] uint32 lanes."""
    return [(bits >> 32) & _U32, bits & _U32]


@traced("keys.key_lanes")
def key_lanes(col: Column, *, descending: bool = False,
              string_pad: Optional[int] = None) -> List[torch.Tensor]:
    """The reference's sort lanes of a column, most significant first:
    int64 tensors holding uint32 values whose joint unsigned
    lexicographic order is the value order (null slots carry storage
    junk). A STRING column gives ceil(pad / 4) big-endian byte lanes and
    a length lane (Spark's binary order); ``string_pad`` overrides the
    pad width (default: the longest string, at least 1)."""
    tid = col.dtype.id
    data = col.data
    if tid == TypeId.STRING:
        from ..columnar.strings import byte_matrix, max_length
        m = string_pad if string_pad is not None else max(max_length(col), 1)
        m4 = ((m + 3) // 4) * 4
        mat, lens = byte_matrix(col, m4)
        mat = mat.to(torch.int64)
        lanes = [(mat[:, i] << 24) | (mat[:, i + 1] << 16)
                 | (mat[:, i + 2] << 8) | mat[:, i + 3]
                 for i in range(0, m4, 4)]
        lanes.append(lens.to(torch.int64))
    elif tid == TypeId.FLOAT64:
        b = float64_to_bits(data)
        lanes = _split64(torch.where(b < 0, ~b, b | _SIGN64))
    elif tid == TypeId.FLOAT32:
        b = float32_to_bits(data).to(torch.int64) & _U32
        lanes = [torch.where(b >> 31 == 1, b ^ _U32, b | (1 << 31))]
    elif tid == TypeId.DECIMAL128:
        lanes = _split64(data[:, 1] ^ _SIGN64) + _split64(data[:, 0])
    elif tid == TypeId.STRUCT:
        # per field: an unconditional validity plane (the lane count is a
        # function of the type), then its lanes masked to 0 on null rows
        lanes = []
        for ch in col.children:
            expects(ch.dtype.id != TypeId.STRING,
                    "STRING fields inside STRUCT keys are not supported")
            valid = ch.valid_bool()
            lanes.append(valid.to(torch.int64))
            lanes.extend(torch.where(valid, lane, 0)
                         for lane in key_lanes(ch))
    elif not col.dtype.is_fixed_width:
        fail(f"key_lanes does not support {col.dtype!r}")
    else:
        st = col.dtype.storage_dtype
        if st.kind == "u" and st.itemsize == 8:
            lanes = _split64(data.view(torch.int64))
        elif st.kind == "u":
            lanes = [data.to(torch.int64)]
        elif st.itemsize == 8:
            lanes = _split64(data.to(torch.int64) ^ _SIGN64)
        else:  # signed <= 32-bit storage
            lanes = [(data.to(torch.int64) & _U32) ^ (1 << 31)]
    if descending:
        lanes = [lane ^ _U32 for lane in lanes]
    return lanes


def null_plane(col: Column, *, nulls_first: bool = True) -> torch.Tensor:
    """0/1 int64 key putting nulls first (0 for null) or last."""
    valid = col.valid_bool().to(torch.int64)
    return valid if nulls_first else 1 - valid


def stable_lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting rows by ``keys`` (first most
    significant): a chain of stable sorts from the least significant
    key up."""
    expects(len(keys) > 0, "need at least one sort key")
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(list(keys)):
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return perm


@traced("keys.lexsort_indices")
def lexsort_indices(columns: Sequence[Column],
                    descending: Optional[Sequence[bool]] = None,
                    nulls_first: Optional[Sequence[bool]] = None
                    ) -> torch.Tensor:
    """Stable multi-column sort permutation (first column most
    significant), nulls first by default (cudf's BEFORE)."""
    n_cols = len(columns)
    expects(n_cols > 0, "need at least one sort column")
    descending = list(descending or [False] * n_cols)
    nulls_first = list(nulls_first or [True] * n_cols)
    keys: List[torch.Tensor] = []
    for col, desc, nf in zip(columns, descending, nulls_first):
        if col.validity is not None:
            keys.append(null_plane(col, nulls_first=nf))
        keys.extend(key_columns(col, descending=desc))
    return stable_lexsort(keys)


def _bucket_pad(n: int) -> int:
    """A string pad width rounded up to the {2^k, 1.5 * 2^k} grid, at
    least 4, as in the reference (there it bounds recompiles)."""
    if n <= 4:
        return 4
    p = 1 << (n - 1).bit_length()
    if 3 * (p >> 2) >= n:
        return 3 * (p >> 2)
    return p


@traced("keys.string_pad_widths")
def string_pad_widths(tables: Sequence[Table]) -> Tuple[int, ...]:
    """The common byte-matrix pad width of each STRING key column across
    ``tables`` (a host sync), bucketed as the reference buckets it; empty
    when no key column is a string. Pass each to ``key_lanes``'s
    ``string_pad`` so every table gets the same lane count."""
    from ..columnar.strings import max_length
    return tuple(
        _bucket_pad(max(max_length(t.columns[ci]) for t in tables))
        for ci in range(tables[0].num_columns)
        if tables[0].columns[ci].dtype.id == TypeId.STRING)


@traced("keys.row_ranks")
def row_ranks(tables: Sequence[Table], *, nulls_equal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense group ids of row tuples across tables sharing a schema.

    Returns ``(sorted_ranks, perm)``: ``perm`` is the stable sort
    permutation over the concatenated row space (table 0's rows first)
    and ``sorted_ranks`` the nondecreasing group id at each sorted
    position. ``nulls_equal=False`` (join semantics) puts every row with
    a null key in a group of its own; ``True`` (GROUP BY) groups nulls.
    """
    expects(len(tables) > 0, "need at least one table")
    schema0 = [c.type_signature() for c in tables[0].columns]
    for t in tables[1:]:
        expects([c.type_signature() for c in t.columns] == schema0,
                "key tables must share a schema (struct fields included)")
    total = sum(t.num_rows for t in tables)
    expects(total < 2**31, "combined rank input must stay under 2^31 rows")
    keys: List[torch.Tensor] = []
    any_null = None
    for ci in range(len(schema0)):
        cols = [t.columns[ci] for t in tables]
        per_table = [key_columns(c) for c in cols]
        col_keys = [torch.cat([pt[k] for pt in per_table])
                    for k in range(len(per_table[0]))]
        if any(c.validity is not None for c in cols):
            valid = torch.cat([c.valid_bool() for c in cols])
            keys.append(valid.to(torch.int64))
            keys.extend(torch.where(valid, k, 0) for k in col_keys)
            any_null = ~valid if any_null is None else any_null | ~valid
        else:
            keys.extend(col_keys)
    if not nulls_equal and any_null is not None:
        iota = torch.arange(1, total + 1, dtype=torch.int64,
                            device=keys[0].device)
        keys.append(torch.where(any_null, iota, 0))
    perm = stable_lexsort(keys)
    new_group = torch.zeros(total, dtype=torch.bool, device=perm.device)
    if total:
        new_group[0] = True
        for k in keys:
            sk = k[perm]
            new_group[1:] |= sk[1:] != sk[:-1]
    sorted_ranks = torch.cumsum(new_group.to(torch.int64), 0) - 1
    return sorted_ranks, perm
