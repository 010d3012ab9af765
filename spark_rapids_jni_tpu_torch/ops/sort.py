"""Table sorting and row gathers (``cudf::sorted_order`` / ``gather``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..columnar import Column, Table, bitmask
from ..types import TypeId
from .keys import lexsort_indices
from ..obs import traced


@traced("sort.sorted_order")
def sorted_order(keys: Table, descending: Optional[Sequence[bool]] = None,
                 nulls_first: Optional[Sequence[bool]] = None
                 ) -> torch.Tensor:
    """Stable permutation that sorts ``keys`` (first column primary)."""
    return lexsort_indices(keys.columns, descending, nulls_first)


def gather_column(col: Column, indices: torch.Tensor) -> Column:
    """Row gather of one column. Gathered values are a subset of the
    source, so its ingest min/max stay valid (possibly loose) bounds;
    an empty result drops them. A STRING or LIST column's elements are
    gathered through new offsets (one host sync: the gathered element
    count); a STRUCT gathers each field and keeps its field names."""
    validity = None
    if col.validity is not None:
        validity = bitmask.pack(col.valid_bool()[indices])
    n_out = int(indices.shape[0])
    if col.dtype.id in (TypeId.STRING, TypeId.LIST):
        return _gather_ragged(col, indices.to(torch.int64), validity)
    if col.dtype.id == TypeId.STRUCT:
        return Column(col.dtype, n_out, None, validity, children=tuple(
            gather_column(c, indices) for c in col.children),
            field_names=col.field_names)
    data = col.data[indices]
    return Column(col.dtype, n_out, data, validity,
                  value_range=col.value_range if n_out else None)


def _gather_ragged(col: Column, indices: torch.Tensor,
                   validity) -> Column:
    offs = col.offsets.data.to(torch.int64)
    starts = offs[indices]
    lens = offs[indices + 1] - starts
    n = int(indices.shape[0])
    new_offs = torch.zeros(n + 1, dtype=torch.int64, device=offs.device)
    torch.cumsum(lens, 0, out=new_offs[1:])
    total = int(new_offs[-1])
    row = torch.repeat_interleave(
        torch.arange(n, device=offs.device), lens, output_size=total)
    pos = starts[row] + torch.arange(total, device=offs.device) \
        - new_offs[row]
    return Column(col.dtype, n, None, validity, children=(
        Column(col.offsets.dtype, n + 1, new_offs.to(torch.int32)),
        gather_column(col.child, pos)))


@traced("sort.gather")
def gather(table: Table, indices: torch.Tensor) -> Table:
    """Row gather, the ``cudf::gather`` analog."""
    return Table([gather_column(c, indices) for c in table.columns])


@traced("sort.sort_by_key")
def sort_by_key(values: Table, keys: Table,
                descending: Optional[Sequence[bool]] = None,
                nulls_first: Optional[Sequence[bool]] = None) -> Table:
    """Reorder ``values`` by the sort order of ``keys``."""
    return gather(values, sorted_order(keys, descending, nulls_first))


@traced("sort.sort")
def sort(table: Table, **kwargs) -> Table:
    """Sort a table by all of its columns."""
    return sort_by_key(table, table, **kwargs)
