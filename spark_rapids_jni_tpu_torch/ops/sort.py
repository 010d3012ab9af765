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
    an empty result drops them. A STRING column's bytes are gathered
    through new offsets (one host sync: the gathered byte count)."""
    validity = None
    if col.validity is not None:
        validity = bitmask.pack(col.valid_bool()[indices])
    n_out = int(indices.shape[0])
    if col.dtype.id == TypeId.STRING:
        return _gather_strings(col, indices.to(torch.int64), validity)
    data = col.data[indices]
    return Column(col.dtype, n_out, data, validity,
                  value_range=col.value_range if n_out else None)


def _gather_strings(col: Column, indices: torch.Tensor,
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
    chars = col.child.data[pos]
    return Column(col.dtype, n, None, validity, children=(
        Column(col.offsets.dtype, n + 1, new_offs.to(torch.int32)),
        Column(col.child.dtype, total, chars)))


@traced("sort.gather")
def gather(table: Table, indices: torch.Tensor) -> Table:
    """Row gather, the ``cudf::gather`` analog."""
    return Table([gather_column(c, indices) for c in table.columns])
