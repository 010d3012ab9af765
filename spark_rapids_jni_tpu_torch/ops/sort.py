"""Table sorting and row gathers (``cudf::sorted_order`` / ``gather``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..columnar import Column, Table, bitmask
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
    an empty result drops them."""
    data = col.data[indices]
    validity = None
    if col.validity is not None:
        validity = bitmask.pack(col.valid_bool()[indices])
    n_out = int(indices.shape[0])
    return Column(col.dtype, n_out, data, validity,
                  value_range=col.value_range if n_out else None)


@traced("sort.gather")
def gather(table: Table, indices: torch.Tensor) -> Table:
    """Row gather, the ``cudf::gather`` analog."""
    return Table([gather_column(c, indices) for c in table.columns])
