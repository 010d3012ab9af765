"""Copying ops: filter, slice, concatenate (cudf ``copying/``).

Port of ``spark_rapids_jni_tpu/ops/copying.py``. ``apply_boolean_mask``
is the Spark filter exec: one host sync for the surviving rows (the
count ``torch.nonzero`` must know), then a gather. ``concatenate``
keeps the 2 GB ``size_type`` caps; the validity of every result goes
through ``bitmask.pack`` (K3 on the card).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from ..columnar import Column, Table, bitmask
from ..types import SIZE_TYPE_MAX, TypeId
from ..utils.errors import expects
from ..obs import traced
from .sort import gather


@traced("copying.apply_boolean_mask")
def apply_boolean_mask(table: Table, mask: Union[torch.Tensor, Column]
                       ) -> Table:
    """Keep rows where mask is True (null mask rows drop, like Spark
    WHERE)."""
    if isinstance(mask, Column):
        keep = (mask.data != 0) & mask.valid_bool()
    else:
        keep = mask.to(torch.bool)
    expects(keep.shape[0] == table.num_rows, "mask length mismatch")
    idx = torch.nonzero(keep)[:, 0]  # host sync: surviving row count
    return gather(table, idx)


@traced("copying.slice_rows")
def slice_rows(table: Table, start: int, end: int) -> Table:
    """Contiguous row slice [start, end)."""
    expects(0 <= start <= end <= table.num_rows, "bad slice bounds")
    dev = table.columns[0].device if table.columns else None
    return gather(table, torch.arange(start, end, dtype=torch.int64,
                                      device=dev))


@traced("copying.concatenate")
def concatenate(tables: Sequence[Table]) -> Table:
    """Vertically concatenate tables with identical schemas."""
    expects(len(tables) > 0, "need at least one table")
    schema0 = [c.type_signature() for c in tables[0].columns]
    for t in tables[1:]:
        expects([c.type_signature() for c in t.columns] == schema0,
                "concatenate requires identical schemas "
                "(struct fields included)")
    return Table([concat_columns([t.columns[ci] for t in tables])
                  for ci in range(len(schema0))])


@traced("copying.concat_columns")
def concat_columns(parts: Sequence[Column]) -> Column:
    """Concatenate columns of one dtype (recursive over nested
    children)."""
    dt = parts[0].dtype
    total = sum(p.size for p in parts)
    validity = None
    if any(p.validity is not None for p in parts):
        validity = bitmask.pack(torch.cat([p.valid_bool() for p in parts]))
    if dt.id == TypeId.STRUCT:
        children = tuple(
            concat_columns([p.children[k] for p in parts])
            for k in range(len(parts[0].children)))
        # schema metadata: the first named part wins, so the result does
        # not depend on whether an unnamed batch comes first; conflicting
        # names are a real schema mismatch
        named = [p.field_names for p in parts if p.field_names is not None]
        expects(all(n == named[0] for n in named),
                "concat of structs with conflicting field names")
        return Column(dt, total, None, validity, children=children,
                      field_names=named[0] if named else None)
    if dt.id in (TypeId.STRING, TypeId.LIST):
        expects((total + 1) * 4 <= SIZE_TYPE_MAX,
                "concatenated offsets buffer would exceed the 2GB cap")
        sizes = [p.child.size for p in parts]
        expects(sum(sizes) <= SIZE_TYPE_MAX,
                "concatenated chars buffer would exceed the 2GB cap")
        # int64 bases: each part's offsets move by the elements before it
        bases, new_offs = 0, []
        for p, size in zip(parts, sizes):
            new_offs.append(p.offsets.data[:-1].to(torch.int64) + bases)
            bases += size
        last = parts[-1].offsets.data[-1:].to(torch.int64) \
            + (bases - sizes[-1])
        offs = torch.cat(new_offs + [last]).to(torch.int32)
        return Column(dt, total, None, validity, children=(
            Column(parts[0].offsets.dtype, total + 1, offs),
            concat_columns([p.child for p in parts])))
    expects(total * dt.size_bytes <= SIZE_TYPE_MAX,
            "concatenated column would exceed the 2GB size_type cap")
    return Column(dt, total, torch.cat([p.data for p in parts]), validity)
