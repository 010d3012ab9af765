"""Group-by aggregation, the general sort-based path.

Port of ``spark_rapids_jni_tpu/ops/groupby.py`` for the aggregations
this slice uses (sum, count, count_all, mean, min, max). Keys are ranked
by one stable sort (GROUP BY null semantics: null keys form one group);
groups come out in sorted key order.

Sums accumulate per group with ``index_add_`` over the sorted rows. The
reference reads cumulative-sum differences at segment boundaries
instead, because scatter-adds serialize on a TPU; a float sum therefore
differs from the reference's in the last bits (its boundary differences
carry about eps x |global prefix| of rounding), integral sums are
identical (exact mod 2^64). min/max re-sort by (group, value) and read
the segment head or tail, which gives Spark's float ordering (NaN
greatest), as in the reference.

The var/std/first/last/any/all/nunique aggregations are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..columnar import Column, Table, bitmask
from ..types import DType, TypeId, INT64, FLOAT64
from ..utils.errors import expects
from .keys import row_ranks, sort_key, stable_lexsort
from .sort import gather
from ..obs import traced

SUPPORTED_AGGS = ("sum", "count", "count_all", "min", "max", "mean")


def result_dtype(agg: str, in_dtype: DType) -> DType:
    """Spark result types: count -> long, mean -> double, sum(integral)
    -> long, sum(float) -> double, min/max keep the input type."""
    if agg in ("count", "count_all"):
        return INT64
    if agg == "mean":
        return FLOAT64
    if agg == "sum":
        if in_dtype.is_floating:
            return FLOAT64
        if in_dtype.is_decimal:
            return DType(TypeId.DECIMAL64, in_dtype.scale)
        return INT64
    return in_dtype


def _segment_sum(x: torch.Tensor, gid: torch.Tensor, n_groups: int):
    out = torch.zeros(n_groups, dtype=x.dtype, device=x.device)
    return out.index_add_(0, gid, x)


def _extreme(col: Column, svalid, sv, gid, head_pos, tail_pos,
             take_min: bool):
    """Per-group min/max via a (group, value) stable sort. Null rows get
    a key past every value (min) or before it (max); a group with no
    valid row is masked by the caller."""
    vkey = sort_key(Column(col.dtype, sv.shape[0], sv))
    if col.dtype.is_floating:
        # every NaN is one value, greater than anything (Spark)
        vkey = torch.where(torch.isnan(sv), torch.iinfo(torch.int64).max - 1,
                           vkey)
    null_key = (torch.iinfo(torch.int64).max if take_min
                else torch.iinfo(torch.int64).min)
    vkey = torch.where(svalid, vkey, null_key)
    order = stable_lexsort([gid, vkey])
    pos = head_pos if take_min else tail_pos
    return sv[order][pos]


@traced("groupby.groupby_aggregate")
def groupby_aggregate(keys: Table, values: Table,
                      aggs: Sequence[Tuple[int, str]]) -> Table:
    """GROUP BY ``keys`` with aggregations over ``values`` columns.

    ``aggs`` is a list of (value column index, agg name). Returns the
    unique key columns followed by one column per aggregation."""
    expects(keys.num_rows == values.num_rows,
            "keys and values must have the same row count")
    for ci, agg in aggs:
        expects(0 <= ci < values.num_columns, f"bad value column {ci}")
        expects(agg in SUPPORTED_AGGS, f"unsupported aggregation {agg!r}")
    n = keys.num_rows
    sorted_ranks, perm = row_ranks([keys], nulls_equal=True)
    n_groups = int(sorted_ranks[-1]) + 1 if n else 0  # host sync
    dev = perm.device
    if n_groups == 0:
        out = [Column(c.dtype, 0, torch.zeros(0, dtype=c.dtype.to_torch(),
                                              device=dev))
               for c in keys.columns]
        for ci, agg in aggs:
            dt = result_dtype(agg, values.column(ci).dtype)
            out.append(Column(dt, 0, torch.zeros(0, dtype=dt.to_torch(),
                                                 device=dev)))
        return Table(out)
    gid = sorted_ranks
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    head_pos = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
    is_head = torch.ones(n, dtype=torch.bool, device=dev)
    is_head[1:] = gid[1:] != gid[:-1]
    head_pos[torch.where(is_head, gid, n_groups)] = pos
    head_pos = head_pos[:n_groups]
    tail_pos = torch.cat([head_pos[1:],
                          torch.full((1,), n, dtype=torch.int64,
                                     device=dev)]) - 1
    out_cols: List[Column] = list(gather(keys, perm[head_pos]).columns)
    for ci, agg in aggs:
        col = values.column(ci)
        out_dt = result_dtype(agg, col.dtype)
        acc = out_dt.to_torch()
        if agg == "count_all":
            data = (tail_pos - head_pos + 1).to(acc)
            out_cols.append(Column(out_dt, n_groups, data))
            continue
        sv = col.data[perm]
        svalid = col.valid_bool()[perm]
        cnt = _segment_sum(svalid.to(torch.int64), gid, n_groups)
        if agg == "count":
            out_cols.append(Column(out_dt, n_groups, cnt.to(acc)))
            continue
        has_any = cnt > 0
        if agg == "sum":
            data = _segment_sum(torch.where(svalid, sv.to(acc), 0), gid,
                                n_groups)
        elif agg == "mean":
            s = _segment_sum(torch.where(svalid, sv.to(torch.float64), 0.0),
                             gid, n_groups)
            data = s / torch.where(has_any, cnt, 1).to(torch.float64)
        else:
            data = _extreme(col, svalid, sv, gid, head_pos, tail_pos,
                            take_min=(agg == "min")).to(acc)
        out_cols.append(Column(out_dt, n_groups, data,
                               bitmask.pack(has_any)))
    return Table(out_cols)
