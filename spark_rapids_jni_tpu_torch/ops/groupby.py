"""Group-by aggregation, the general sort-based path.

Port of ``spark_rapids_jni_tpu/ops/groupby.py`` with all of its
aggregations (``SUPPORTED_AGGS``). Keys are ranked by one stable sort
(GROUP BY null semantics: null keys form one group; a STRUCT key sorts
field by field); groups come out in sorted key order.

Integral totals (counts, any/all, nunique, integral sums) are
cumulative-sum differences at the group boundaries, as in the
reference: exact mod 2^64, and no atomics (a skewed key's hot group
would serialize them). Float sums (and so mean, var and std) accumulate
per group with ``index_add_`` instead: a boundary difference carries
about eps x |global prefix| of rounding, so a float sum differs from the
reference's in the last bits. min/max re-sort by (group, value) and
first/last by (group, validity), and read the segment head or tail,
which gives Spark's float ordering (NaN greatest), as in the reference.

Spark semantics: null values are skipped inside a group; an all-null
group gives NULL for sum/min/max/mean/first/last/any/all; count skips
nulls (COUNT(col)) and count_all counts rows (COUNT(*)); var and std
are the sample statistics, NULL below two values, computed in two
passes (the mean, then centered squares) so that {1e9, 1e9 + 1} does
not cancel to 0; first/last take the first/last valid value in input
order within the group (the stable sort keeps it, as the reference's
row-index tiebreak does); any/all are bool_or/bool_and over BOOL8;
nunique counts distinct valid values, every NaN as one value, and keeps
a null row apart from a valid row that stores the null's fill value.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..columnar import Column, Table, bitmask
from ..types import DType, TypeId, BOOL8, INT64, FLOAT64
from ..utils.errors import expects, fail
from .keys import row_ranks, sort_key, stable_lexsort
from .sort import gather
from ..obs import traced

SUPPORTED_AGGS = ("sum", "count", "count_all", "min", "max", "mean",
                  "var", "std", "first", "last", "any", "all", "nunique")


def result_dtype(agg: str, in_dtype: DType) -> DType:
    """Spark result types: count/count_all/nunique -> long, mean/var/std
    -> double, any/all -> boolean, sum(integral) -> long, sum(float) ->
    double, min/max/first/last keep the input type."""
    if agg in ("count", "count_all", "nunique"):
        return INT64
    if agg in ("mean", "var", "std"):
        return FLOAT64
    if agg in ("any", "all"):
        return BOOL8
    if agg == "sum":
        if in_dtype.is_floating:
            return FLOAT64
        if in_dtype.is_decimal:
            return DType(TypeId.DECIMAL64, in_dtype.scale)
        return INT64
    return in_dtype


def _segment_sum(x: torch.Tensor, gid: torch.Tensor, n_groups: int):
    """Per-group float sums of group-sorted rows (``index_add_``)."""
    out = torch.zeros(n_groups, dtype=x.dtype, device=x.device)
    return out.index_add_(0, gid, x)


def _segment_total(x: torch.Tensor, head_pos, tail_pos) -> torch.Tensor:
    """Per-group int64 totals of group-sorted rows: cumulative-sum
    differences at the group boundaries (exact mod 2^64)."""
    c = torch.cumsum(x.to(torch.int64), 0)
    return c[tail_pos] - c[head_pos] + x[head_pos]


def sorted_phase(keys: Table) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Rank-sort the key rows: (sorted group id of each sorted row, the
    sort permutation, the group count: a host sync)."""
    sorted_ranks, perm = row_ranks([keys], nulls_equal=True)
    n = sorted_ranks.shape[0]
    return sorted_ranks, perm, int(sorted_ranks[-1]) + 1 if n else 0


def group_layout(gid: torch.Tensor, n_groups: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head and tail sorted positions of each group (the reference's
    ``_group_layout``); ``perm[head]`` are representative rows."""
    n = gid.shape[0]
    dev = gid.device
    head = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
    is_head = torch.ones(n, dtype=torch.bool, device=dev)
    is_head[1:] = gid[1:] != gid[:-1]
    head[torch.where(is_head, gid, n_groups)] = torch.arange(
        n, dtype=torch.int64, device=dev)
    head = head[:n_groups]
    tail = torch.cat([head[1:], torch.full((1,), n, dtype=torch.int64,
                                           device=dev)]) - 1
    return head, tail


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


def _nunique(col: Column, sv, svalid, gid, head_pos, tail_pos
             ) -> torch.Tensor:
    """Distinct valid values per group: sort by (group, null, value) and
    count run heads. Validity is a key, so a null row never joins the
    run of a valid value equal to its stored fill."""
    n = sv.shape[0]
    vkey = sort_key(Column(col.dtype, n, sv))
    order = stable_lexsort([gid, (~svalid).to(torch.int64), vkey])
    v2, va2 = sv[order], svalid[order]
    same = v2[1:] == v2[:-1]  # -0.0 equals 0.0 and sorts next to it
    if col.dtype.is_floating:
        same |= torch.isnan(v2[1:]) & torch.isnan(v2[:-1])
    new_run = torch.ones(n, dtype=torch.bool, device=sv.device)
    new_run[1:] = ~same | (gid[1:] != gid[:-1]) | (va2[1:] != va2[:-1])
    return _segment_total(new_run & va2, head_pos, tail_pos)


def _first_last(sv, svalid, gid, head_pos, tail_pos, first: bool):
    """The first (last) valid value of each group in input order: a
    stable sort by (group, validity) puts a group's valid rows first
    (last), in their order, so the group's head (tail) holds it."""
    flag = ~svalid if first else svalid
    order = stable_lexsort([gid * 2 + flag.to(torch.int64)])
    return sv[order[head_pos if first else tail_pos]]


def _moments(sv, svalid, cnt, gid, n_groups: int, centered: bool):
    """Per-group mean and, if ``centered``, the sum of squares about it
    (the second pass of var/std); else None."""
    x = sv.to(torch.float64)
    s = _segment_sum(torch.where(svalid, x, 0.0), gid, n_groups)
    mean = s / torch.where(cnt > 0, cnt, 1).to(torch.float64)
    if not centered:
        return mean, None
    d = torch.where(svalid, x - mean[gid], 0.0)
    return mean, _segment_sum(d * d, gid, n_groups)


def _sorted_agg(agg: str, col: Column, sv, svalid, cnt, mean, ss, gid,
                n_groups: int, head_pos, tail_pos):
    """One aggregation over rank-sorted values: (data, valid or None);
    ``cnt`` is the group's valid-value count, ``mean`` and ``ss`` its
    ``_moments`` where a mean, var or std needs them."""
    acc = result_dtype(agg, col.dtype).to_torch()
    if agg == "count_all":
        return (tail_pos - head_pos + 1).to(acc), None
    if agg == "nunique":
        return _nunique(col, sv, svalid, gid, head_pos, tail_pos), None
    if agg == "count":
        return cnt.to(acc), None
    has_any = cnt > 0
    if agg == "sum":
        x = torch.where(svalid, sv.to(acc), 0)
        return (_segment_sum(x, gid, n_groups) if col.dtype.is_floating
                else _segment_total(x, head_pos, tail_pos)), has_any
    if agg == "mean":
        return mean, has_any
    if agg in ("var", "std"):
        var = ss / torch.where(cnt > 1, cnt - 1, 1).to(torch.float64)
        return (torch.sqrt(var) if agg == "std" else var), cnt > 1
    if agg in ("first", "last"):
        return _first_last(sv, svalid, gid, head_pos, tail_pos,
                           agg == "first"), has_any
    if agg in ("any", "all"):
        hit = (sv != 0) if agg == "any" else (sv == 0)
        k = _segment_total(hit & svalid, head_pos, tail_pos)
        return ((k > 0) if agg == "any" else (k == 0)).to(acc), has_any
    if agg in ("min", "max"):
        return _extreme(col, svalid, sv, gid, head_pos, tail_pos,
                        take_min=(agg == "min")).to(acc), has_any
    fail(f"unsupported aggregation {agg!r}")


@traced("groupby.groupby_aggregate")
def groupby_aggregate(keys: Table, values: Table,
                      aggs: Sequence[Tuple[int, str]]) -> Table:
    """GROUP BY ``keys`` with aggregations over ``values`` columns.

    ``aggs`` is a list of (value column index, agg name). Returns the
    unique key columns followed by one column per aggregation; a result
    that can be NULL carries validity words (K3)."""
    expects(keys.num_rows == values.num_rows,
            "keys and values must have the same row count")
    for ci, agg in aggs:
        expects(0 <= ci < values.num_columns, f"bad value column {ci}")
        expects(agg in SUPPORTED_AGGS, f"unsupported aggregation {agg!r}")
    gid, perm, n_groups = sorted_phase(keys)
    if n_groups == 0:
        out = list(gather(keys, perm).columns)
        for ci, agg in aggs:
            dt = result_dtype(agg, values.column(ci).dtype)
            out.append(Column(dt, 0, torch.zeros(0, dtype=dt.to_torch(),
                                                 device=perm.device)))
        return Table(out)
    head_pos, tail_pos = group_layout(gid, n_groups)
    out_cols: List[Column] = list(gather(keys, perm[head_pos]).columns)
    moment_cols = {ci for ci, a in aggs if a in ("mean", "var", "std")}
    centered_cols = {ci for ci, a in aggs if a in ("var", "std")}
    sorted_vals = {}  # one gather, count and moments per value column
    for ci, agg in aggs:
        col = values.column(ci)
        if ci not in sorted_vals:
            sv, svalid = col.data[perm], col.valid_bool()[perm]
            cnt = _segment_total(svalid, head_pos, tail_pos)
            mean, ss = (_moments(sv, svalid, cnt, gid, n_groups,
                                 ci in centered_cols)
                        if ci in moment_cols else (None, None))
            sorted_vals[ci] = (sv, svalid, cnt, mean, ss)
        data, valid = _sorted_agg(agg, col, *sorted_vals[ci], gid, n_groups,
                                  head_pos, tail_pos)
        out_cols.append(Column(result_dtype(agg, col.dtype), n_groups, data,
                               None if valid is None
                               else bitmask.pack(valid)))
    return Table(out_cols)
