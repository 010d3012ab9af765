"""Histogram aggregate and exact percentile (Spark ``percentile``).

Port of ``spark_rapids_jni_tpu/ops/histogram.py`` (the mainline
``histogram.cu``: per-group (value, count) pairs, merged partials, the
interpolation at the end). Everything runs in sorted-segment space on
the device; counts are exact int64 cumulative-sum differences:

- ``group_histogram``: per-group run-length encoding of the sorted
  values, the MAP layout LIST<STRUCT<value FLOAT64, count INT64>>.
- ``merge_histograms``: a merge is concatenate plus a count-weighted
  rebuild. A zero-weight sentinel row a group (value NaN) keeps groups
  whose partial histograms are empty; zero-count runs are dropped.
- ``group_percentile`` / ``percentile_from_histogram``: Spark's
  interpolation at position p * (N - 1) of the expanded values,
  ``lo + (hi - lo) * frac`` in float64; null values are ignored and an
  empty group gives NULL. Ranks over a histogram are a ``searchsorted``
  against the running count; the expansion is never built.

A run is a group's stretch of ``==``-equal sorted values, as in the
reference: -0.0 (which sorts first) and 0.0 share a run that carries
-0.0, and every NaN is a run of its own. Spark's ``Percentile`` counts
values in a hash map keyed by Java ``Double`` equality instead: -0.0
and 0.0 apart, every NaN as one value.

The groups are the port's ``groupby.sorted_phase`` (one host sync, the
group count); the runs cost one more (the kept runs, one
``nonzero``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..columnar import Column, Table, bitmask
from ..types import FLOAT64, INT32, INT64, LIST, STRUCT, TypeId
from ..utils.errors import expects
from ..obs import traced
from .groupby import group_layout, sorted_phase
from .keys import sort_key, stable_lexsort
from .sort import gather


def _sorted_by_key_value(keys: Table, values: Column):
    """Sort rows by (group, value null last, value) -> the sorted group
    id, value (float64), valid flag, the permutation and the group
    count."""
    n = keys.num_rows
    gid, perm, n_groups = sorted_phase(keys)
    ranks = torch.empty_like(gid)
    ranks[perm] = gid  # each row's group in input order
    valid = values.valid_bool()
    vf = values.data.to(torch.float64)
    order = stable_lexsort([2 * ranks + (~valid).to(torch.int64),
                            sort_key(Column(FLOAT64, n, vf))])
    return ranks[order], vf[order], valid[order], order, n_groups


def _layout(sr: torch.Tensor, order: torch.Tensor, n_groups: int):
    """(head, tail, representative rows) of each group."""
    head, tail = group_layout(sr, n_groups)
    return head, tail, order[head]


def _seg_sum(x: torch.Tensor, head: torch.Tensor, tail: torch.Tensor):
    """Inclusive head..tail segment totals via cumsum differences."""
    c = torch.cumsum(x, 0)
    return c[tail] - c[head] + x[head]


def _runs(sr: torch.Tensor, same: torch.Tensor, weights: torch.Tensor):
    """Runs of sorted rows (a new run where ``same`` is False) that hold
    weight: (head positions, weight totals) of the kept runs; one host
    sync, the kept-run count. Totals are the reference's cumsum
    differences over each run."""
    n = sr.shape[0]
    dev = sr.device
    run_head = ~same
    run_id = torch.cumsum(run_head.to(torch.int64), 0) - 1
    run_tail = torch.ones(n, dtype=torch.bool, device=dev)
    run_tail[:-1] = run_head[1:]
    tail_of = torch.empty(n + 1, dtype=torch.int64, device=dev)
    tail_of.scatter_(0, torch.where(run_tail, run_id, n),
                     torch.arange(n, device=dev))
    tails = tail_of[run_id]
    c = torch.cumsum(weights, 0)
    totals = c[tails] - c + weights  # the run's total at its head rows
    kept = torch.nonzero(run_head & (totals > 0))[:, 0]
    return kept, tails[kept], totals[kept]


def _empty_keys(keys: Table) -> Table:
    return gather(keys, torch.zeros(0, dtype=torch.int64,
                                    device=keys.columns[0].device))


def _list_of_struct(offsets: torch.Tensor, names: Tuple[str, str],
                    a: Column, b: Column) -> Column:
    n_groups = int(offsets.shape[0]) - 1
    struct = Column(STRUCT, a.size, None, children=(a, b), field_names=names)
    return Column(LIST, n_groups, None, children=(
        Column(INT32, n_groups + 1, offsets.to(torch.int32)), struct))


def _empty_hist(n_groups: int, dev) -> Column:
    return _list_of_struct(
        torch.zeros(n_groups + 1, dtype=torch.int32, device=dev),
        ("value", "count"),
        Column(FLOAT64, 0, torch.zeros(0, dtype=torch.float64, device=dev)),
        Column(INT64, 0, torch.zeros(0, dtype=torch.int64, device=dev)))


def _group_offsets(run_group: torch.Tensor, n_groups: int) -> torch.Tensor:
    return torch.searchsorted(run_group, torch.arange(
        n_groups + 1, dtype=run_group.dtype, device=run_group.device))


def _interpolate(vals, lo, hi, frac):
    v_lo, v_hi = vals[lo], vals[hi]
    return v_lo + (v_hi - v_lo) * frac


@traced("histogram.group_percentile")
def group_percentile(keys: Table, values: Column,
                     percentages: Sequence[float]) -> Table:
    """GROUP BY keys -> exact interpolated percentile(s) of ``values``.

    Returns unique keys + one FLOAT64 column per requested percentage.
    """
    expects(keys.num_rows == values.size, "row count mismatch")
    for p in percentages:
        expects(0.0 <= p <= 1.0, "percentage must be in [0, 1]")
    sr, sval, svalid, order, n_groups = _sorted_by_key_value(keys, values)
    if n_groups == 0:
        return Table(list(_empty_keys(keys).columns) + [
            Column(FLOAT64, 0, sval[:0]) for _ in percentages])
    n = sr.shape[0]
    head, tail, rep = _layout(sr, order, n_groups)
    # valid (non-null) count per group; nulls sort to each group's end
    n_valid = _seg_sum(svalid.to(torch.int64), head, tail)
    out = list(gather(keys, rep).columns)
    for p in percentages:
        pos = torch.clamp_min(p * (n_valid - 1).to(torch.float64), 0.0)
        lo = torch.floor(pos).to(torch.int64)
        frac = pos - lo
        hi = torch.minimum(lo + 1, torch.clamp_min(n_valid - 1, 0))
        res = _interpolate(sval, torch.clamp_max(head + lo, n - 1),
                           torch.clamp_max(head + hi, n - 1), frac)
        out.append(Column(FLOAT64, n_groups, res, bitmask.pack(n_valid > 0)))
    return Table(out)


def _runs_to_hist(sr, sval, weights, order, n_groups: int, keys: Table):
    """The shared build: RLE over sorted (group, value) with per-row
    weights; zero-weight rows are dropped from the runs but still claim
    their group. Returns (unique-keys Table, histogram LIST column)."""
    n = sr.shape[0]
    if n == 0 or n_groups == 0:
        return _empty_keys(keys), _empty_hist(n_groups, sr.device)
    rep = _layout(sr, order, n_groups)[2]
    same = torch.zeros(n, dtype=torch.bool, device=sr.device)
    same[1:] = (sval[1:] == sval[:-1]) & (sr[1:] == sr[:-1])
    kept, _, counts = _runs(sr, same, weights.to(torch.int64))
    offs = _group_offsets(sr[kept], n_groups)
    nk = int(kept.shape[0])
    return gather(keys, rep), _list_of_struct(
        offs, ("value", "count"), Column(FLOAT64, nk, sval[kept]),
        Column(INT64, nk, counts))


@traced("histogram.group_histogram")
def group_histogram(keys: Table, values: Column) -> Tuple[Table, Column]:
    """GROUP BY keys -> histogram of ``values`` per group.

    Returns (unique-keys Table, LIST<STRUCT<value FLOAT64, count INT64>>
    aligned with it). Null values are excluded; a group of only nulls
    keeps an empty list."""
    expects(keys.num_rows == values.size, "row count mismatch")
    sr, sval, svalid, order, n_groups = _sorted_by_key_value(keys, values)
    return _runs_to_hist(sr, sval, svalid, order, n_groups, keys)


def partial_rows(parts: Sequence[Tuple[Table, Column]], fill: float):
    """Flatten partial (keys, LIST<STRUCT<a, b>>) aggregates into rows:
    the keys gathered a row per element plus one sentinel row a group
    (a = ``fill``, b = 0), with the elements' two field values."""
    from .copying import concatenate
    key_tables, a_parts, b_parts = [], [], []
    for kt, lst in parts:
        offs = lst.offsets.data.to(torch.int64)
        dev = offs.device
        a, b = lst.child.children
        g = torch.searchsorted(offs, torch.arange(a.size, device=dev),
                               right=True) - 1
        key_tables.append(gather(kt, torch.cat(
            [g, torch.arange(kt.num_rows, device=dev)])))
        a_parts += [a.data.to(torch.float64), torch.full(
            (kt.num_rows,), fill, dtype=torch.float64, device=dev)]
        b_parts += [b.data, torch.zeros(kt.num_rows, dtype=b.data.dtype,
                                        device=dev)]
    # full-column concat: validity and string children ride along (a raw
    # ``.data`` rebuild would drop null keys into fill values)
    return concatenate(key_tables), torch.cat(a_parts), torch.cat(b_parts)


@traced("histogram.merge_histograms")
def merge_histograms(parts: Sequence[Tuple[Table, Column]]
                     ) -> Tuple[Table, Column]:
    """Merge partial histograms (the Spark merge phase).

    Every part contributes one (key, value, count) row per run plus one
    zero-weight sentinel row per group (NaN value), so groups with empty
    partial histograms survive into the merged keyset."""
    expects(len(parts) > 0, "need at least one partial histogram")
    keys_cat, v, c = partial_rows(parts, float("nan"))
    sr, sval, _, order, n_groups = _sorted_by_key_value(
        keys_cat, Column(FLOAT64, keys_cat.num_rows, v))
    return _runs_to_hist(sr, sval, c[order], order, n_groups, keys_cat)


def _group_span(offs: torch.Tensor, cum: torch.Tensor):
    """(running total before each group, the group's total) of a
    LIST's elements, from their running sum ``cum``."""
    zero = torch.zeros((), dtype=cum.dtype, device=cum.device)

    def before(o):
        return torch.where(o > 0, cum[torch.clamp_min(o - 1, 0)], zero)
    base = before(offs[:-1])
    return base, before(offs[1:]) - base


@traced("histogram.percentile_from_histogram")
def percentile_from_histogram(hist: Column,
                              percentages: Sequence[float]) -> Table:
    """Final phase: interpolated percentiles straight off a histogram
    column (no expansion: searchsorted over running counts)."""
    expects(hist.dtype.id == TypeId.LIST, "histogram column expected")
    offs = hist.offsets.data.to(torch.int64)
    vals, cnts = (c.data for c in hist.child.children)
    n_groups = hist.size
    n_runs = hist.child.size
    if n_runs == 0:
        none = torch.zeros(n_groups, dtype=torch.bool, device=offs.device)
        return Table([Column(FLOAT64, n_groups, torch.zeros(
            n_groups, dtype=torch.float64, device=offs.device),
            bitmask.pack(none)) for _ in percentages])
    cum = torch.cumsum(cnts, 0)  # global running count
    base, total = _group_span(offs, cum)
    out = []
    for p in percentages:
        pos = torch.clamp_min(p * (total - 1).to(torch.float64), 0.0)
        lo = torch.floor(pos).to(torch.int64)
        frac = pos - lo
        hi = torch.minimum(lo + 1, torch.clamp_min(total - 1, 0))
        j_lo = torch.searchsorted(cum, base + lo + 1)
        j_hi = torch.searchsorted(cum, base + hi + 1)
        res = _interpolate(vals, torch.clamp_max(j_lo, n_runs - 1),
                           torch.clamp_max(j_hi, n_runs - 1), frac)
        out.append(Column(FLOAT64, n_groups, res, bitmask.pack(total > 0)))
    return Table(out)
