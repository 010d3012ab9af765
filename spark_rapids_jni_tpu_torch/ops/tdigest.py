"""t-digest aggregates, the approx_percentile backend.

Port of ``spark_rapids_jni_tpu/ops/tdigest.py`` (the mainline cudf
tdigest build, merge and estimate) in its cluster-from-quantiles form:

- **build:** values sorted within groups (``histogram``'s sort); each
  sorted row's mid-rank quantile q maps through the k1 scale function
  ``k(q) = (delta / (2 pi)) asin(2q - 1)``, and its cluster is
  ``floor(k(q) - k(0))``; rows sharing a cluster merge into one centroid
  by weighted mean;
- **merge:** centroids are weighted values, so a merge is concatenate
  plus a weighted rebuild;
- **estimate:** linear interpolation between the centroid means around
  the target rank, a ``searchsorted`` over cumulative weights a
  percentile (first and last centroids clamp).

Accuracy follows the k1 bound: rank error O(1/delta) near the median,
tighter at the tails. The arithmetic is the reference's: weighted sums
are differences of one float64 cumulative sum over the column, so a
small group late in a long column keeps fewer bits, and a row whose
``k(q) - k(0)`` lies within an ulp of an integer may change cluster
where ``asin`` or the cumulative sum rounds otherwise (another device,
another library).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..columnar import Column, Table, bitmask
from ..types import FLOAT64, TypeId
from ..utils.errors import expects
from ..obs import traced
from .histogram import (_empty_keys, _group_span, _layout, _list_of_struct,
                        _runs, _seg_sum, _sorted_by_key_value, partial_rows)
from .sort import gather


def clusters_from_quantiles(q: torch.Tensor, delta: float) -> torch.Tensor:
    """k1 scale function cluster ids for mid-rank quantiles q in [0, 1]."""
    k = (delta / (2.0 * math.pi)) * torch.asin(2.0 * q - 1.0)
    k0 = -(delta / 4.0)  # k(0) = -(delta / (2 pi)) * (pi / 2)
    return torch.floor(k - k0).to(torch.int32)


def _empty_digest(n_groups: int, dev) -> Column:
    zeros = torch.zeros(0, dtype=torch.float64, device=dev)
    return _list_of_struct(
        torch.zeros(n_groups + 1, dtype=torch.int32, device=dev),
        ("mean", "weight"), Column(FLOAT64, 0, zeros),
        Column(FLOAT64, 0, zeros))


@traced("tdigest.group_tdigest")
def group_tdigest(keys: Table, values: Column, delta: int = 100,
                  weights: Optional[torch.Tensor] = None):
    """GROUP BY keys -> t-digest of ``values`` per group.

    Returns (unique-keys Table, LIST<STRUCT<mean FLOAT64, weight
    FLOAT64>>). Null values are excluded; all-null groups keep an empty
    digest.
    """
    expects(keys.num_rows == values.size, "row count mismatch")
    expects(delta >= 10, "delta too small to be meaningful")
    sr, sval, svalid, order, n_groups = _sorted_by_key_value(keys, values)
    n = sr.shape[0]
    if n == 0 or n_groups == 0:
        return _empty_keys(keys), _empty_digest(n_groups, sr.device)
    head, tail, rep = _layout(sr, order, n_groups)
    w = (weights[order].to(torch.float64) if weights is not None
         else torch.ones(n, dtype=torch.float64, device=sr.device))
    w = torch.where(svalid, w, 0.0)

    # per-row mid-rank quantile within its group (weights included)
    cw = torch.cumsum(w, 0)
    base = cw[head] - w[head]  # exclusive prefix at the group head
    total = _seg_sum(w, head, tail)
    q = (cw - base[sr] - 0.5 * w) / torch.clamp_min(total[sr], 1e-300)
    cluster = clusters_from_quantiles(torch.clamp(q, 0.0, 1.0),
                                      float(delta))

    # runs: a new (group, cluster) pair; only runs with weight are kept
    same = torch.zeros(n, dtype=torch.bool, device=sr.device)
    same[1:] = (sr[1:] == sr[:-1]) & (cluster[1:] == cluster[:-1])
    kept, tails, run_w = _runs(sr, same, w)
    wx = w * sval
    cwx = torch.cumsum(wx, 0)
    run_wx = cwx[tails] - cwx[kept] + wx[kept]
    offs = torch.searchsorted(sr[kept], torch.arange(
        n_groups + 1, dtype=sr.dtype, device=sr.device))
    nk = int(kept.shape[0])
    return gather(keys, rep), _list_of_struct(
        offs, ("mean", "weight"), Column(FLOAT64, nk, run_wx / run_w),
        Column(FLOAT64, nk, run_w))


@traced("tdigest.merge_tdigests")
def merge_tdigests(parts, delta: int = 100):
    """Merge partial digests: centroids re-cluster as weighted values
    (a zero-weight sentinel a group keeps groups with empty digests)."""
    expects(len(parts) > 0, "need at least one partial digest")
    keys_cat, means, wts = partial_rows(parts, 0.0)
    return group_tdigest(keys_cat, Column(FLOAT64, keys_cat.num_rows, means),
                         delta=delta, weights=wts)


@traced("tdigest.percentile_approx")
def percentile_approx(dig: Column, percentages: Sequence[float]) -> Table:
    """Estimate percentiles from a digest column -> one FLOAT64 column
    per requested percentage (NULL for empty digests)."""
    expects(dig.dtype.id == TypeId.LIST, "digest column expected")
    offs = dig.offsets.data.to(torch.int64)
    means, wts = (c.data for c in dig.child.children)
    n_groups = dig.size
    n_cent = dig.child.size
    if n_cent == 0:
        none = torch.zeros(n_groups, dtype=torch.bool, device=offs.device)
        return Table([Column(FLOAT64, n_groups, torch.zeros(
            n_groups, dtype=torch.float64, device=offs.device),
            bitmask.pack(none)) for _ in percentages])
    cum = torch.cumsum(wts, 0)
    base, total = _group_span(offs, cum)
    mid = cum - 0.5 * wts  # centroid mid-rank positions, global
    first, last = offs[:-1], torch.clamp_min(offs[1:] - 1, 0)
    out = []
    for p in percentages:
        target = base + p * total
        j = torch.searchsorted(mid, target)
        # the bracketing centroids, clamped into each group's own span
        lo = torch.clamp(torch.clamp(j - 1, 0, n_cent - 1), first, last)
        hi = torch.clamp(torch.clamp(j, 0, n_cent - 1), first, last)
        r_lo, r_hi = mid[lo], mid[hi]
        frac = torch.where(r_hi > r_lo, (target - r_lo) / (r_hi - r_lo), 0.0)
        frac = torch.clamp(frac, 0.0, 1.0)
        m_lo, m_hi = means[lo], means[hi]
        res = m_lo + (m_hi - m_lo) * frac
        out.append(Column(FLOAT64, n_groups, res, bitmask.pack(total > 0)))
    return Table(out)
