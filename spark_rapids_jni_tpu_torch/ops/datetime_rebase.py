"""Proleptic-Gregorian <-> hybrid-Julian calendar rebase.

Port of ``spark_rapids_jni_tpu/ops/datetime_rebase.py`` (Spark's
``RebaseDateTime.rebaseGregorianToJulianDays`` /
``rebaseJulianToGregorianDays``): a day before the 1582-10-15 cutover
keeps its year-month-day and is read in the other calendar; from the
cutover on the calendars agree. Gregorian dates 1582-10-05..14 (the gap
the hybrid calendar skips) land on Julian October 5..14, ten days on,
as Spark's lenient calendar does. Microsecond timestamps rebase their
day and keep the time of day (UTC). Integer algebra over int64 lanes,
every division flooring.
"""

from __future__ import annotations

import torch

from ..columnar import Column
from ..obs import traced
from ..types import TypeId
from ..utils.errors import expects
from .datetime import civil_from_days, days_from_civil

_US_PER_DAY = 86_400 * 1_000_000
# 1582-10-15, the hybrid calendar's first Gregorian day
_CUTOVER_DAYS = -141427


def _julian_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (y, m, d) in the proleptic Julian
    calendar."""
    c = days + 2440588 + 32082  # the Julian Day Number, shifted
    d2 = (4 * c + 3) // 1461
    e = c - (1461 * d2) // 4
    m2 = (5 * e + 2) // 153
    day = e - (153 * m2 + 2) // 5 + 1
    month = m2 + 3 - 12 * (m2 // 10)
    return d2 - 4800 + m2 // 10, month, day


def _days_from_julian(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(y, m, d) in the proleptic Julian calendar -> days since the
    epoch."""
    a = (14 - m) // 12
    y2 = y + 4800 - a
    m2 = m + 12 * a - 3
    return d + (153 * m2 + 2) // 5 + 365 * y2 + y2 // 4 - 32083 - 2440588


def _rebase_days(days: torch.Tensor, to_julian: bool) -> torch.Tensor:
    if to_julian:
        rebased = _days_from_julian(*civil_from_days(days))
    else:
        rebased = days_from_civil(*_julian_from_days(days))
    return torch.where(days >= _CUTOVER_DAYS, days, rebased)


def _dispatch(col: Column, to_julian: bool) -> Column:
    tid = col.dtype.id
    expects(tid in (TypeId.TIMESTAMP_DAYS, TypeId.TIMESTAMP_MICROSECONDS),
            "rebase expects DATE (TIMESTAMP_DAYS) or TIMESTAMP_MICROSECONDS")
    v = col.data.to(torch.int64)
    if tid == TypeId.TIMESTAMP_DAYS:
        out = _rebase_days(v, to_julian).to(torch.int32)
    else:
        days = v // _US_PER_DAY
        out = _rebase_days(days, to_julian) * _US_PER_DAY \
            + (v - days * _US_PER_DAY)
    return Column(col.dtype, col.size, out, col.validity)


@traced("datetime_rebase.rebase_gregorian_to_julian")
def rebase_gregorian_to_julian(col: Column) -> Column:
    """Proleptic Gregorian -> hybrid Julian (the legacy write side)."""
    return _dispatch(col, to_julian=True)


@traced("datetime_rebase.rebase_julian_to_gregorian")
def rebase_julian_to_gregorian(col: Column) -> Column:
    """Hybrid Julian -> proleptic Gregorian (the legacy read side)."""
    return _dispatch(col, to_julian=False)
