"""Datetime field extraction and arithmetic over timestamp columns.

Port of ``spark_rapids_jni_tpu/ops/datetime.py``: UTC field extraction
as integer algebra over int64 lanes, with Howard Hinnant's
``civil_from_days`` / ``days_from_civil`` (proleptic Gregorian). Every
division floors (torch ``//`` on int64 and ``torch.remainder`` floor, as
jnp's do), so days and times before 1970 come out right.
"""

from __future__ import annotations

import torch

from ..columnar import Column
from ..obs import traced
from ..types import TypeId, DType, INT16, INT32
from ..utils.errors import expects, fail

_US_PER_SEC = 1_000_000
_US_PER_DAY = 86_400 * _US_PER_SEC
_TRUNC_US = {"day": _US_PER_DAY, "hour": 3600 * _US_PER_SEC,
             "minute": 60 * _US_PER_SEC, "second": _US_PER_SEC}
TRUNCATE_UNITS = tuple(_TRUNC_US)


def _days_and_time_us(col: Column):
    """(days since the epoch, microseconds into the day) as int64."""
    tid = col.dtype.id
    v = col.data.to(torch.int64)
    if tid == TypeId.TIMESTAMP_DAYS:
        return v, torch.zeros_like(v)
    if tid == TypeId.TIMESTAMP_SECONDS:
        us = v * _US_PER_SEC
    elif tid == TypeId.TIMESTAMP_MILLISECONDS:
        us = v * 1000
    elif tid == TypeId.TIMESTAMP_MICROSECONDS:
        us = v
    elif tid == TypeId.TIMESTAMP_NANOSECONDS:
        us = v // 1000
    else:
        fail(f"not a timestamp column: {col.dtype!r}")
    days = us // _US_PER_DAY
    return days, us - days * _US_PER_DAY


def civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day), proleptic
    Gregorian."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) -> days since the epoch (the inverse)."""
    y = torch.where(m <= 2, y - 1, y)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _wrap(col: Column, data: torch.Tensor, dt: DType) -> Column:
    return Column(dt, col.size, data.to(dt.to_torch()), col.validity)


@traced("datetime.extract_year")
def extract_year(col: Column) -> Column:
    return _wrap(col, civil_from_days(_days_and_time_us(col)[0])[0], INT16)


@traced("datetime.extract_month")
def extract_month(col: Column) -> Column:
    return _wrap(col, civil_from_days(_days_and_time_us(col)[0])[1], INT16)


@traced("datetime.extract_day")
def extract_day(col: Column) -> Column:
    return _wrap(col, civil_from_days(_days_and_time_us(col)[0])[2], INT16)


@traced("datetime.extract_hour")
def extract_hour(col: Column) -> Column:
    tod = _days_and_time_us(col)[1]
    return _wrap(col, tod // (3600 * _US_PER_SEC), INT16)


@traced("datetime.extract_minute")
def extract_minute(col: Column) -> Column:
    tod = _days_and_time_us(col)[1]
    return _wrap(col, torch.remainder(tod // (60 * _US_PER_SEC), 60), INT16)


@traced("datetime.extract_second")
def extract_second(col: Column) -> Column:
    tod = _days_and_time_us(col)[1]
    return _wrap(col, torch.remainder(tod // _US_PER_SEC, 60), INT16)


@traced("datetime.extract_microsecond")
def extract_microsecond(col: Column) -> Column:
    tod = _days_and_time_us(col)[1]
    return _wrap(col, torch.remainder(tod, _US_PER_SEC), INT32)


@traced("datetime.day_of_week")
def day_of_week(col: Column) -> Column:
    """1 = Sunday ... 7 = Saturday (Spark's dayofweek); 1970-01-01 was a
    Thursday."""
    days = _days_and_time_us(col)[0]
    return _wrap(col, torch.remainder(days + 4, 7) + 1, INT16)


@traced("datetime.day_of_year")
def day_of_year(col: Column) -> Column:
    days = _days_and_time_us(col)[0]
    y = civil_from_days(days)[0]
    one = torch.ones_like(y)
    return _wrap(col, days - days_from_civil(y, one, one) + 1, INT16)


@traced("datetime.truncate")
def truncate(col: Column, unit: str) -> Column:
    """date_trunc of TIMESTAMP_MICROSECONDS to a day, hour, minute or
    second."""
    expects(col.dtype.id == TypeId.TIMESTAMP_MICROSECONDS,
            "truncate requires TIMESTAMP_MICROSECONDS")
    q = _TRUNC_US.get(unit)
    expects(q is not None, f"unsupported truncate unit {unit!r}")
    return Column(col.dtype, col.size, (col.data // q) * q, col.validity)


@traced("datetime.add_interval_days")
def add_interval_days(col: Column, days: int) -> Column:
    tid = col.dtype.id
    if tid == TypeId.TIMESTAMP_DAYS:
        return Column(col.dtype, col.size, col.data + days, col.validity)
    expects(tid == TypeId.TIMESTAMP_MICROSECONDS,
            "add_interval_days: DAYS or MICROSECONDS timestamps")
    return Column(col.dtype, col.size, col.data + days * _US_PER_DAY,
                  col.validity)
