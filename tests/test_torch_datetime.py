"""Datetime extraction and arithmetic, the Julian/Gregorian rebase and the
timezone conversions of the PyTorch/CUDA port against the JAX package on
the same numpy inputs (on the CPU). Results are byte-equal, on
timestamps spanning the years 0001-9999 with pre-epoch values,
0001-01-01, 9999-12-31 and the 1582-10-04/15 switch mixed in, and on
Python's ``datetime`` and ``zoneinfo``. A timezone case skips when its
TZif file is absent, as the reference's test does.
"""

import datetime as pydt
import os
from zoneinfo import ZoneInfo

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import types as ref_types
from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.ops import datetime as ref_dt
from spark_rapids_jni_tpu.ops import datetime_rebase as ref_reb
from spark_rapids_jni_tpu.ops import timezone as ref_tz

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch import types as T
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops import datetime as dto
from spark_rapids_jni_tpu_torch.ops import datetime_rebase as reb
from spark_rapids_jni_tpu_torch.ops import timezone as tz

CPU = torch.device("cpu")
US_PER_DAY = 86_400_000_000
EPOCH = pydt.datetime(1970, 1, 1)


def _us(y, mo, d, h=0, mi=0, s=0, us=0):
    dt = pydt.datetime(y, mo, d, h, mi, s, us)
    return (dt - EPOCH) // pydt.timedelta(microseconds=1)


MIN_US = _us(1, 1, 1)
MAX_US = _us(9999, 12, 31, 23, 59, 59, 999_999)
EDGES = [MIN_US, MAX_US, _us(1582, 10, 4), _us(1582, 10, 15),
         _us(1582, 10, 4, 23, 59, 59, 999_999), _us(1582, 10, 15, 0, 0, 0, 1),
         -1, 0, 1, -US_PER_DAY, -US_PER_DAY - 1, _us(1900, 2, 28, 12),
         _us(2000, 2, 29, 23, 59, 59, 1), _us(1969, 12, 31, 23, 59, 59)]


def timestamps(n, seed=0):
    """Seeded TIMESTAMP_MICROSECONDS over the years 0001-9999, the edge
    values first."""
    rng = np.random.default_rng(seed)
    v = rng.integers(MIN_US, MAX_US, n, dtype=np.int64, endpoint=True)
    v[:len(EDGES)] = EDGES
    return v


def _pair(values, dtype, valid=None):
    ref_dtype = ref_types.DType.from_ids(int(dtype.id))
    return (RefColumn.from_numpy(values, valid, ref_dtype),
            Column.from_numpy(values, valid, dtype, device=CPU))


def _same(got: Column, want) -> None:
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.data.dtype.itemsize == np.asarray(want.data).dtype.itemsize
    np.testing.assert_array_equal(got.valid_bool().numpy(),
                                  np.asarray(want.valid_bool()))


FIELDS = ["extract_year", "extract_month", "extract_day", "extract_hour",
          "extract_minute", "extract_second", "extract_microsecond",
          "day_of_week", "day_of_year"]
TS_UNITS = [(T.TypeId.TIMESTAMP_MICROSECONDS, 1),
            (T.TypeId.TIMESTAMP_MILLISECONDS, 1000),
            (T.TypeId.TIMESTAMP_SECONDS, 1_000_000),
            (T.TypeId.TIMESTAMP_NANOSECONDS, None),
            (T.TypeId.TIMESTAMP_DAYS, US_PER_DAY)]


@pytest.fixture(scope="module")
def micros():
    v = timestamps(3000)
    valid = np.random.default_rng(1).random(v.size) > 0.05
    return _pair(v, T.TIMESTAMP_MICROSECONDS, valid)


@pytest.mark.parametrize("fn", FIELDS)
def test_fields_equal_reference(micros, fn):
    ref, got = micros
    _same(getattr(dto, fn)(got), getattr(ref_dt, fn)(ref))


@pytest.mark.parametrize("tid,div", TS_UNITS)
def test_fields_of_every_timestamp_unit_equal_reference(tid, div):
    v = timestamps(500, seed=int(tid))
    if div is None:  # nanoseconds: +-292 years around 1970
        v = np.random.default_rng(5).integers(-2**62, 2**62, 500)
        v[:3] = [-1, 0, -999]
    else:
        v = v // div
    if tid == T.TypeId.TIMESTAMP_DAYS:
        v = v.astype(np.int32)
    ref, got = _pair(v, T.DType(tid))
    for fn in FIELDS:
        _same(getattr(dto, fn)(got), getattr(ref_dt, fn)(ref))


def test_fields_equal_python_datetime():
    v = timestamps(2000, seed=2)
    got = Column.from_numpy(v, None, T.TIMESTAMP_MICROSECONDS, device=CPU)
    out = {fn: getattr(dto, fn)(got).data.tolist() for fn in FIELDS}
    for i, us in enumerate(v.tolist()):
        dt = EPOCH + pydt.timedelta(microseconds=us)
        want = [dt.year, dt.month, dt.day, dt.hour, dt.minute, dt.second,
                dt.microsecond, dt.isoweekday() % 7 + 1,
                dt.timetuple().tm_yday]
        assert [out[fn][i] for fn in FIELDS] == want, dt


@pytest.mark.parametrize("unit", dto.TRUNCATE_UNITS)
def test_truncate_equals_reference_and_python(micros, unit):
    ref, got = micros
    out = dto.truncate(got, unit)
    _same(out, ref_dt.truncate(ref, unit))
    step = {"day": US_PER_DAY, "hour": 3_600_000_000, "minute": 60_000_000,
            "second": 1_000_000}[unit]
    v = got.data.numpy()
    np.testing.assert_array_equal(out.data.numpy(), v - np.mod(v, step))


@pytest.mark.parametrize("days", [0, 40, -1, -700_000, 3_000_000])
def test_add_interval_days_equals_reference(days):
    v = timestamps(400, seed=3)
    ref, got = _pair(v, T.TIMESTAMP_MICROSECONDS)
    _same(dto.add_interval_days(got, days),
          ref_dt.add_interval_days(ref, days))
    d = (v // US_PER_DAY).astype(np.int32)
    ref, got = _pair(d, T.TIMESTAMP_DAYS, d % 3 != 0)
    _same(dto.add_interval_days(got, days),
          ref_dt.add_interval_days(ref, days))


def test_add_interval_days_refuses_other_types():
    col = Column.from_numpy(np.arange(3, dtype=np.int64), None,
                            T.DType(T.TypeId.TIMESTAMP_SECONDS), device=CPU)
    with pytest.raises(Exception, match="DAYS or MICROSECONDS"):
        dto.add_interval_days(col, 1)


# --------------------------------------------------------------------------
# Julian / Gregorian rebase
# --------------------------------------------------------------------------

def _g_days(y, m, d):
    return pydt.date(y, m, d).toordinal() - 719163


@pytest.mark.parametrize("direction", ["rebase_gregorian_to_julian",
                                       "rebase_julian_to_gregorian"])
def test_rebase_equals_reference(direction):
    v = timestamps(3000, seed=4)
    d = (v // US_PER_DAY).astype(np.int32)
    valid = np.random.default_rng(2).random(v.size) > 0.05
    for arr, dt in ((d, T.TIMESTAMP_DAYS), (v, T.TIMESTAMP_MICROSECONDS)):
        ref, got = _pair(arr, dt, valid)
        _same(getattr(reb, direction)(got), getattr(ref_reb, direction)(ref))


def test_rebase_known_anchors():
    col = lambda days: Column.from_numpy(  # noqa: E731
        np.asarray(days, np.int32), None, T.TIMESTAMP_DAYS, device=CPU)
    for d in range(4, 15):  # Oct 4 and the gap Oct 5..14 move ten days on
        g = _g_days(1582, 10, d)
        assert reb.rebase_gregorian_to_julian(col([g])).data.item() == g + 10
    for y, m, d in ((1582, 10, 15), (1970, 1, 1), (9999, 12, 31)):
        g = _g_days(y, m, d)  # from the cutover on: identity
        assert reb.rebase_gregorian_to_julian(col([g])).data.item() == g
        assert reb.rebase_julian_to_gregorian(col([g])).data.item() == g
    j = _g_days(1582, 10, 4) + 10
    assert reb.rebase_julian_to_gregorian(col([j])).data.item() == \
        _g_days(1582, 10, 4)
    g = _g_days(1000, 1, 1)
    assert reb.rebase_gregorian_to_julian(col([g])).data.item() == g + 5
    g = _g_days(1, 1, 1)
    assert reb.rebase_gregorian_to_julian(col([g])).data.item() == g - 2


def test_rebase_round_trip_below_the_cutover():
    days = np.random.default_rng(3).integers(
        _g_days(1, 1, 1), _g_days(1582, 10, 5), 500).astype(np.int32)
    got = Column.from_numpy(days, None, T.TIMESTAMP_DAYS, device=CPU)
    back = reb.rebase_julian_to_gregorian(reb.rebase_gregorian_to_julian(got))
    np.testing.assert_array_equal(back.data.numpy(), days)


# --------------------------------------------------------------------------
# timezones
# --------------------------------------------------------------------------

ZONES = ["America/Los_Angeles", "Europe/Berlin", "Asia/Kolkata",
         "Europe/Paris", "Australia/Lord_Howe", "UTC"]


def _zone(zone):
    if not os.path.isfile(os.path.join(config.tzdir(), zone)):
        pytest.skip(f"no TZif file for {zone}")
    return zone


def _tz_inputs(seed):
    rng = np.random.default_rng(seed)
    secs = rng.integers(-2_208_988_800, 7_258_118_400, 1500)  # 1900..2200
    us = secs * 1_000_000 + rng.integers(0, 1_000_000, secs.size)
    dst = [_us(2026, 3, 8, 9, 59, 59), _us(2026, 3, 8, 10),
           _us(2026, 11, 1, 8, 59, 59), _us(2026, 11, 1, 9, 0, 1),
           _us(2026, 3, 29, 0, 59, 59), _us(2026, 3, 29, 1, 0, 1),
           _us(2026, 3, 8, 2, 30), _us(2026, 11, 1, 1, 30),
           _us(2026, 3, 29, 2, 30), _us(2026, 10, 25, 2, 30),
           _us(1583, 1, 1), _us(2150, 7, 15, 12), MIN_US // 2]
    us[:len(dst)] = dst
    return us


@pytest.mark.parametrize("zone", ZONES)
def test_timezone_conversions_equal_reference(zone):
    _zone(zone)
    us = _tz_inputs(len(zone))
    valid = np.arange(us.size) % 11 != 0
    ref, got = _pair(us, T.TIMESTAMP_MICROSECONDS, valid)
    _same(tz.convert_utc_to_timezone(got, zone),
          ref_tz.convert_utc_to_timezone(ref, zone))
    _same(tz.convert_timezone_to_utc(got, zone),
          ref_tz.convert_timezone_to_utc(ref, zone))
    tbl, ref_tbl = tz.load_zone(zone, CPU), ref_tz.load_zone(zone)
    for name in ("utc_trans_us", "offsets_us", "local_thresholds_us"):
        np.testing.assert_array_equal(getattr(tbl, name).numpy(),
                                      np.asarray(getattr(ref_tbl, name)))


@pytest.mark.parametrize("zone", ["America/Los_Angeles", "Europe/Berlin",
                                  "Asia/Kolkata"])
def test_timezone_conversions_equal_zoneinfo(zone):
    z = ZoneInfo(_zone(zone))
    us = _tz_inputs(7)[:400]
    got = Column.from_numpy(us, None, T.TIMESTAMP_MICROSECONDS, device=CPU)
    local = tz.convert_utc_to_timezone(got, zone).data.tolist()
    utc = tz.convert_timezone_to_utc(got, zone).data.tolist()
    for v, lo, ut in zip(us.tolist(), local, utc):
        at = pydt.datetime.fromtimestamp(v // 1_000_000, tz=pydt.timezone.utc)
        assert lo == v + int(at.astimezone(z).utcoffset().total_seconds()) \
            * 1_000_000
        wall = (EPOCH + pydt.timedelta(microseconds=v)).replace(tzinfo=z,
                                                                fold=0)
        assert ut == v - int(wall.utcoffset().total_seconds()) * 1_000_000


def test_local_thresholds_monotonic():
    for zone in ("Pacific/Apia", "Pacific/Kiritimati", "Africa/Monrovia",
                 "Asia/Manila", "America/New_York", "Australia/Lord_Howe"):
        if os.path.isfile(os.path.join(config.tzdir(), zone)):
            t = tz.load_zone(zone, CPU).local_thresholds_us.numpy()
            assert (np.diff(t) >= 0).all(), zone


def test_timezone_refuses_bad_input():
    col = Column.from_numpy(np.zeros(2, np.int64), None,
                            T.TIMESTAMP_MICROSECONDS, device=CPU)
    with pytest.raises(Exception, match="bad zone id"):
        tz.convert_utc_to_timezone(col, "../etc/passwd")
    with pytest.raises(Exception, match="unknown timezone"):
        tz.convert_utc_to_timezone(col, "Nowhere/Atlantis")
    days = Column.from_numpy(np.zeros(2, np.int32), None, T.TIMESTAMP_DAYS,
                             device=CPU)
    with pytest.raises(Exception, match="TIMESTAMP_MICROSECONDS"):
        tz.convert_utc_to_timezone(days, "UTC")
