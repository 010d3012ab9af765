"""Timezone conversion over a transition table loaded once per zone.

Port of ``spark_rapids_jni_tpu/ops/timezone.py``, with its own copy of
the TZif parser (RFC 8536) and of the POSIX footer rule:

- host, once per zone: parse the zone's TZif file under ``TZDIR``
  (``config.tzdir``) into 64-bit transition instants and UTC offsets,
  extend it past the last recorded transition with the footer's
  ``M m.w.d`` rule out to the year 2200, and upload the table to the
  device (cached per zone and device);
- device, per call: ``torch.searchsorted`` of the timestamps in the
  transition instants, then one gather of the offsets.

Local -> UTC follows java.time's resolution, as Spark does: in an
overlap the earlier offset wins, in a gap the pre-transition offset
applies (the wall time moves forward by the gap). Both are one rule:
the pre-transition offset holds for local times below ``transition +
max(offset before, offset after)``, a second searchsorted over those
thresholds (kept monotone by a running maximum). Columns are
TIMESTAMP_MICROSECONDS.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..columnar import Column
from ..config import tzdir
from ..obs import traced
from ..types import TypeId
from ..utils.device import resolve_device
from ..utils.errors import expects

_US = 1_000_000
RULE_HORIZON_YEAR = 2200


@dataclass(frozen=True)
class ZoneTable:
    """One zone's transition table on a device."""
    utc_trans_us: torch.Tensor         # (T,) int64 transition instants
    offsets_us: torch.Tensor           # (T + 1,) int64 offset per segment
    local_thresholds_us: torch.Tensor  # (T,) int64 local-time thresholds


# --------------------------------------------------------------------------
# TZif parsing (RFC 8536)
# --------------------------------------------------------------------------

def _parse_tzif(path: str):
    """(transition seconds int64 (T,), offset seconds int64 (T + 1,),
    the POSIX footer)."""
    with open(path, "rb") as f:
        raw = f.read()

    def read_header(pos):
        expects(raw[pos:pos + 4] == b"TZif", f"not a TZif file: {path}")
        # isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt
        return raw[pos + 4:pos + 5], struct.unpack(">6I",
                                                   raw[pos + 20:pos + 44])

    def block_size(cnt, tsize):
        iu, istd, leap, tc, ty, ch = cnt
        return tc * tsize + tc + ty * 6 + ch + leap * (tsize + 4) + istd + iu

    version, counts = read_header(0)
    pos = 44
    tsize = 4
    if version >= b"2":  # skip the 32-bit block, read the 64-bit one
        pos += block_size(counts, 4)
        _, counts = read_header(pos)
        pos += 44
        tsize = 8
    isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = counts
    trans = np.frombuffer(raw, dtype=">i8" if tsize == 8 else ">i4",
                          count=timecnt, offset=pos).astype(np.int64)
    pos += timecnt * tsize
    type_idx = np.frombuffer(raw, dtype=np.uint8, count=timecnt, offset=pos)
    pos += timecnt
    ttinfos = []
    for _ in range(typecnt):
        utoff, isdst, _abbr = struct.unpack(">iBB", raw[pos:pos + 6])
        ttinfos.append((utoff, bool(isdst)))
        pos += 6
    pos += charcnt + leapcnt * (tsize + 4) + isstdcnt + isutcnt

    footer = b""
    if version >= b"2":
        rest = raw[pos:]
        if rest.startswith(b"\n"):
            footer = (rest[1:rest.find(b"\n", 1)] if b"\n" in rest[1:]
                      else rest[1:])
    # the offset before the first transition: the first non-DST type
    # (RFC 8536 section 3.2), else type 0
    first_std = next((o for o, d in ttinfos if not d),
                     ttinfos[0][0] if ttinfos else 0)
    offsets = np.empty(timecnt + 1, np.int64)
    offsets[0] = first_std
    for i in range(timecnt):
        offsets[i + 1] = ttinfos[type_idx[i]][0]
    return trans, offsets, footer.decode("ascii", "replace")


# --------------------------------------------------------------------------
# The POSIX TZ footer rule (transitions past the recorded ones)
# --------------------------------------------------------------------------

def _parse_posix_offset(s: str, i: int) -> Tuple[int, int]:
    """[+-]hh[:mm[:ss]] at s[i:] -> (seconds, next index); POSIX offsets
    are west-positive and returned as written."""
    sign = 1
    if i < len(s) and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    parts = [0, 0, 0]
    for p in range(3):
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        if j == i:
            break
        parts[p] = int(s[i:j])
        i = j
        if i < len(s) and s[i] == ":":
            i += 1
        else:
            break
    return sign * (parts[0] * 3600 + parts[1] * 60 + parts[2]), i


def _parse_name(s: str, i: int) -> int:
    if i < len(s) and s[i] == "<":
        return s.find(">", i) + 1
    j = i
    while j < len(s) and s[j].isalpha():
        j += 1
    return j


def _days_from_civil_scalar(y: int, m: int, d: int) -> int:
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _rule_day_epoch(year: int, rule: str) -> int:
    """Epoch day of one POSIX transition-date rule in ``year``."""
    if rule.startswith("M"):
        m, w, d = (int(x) for x in rule[1:].split("."))
        first = _days_from_civil_scalar(year, m, 1)
        first_dow = (first + 4) % 7  # 1970-01-01 was a Thursday (Sun = 0)
        day = first + (d - first_dow) % 7 + (w - 1) * 7
        next_month = _days_from_civil_scalar(year + (m == 12), m % 12 + 1, 1)
        while day >= next_month:
            day -= 7
        return day
    if rule.startswith("J"):
        n = int(rule[1:])  # 1..365, February 29 never counted
        day = _days_from_civil_scalar(year, 1, 1) + n - 1
        leap = (year % 4 == 0 and year % 100 != 0) or year % 400 == 0
        return day + 1 if leap and n >= 60 else day
    return _days_from_civil_scalar(year, 1, 1) + int(rule)  # 0..365


def _extend_with_footer(trans: np.ndarray, offsets: np.ndarray,
                        footer: str):
    """The footer rule's transitions after the last recorded one, to the
    year 2200."""
    if not footer or "," not in footer:
        return trans, offsets
    i = _parse_name(footer, 0)
    std_posix, i = _parse_posix_offset(footer, i)
    i = _parse_name(footer, i)
    if i < len(footer) and footer[i] != ",":
        dst_posix, i = _parse_posix_offset(footer, i)
    else:
        dst_posix = std_posix - 3600
    std_utoff, dst_utoff = -std_posix, -dst_posix
    rules = footer[i:].lstrip(",").split(",")
    if len(rules) != 2:
        return trans, offsets

    def split_rule(r):
        if "/" in r:
            date, t = r.split("/", 1)
            return date, _parse_posix_offset(t, 0)[0]
        return r, 2 * 3600

    start_rule, start_secs = split_rule(rules[0])
    end_rule, end_secs = split_rule(rules[1])
    last = int(trans[-1]) if len(trans) else 0
    # the civil year of the last recorded transition: the rule takes
    # over from that year (instants up to it are filtered below)
    z = last // 86400 + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    new_t, new_o = [], []
    for year in range(max(1970, int(yoe + era * 400)),
                      RULE_HORIZON_YEAR + 1):
        t_on = _rule_day_epoch(year, start_rule) * 86400 + start_secs \
            - std_utoff
        t_off = _rule_day_epoch(year, end_rule) * 86400 + end_secs \
            - dst_utoff
        for t, o in sorted([(t_on, dst_utoff), (t_off, std_utoff)]):
            if t > last:
                new_t.append(t)
                new_o.append(o)
    if not new_t:
        return trans, offsets
    return (np.concatenate([trans, np.array(new_t, np.int64)]),
            np.concatenate([offsets, np.array(new_o, np.int64)]))


# --------------------------------------------------------------------------
# Zone tables and the conversions
# --------------------------------------------------------------------------

_ZONE_CACHE: Dict[Tuple[str, torch.device], ZoneTable] = {}


@traced("timezone.load_zone")
def load_zone(zone_id: str, device=None) -> ZoneTable:
    """One zone's transition table on ``device`` (``cuda`` unless the
    caller passes another): parsed on the host and uploaded once, then
    cached."""
    dev = resolve_device(device)
    tbl = _ZONE_CACHE.get((zone_id, dev))
    if tbl is not None:
        return tbl
    expects(".." not in zone_id and not zone_id.startswith("/"),
            "bad zone id")
    path = os.path.join(tzdir(), zone_id)
    expects(os.path.isfile(path), f"unknown timezone: {zone_id}")
    trans, offsets = _extend_with_footer(*_parse_tzif(path))
    # transitions closer together than their offset jump give unsorted
    # thresholds; the running maximum keeps them sorted, and the earlier
    # threshold then owns the span (the earlier offset wins)
    thresholds = np.maximum.accumulate(
        trans + np.maximum(offsets[:-1], offsets[1:]))
    tbl = _ZONE_CACHE[(zone_id, dev)] = ZoneTable(*(
        torch.from_numpy(a * _US).to(dev)
        for a in (trans, offsets, thresholds)))
    return tbl


def _check_ts(col: Column):
    expects(col.dtype.id == TypeId.TIMESTAMP_MICROSECONDS,
            "timezone conversion expects TIMESTAMP_MICROSECONDS")


@traced("timezone.convert_utc_to_timezone")
def convert_utc_to_timezone(col: Column, zone_id: str) -> Column:
    """UTC timestamps -> wall-clock time in the zone (Spark's
    from_utc_timestamp)."""
    _check_ts(col)
    tbl = load_zone(zone_id, col.device)
    idx = torch.searchsorted(tbl.utc_trans_us, col.data, right=True)
    return Column(col.dtype, col.size, col.data + tbl.offsets_us[idx],
                  col.validity)


@traced("timezone.local_to_utc_us")
def local_to_utc_us(local_us: torch.Tensor, tbl: ZoneTable) -> torch.Tensor:
    """Local wall-clock microseconds -> UTC microseconds under the zone's
    table (java.time's gap and overlap resolution)."""
    idx = torch.searchsorted(tbl.local_thresholds_us, local_us, right=True)
    return local_us - tbl.offsets_us[idx]


@traced("timezone.convert_timezone_to_utc")
def convert_timezone_to_utc(col: Column, zone_id: str) -> Column:
    """Wall-clock timestamps in the zone -> UTC (Spark's
    to_utc_timestamp)."""
    _check_ts(col)
    out = local_to_utc_us(col.data, load_zone(zone_id, col.device))
    return Column(col.dtype, col.size, out, col.validity)

