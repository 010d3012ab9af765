"""The program's own ranges in a host-and-device trace: the ``srt::``
ranges the port opens under ``SRT_TRACE_ENABLED``, read for the host's
time inside them and for the device's idle time they cover. Each
reader returns None where the trace holds none of the ranges it reads,
as it does of a program that opens none."""

from __future__ import annotations

import statistics
from typing import List, Optional, Tuple

from .trace import Trace

PROGRAM_PREFIX = "srt::"


def median_range_us(tr: Optional[Trace], name: str) -> Optional[float]:
    """The median host duration, in us, of the ranges named ``name``."""
    spans = tr.ranges.get(name) if tr is not None else None
    if not spans:
        return None
    return statistics.median(e - s for s, e in spans)


def _union(ivs) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap_us(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_program_share(tr: Optional[Trace]) -> Optional[float]:
    """Percent of the window's device-idle time (``Trace.idle_gaps``)
    that the union of the program's ranges covers, interval by interval:
    the idle the program's host steps hold, apart from the idle in the
    benchmark's loop and synchronise."""
    if tr is None:
        return None
    program = _union(iv for name, spans in tr.ranges.items()
                     if name.startswith(PROGRAM_PREFIX) for iv in spans)
    gaps = tr.idle_gaps()
    idle = sum(b - a for a, b in gaps)
    if not program or idle <= 0:
        return None
    return 100.0 * _overlap_us(gaps, program) / idle
