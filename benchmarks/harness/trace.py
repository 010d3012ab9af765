"""Reading a ``torch.profiler`` trace of a window: the device's
operations, its busy time, its idle gaps and what the host was doing in
each, and the device time inside the benchmark's own ranges.

Times are in microseconds on the profiler's clock, on which the host's
ranges and the device's operations are both placed.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# the __global__ functions of the port's hand-written CUDA sources
# (csrc/*.cu, templates included) as the profiler names them, frozen
# with the benchmark
HAND_KERNEL = re.compile(r"(?:^|::|\s)(?:build|probe|build_probe|"
                         r"ragged_groupby|bitmask_pack|bitmask_pack_fields|"
                         r"murmur3_int32|murmur3_int64|pack_rows)_kernel"
                         r"(?:<[^>]*>)?\(")
# ranges opened by record_function: the benchmark's and the program's
RANGE_PREFIXES = ("bench::", "srt::")
WINDOW_RANGE = "bench::window"
LABEL_GAPS = 4000  # the longest gaps that are labelled by the host's op


def is_hand_kernel(name: str) -> bool:
    return bool(HAND_KERNEL.search(name))


@dataclass
class Trace:
    """The device's operations and the host's events of one window.
    ``window`` bounds it on the profiler's clock; a trace of the device
    alone has no host events to bound it by, and gives the window's
    length (``length_us``, on the host's clock) instead."""

    window: Tuple[float, float]
    device_ops: List[Tuple[float, float, str]]
    host_events: List[Tuple[float, float, str]]
    ranges: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict)
    length_us: Optional[float] = None

    @property
    def window_us(self) -> float:
        if self.length_us is not None:
            return self.length_us
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for s, e, _ in self.device_ops
                     if e > lo and s < hi)
        out: List[Tuple[float, float]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_us_in(self, range_name: str) -> Tuple[float, int]:
        """(device time of the operations that ran inside a host range
        of that name, the number of such ranges). A range that ends in a
        synchronise holds every operation it launched."""
        spans = sorted(self.ranges.get(range_name, []))
        starts = [s for s, _ in spans]
        total = 0.0
        for s, e, _ in self.device_ops:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= spans[i][1]:
                total += e - s
        return total, len(spans)

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, n in self.device_ops:
            by[n] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, us / 1e6] for n, us in top]

    def idle_gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def host_op_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost host event
        open then, under the program's or the benchmark's innermost
        range where one is open."""
        ev = self.host_events
        i = bisect.bisect_right(self._host_starts, t) - 1
        op, rng = None, None
        scanned = 0
        while i >= 0 and scanned < 20000 and (op is None or rng is None):
            s, e, n = ev[i]
            if e >= t and n != WINDOW_RANGE:
                if n.startswith(RANGE_PREFIXES):
                    rng = rng or n
                else:
                    op = op or n
            i -= 1
            scanned += 1
        if rng and op:
            return f"{rng} > {op}"
        return rng or op or "no host op"

    def gaps_by_host_op(self, k: int = 10) -> List[list]:
        """The idle time summed by what the host was doing, the ``k``
        largest; the gaps beyond the ``LABEL_GAPS`` longest are summed
        as one entry."""
        self._host_starts = [s for s, _, _ in self.host_events]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])
        by: Dict[str, float] = defaultdict(float)
        for a, b in gaps[:LABEL_GAPS]:
            by[self.host_op_at((a + b) / 2)] += b - a
        rest = sum(b - a for a, b in gaps[LABEL_GAPS:])
        if rest:
            by["(shorter gaps)"] += rest
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, us / 1e6] for n, us in top]


def device_only(prof, length_s: float) -> Trace:
    """A ``Trace`` of a ``torch.profiler.profile`` run that recorded the
    device's activity alone (no host events, so the host runs as it
    does untraced), over a window of ``length_s`` on the host's clock
    that began after the profiler started and ended in a synchronise
    before it stopped."""
    from torch.autograd import DeviceType
    dev = [(float(e.time_range.start), float(e.time_range.end), e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    return Trace(window=(float("-inf"), float("inf")), device_ops=dev,
                 host_events=[], length_us=length_s * 1e6)


def from_profiler(prof) -> Trace:
    """A ``Trace`` of a ``torch.profiler.profile`` run of the host and
    the device whose window was wrapped in a ``bench::window`` range."""
    from torch.autograd import DeviceType
    host, dev, ranges = [], [], defaultdict(list)
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            dev.append((s, t, e.name))
        else:
            host.append((s, t, e.name))
            if e.name.startswith(RANGE_PREFIXES):
                ranges[e.name].append((s, t))
    # a record_function range is also placed on the device's timeline;
    # it is no operation of the device
    names = set(ranges)
    dev = [d for d in dev if d[2] not in names]
    host.sort()
    win = ranges.get(WINDOW_RANGE)
    if not win:
        raise RuntimeError("the trace holds no bench::window range")
    return Trace(window=win[0], device_ops=dev, host_events=host,
                 ranges=dict(ranges))


def hand_kernel_count(trace: Optional[Trace]) -> int:
    if trace is None:
        return 0
    return sum(1 for _, _, n in trace.device_ops if is_hand_kernel(n))
