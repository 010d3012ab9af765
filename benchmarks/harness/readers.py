"""Arithmetic the metric readers share. Each returns None where the run
has nothing to read: no trace, or a trace that missed launches."""

from __future__ import annotations

from typing import Optional

from . import roofline

# byte widths of the row format's fixed-width type names
TYPE_BYTES = {"BOOL8": 1, "INT8": 1, "UINT8": 1, "INT16": 2, "UINT16": 2,
              "INT32": 4, "UINT32": 4, "FLOAT32": 4, "DECIMAL32": 4,
              "TIMESTAMP_DAYS": 4, "INT64": 8, "UINT64": 8, "FLOAT64": 8,
              "DECIMAL64": 8, "TIMESTAMP_MICROSECONDS": 8}


def window_rate(ctx) -> Optional[float]:
    """Work done over the whole window, per second."""
    win = ctx.window
    if win.seconds <= 0:
        return None
    return sum(r.work for r in win.counted()) / win.seconds


def idle_share(ctx) -> Optional[float]:
    """Percent of the device-traced window in which no operation ran on
    the device: 1 less the union of its operations' intervals over the
    window's length, both of that one window (the result's ``busy_s``
    and ``window_s``). The profiler slows the host's launches, so this
    reads the idle share at the traced pace; the result's ``pace`` sets
    that pace beside the untraced one."""
    tr = ctx.trace if ctx.trace_complete else None
    if tr is None or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)


def conversion_roofline(ctx, range_name: str) -> Optional[float]:
    """Percent of the least time of the conversions in the host-traced
    window (each conversion the columns, their validity and the rows
    moved once, ``roofline.conversion_bytes``) over the device time of
    the operations inside the benchmark's ``range_name`` ranges."""
    tr = ctx.host_trace
    if tr is None:
        return None
    us, _ = tr.device_us_in(range_name)
    conversions = len(tr.ranges.get("bench::to_rows", []))
    if us <= 0 or not conversions:
        return None
    cfg = ctx.config
    widths = [TYPE_BYTES[t.partition(":")[0]] for t in cfg["types"]] \
        * int(cfg["repeats"])
    least = conversions * roofline.least_seconds(
        roofline.conversion_bytes(widths, int(cfg["rows"])))
    return 100.0 * least / (us / 1e6)
