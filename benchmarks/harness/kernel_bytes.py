"""The bytes K1 and K2 have to move in a window, from the launch shapes
the program counted there (``cuda_kernels.LAUNCH_SHAPES``), and their
share of the least time those bytes take over the kernels' device time
in the device-only trace: the yardstick of ``k1_roofline_share.*`` and
``k2_roofline_share.*``.

Each input byte is read once and each output byte written once: K1
reads its int64 build and probe keys and the bool live masks it was
given, and writes an int32 row index and a bool found flag a probe row;
K2 reads an int32 slot, a bool live flag and an int64 value a row, and
writes an int64 sum and an int32 count a slot.
"""

from __future__ import annotations

import re
from typing import Optional

from . import roofline

K1 = re.compile(r"(?:^|::|\s)(?:build|probe|build_probe)_kernel"
                r"(?:<[^>]*>)?\(")
K2 = re.compile(r"(?:^|::|\s)ragged_groupby_kernel(?:<[^>]*>)?\(")


def k1_bytes(shapes: dict) -> int:
    s = lambda k: int(shapes.get(f"hash_join_probe.{k}", 0))  # noqa: E731
    return (8 * s("build_rows") + s("build_live_rows")
            + 8 * s("probe_rows") + s("probe_live_rows")
            + 5 * s("probe_rows"))


def k2_bytes(shapes: dict) -> int:
    s = lambda k: int(shapes.get(f"ragged_groupby_sum_count.{k}",  # noqa
                                 0))
    return 13 * s("rows") + 12 * s("slots")


def _kernel_time_us(tr, pattern) -> "tuple[float, int]":
    """(device time, launches) of the kernels ``pattern`` names."""
    hits = [(e - s) for s, e, n in tr.device_ops if pattern.search(n)]
    return sum(hits), len(hits)


def kernel_roofline(ctx, pattern, launch_name: str,
                    bytes_fn) -> Optional[float]:
    """Percent of the least time of the device-traced window's launches
    of a kernel over their device time. The bytes a launch moves are
    the untraced window's (its shapes over its launches): every pass
    runs the same plans over the same tables, so each window's launches
    move the same bytes on the average. None without a complete trace or
    a launch to read."""
    tr = ctx.trace if ctx.trace_complete else None
    win = ctx.window
    shapes = getattr(win, "shapes", None)
    launched = getattr(win, "launches", {}).get(launch_name, 0)
    if tr is None or not shapes or not launched:
        return None
    us, seen = _kernel_time_us(tr, pattern)
    if us <= 0 or not seen:
        return None
    nbytes = bytes_fn(shapes) * seen / launched
    return 100.0 * roofline.least_seconds(nbytes) / (us / 1e6)
