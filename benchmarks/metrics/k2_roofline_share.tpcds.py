"""Percent of K2's least time (its slots, live flags and values read
once, its sums and counts written once, at 3.35 TB/s) over K2's device
time in the device-only traced window (``harness/kernel_bytes.py``)."""

from harness.kernel_bytes import K2, k2_bytes, kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, K2, "ragged_groupby_sum_count", k2_bytes)
