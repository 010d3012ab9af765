"""Percent of K1's least time (its keys and masks read once, its index
and found flag written once, at 3.35 TB/s) over K1's device time in the
device-only traced window (``harness/kernel_bytes.py``)."""

from harness.kernel_bytes import K1, k1_bytes, kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, K1, "hash_join_probe", k1_bytes)
