"""Percent of the least time of the traced window's conversions to rows
(columns and validity read once, rows written once, at 3.35 TB/s) over
the device time inside them."""

from harness.readers import conversion_roofline


def read(ctx):
    return conversion_roofline(ctx, "bench::to_rows")
