"""The median host time, in us, of the program's
``srt::row_conversion.convert_to_rows`` ranges in the host-and-device
traced window: the host's busy time a conversion to rows, at the traced
pace (the line's ``pace``). None where the program opens no such
range."""

from harness.program_spans import median_range_us


def read(ctx):
    return median_range_us(ctx.host_trace,
                           "srt::row_conversion.convert_to_rows")
