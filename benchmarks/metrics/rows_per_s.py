"""Rows converted over the whole window, per second (a round trip counts
each row once)."""

from harness.readers import window_rate


def read(ctx):
    return window_rate(ctx)
