"""Percent of the device-traced window in which no operation ran on the
device: 1 less busy_s over window_s of that one window."""

from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
