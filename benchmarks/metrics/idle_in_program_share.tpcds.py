"""Percent of the host-and-device traced window's device-idle time that
the program's ``srt::`` ranges cover: the idle the program's own host
steps hold; the rest is the benchmark's loop and synchronise. None
where the program opens no range."""

from harness.program_spans import idle_in_program_share


def read(ctx):
    return idle_in_program_share(ctx.host_trace)
