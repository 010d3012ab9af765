"""Process start to the first timed request, in s: imports, the kernel
library's bind (or build), the data, ingest and warm-up."""


def read(ctx):
    return ctx.setup_s
