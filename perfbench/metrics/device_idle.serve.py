"""1 - device-busy / wall over about a second of serving on the trace."""

from perfbench import readers


def read(ctx):
    return readers.idle(ctx)
