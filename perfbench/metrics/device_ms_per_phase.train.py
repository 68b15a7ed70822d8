"""Device-busy ms a train phase."""

from perfbench import readers


def read(ctx):
    return readers.busy_ms(ctx)
