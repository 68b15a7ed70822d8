"""Device-busy ms a learner step: the union of the device's activity intervals on the trace."""

from perfbench import readers


def read(ctx):
    return readers.busy_ms(ctx)
