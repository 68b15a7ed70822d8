"""1 - device-busy / wall over the traced learner steps."""

from perfbench import readers


def read(ctx):
    return readers.idle(ctx)
