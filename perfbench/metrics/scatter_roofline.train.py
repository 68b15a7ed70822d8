"""The priority scatter's share of its memory roofline over the traced train phases, in %."""

from perfbench import readers


def read(ctx):
    return readers.scatter_roofline(ctx)
