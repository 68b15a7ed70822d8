"""Device kernels a train phase, counted on the trace."""

from perfbench import readers


def read(ctx):
    return readers.per_unit(ctx, "kernels")
