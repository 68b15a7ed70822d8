"""Device kernels a learner step, counted on the trace."""

from perfbench import readers


def read(ctx):
    return readers.per_unit(ctx, "kernels")
