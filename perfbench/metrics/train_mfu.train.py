"""A train phase's analytic FLOPs (policy steps, entry priorities, learner steps) over the window, as a share in % of the peak of the compute dtype."""

from perfbench import readers


def read(ctx):
    return readers.mfu(ctx)
