"""The learner step's analytic FLOPs over the window, as a share in % of the peak of the configuration's compute dtype."""

from perfbench import readers


def read(ctx):
    return readers.mfu(ctx)
