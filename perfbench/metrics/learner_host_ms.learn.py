"""Host ms a learner step spends in the benchmark's update span (Trainer._update_step: IS weights, R2D2DPG.learner_step, the write-back)."""

from perfbench import readers


def read(ctx):
    return readers.span_ms(ctx, "learner_step")
