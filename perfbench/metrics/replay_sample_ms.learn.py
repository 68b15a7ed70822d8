"""Host ms a learner step spends in the benchmark's sample span (Trainer._sample: ReplayArena.sample on the benchmark's uniforms)."""

from perfbench import readers


def read(ctx):
    return readers.span_ms(ctx, "sample")
