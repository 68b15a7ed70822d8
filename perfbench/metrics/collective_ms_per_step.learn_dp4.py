"""Device ms a learner step in rank 0's NCCL kernels on the trace (the block priorities' all-gather, the rows' reduce-scatter, the gradients' all-reduce, the new priorities' all-gather).  An NCCL kernel runs from its launch until every rank has joined, so on eager steps this is mostly rank 0's wait for the slowest of the other hosts to reach the collective, and only a little the transfer itself: it moves when the ranks' hosts fall out of step, not only when the exchange gets cheaper."""

from perfbench import readers


def read(ctx):
    return readers.kernel_ms(ctx, "nccl")
