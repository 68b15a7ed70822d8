"""Device ms a learner step in matrix-product kernels (``gemm.MARKS``)."""

from perfbench import gemm


def read(ctx):
    return gemm.ms_per_unit(ctx)
