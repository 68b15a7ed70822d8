"""The learner step's analytic FLOPs over its matrix-product kernels' device
time, as a share in % of the card's peak in the compute dtype."""

from perfbench import gemm


def read(ctx):
    return gemm.roofline(ctx)
