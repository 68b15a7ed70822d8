"""Which kernels of a device trace are matrix products, and what the
``gemm_*`` metrics read of them.

A kernel is a matrix product where its name, in lower case, holds one of
``MARKS``: cuBLAS's and cuBLASLt's GEMM and GEMV kernels
(``sm90_xmma_gemm_*``, ``ampere_sgemm_*``, ``gemmk1_kernel``,
``gemv2T_kernel_val``, ``gemvx::kernel``), CUTLASS's (``cutlass::Kernel2<
cutlass_80_simt_sgemm_*>``), and the split-K reductions that finish some
of them (``splitKreduce_kernel``).  Busy time less this is the cost of
everything else on the device: a mixer's scan, convolution, norms, gates,
softmax and masks, the optimizer's elementwise passes, copies.
"""

from __future__ import annotations

from typing import Dict, Optional

from perfbench import readers

MARKS = ("gemm", "gemv", "splitkreduce")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in MARKS)


def seconds_per_unit(ctx: Dict) -> Optional[float]:
    """Device seconds a unit in matrix-product kernels; None where the trace
    has none."""
    t = ctx.get("trace")
    if not t or not t["units"]:
        return None
    spent = [s for name, (_, s) in t["by_name"].items() if is_gemm(name)]
    return sum(spent) / t["units"] if spent else None


def ms_per_unit(ctx: Dict) -> Optional[float]:
    s = seconds_per_unit(ctx)
    return None if s is None else 1e3 * s


def roofline(ctx: Dict) -> Optional[float]:
    """A unit's analytic FLOPs (every matrix product the algorithm needs)
    over its matrix-product seconds, as a share in % of the card's peak in
    the configuration's compute dtype."""
    peaks, s = readers.card(ctx), seconds_per_unit(ctx)
    if peaks is None or not s or not ctx.get("unit_flops"):
        return None
    return 100.0 * ctx["unit_flops"] / s / peaks["flops_per_s"][ctx["dtype"]]
