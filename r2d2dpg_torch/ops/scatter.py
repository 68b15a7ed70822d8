"""Priority scatter write-back: the CUDA kernel's wrapper and its plain version.

Port of ``r2d2dpg_tpu/ops/pallas/scatter.py``.  ``priority_scatter``
computes ``priority[indices[j]] = values[j]`` for ``j = 0 .. B-1`` in
order: a repeated index keeps its last value, and an index outside
``[0, capacity)`` writes nothing.  It updates ``priority`` in place.

On a CUDA tensor it launches ``csrc/priority_scatter.cu`` (built on first
use, see ``r2d2dpg_torch.kernels``) or raises; on a CPU tensor it runs
``priority_scatter_plain``.  There is no other route.
"""

from __future__ import annotations

import torch

from r2d2dpg_torch.kernels import PRIORITY_SCATTER


def priority_scatter_plain(
    priority: torch.Tensor, indices: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """Reference semantics: sequential writes in order, out-of-range skipped."""
    capacity = priority.shape[0]
    for j, idx in enumerate(indices.tolist()):
        if 0 <= idx < capacity:
            priority[idx] = values[j]
    return priority


def _check(priority, indices, values):
    if not (priority.device == indices.device == values.device):
        raise ValueError(
            "priority_scatter: priority, indices and values must share a device"
        )
    if priority.dtype != torch.float32 or values.dtype != torch.float32:
        raise TypeError("priority_scatter: priority and values must be float32")
    if indices.dtype != torch.int64:
        raise TypeError("priority_scatter: indices must be int64")
    if priority.ndim != 1 or indices.ndim != 1 or values.shape != indices.shape:
        raise ValueError(
            "priority_scatter: need priority [C], indices [B], values [B]; got "
            f"{tuple(priority.shape)}, {tuple(indices.shape)}, {tuple(values.shape)}"
        )
    if not (
        priority.is_contiguous() and indices.is_contiguous() and values.is_contiguous()
    ):
        raise ValueError("priority_scatter: tensors must be contiguous")
    if indices.shape[0] >= 2**31:
        raise ValueError("priority_scatter: batch too large for an int count")


def priority_scatter(
    priority: torch.Tensor, indices: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """``priority[indices] = values`` in place, last write wins; returns it."""
    _check(priority, indices, values)
    if priority.device.type == "cpu":
        return priority_scatter_plain(priority, indices, values)
    if priority.device.type != "cuda":
        raise ValueError(f"priority_scatter: unsupported device {priority.device}")
    b = indices.shape[0]
    if b == 0:
        return priority
    lib = PRIORITY_SCATTER.library()
    with torch.cuda.device(priority.device):
        err = lib.priority_scatter_f32(
            priority.data_ptr(),
            priority.shape[0],
            indices.data_ptr(),
            values.data_ptr(),
            b,
            torch.cuda.current_stream(priority.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"priority_scatter kernel launch failed: cudaError {err}")
    PRIORITY_SCATTER.launches += 1
    return priority
