"""Priority scatter write-back: the CUDA kernel's wrapper and its plain version.

Port of ``r2d2dpg_tpu/ops/pallas/scatter.py``.  ``priority_scatter``
computes ``priority[indices[j]] = values[j]`` for ``j = 0 .. B-1`` in
order: a repeated index keeps its last value, and an index outside
``[0, capacity)`` writes nothing.  It updates ``priority`` in place.

On a CUDA tensor it launches ``csrc/priority_scatter.cu`` (built on first
use, see ``r2d2dpg_torch.kernels``) or raises; on a CPU tensor it runs
``priority_scatter_plain``.  There is no other route.  The kernel runs one
block sized to the batch, or blocks of 1,024 threads past that, as
``_launch_shape`` computes.  It counts updates in 32-bit ints, so B is
limited to ``MAX_BATCH``, and compares indices as 32-bit keys (as the TPU
kernel's int32 indices), so the capacity is limited to ``MAX_CAPACITY``, on
every device alike.
"""

from __future__ import annotations

import struct

import torch

from r2d2dpg_torch.kernels import PRIORITY_SCATTER

MAX_THREADS = 1024  # threads in one block
# Updates are counted in 32-bit ints, with room for one block past the last.
MAX_BATCH = 2**31 - 1 - MAX_THREADS
MAX_CAPACITY = 2**31 - 1  # indices are compared as 32-bit keys

# The kernel's launch record, LaunchArgs in csrc/priority_scatter.cu:
# priority, capacity, indices, values, B, blocks, threads, stream.  One
# packed argument costs ctypes far less than eight converted ones.
_LAUNCH_RECORD = struct.Struct("=8q")
_F32, _I64 = torch.float32, torch.int64
_UNIT_STRIDE = (1,)


def priority_scatter_plain(
    priority: torch.Tensor, indices: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """Reference semantics: sequential writes in order, out-of-range skipped."""
    capacity = priority.shape[0]
    for j, idx in enumerate(indices.tolist()):
        if 0 <= idx < capacity:
            priority[idx] = values[j]
    return priority


def _launch_shape(b: int) -> tuple[int, int]:
    """(blocks, threads) of the kernel's grid.

    One block of ``ceil(b/32)*32`` threads up to ``MAX_THREADS``; past that,
    blocks of ``MAX_THREADS`` (the kernel's warps share nothing).
    """
    threads = min(-(-b // 32) * 32, MAX_THREADS)
    return -(-b // threads), threads


def _check(priority, indices, values) -> tuple[int, int]:
    """Raise on what the kernel does not take; return (B, capacity)."""
    if priority.dtype is not _F32 or values.dtype is not _F32:
        raise TypeError("priority_scatter: priority and values must be float32")
    if indices.dtype is not _I64:
        raise TypeError("priority_scatter: indices must be int64")
    # Stride (1,) is 1-D and contiguous; anything else takes the full check
    # (a length-1 view may be contiguous with another stride).
    if not (priority.stride() == indices.stride() == values.stride() == _UNIT_STRIDE):
        if priority.dim() != 1 or indices.dim() != 1 or values.dim() != 1:
            raise ValueError(
                "priority_scatter: need priority [C], indices [B], values [B]; got "
                f"{tuple(priority.shape)}, {tuple(indices.shape)}, "
                f"{tuple(values.shape)}"
            )
        if not (
            priority.is_contiguous()
            and indices.is_contiguous()
            and values.is_contiguous()
        ):
            raise ValueError("priority_scatter: tensors must be contiguous")
    b = indices.numel()
    if values.numel() != b:
        raise ValueError(
            f"priority_scatter: indices [{b}] and values [{values.numel()}] differ"
        )
    dev = priority.device
    if indices.device != dev or values.device != dev:
        raise ValueError(
            "priority_scatter: priority, indices and values must share a device"
        )
    if b > MAX_BATCH:
        raise ValueError(
            f"priority_scatter: batch {b} exceeds {MAX_BATCH}: updates are "
            "counted in 32-bit ints"
        )
    capacity = priority.numel()
    if capacity > MAX_CAPACITY:
        raise ValueError(
            f"priority_scatter: capacity {capacity} exceeds {MAX_CAPACITY}: "
            "indices are compared as 32-bit keys"
        )
    return b, capacity


def priority_scatter(
    priority: torch.Tensor, indices: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """``priority[indices] = values`` in place, last write wins; returns it."""
    b, capacity = _check(priority, indices, values)
    if not priority.is_cuda:
        if priority.device.type == "cpu":
            return priority_scatter_plain(priority, indices, values)
        raise ValueError(f"priority_scatter: unsupported device {priority.device}")
    if b == 0:
        return priority
    index = priority.get_device()
    record = _LAUNCH_RECORD.pack(
        priority.data_ptr(), capacity, indices.data_ptr(),
        values.data_ptr(), b, *_launch_shape(b),
        torch._C._cuda_getCurrentRawStream(index),
    )
    launch = PRIORITY_SCATTER.function("priority_scatter_f32")
    if index == torch._C._cuda_getDevice():
        err = launch(record)
    else:
        with torch.cuda.device(index):
            err = launch(record)
    if err != 0:
        raise RuntimeError(f"priority_scatter kernel launch failed: cudaError {err}")
    # A launch recorded into a CUDA graph counts here once; replays do not.
    PRIORITY_SCATTER.launches += 1
    return priority
