"""Named host regions for profiler timelines, a block timer, a trace
context and the NaN debug switch.

Port of ``r2d2dpg_tpu/utils/profiling.py``:

- ``annotate(name)`` names a host-side region: a
  ``torch.profiler.record_function`` range (it shows in a
  ``torch.profiler`` trace) plus an NVTX range once CUDA is initialized in
  the process (it shows in any NVTX-aware timeline).  The training loops wrap
  their phase dispatches in it (``Trainer.run``, both threads of the
  pipelined executor).
- ``scope(name)`` names a region inside a phase.  JAX needs it apart from
  ``annotate`` because a jitted region runs at trace time; eager torch runs
  every region when it is written, so ``scope`` is the same range.
- ``timed(window)`` adds the block's seconds to anything with ``add``
  (a ``PercentileWindow`` or a registry ``Histogram``).
- ``profile_trace(logdir)`` traces the enclosed block with
  ``torch.profiler`` (host activity, and the card's once CUDA is
  initialized) and exports a Chrome trace into ``logdir`` (the train CLI's
  ``--profile-phases``).
- ``nan_debug(True)`` turns on ``torch.autograd.set_detect_anomaly(True,
  check_nan=True)``: a backward op that returns a NaN raises at that op,
  with the forward traceback that made it.  It sees backward only; JAX's
  ``jax_debug_nans`` also stops at a NaN made in the forward pass.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A host region ``name``: profiler range, and an NVTX range on CUDA."""
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def scope(name: str):
    """A region inside a phase; in eager torch the same range as ``annotate``."""
    return annotate(name)


@contextlib.contextmanager
def timed(window) -> Iterator[None]:
    """Add the enclosed block's seconds to ``window`` (anything with ``add``)."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        window.add(time.monotonic() - t0)


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Trace the enclosed block into ``logdir`` (a Chrome trace file)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_initialized()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"profile_pid{os.getpid()}.pt.trace.json"))


def nan_debug(enable: bool = True) -> None:
    """Raise at the backward op that makes a NaN (debug runs only: anomaly
    mode records forward tracebacks and checks every backward output)."""
    torch.autograd.set_detect_anomaly(enable, check_nan=enable)
