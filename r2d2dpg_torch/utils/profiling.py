"""Named host regions for profiler timelines, and a block timer.

Port of ``r2d2dpg_tpu/utils/profiling.py``'s ``annotate``, ``scope`` and
``timed``:

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
"""

from __future__ import annotations

import contextlib
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
