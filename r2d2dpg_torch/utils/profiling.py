"""Named host regions for profiler timelines and the program's spans, a
block timer, a trace context and the NaN debug switch.

Port of ``r2d2dpg_tpu/utils/profiling.py``, with spans the JAX package
does not have:

- ``annotate(name, id=None)`` names a host-side region.  While a
  ``torch.profiler`` session runs (the train CLI's ``--profile-phases`` and
  ``--profile-window``, a benchmark's traced pass) it opens a
  profiler range, which puts the region on the trace's host timeline beside
  the ops and kernels it launched.  The range is a plain ``RecordFunction``
  (``torch._C._profiler._RecordFunctionFast``), not a user annotation
  (``torch.profiler.record_function``): a user annotation is also stamped
  on the device's timeline over the kernels under it, where a reader of
  device activity would take it for device work.  Once CUDA is
  initialized it always opens an NVTX range, for NVTX-aware timelines.
  While span timing is on (``enable_spans(True)``; the train and serve
  CLIs turn it on with ``--obs-port``) it also records the span: into the
  flight recorder's span ring (``hop`` the name, ``t_wall`` its start,
  ``dur_s``, ``parent`` the enclosing span on this thread, ``trace_id`` its
  unit's id) and into the
  registry histogram ``r2d2dpg_span_seconds{span=<name>}`` (lifetime count
  and sum, p50/p99 over the last 2,048 spans of a name).  With neither, a
  span opens no profiler range, reads no clock and records nothing: a
  function call, three flag reads and, on CUDA, the NVTX push and pop.
- A span's ``id`` names the unit of work it belongs to (a train phase's
  index, a learner update, a served batch): host counters, never a device
  value.  Without one a span takes its enclosing span's, or the one a
  ``span_id(id)`` block set on this thread (a unit whose spans are
  siblings, with no range around them).
- Its start is ``time.time_ns()``: CLOCK_REALTIME, the clock Kineto
  stamps a trace's host events with, so a ring dump lines up with a
  profiler trace of the same run.  A profiler session sees the ranges of
  the thread that started it (and of threads started under it): not a
  serving worker's, whose spans the registry and the ring still get.
- The spans on the program's paths: ``trainer/collect``,
  ``trainer/emit_add`` and ``trainer/learn`` in ``Trainer.train_phase``
  (id: the phase index); ``learner/is_weights`` and ``learner/quality`` in
  ``Trainer._update_step`` and, in ``R2D2DPG.learner_step``,
  ``learner/burn_in``, ``learner/targets``, ``learner/critic_forward``,
  ``learner/critic_backward``, ``learner/actor_forward``,
  ``learner/actor_backward``, ``learner/optimize`` and
  ``learner/priorities`` (id: the trainer's update count) where the step
  runs eagerly, ``learner/graph_replay`` (the copy in, the graph's launch
  and the copy out) where it replays as a CUDA graph
  (``agents/graph.py``); ``replay/sample``,
  ``replay/add`` and ``replay/write_back`` in ``ReplayArena``; and in the
  serving worker ``serve/next_batch``, ``serve/admit``,
  ``serve/policy_step`` and ``serve/answer`` (id: the worker's batch
  count), with each request's queue wait observed into
  ``r2d2dpg_serve_queue_wait_seconds`` as its batch is handed over.
  The training loops also wrap their phase dispatches in ``annotate``
  (``Trainer.run``, both threads of the pipelined executor).
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
import threading
import time
from typing import Dict, Iterator, Optional

import torch

SPAN_METRIC = "r2d2dpg_span_seconds"

_profiler_enabled = torch.autograd._profiler_enabled
_RecordFunction = torch._C._profiler._RecordFunctionFast  # a host range alone
_timing = False
_cells: Dict[str, object] = {}  # span name -> its histogram cell
_tls = threading.local()  # .parent (enclosing span's name), .id (its unit)


def enable_spans(on: bool) -> None:
    """Turn span timing on or off for the whole process (off by default).
    The histograms register on the first span timed after it is turned on."""
    global _timing
    _cells.clear()
    _timing = bool(on)


def spans_enabled() -> bool:
    return _timing


class _Off:
    """What a span is with timing off and no profiler session."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _cell(name: str):
    cell = _cells.get(name)
    if cell is None:
        from r2d2dpg_torch.obs.registry import get_registry

        cell = _cells[name] = get_registry().histogram(
            SPAN_METRIC, "host seconds in each of the program's spans",
            labelnames=("span",)).labels(span=name)
    return cell


class _Nvtx:
    """An NVTX range alone (timing off, no profiler session, CUDA up)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        torch.cuda.nvtx.range_pop()
        return False


class _Span:
    __slots__ = ("name", "id", "timed", "rf", "nvtx", "prev", "t0")

    def __init__(self, name: str, id: Optional[int], timed: bool, ranged: bool):
        self.name, self.id, self.timed = name, id, timed
        self.rf = _RecordFunction(name) if ranged else None
        self.nvtx = torch.cuda.is_initialized()

    # The timed interval encloses the profiler's and NVTX's ranges.
    def __enter__(self):
        if self.timed:
            parent, unit = getattr(_tls, "parent", None), getattr(_tls, "id", None)
            if self.id is None:
                self.id = unit
            self.prev = (parent, unit)
            _tls.parent, _tls.id = self.name, self.id
            self.t0 = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.timed:
            dur = max(time.time_ns() - self.t0, 0) * 1e-9
            parent = self.prev[0]
            _tls.parent, _tls.id = self.prev
            from r2d2dpg_torch.obs.flight import get_flight_recorder

            get_flight_recorder().record_span(
                self.name, self.id if self.id is not None else 0, self.t0 * 1e-9,
                dur, parent=parent)
            _cell(self.name).observe(dur)
        return False


def annotate(name: str, id: Optional[int] = None):
    """A host region ``name`` (module docstring): an NVTX range on CUDA, a
    profiler range while a profiler session runs, and with span timing on
    a recorded span."""
    ranged = _profiler_enabled()
    if _timing or ranged:
        return _Span(name, id, _timing, ranged)
    return _Nvtx(name) if torch.cuda.is_initialized() else _OFF


@contextlib.contextmanager
def span_id(id: int) -> Iterator[None]:
    """Spans opened in the block on this thread take ``id`` (no range, no
    record of its own; nothing with timing off)."""
    if not _timing:
        yield
        return
    prev = getattr(_tls, "id", None)
    _tls.id = id
    try:
        yield
    finally:
        _tls.id = prev


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
