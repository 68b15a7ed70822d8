"""``R2D2DPG.learner_step`` replayed as one CUDA graph.

An eager learner step launches some 7,000 (walker_r2d2) to 12,000
(cheetah_pixels) small kernels, and the host's ~20 µs a launch, not the
device's work, sets its pace.  ``LearnerGraphs`` captures the step's eager
body (``R2D2DPG._learner_step_eager``) once per input signature into a
``torch.cuda.CUDAGraph`` and replays it: one grouped copy into the graph's
static inputs, one graph launch and one grouped copy out into fresh
tensors, all on the caller's current stream, inside the span
``learner/graph_replay``.

- **When.**  Every input tensor is on a CUDA device and the agent syncs no
  gradients over a mesh (``config.axis_name`` is None).  Otherwise the
  step runs eagerly, for one of these reasons: ``mesh`` (a collective
  falls inside the step), ``cpu`` (an input is not on a card),
  ``instrumented`` (a ``TorchDispatchMode`` such as ``FlopCounterMode`` is
  on, which has to see the ops, or autograd's anomaly mode, which syncs
  inside the step), ``cache_full`` (``MAX_GRAPHS`` signatures are
  captured already) and ``state_size`` (the learner state of a new
  signature is over ``MAX_GRAPH_STATE_BYTES``: a graph holds its static
  inputs, its outputs and the fresh copies a replay hands back, three
  more copies of the state, which at walker_granite's 24 GB do not fit
  beside it on one card; so large a step launches few kernels for its
  work).  The registry counter
  ``r2d2dpg_learner_graph_total{event, reason}`` counts each call:
  ``capture`` (the call that captured), ``replay`` or ``eager`` with its
  reason.
- **Signature.**  Shape, dtype and device of every leaf of the state, the
  batch, the IS weights and the smoothing normal, and whether the normal
  is given.  The config is the agent's, a constant of the graph.
- **Adam's bias corrections** change every step, so the graph takes them
  as a device tensor: the host computes them as the eager step does
  (``adam_bias_reciprocals``), writes them into a fresh pinned tensor and
  copies it in without blocking.  ``step`` and the Adam counts stay Python
  ints.
- **Outputs** never alias the graph's memory: the next replay overwrites
  it, and callers keep earlier states (the pipelined executor's param
  versions, checkpoints).
- **Capture** warms the body up once on a side stream, as CUDA graphs
  ask, then captures on that stream in ``thread_local`` mode, so other
  threads (the pipeline's collector, the fleet's ingest) keep launching on
  their own streams meanwhile, with the garbage collector off.  The first
  call of a signature pays it.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from r2d2dpg_torch.tree import tree_leaves, tree_nbytes, tree_with_leaves
from r2d2dpg_torch.utils.profiling import annotate

GRAPH_METRIC = "r2d2dpg_learner_graph_total"
# Signatures a learner keeps graphs for; a trainer uses one (its batch).
MAX_GRAPHS = 4
# The largest learner state (params, targets, Adam moments) a graph copies.
MAX_GRAPH_STATE_BYTES = 4 << 30


def _counter():
    from r2d2dpg_torch.obs.registry import get_registry

    return get_registry().counter(
        GRAPH_METRIC, "learner steps by path: a graph captured or replayed, "
        "or eager with its reason", labelnames=("event", "reason"))


def _count(event: str, reason: str = "") -> None:
    _counter().labels(event=event, reason=reason).inc()


def _dtype_groups(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` by dtype: one ``_foreach_copy_`` a group."""
    groups: Dict[torch.dtype, List[int]] = defaultdict(list)
    for i, t in enumerate(tensors):
        groups[t.dtype].append(i)
    return list(groups.values())


def _copy_groups(dst: List[torch.Tensor], src: List[torch.Tensor],
                 groups: List[List[int]]) -> None:
    for g in groups:
        torch._foreach_copy_([dst[i] for i in g], [src[i] for i in g])


def _bias_reciprocals(state) -> np.ndarray:
    """This step's Adam bias reciprocals, critic's then actor's."""
    from r2d2dpg_torch.agents.ddpg import adam_bias_reciprocals  # ddpg imports us

    return np.array(
        adam_bias_reciprocals(state.critic_opt_state.count + 1)
        + adam_bias_reciprocals(state.actor_opt_state.count + 1),
        dtype=np.float32)


class _StepGraph:
    """One captured learner step: static inputs, the graph, static outputs."""

    def __init__(self, agent, args: tuple, leaves: List[torch.Tensor]):
        dev = leaves[0].device
        cur, stream = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        self.inputs = [x.detach().clone() for x in leaves]
        self.in_groups = _dtype_groups(self.inputs)
        self.bias = torch.from_numpy(_bias_reciprocals(args[0])).to(dev)
        static = tree_with_leaves(args, self.inputs)
        inv_bias = (self.bias[:2], self.bias[2:])

        def body():
            return agent._learner_step_eager(*static, inv_bias=inv_bias)

        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            body()  # warm-up: the step is pure, its results are dropped
        cur.wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: a collected graph (an
        # agent dropped in a reference cycle) would be destroyed there, a
        # call CUDA forbids while this thread captures, and the capture
        # would be lost.  ``torch.cuda.graph`` collects just before it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                out = body()
        finally:
            if collecting:
                gc.enable()
        self.out_tree = out
        self.outputs = tree_leaves(out)
        self.out_groups = _dtype_groups(self.outputs)
        self.stream = cur  # the stream the last replay ran on

    def replay(self, state, leaves: List[torch.Tensor]):
        cur = torch.cuda.current_stream(self.inputs[0].device)
        if cur != self.stream:
            # The last replay, on another stream, may still read the inputs.
            cur.wait_stream(self.stream)
            self.stream = cur
        _copy_groups(self.inputs, leaves, self.in_groups)
        host = torch.empty(4, dtype=torch.float32, pin_memory=True)
        host.numpy()[:] = _bias_reciprocals(state)
        self.bias.copy_(host, non_blocking=True)
        self.graph.replay()
        fresh = [torch.empty_like(t) for t in self.outputs]
        _copy_groups(fresh, self.outputs, self.out_groups)
        new_state, prios, metrics = tree_with_leaves(self.out_tree, fresh)
        new_state = _with_counts(new_state, state)
        return new_state, prios, metrics


def _with_counts(new_state, state):
    """``new_state`` with the host counters one past ``state``'s (the graph's
    outputs carry those of the step it captured)."""
    return dataclasses.replace(
        new_state,
        step=state.step + 1,
        actor_opt_state=dataclasses.replace(
            new_state.actor_opt_state, count=state.actor_opt_state.count + 1),
        critic_opt_state=dataclasses.replace(
            new_state.critic_opt_state, count=state.critic_opt_state.count + 1),
    )


class LearnerGraphs:
    """An agent's learner-step graphs by input signature (module docstring).

    It holds no reference to its agent, so an agent dropped by its caller
    frees its graphs at once rather than in a later collection."""

    def __init__(self):
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _eager_reason(agent, leaves: List[torch.Tensor]) -> Optional[str]:
        if agent.config.axis_name is not None:
            return "mesh"
        if any(x.device.type != "cuda" for x in leaves):
            return "cpu"
        if _get_current_dispatch_mode() is not None or torch.is_anomaly_enabled():
            return "instrumented"
        return None

    def step(self, agent, state, batch, is_weights, normal=None) -> Tuple:
        """``agent.learner_step(state, batch, is_weights, normal)``."""
        args = (state, batch, is_weights, normal)
        leaves = tree_leaves(args)
        reason = self._eager_reason(agent, leaves)
        if reason is None:
            key = (normal is None,) + tuple(
                (tuple(x.shape), x.dtype, x.device) for x in leaves)
            with self._lock:
                graph = self._graphs.get(key)
                if graph is not None:
                    _count("replay")
                elif tree_nbytes(state) > MAX_GRAPH_STATE_BYTES:
                    reason = "state_size"
                elif len(self._graphs) < MAX_GRAPHS:
                    graph = self._graphs[key] = _StepGraph(agent, args, leaves)
                    _count("capture")
                else:
                    reason = "cache_full"
                if graph is not None:
                    with annotate("learner/graph_replay"):
                        return graph.replay(state, leaves)
        _count("eager", reason)
        return agent._learner_step_eager(state, batch, is_weights, normal)
