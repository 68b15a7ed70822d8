"""The program's spans (``utils/profiling.py::annotate``) on a tiny config.

- One learner update, one train phase and one served batch each record
  exactly the named spans, with their parents and the id of their unit.
- The results are bitwise the same with span timing on and off.
- Off, a span records nothing, touches no histogram and enters no
  profiler range unless a profiler runs; a profiler session still sees
  the range, as a host range and not a user annotation (which the
  profiler would also stamp on the device's timeline).
- Every served request adds one queue wait; the ring's Chrome trace
  carries the parents; ``r2d2dpg_span_seconds`` renders in the Prometheus
  text.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from r2d2dpg_torch import obs
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.models import ActorNet
from r2d2dpg_torch.obs import chrome_trace, get_flight_recorder, get_registry
from r2d2dpg_torch.serving import PolicyService
from r2d2dpg_torch.serving.batcher import QUEUE_WAIT_METRIC
from r2d2dpg_torch.training.draws import Draws
from r2d2dpg_torch.tree import tree_map
from r2d2dpg_torch.utils import profiling
from r2d2dpg_torch.utils.profiling import SPAN_METRIC, annotate

LEARNER = ["learner/is_weights", "learner/burn_in", "learner/targets",
           "learner/critic_forward", "learner/critic_backward", "learner/actor_forward",
           "learner/actor_backward", "learner/optimize", "learner/priorities",
           "replay/write_back", "learner/quality"]
SERVE = ["serve/next_batch", "serve/admit", "serve/policy_step", "serve/answer"]


@pytest.fixture
def spans():
    """Span timing on, an empty ring; off again afterwards."""
    ring = get_flight_recorder()
    ring.clear_spans()
    obs.enable_spans(True)
    try:
        yield ring
    finally:
        obs.enable_spans(False)
        ring.clear_spans()


def _trainer_at_train_phase():
    """pendulum_tiny on the CPU, its warm-up and fill phases run."""
    t = PENDULUM_TINY.build("cpu")
    state = t.init(Draws(0, torch.device("cpu")))
    for _ in range(t.window_fill_phases):
        state = t.collect_phase(state)
    for _ in range(t.replay_fill_phases):
        state = t.fill_phase(state)
    return t, state


def _clone(state):
    """A copy of a trainer state that later calls cannot touch (the arena's
    buffers change in place, the draws advance)."""
    draws = Draws(state.draws.seed, state.draws.device)
    draws.generator.set_state(state.draws.generator.get_state())
    arena = dataclasses.replace(
        state.arena, data=tree_map(torch.clone, state.arena.data),
        priority=state.arena.priority.clone(), meta=state.arena.meta.clone())
    return dataclasses.replace(state, arena=arena, draws=draws)


def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _leaves(e)]
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x) for v in _leaves(getattr(x, f.name))]
    return []


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _spans_of(ring):
    return [(s["hop"], s.get("parent"), s["trace_id"]) for s in ring.spans()]


def test_one_learner_update_records_its_spans_with_one_id(spans):
    t, state = _trainer_at_train_phase()
    spans.clear_spans()
    before = t._updates
    res = t._sample(state.arena, state.draws)
    t._update_step(state.train, state.arena, res, t._smoothing_normal(res, state.draws))
    got = _spans_of(spans)
    assert got[0] == ("replay/sample", None, 0)  # no unit around the draw
    assert got[1:] == [(n, None, before + 1) for n in LEARNER]
    assert all(s["dur_s"] >= 0 and s["t_wall"] > 0 for s in spans.spans())


def test_one_train_phase_records_its_parts(spans):
    t, state = _trainer_at_train_phase()
    spans.clear_spans()
    phase, update = state.phase_idx, t._updates + 1
    t.train_phase(state)
    want = ([("trainer/collect", None, phase), ("replay/add", "trainer/emit_add", phase),
             ("trainer/emit_add", None, phase), ("replay/sample", "trainer/learn", phase)]
            + [(n, "trainer/learn", update) for n in LEARNER]
            + [("trainer/learn", None, phase)])
    assert t.config.learner_steps == 1
    assert _spans_of(spans) == want


def test_a_learner_update_and_a_train_phase_are_bitwise_with_spans_on_and_off():
    t, state = _trainer_at_train_phase()
    out = {}
    for on in (False, True, False):
        obs.enable_spans(on)
        try:
            s = _clone(state)
            res = t._sample(s.arena, s.draws)
            train, arena, m = t._update_step(s.train, s.arena, res,
                                             t._smoothing_normal(res, s.draws))
            phased, pm = t.train_phase(_clone(state))
        finally:
            obs.enable_spans(False)
        out.setdefault(on, []).append(
            (train, arena.priority, m, phased.train, phased.arena, pm, phased.obs))
    _bitwise(out[False][0], out[True][0])
    _bitwise(out[False][0], out[False][1])


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    obs.enable_spans(False)
    ring = get_flight_recorder()
    ring.clear_spans()
    hist = get_registry().get(SPAN_METRIC)
    counts = ({} if hist is None else
              {s["labels"]["span"]: s["count"]
               for s in get_registry().snapshot()[SPAN_METRIC]["samples"]})

    def entered(*_a, **_k):
        raise AssertionError("a span entered a profiler range with no profiler running")

    monkeypatch.setattr(profiling, "_RecordFunction", entered)
    monkeypatch.setattr(profiling.time, "time_ns", entered)
    t, state = _trainer_at_train_phase()
    t.train_phase(state)
    with annotate("learner/burn_in", 3):
        pass
    assert ring.spans() == []
    after = get_registry().get(SPAN_METRIC)
    assert (after is None) == (hist is None)
    if after is not None:
        assert {s["labels"]["span"]: s["count"]
                for s in get_registry().snapshot()[SPAN_METRIC]["samples"]} == counts


def test_a_profiler_sees_each_span_as_a_host_range_alone():
    obs.enable_spans(False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("learner/burn_in", 3):
            (torch.ones(4) * 2).sum()
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "learner/burn_in"]
    assert len(ranges) == 1
    assert not ranges[0].is_user_annotation()


def _service(**kw):
    actor = ActorNet((3,), 2, hidden=8, use_lstm=True)
    params = actor.init_params(torch.Generator().manual_seed(1), "cpu")
    return PolicyService(actor, params, obs_shape=(3,), max_batch=4, flush_ms=20.0,
                         device="cpu", **kw)


def _serve(service, n):
    obs_rows = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    reqs = [service.act_async(f"s{i}", obs_rows[i]) for i in range(n)]
    assert all(r.wait(30) for r in reqs)
    return np.stack([r.action for r in reqs])


def test_a_served_batch_records_its_spans_and_each_queue_wait(spans):
    with _service() as service:
        hist = get_registry().histogram(QUEUE_WAIT_METRIC)
        before = hist.count
        time.sleep(0.1)  # the worker idles in next_batch
        spans.clear_spans()
        _serve(service, 4)
        time.sleep(0.1)
    got = _spans_of(spans)
    served = [x for x in got if x[0] != "serve/next_batch"]
    (cycle,) = {c for _, _, c in served}
    assert [n for n, _, _ in served] == SERVE[1:]
    assert ("serve/next_batch", None, cycle) in got
    assert all(parent is None for _, parent, _ in got)
    assert hist.count == before + 4
    assert hist.percentiles((0.0,))[0] >= 0.0  # the smallest wait


def test_served_actions_are_bitwise_with_spans_on_and_off():
    actions = []
    for on in (False, True):
        obs.enable_spans(on)
        try:
            with _service() as service:
                actions.append(_serve(service, 4))
        finally:
            obs.enable_spans(False)
    assert np.array_equal(actions[0], actions[1])


def test_the_rings_chrome_trace_carries_the_parents(spans):
    with annotate("trainer/learn", 7):
        with annotate("learner/optimize"):
            pass
    events = chrome_trace(spans.spans())["traceEvents"]
    inner = next(e for e in events if e["name"] == "learner/optimize")
    assert inner["args"]["parent"] == "trainer/learn"
    assert inner["args"]["trace_id"] == 7 and inner["tid"] == 7
    outer = next(e for e in events if e["name"] == "trainer/learn")
    assert "parent" not in outer["args"]


def test_span_seconds_render_in_the_prometheus_text(spans):
    with annotate("replay/sample"):
        pass
    text = get_registry().prometheus_text()
    assert "# TYPE r2d2dpg_span_seconds summary" in text
    assert any(line.startswith('r2d2dpg_span_seconds_count{span="replay/sample"}')
               for line in text.splitlines())
