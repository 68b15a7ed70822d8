"""Port parity: the telemetry the pipelined executor drives, against JAX.

- The divergence watchdog: the same verdict (trip or not, reason, step,
  the flight event's fields) as the JAX watchdog on the same scalar rows.
- ``chrome_trace``: the same document as JAX's for the same spans; the
  span ring's bound and its atomic ``trace.json`` dump.
- ``obs/trace.py``: ``record_hop`` fills the hop's histogram and the span
  ring; rate 0 touches no RNG; ``HOPS`` is JAX's tuple.
- ``QualityPlane``: the same gauge values and final stamp as JAX's for
  the same ``publish_scalars`` calls, and the same pure folds.
- The arena's and the trainer's gauges after ``pop_episode_metrics`` on a
  converted pendulum_tiny state equal the JAX trainer's on the same state.
- ``utils/profiling.py`` and the device monitor's run window.
Every comparison is exact (pure host arithmetic on the same inputs) unless
it says otherwise.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.obs import flight as j_flight
from r2d2dpg_tpu.obs import quality as j_quality
from r2d2dpg_tpu.obs import trace as j_trace
from r2d2dpg_tpu.obs import watchdog as j_watchdog
from r2d2dpg_tpu.obs.registry import Registry as JRegistry
from r2d2dpg_torch.obs import (
    DeviceMonitor,
    DivergenceError,
    DivergenceWatchdog,
    FlightRecorder,
    Registry,
    WatchdogConfig,
    chrome_trace,
    get_flight_recorder,
    get_registry,
)
from r2d2dpg_torch.obs import quality, trace
from r2d2dpg_torch.utils.metrics import PercentileWindow
from r2d2dpg_torch.utils.profiling import annotate, enable_spans, timed

ROWS = [
    {"critic_loss": 1.0, "grad_norm": 3.0, "param_norm": 10.0},
    {"critic_loss": float("nan"), "grad_norm": 3.0},
    {"actor_loss": float("-inf")},
    {"critic_loss": 1.0, "grad_norm": 2e6},
    {"critic_loss": 1.0, "grad_norm": 5.0, "param_norm": 3e7},
    {"grad_norm": 50.0, "param_norm": 50.0},
]
THRESHOLDS = [dict(), dict(grad_norm_max=10.0, param_norm_max=40.0)]


def _verdict(make_dog, errors, recorder, step, row):
    dog = make_dog()
    try:
        dog.check(step, row)
    except errors as e:
        trip = [ev for ev in recorder.events() if ev["kind"] == "watchdog_trip"][-1]
        return (e.reason, e.step, {k: trip[k] for k in ("step", "reason", "scalars")})
    return None


@pytest.mark.parametrize("limits", THRESHOLDS, ids=["defaults", "tight"])
@pytest.mark.parametrize("row", range(len(ROWS)))
def test_watchdog_verdicts_match_jax(limits, row):
    step = 100 + row
    port_rec, jax_rec = FlightRecorder(), j_flight.FlightRecorder()
    got = _verdict(
        lambda: DivergenceWatchdog(WatchdogConfig(**limits), registry=Registry(),
                                   recorder=port_rec),
        DivergenceError, port_rec, step, ROWS[row])
    want = _verdict(
        lambda: j_watchdog.DivergenceWatchdog(j_watchdog.WatchdogConfig(**limits),
                                              registry=JRegistry(), recorder=jax_rec),
        j_watchdog.DivergenceError, jax_rec, step, ROWS[row])
    assert got == want


def test_watchdog_counts_checks_and_trips():
    reg = Registry()
    dog = DivergenceWatchdog(registry=reg, recorder=FlightRecorder())
    dog.check(1, ROWS[0])
    with pytest.raises(DivergenceError):
        dog.check(2, ROWS[1])
    assert reg.get("r2d2dpg_watchdog_checks_total").value == 2
    assert reg.get("r2d2dpg_watchdog_trips_total").value == 1


def _spans():
    return [
        {"hop": "learn", "trace_id": 7, "t_wall": 12.5, "dur_s": 0.25, "pid": 3},
        {"hop": "collect", "trace_id": 2**40 + 5, "t_wall": 10.0, "dur_s": 1.5,
         "pid": 3, "bytes": 128},
        {"hop": "enqueue", "trace_id": 7, "t_wall": 11.0, "dur_s": -0.1, "pid": 4},
    ]


def test_chrome_trace_matches_jax():
    assert chrome_trace(_spans()) == j_flight.chrome_trace(_spans())


def test_span_ring_is_bounded_and_dumps_trace_json_next_to_flight(tmp_path):
    rec = FlightRecorder(capacity=4)
    assert rec.dump_trace(str(tmp_path / "t.json")) is None  # no spans, no file
    assert not (tmp_path / "t.json").exists()
    for i in range(2050):
        rec.record_span("collect", i, float(i), 0.5, bytes=None, width=2)
    spans = rec.spans()
    assert len(spans) == 2048 and spans[0]["trace_id"] == 2
    assert "bytes" not in spans[0] and spans[0]["width"] == 2
    rec.install(str(tmp_path / "flight.jsonl"))
    path = rec.dump_trace()
    assert path == os.path.join(str(tmp_path), "trace.json")
    doc = json.loads(open(path).read())
    assert doc == j_flight.chrome_trace(spans)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    rec.clear_spans()
    assert rec.spans() == []


def test_record_hop_fills_the_histogram_and_the_span_ring():
    assert trace.HOPS == j_trace.HOPS
    hist = trace.hop_histogram("arena_add")
    before = hist.count
    ring = get_flight_recorder()
    ring.clear_spans()
    dur = trace.record_hop("arena_add", 5.0, 4.0, 99, bytes=64)
    assert dur == 0.0  # clamped, like JAX
    assert hist.count == before + 1
    (span,) = ring.spans()
    assert (span["hop"], span["trace_id"], span["t_wall"], span["dur_s"], span["bytes"]) == (
        "arena_add", 99, 5.0, 0.0, 64)
    with pytest.raises(ValueError, match="unknown trace hop"):
        trace.hop_histogram("teleport")
    ring.clear_spans()


def test_maybe_start_at_rate_zero_touches_no_rng(monkeypatch):
    def forbidden(*_):
        raise AssertionError("rate 0 drew a random number")

    monkeypatch.setattr(trace.random, "random", forbidden)
    monkeypatch.setattr(trace.random, "getrandbits", forbidden)
    assert trace.maybe_start(0.0) is None
    monkeypatch.undo()
    stamp = trace.maybe_start(1.0)
    assert stamp is not None and 0 <= stamp.trace_id < 2**47


def test_quality_plane_publish_scalars_matches_jax():
    port = quality.QualityPlane(registry=Registry())
    ref = j_quality.QualityPlane(registry=JRegistry())
    calls = [dict(ess_frac=0.5, is_saturation=0.125, replay_age_mean=3.0),
             dict(ess_frac=float("nan"), replay_age_mean=7.5),
             dict(is_saturation=1.0),
             dict(ess_frac=0.9, is_saturation=float("inf"), replay_age_mean=None)]
    for kw in calls:
        port.publish_scalars(**kw)
        ref.publish_scalars(**kw)
        assert port.ess.value == ref.ess.value
        assert port.saturation.value == ref.saturation.value
        assert port.age.snapshot() == ref.age.snapshot()
    assert port.snapshot_final() == ref.snapshot_final()
    assert quality.METRIC_NAMES == j_quality.METRIC_NAMES


def test_quality_folds_match_jax():
    rng = np.random.default_rng(3)
    probs = rng.random(64) * 0.01
    probs[5] = 0.0
    for fn, args in (("ess_fraction", (probs,)),
                     ("is_saturation_fraction", (probs, 500.0, 0.4)),
                     ("policy_lags", (40, np.array([3, -1, 41, 12]))),
                     ("replay_ages", (9, np.array([-1, 2, 9, 12])))):
        got, want = getattr(quality, fn)(*args), getattr(j_quality, fn)(*args)
        np.testing.assert_array_equal(got, want, err_msg=fn)


def test_pop_episode_metrics_publishes_the_jax_gauges():
    from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
    from r2d2dpg_tpu.obs import get_registry as j_get_registry
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.convert import trainer_state_from_jax

    jt = J_TINY.build()
    js = jt.run(6, log_every=0)
    host = jax.device_get(js)
    _, jep = jt.pop_episode_metrics(js)
    names = ("r2d2dpg_replay_capacity", "r2d2dpg_replay_occupancy",
             "r2d2dpg_replay_priority_sum", "r2d2dpg_replay_sequences_added",
             "r2d2dpg_trainer_env_steps", "r2d2dpg_trainer_episode_return_mean")
    want = {n: j_get_registry().get(n).value for n in names}
    t = PENDULUM_TINY.build("cpu")
    _, ep = t.pop_episode_metrics(trainer_state_from_jax(host, None, device="cpu"))
    got = {n: get_registry().get(n).value for n in names}
    assert got.keys() == want.keys()
    for n in names:  # the priority sum: float32 sums in another order
        assert math.isclose(got[n], want[n], rel_tol=1e-6), n
    assert ep == pytest.approx(jep, rel=1e-6)


def test_profiling_ranges_show_in_the_profiler_and_timed_adds():
    # Span timing off: a profiler session still sees every range, and the
    # span ring records none of them.
    enable_spans(False)
    ring = get_flight_recorder()
    ring.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("pipeline/learn"):
            torch.ones(4).sum()
        with annotate("pipeline_add"):
            torch.ones(4).sum()
    keys = {e.key for e in prof.key_averages()}
    assert {"pipeline/learn", "pipeline_add"} <= keys
    assert ring.spans() == []
    win = PercentileWindow()
    with timed(win):
        pass
    with pytest.raises(RuntimeError):
        with timed(win):
            raise RuntimeError("timed still adds")
    assert win.count == 2 and win.total >= 0.0


def test_device_monitor_run_window_on_the_cpu():
    reg = Registry()
    mon = DeviceMonitor(registry=reg).install()
    mon.begin_run()
    assert not mon.steady
    for n in (1, 2, 3):
        mon.on_phase(n)
        mon.note_learn()
        if n == 1:
            mon.mark_steady()
    assert mon.steady
    stats = mon.run_stats()
    mon.end_run()
    assert not mon.steady
    assert stats == {"compile_count": 0.0, "compile_seconds": 0.0,
                     "steady_recompiles": 0.0, "peak_hbm_bytes": 0.0,
                     "learn_phases": 3.0}
    # The CPU has no allocator to read: the memory gauges stay absent.
    assert reg.snapshot()["r2d2dpg_device_hbm_bytes_in_use"]["samples"] == []
    mon.begin_run()
    assert mon.run_stats()["learn_phases"] == 0.0
