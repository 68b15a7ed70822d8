"""The port's session-affine router against the JAX router and its own service.

- ``worker_for`` equals the JAX ``worker_for`` exactly, for 5,000 session
  ids and 1 to 8 workers, and keeps the JAX golden pins.
- Interleaved traffic over 2 workers stays affine (each session's slot on
  its hash worker, zero violations) and is BITWISE equal to each session's
  rollout alone (``test_torch_serving.padded_rollout``); a 1-worker router
  serves bitwise what the plain ``PolicyService`` serves.
- A hot reload through ``FanoutReloader`` reaches every worker off ONE
  restore, with carries continuous across the swap; sheds land on the
  hashed worker's ``worker=`` label.
"""

import collections

import numpy as np
import pytest

from r2d2dpg_tpu.serving.router import worker_for as jax_worker_for
from r2d2dpg_torch.obs.registry import Registry
from r2d2dpg_torch.serving import (
    FanoutReloader,
    PolicyService,
    ServiceRouter,
    build_router,
    default_worker_devices,
    worker_for,
)
from r2d2dpg_torch.utils.codes import OK, SHED_QUEUE
from test_torch_serving import OBS, drive, init_params, make_actor, padded_rollout


def make_router(actor, params=None, *, num_workers=2, reloader=None, **kw):
    kw.setdefault("obs_shape", OBS)
    kw.setdefault("max_sessions", 8)
    kw.setdefault("max_batch", 2)
    kw.setdefault("flush_ms", 1.0)
    kw.setdefault("registry", Registry())
    return build_router(
        actor, num_workers=num_workers, params=params, reloader=reloader,
        device="cpu", **kw,
    )


class FakeReloader:
    """In-memory stand-in for CheckpointHotReloader; ``restores`` counts reads."""

    def __init__(self, params, step=1):
        self._latest = (params, int(step))
        self.current_step = None
        self.last_error = None
        self.restores = 0

    def publish(self, params, step):
        self._latest = (params, int(step))

    def load_latest(self):
        params, step = self._latest
        self.current_step = step
        self.restores += 1
        return params

    def poll(self):
        params, step = self._latest
        if step == self.current_step:
            return None
        self.current_step = step
        self.restores += 1
        return params

    def staleness_s(self):
        return 0.0


def test_worker_for_equals_the_jax_router_exactly():
    sids = [f"user-{i}" for i in range(4000)] + [f"s{i}-é" for i in range(1000)]
    for n in range(1, 9):
        assert [worker_for(s, n) for s in sids] == [jax_worker_for(s, n) for s in sids]
    assert [worker_for(s, 4) for s in ("alice", "bob", "carol", "dave")] == [0, 1, 2, 3]
    for n in (2, 4):
        assert len({worker_for(f"user-{i}", n) for i in range(64)}) == n
    with pytest.raises(ValueError):
        worker_for("x", 0)


def test_default_worker_devices():
    assert [d.type for d in default_worker_devices(3, "cpu")] == ["cpu"] * 3


def test_router_sessions_stay_affine_and_bitwise():
    actor = make_actor()
    params = init_params(actor)
    rng = np.random.default_rng(3)
    sids = [f"client-{i}" for i in range(6)]
    obs = {s: rng.standard_normal((6,) + OBS).astype(np.float32) for s in sids}
    router = make_router(actor, params)
    with router:
        got = drive(router, obs, 6)
        expected = collections.Counter(worker_for(s, 2) for s in sids)
        for w, svc in enumerate(router.services):
            assert svc.sessions.active == expected[w]
    h = router.health()
    assert h["workers"] == 2 and h["requests_ok"] == 36
    assert h["requests_shed"] == 0 and h["affinity_violations"] == 0
    for s in sids:
        want = padded_rollout(actor, [params] * 6, obs[s], rows=2)
        for t in range(6):
            np.testing.assert_array_equal(got[s][t][1], want[t])


def test_router_one_worker_bitwise_equal_to_plain_service():
    actor = make_actor()
    params = init_params(actor)
    rng = np.random.default_rng(11)
    obs = {s: rng.standard_normal((4,) + OBS).astype(np.float32) for s in "abc"}
    plain = PolicyService(actor, params, obs_shape=OBS, max_sessions=8,
                          max_batch=2, flush_ms=1.0, device="cpu")
    with plain:
        want = drive(plain, obs, 4)
    with make_router(actor, params, num_workers=1) as routed:
        got = drive(routed, obs, 4)
    for s in obs:
        for t in range(4):
            np.testing.assert_array_equal(got[s][t][1], want[s][t][1])


def test_hot_reload_broadcasts_off_one_restore():
    actor = make_actor()
    params_by_step = {1: init_params(actor, 1), 2: init_params(actor, 2)}
    base = FakeReloader(params_by_step[1], step=1)
    sids = [f"s{i}" for i in range(4)]
    assert {worker_for(s, 2) for s in sids} == {0, 1}
    rng = np.random.default_rng(7)
    obs = {s: rng.standard_normal((8,) + OBS).astype(np.float32) for s in sids}
    served = {s: [] for s in sids}
    router = make_router(actor, reloader=base)
    with router:
        for t in range(8):
            if t == 3:
                base.publish(params_by_step[2], step=2)
            pending = [(s, router.act_async(s, obs[s][t], reset=(t == 0))) for s in sids]
            for s, req in pending:
                assert req.wait(30.0) and req.code == OK, req.code
                served[s].append((req.params_step, req.action))
        h = router.health()
    for snap in h["per_worker"].values():
        assert snap["params_step"] == 2
    assert base.restores == 2  # load_latest + one poll, for both workers
    for s in sids:
        steps = [ps for ps, _ in served[s]]
        assert steps[0] == 1 and steps[-1] == 2 and steps == sorted(steps)
        want = padded_rollout(actor, [params_by_step[ps] for ps in steps], obs[s], rows=2)
        for t in range(8):
            np.testing.assert_array_equal(served[s][t][1], want[t])
    assert router.affinity_violations == 0


def test_fanout_reloader_views_apply_lazily_and_once():
    actor = make_actor()
    base = FakeReloader(init_params(actor, 1), step=1)
    fan = FanoutReloader(base)
    views = [fan.view("cpu") for _ in range(3)]
    for v in views:
        v.load_latest()
        assert v.current_step == 1
    assert base.restores == 1
    base.publish(init_params(actor, 2), step=2)
    for v in views:
        assert v.poll() is not None and v.current_step == 2
    assert base.restores == 2
    assert all(v.poll() is None for v in views)


def test_shed_attribution_lands_on_the_hashed_worker_label():
    reg = Registry()
    sids = [f"u{i}" for i in range(16)]
    expected = collections.Counter(str(worker_for(s, 2)) for s in sids)
    router = make_router(make_actor(), init_params(make_actor()), max_queue=0,
                         registry=reg)
    router.start(warmup=False)
    try:
        for s in sids:
            assert router.act_async(s, np.zeros(OBS, np.float32)).code == SHED_QUEUE
    finally:
        router.stop()
    sheds = reg.get("r2d2dpg_serve_sheds_total")
    for w in ("0", "1"):
        assert sheds.labels(worker=w, code=SHED_QUEUE).value == float(expected[w])
    assert router.affinity_violations == 0
    assert reg.get("r2d2dpg_serve_workers").value == 2.0


def test_router_end_session_and_requires_workers():
    actor = make_actor()
    router = make_router(actor, init_params(actor))
    with router:
        req = router.act_async("goodbye", np.zeros(OBS, np.float32), reset=True)
        assert req.wait(30.0) and req.code == OK
        w = worker_for("goodbye", 2)
        assert router.services[w].sessions.active == 1
        assert router.end_session("goodbye")
        assert router.services[w].sessions.active == 0
        assert not router.end_session("never-seen")
    with pytest.raises(ValueError):
        ServiceRouter([])
    with pytest.raises(ValueError):
        build_router(actor, num_workers=0, params=None, device="cpu")
