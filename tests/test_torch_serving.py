"""The port's serving stack against its own sequential rollouts and the JAX actor.

Every policy step of the port's ``PolicyService`` runs at ``max_batch``
rows, each row computed as a one-row problem of its own
(``rowwise_policy_step_fn``), so a session's actions must be BITWISE equal
to a rollout of that session alone in row 0 of such a step
(``padded_rollout``), whichever requests shared its batches and wherever
it sat: the contract of docs/SERVING.md,
held here on the CPU (and on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``).  The same actions agree with the JAX ``actor.apply``
one-row rollout from the same (converted) params within 1e-5 absolute.
The nets have ``action_dim`` 3, as in the JAX serving tests.

Also the units (session store, batcher), the admission
codes (queue and session sheds, bad shapes, shutdown), the poison-batch
recovery, the health counts, a mid-stream hot reload from the port's own
checkpoints, and a wrong-net checkpoint rejected while serving goes on.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.models import ActorNet as JActorNet
from r2d2dpg_torch.convert import net_params_from_flax
from r2d2dpg_torch.models import ActorNet
from r2d2dpg_torch.obs import get_flight_recorder
from r2d2dpg_torch.serving import (
    BAD_REQUEST,
    INTERNAL_ERROR,
    CheckpointHotReloader,
    MicroBatcher,
    PolicyService,
    Request,
    SessionStore,
    actor_params_template,
)
from r2d2dpg_torch.serving.service import expand_rows, rowwise_policy_step_fn
from r2d2dpg_torch.utils.checkpoint import CheckpointManager
from r2d2dpg_torch.utils.codes import OK, SHED_QUEUE, SHED_SESSIONS, SHUTDOWN

OBS = (5,)
ACT = 3
HIDDEN = 32


def make_actor(use_lstm=True, hidden=HIDDEN):
    return ActorNet(OBS, ACT, hidden=hidden, use_lstm=use_lstm)


def init_params(actor, seed=1):
    return actor.init_params(torch.Generator().manual_seed(seed), "cpu")


def make_service(actor=None, params=None, **kw):
    actor = actor or make_actor()
    params = params if params is not None else init_params(actor)
    kw.setdefault("obs_shape", OBS)
    kw.setdefault("max_sessions", 8)
    kw.setdefault("max_batch", 8)
    kw.setdefault("flush_ms", 1.0)
    kw.setdefault("device", "cpu")
    return PolicyService(actor, params, **kw)


def padded_rollout(actor, params_seq, obs_seq, rows):
    """One session alone in row 0 of ``rows``-row policy steps (the other
    rows: zero obs, reset 1), params ``params_seq[t]`` at step t."""
    step = rowwise_policy_step_fn(actor)
    carry = actor.initial_carry(rows, "cpu")
    out = []
    for t in range(len(obs_seq)):
        obs = torch.zeros((rows,) + OBS)
        obs[0] = torch.from_numpy(obs_seq[t])
        reset = torch.ones(rows)
        reset[0] = 1.0 if t == 0 else 0.0
        action, carry = step(expand_rows(params_seq[t], rows), obs, carry, reset)
        out.append(action[0].numpy())
    return out


def drive(service, obs, steps):
    """Every session's step t submitted together, for t in range(steps)."""
    got = {s: [] for s in obs}
    for t in range(steps):
        pending = [(s, service.act_async(s, obs[s][t], reset=(t == 0))) for s in obs]
        for s, req in pending:
            assert req.wait(30.0), "request dropped"
            assert req.code == OK, req.code
            got[s].append((req.params_step, req.action))
    return got


# --------------------------------------------------------------------- units
def test_batcher_launches_a_full_batch_before_the_deadline():
    """A full batch leaves at once (a 60 s flush deadline is never waited
    for); requests past ``max_batch`` stay queued for the next batch."""
    b = MicroBatcher(2, max_queue=16, flush_ms=60_000.0)
    reqs = [Request(s, np.zeros(OBS), False, time.monotonic()) for s in "abc"]
    for r in reqs:
        assert b.submit(r)
    t0 = time.monotonic()
    assert b.next_batch(poll_s=0.0) == reqs[:2]
    assert time.monotonic() - t0 < 30.0
    assert b.depth == 1 and b.drain() == reqs[2:]
    with pytest.raises(ValueError):
        MicroBatcher(0)


def test_session_store_alloc_touch_ttl_evict_clear():
    t = [0.0]
    store = SessionStore(2, make_actor().initial_carry, ttl_s=10.0, clock=lambda: t[0])
    assert store.acquire("a") == (0, True)
    assert store.acquire("b") == (1, True)
    assert store.acquire("a") == (0, False)
    assert store.acquire("c") is None  # full, nobody expired
    t[0] = 5.0
    store.acquire("a")  # touch a at 5
    t[0] = 12.0  # b idle 12 s > ttl, a idle 7 s
    assert store.acquire("c") == (1, True)
    assert store.evictions == 1 and store.active == 2
    assert store.release("c") and not store.release("c")
    assert store.clear() == 1 and store.active == 0
    slabs = store.init_slabs("cpu")
    assert [tuple(x.shape) for x in slabs.carries] == [(3, HIDDEN), (3, HIDDEN)]
    assert store.scratch_slot == 2


def test_batcher_bounded_queue_and_one_request_per_session():
    b = MicroBatcher(2, max_queue=2, flush_ms=0.0)
    mk = lambda s: Request(s, np.zeros(OBS), False, time.monotonic())  # noqa: E731
    assert b.submit(mk("a")) and b.submit(mk("b"))
    assert not b.submit(mk("c"))
    assert b.shed_queue_full == 1 and b.depth == 2
    b = MicroBatcher(4, max_queue=16, flush_ms=0.0)
    r1, r2, r3 = mk("s"), mk("s"), mk("t")
    for r in (r1, r2, r3):
        assert b.submit(r)
    first = b.next_batch(poll_s=0.0)
    assert [r.session_id for r in first] == ["s", "t"] and first[0] is r1
    assert b.next_batch(poll_s=0.0) == [r2]


# ------------------------------------------------------------------ service
def test_interleaved_sessions_bitwise_equal_sequential_and_near_jax():
    """4 sessions x 6 steps, batches of 1-4 real rows (padded to 8), against
    each session alone (bitwise) and the JAX one-row rollout (1e-5)."""
    jactor = JActorNet(action_dim=ACT, hidden=HIDDEN, use_lstm=True)
    jparams = jactor.init(
        jax.random.PRNGKey(1), jnp.zeros((1,) + OBS), jactor.initial_carry(1),
        jnp.zeros((1,)),
    )
    actor = make_actor()
    params = net_params_from_flax(jax.device_get(jparams), "cpu")
    rng = np.random.default_rng(0)
    obs = {s: rng.standard_normal((6,) + OBS).astype(np.float32) for s in "abcd"}
    with make_service(actor, params) as svc:
        # Ragged batches: session "d" joins late, "c" skips step 2.
        got = {s: [] for s in obs}
        for t in range(6):
            live = [s for s in obs
                    if not (s == "c" and t == 2) and not (s == "d" and t < 2)]
            pending = [(s, svc.act_async(s, obs[s][len(got[s])],
                                         reset=(len(got[s]) == 0))) for s in live]
            for s, req in pending:
                assert req.wait(30.0) and req.code == OK
                got[s].append(req.action)
    jstep = jax.jit(jactor.apply)
    for s in obs:
        n = len(got[s])
        want = padded_rollout(actor, [params] * n, obs[s][:n], rows=8)
        for t in range(n):
            np.testing.assert_array_equal(got[s][t], want[t])
        carry = jactor.initial_carry(1)
        for t in range(n):
            a, carry = jstep(jparams, obs[s][t][None], carry,
                             jnp.asarray([1.0 if t == 0 else 0.0]))
            np.testing.assert_allclose(got[s][t], np.asarray(a[0]), rtol=0, atol=1e-5)


def test_padding_and_row_position_never_change_a_row():
    """The same inputs in row 0 alone, or in any row among random rows, give
    bitwise the same action and carry at the step's row count (8 rows and a
    3-wide head: the shape at which the CPU's plain 2-D product computes
    odd rows apart from even ones)."""
    actor = make_actor()
    step = rowwise_policy_step_fn(actor)
    params = expand_rows(init_params(actor), 8)
    g = torch.Generator().manual_seed(3)
    obs = torch.randn(8, *OBS, generator=g)
    carry = tuple(torch.randn(8, HIDDEN, generator=g) for _ in range(2))
    reset = (torch.rand(8, generator=g) < 0.3).float()
    a_all, c_all = step(params, obs, carry, reset)
    perm = torch.randperm(8, generator=g)
    a_perm, c_perm = step(params, obs[perm], tuple(c[perm] for c in carry), reset[perm])
    assert torch.equal(a_perm, a_all[perm])
    assert all(torch.equal(x, y[perm]) for x, y in zip(c_perm, c_all))
    alone = torch.zeros(8, *OBS)
    alone[0] = obs[5]
    zc = tuple(torch.zeros(8, HIDDEN) for _ in range(2))
    for z, c in zip(zc, carry):
        z[0] = c[5]
    r = torch.ones(8)
    r[0] = reset[5]
    a_alone, _ = step(params, alone, zc, r)
    assert torch.equal(a_alone[0], a_all[5])


def test_feedforward_actor_serves_too():
    actor = make_actor(use_lstm=False)
    params = init_params(actor)
    obs = np.ones(OBS, np.float32)
    with make_service(actor, params) as svc:
        res = svc.act("x", obs)
    assert res.code == OK
    want = padded_rollout(actor, [params], obs[None], rows=8)[0]
    np.testing.assert_array_equal(res.action, want)


def test_admission_codes():
    with make_service(max_queue=0) as svc:
        res = svc.act("a", np.zeros(OBS, np.float32))
    assert res.code == SHED_QUEUE and res.action is None
    assert svc.health().requests_shed == 1
    with make_service(max_sessions=1, session_ttl_s=1e9) as svc:
        r1 = svc.act("a", np.zeros(OBS, np.float32))
        r2 = svc.act("b", np.zeros(OBS, np.float32))
        bad = svc.act("a", np.zeros((7,), np.float32))
        h = svc.health()
    assert (r1.code, r2.code, bad.code) == (OK, SHED_SESSIONS, BAD_REQUEST)
    assert h.requests_shed == 1
    svc = make_service()
    svc.start(warmup=False)
    svc.stop()
    assert svc.act("a", np.zeros(OBS, np.float32)).code == SHUTDOWN


def test_same_session_pipelined_requests_stay_ordered():
    actor = make_actor()
    params = init_params(actor)
    obs = np.random.default_rng(1).standard_normal((4,) + OBS).astype(np.float32)
    with make_service(actor, params, flush_ms=5.0) as svc:
        reqs = [svc.act_async("s", obs[t], reset=(t == 0)) for t in range(4)]
        for r in reqs:
            assert r.wait(30.0) and r.code == OK
    want = padded_rollout(actor, [params] * 4, obs, rows=8)
    for t in range(4):
        np.testing.assert_array_equal(reqs[t].action, want[t])


def test_health_snapshot_counts_and_occupancy():
    with make_service(params_step=42) as svc:
        pending = [svc.act_async(f"s{i}", np.zeros(OBS, np.float32), reset=True)
                   for i in range(6)]
        for r in pending:
            assert r.wait(30.0) and r.code == OK
        h = svc.health()
    assert h.requests_ok == 6 and h.params_step == 42 and h.sessions_active == 6
    assert 0.0 < h.batch_occupancy <= 1.0
    assert h.latency_p99_ms >= h.latency_p50_ms >= 0.0
    scalars = h.as_scalars()
    assert "last_reload_error" not in scalars
    assert all(isinstance(v, float) for v in scalars.values())


def test_worker_survives_a_poison_batch():
    svc = make_service(max_batch=2, flush_ms=50.0)
    real_step = svc.policy_step

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    with svc:
        svc.policy_step = boom
        poisoned = [svc.act_async(s, np.zeros(OBS, np.float32), reset=True)
                    for s in "ab"]
        for r in poisoned:
            assert r.wait(30.0)
            assert r.code == INTERNAL_ERROR and r.action is None
        assert svc.sessions.active == 0  # slabs rebuilt, sessions dropped
        svc.policy_step = real_step
        ok = svc.act("a", np.zeros(OBS, np.float32), reset=True)
        h = svc.health()
    assert ok.code == OK
    assert h.worker_errors == 1 and "RuntimeError" in h.last_worker_error
    assert h.requests_ok == 1


def test_housekeeping_failure_keeps_sessions():
    class BoomLogger:
        def log(self, step, scalars):
            raise OSError("disk full")

    actor = make_actor()
    params = init_params(actor)
    obs = np.random.default_rng(3).standard_normal((3,) + OBS).astype(np.float32)
    svc = make_service(actor, params, logger=BoomLogger(), log_every_s=0.0)
    with svc:
        got = [svc.act("a", obs[t], reset=(t == 0)).action for t in range(3)]
        h = svc.health()
    assert h.worker_errors > 0 and "OSError" in h.last_worker_error
    assert h.sessions_active == 1
    want = padded_rollout(actor, [params] * 3, obs, rows=8)
    for t in range(3):
        np.testing.assert_array_equal(got[t], want[t])


def test_many_threads_are_accounted():
    results = []
    lock = threading.Lock()
    with make_service(max_queue=8, max_batch=4) as svc:

        def client(i):
            res = svc.act(f"s{i % 8}", np.zeros(OBS, np.float32), timeout=30.0)
            with lock:
                results.append(res.code)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)
            assert not th.is_alive()
        h = svc.health()
    assert len(results) == 32 and set(results) <= {OK, SHED_QUEUE}
    assert h.requests_ok == results.count(OK)
    assert h.requests_shed == results.count(SHED_QUEUE)


# ------------------------------------------------------- hot reload (disk)
def _save(mgr, step, params):
    mgr.save(step, types.SimpleNamespace(train={"actor_params": params}))


def test_midstream_hot_reload_from_port_checkpoints(tmp_path):
    """4 sessions x 10 steps; step 2 is checkpointed at t = 4 and must be
    served from t = 5 on, every session kept, bitwise against each
    session's rollout under the params schedule it observed."""
    actor = make_actor()
    params_by_step = {1: init_params(actor, 1), 2: init_params(actor, 2)}
    mgr = CheckpointManager(str(tmp_path / "hot"), save_every=1, light=True)
    _save(mgr, 1, params_by_step[1])
    reloader = CheckpointHotReloader(
        mgr.directory, actor_params_template(actor), poll_every_s=0.0)
    rng = np.random.default_rng(7)
    obs = {f"client-{i}": rng.standard_normal((10,) + OBS).astype(np.float32)
           for i in range(4)}
    served = {s: [] for s in obs}
    svc = make_service(actor, None, max_batch=4, flush_ms=2.0,
                       reloader=reloader)
    with svc:
        for t in range(10):
            if t == 4:
                _save(mgr, 2, params_by_step[2])
            step_t = drive_one(svc, obs, t)
            for s in obs:
                served[s].append(step_t[s])
        h = svc.health()
    assert h.params_step == 2 and h.sessions_active == 4 and h.last_reload_error is None
    assert any(e["kind"] == "hot_reload" and e["params_step"] == 2
               for e in get_flight_recorder().events())
    for s in obs:
        steps = [ps for ps, _ in served[s]]
        assert steps[:4] == [1, 1, 1, 1] and steps[5] == 2
        assert steps == sorted(steps)
        want = padded_rollout(actor, [params_by_step[ps] for ps in steps], obs[s], rows=4)
        for t in range(10):
            np.testing.assert_array_equal(served[s][t][1], want[t])


def drive_one(service, obs, t):
    out = {}
    pending = [(s, service.act_async(s, obs[s][t], reset=(t == 0))) for s in obs]
    for s, req in pending:
        assert req.wait(30.0) and req.code == OK, req.code
        out[s] = (req.params_step, req.action)
    return out


def test_wrong_net_checkpoint_is_rejected_and_serving_goes_on(tmp_path):
    actor = make_actor()
    params = init_params(actor)
    mgr = CheckpointManager(str(tmp_path / "ck"), save_every=1, light=True)
    _save(mgr, 1, params)
    wide = make_actor(hidden=2 * HIDDEN)
    with pytest.raises(ValueError, match="mismatched") as e:
        CheckpointHotReloader(mgr.directory, actor_params_template(wide)).load_latest()
    assert "actor_params/core.cell.wi" in str(e.value)
    reloader = CheckpointHotReloader(
        mgr.directory, actor_params_template(actor), poll_every_s=0.0)
    with make_service(actor, None, reloader=reloader) as svc:
        assert svc.act("a", np.zeros(OBS, np.float32), reset=True).code == OK
        _save(mgr, 2, init_params(wide))  # a checkpoint of another net lands
        # The worker polls between batches: the second act follows a poll.
        for _ in range(2):
            res = svc.act("a", np.zeros(OBS, np.float32))
        h = svc.health()
    assert res.code == OK and res.params_step == 1
    assert h.params_step == 1 and "mismatched" in h.last_reload_error
