"""Port parity: the autoscaler and the supervisor's runtime resize API.

``r2d2dpg_torch/fleet/supervisor.py`` (``retire_slot``, ``set_target``,
``slot_states``, ``restart="policy"``) and ``r2d2dpg_torch/fleet/
autoscaler.py`` against the JAX package's, exactly: each case runs one
script on both packages side by side and asserts equal results.

- **Supervisor**: the fake-clock cases of ``tests/test_autoscaler.py``
  (``_poll_once`` driven directly, worker processes replaced by a
  poll()-able stand-in): both supervisors give equal ``slot_states()``
  after every step, equal return values and equal flight-event sequences
  (kinds and fields, timestamps dropped).
- **Hysteresis**: each case drives the JAX ``Autoscaler`` and the port's
  with one scripted fake health engine, one scripted fake supervisor each
  and one injected clock; the landed actions, the calls into the
  supervisor, the gates and the decision events are equal.
- **Kill drill** (the port alone, modelled on the JAX drill): a live
  2-actor pendulum_tiny fleet under ``kill_actor@p3`` with the supervisor
  in policy mode; the autoscaler restores the population with
  ``restarts_total == 0`` and no shed.
"""

import sys
import threading
import time

import pytest

import r2d2dpg_torch.fleet as pfleet
import r2d2dpg_torch.obs as pobs
import r2d2dpg_tpu.fleet as jfleet
import r2d2dpg_tpu.obs as jobs
from r2d2dpg_torch.utils.codes import TERMINAL_ACTOR_EXITS

pytestmark = pytest.mark.autoscale

PKGS = {"jax": (jfleet, jobs), "torch": (pfleet, pobs)}
_DROP = ("t_wall", "t_mono", "thread", "pid", "seq")


@pytest.fixture(autouse=True)
def _no_flight_identity(monkeypatch):
    """Both recorders without identity fields for the test: an earlier test
    in the process may have stamped one (``set_flight_identity``) onto
    every later event of one package's recorder."""
    for _, obs in PKGS.values():
        monkeypatch.setattr(obs.get_flight_recorder(), "_identity", {})


class _FakeProc:
    """poll()-able stand-in for a worker process; SIGUSR1, terminate and
    kill are recorded, and a script sets ``returncode`` to end it."""

    def __init__(self, returncode=None):
        self.returncode = returncode
        self.signals = []
        self.terminated = False
        self.killed = False

    def poll(self):
        return self.returncode

    def send_signal(self, sig):
        self.signals.append(int(sig))

    def terminate(self):
        self.terminated = True

    def kill(self):
        self.killed = True
        self.returncode = -9


def _events_since(obs, seq0):
    """The flight events after sequence number ``seq0``, without their
    timestamps and process identity."""
    return [{k: v for k, v in e.items() if k not in _DROP}
            for e in obs.get_flight_recorder().events() if e["seq"] > seq0]


def _last_seq(obs):
    events = obs.get_flight_recorder().events()
    return events[-1]["seq"] if events else -1


def _fake_clock_supervisor(fleet, num_actors=1, **cfg):
    sup = fleet.ActorSupervisor(lambda i: ["unused"], num_actors,
                                config=fleet.SupervisorConfig(**cfg),
                                clock=lambda: 0.0)
    spawned = []

    def fake_spawn(actor_id):
        slot = sup._slots[actor_id]
        slot.proc = _FakeProc()
        slot.restart_at = None
        spawned.append(actor_id)

    sup._spawn = fake_spawn
    for i in range(num_actors):
        sup._spawn(i)  # slots start live, no monitor thread
    spawned.clear()
    return sup, spawned


# --------------------------------------------------------- supervisor scripts
# Each script drives one supervisor and returns its observations; ``obs``
# appends (step, return value, slot_states()) after each step.
def _retire_drains(sup, spawned, obs):
    proc = sup._slots[0].proc
    obs("retire", sup.retire_slot(0, origin="autoscale"))
    obs("signals", list(proc.signals))
    proc.returncode = 0  # finished its phase, sent BYE, exited
    sup._poll_once(1.0)
    obs("reaped", sup._slots[0].proc is None)
    sup._poll_once(100.0)  # and stays drained: no late respawn
    obs("spawned", list(spawned), sup.restarts_total)


def _retire_escalates(sup, spawned, obs):
    slot = sup._slots[0]
    proc = slot.proc
    obs("retire", sup.retire_slot(0), slot.retire_at)
    for t in (9.9, 10.0, 19.9, 20.0, 20.1):
        sup._poll_once(t)
        obs(t, proc.terminated, proc.killed, slot.proc is None)
    obs("restarts", sup.restarts_total)


def _retire_noops(sup, spawned, obs):
    obs("retire", sup.retire_slot(0))
    obs("again", sup.retire_slot(0))
    obs("absent", sup.retire_slot(7))
    sup._slots[0].retired = False
    sup._slots[0].gave_up = True
    obs("gave_up", sup.retire_slot(0))


def _spawn_mid_backoff(sup, spawned, obs):
    slot = sup._slots[0]
    obs("live", sup.spawn_slot(0))
    slot.proc.returncode = 1
    sup._poll_once(100.0)
    obs("armed", slot.restart_at)
    obs("mid_backoff", sup.spawn_slot(0), list(spawned))
    sup._poll_once(100.5)
    obs("ladder", list(spawned), sup.restarts_total)
    obs("new_live", sup.spawn_slot(0), list(spawned))


def _policy_corpse(sup, spawned, obs):
    slot = sup._slots[0]
    slot.proc.returncode = 1
    sup._poll_once(100.0)
    obs("down", slot.proc is None, slot.restart_at)
    sup._poll_once(200.0)
    obs("stays_down", list(spawned))
    obs("spawn", sup.spawn_slot(0, origin="autoscale"), list(spawned),
        sup.restarts_total)


def _policy_terminal(sup, spawned, obs):
    sup._slots[0].proc.returncode = sorted(TERMINAL_ACTOR_EXITS)[0]
    sup._poll_once(100.0)
    obs("gave_up", sup._slots[0].gave_up)


def _resurrect_explicitly(sup, spawned, obs):
    sup._slots[0].gave_up = True
    sup._slots[0].proc = None
    obs("capped", sup.set_target(2, lane_limit=2), sup._slots[0].gave_up)
    obs("uncapped", sup.set_target(2), sup._slots[0].gave_up)
    obs("explicit", sup.spawn_slot(0, origin="autoscale"), sup._slots[0].gave_up)


def _set_target_walk(sup, spawned, obs):
    obs("target", sup.target)
    obs("down", sup.set_target(2), sup.target)
    obs("up_while_draining", sup.set_target(3), list(spawned))
    sup._slots[2].proc.returncode = 0
    sup._poll_once(50.0)
    obs("up_after_reap", sup.set_target(4))


SUPERVISOR_CASES = {
    "retire_drains_without_churn": (_retire_drains, {"backoff_base_s": 0.5}, 1),
    "retire_escalates_term_then_kill": (_retire_escalates, {"retire_grace_s": 10.0}, 1),
    "retire_noops": (_retire_noops, {}, 1),
    "spawn_noops_mid_backoff": (_spawn_mid_backoff, {"backoff_base_s": 0.5}, 1),
    "policy_mode_corpse": (_policy_corpse, {"restart": "policy"}, 1),
    "policy_mode_terminal_gives_up": (_policy_terminal, {"restart": "policy"}, 1),
    "explicit_resurrection": (_resurrect_explicitly, {}, 2),
    "set_target_highest_and_lowest_free": (_set_target_walk, {}, 3),
}


def _run_supervisor_case(pkg, name):
    fleet, obs = PKGS[pkg]
    script, cfg, n = SUPERVISOR_CASES[name]
    sup, spawned = _fake_clock_supervisor(fleet, n, **cfg)
    seq0 = _last_seq(obs)
    out = []

    def record(step, *values):
        out.append((step, values, sup.slot_states()))

    script(sup, spawned, record)
    return out, _events_since(obs, seq0)


@pytest.mark.parametrize("name", sorted(SUPERVISOR_CASES))
def test_supervisor_resize_equals_jax(name):
    port, port_events = _run_supervisor_case("torch", name)
    ref, ref_events = _run_supervisor_case("jax", name)
    assert port == ref
    assert port_events == ref_events
    kinds = [e["kind"] for e in port_events]
    # The contracts the JAX tests pin, read off the shared trace.
    if name == "retire_drains_without_churn":
        assert "actor_drained" in kinds and "actor_crash" not in kinds
        assert "actor_restart" not in kinds and port[-1][1] == ([], 0)
    if name == "retire_escalates_term_then_kill":
        assert [o[1] for o in port[1:5]] == [(False, False, False), (True, False, False),
                                            (True, False, False), (True, True, False)]
        assert port[5][1] == (True, True, True) and port[-1][1] == (0,)
    if name == "policy_mode_corpse":
        assert port[0][2] == {0: "down"} and port[-1][1] == (True, [0], 0)
    if name == "policy_mode_terminal_gives_up":
        assert port[-1][2] == {0: "gave_up"}
    if name == "set_target_highest_and_lowest_free":
        assert port[1][1][0] == {"spawned": [], "retiring": [2]}
        assert port[2][1][0] == {"spawned": [3], "retiring": []}
        assert port[3][1][0] == {"spawned": [2], "retiring": []}


# ------------------------------------------------------- policy-engine fakes
def _finding(rule, detail=""):
    return {"rule": rule, "severity": "degraded", "detail": detail,
            "value": 1.0, "threshold": 0.0}


class _FakeEngine:
    """Each evaluate() pops the next findings list; the last repeats."""

    def __init__(self, *script):
        self.script = list(script)
        self.evaluations = 0

    def evaluate(self):
        self.evaluations += 1
        findings = (self.script.pop(0) if len(self.script) > 1
                    else (self.script[0] if self.script else []))
        return {"verdict": "ok", "findings": list(findings), "t_wall": 0.0}


class _FakeSup:
    """The resize API surface the policy engine actuates; ``spawn_ok =
    False`` makes every landing fail (the pending-until-landed path)."""

    def __init__(self, states=None, target=2):
        self.states = dict(states if states is not None else {0: "live", 1: "live"})
        self._target = target
        self.calls = []
        self.spawn_ok = True

    @property
    def target(self):
        return self._target

    def slot_states(self):
        return dict(self.states)

    def spawn_slot(self, i, *, origin="resize"):
        self.calls.append(("spawn_slot", i))
        if not self.spawn_ok:
            return False
        self.states[i] = "live"
        return True

    def retire_slot(self, i, *, origin="resize"):
        self.calls.append(("retire_slot", i))
        self.states[i] = "retired"
        return True

    def kill_actor(self, i):
        self.calls.append(("kill_actor", i))
        self.states[i] = "down"
        return True

    def set_target(self, n, *, lane_limit=None):
        self.calls.append(("set_target", n))
        spawned, retiring = [], []
        active = sorted(i for i, s in self.states.items() if s in ("live", "down"))
        while len(active) > n:
            retiring.append(active.pop())
            self.states[retiring[-1]] = "retired"
        while len(active) < n:
            lane = 0
            while lane in active or self.states.get(lane) in ("retired", "gave_up"):
                lane += 1
            if lane_limit is not None and lane >= lane_limit or not self.spawn_ok:
                break
            self.states[lane] = "live"
            active.append(lane)
            spawned.append(lane)
        self._target = n
        return {"spawned": spawned, "retiring": retiring}


class _Tier:
    def __init__(self, states):
        self.supervisor = _FakeSup(states)


DOWN = [_finding("actors_down")]
STARVING = [_finding("learner_starving")]
CHURN = [_finding("eviction_churn")]

# name -> (engine script, supervisor states, target, config, ticks, extras).
# A tick is a time, or (time, action) where action(sup, ready, tier) runs
# before that tick.
HYSTERESIS_CASES = {
    "fire_threshold_needs_consecutive": (
        [DOWN], {0: "down", 1: "live"}, 2, {"fire_threshold": 3}, [0.0, 1.0, 2.0], {}),
    "streak_resets_on_clean_evaluation": (
        [DOWN, DOWN, [], DOWN, DOWN, DOWN], {0: "down", 1: "live"}, 2,
        {"fire_threshold": 3}, [0.0, 1.0, 2.0, 3.0, 4.0, 5.0], {}),
    "flapping_threshold_1_one_action_per_cooldown": (
        [STARVING, [], STARVING, [], STARVING, []], {0: "live", 1: "live"}, 2,
        {"fire_threshold": 1, "cooldown_s": 30.0}, [0.0, 1.0, 2.0, 3.0, 4.0, 5.0], {}),
    "flapping_default_threshold_inert": (
        [STARVING, [], STARVING, [], STARVING, []], {0: "live", 1: "live"}, 2,
        {"fire_threshold": 3}, [0.0, 1.0, 2.0, 3.0, 4.0, 5.0], {}),
    "cooldown_blocks_until_window_elapses": (
        [DOWN], {0: "down", 1: "down"}, 2, {"fire_threshold": 1, "cooldown_s": 30.0},
        [0.0, 10.0, 29.9, 30.0], {}),
    "actions_per_window_budget": (
        [DOWN], {i: "down" for i in range(4)}, 2,
        {"fire_threshold": 1, "cooldown_s": 10.0, "window_s": 300.0,
         "max_actions_per_window": 2}, [0.0, 10.0, 20.0, 100.0, 300.0], {}),
    "warmup_gates_load_scaling": (
        [STARVING], {0: "live", 1: "live"}, 2, {"fire_threshold": 1},
        [0.0, (1.0, lambda sup, ready, tier: ready.__setitem__(0, True))],
        {"ready": False}),
    "warmup_exempts_replacement": (
        [DOWN], {0: "down", 1: "live"}, 2, {"fire_threshold": 1}, [0.0],
        {"ready": False}),
    "scale_up_at_ceiling_noop": (
        [STARVING], {0: "live", 1: "live"}, 2, {"fire_threshold": 1, "max_actors": 2},
        [0.0], {}),
    "scale_down_at_floor_noop": (
        [CHURN], {0: "live"}, 1, {"fire_threshold": 1, "min_actors": 1}, [0.0], {}),
    "scale_up_in_bounds": (
        [STARVING], {0: "live", 1: "live"}, 2, {"fire_threshold": 1, "max_actors": 4},
        [0.0], {}),
    "scale_down_in_bounds": (
        [CHURN], {0: "live", 1: "live"}, 2, {"fire_threshold": 1, "min_actors": 1},
        [0.0], {}),
    "starving_with_stale_actor_replaces": (
        [[_finding("learner_starving"),
          _finding("telem_stale", detail="actor 1 TELEM stale — wedged")]],
        {0: "live", 1: "live"}, 2, {"fire_threshold": 1}, [0.0, 1.0], {}),
    "pending_until_landed_never_double_spawns": (
        [DOWN], {0: "down", 1: "live"}, 2, {"fire_threshold": 1},
        [(0.0, lambda sup, ready, tier: setattr(sup, "spawn_ok", False)), 1.0,
         (2.0, lambda sup, ready, tier: setattr(sup, "spawn_ok", True))], {}),
    "pending_superseded_by_ladder_recovery": (
        [DOWN], {0: "down", 1: "live"}, 2, {"fire_threshold": 1},
        [(0.0, lambda sup, ready, tier: setattr(sup, "spawn_ok", False)),
         (1.0, lambda sup, ready, tier: sup.states.__setitem__(0, "live"))], {}),
    "dry_run_never_actuates": (
        [DOWN], {0: "down", 1: "live"}, 2, {"fire_threshold": 1, "dry_run": True},
        [0.0, 1.0], {}),
    "shards_down_respawns_through_tier": (
        [[_finding("shards_down")]], {0: "live", 1: "live"}, 2,
        {"fire_threshold": 1, "max_actors": 4}, [0.0], {"tier": {0: "gave_up"}}),
}


def _run_hysteresis_case(pkg, name):
    fleet, obs = PKGS[pkg]
    script, states, target, cfg, ticks, extras = HYSTERESIS_CASES[name]
    cfg = {"min_actors": 1, "max_actors": 4, "fire_threshold": 3,
           "cooldown_s": 30.0, "eval_every_s": 1.0, **cfg}
    eng = _FakeEngine(*script)
    sup = _FakeSup(states, target=target)
    tier = _Tier(extras["tier"]) if "tier" in extras else None
    ready = [extras.get("ready", True)]
    scaler = fleet.Autoscaler(
        eng, sup, shard_tier=tier, config=fleet.AutoscaleConfig(**cfg),
        clock=lambda: 0.0,
        ready_fn=(lambda: ready[0]) if "ready" in extras else None)
    seq0 = _last_seq(obs)
    landed = []
    for tick in ticks:
        t, act = tick if isinstance(tick, tuple) else (tick, None)
        if act is not None:
            act(sup, ready, tier)
        a = scaler.tick(t)
        landed.append(None if a is None else (a.kind, a.slot, a.rule, a.goal))
    stats = scaler.stats()
    events = [e for e in _events_since(obs, seq0) if e["kind"].startswith("autoscale_")]
    return {
        "landed": landed,
        "calls": sup.calls,
        "tier_calls": tier.supervisor.calls if tier is not None else None,
        "gates": [e.get("gated_by") for e in events if e["kind"] == "autoscale_decision"],
        "events": events,
        "evaluations": eng.evaluations,
        "stats": stats,
    }


@pytest.mark.parametrize("name", sorted(HYSTERESIS_CASES))
def test_autoscaler_hysteresis_equals_jax(name):
    port, ref = _run_hysteresis_case("torch", name), _run_hysteresis_case("jax", name)
    assert port == ref
    landed = port["landed"]
    # The contracts the JAX tests pin, read off the shared trace.
    if name == "fire_threshold_needs_consecutive":
        assert landed == [None, None, ("spawn_actor", 0, "actors_down", None)]
    if name == "streak_resets_on_clean_evaluation":
        assert landed[:5] == [None] * 5 and landed[5] is not None
    if name == "flapping_threshold_1_one_action_per_cooldown":
        assert sum(x is not None for x in landed) <= 1
    if name == "flapping_default_threshold_inert":
        assert landed == [None] * 6 and port["calls"] == []
    if name == "cooldown_blocks_until_window_elapses":
        assert [x is not None for x in landed] == [True, False, False, True]
    if name == "actions_per_window_budget":
        assert [x is not None for x in landed] == [True, True, False, False, True]
    if name == "warmup_gates_load_scaling":
        # Not decided at all while warming up; decided and fired once steady.
        assert landed[0] is None and landed[1] is not None and port["gates"] == [None]
    if name == "starving_with_stale_actor_replaces":
        assert landed == [None, ("replace_actor", 1, "telem_stale", None)]
        assert port["calls"] == [("kill_actor", 1), ("spawn_slot", 1)]
    if name == "pending_until_landed_never_double_spawns":
        assert port["calls"] == [("spawn_slot", 0)] * 3 and port["evaluations"] == 1
        assert [e["kind"] for e in port["events"]].count("autoscale_action") == 1
    if name == "pending_superseded_by_ladder_recovery":
        assert "superseded" in port["gates"] and landed == [None, None]
        assert all(e["kind"] != "autoscale_action" for e in port["events"])
    if name == "dry_run_never_actuates":
        assert port["calls"] == [] and port["stats"]["autoscale_dry_run_decisions"] == 1
    if name == "shards_down_respawns_through_tier":
        assert landed[0][0] == "respawn_shard_proc" and port["tier_calls"] == [
            ("spawn_slot", 0)]


def test_autoscaler_instruments_equal_jax():
    """The three instruments, by name, kind and labels, after one landed
    spawn on each package's registry."""
    snaps = {}
    for pkg in ("jax", "torch"):
        fleet, obs = PKGS[pkg]
        sup = _FakeSup({0: "down", 1: "live"})
        scaler = fleet.Autoscaler(_FakeEngine(DOWN), sup,
                                  config=fleet.AutoscaleConfig(fire_threshold=1),
                                  clock=lambda: 5.0)
        before = obs.get_registry().snapshot().get(
            "r2d2dpg_autoscale_actions_total", {"samples": []})
        count0 = sum(s["value"] for s in before["samples"]
                     if s["labels"] == {"action": "spawn_actor"})
        scaler.tick(5.0)
        snap = obs.get_registry().snapshot()
        snaps[pkg] = {
            name: (snap[name]["kind"], [s["labels"] for s in snap[name]["samples"]])
            for name in ("r2d2dpg_autoscale_actions_total",
                         "r2d2dpg_autoscale_target_actors",
                         "r2d2dpg_autoscale_last_decision_age_seconds")}
        moved = sum(s["value"] for s in snap["r2d2dpg_autoscale_actions_total"]["samples"]
                    if s["labels"] == {"action": "spawn_actor"}) - count0
        assert moved == 1, pkg
        assert snap["r2d2dpg_autoscale_target_actors"]["samples"][0]["value"] == 2
    assert snaps["torch"] == snaps["jax"]


# ------------------------------------------------------------ kill drill
def test_autoscale_kill_drill_restores_population():
    """A live 2-actor pendulum_tiny fleet (thread actors carry the
    experience; the supervised slots are sleeper processes), ``kill_actor
    @p3``, the supervisor in policy mode: the autoscaler, not the backoff
    ladder, restores the population (an ``autoscale_action`` spawn on the
    killed slot, ``origin="autoscale"``), ``restarts_total`` stays 0, env
    steps never go down and nothing is shed."""
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.fleet import (
        ActorSupervisor,
        AutoscaleConfig,
        Autoscaler,
        ChaosEngine,
        FleetActor,
        FleetConfig,
        FleetLearner,
        SupervisorConfig,
        parse_chaos_spec,
    )

    seed, num_actors = 0, 2
    trainer = PENDULUM_TINY.build("cpu")
    # A deep queue and a patient shed deadline: nothing paces these thread
    # actors, and the drill's claim is that the recovery drops nothing.
    learner = FleetLearner(trainer, FleetConfig(
        num_actors=num_actors, queue_depth=32, idle_timeout_s=120, shed_after_s=30.0))
    address = learner.start()
    actors = [FleetActor(PENDULUM_TINY, actor_id=i, num_actors=num_actors,
                         address=address, seed=seed, device="cpu")
              for i in range(num_actors)]

    def actor_loop(a):
        try:
            a.run(max_phases=400)
        except Exception:  # noqa: BLE001 - the teardown cuts the socket
            pass

    threads = [threading.Thread(target=actor_loop, args=(a,), daemon=True)
               for a in actors]
    sup = ActorSupervisor(
        lambda i: [sys.executable, "-c", "import time; time.sleep(600)"],
        num_actors, config=SupervisorConfig(poll_s=0.05, restart="policy"))
    engine = ChaosEngine(parse_chaos_spec("kill_actor@p3"), seed=seed,
                         num_actors=num_actors, supervisor=sup, server=learner.server)
    # The experience carriers are threads with no TELEM cadence: a growing
    # staleness clock here is not a wedge (train derives this from
    # --obs-fleet).
    health = pobs.HealthEngine(
        pobs.HealthConfig(expected_actors=num_actors, telem_expected=False),
        registry=pobs.get_registry())
    scaler = Autoscaler(health, sup, config=AutoscaleConfig(
        min_actors=1, max_actors=num_actors, fire_threshold=2, cooldown_s=0.2,
        window_s=60.0, max_actions_per_window=4, eval_every_s=0.05))
    n_train, rows = 8, []
    seq0 = _last_seq(pobs)
    for t in threads:
        t.start()
    try:
        sup.start()
        scaler.start()
        state = learner.run(n_train, log_every=2,
                            metrics_fn=lambda p, s: rows.append((p, dict(s))),
                            phase_fn=engine.on_phase)
        # Hold the fleet up until the replacement lands.
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and (
                sup.alive_count() < num_actors
                or sum(scaler.stats()["autoscale_actions"].values()) < 1):
            time.sleep(0.05)
        alive_restored = sup.alive_count()
    finally:
        scaler.stop()
        sup.stop()
        learner.close()
        for t in threads:
            t.join(timeout=30)

    assert int(state.train.step) == n_train * trainer.config.learner_steps
    stats = learner.stats()
    assert stats["train_phases"] == n_train and stats["sheds"] == 0
    assert not engine.unfired()
    env_steps = [s["env_steps"] for _, s in rows]
    assert env_steps == sorted(env_steps) and env_steps[-1] > 0
    events = _events_since(pobs, seq0)
    kill_target = next(e["actor"] for e in events
                       if e["kind"] == "chaos_inject" and e["fault"] == "kill_actor")
    assert any(e["kind"] == "actor_crash" and e.get("actor") == kill_target
               for e in events)
    assert any(e["kind"] == "autoscale_action" and e["action"] == "spawn_actor"
               and e["slot"] == kill_target and e["rule"] == "actors_down"
               for e in events)
    assert any(e["kind"] == "actor_spawn" and e.get("actor") == kill_target
               and e.get("origin") == "autoscale" for e in events)
    assert not any(e["kind"] == "actor_restart" for e in events)
    assert sup.restarts_total == 0 and alive_restored == num_actors
