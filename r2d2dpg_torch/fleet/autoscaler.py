"""Autoscaler: the health -> actuation loop.

Port of ``r2d2dpg_tpu/fleet/autoscaler.py``.  A policy engine evaluates
the in-process ``HealthEngine`` (``obs/health.py``) on its own cadence and
maps findings to typed ``ScaleAction``s, actuated through the supervisor's
runtime resize API (``spawn_slot``/``retire_slot``/``set_target``) and the
shard tier's supervisor:

- ``actors_down``      -> ``spawn_actor`` on the dead slot (under
                          ``SupervisorConfig(restart="policy")`` the
                          ladder leaves the corpse for this decision).
- ``shards_down``      -> ``respawn_shard_proc`` (a backstop: the shard
                          tier keeps its ladder, so this stays pending
                          while backoff owns the respawn).
- ``telem_stale``      -> ``replace_actor``: kill the wedged peer, then
                          respawn its lane once the corpse is reaped.
- ``learner_starving`` with every actor fresh -> ``spawn_actor`` toward
                          ``--autoscale-max`` (Ape-X, 1803.00933).
- ``eviction_churn`` with a learner not starving -> ``kill_actor``
                          toward ``--autoscale-min``.

Every decision passes a hysteresis gate: per-rule consecutive-fire
thresholds, a cooldown between landed actions, a budget of actions per
window, and a warm-up gate for the load rules (they wait for the ingest
server's ``is_steady``; replacements act during warm-up too).  An action
on a slot that is mid-backoff or still draining stays pending for the next
tick instead of spawning twice.  New actors slot into the global sigma
ladder, whose width the train CLI fixes at ``max(--actors,
--autoscale-max)``; a landed resize moves ``r2d2dpg_fleet_actors_expected``
so ``actors_down`` judges against the current target.  Dry run walks the
same decision path but never actuates and emits no ``autoscale_action``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from r2d2dpg_torch.obs import flight_event, get_registry

# The rules this policy consumes (a subset of obs/health.py RULES —
# recompile_churn/hbm_pressure/shard_skew are diagnoses, not population
# problems, and engine_error must never drive actuation).
POLICY_RULES = (
    "actors_down",
    "shards_down",
    "telem_stale",
    "learner_starving",
    "eviction_churn",
)

# Which rules are exempt from the warm-up gate: replacing a dead or
# wedged process is safe (and urgent) during absorb; LOAD-based scaling
# must wait until the loop is past its first compiled phase, or the
# warm-up queue-full wait reads as starving/churning and flaps the fleet
# before phase 1.  (The health engine's wait-p99 rules are absorb-split
# too — this is the second, structural layer of the same exemption.)
_LOAD_RULES = frozenset({"learner_starving", "eviction_churn"})

ACTION_KINDS = (
    "spawn_actor",
    "kill_actor",
    "replace_actor",
    "respawn_shard_proc",
)


@dataclasses.dataclass(frozen=True)
class ScaleAction:
    """One typed actuation decision: what to do, to which slot, and the
    health rule + human-readable evidence that drove it.  ``slot`` is
    None for population resizes (``goal`` carries the new target) and a
    concrete lane id for replacements."""

    kind: str  # one of ACTION_KINDS
    slot: Optional[int]
    rule: str
    reason: str
    goal: Optional[int] = None  # population target for resize kinds


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    min_actors: int = 1
    max_actors: int = 0  # 0 = pinned to the startup population
    # Hysteresis: a rule must fire on this many CONSECUTIVE evaluations
    # before it may act (one stale sample can never flap the fleet);
    # ``fire_overrides`` tunes individual rules.
    fire_threshold: int = 3
    fire_overrides: Optional[Dict[str, int]] = None
    # Cooldown between LANDED actions, and a budget of actions per
    # rolling window — the two outer hysteresis rings.
    cooldown_s: float = 30.0
    window_s: float = 300.0
    max_actions_per_window: int = 4
    eval_every_s: float = 2.0
    dry_run: bool = False

    def fire_needed(self, rule: str) -> int:
        if self.fire_overrides and rule in self.fire_overrides:
            return int(self.fire_overrides[rule])
        return self.fire_threshold


class Autoscaler:
    """The decision/actuation loop.

    ``engine`` is an armed ``HealthEngine`` (evaluate() never raises);
    ``supervisor`` the actor fleet's ``ActorSupervisor``; ``shard_tier``
    (optional) anything exposing ``.supervisor`` with the same resize
    API (``ShardProcTier``).  ``ready_fn`` gates load-based rules (wired
    to ``IngestServer.is_steady``); ``expected_fn`` is told the new
    population target after a landed resize (wired to
    ``IngestServer.set_expected_actors``).  The clock is injectable and
    ``tick(now)`` is the whole per-evaluation step — the hysteresis
    tests drive it directly, no sleeps.
    """

    def __init__(
        self,
        engine: Any,
        supervisor: Any,
        *,
        shard_tier: Any = None,
        config: AutoscaleConfig = AutoscaleConfig(),
        clock: Callable[[], float] = time.monotonic,
        ready_fn: Optional[Callable[[], bool]] = None,
        expected_fn: Optional[Callable[[int], None]] = None,
    ):
        if config.min_actors < 0:
            raise ValueError("autoscale: min_actors must be >= 0")
        if config.max_actors and config.max_actors < config.min_actors:
            raise ValueError("autoscale: max bound below min bound")
        self.engine = engine
        self.supervisor = supervisor
        self.shard_tier = shard_tier
        self.config = config
        self._clock = clock
        self._ready_fn = ready_fn
        self._expected_fn = expected_fn
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._streaks: Dict[str, int] = {r: 0 for r in POLICY_RULES}
        self._pending: Optional[Dict[str, Any]] = None
        self._last_action_at: Optional[float] = None
        self._window: List[float] = []  # landed-action times (pruned)
        self._last_eval_at: Optional[float] = None
        self._actions: Dict[str, int] = {k: 0 for k in ACTION_KINDS}
        self._decisions = 0
        self._gated = 0
        self._dry_decisions = 0
        # Flight-ring hygiene: a decision that stays gated re-fires every
        # tick (a dead slot behind a spent window budget is re-decided at
        # eval cadence) — only the FIRST of an identical gated run is
        # flight evidence, the rest would flood the ring.
        self._last_gated_sig: Optional[tuple] = None
        reg = get_registry()
        self._obs_actions = reg.counter(
            "r2d2dpg_autoscale_actions_total",
            "landed autoscale actuations by kind",
            labelnames=("action",),
        )
        self._obs_target = reg.gauge(
            "r2d2dpg_autoscale_target_actors",
            "the autoscaler-managed actor population target",
        )
        self._obs_target.set_fn(lambda: float(self.supervisor.target))
        self._obs_age = reg.gauge(
            "r2d2dpg_autoscale_last_decision_age_seconds",
            "seconds since the policy loop last evaluated the health "
            "engine (a growing value means the loop itself is wedged)",
        )
        self._obs_age.set_fn(self._age)

    def _age(self) -> float:
        with self._lock:
            last = self._last_eval_at
        return 0.0 if last is None else max(self._clock() - last, 0.0)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._thread = threading.Thread(
            target=self._loop, name="fleet-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the policy loop must
                # never die mid-run; a failed tick is flight evidence.
                flight_event(
                    "autoscale_decision",
                    fired=False,
                    error=f"{type(e).__name__}: {e}",
                )
            self._stop.wait(self.config.eval_every_s)

    # ------------------------------------------------------------------ tick
    def tick(self, now: Optional[float] = None) -> Optional[ScaleAction]:
        """One policy evaluation: retry the pending action if one is in
        flight (no new decision while an actuation hasn't landed — the
        no-double-spawn contract), else evaluate the health engine,
        update per-rule streaks, and gate/actuate at most one candidate.
        Returns the action that LANDED this tick (None otherwise)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._last_eval_at = now
            pending = self._pending
        if pending is not None:
            return self._retry_pending(pending, now)
        verdict = self.engine.evaluate()
        findings = verdict.get("findings", [])
        firing: Dict[str, List[Dict]] = {}
        for f in findings:
            firing.setdefault(f.get("rule", "?"), []).append(f)
        with self._lock:
            for rule in POLICY_RULES:
                self._streaks[rule] = (
                    self._streaks[rule] + 1 if rule in firing else 0
                )
            streaks = dict(self._streaks)
        action = self._decide(firing, streaks)
        if action is None:
            return None
        gate = self._gate(action, now)
        sig = (action.kind, action.slot, action.rule, gate)
        with self._lock:
            self._decisions += 1
            if gate is not None:
                self._gated += 1
            repeat = gate is not None and sig == self._last_gated_sig
            self._last_gated_sig = sig if gate is not None else None
        if not repeat:
            flight_event(
                "autoscale_decision",
                action=action.kind,
                slot=action.slot,
                rule=action.rule,
                reason=action.reason,
                fired=gate is None,
                gated_by=gate,
                dry_run=self.config.dry_run,
            )
        if gate is not None:
            return None
        if self.config.dry_run:
            # The identical hysteresis clock ticks — a dry run logs the
            # cadence real actuation would have — but nothing moves and
            # no autoscale_action is emitted (the gate pairing check
            # stays trivially green).
            with self._lock:
                self._dry_decisions += 1
                self._last_action_at = now
                self._window.append(now)
            return None
        return self._actuate(action, now, first=True)

    # -------------------------------------------------------------- decision
    def _decide(
        self, firing: Dict[str, List[Dict]], streaks: Dict[str, int]
    ) -> Optional[ScaleAction]:
        cfg = self.config
        sup = self.supervisor
        hot = lambda rule: streaks.get(rule, 0) >= cfg.fire_needed(rule)  # noqa: E731

        # 1) Dead actor: replace on its own lane (population unchanged).
        if hot("actors_down"):
            states = sup.slot_states()
            down = sorted(i for i, s in states.items() if s == "down")
            if down:
                return ScaleAction(
                    "spawn_actor",
                    down[0],
                    "actors_down",
                    f"slot {down[0]} dead with no respawn owner",
                )
            # All corpses are mid-backoff/gave-up: the ladder (or an
            # operator) owns them — nothing for policy to do yet.

        # 2) Dead shard proc: backstop respawn through the tier's ladder.
        if hot("shards_down") and self.shard_tier is not None:
            states = self.shard_tier.supervisor.slot_states()
            dead = sorted(
                i for i, s in states.items() if s in ("down", "gave_up")
            )
            if dead:
                return ScaleAction(
                    "respawn_shard_proc",
                    dead[0],
                    "shards_down",
                    f"shard proc {dead[0]} {states[dead[0]]}",
                )

        # 3) Wedged actor (alive but silent): kill + respawn its lane.
        if hot("telem_stale"):
            slot = self._stale_actor(firing.get("telem_stale", ()))
            if slot is not None and sup.slot_states().get(slot) == "live":
                return ScaleAction(
                    "replace_actor",
                    slot,
                    "telem_stale",
                    f"actor {slot} TELEM stale but process alive",
                )

        ready = self._ready_fn is None or bool(self._ready_fn())
        target = sup.target
        fresh = "telem_stale" not in firing and "actors_down" not in firing

        # 4) Starving learner + every actor fresh: add an actor.
        if (
            hot("learner_starving")
            and ready
            and fresh
            and cfg.max_actors
            and target < cfg.max_actors
        ):
            return ScaleAction(
                "spawn_actor",
                None,
                "learner_starving",
                f"learner starving with {target} fresh actors",
                goal=target + 1,
            )

        # 5) Eviction churn with a satiated learner: drop an actor.
        if (
            hot("eviction_churn")
            and ready
            and "learner_starving" not in firing
            and target > cfg.min_actors
        ):
            return ScaleAction(
                "kill_actor",
                None,
                "eviction_churn",
                f"ring churning with a satiated learner at {target} actors",
                goal=target - 1,
            )
        return None

    @staticmethod
    def _stale_actor(findings) -> Optional[int]:
        # The finding's detail is "actor {who} TELEM stale — ..."; shard
        # staleness shares the rule but names unit "shard" and is the
        # shard ladder's problem, not this policy's.
        for f in findings:
            parts = str(f.get("detail", "")).split()
            if len(parts) >= 2 and parts[0] == "actor" and parts[1].isdigit():
                return int(parts[1])
        return None

    # ------------------------------------------------------------ hysteresis
    def _gate(self, action: ScaleAction, now: float) -> Optional[str]:
        """None = fire; otherwise the name of the ring that held it."""
        cfg = self.config
        with self._lock:
            if (
                self._last_action_at is not None
                and now - self._last_action_at < cfg.cooldown_s
            ):
                return "cooldown"
            self._window = [
                t for t in self._window if now - t < cfg.window_s
            ]
            if len(self._window) >= cfg.max_actions_per_window:
                return "window_budget"
        if action.rule in _LOAD_RULES:
            if self._ready_fn is not None and not self._ready_fn():
                return "warmup"
        return None

    # ------------------------------------------------------------- actuation
    def _retry_pending(self, pending: Dict[str, Any], now: float):
        action: ScaleAction = pending["action"]
        # A pending replacement/respawn whose slot came back on its own
        # (the ladder respawned it, or the wedge cleared) is superseded:
        # drop it without an autoscale_action — nothing was actuated.
        if action.slot is not None and action.kind != "kill_actor":
            sup = (
                self.shard_tier.supervisor
                if action.kind == "respawn_shard_proc"
                else self.supervisor
            )
            live = sup.slot_states().get(action.slot) == "live"
            if live and (action.kind != "replace_actor" or not pending.get("killed")):
                with self._lock:
                    self._pending = None
                flight_event(
                    "autoscale_decision",
                    action=action.kind,
                    slot=action.slot,
                    rule=action.rule,
                    fired=False,
                    gated_by="superseded",
                )
                return None
        return self._actuate(action, now, first=False, pending=pending)

    def _actuate(
        self,
        action: ScaleAction,
        now: float,
        *,
        first: bool,
        pending: Optional[Dict[str, Any]] = None,
    ) -> Optional[ScaleAction]:
        state = pending if pending is not None else {"action": action}
        landed = self._try_land(action, state)
        if not landed:
            with self._lock:
                self._pending = state
            if first:
                flight_event(
                    "autoscale_pending",
                    action=action.kind,
                    slot=action.slot,
                    rule=action.rule,
                )
            return None
        with self._lock:
            self._pending = None
            self._last_action_at = now
            self._window.append(now)
            self._actions[action.kind] += 1
        self._obs_actions.labels(action=action.kind).inc()
        flight_event(
            "autoscale_action",
            action=action.kind,
            slot=action.slot,
            rule=action.rule,
            goal=action.goal,
            target=self.supervisor.target,
        )
        if action.goal is not None and self._expected_fn is not None:
            self._expected_fn(action.goal)
        return action

    def _try_land(self, action: ScaleAction, state: Dict[str, Any]) -> bool:
        sup = self.supervisor
        if action.kind == "spawn_actor":
            if action.slot is not None:
                return sup.spawn_slot(action.slot, origin="autoscale")
            lim = self.config.max_actors or None
            res = sup.set_target(action.goal, lane_limit=lim)
            return bool(res["spawned"])
        if action.kind == "kill_actor":
            res = sup.set_target(action.goal)
            return bool(res["retiring"])
        if action.kind == "replace_actor":
            st = sup.slot_states().get(action.slot)
            if st == "live" and not state.get("killed"):
                # Stage 1: kill the wedged peer.  The monitor reaps the
                # corpse on its next poll; the spawn stage lands on a
                # later tick (never two processes in one lane).
                state["killed"] = bool(sup.kill_actor(action.slot))
                return False
            if st == "live":
                # Killed and already back: under a reflexive ladder the
                # restart WAS the replacement — count it landed.
                return True
            return sup.spawn_slot(action.slot, origin="autoscale")
        if action.kind == "respawn_shard_proc":
            return self.shard_tier.supervisor.spawn_slot(
                action.slot, origin="autoscale"
            )
        raise ValueError(f"unknown ScaleAction kind: {action.kind}")

    # ------------------------------------------------------------------ info
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "autoscale_decisions": self._decisions,
                "autoscale_gated": self._gated,
                "autoscale_actions": dict(self._actions),
                "autoscale_dry_run_decisions": self._dry_decisions,
                "autoscale_pending": (
                    self._pending["action"].kind
                    if self._pending is not None
                    else None
                ),
                "autoscale_target": self.supervisor.target,
            }
