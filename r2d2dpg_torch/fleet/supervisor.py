"""Actor supervision: spawn, watch, restart with exponential backoff.

Port of ``r2d2dpg_tpu/fleet/supervisor.py``.  The supervisor owns the
fleet's processes: it spawns each
worker as a subprocess, polls liveness on a monitor thread, and restarts
any actor that exits while the fleet is live, after an exponential backoff
(a crash-looping actor must not fork-bomb the host) that resets once an
incarnation survives ``healthy_after_s``.  Every crash lands in the flight
recorder (``actor_crash`` with actor id, returncode, restart count).
``role`` names the process class: ``"actor"`` (the fleet's actors) or
``"shard"`` (the standalone replay shards, ``fleet/shard.py``), whose
metrics are ``r2d2dpg_shard_alive``/``r2d2dpg_shard_restarts_total`` and
whose events are ``shard_crash``/``shard_restart``/``shard_gave_up``,
keyed by ``id_field`` (``shard_proc``: a process hosts several shards).  A
slot is given up after ``max_restarts``, or at once when the actor exits
with a HELLO-refusal code (``utils/codes.py``: every restart would be
refused again); ``gave_up()`` names such slots, and the fleet learner
treats them as an error.

``restart="policy"`` hands a crashed slot's respawn to a policy engine
(``fleet/autoscaler.py``): the crash is recorded and the slot left down
until ``spawn_slot``.  The runtime resize API (``target``,
``slot_states``, ``retire_slot``, ``set_target``) drains a slot out with
SIGUSR1 (the actor finishes its phase, sends BYE and exits 0), reaps that
exit as ``<role>_drained`` and escalates SIGTERM, then SIGKILL, when the
drain is ignored past ``retire_grace_s``.

Every child runs on the CPU: its environment hides every card
(``CUDA_VISIBLE_DEVICES=""``), an actor's argv carries ``--device cpu``
and a shard process makes no CUDA call, so only the learner opens a CUDA
context on the card.  A child also runs one intra-op thread
(``OMP_NUM_THREADS=1``) unless the caller's environment names another
count: N children each spinning torch's default one thread per core
oversubscribe the host whose cores the learner's dispatch needs.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from r2d2dpg_torch.obs import flight_event, get_registry
from r2d2dpg_torch.utils.codes import TERMINAL_ACTOR_EXITS


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    backoff_base_s: float = 0.5  # first restart delay; doubles per crash
    backoff_max_s: float = 30.0
    healthy_after_s: float = 60.0  # uptime that resets the backoff ladder
    max_restarts: Optional[int] = None  # per actor; None = never give up
    poll_s: float = 0.2
    # Who owns a crashed slot's respawn: "backoff" is the ladder above;
    # "policy" records the crash and leaves the slot down for a policy
    # engine's spawn_slot.  Terminal exits give the slot up either way.
    restart: str = "backoff"
    # retire_slot's drain window before SIGTERM (and, one more window
    # later, SIGKILL).
    retire_grace_s: float = 10.0


@dataclasses.dataclass
class _ActorSlot:
    proc: Optional[subprocess.Popen] = None
    started_at: float = 0.0
    first_started_at: Optional[float] = None
    restarts: int = 0
    consecutive_crashes: int = 0
    restart_at: Optional[float] = None  # backoff deadline when dead
    gave_up: bool = False
    # A retired slot is draining out of the fleet: its exit is never a
    # crash to restart.  ``retire_at`` is the escalation deadline;
    # ``term_sent`` marks SIGTERM already sent.
    retired: bool = False
    retire_at: Optional[float] = None
    term_sent: bool = False


class ActorSupervisor:
    """Owns ``num_actors`` worker subprocesses for the life of a fleet run.

    ``argv_fn(actor_id)`` builds each worker's command line;
    ``log_path_fn(actor_id)``, when given, routes the worker's stdout and
    stderr to a per-worker file.  ``clock`` is injectable: the backoff and
    give-up timing is tested against a fake clock (tests drive
    ``_poll_once`` directly)."""

    def __init__(
        self,
        argv_fn: Callable[[int], List[str]],
        num_actors: int,
        *,
        config: SupervisorConfig = SupervisorConfig(),
        env: Optional[Dict[str, str]] = None,
        log_path_fn: Optional[Callable[[int], str]] = None,
        clock: Callable[[], float] = time.monotonic,
        role: str = "actor",
        id_field: Optional[str] = None,
    ):
        if num_actors < 1:
            raise ValueError("num_actors must be >= 1")
        self.argv_fn = argv_fn
        self.num_actors = num_actors
        self.config = config
        self.log_path_fn = log_path_fn
        self.role = role
        self.id_field = id_field or role
        self._clock = clock
        self._env = dict(os.environ if env is None else env)
        # CPU discipline (module docstring): no card is visible to a child,
        # and a child runs one intra-op thread unless the caller's
        # environment names another count.
        self._env["CUDA_VISIBLE_DEVICES"] = ""
        self._env.setdefault("OMP_NUM_THREADS", "1")
        # The child imports the port from this checkout, whatever its cwd.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = self._env.get("PYTHONPATH")
        self._env["PYTHONPATH"] = root + (os.pathsep + path if path else "")
        self._slots: Dict[int, _ActorSlot] = {
            i: _ActorSlot() for i in range(num_actors)
        }
        # The runtime population target: set_target moves it.  num_actors
        # stays the startup count (chaos hashing and the sigma ladder's
        # width are fixed at spawn time).
        self._target = num_actors
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # Per-role metric names: an actor fleet and a shard tier in one
        # learner never share a series.
        reg = get_registry()
        if role == "actor":
            alive_name = "r2d2dpg_fleet_actors_alive"
            restarts_name = "r2d2dpg_fleet_actor_restarts_total"
        else:
            alive_name = f"r2d2dpg_{role}_alive"
            restarts_name = f"r2d2dpg_{role}_restarts_total"
        self._obs_alive = reg.gauge(alive_name, f"live supervised {role} subprocesses")
        self._obs_alive.set_fn(lambda: float(self.alive_count()))
        self._obs_restarts = reg.counter(
            restarts_name,
            f"supervised {role} restarts (crash -> backoff -> respawn)",
        )

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "ActorSupervisor":
        if self._monitor is not None:
            raise RuntimeError("supervisor already started")
        for i in range(self.num_actors):
            self._spawn(i)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="fleet-supervisor", daemon=True
        )
        self._monitor.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Orderly teardown: no restarts from here on, SIGTERM the fleet,
        SIGKILL stragglers.  Call BEFORE stopping the ingest server, so a
        connection reset never masquerades as a crash."""
        self._stopping.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        with self._lock:
            procs = [s.proc for s in self._slots.values() if s.proc is not None]
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + timeout
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()

    # ------------------------------------------------------------ inspection
    def alive_count(self) -> int:
        with self._lock:
            return sum(
                1
                for s in self._slots.values()
                if s.proc is not None and s.proc.poll() is None
            )

    @property
    def restarts_total(self) -> int:
        with self._lock:
            return sum(s.restarts for s in self._slots.values())

    def gave_up(self) -> List[int]:
        """The slots given up (restart budget spent or a terminal exit)."""
        with self._lock:
            return [i for i, s in self._slots.items() if s.gave_up]

    def first_started_at(self, actor_id: int) -> Optional[float]:
        """When the slot's first incarnation was spawned (the clock's time)."""
        with self._lock:
            return self._slots[actor_id].first_started_at

    def pids(self) -> Dict[int, int]:
        """The live incarnations' process ids, by actor id."""
        with self._lock:
            return {i: s.proc.pid for i, s in self._slots.items()
                    if s.proc is not None and s.proc.poll() is None}

    def kill_actor(self, actor_id: int) -> bool:
        """Drill hook: hard-kill one worker (the supervisor sees a crash and
        walks the restart path).  True when a kill was delivered; False for
        a slot that is already dead or in backoff."""
        with self._lock:
            proc = self._slots[actor_id].proc
        if proc is not None and proc.poll() is None:
            proc.kill()
            return True
        return False

    # ------------------------------------------------------- runtime resize
    @property
    def target(self) -> int:
        """The current population target (set_target moves it)."""
        with self._lock:
            return self._target

    def slot_states(self) -> Dict[int, str]:
        """Each slot's state: ``live``, ``backoff`` (the ladder owns a
        pending respawn), ``down`` (dead and nobody owns a respawn: a
        policy-mode corpse), ``retired`` or ``gave_up``."""
        out: Dict[int, str] = {}
        with self._lock:
            for i, s in self._slots.items():
                if s.gave_up:
                    out[i] = "gave_up"
                elif s.retired:
                    out[i] = "retired"
                elif s.proc is not None and s.proc.poll() is None:
                    out[i] = "live"
                elif s.restart_at is not None:
                    out[i] = "backoff"
                else:
                    out[i] = "down"
        return out

    def spawn_slot(self, actor_id: int, *, origin: str = "resize") -> bool:
        """Explicitly (re)spawn one slot, a given-up or a new one included.
        False (the caller keeps it pending and retries) while the slot's
        process is alive or draining, while the backoff ladder owns a
        pending respawn, or when the spawn fails (a ``<role>_spawn_failed``
        event)."""
        with self._lock:
            if self._stopping.is_set():
                return False
            slot = self._slots.get(actor_id)
            if slot is None:
                slot = self._slots[actor_id] = _ActorSlot()
            if slot.proc is not None and slot.proc.poll() is None:
                return False
            if slot.restart_at is not None and not slot.gave_up:
                return False
            resurrected = slot.gave_up
            slot.gave_up = False
            slot.retired = False
            slot.retire_at = None
            slot.term_sent = False
            slot.consecutive_crashes = 0
            try:
                self._spawn(actor_id)
            except Exception as e:  # noqa: BLE001 - an event, never a raise
                flight_event(f"{self.role}_spawn_failed",
                             **{self.id_field: actor_id},
                             error=f"{type(e).__name__}: {e}")
                return False
            flight_event(f"{self.role}_spawn", **{self.id_field: actor_id},
                         origin=origin, resurrected=resurrected)
            return True

    def retire_slot(self, actor_id: int, *, origin: str = "resize") -> bool:
        """Drain one slot out of the fleet (the scale-down actuator).  The
        slot is marked retired first, so the monitor never reads its exit
        as a crash; then the worker gets SIGUSR1.  False for a slot that is
        absent, already retired or given up."""
        with self._lock:
            slot = self._slots.get(actor_id)
            if slot is None or slot.retired or slot.gave_up:
                return False
            slot.retired = True
            slot.restart_at = None
            slot.retire_at = self._clock() + self.config.retire_grace_s
            slot.term_sent = False
            proc = slot.proc
            draining = proc is not None and proc.poll() is None
            if draining:
                try:
                    proc.send_signal(signal.SIGUSR1)
                except (OSError, ValueError):
                    draining = False
            flight_event(f"{self.role}_retire", **{self.id_field: actor_id},
                         origin=origin, draining=draining)
            return True

    def set_target(self, n: int, *,
                   lane_limit: Optional[int] = None) -> Dict[str, List[int]]:
        """Resize the live population to ``n`` slots.  Scale-down retires
        the highest active slots (lane 0, the greediest explorer, goes
        last); scale-up fills the lowest free lane, never a given-up slot
        (that needs an explicit spawn_slot) nor one still draining, and no
        lane at or past ``lane_limit``.  A spawn that cannot land stops the
        walk.  Returns the slot ids spawned and retiring."""
        if n < 0:
            raise ValueError("set_target: n must be >= 0")
        with self._lock:
            previous, self._target = self._target, n
        if n != previous:
            flight_event(f"{self.role}_set_target", target=n,
                         previous=previous)
        spawned: List[int] = []
        retiring: List[int] = []
        while True:
            with self._lock:
                active = sorted(i for i, s in self._slots.items()
                                if not s.retired and not s.gave_up)
            if len(active) <= n:
                break
            if not self.retire_slot(active[-1], origin="resize"):
                break
            retiring.append(active[-1])
        while True:
            with self._lock:
                active = {i for i, s in self._slots.items()
                          if not s.retired and not s.gave_up}
                if len(active) >= n:
                    break
                lane = 0
                while True:
                    s = self._slots.get(lane)
                    if lane not in active and (
                        s is None
                        or (not s.gave_up
                            and (s.proc is None or s.proc.poll() is not None))
                    ):
                        break
                    lane += 1
                if lane_limit is not None and lane >= lane_limit:
                    lane = None
            if lane is None or not self.spawn_slot(lane, origin="resize"):
                break
            spawned.append(lane)
        return {"spawned": spawned, "retiring": retiring}

    # -------------------------------------------------------------- internal
    def _spawn(self, actor_id: int) -> None:
        slot = self._slots[actor_id]
        stdout = subprocess.DEVNULL
        if self.log_path_fn is not None:
            stdout = open(self.log_path_fn(actor_id), "ab")
        try:
            slot.proc = subprocess.Popen(
                self.argv_fn(actor_id),
                env=self._env,
                stdout=stdout,
                stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL,
            )
        finally:
            if stdout is not subprocess.DEVNULL:
                stdout.close()  # the child holds its own fd
        slot.started_at = self._clock()
        if slot.first_started_at is None:
            slot.first_started_at = slot.started_at
        slot.restart_at = None

    def _monitor_loop(self) -> None:
        while not self._stopping.is_set():
            self._poll_once(self._clock())
            self._stopping.wait(self.config.poll_s)

    def _poll_once(self, now: float) -> None:
        """One supervision pass at time ``now``: the whole timing contract
        (healthy-uptime ladder reset, backoff arming, the restart_at
        deadline, the give-up paths) in one directly testable step."""
        cfg = self.config
        with self._lock:
            for actor_id, slot in self._slots.items():
                if slot.gave_up:
                    continue
                if slot.retired:
                    # Draining out: the exit was asked for.  Reap it as a
                    # drain, never as a crash, and never arm the ladder.
                    proc = slot.proc
                    if proc is None:
                        continue  # already reaped
                    if proc.poll() is not None:
                        flight_event(f"{self.role}_drained",
                                     **{self.id_field: actor_id},
                                     returncode=proc.returncode)
                        slot.proc = None
                        slot.retire_at = None
                        continue
                    if slot.retire_at is not None and now >= slot.retire_at:
                        # The drain was ignored: SIGTERM, then SIGKILL one
                        # more grace window later.
                        if not slot.term_sent:
                            proc.terminate()
                            slot.term_sent = True
                            slot.retire_at = now + cfg.retire_grace_s
                        else:
                            proc.kill()
                            slot.retire_at = None  # the next poll reaps
                    continue
                if slot.proc is not None and slot.proc.poll() is None:
                    # Healthy uptime resets the backoff ladder.
                    if (
                        slot.consecutive_crashes
                        and now - slot.started_at > cfg.healthy_after_s
                    ):
                        slot.consecutive_crashes = 0
                    continue
                if slot.proc is not None and slot.restart_at is None:
                    # Fresh corpse: record, arm the backoff.
                    rc = slot.proc.returncode
                    slot.consecutive_crashes += 1
                    backoff = min(
                        cfg.backoff_base_s
                        * (2 ** (slot.consecutive_crashes - 1)),
                        cfg.backoff_max_s,
                    )
                    flight_event(
                        f"{self.role}_crash",
                        **{self.id_field: actor_id},
                        returncode=rc,
                        restarts=slot.restarts,
                        backoff_s=round(backoff, 3),
                    )
                    if rc in TERMINAL_ACTOR_EXITS:
                        # A HELLO refusal: every restart would be refused
                        # again within milliseconds.
                        slot.gave_up = True
                        flight_event(
                            f"{self.role}_gave_up",
                            **{self.id_field: actor_id},
                            restarts=slot.restarts,
                            reason=TERMINAL_ACTOR_EXITS[rc],
                        )
                        continue
                    if (
                        cfg.max_restarts is not None
                        and slot.restarts >= cfg.max_restarts
                    ):
                        slot.gave_up = True
                        flight_event(
                            f"{self.role}_gave_up",
                            **{self.id_field: actor_id},
                            restarts=slot.restarts,
                        )
                        continue
                    if cfg.restart == "policy":
                        # Policy-owned recovery: leave the slot down; a
                        # spawn_slot is the only way back.
                        slot.proc = None
                        continue
                    slot.restart_at = now + backoff
                if slot.restart_at is not None and now >= slot.restart_at:
                    # A failed spawn must not kill the monitor thread: note
                    # it and retry on the max backoff.
                    try:
                        self._spawn(actor_id)
                    except Exception as e:  # noqa: BLE001
                        flight_event(
                            f"{self.role}_spawn_failed",
                            **{self.id_field: actor_id},
                            error=f"{type(e).__name__}: {e}",
                        )
                        slot.restart_at = now + cfg.backoff_max_s
                        continue
                    slot.restarts += 1
                    self._obs_restarts.inc()
                    flight_event(
                        f"{self.role}_restart",
                        **{self.id_field: actor_id},
                        restarts=slot.restarts,
                    )


def default_actor_argv(
    actor_id: int,
    *,
    config_name: str,
    address: str,
    num_actors: int,
    seed: Optional[int] = None,
    extra: Optional[List[str]] = None,
) -> List[str]:
    """The standard actor command line (the train CLI's spawner); the
    actor runs on the CPU."""
    argv = [
        sys.executable,
        "-m",
        "r2d2dpg_torch.fleet.actor",
        "--device",
        "cpu",
        "--config",
        config_name,
        "--connect",
        address,
        "--actor-id",
        str(actor_id),
        "--num-actors",
        str(num_actors),
    ]
    if seed is not None:
        argv += ["--seed", str(seed)]
    if extra:
        argv += list(extra)
    return argv
