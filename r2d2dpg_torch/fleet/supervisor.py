"""Actor supervision: spawn, watch, restart with exponential backoff.

Port of ``r2d2dpg_tpu/fleet/supervisor.py`` without the rest of its
runtime-resize API (``retire_slot``/``set_target``, which come with the
autoscaler).  The supervisor owns the fleet's processes: it spawns each
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

Every child runs on the CPU: its environment hides every card
(``CUDA_VISIBLE_DEVICES=""``), an actor's argv carries ``--device cpu``
and a shard process makes no CUDA call, so only the learner opens a CUDA
context on the card.
"""

from __future__ import annotations

import dataclasses
import os
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


@dataclasses.dataclass
class _ActorSlot:
    proc: Optional[subprocess.Popen] = None
    started_at: float = 0.0
    first_started_at: Optional[float] = None
    restarts: int = 0
    consecutive_crashes: int = 0
    restart_at: Optional[float] = None  # backoff deadline when dead
    gave_up: bool = False


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
        # CPU discipline (module docstring): no card is visible to a child.
        self._env["CUDA_VISIBLE_DEVICES"] = ""
        # The child imports the port from this checkout, whatever its cwd.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = self._env.get("PYTHONPATH")
        self._env["PYTHONPATH"] = root + (os.pathsep + path if path else "")
        self._slots: Dict[int, _ActorSlot] = {
            i: _ActorSlot() for i in range(num_actors)
        }
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

    def spawn_slot(self, actor_id: int, *, origin: str = "resize") -> bool:
        """Explicitly (re)spawn one slot, a given-up one included.  False
        (the caller retries later) while the slot's process is alive, while
        the backoff ladder owns a pending respawn, or when the spawn fails
        (a ``<role>_spawn_failed`` event)."""
        with self._lock:
            if self._stopping.is_set():
                return False
            slot = self._slots[actor_id]
            if slot.proc is not None and slot.proc.poll() is None:
                return False
            if slot.restart_at is not None and not slot.gave_up:
                return False
            resurrected = slot.gave_up
            slot.gave_up = False
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
