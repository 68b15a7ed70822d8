"""The rank launcher: a cell on several chips as one process a chip.

Rank 0 is the harness's own process, on ``cuda:0``.  Ranks ``1 .. D-1`` are
child processes (``python -m perfbench.ranks``) on ``cuda:1 ...`` (all on
the CPU in the tests), started by ``Ranks`` and handed the run through a
``TCPStore`` that rank 0 serves on a free loopback port.  Every rank joins
one ``torch.distributed`` process group over that store (the backend the
program takes for the device: NCCL between cards, gloo on the CPU) and runs the same follower code, so every rank
makes the same collective calls in the same order; a child runs the
driver module's ``follow(run, ranks)`` and stores what it returns as its
report.

The window's end is rank 0's clock: once ``--seconds`` have passed it
names, through the store, the step after which every rank stops
(``STOP_MARGIN`` steps on, more than a rank's host can run ahead of rank
0's, since each step waits on rank 0 in its collectives).

Nothing waits without a limit.  A child must be ready ``SETUP_TIMEOUT_S``
after it starts and must report ``JOIN_TIMEOUT_S`` after rank 0's last
step; a watchdog ends the run ``deadline_s(--seconds)`` after the process
started if the children have not all reported, and as soon as one exits
with another code than 0.  Rank 0 hands the limits to the children with
the run, so a test that sets the constants sets them for every rank.  A child that fails, misses a limit or loads a
forbidden module (``harness.FORBIDDEN``) ends the run with a failed
result (``rank_faults`` 1) and exit code 0, through the driver's
``fault`` callback; every child is killed and waited for first.  A child
also ends itself once rank 0 is gone.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

from perfbench import harness
from r2d2dpg_torch.parallel import distributed

STOP_MARGIN = 4  # steps between rank 0's stop decision and the last step
POLL_S = 0.2
HOST = "127.0.0.1"
RUN_KEY = "perfbench/run"
STOP_KEY = "perfbench/stop_at"
SETUP_TIMEOUT_S = 150.0  # from a child's start to its readiness
JOIN_TIMEOUT_S = 60.0  # from rank 0's last step to every child's report
# What a run takes besides a child's readiness and the window: the rest of
# set-up, the checked and warm-up steps, the traced passes and the join.
MARGIN_S = 140.0


def deadline_s(seconds: float) -> float:
    """How long after its start a run of ``seconds`` may take until every
    child has reported."""
    return SETUP_TIMEOUT_S + float(seconds) + MARGIN_S


def _dist():
    import torch.distributed as dist

    return dist


def _seconds(s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(s))


class _Member:
    """What rank 0 and a child share: the store, the group and the limits."""

    rank: int
    world: int
    store = None
    limits: Dict[str, float]

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def join_group(self, dev: torch.device) -> None:
        """Join the world's process group over the backend the program
        takes for ``dev`` (NCCL between cards, gloo on the CPU).  Each rank keeps one intra-op
        thread, as ``torchrun`` sets for several processes on one host."""
        dist = _dist()
        torch.set_num_threads(1)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        self.store.set(f"perfbench/ready/{self.rank}", "1")
        self._wait_ready()
        dist.init_process_group(
            distributed.backend_for(dev),
            store=dist.PrefixStore("perfbench/group", self.store), rank=self.rank,
            world_size=self.world, timeout=_seconds(self.limits["deadline_s"] + 60))

    def _wait_ready(self) -> None:
        pass

    @staticmethod
    def leave_group() -> None:
        dist = _dist()
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks(_Member):
    """Rank 0's side: starts the children, serves the store, watches them.

    ``fault(reason)`` is called once, from whichever thread finds the fault,
    with every child already ended; it prints the failed result, and the
    process then exits with code 0."""

    def __init__(self, run: "harness.Run", world: int, follower: str,
                 fault: Callable[[str], None]):
        self.rank, self.world, self.run, self._fault = 0, world, run, fault
        self.limits = {"setup_timeout_s": SETUP_TIMEOUT_S, "join_timeout_s": JOIN_TIMEOUT_S,
                       "deadline_s": deadline_s(run.seconds)}
        self.store, port = _serve_store(self.limits["deadline_s"])
        self.store.set(RUN_KEY, json.dumps({
            "cell": {f: getattr(run.cell, f) for f in harness.Cell.__dataclass_fields__},
            "seed": run.seed, "seconds": run.seconds, "trace": run.trace,
            "device": run.device.type, "follower": follower, "world": world,
            "limits": self.limits}))
        self._lock = threading.Lock()
        self._ended = False
        self.children: List[subprocess.Popen] = []
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for r in range(1, world):
            self.children.append(subprocess.Popen(
                [sys.executable, "-m", "perfbench.ranks", "--port", str(port), "--rank", str(r)],
                cwd=harness.ROOT, env=env, stdin=subprocess.DEVNULL, stdout=sys.stderr))
        self._launched = time.perf_counter()
        self._watchdog = threading.Thread(target=self._watch, name="perfbench-ranks",
                                          daemon=True)
        self._watchdog.start()

    # ------------------------------------------------------------- limits
    def _wait_ready(self) -> None:
        keys = [f"perfbench/ready/{r}" for r in range(1, self.world)]
        left = self.limits["setup_timeout_s"] - (time.perf_counter() - self._launched)
        self._wait(keys, left, "set-up")

    def _wait(self, keys: List[str], seconds: float, what: str) -> None:
        try:
            self.store.wait(keys, _seconds(max(seconds, 0.001)))
        except RuntimeError:  # DistStoreError: the store's wait timed out
            missing = [k for k in keys if not self.store.check([k])]
            self.fault(f"{what}: no word from {missing} within its limit")

    def _watch(self) -> None:
        while True:
            time.sleep(POLL_S)
            with self._lock:
                if self._ended:
                    return
            for r, p in enumerate(self.children, 1):
                code = p.poll()
                if code not in (None, 0):
                    self.fault(f"rank {r} exited with code {code}: {self._error(r)}")
            if time.perf_counter() - self.run.started > self.limits["deadline_s"]:
                self.fault(f"the ranks did not finish within {self.limits['deadline_s']} s")

    def _error(self, r: int) -> str:
        key = f"perfbench/error/{r}"
        try:
            return self.store.get(key).decode()[-1500:] if self.store.check([key]) else ""
        except RuntimeError:
            return ""

    # -------------------------------------------------------------- window
    def stop_at(self, n: int, t0: float) -> Optional[int]:
        """Past ``--seconds`` on rank 0's clock: the step count every rank
        stops at, told to the children."""
        if time.perf_counter() - t0 < self.run.seconds:
            return None
        stop = n + STOP_MARGIN
        self.store.set(STOP_KEY, str(stop))
        return stop

    def reports(self) -> List[Dict]:
        """Every child's report, once each has stored it (``JOIN_TIMEOUT_S``);
        a report with forbidden modules ends the run as a fault."""
        keys = [f"perfbench/report/{r}" for r in range(1, self.world)]
        self._wait(keys, self.limits["join_timeout_s"], "join")
        out = [json.loads(self.store.get(k)) for k in keys]
        for r, rep in enumerate(out, 1):
            if rep["forbidden"]:
                self.fault(f"rank {r} loaded forbidden modules: {rep['forbidden']}")
        return out

    # ---------------------------------------------------------------- ends
    def fault(self, reason: str) -> None:
        with self._lock:
            if self._ended:
                return
            self._ended = True
        self._end_children(0.0)
        try:
            self._fault(reason)
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0)

    def abort(self) -> None:
        """Rank 0 raised: a child that failed first is the cause, and ends
        the run as a fault; otherwise the children are killed and rank 0's
        error goes on."""
        deadline = time.perf_counter() + 2.0
        while time.perf_counter() < deadline:
            for r, p in enumerate(self.children, 1):
                code = p.poll()
                if code not in (None, 0):
                    self.fault(f"rank {r} exited with code {code}: {self._error(r)}")
            time.sleep(POLL_S / 4)
        with self._lock:
            self._ended = True
        self._end_children(0.0)
        self.leave_group()

    def close(self) -> None:
        """Leave the group as the children do, stop the watchdog, wait
        ``JOIN_TIMEOUT_S`` for the children to exit and kill any left."""
        self.leave_group()
        with self._lock:
            ended, self._ended = self._ended, True
        if not ended:
            self._end_children(self.limits["join_timeout_s"])
            self._watchdog.join(timeout=2 * POLL_S + 1)

    def _end_children(self, grace: float) -> None:
        deadline = time.perf_counter() + grace
        for p in self.children:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 0.0))
            except subprocess.TimeoutExpired:
                pass
        for p in self.children:
            if p.poll() is None:
                p.kill()
        for p in self.children:
            p.wait()


class Follower(_Member):
    """A child's side: the run from the store, its stop and its report."""

    def __init__(self, store, rank: int, desc: Dict):
        self.rank, self.world, self.store = rank, desc["world"], store
        self.limits = desc["limits"]
        self._stop: Optional[int] = None

    def stop_at(self, n: int, t0: float) -> Optional[int]:
        """The step count rank 0 named, once it has; never one already past."""
        del t0
        if self._stop is None and self.store.check([STOP_KEY]):
            self._stop = int(self.store.get(STOP_KEY))
            if n > self._stop:
                raise RuntimeError(f"rank {self.rank} ran {n} steps, past the stop at "
                                   f"{self._stop}")
        return self._stop


def _serve_store(timeout_s: float):
    """``(store, port)``: a ``TCPStore`` served by this process on a free
    loopback port."""
    dist = _dist()
    for attempt in range(5):
        port = distributed.free_port()
        try:
            return dist.TCPStore(HOST, port, is_master=True, timeout=_seconds(timeout_s),
                                 wait_for_workers=False), port
        except RuntimeError:  # the port was taken in between
            if attempt == 4:
                raise
    raise AssertionError("unreachable")


def _orphan_guard(parent: int) -> None:
    """End this child once rank 0 has gone (its parent changes)."""
    def watch():
        while True:
            time.sleep(POLL_S)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, name="perfbench-orphan-guard", daemon=True).start()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="One child rank of a benchmark run.")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    args = p.parse_args(argv)
    started = time.perf_counter()
    _orphan_guard(os.getppid())
    store = _dist().TCPStore(HOST, args.port, is_master=False, timeout=_seconds(60))
    desc = json.loads(store.get(RUN_KEY))
    ranks = Follower(store, args.rank, desc)
    try:
        harness.pin_caches()
        dev = (torch.device("cuda", args.rank) if desc["device"] == "cuda"
               else torch.device(desc["device"]))
        run = harness.Run(cell=harness.Cell(**desc["cell"]), seed=desc["seed"],
                          seconds=desc["seconds"], trace=desc["trace"], device=dev,
                          started=started)
        report = importlib.import_module(desc["follower"]).follow(run, ranks)
        report["forbidden"] = harness.forbidden_modules()
        store.set(f"perfbench/report/{args.rank}", json.dumps(report))
        ranks.leave_group()
    except BaseException:
        text = traceback.format_exc()
        print(f"perfbench: rank {args.rank}: {text}", file=sys.stderr, flush=True)
        try:
            store.set(f"perfbench/error/{args.rank}", text)
        finally:
            os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
