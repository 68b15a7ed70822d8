"""The serving client: sessions that each step their own stand-in env with
the action they were served, paced at a fixed rate.

Lane ``i`` of ``sessions`` sends its requests at ``start + (i / sessions +
k) * period`` (``period = sessions / rate``), so the offered load is
``rate`` requests a second whatever the service does; a request whose lane
still waits for its previous answer goes out when that answer comes, and
its latency still counts from the time it was due.  A session lasts one
episode of the env; then ``end_session`` and a new session, whose first
request carries ``reset``.  One thread submits and polls every lane.

``service`` needs ``act_async(session, obs, reset=...)`` returning a
request with ``done``, ``code``, ``action``, ``enqueued_at`` and
``latency_s``, and ``end_session``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from perfbench.traffic.standin import StandIn


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank (0.0 with no values)."""
    if not values:
        return 0.0
    data = sorted(values)
    rank = int(np.ceil(q / 100.0 * len(data))) - 1
    return data[max(0, min(len(data) - 1, rank))]


class Client:
    def __init__(self, service, env: StandIn, lane_seeds, rate_per_s: float,
                 clock=time.monotonic, poll_s: float = 2e-4):
        self.service, self.env = service, env
        self.sessions = len(lane_seeds)
        self.period = self.sessions / rate_per_s
        self.clock, self.poll_s = clock, poll_s
        self.obs = env.reset(lane_seeds)
        self.fresh = [True] * self.sessions
        self.episode = [0] * self.sessions
        self.prefix = "w"

    def session_id(self, lane: int) -> str:
        return f"{self.prefix}{lane}-{self.episode[lane]}"

    def recorder(self, seconds: float) -> Dict[str, np.ndarray]:
        """Room for every answer of a ``run(seconds)``, made before it starts
        (so that recording allocates nothing while the load runs)."""
        n = int(np.ceil(seconds / self.period)) + 2
        s, o = self.sessions, self.obs.shape[1]
        return {"obs": np.zeros((s, n, o), np.float32), "reset": np.ones((s, n), np.float32),
                "action": np.zeros((s, n, self.env.action_dim), np.float32),
                "count": np.zeros(s, np.int64)}

    def run(self, seconds: float, record: Optional[Dict[str, np.ndarray]] = None) -> Dict:
        """Offer load for ``seconds``, then wait for every request sent.

        Returns the latencies (seconds from due to answer) and the codes of
        the requests due in the window; ``record`` (from ``recorder``) gets
        the obs, reset flag and action of each answered request, by lane."""
        start = self.clock()
        end = start + seconds
        due = [start + (i / self.sessions) * self.period for i in range(self.sessions)]
        pending: List[Optional[tuple]] = [None] * self.sessions
        latencies: List[float] = []
        codes: Dict[str, int] = {}
        while True:
            now = self.clock()
            busy = False
            for lane in range(self.sessions):
                sent = pending[lane]
                if sent is not None:
                    req, t_due, obs, reset = sent
                    if not req.done:
                        busy = True
                        continue
                    pending[lane] = None
                    latencies.append(req.enqueued_at + req.latency_s - t_due)
                    codes[req.code] = codes.get(req.code, 0) + 1
                    if req.code == "ok":
                        if record is not None:
                            j = record["count"][lane]
                            record["obs"][lane, j] = obs
                            record["reset"][lane, j] = reset
                            record["action"][lane, j] = req.action
                            record["count"][lane] = j + 1
                        self.fresh[lane] = False
                        nxt, done = self.env.step_lane(lane, req.action)
                        self.obs[lane] = nxt
                        if done:
                            self.service.end_session(self.session_id(lane))
                            self.episode[lane] += 1
                            self.fresh[lane] = True
                if due[lane] < end and due[lane] <= now:
                    obs = self.obs[lane].copy()
                    req = self.service.act_async(self.session_id(lane), obs,
                                                 reset=self.fresh[lane])
                    pending[lane] = (req, due[lane], obs, self.fresh[lane])
                    due[lane] += self.period
                    busy = True
            if not busy and min(due) >= end:
                break
            time.sleep(self.poll_s)
        return {"latencies": latencies, "codes": codes, "seconds": self.clock() - start}

    def close(self) -> None:
        """End every lane's session; the next request of each starts a new one."""
        for lane in range(self.sessions):
            self.service.end_session(self.session_id(lane))
            self.episode[lane] += 1
            self.fresh[lane] = True
