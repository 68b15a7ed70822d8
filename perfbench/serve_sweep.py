"""Find the highest rate the serving cell sustains: its load at each rate
in turn, on one service, on the card.

    python3 perfbench/serve_sweep.py --workload walker_r2d2.serve \
        --rates 2000,4000,6000 --seconds 5 --seed 1

Prints one JSON line per rate: requests answered per second, the latency
p50/p95/p99 from the time each request was due, and the p95 of the
window's first and last thirds (a growing backlog shows as a later third
far above the first).  The serving cell's mix fixes its rate below the
highest that holds; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness, inputs, models  # noqa: E402
from perfbench.traffic.client import Client, nearest_rank  # noqa: E402
from perfbench.traffic.standin import StandIn  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="walker_r2d2.serve")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args()
    harness.pin_caches()
    import types

    from r2d2dpg_torch.envs.core import EnvSpec
    from r2d2dpg_torch.serving import PolicyService

    from perfbench.drivers import program

    cell = harness.find_cell(args.workload)
    conf, mix, dev = cell.config, cell.traffic, torch.device("cuda", 0)
    env = conf["env"]
    cfg = program.experiment(conf, 0)
    actor = cfg.build_agent(types.SimpleNamespace(
        spec=EnvSpec("sweep", tuple(env["obs_shape"]), env["action_dim"]))).actor
    weights = inputs.make_weights(models.entry(conf).shapes(conf), args.seed, dev)
    service = PolicyService(
        actor, weights["actor"], obs_shape=tuple(env["obs_shape"]),
        max_sessions=mix["max_sessions"], max_batch=max(mix["bucket_sizes"]),
        max_queue=mix["max_queue"], flush_ms=mix["flush_ms"],
        session_ttl_s=mix["session_ttl_s"], device=dev).start()
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            dyn = StandIn(args.seed, env["obs_shape"][0], env["action_dim"],
                          env["episode_length"])
            seeds = np.arange(mix["sessions"]) + 1000 * args.seed
            client = Client(service, dyn, seeds, rate)
            client.prefix = f"r{int(rate)}-"
            client.run(1.0)
            out = client.run(args.seconds)
            client.close()
            lat = out["latencies"]
            third = len(lat) // 3
            h = service.health()
            print(json.dumps({
                "rate": rate, "answered_per_s": len(lat) / out["seconds"],
                "codes": out["codes"],
                "p50_ms": 1e3 * nearest_rank(lat, 50), "p95_ms": 1e3 * nearest_rank(lat, 95),
                "p99_ms": 1e3 * nearest_rank(lat, 99),
                "p95_first_third_ms": 1e3 * nearest_rank(lat[:third], 95),
                "p95_last_third_ms": 1e3 * nearest_rank(lat[-third:], 95),
                "step_p50_ms": h.step_p50_ms, "batch_occupancy": h.batch_occupancy,
            }), flush=True)
    finally:
        service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
