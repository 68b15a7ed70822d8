"""The serve loop: one ``PolicyService`` with the serve CLI's settings, and
``traffic/client.py``'s sessions at the mix's fixed rate.

Set-up builds the configuration's actor, loads the benchmark's weights
into the service and offers ``warmup_s`` of the same load (the service's
own warm-up step, then every bucket the traffic reaches).  The window
offers ``--seconds`` of load from fresh sessions and records each answer;
after it, the plain rollout of every session decides ``correct``.
"""

from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from perfbench import compare, inputs, models, trace
from perfbench.harness import Run, Window, peak_bytes, sync
from perfbench.traffic.client import Client, nearest_rank
from perfbench.traffic.standin import StandIn


def run(run: Run) -> Window:
    from r2d2dpg_torch.envs.core import EnvSpec
    from r2d2dpg_torch.serving import PolicyService

    from perfbench.drivers import program

    cell, dev = run.cell, program.device(run.device)
    conf, mix = cell.config, cell.traffic
    env, model = conf["env"], models.entry(conf)
    run.mark("imports")
    cfg = program.experiment(conf, inputs.subseed(run.seed, "env"))
    spec = EnvSpec("perfbench-serve", tuple(env["obs_shape"]), env["action_dim"])
    actor = cfg.build_agent(types.SimpleNamespace(spec=spec)).actor
    weights = inputs.make_weights(model.shapes(conf), run.seed, dev)
    service = PolicyService(
        actor, weights["actor"], obs_shape=tuple(env["obs_shape"]),
        max_sessions=mix["max_sessions"], max_batch=max(mix["bucket_sizes"]),
        max_queue=mix["max_queue"], flush_ms=mix["flush_ms"],
        session_ttl_s=mix["session_ttl_s"], device=dev)
    service.start(warmup=True)
    run.mark("service started")
    dyn = StandIn(inputs.subseed(run.seed, "env"), env["obs_shape"][0], env["action_dim"],
                  env["episode_length"])
    seeds = np.random.default_rng(inputs.subseed(run.seed, "lanes")).integers(
        0, 2**31 - 1, mix["sessions"])
    client = Client(service, dyn, seeds, mix["rate_per_s"])
    try:
        client.run(mix["warmup_s"])
        client.close()
        client.prefix = "s"
        streams = client.recorder(run.seconds)
        sync(dev)
        t0 = time.perf_counter()
        out = client.run(run.seconds, record=streams)
        lat = out["latencies"]
        ok = out["codes"].get("ok", 0)
        health = service.health()
        window = Window(
            attempted=len(lat), failed=len(lat) - ok, setup_s=t0 - run.started,
            end_to_end={"serve_p95_ms": 1e3 * nearest_rank(lat, 95.0)}, checks={},
            memory_peak_bytes=peak_bytes(dev),
            readings={"health": {"step_p50_ms": health.step_p50_ms,
                                 "batch_occupancy": health.batch_occupancy},
                      "window_s": out["seconds"]})
        print(f"perfbench: {len(lat)} requests in {out['seconds']:.3f} s, codes {out['codes']}, "
              f"p50 {1e3 * nearest_rank(lat, 50.0):.3f} ms, "
              f"p99 {1e3 * nearest_rank(lat, 99.0):.3f} ms", flush=True)
        if run.trace:
            def offer(seconds):
                with run.spans("serve"):
                    client.run(seconds)

            window.trace = trace.profile(lambda: offer(mix["trace_s"]), 1)
            names = trace.profile(lambda: offer(mix["breakdown_s"]), 1, host=True)
            window.breakdown = trace.breakdown(window.trace, names)
    finally:
        client.close()
        service.stop()
    del service, actor, weights, client
    gc.collect()
    torch.cuda.empty_cache()
    params = inputs.make_weights(model.shapes(conf), run.seed, dev)["actor"]
    mask = np.arange(streams["obs"].shape[1])[None, :] < streams["count"][:, None]
    want = model.actions(params, streams["obs"], streams["reset"], "float32", dev)
    window.readings["streams"] = streams
    window.checks = compare.serving_checks(streams["action"], want, mask)
    return window
