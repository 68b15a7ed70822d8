"""Serving CLI of the port (``python -m r2d2dpg_tpu serve``'s flags).

    python -m r2d2dpg_torch.serve --config pendulum_r2d2 --checkpoint-dir D \\
        [--bucket-sizes 1,2,4,8,16,32] [--flush-ms 5] [--max-queue 256] \\
        [--serve-workers 1] [--max-sessions 1024] [--session-ttl 300] \\
        [--poll-every 2] [--logdir DIR] [--log-every-s 10] \\
        [--flight-path F] [--selftest N] [--compute-dtype bfloat16] \\
        [--device cpu]

Stands up a ``PolicyService`` (or, with ``--serve-workers N > 1``, N of
them behind the session-affine router) over the latest checkpoint under
``D``, watches ``D`` for newer steps, and speaks newline-delimited JSON on
stdio:

    {"session": "u1", "obs": [..], "reset": true}
        -> {"code": "ok", "action": [..], "params_step": 1500, "latency_ms": 1.9}
    {"cmd": "health"}        -> the HealthSnapshot as JSON
    {"cmd": "end_session", "session": "u1"}   -> {"code": "ok", "released": true}
    {"cmd": "quit"}          -> exits after draining

``--selftest N`` instead drives N synthetic requests (8 interleaved
sessions) through the whole stack and prints one line: the response codes
and the final health.  The observation shape comes from the config's env,
so the configs whose envs are ported (Pendulum) serve; the DM-Control
configs raise until their envs are ported.  The HTTP exporter
(``--obs-port``) comes with the telemetry slice.  Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from r2d2dpg_torch.configs import CONFIGS, get_config
from r2d2dpg_torch.device import device_name, resolve_device
from r2d2dpg_torch.obs import get_flight_recorder
from r2d2dpg_torch.serving import (
    BAD_REQUEST,
    CheckpointHotReloader,
    PolicyService,
    actor_params_template,
    build_router,
)
from r2d2dpg_torch.utils.metrics import MetricLogger


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m r2d2dpg_torch.serve", description=__doc__)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--checkpoint-dir", required=True,
                   help="training run's checkpoint dir; also watched for hot-reload")
    p.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--bucket-sizes", default="1,2,4,8,16,32",
                   help="comma-separated batch sizes (the JAX CLI's flag); only the "
                   "largest counts here: it bounds a batch and is the row count "
                   "of every policy step")
    p.add_argument("--flush-ms", type=float, default=5.0,
                   help="max time the batcher waits for stragglers before launching")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission bound; beyond it requests shed with shed_queue_full")
    p.add_argument("--serve-workers", type=int, default=1, metavar="N",
                   help="worker services behind the session-affine router "
                   "(1 = one PolicyService, no router)")
    p.add_argument("--max-sessions", type=int, default=1024,
                   help="session-slab capacity PER WORKER")
    p.add_argument("--session-ttl", type=float, default=300.0,
                   help="seconds of idleness before a session's slot is reclaimed")
    p.add_argument("--poll-every", type=float, default=2.0,
                   help="seconds between checkpoint-dir polls for new params")
    p.add_argument("--logdir", default=None, help="health metrics CSV dir")
    p.add_argument("--log-every-s", type=float, default=10.0,
                   help="seconds between health rows written to --logdir")
    p.add_argument("--flight-path", default=None,
                   help="flight-recorder dump path (default <logdir>/flight.jsonl)")
    p.add_argument("--selftest", type=int, default=0, metavar="N",
                   help="drive N synthetic requests through the service and exit")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


def build_service(args):
    """The serving front end from CLI flags: ``(service, obs_shape)``."""
    cfg = get_config(args.config)
    if args.compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    device = resolve_device(args.device)
    env = cfg.env_factory(device)
    actor = cfg.build_agent(env).actor
    obs_shape = tuple(env.spec.obs_shape)
    max_batch = max(int(b) for b in args.bucket_sizes.split(","))
    if args.serve_workers < 1:
        raise SystemExit(f"--serve-workers must be >= 1, got {args.serve_workers}")
    common = dict(
        obs_shape=obs_shape,
        max_batch=max_batch,
        max_queue=args.max_queue,
        flush_ms=args.flush_ms,
        max_sessions=args.max_sessions,
        session_ttl_s=args.session_ttl,
    )
    template = actor_params_template(actor)
    if args.serve_workers > 1:
        # One restore on the host, moved onto each worker's device.  No CSV
        # logger: N workers would interleave rows in one file.
        reloader = CheckpointHotReloader(
            args.checkpoint_dir, template, device="cpu", poll_every_s=args.poll_every
        )
        service = build_router(
            actor, num_workers=args.serve_workers, reloader=reloader,
            device=device, **common,
        )
        return service, obs_shape
    reloader = CheckpointHotReloader(
        args.checkpoint_dir, template, device=device, poll_every_s=args.poll_every
    )
    logger = MetricLogger(args.logdir) if args.logdir else None
    service = PolicyService(
        actor, reloader=reloader, logger=logger, log_every_s=args.log_every_s,
        device=device, **common,
    )
    return service, obs_shape


def _health_dict(service) -> dict:
    """A PolicyService returns a dataclass snapshot, a ServiceRouter a dict."""
    snap = service.health()
    return snap if isinstance(snap, dict) else dataclasses.asdict(snap)


def _serve_stdio(service) -> None:
    """The JSONL request loop (one line in, one line out, order-preserving)."""
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"code": BAD_REQUEST, "error": str(e)}), flush=True)
            continue
        if not isinstance(msg, dict):
            print(json.dumps({"code": BAD_REQUEST,
                              "error": "request must be a JSON object"}), flush=True)
            continue
        cmd = msg.get("cmd")
        if cmd == "quit":
            break
        if cmd == "health":
            print(json.dumps(_health_dict(service)), flush=True)
            continue
        if cmd == "end_session":
            released = service.end_session(str(msg.get("session", "")))
            print(json.dumps({"code": "ok", "released": released}), flush=True)
            continue
        try:
            res = service.act(
                str(msg.get("session", "")),
                msg.get("obs", []),
                reset=bool(msg.get("reset", False)),
            )
            out = {"code": res.code, "params_step": res.params_step,
                   "latency_ms": round(res.latency_s * 1e3, 3)}
            if res.action is not None:
                out["action"] = [float(a) for a in res.action]
        except Exception as e:  # noqa: BLE001 - one bad payload answers its client
            out = {"code": BAD_REQUEST, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(out), flush=True)


def _selftest(service, obs_shape, n: int) -> dict:
    """Drive n synthetic requests (8 interleaved sessions); print and return
    the codes and the final health."""
    rng = np.random.default_rng(0)
    pending = [
        service.act_async(
            f"selftest-{i % 8}", rng.standard_normal(obs_shape).astype(np.float32),
            reset=(i < 8),
        )
        for i in range(n)
    ]
    codes: dict = {}
    for req in pending:
        req.wait(60.0)
        codes[req.code] = codes.get(req.code, 0) + 1
    out = {"selftest": n, "codes": codes, **_health_dict(service)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.logdir or args.flight_path:
        # Arm the exit-time dump only when the operator named a destination.
        get_flight_recorder().install(
            args.flight_path or os.path.join(args.logdir, "flight.jsonl"))
    service, obs_shape = build_service(args)
    print(f"backend: {device_name(resolve_device(args.device))}",
          file=sys.stderr, flush=True)
    with service:
        if args.selftest:
            return _selftest(service, obs_shape, args.selftest)
        _serve_stdio(service)
    return None


if __name__ == "__main__":
    main()
