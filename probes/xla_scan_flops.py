#!/usr/bin/env python3
"""How XLA's ``cost_analysis`` counts the FLOPs of a ``lax.scan`` (the JAX
reference package, on the CPU).

    JAX_PLATFORMS=cpu python3 probes/xla_scan_flops.py

Prints one JSON line with two measurements:

1. ``scan``: a ``lax.scan`` of N products ``[8, 64] @ [64, 64]`` (2*8*64*64
   = 65,536 FLOPs each), for N = 1, 4, 16, against N unrolled in Python.
2. ``pendulum_tiny_learner_step``: the JAX package's learner step at
   pendulum_tiny (batch 8) as written, and with every ``lax.scan`` forced
   to ``unroll=True``.

The port counts the same learner step with ``FlopCounterMode``
(``tests/test_torch_telemetry.py`` pins it to its analytic count,
7,214,080); this script explains why the reference's MFU numerator is
smaller.  It runs on the host only; it is no part of either package.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _flops(lowered) -> float:
    ca = lowered.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["flops"])


def main() -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    x = jnp.ones((8, 64))
    scan = {}
    for n in (1, 4, 16):
        ws = jnp.ones((n, 64, 64))

        def scanned(x, ws):
            return jax.lax.scan(lambda c, wi: (c @ wi, ()), x, ws)[0]

        def unrolled(x, ws):
            for i in range(ws.shape[0]):
                x = x @ ws[i]
            return x

        scan[n] = {"scan": _flops(jax.jit(scanned).lower(x, ws)),
                   "python_unrolled": _flops(jax.jit(unrolled).lower(x, ws))}

    from r2d2dpg_tpu.configs import PENDULUM_TINY
    from r2d2dpg_tpu.replay.arena import SequenceBatch

    env = PENDULUM_TINY.env_factory()
    agent = PENDULUM_TINY.build_agent(env)
    b, length = 8, agent.config.seq_len
    a_dim, o_dim = env.spec.action_dim, 3
    train = agent.init(jax.random.PRNGKey(0), jnp.zeros((b, o_dim)), jnp.zeros((b, a_dim)))
    batch = SequenceBatch(
        obs=jnp.zeros((b, length, o_dim)), action=jnp.zeros((b, length, a_dim)),
        reward=jnp.zeros((b, length)), discount=jnp.ones((b, length)),
        reset=jnp.zeros((b, length)),
        carries={"actor": agent.actor.initial_carry(b),
                 "critic": agent.critic.initial_carry(b)},
    )
    weights = jnp.ones((b,))
    as_written = _flops(jax.jit(lambda *a: agent.learner_step(*a)).lower(
        train, batch, weights))
    plain_scan = jax.lax.scan

    def scan_unrolled(f, init, xs=None, length=None, reverse=False, unroll=1, **kw):
        del unroll
        return plain_scan(f, init, xs, length, reverse=reverse, unroll=True, **kw)

    jax.lax.scan = scan_unrolled
    try:
        unrolled_all = _flops(jax.jit(lambda *a: agent.learner_step(*a)).lower(
            train, batch, weights))
    finally:
        jax.lax.scan = plain_scan
    print(json.dumps({
        "jax": jax.__version__, "backend": jax.default_backend(),
        "product_flops": 2 * 8 * 64 * 64,
        "scan": scan,
        "pendulum_tiny_learner_step": {"as_written": as_written,
                                       "every_scan_unrolled": unrolled_all},
    }))


if __name__ == "__main__":
    main()
