"""Port parity: r2d2dpg_torch.ops against r2d2dpg_tpu.ops on the CPU.

Inputs come from ``np.random.default_rng(seed)`` and go through both
packages.  Tolerance: rtol 1e-6 (atol 1e-6 where values pass through zero) —
the same float32 arithmetic in the same order on both sides, so only
last-ulp differences of the two CPU backends remain.
Also here: the package's import purity and its refusal to fall back to the
CPU when CUDA is missing.
"""

import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_tpu import ops as jops
from r2d2dpg_torch import ops as tops

RTOL, ATOL = 1e-6, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=rtol, atol=atol
    )


def _nstep_case(kind, n, seed=0):
    """The boundary fixtures of tests/test_returns.py, plus a random batch."""
    rng = np.random.default_rng(seed)
    if kind == "none":
        T = 12
        r, q = rng.standard_normal((2, T)).astype(np.float32)
        return r, np.ones(T, np.float32), np.zeros(T, np.float32), q
    if kind == "boundaries":
        T = 14
        r, q = rng.standard_normal((2, T)).astype(np.float32)
        d = np.ones(T, np.float32)
        resets = np.zeros(T, np.float32)
        d[3] = 0.0  # termination at t=3 (reset follows)
        resets[4] = 1.0
        resets[9] = 1.0  # truncation at t=8
        return r, d, resets, q
    if kind == "truncation_leak":
        T = 8
        r = np.ones(T, np.float32)
        r[4:] = 1000.0
        q = np.full(T, 7.0, np.float32)
        q[4:] = -999.0
        resets = np.zeros(T, np.float32)
        resets[4] = 1.0
        return r, np.ones(T, np.float32), resets, q
    # random batch with terminations, truncations and fractional discounts
    B, T = 6, 15
    r, q = rng.standard_normal((2, B, T)).astype(np.float32)
    d = rng.choice([0.0, 0.5, 1.0, 1.0, 1.0], size=(B, T)).astype(np.float32)
    resets = (rng.random((B, T)) < 0.2).astype(np.float32)
    return r, d, resets, q


@pytest.mark.parametrize(
    "kind,n",
    [
        ("none", 1), ("none", 3), ("none", 5),
        ("boundaries", 2), ("boundaries", 5),
        ("truncation_leak", 3),
        ("random", 1), ("random", 4),
    ],
)
def test_n_step_targets_match_jax(kind, n):
    r, d, resets, q = _nstep_case(kind, n)
    want = jops.n_step_targets(
        jnp.asarray(r), jnp.asarray(d), jnp.asarray(resets), jnp.asarray(q),
        n=n, gamma=0.97,
    )
    got = tops.n_step_targets(
        torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(resets),
        torch.from_numpy(q), n=n, gamma=0.97,
    )
    _close(got, want)


def test_n_step_targets_rejects_short_sequences():
    with pytest.raises(ValueError):
        tops.n_step_targets(
            torch.ones(5), torch.ones(5), torch.zeros(5), torch.ones(5),
            n=5, gamma=0.99,
        )


def test_td_errors_and_huber_match_jax():
    rng = np.random.default_rng(1)
    q, y = (3 * rng.standard_normal((2, 4, 7))).astype(np.float32)
    _close(
        tops.td_errors(torch.from_numpy(q), torch.from_numpy(y)),
        jops.td_errors(jnp.asarray(q), jnp.asarray(y)),
    )
    _close(tops.huber(torch.from_numpy(q)), jops.huber(jnp.asarray(q)))


def test_sequence_priority_matches_jax():
    td = np.random.default_rng(2).standard_normal((8, 20)).astype(np.float32)
    _close(
        tops.sequence_priority(torch.from_numpy(td), eta=0.9),
        jops.sequence_priority(jnp.asarray(td), eta=0.9),
    )


@pytest.mark.parametrize("size,beta", [(1, 0.4), (37, 0.4), (5000, 0.73), (64, 1.0)])
def test_importance_weights_match_jax(size, beta):
    probs = np.random.default_rng(3).random(16).astype(np.float32) / size
    probs[0] = 0.0  # exercises the 1e-12 floor
    _close(
        tops.importance_weights(torch.from_numpy(probs), size, beta=beta),
        jops.importance_weights(jnp.asarray(probs), size, beta=beta),
    )


@pytest.mark.parametrize("step", [0, 1, 777, 100_000, 250_000])
def test_anneal_beta_matches_jax(step):
    got = tops.anneal_beta(step, beta0=0.4, steps=100_000)
    want = float(jops.anneal_beta(jnp.asarray(step), beta0=0.4, steps=100_000))
    assert got == want  # both float32 by construction


@pytest.mark.parametrize("kind", ["geometric", "linear", "constant"])
@pytest.mark.parametrize("n", [1, 4, 64])
def test_sigma_ladder_matches_jax(kind, n):
    kw = dict(sigma_max=0.3, alpha=3.0, kind=kind, sigma_min=0.05)
    _close(tops.sigma_ladder(n, **kw), jops.sigma_ladder(n, **kw))


def test_sigma_ladder_rejects_unknown_kind():
    with pytest.raises(ValueError):
        tops.sigma_ladder(4, kind="bogus")


def test_noise_with_injected_normals_matches_jax():
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(5)
    E, A = 6, 3
    sigma = tops.sigma_ladder(E, sigma_max=0.4, alpha=7.0)
    action = jnp.asarray(rng.uniform(-1, 1, (E, A)).astype(np.float32))
    normal = jax.random.normal(key, (E, A), jnp.float32)
    want = jops.gaussian_noise(key, action, jnp.asarray(sigma.numpy()))
    got = tops.gaussian_noise(
        torch.tensor(np.asarray(action)), sigma,
        normal=torch.tensor(np.asarray(normal)),
    )
    _close(got, want)

    state = rng.standard_normal((E, A)).astype(np.float32)
    want = jops.ou_step(key, jnp.asarray(state), jnp.asarray(sigma.numpy()))
    got = tops.ou_step(
        torch.from_numpy(state), sigma, normal=torch.tensor(np.asarray(normal))
    )
    _close(got, want)


def test_noise_draws_from_generator_without_injection():
    sigma = torch.full((4,), 0.5)
    a = torch.zeros(4, 2)
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    x1 = tops.gaussian_noise(a, sigma, generator=g1)
    x2 = tops.gaussian_noise(a, sigma, generator=g2)
    assert torch.equal(x1, x2) and x1.abs().sum() > 0


def test_polyak_matches_jax():
    rng = np.random.default_rng(6)
    online = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    target = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    want = jops.polyak_update(
        {"w": jnp.asarray(online["w"])}, {"w": jnp.asarray(target["w"])}, 5e-3
    )
    got = tops.polyak_update(
        {"w": torch.from_numpy(online["w"])}, {"w": torch.from_numpy(target["w"])}, 5e-3
    )
    _close(got["w"], want["w"])
    hard = tops.hard_update({"w": torch.from_numpy(online["w"])}, None)
    np.testing.assert_array_equal(hard["w"].numpy(), online["w"])


_PURITY = """
import importlib, pkgutil, sys
import r2d2dpg_torch
names = [m.name for m in pkgutil.walk_packages(r2d2dpg_torch.__path__, "r2d2dpg_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
print("MODULES", " ".join(names))
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "r2d2dpg_tpu")
)
print("BAD", bad)
sys.exit(1 if bad else 0)
"""

# Every module and CLI the port has, so a new one cannot slip past the walk.
_PORT_MODULES = {
    "r2d2dpg_torch.train", "r2d2dpg_torch.eval", "r2d2dpg_torch.serve",
    "r2d2dpg_torch.training.evaluator", "r2d2dpg_torch.utils.checkpoint",
    "r2d2dpg_torch.utils.metrics", "r2d2dpg_torch.utils.codes",
    "r2d2dpg_torch.obs.registry", "r2d2dpg_torch.obs.flight",
    "r2d2dpg_torch.serving.sessions", "r2d2dpg_torch.serving.batcher",
    "r2d2dpg_torch.serving.health", "r2d2dpg_torch.serving.service",
    "r2d2dpg_torch.serving.reload", "r2d2dpg_torch.serving.router",
    "r2d2dpg_torch.training.pipeline", "r2d2dpg_torch.utils.profiling",
    "r2d2dpg_torch.obs.trace", "r2d2dpg_torch.obs.watchdog",
    "r2d2dpg_torch.obs.quality", "r2d2dpg_torch.obs.device",
}


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PURITY], capture_output=True, text=True,
        timeout=120, cwd=pathlib.Path(__file__).resolve().parent.parent,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("MODULES ")[1].split("\n")[0].split())
    assert _PORT_MODULES <= walked, _PORT_MODULES - walked


def test_no_cpu_fallback_without_cuda(monkeypatch):
    from r2d2dpg_torch import resolve_device
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PENDULUM_TINY.build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", "pendulum_tiny", "--phases", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", "pendulum_tiny", "--phases", "1", "--pipeline", "1"])
    from r2d2dpg_torch.eval import main as eval_main
    from r2d2dpg_torch.serve import main as serve_main
    from r2d2dpg_torch.serving import PolicyService, default_worker_devices

    for cli in (eval_main, serve_main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli(["--config", "pendulum_tiny", "--checkpoint-dir", "unused"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_worker_devices(2)
    actor = PENDULUM_TINY.build_agent(types.SimpleNamespace(
        spec=types.SimpleNamespace(obs_shape=(3,), action_dim=1))).actor
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PolicyService(actor, actor.init_params(None, "cpu"))
    assert resolve_device("cpu").type == "cpu"
