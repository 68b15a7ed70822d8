"""Port parity: ``r2d2dpg_torch/parallel/`` (mesh, process group, ``SPMDTrainer``).

- ``make_mesh`` / ``distributed``: JAX's ``requested n devices, have m``
  rule, a group of one brought up in this process, the block helpers.
- ``SPMDTrainer``'s refusals carry JAX's messages.
- ``--spmd 1`` is bitwise the plain ``Trainer`` (a world of one runs the
  same collectives), through the class and through the train CLI, whose
  ``topology:`` line equals JAX's ``describe()``.
- ``--spmd 2`` as 2 gloo processes against JAX's ``SPMDTrainer`` on a
  2-device mesh: JAX runs warm-up and replay fill, each rank gets its
  slice of that state and JAX's per-device draws of one train phase
  (``fold_in`` of the collect and learn keys by device index), and both
  run the train phase.  Compared per rank: env state, window and arena
  (atol 1e-5, rtol 1e-4, the single-device trainer test's tolerance), the
  replicated params (atol 1e-5, rtol 1e-4), the averaged metrics (rtol
  1e-4, atol 1e-5); every injected draw consumed.  The ranks' init rows
  equal the global init's rows (bitwise).
- ``allgather_into_mirror`` at 2 gloo processes: rank 0's merged scrape
  equals JAX's ``render_prometheus(merge_remote(...))`` of a JAX
  ``RemoteMirror`` fed rank 1's snapshot (exact).

``spawn_world`` starts the gloo processes (``RANK``/``WORLD_SIZE``/
``MASTER_ADDR``/``MASTER_PORT`` on a free loopback port), one torch
intra-op thread each; ``tests/test_torch_dp_learner.py`` uses it too.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.parallel import DP_AXIS, distributed, make_mesh, replicated, sharded
from r2d2dpg_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-4)

# Every worker starts with this: the group from the environment, the mesh.
PRELUDE = """
import os, sys, torch
sys.path.insert(0, os.environ["REPO"])
from r2d2dpg_torch.parallel import distributed, make_mesh
assert distributed.initialize("cpu")
mesh = make_mesh(int(os.environ["WORLD_SIZE"]), "cpu")
OUT = os.environ["OUT"]
"""


def spawn_world(world: int, body: str, out_dir, timeout: float = 300) -> list:
    """Run ``PRELUDE + body`` in ``world`` gloo processes; returns each
    rank's ``torch.load(<out_dir>/rank<r>.pt)``."""
    port = distributed.free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), REPO=REPO, OUT=str(out_dir),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PRELUDE + body], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------- mesh, group
def test_mesh_of_one_and_the_jax_device_rule():
    mesh = make_mesh(1, "cpu")
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    assert mesh.shape == {DP_AXIS: 1}
    assert distributed.is_initialized() and distributed.is_primary()
    assert make_mesh(None, "cpu").size == 1  # idempotent
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, "cpu")
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(sharded(mesh)(x), x) and replicated(mesh)(x) is x
    assert torch.equal(mesh.all_gather(x), x)
    assert torch.equal(mesh.reduce_scatter(x), x)
    assert torch.equal(mesh.pmean_(x.clone()), x)


def test_distributed_initialize_is_a_noop_without_a_cluster(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    up = distributed.is_initialized()
    assert distributed.initialize("cpu") == up
    assert distributed.world_size() == 1 and distributed.rank() == 0


def test_block_helpers_split_like_a_dp_sharding():
    """Rank r of D keeps rows [r*n/D, (r+1)*n/D): JAX's P("dp") blocks."""
    from r2d2dpg_torch.parallel.mesh import Mesh

    x = torch.arange(24.0).reshape(2, 12)
    for r in range(4):
        m = Mesh(size=4, rank=r, device=torch.device("cpu"))
        assert torch.equal(sharded(m)(x, axis=1), x[:, 3 * r:3 * r + 3])
    with pytest.raises(ValueError, match="not divisible"):
        Mesh(size=5, rank=0, device=torch.device("cpu")).block(12)


# ------------------------------------------------------------- refusals
def _jax_refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_spmd_refusals_equal_jax():
    from r2d2dpg_tpu.configs import PENDULUM_R2D2 as J_R2D2
    from r2d2dpg_tpu.models import ActorNet as JActor, CriticNet as JCritic
    from r2d2dpg_tpu.agents import R2D2DPG as JAgent
    from r2d2dpg_tpu.parallel import SPMDTrainer as JSPMD, make_mesh as jmesh
    from r2d2dpg_torch.parallel import SPMDTrainer

    jm = jmesh(1)
    jenv = J_R2D2.env_factory()
    mesh = make_mesh(1, "cpu")
    cfg = PENDULUM_TINY
    env = cfg.env_factory("cpu")

    def jagent(axis):
        return JAgent(JActor(action_dim=1, hidden=8), JCritic(hidden=8),
                      dataclasses.replace(J_R2D2.agent, axis_name=axis))

    msg = _jax_refusal(lambda: JSPMD(jenv, jagent(None), J_R2D2.trainer, jm))
    with pytest.raises(ValueError) as e:
        SPMDTrainer(env, cfg.build_agent(env), cfg.trainer, mesh)
    assert str(e.value) == msg
    env.batched = True
    with pytest.raises(ValueError, match="host-callback"):
        SPMDTrainer(env, cfg.build_agent(env, DP_AXIS), cfg.trainer, mesh)
    # Divisibility: the JAX text at mesh size 8 (the conftest's 8 devices).
    bad = dataclasses.replace(J_R2D2.trainer, num_envs=6)
    msg = _jax_refusal(lambda: JSPMD(jenv, jagent(DP_AXIS), bad, jmesh(8)))
    from r2d2dpg_torch.parallel.mesh import Mesh

    wide = Mesh(size=8, rank=0, device=torch.device("cpu"))
    port_env = cfg.env_factory("cpu")
    with pytest.raises(ValueError) as e:
        SPMDTrainer(port_env, cfg.build_agent(port_env, DP_AXIS),
                    dataclasses.replace(cfg.trainer, num_envs=6), wide)
    assert str(e.value) == msg


# ------------------------------------------------------ world of one
def test_spmd1_is_bitwise_the_plain_trainer():
    mesh = make_mesh(1, "cpu")
    plain = PENDULUM_TINY.build("cpu")
    n = plain.window_fill_phases + plain.replay_fill_phases + 4
    ref = plain.run(n, log_every=2, log_fn=lambda *_: None)
    got = PENDULUM_TINY.build_spmd(mesh, "cpu").run(n, log_every=2, log_fn=lambda *_: None)
    assert _leaves_equal(got.train, ref.train)
    assert torch.equal(got.arena.priority, ref.arena.priority)
    assert torch.equal(got.obs, ref.obs) and got.env_steps == ref.env_steps


def test_spmd1_cli_is_bitwise_the_plain_cli(capsys):
    from r2d2dpg_tpu import topology as jtopology
    from r2d2dpg_tpu import train as jtrain
    from r2d2dpg_torch import train

    argv = ["--config", "pendulum_tiny", "--phases", "3", "--log-every", "2",
            "--device", "cpu"]
    ref = train.main(argv)
    capsys.readouterr()
    got = train.main(argv + ["--spmd", "1"])
    lines = capsys.readouterr().out.splitlines()
    want = jtopology.resolve(jtrain.parse_args(
        ["--config", "pendulum_tiny", "--spmd", "1"])).describe()
    assert lines[1] == f"topology: {want}"
    assert _leaves_equal(got.train, ref.train)
    assert torch.equal(got.arena.priority, ref.arena.priority)


# ------------------------------------------------------ --spmd 2 vs JAX
def _rank_draws(rng, d, tcfg_local, action_dim):
    """JAX device d's draws of one SPMD train phase, in the port's order:
    the collect key and the learn key folded by the device index."""
    E = tcfg_local.num_envs
    out = []
    rng, scan_key = jax.random.split(rng)  # Trainer._collect
    scan_key = jax.random.fold_in(scan_key, d)
    for key in jax.random.split(scan_key, tcfg_local.stride):
        k_noise, k_env = jax.random.split(key)
        out.append(jax.random.normal(k_noise, (E, action_dim), jnp.float32))
        k12 = jax.vmap(jax.random.split)(jax.random.split(k_env, E))
        out.append(jax.vmap(lambda k: jax.random.uniform(
            k, (), minval=-jnp.pi, maxval=jnp.pi))(k12[:, 0]))
        out.append(jax.vmap(lambda k: jax.random.uniform(
            k, (), minval=-1.0, maxval=1.0))(k12[:, 1]))
    _, key = jax.random.split(rng)  # Trainer._learn
    key = jax.random.fold_in(key, d)
    for k in jax.random.split(key, tcfg_local.learner_steps):
        out.append(jax.random.uniform(k, (tcfg_local.batch_size,)))
    return [torch.tensor(np.asarray(x)) for x in out]


def _rank_slice(s, d, world, capacity):
    """Device d's part of a global JAX SPMD TrainerState (host numpy)."""
    tm = jax.tree_util.tree_map

    def lanes(x):
        n = np.shape(x)[0] // world
        return np.asarray(x)[d * n:(d + 1) * n]

    c = capacity // world
    blk = lambda x: np.asarray(x)[d * c:(d + 1) * c]  # noqa: E731
    return dataclasses.replace(
        s,
        env_state=tm(lanes, s.env_state), obs=lanes(s.obs), reset=lanes(s.reset),
        actor_carry=tm(lanes, s.actor_carry), critic_carry=tm(lanes, s.critic_carry),
        noise_state=lanes(s.noise_state), window=tm(lanes, s.window),
        episode_return=lanes(s.episode_return),
        arena=dataclasses.replace(
            s.arena, data=tm(blk, s.arena.data), priority=blk(s.arena.priority),
            meta=blk(s.arena.meta)),
    )


SPMD_BODY = """
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.obs.registry import Registry, RemoteMirror, allgather_into_mirror
from r2d2dpg_torch.training.draws import Draws
t = PENDULUM_TINY.build_spmd(mesh, "cpu")
init = t.init()
inp = torch.load(os.path.join(OUT, f"in{mesh.rank}.pt"), weights_only=False)
state, metrics = t.train_phase(inp)
# The mirror: a registry per rank, rank 0 folds rank 1's.
reg = Registry()
reg.gauge("r2d2dpg_test_rank", "this rank").set(float(mesh.rank))
reg.counter("r2d2dpg_test_steps_total", "steps").inc(3.0 + mesh.rank)
mirror = RemoteMirror()
folded = allgather_into_mirror(reg, mirror)
torch.save({"state": {"env_state": state.env_state, "obs": state.obs,
                      "window": state.window, "priority": state.arena.priority,
                      "train": state.train, "env_steps": state.env_steps,
                      "completed_count": state.completed_count},
            "metrics": metrics, "left": inp.draws.remaining(),
            "init_obs": init.obs, "init_window": init.window,
            "sigmas": t.sigmas, "folded": folded,
            "snapshot": reg.snapshot(), "sources": mirror.sources()},
           os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


def test_spmd2_matches_jax_spmd_and_the_mirror(tmp_path):
    from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
    from r2d2dpg_tpu.obs.registry import RemoteMirror as JMirror
    from r2d2dpg_tpu.obs.registry import merge_remote as j_merge
    from r2d2dpg_tpu.obs.registry import render_prometheus as j_render
    from r2d2dpg_tpu.parallel import make_mesh as jmesh
    from r2d2dpg_torch.convert import net_params_from_flax, trainer_state_from_jax
    from r2d2dpg_torch.obs.registry import merge_remote, render_prometheus
    from r2d2dpg_torch.training import ReplayDraws

    world = 2
    jt = J_TINY.build_spmd(jmesh(world))
    js = jt.init()
    for _ in range(jt.window_fill_phases):
        js = jt.collect_phase(js)
    for _ in range(jt.replay_fill_phases):
        js = jt.fill_phase(js)
    host = jax.device_get(js)
    cap = J_TINY.trainer.capacity
    draws = []
    for d in range(world):
        dr = _rank_draws(js.rng, d, jt.config, jt.env.spec.action_dim)
        draws.append(len(dr))
        torch.save(trainer_state_from_jax(_rank_slice(host, d, world, cap),
                                          ReplayDraws(dr), device="cpu"),
                   tmp_path / f"in{d}.pt")
    js, jm = jt.train_phase(js)
    ref = jax.device_get(js)
    outs = spawn_world(world, SPMD_BODY, tmp_path)

    plain_init = PENDULUM_TINY.build("cpu").init()
    for d, out in enumerate(outs):
        want = _rank_slice(ref, d, world, cap)
        st = out["state"]
        assert out["left"] == 0
        np.testing.assert_allclose(st["env_state"].theta.numpy(), want.env_state.theta, **TOL)
        np.testing.assert_allclose(st["env_state"].thdot.numpy(), want.env_state.thdot, **TOL)
        np.testing.assert_allclose(st["obs"].numpy(), want.obs, **TOL)
        for name in ("obs", "action", "reward", "discount", "reset"):
            np.testing.assert_allclose(getattr(st["window"], name).numpy(),
                                       getattr(want.window, name), **TOL, err_msg=name)
        np.testing.assert_allclose(st["priority"].numpy(), want.arena.priority, **TOL)
        assert st["train"].step == int(ref.train.step)
        assert st["env_steps"] == int(ref.env_steps)
        np.testing.assert_allclose(float(st["completed_count"]), float(ref.completed_count))
        for name in ("actor_params", "critic_params", "target_actor_params",
                     "target_critic_params"):
            jp = net_params_from_flax(getattr(ref.train, name))
            for k in jp:
                np.testing.assert_allclose(getattr(st["train"], name)[k].numpy(),
                                           jp[k].numpy(), **TOL, err_msg=f"{name}.{k}")
        assert set(out["metrics"]) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(out["metrics"][k]), float(jm[k]), **TOL, err_msg=k)
        # init: the global reset's rows, this rank's ladder lanes.
        rows = slice(2 * d, 2 * d + 2)
        assert torch.equal(out["init_obs"], plain_init.obs[rows])
        assert torch.equal(out["init_window"].obs, plain_init.window.obs[rows])
        plain_sig = PENDULUM_TINY.build("cpu").sigmas
        assert torch.equal(out["sigmas"], plain_sig[rows])
    # The params stay replicated.
    assert _leaves_equal(outs[0]["state"]["train"], outs[1]["state"]["train"])

    # allgather_into_mirror: rank 0 folded rank 1 under host=proc1.
    assert [o["folded"] for o in outs] == [1, 0]
    jmirror = JMirror()
    jmirror.update("proc:1", {"host": "proc1"}, outs[1]["snapshot"])
    want = j_render(j_merge(outs[0]["snapshot"], jmirror.sources()))
    got = render_prometheus(merge_remote(outs[0]["snapshot"], outs[0]["sources"]))
    assert got == want and 'host="proc1"' in got
