"""Port parity: the host-pool trainer (``parallel/hybrid.py``) and the
batched-env paths of the plain trainer, the evaluator and the pipeline.

At ``test_hybrid_spmd.py``'s tiny walker shapes (4 envs, stride 4, batch
4, capacity 64, hidden 32, burn-in 2, unroll 4, n-step 2, the native
walker-walk pool at action repeat 2):

- ``HostSPMDTrainer`` against JAX's ``HostSPMDTrainer``, sequential and
  overlapped (``overlap_learner``, 3 learner steps spread over a stride of
  4): both run init, warm-up, fill and one train phase from the same
  params (JAX's init, converted) with JAX's draws injected in the port's
  order (the reset seeds, each step's exploration normal, each learner
  step's sampling uniforms; every one consumed).  Walker's physics turns
  a one-ulp difference in an action into 1.2e-4 in an observation within
  12 agent steps (measured here), and two sources of such ulps are not the
  port's to remove: the two packages' float32 nets round differently, and
  JAX's jitted ``sigma * normal`` fuses the product into the normal's
  transform (one ulp off the correctly rounded product for most lanes).
  So these runs start the actor's output layer at zero (``_zero_head``)
  and explore at a constant sigma of 1 (``EXACT_ACTIONS``): every
  collected action is then the injected normal, clipped, with the same
  bits in both packages, and the env data stays bitwise equal; the
  learner's updates run on the whole nets.  The ladder itself is held
  bitwise to JAX's, rank by rank, on its own.  Compared: the env obs,
  the window, the arena (priorities, provenance, stored obs), the params
  and the metrics, at atol 1e-5, rtol 1e-4 (the trainer tests'
  tolerance).  At D = 1 in this process; at D = 2 and 4 as gloo processes
  (``spawn_world``) against JAX's trainer on a mesh of 2 or 4 of the
  conftest's virtual devices, each rank's env rows and its replicated
  arena and params against JAX's global state.
- World size 1 is bitwise the port's plain ``Trainer`` on the same env and
  seed (the same draws, the same ops).
- The plain ``Trainer`` on walker against JAX's, whose collect steps the
  pool through ``io_callback``; the ``Evaluator`` on walker against JAX's
  (both with the zero head, so the 500-step rollouts stay bitwise).
- The refusals carry JAX's messages (the trainer's, and ``build``,
  ``build_spmd`` and ``build_dp_learner``'s for ``overlap_learner``).
- The pipelined executor over the host-pool trainer at world size 1: the
  off anchor bitwise ``Trainer.run``, counters, moved priorities, finite
  metrics, the collector on its own modules, each phase's param version
  ``max(0, k - d - 1)``; taken at world size 2 (D = 2 and 4 run in
  ``tests/test_torch_hybrid_pipeline.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_torch.configs import WALKER_R2D2
from r2d2dpg_torch.convert import net_params_from_flax, train_state_from_jax
from r2d2dpg_torch.parallel import HostSPMDTrainer, make_mesh
from r2d2dpg_torch.training import ReplayDraws
from r2d2dpg_torch.tree import tree_leaves

from test_torch_parallel import spawn_world

TOL = dict(atol=1e-5, rtol=1e-4)
# The tiny shapes, shared by this process and the gloo workers.
TINY_SRC = """
import dataclasses
TINY = dict(num_envs=4, stride=4, batch_size=4, capacity=64, min_replay=4)
EXACT_ACTIONS = dict(ladder_kind="constant", sigma_max=1.0)


def _tiny(cfg, overlap=False, learner_steps=1, **trainer):
    return dataclasses.replace(
        cfg,
        trainer=dataclasses.replace(cfg.trainer, **TINY, learner_steps=learner_steps,
                                    overlap_learner=overlap, **trainer),
        hidden=32,
        agent=dataclasses.replace(cfg.agent, burnin=2, unroll=4, n_step=2),
    )
"""
exec(TINY_SRC)


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _zero_head(params):
    """Flax actor params with the output layer's kernel and bias zeroed."""
    head = {k: jnp.zeros_like(v) for k, v in params["params"]["head"].items()}
    return {**params, "params": {**params["params"], "head": head}}


def _jax_init(jt):
    """JAX's initial state with the actor's head zeroed (module docstring)."""
    js = jt.init()
    train = dataclasses.replace(
        js.train, actor_params=_zero_head(js.train.actor_params),
        target_actor_params=_zero_head(js.train.target_actor_params))
    return dataclasses.replace(js, train=train,
                               behavior_params=_zero_head(js.behavior_params))


def _schedule(t):
    return (["collect"] * t.window_fill_phases + ["fill"] * t.replay_fill_phases
            + ["train"])


def _jax_hybrid(world, overlap, learner_steps):
    """JAX's ``HostSPMDTrainer`` through init, warm-up, fill and one train
    phase; returns (final host state, train metrics, the draws in the
    port's order, the init train state)."""
    from r2d2dpg_tpu.configs import WALKER_R2D2 as J_WALKER
    from r2d2dpg_tpu.parallel import HostSPMDTrainer as JHybrid
    from r2d2dpg_tpu.parallel import make_mesh as jmesh

    jt = _tiny(J_WALKER, overlap, learner_steps, **EXACT_ACTIONS).build_spmd(jmesh(world))
    assert isinstance(jt, JHybrid)
    cfg, a_dim = jt.config, jt.env.spec.action_dim
    k_env, _, _ = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    draws = [_t(jax.random.randint(k_env, (cfg.num_envs,), 0, 2**31 - 1), torch.int64)]
    js = _jax_init(jt)
    init_train = jax.device_get(js.train)
    metrics = None
    for kind in _schedule(jt):
        rng, sk, sl = jax.random.split(js.rng, 3)  # HostSPMDTrainer._collect_setup
        keys = jax.random.split(sk, cfg.stride)
        lkeys = jax.random.split(sl, max(cfg.learner_steps, 1))
        sub = 0
        for t in range(cfg.stride):
            draws.append(_t(jax.random.normal(keys[t], (cfg.num_envs, a_dim), jnp.float32)))
            if kind == "train" and overlap:
                while sub < cfg.learner_steps and (
                        (sub + 1) * cfg.stride <= (t + 1) * cfg.learner_steps):
                    draws.append(_t(jax.random.uniform(lkeys[sub], (cfg.batch_size,))))
                    sub += 1
        if kind == "train" and not overlap:
            _, key = jax.random.split(rng)  # Trainer._learn
            for k in jax.random.split(key, cfg.learner_steps):
                draws.append(_t(jax.random.uniform(k, (cfg.batch_size,))))
        if kind == "collect":
            js = jt.collect_phase(js)
        elif kind == "fill":
            js = jt.fill_phase(js)
        else:
            js, metrics = jt.train_phase(js)
    return jax.device_get(js), jax.device_get(metrics), draws, init_train


# The port's side of one run, shared by this process and the gloo workers.
RUN_SRC = """
def run_port(mesh, cfg, draws, train0, build_overlap=False):
    import dataclasses, torch
    from r2d2dpg_torch.training import ReplayDraws
    t = cfg.build("cpu") if build_overlap else cfg.build_spmd(mesh, "cpu")
    draws = ReplayDraws(draws)
    s = t.init(draws)
    s = dataclasses.replace(s, train=train0, behavior_params={
        k: v.clone() for k, v in train0.actor_params.items()})
    for _ in range(t.window_fill_phases):
        s = t.collect_phase(s)
    for _ in range(t.replay_fill_phases):
        s = t.fill_phase(s)
    s, m = t.train_phase(s)
    return {"kind": type(t).__name__, "mesh": t.mesh.size, "obs": s.obs,
            "window": s.window, "priority": s.arena.priority, "meta": s.arena.meta,
            "arena_obs": s.arena.data.obs, "cursor": s.arena.cursor,
            "train": s.train, "metrics": m, "left": draws.remaining(),
            "env_steps": s.env_steps, "phase_idx": s.phase_idx,
            "episode_return": s.episode_return}
"""
_ns: dict = {}
exec(RUN_SRC, _ns)
run_port = _ns["run_port"]


def _check_rank(got, ref, metrics, world, rank):
    e = TINY["num_envs"] // world
    rows = slice(rank * e, (rank + 1) * e)
    assert got["left"] == 0
    assert got["kind"] == "HostSPMDTrainer" and got["mesh"] == world
    np.testing.assert_allclose(got["obs"].numpy(), ref.obs[rows], **TOL)
    np.testing.assert_allclose(got["episode_return"].numpy(), ref.episode_return[rows], **TOL)
    for name in ("obs", "action", "reward", "discount", "reset"):
        np.testing.assert_allclose(getattr(got["window"], name).numpy(),
                                   np.asarray(getattr(ref.window, name))[rows], **TOL,
                                   err_msg=name)
    for net in ("actor", "critic"):
        for x, y in zip(got["window"].carries[net], ref.window.carries[net], strict=True):
            np.testing.assert_allclose(x.numpy(), np.asarray(y)[rows], **TOL)
    np.testing.assert_allclose(got["priority"].numpy(), ref.arena.priority, **TOL)
    np.testing.assert_array_equal(got["meta"].numpy(), ref.arena.meta)
    np.testing.assert_allclose(got["arena_obs"].numpy(), ref.arena.data.obs, **TOL)
    assert got["cursor"] == int(ref.arena.cursor)
    assert got["env_steps"] == int(ref.env_steps) and got["phase_idx"] == int(ref.phase_idx)
    assert got["train"].step == int(ref.train.step)
    for name in ("actor_params", "critic_params", "target_actor_params",
                 "target_critic_params"):
        want = net_params_from_flax(getattr(ref.train, name))
        for k in want:
            np.testing.assert_allclose(getattr(got["train"], name)[k].numpy(),
                                       want[k].numpy(), **TOL, err_msg=f"{name}.{k}")
    assert set(got["metrics"]) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(got["metrics"][k]), float(metrics[k]), **TOL,
                                   err_msg=k)


SCHEDULES = [(False, 1), (True, 3)]  # (overlap_learner, learner_steps)


@pytest.mark.parametrize("overlap,learner_steps", SCHEDULES,
                         ids=["sequential", "overlap"])
def test_hybrid1_matches_jax(overlap, learner_steps):
    ref, metrics, draws, init_train = _jax_hybrid(1, overlap, learner_steps)
    got = run_port(make_mesh(1, "cpu"),
                   _tiny(WALKER_R2D2, overlap, learner_steps, **EXACT_ACTIONS),
                   draws, train_state_from_jax(init_train, "cpu"), build_overlap=overlap)
    _check_rank(got, ref, metrics, 1, 0)
    assert got["train"].step == learner_steps


WORLD_BODY = TINY_SRC + RUN_SRC + """
from r2d2dpg_torch.configs import WALKER_R2D2
inp = torch.load(os.path.join(OUT, "in.pt"), weights_only=False)
out = {}
for overlap, (ls, draws, train0) in inp.items():
    out[overlap] = run_port(mesh, _tiny(WALKER_R2D2, overlap, ls, **EXACT_ACTIONS),
                            draws, train0)
torch.save(out, os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


@pytest.mark.parametrize("world", [2, 4])
def test_hybrid_world_matches_jax_mesh(world, tmp_path):
    """D gloo ranks against JAX's trainer on a D-device mesh, overlap 0 and 1."""
    refs, inp = {}, {}
    for overlap, ls in SCHEDULES:
        ref, metrics, draws, init_train = _jax_hybrid(world, overlap, ls)
        refs[overlap] = (ref, metrics)
        inp[overlap] = (ls, draws, train_state_from_jax(init_train, "cpu"))
    torch.save(inp, tmp_path / "in.pt")
    outs = spawn_world(world, WORLD_BODY, tmp_path, timeout=600)
    for rank, out in enumerate(outs):
        for overlap, (ref, metrics) in refs.items():
            _check_rank(out[overlap], ref, metrics, world, rank)
    for overlap in refs:  # the replicated state is equal on every rank
        for out in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(out[overlap]["train"]), tree_leaves(outs[0][overlap]["train"])))
            assert torch.equal(out[overlap]["priority"], outs[0][overlap]["priority"])


# ------------------------------------------------------ world of one
def test_hybrid1_is_bitwise_the_plain_trainer():
    from r2d2dpg_torch.training.trainer import Trainer

    cfg = _tiny(WALKER_R2D2, learner_steps=2)
    plain, hybrid = cfg.build("cpu"), cfg.build_spmd(make_mesh(1, "cpu"), "cpu")
    assert type(plain) is Trainer and isinstance(hybrid, HostSPMDTrainer)
    n = plain.window_fill_phases + plain.replay_fill_phases + 3
    ref = plain.run(n, log_every=2, log_fn=lambda *_: None)
    got = hybrid.run(n, log_every=2, log_fn=lambda *_: None)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got.train),
                                                  tree_leaves(ref.train), strict=True))
    assert torch.equal(got.arena.priority, ref.arena.priority)
    assert torch.equal(got.obs, ref.obs) and got.env_steps == ref.env_steps
    assert torch.equal(got.window.obs, ref.window.obs)
    count, *_ = hybrid._obs_host_step.snapshot()
    assert count >= n * cfg.trainer.stride


def test_hybrid_lanes_take_their_rows_of_the_jax_ladder():
    from r2d2dpg_tpu.ops.noise import sigma_ladder as j_ladder
    from r2d2dpg_torch.parallel.mesh import Mesh

    cfg = _tiny(WALKER_R2D2)
    env = cfg.env_factory("cpu")
    tc = cfg.trainer
    want = np.asarray(j_ladder(tc.num_envs, sigma_max=tc.sigma_max, alpha=tc.ladder_alpha))
    for world in (1, 2, 4):
        e = tc.num_envs // world
        for rank in range(world):
            t = HostSPMDTrainer(env, cfg.build_agent(env), tc,
                                Mesh(size=world, rank=rank, device=torch.device("cpu")))
            np.testing.assert_array_equal(t.sigmas.numpy(), want[rank * e:(rank + 1) * e])
            assert t.config.num_envs == e and t.global_envs == tc.num_envs


def test_stand_in_env_drives_the_hybrid_bitwise_the_plain_trainer():
    """``HostStandInEnv`` (``chip_smoke.py``'s host env): walker-walk's
    spec, deterministic dynamics from its seed, episodes that end at the
    spec's length; the host-pool trainer on it is bitwise the plain
    ``Trainer``, as ``chip_smoke.py``'s ``hybrid1`` (a) holds on the card."""
    from r2d2dpg_torch.testing import HostStandInEnv, stand_in_factory
    from r2d2dpg_torch.training.draws import Draws

    env = HostStandInEnv(0, "cpu", episode_length=3)
    assert (env.spec.obs_shape, env.spec.action_dim) == ((24,), 6)
    assert HostStandInEnv(0, "cpu").spec.episode_length == 500
    _, ts = env.reset(2, Draws(1, "cpu"))
    assert ts.reset.tolist() == [1.0, 1.0]
    act = np.full((2, 6), 0.5, np.float32)
    steps = [env.host_step(act) for _ in range(3)]
    assert [s[3].tolist() for s in steps] == [[0, 0], [0, 0], [1, 1]]
    again = HostStandInEnv(0, "cpu", episode_length=3)
    again.reset(2, Draws(1, "cpu"))
    np.testing.assert_array_equal(again.host_step(act)[0], steps[0][0])
    other = again.host_step(-act)  # the action moves the next obs and reward
    assert not np.array_equal(other[0], steps[1][0]) and not np.array_equal(
        other[1], steps[1][1])
    cfg = dataclasses.replace(_tiny(WALKER_R2D2, learner_steps=2),
                              env_factory=stand_in_factory(0))
    plain, hybrid = cfg.build("cpu"), cfg.build_spmd(make_mesh(1, "cpu"), "cpu")
    n = plain.window_fill_phases + plain.replay_fill_phases + 2
    ref = plain.run(n, log_every=0)
    got = hybrid.run(n, log_every=0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got.train),
                                                  tree_leaves(ref.train), strict=True))
    assert torch.equal(got.arena.priority, ref.arena.priority)


# ------------------------------------------------ plain trainer, evaluator
def test_plain_trainer_on_walker_matches_jax():
    """JAX's plain Trainer steps the pool through an ordered io_callback
    inside its jitted collect; the port's calls it in its loop."""
    from r2d2dpg_tpu.configs import WALKER_R2D2 as J_WALKER
    from r2d2dpg_tpu.training.trainer import Trainer as JTrainer
    from r2d2dpg_torch.training.trainer import Trainer

    jt = _tiny(J_WALKER, **EXACT_ACTIONS).build()
    assert type(jt) is JTrainer
    cfg, a_dim = jt.config, jt.env.spec.action_dim
    k_env, _, _ = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    draws = [_t(jax.random.randint(k_env, (cfg.num_envs,), 0, 2**31 - 1), torch.int64)]
    js = _jax_init(jt)
    train0 = train_state_from_jax(jax.device_get(js.train), "cpu")
    for kind in _schedule(jt):
        rng, scan_key = jax.random.split(js.rng)  # Trainer._collect
        for key in jax.random.split(scan_key, cfg.stride):
            k_noise, _ = jax.random.split(key)
            draws.append(_t(jax.random.normal(k_noise, (cfg.num_envs, a_dim), jnp.float32)))
        if kind == "train":
            _, key = jax.random.split(rng)  # Trainer._learn
            for k in jax.random.split(key, cfg.learner_steps):
                draws.append(_t(jax.random.uniform(k, (cfg.batch_size,))))
        js = {"collect": jt.collect_phase, "fill": jt.fill_phase}.get(
            kind, lambda s: s)(js)
    js, jm = jt.train_phase(js)
    ref, metrics = jax.device_get(js), jax.device_get(jm)

    t = _tiny(WALKER_R2D2, **EXACT_ACTIONS).build("cpu")
    assert type(t) is Trainer
    rd = ReplayDraws(draws)
    s = t.init(rd)
    s = dataclasses.replace(s, train=train0, behavior_params={
        k: v.clone() for k, v in train0.actor_params.items()})
    for kind in _schedule(t)[:-1]:
        s = t.collect_phase(s) if kind == "collect" else t.fill_phase(s)
    s, m = t.train_phase(s)
    got = {"kind": "HostSPMDTrainer", "mesh": 1, "obs": s.obs, "window": s.window,
           "priority": s.arena.priority, "meta": s.arena.meta,
           "arena_obs": s.arena.data.obs, "cursor": s.arena.cursor, "train": s.train,
           "metrics": m, "left": rd.remaining(), "env_steps": s.env_steps,
           "phase_idx": s.phase_idx, "episode_return": s.episode_return}
    _check_rank(got, ref, metrics, 1, 0)


def test_evaluator_on_walker_matches_jax():
    from r2d2dpg_tpu.configs import WALKER_R2D2 as J_WALKER
    from r2d2dpg_tpu.training.evaluator import Evaluator as JEvaluator
    from r2d2dpg_torch.training.evaluator import Evaluator

    num_envs = 2
    jt = _tiny(J_WALKER).build()
    jactor = jt.agent.actor
    obs_dim = jt.env.spec.obs_shape[0]
    jparams = _zero_head(jactor.init(jax.random.PRNGKey(5), jnp.zeros((1, obs_dim)),
                                     jactor.initial_carry(1), jnp.zeros((1,))))
    key = jax.random.PRNGKey(9)
    jenv = J_WALKER.env_factory()
    want = JEvaluator(jenv, jactor, num_envs).run(jparams, key)
    assert jenv._pool._role == "eval"
    k_reset, _ = jax.random.split(key)
    seeds = _t(jax.random.randint(k_reset, (num_envs,), 0, 2**31 - 1), torch.int64)
    t = _tiny(WALKER_R2D2).build("cpu")
    env = WALKER_R2D2.env_factory("cpu")
    got = Evaluator(env, t.agent.actor, num_envs).run(
        net_params_from_flax(jax.device_get(jparams)), ReplayDraws([seeds]))
    assert env._pool._role == "eval"
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


# ----------------------------------------------------------- refusals
def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_hybrid_refusals_equal_jax():
    from r2d2dpg_tpu.agents import AgentConfig as JAgentConfig
    from r2d2dpg_tpu.agents import R2D2DPG as JAgent
    from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
    from r2d2dpg_tpu.configs import WALKER_R2D2 as J_WALKER
    from r2d2dpg_tpu.envs import Pendulum as JPendulum
    from r2d2dpg_tpu.models import ActorNet as JActor, CriticNet as JCritic
    from r2d2dpg_tpu.parallel import HostSPMDTrainer as JHybrid
    from r2d2dpg_tpu.parallel import make_mesh as jmesh
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.parallel.mesh import Mesh

    mesh = make_mesh(1, "cpu")
    cfg = _tiny(WALKER_R2D2)
    jcfg = _tiny(J_WALKER)
    # A tensor env.
    jagent = JAgent(JActor(action_dim=1, hidden=8), JCritic(hidden=8), JAgentConfig())
    want = _refusal(lambda: JHybrid(JPendulum(), jagent, jcfg.trainer, jmesh(1)))
    env = PENDULUM_TINY.env_factory("cpu")
    assert _refusal(lambda: HostSPMDTrainer(
        env, PENDULUM_TINY.build_agent(env), cfg.trainer, mesh)) == want
    # An agent that syncs over a named axis.
    jenv = jcfg.env_factory()
    want = _refusal(lambda: JHybrid(jenv, jcfg.build_agent(jenv, axis_name="dp"),
                                    jcfg.trainer, jmesh(1)))
    denv = cfg.env_factory("cpu")
    assert _refusal(lambda: HostSPMDTrainer(
        denv, cfg.build_agent(denv, axis_name="dp"), cfg.trainer, mesh)) == want
    # The mesh divides the batch (JAX's text); the port's process count is
    # its mesh size, so an indivisible fleet is JAX's per-host refusal.
    wide = Mesh(size=4, rank=0, device=torch.device("cpu"))
    bad_b = dataclasses.replace(cfg.trainer, batch_size=6)
    want = _refusal(lambda: JHybrid(jenv, jcfg.build_agent(jenv), dataclasses.replace(
        jcfg.trainer, batch_size=6), jmesh(4)))
    assert _refusal(lambda: HostSPMDTrainer(denv, cfg.build_agent(denv), bad_b, wide)) == want
    got = _refusal(lambda: HostSPMDTrainer(denv, cfg.build_agent(denv), dataclasses.replace(
        cfg.trainer, num_envs=6), wide))
    assert got == ("TrainerConfig.num_envs=6 must be divisible by the process count 4 "
                   "(one env pool per host, each owning num_envs/process_count envs)")
    # overlap_learner where no host-pool trainer runs: build, build_spmd,
    # build_dp_learner.
    jov = dataclasses.replace(J_TINY, trainer=dataclasses.replace(
        J_TINY.trainer, overlap_learner=True))
    pov = dataclasses.replace(PENDULUM_TINY, trainer=dataclasses.replace(
        PENDULUM_TINY.trainer, overlap_learner=True))
    assert _refusal(lambda: pov.build("cpu")) == _refusal(jov.build)
    assert _refusal(lambda: pov.build_spmd(mesh, "cpu")) == _refusal(
        lambda: jov.build_spmd(jmesh(1)))
    assert _refusal(lambda: pov.build_dp_learner(mesh, collect_local=False)) == _refusal(
        lambda: jov.build_dp_learner(jmesh(1), collect_local=False))


# ------------------------------------------------------------ pipeline
def test_pipeline_over_the_hybrid_at_world_size_1():
    from r2d2dpg_torch.parallel.mesh import Mesh
    from r2d2dpg_torch.training.pipeline import PipelineConfig, PipelineExecutor

    cfg = _tiny(WALKER_R2D2, learner_steps=2)
    quiet = dict(log_every=2, log_fn=lambda *_: None)
    t = cfg.build_spmd(make_mesh(1, "cpu"), "cpu")
    n = t.window_fill_phases + t.replay_fill_phases + 3
    ref = t.run(n, **quiet)
    off = PipelineExecutor(cfg.build_spmd(make_mesh(1, "cpu"), "cpu"),
                           PipelineConfig(enabled=False)).run(n, **quiet)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(off.train),
                                                  tree_leaves(ref.train), strict=True))
    assert torch.equal(off.arena.priority, ref.arena.priority)
    lines = []
    ex = PipelineExecutor(cfg.build_spmd(make_mesh(1, "cpu"), "cpu"),
                          PipelineConfig(queue_depth=2))
    assert all(a is not b for a, b in zip(ex.collector_nets,
                                          (ex.trainer.agent.actor, ex.trainer.agent.critic)))
    got = ex.run(n, log_every=2, log_fn=lines.append)
    tc = cfg.trainer
    assert (got.phase_idx, got.env_steps, got.train.step) == (
        n, n * tc.stride * tc.num_envs, 3 * tc.learner_steps)
    assert got.arena.total_added == (n - t.window_fill_phases) * tc.num_envs
    assert bool(torch.isfinite(got.arena.priority).all())
    assert all(torch.isfinite(x).all() for x in tree_leaves(got.train))
    stats = ex.stats()
    assert stats["train_phases"] == 3 and 0.0 <= stats["overlap_fraction"] <= 1.0
    assert ex.trainer._obs_host_step.count >= n * tc.stride
    assert ex.param_versions == [0, 0, 0] and ex.version_waits == 0
    # At a world of 2 the collector calls no collective, so the executor
    # takes the trainer (tests/test_torch_hybrid_pipeline.py runs it).
    two = HostSPMDTrainer(t.env, cfg.build_agent(t.env), cfg.trainer,
                          Mesh(size=2, rank=0, device=torch.device("cpu")))
    assert PipelineExecutor(two).trainer is two
