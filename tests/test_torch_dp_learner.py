"""Port parity: ``DPLearnerTrainer`` and the capacity-block arena.

JAX's dp learner cannot run at D >= 2 with this box's jax (its ring add on
the dp-sharded arena raises ``ShardingTypeError``), so the port's
``DPLearnerTrainer`` is held against the port's single-device ``Trainer``,
which ``tests/test_torch_trainer.py`` holds against JAX's:

- D = 2 and D = 4 gloo processes against ``Trainer.run`` at pendulum_tiny
  (warm-up, fill, 6 train phases, the same seed: the draws are replicated,
  so both make the same draws): every learner step's sampled indices
  (exact), its probabilities (atol 1e-6), the params and the arena
  priorities at the end (atol 1e-5, rtol 1e-4: a rank's learner step
  sums over its ``B/D`` rows, then the gradient average over the ranks).
- The block write-back with indices repeated across ranks' blocks and
  within a batch, against JAX's ``.at[idx].set`` on the whole vector
  (exact: the kernel path only copies values; on the CPU the wrapper runs
  the plain version).
- A world of one is bitwise the plain ``Trainer``: the class, the train
  CLI (whose ``topology:`` line equals JAX's ``describe()``), and the fleet
  drain body (``drain_staged`` through ``_put_staged``).
  ``r2d2dpg_dp_shard_occupancy{shard="0"}`` reads the arena's size.
- The refusals carry JAX's messages; ``per_shard_occupancy`` equals JAX's.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.parallel import DP_AXIS, DPLearnerTrainer, make_mesh
from r2d2dpg_torch.parallel.mesh import Mesh
from test_torch_parallel import _leaves_equal, spawn_world

K_TRAIN = 6
WB_CAPACITY = 16
# Global write-back batch: repeats inside one block and across blocks.
WB_INDICES = [3, 12, 3, 0, 12, 15, 7, 3]
WB_VALUES = [0.5 + i for i in range(8)]


def _recording(trainer):
    """Record each learner step's sampled (indices, probs)."""
    seen = []
    sample = trainer._sample

    def rec(arena, draws):
        res = sample(arena, draws)
        seen.append((res.indices.clone(), res.probs.clone()))
        return res

    trainer._sample = rec
    return seen


DP_BODY = inspect.getsource(_recording) + f"""
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.replay.arena import CapacityBlockArena, SequenceBatch
t = PENDULUM_TINY.build_dp_learner(mesh, True, "cpu")
seen = _recording(t)
st = t.run(t.window_fill_phases + t.replay_fill_phases + {K_TRAIN}, log_every=2,
           log_fn=lambda *_: None)
arena = CapacityBlockArena({WB_CAPACITY}, mesh)
ex = SequenceBatch(obs=torch.zeros(1, 2, 3), action=torch.zeros(1, 2, 1),
                   reward=torch.zeros(1, 2), discount=torch.zeros(1, 2),
                   reset=torch.zeros(1, 2), carries={{}})
wb = arena.init_state(ex)
wb.priority.copy_(torch.arange(arena.lo, arena.lo + arena.block, dtype=torch.float32) + 100)
values = torch.tensor({WB_VALUES})[mesh.block({len(WB_VALUES)})]
arena.update_priorities(wb, torch.tensor({WB_INDICES}), values)
torch.save({{"train": st.train, "priority": st.arena.priority, "seen": seen,
            "block": wb.priority, "size": arena.block,
            "occupancy": t._log_extra_refs(st.arena)[0]}},
           os.path.join(OUT, f"rank{{mesh.rank}}.pt"))
"""


@pytest.fixture(scope="module")
def plain_run():
    t = PENDULUM_TINY.build("cpu")
    seen = _recording(t)
    st = t.run(t.window_fill_phases + t.replay_fill_phases + K_TRAIN, log_every=2,
               log_fn=lambda *_: None)
    return st, seen


@pytest.mark.parametrize("world", [2, 4])
def test_dp_learner_matches_the_single_device_trainer(world, plain_run, tmp_path):
    ref, ref_seen = plain_run
    outs = spawn_world(world, DP_BODY, tmp_path)
    for out in outs:
        assert len(out["seen"]) == len(ref_seen) == K_TRAIN
        for (idx, probs), (ridx, rprobs) in zip(out["seen"], ref_seen):
            assert torch.equal(idx, ridx)
            np.testing.assert_allclose(probs.numpy(), rprobs.numpy(), atol=1e-6)
        for name in ("actor_params", "critic_params", "target_actor_params",
                     "target_critic_params"):
            for k, v in getattr(ref.train, name).items():
                np.testing.assert_allclose(getattr(out["train"], name)[k].numpy(),
                                           v.numpy(), atol=1e-5, rtol=1e-4,
                                           err_msg=f"{name}.{k}")
        assert out["train"].step == ref.train.step
    # The params stay replicated; the blocks tile the single arena.
    assert all(_leaves_equal(o["train"], outs[0]["train"]) for o in outs[1:])
    prio = torch.cat([o["priority"] for o in outs])
    np.testing.assert_allclose(prio.numpy(), ref.arena.priority.numpy(),
                               atol=1e-5, rtol=1e-4)
    occ = (ref.arena.priority.reshape(world, -1) > 0).sum(1)
    for o in outs:
        assert torch.equal(o["occupancy"], occ)
    # The block write-back: last write wins in global batch order.
    start = jnp.arange(WB_CAPACITY, dtype=jnp.float32) + 100
    want = np.asarray(start.at[jnp.asarray(WB_INDICES)].set(jnp.asarray(WB_VALUES)))
    got = torch.cat([o["block"] for o in outs]).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ world of one
def test_dp1_is_bitwise_the_plain_trainer_and_publishes_occupancy(plain_run):
    from r2d2dpg_torch.obs import get_registry

    ref, ref_seen = plain_run
    t = PENDULUM_TINY.build_dp_learner(make_mesh(1, "cpu"), True, "cpu")
    seen = _recording(t)
    st = t.run(t.window_fill_phases + t.replay_fill_phases + K_TRAIN, log_every=2,
               log_fn=lambda *_: None)
    assert _leaves_equal(st.train, ref.train)
    assert torch.equal(st.arena.priority, ref.arena.priority)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(seen, ref_seen))
    gauge = get_registry().get("r2d2dpg_dp_shard_occupancy")
    assert gauge.labels(shard="0").value == float(t.arena.size(st.arena))


def test_dp1_cli_is_bitwise_the_plain_cli(capsys):
    from r2d2dpg_tpu import topology as jtopology
    from r2d2dpg_tpu import train as jtrain
    from r2d2dpg_torch import train

    argv = ["--config", "pendulum_tiny", "--phases", "3", "--log-every", "2",
            "--device", "cpu"]
    ref = train.main(argv)
    capsys.readouterr()
    got = train.main(argv + ["--learner-dp", "1"])
    lines = capsys.readouterr().out.splitlines()
    want = jtopology.resolve(jtrain.parse_args(
        ["--config", "pendulum_tiny", "--learner-dp", "1"])).describe()
    assert lines[1] == f"topology: {want}"
    assert _leaves_equal(got.train, ref.train)
    assert torch.equal(got.arena.priority, ref.arena.priority)


def test_dp1_fleet_drain_is_bitwise_the_plain_drain():
    """The fleet's drain body (absorb, then drain-learn) through
    ``_put_staged`` at a world of one."""
    from r2d2dpg_torch.replay import StagedSequences
    from r2d2dpg_torch.training.assembler import emit
    from r2d2dpg_torch.training.pipeline import LearnerState, drain_staged

    src = PENDULUM_TINY.build("cpu")
    filled = src.run(src.window_fill_phases, log_every=0)
    staged = StagedSequences(seq=emit(filled.window))
    outs = []
    for t in (PENDULUM_TINY.build("cpu"),
              PENDULUM_TINY.build_dp_learner(make_mesh(1, "cpu"), False, "cpu")):
        st = t.init()
        ls = LearnerState(train=st.train, arena=st.arena, draws=st.draws)
        for i in range(5):
            ls, _ = drain_staged(t, ls, t._put_staged(staged), learn=i >= 2)
        outs.append(ls)
    assert _leaves_equal(outs[0].train, outs[1].train) and outs[1].train.step == 3
    assert torch.equal(outs[0].arena.priority, outs[1].arena.priority)


def test_put_staged_widths_and_axes():
    t = PENDULUM_TINY.build_dp_learner(make_mesh(1, "cpu"), False, "cpu")
    seqs = {"obs": torch.zeros(2, 8, 3)}
    assert t._put_staged(seqs, axis=1)["obs"].shape == (2, 8, 3)
    assert t._put_staged(seqs)["obs"] is seqs["obs"]
    three = dataclasses.replace(t.mesh, size=3)
    fake = type("T", (), {"num_devices": 3, "mesh": three})()
    with pytest.raises(ValueError, match="staged width 8 does not divide the 3-device mesh"):
        DPLearnerTrainer._put_staged(fake, {"obs": torch.zeros(8, 3)})
    # A world of 2: rank r keeps columns [4r, 4r + 4) of the batch axis.
    obs = torch.arange(48.0).reshape(2, 8, 3)
    for r in range(2):
        two = type("T", (), {"num_devices": 2,
                             "mesh": dataclasses.replace(t.mesh, size=2, rank=r)})()
        got = DPLearnerTrainer._put_staged(two, {"obs": obs}, axis=1)["obs"]
        assert torch.equal(got, obs[:, 4 * r:4 * r + 4])


def test_dp_refusals_and_occupancy_equal_jax():
    from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
    from r2d2dpg_tpu.parallel import DPLearnerTrainer as JDP, make_mesh as jmesh
    from r2d2dpg_tpu.replay.arena import ReplayArena as JArena
    from r2d2dpg_torch.replay import ReplayArena

    jenv = J_TINY.env_factory()
    env = PENDULUM_TINY.env_factory("cpu")

    def both(jfn, fn):
        with pytest.raises(ValueError) as j:
            jfn()
        with pytest.raises(ValueError) as p:
            fn()
        assert str(p.value) == str(j.value)

    both(lambda: JDP(jenv, J_TINY.build_agent(jenv, axis_name=DP_AXIS), J_TINY.trainer,
                     jmesh(1)),
         lambda: DPLearnerTrainer(env, PENDULUM_TINY.build_agent(env, DP_AXIS),
                                  PENDULUM_TINY.trainer, make_mesh(1, "cpu")))
    wide = Mesh(size=8, rank=0, device=torch.device("cpu"))
    for field, v in (("capacity", 100), ("batch_size", 12), ("num_envs", 6)):
        jcfg = dataclasses.replace(J_TINY.trainer, **{field: v})
        cfg = dataclasses.replace(PENDULUM_TINY.trainer, **{field: v})
        both(lambda: JDP(jenv, J_TINY.build_agent(jenv), jcfg, jmesh(8)),
             lambda: DPLearnerTrainer(env, PENDULUM_TINY.build_agent(env), cfg, wide))
    prio = np.zeros(12, np.float32)
    prio[[0, 1, 5, 11]] = 1.0
    jstate = type("S", (), {"priority": jnp.asarray(prio)})()
    pstate = type("S", (), {"priority": torch.tensor(prio)})()
    for n in (1, 3, 4):
        np.testing.assert_array_equal(
            ReplayArena(12).per_shard_occupancy(pstate, n).numpy(),
            np.asarray(JArena(12).per_shard_occupancy(jstate, n)))
    both(lambda: JArena(12).per_shard_occupancy(jstate, 5),
         lambda: ReplayArena(12).per_shard_occupancy(pstate, 5))
