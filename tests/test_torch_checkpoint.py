"""The port's checkpoints: round trip, manager semantics, resume, and a bridge from JAX.

Every comparison here is bitwise (a checkpoint copies values): the round
trip of a whole pendulum_tiny ``TrainerState``; a full resume, where k
train phases, a save, a resume through the train CLI and m more phases
equal k + m phases run straight through, for every param, the arena, the
window, the env state, the draws generator and the counters.  Also the
manager's rules (cadence, same-step overwrite, ``save_final`` skip,
``max_to_keep`` pruning, the light/full layout guards, leftover
``.tmp-*`` directories ignored), one ``ValueError`` naming mismatched
leaves, and a JAX light checkpoint restored by the JAX package, converted,
saved by the port and restored to params equal to the JAX ones.
"""

import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
from r2d2dpg_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
from r2d2dpg_tpu.utils.checkpoint import abstract_template
from r2d2dpg_tpu.utils.checkpoint import restore_subtree as j_restore_subtree
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.convert import net_params_from_flax, train_state_from_jax
from r2d2dpg_torch.train import main as train_main
from r2d2dpg_torch.utils.checkpoint import (
    LIGHT_MARKER,
    CheckpointManager,
    latest_step,
    restore_subtree,
    resume_state,
    to_tree,
)


def flat(tree, path=""):
    """``to_tree`` output as {path: leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{path}/{i}"))
        return out
    return {path: tree}


def assert_same(a, b):
    fa, fb = flat(to_tree(a)), flat(to_tree(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


@pytest.fixture(scope="module")
def trained():
    """pendulum_tiny after warm-up, fill and one train phase (CPU)."""
    trainer = PENDULUM_TINY.build("cpu")
    fill = trainer.window_fill_phases + trainer.replay_fill_phases
    return trainer, trainer.run(fill + 1, log_every=0)


def test_full_round_trip_is_bitwise(tmp_path, trained):
    trainer, state = trained
    ckpt = CheckpointManager(str(tmp_path / "full"), save_every=2)
    assert not ckpt.maybe_save(3, state)
    assert ckpt.maybe_save(4, state)
    assert ckpt.latest_step == 4
    assert sorted(os.listdir(tmp_path / "full" / "4")) == sorted(
        f"{f.name}.pt" for f in dataclasses.fields(state))
    restored = resume_state(trainer, ckpt)
    assert_same(restored, state)
    # The draws continue where the saved run's did.
    assert torch.equal(restored.draws.uniform((4,)), state.draws.uniform((4,)))


def test_light_round_trip_and_subtree_restore(tmp_path, trained):
    trainer, state = trained
    ckpt = CheckpointManager(str(tmp_path / "light"), save_every=1, light=True)
    ckpt.save(1, state)
    assert os.listdir(tmp_path / "light" / "1") == ["train.pt"]
    resumed = resume_state(trainer, ckpt)
    assert_same(resumed.train, state.train)
    assert resumed.phase_idx == 0 and trainer.arena.size(resumed.arena) == 0
    meta = trainer.agent.init(torch.Generator().manual_seed(0), "meta")
    out, step = restore_subtree(str(tmp_path / "light"),
                                {"train": {"actor_params": meta.actor_params}},
                                device="cpu")
    assert step == 1
    assert_same(out["train"]["actor_params"], state.train.actor_params)


def test_manager_rules(tmp_path, trained):
    _, state = trained
    d = str(tmp_path / "ck")
    ckpt = CheckpointManager(d, save_every=1, max_to_keep=2, light=True)
    for step in (1, 2, 3):
        ckpt.save(step, state)
    assert ckpt.all_steps() == [2, 3]  # pruned to max_to_keep
    bumped = dataclasses.replace(
        state, train=dataclasses.replace(state.train, step=state.train.step + 7))
    ckpt.save(3, bumped)  # same step: replaced
    out, _ = restore_subtree(d, {"train": {"step": 0}})
    assert out["train"]["step"] == state.train.step + 7
    ckpt.save_final(3, state)  # already saved: a no-op
    out, _ = restore_subtree(d, {"train": {"step": 0}})
    assert out["train"]["step"] == state.train.step + 7
    os.makedirs(os.path.join(d, "9.tmp-12345"))  # a save that died
    assert latest_step(d) == 3
    assert os.path.exists(os.path.join(d, LIGHT_MARKER))
    with pytest.raises(ValueError, match="LIGHT"):
        CheckpointManager(d).save(4, state)
    full = str(tmp_path / "full")
    CheckpointManager(full, save_every=1).save(1, state)
    with pytest.raises(ValueError, match="FULL"):
        CheckpointManager(full, light=True).save(2, state)
    with pytest.raises(FileNotFoundError):
        restore_subtree(str(tmp_path / "empty"), {"train": {}})


def test_mismatched_leaves_raise_with_their_names(tmp_path, trained):
    trainer, state = trained
    d = str(tmp_path / "ck")
    CheckpointManager(d, save_every=1, light=True).save(1, state)
    twin_cfg = dataclasses.replace(
        PENDULUM_TINY, agent=dataclasses.replace(PENDULUM_TINY.agent, twin_critic=True))
    twin = twin_cfg.build("cpu").agent.init(torch.Generator().manual_seed(0), "meta")
    with pytest.raises(ValueError, match="mismatched") as e:
        restore_subtree(d, {"train": twin}, device="cpu")
    assert "train/critic_params/core.cell.wi (checkpoint float32[128, 32] vs " \
        "expected float32[2, 128, 32])" in str(e.value)
    wide = dataclasses.replace(PENDULUM_TINY, hidden=64).build("cpu")
    with pytest.raises(ValueError, match="train/actor_params/head.weight"):
        restore_subtree(d, {"train": wide.agent.init(None, "meta")}, device="cpu")
    with pytest.raises(ValueError, match="1 leaves missing: train/nothing_here"):
        restore_subtree(d, {"train": {"nothing_here": torch.zeros(1)}})
    # The port's bf16 cell keeps float32's param tree (unlike the JAX
    # package's), so a bf16 learner restores a float32 checkpoint as it is.
    bf16 = dataclasses.replace(PENDULUM_TINY, compute_dtype="bfloat16").build("cpu")
    out, _ = restore_subtree(d, {"train": bf16.agent.init(None, "meta")}, device="cpu")
    assert_same(out["train"], state.train)


def test_full_resume_through_the_cli_is_bit_exact(tmp_path):
    """3 train phases, saved; --resume and 2 more == 5 straight through."""
    common = ["--config", "pendulum_tiny", "--device", "cpu", "--log-every", "0"]
    d = str(tmp_path / "ck")
    first = train_main(common + ["--phases", "3", "--checkpoint-dir", d,
                                 "--checkpoint-every", "-1"])
    assert latest_step(d) == first.phase_idx == 7
    resumed = train_main(common + ["--phases", "2", "--checkpoint-dir", d, "--resume"])
    straight = train_main(common + ["--phases", "5"])
    assert resumed.phase_idx == straight.phase_idx == 9
    assert resumed.train.step == 5
    assert latest_step(d) == 9
    assert_same(resumed, straight)


def test_jax_light_checkpoint_bridges_to_the_port(tmp_path):
    """JAX save -> JAX restore_subtree -> convert -> port save -> port restore."""
    jstate = J_TINY.build().init()
    jdir = str(tmp_path / "jax")
    jm = JCheckpointManager(jdir, save_every=1, light=True)
    jm.save(5, jstate)
    jm.wait()
    jm.close()
    out, step = j_restore_subtree(jdir, {"train": abstract_template(jstate.train)})
    host = jax.device_get(out["train"])
    port_train = train_state_from_jax(host, "cpu")
    pdir = str(tmp_path / "port")
    CheckpointManager(pdir, save_every=1, light=True).save(
        step, types.SimpleNamespace(train=port_train))
    meta = PENDULUM_TINY.build("cpu").agent.init(None, "meta")
    got, pstep = restore_subtree(pdir, {"train": meta}, device="cpu")
    assert pstep == 5
    want = net_params_from_flax(jax.device_get(jstate.train.actor_params))
    for k, v in want.items():
        np.testing.assert_array_equal(got["train"].actor_params[k].numpy(), v.numpy())
    want = net_params_from_flax(jax.device_get(jstate.train.critic_params))
    for k, v in want.items():
        np.testing.assert_array_equal(got["train"].critic_params[k].numpy(), v.numpy())
    assert got["train"].step == int(jstate.train.step)
