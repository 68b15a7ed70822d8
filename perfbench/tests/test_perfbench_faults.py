"""A run whose timed path is broken underneath comes out not correct: each
fault a cell can have is planted in the program at toy size on the CPU
and the rest of the run goes as on the card.  (No cell exchanges data
between chips, so that fault has no cell here.)"""

import numpy as np
import pytest
import torch

from perfbench.tests import tiny

CONF = None


def _conf():
    global CONF
    CONF = CONF or tiny.config_file("pendulum_tiny")
    return CONF


def _unchanged_state(monkeypatch):
    from r2d2dpg_torch.agents.ddpg import R2D2DPG

    real = R2D2DPG.learner_step

    def step(self, state, batch, w, normal=None):
        _, prio, metrics = real(self, state, batch, w, normal)
        return state, prio, metrics

    monkeypatch.setattr(R2D2DPG, "learner_step", step)


def _half_batch(monkeypatch):
    from r2d2dpg_torch.agents.ddpg import R2D2DPG
    from r2d2dpg_torch.tree import tree_map

    real = R2D2DPG.learner_step

    def step(self, state, batch, w, normal=None):
        half = w.shape[0] // 2
        new, prio, metrics = real(self, state, tree_map(lambda x: x[:half], batch), w[:half],
                                  normal)
        return new, torch.cat([prio, prio])[: w.shape[0]], metrics

    monkeypatch.setattr(R2D2DPG, "learner_step", step)


def _half_sample(monkeypatch):
    """The batch drawn at half its size: the update then averages over the
    half it has, whatever the reference is handed."""
    from r2d2dpg_torch.training.trainer import Trainer

    def sample(self, arena, draws):
        b = self.config.batch_size // 2
        return self.arena.sample(arena, b, uniforms=draws.uniform((b,)))

    monkeypatch.setattr(Trainer, "_sample", sample)


def _index_altered(monkeypatch):
    import dataclasses

    from r2d2dpg_torch.replay.arena import ReplayArena
    from r2d2dpg_torch.tree import tree_map

    real = ReplayArena.sample

    def sample(self, state, batch_size, **kw):
        res = real(self, state, batch_size, **kw)
        idx = res.indices.clone()
        idx[0] = (idx[0] + 1) % self.size(state)
        return dataclasses.replace(res, indices=idx,
                                   batch=tree_map(lambda buf: buf[idx], state.data))

    monkeypatch.setattr(ReplayArena, "sample", sample)


def _action_altered_in_collection(monkeypatch):
    from r2d2dpg_torch.training.trainer import Trainer

    real = Trainer._policy_step

    def step(self, *args):
        action, *rest = real(self, *args)
        action = action.clone()
        action[0, 0] += 0.01
        return (action, *rest)

    monkeypatch.setattr(Trainer, "_policy_step", step)


TRAINING = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
            "half_sample": _half_sample, "index_altered": _index_altered}


TRAINING_CASES = [(k, f) for k in ("learn", "train") for f in sorted(TRAINING)]
TRAINING_CASES.append(("train", "action_altered"))  # the learn loop collects no actions


@pytest.mark.parametrize("kind,fault", TRAINING_CASES)
def test_training_faults_come_out_not_correct(monkeypatch, kind, fault):
    (TRAINING.get(fault) or _action_altered_in_collection)(monkeypatch)
    _, _, out = tiny.run(tiny.cell(kind, _conf()), seed=21)
    assert not out["correct"], out["checks"]


def _serve_action_altered(monkeypatch):
    from r2d2dpg_torch.serving.service import PolicyService

    real = PolicyService.policy_step

    def step(self, slots, resets, obs):
        out = real(self, slots, resets, obs).copy()
        out[0, 0] += 0.01
        return out

    monkeypatch.setattr(PolicyService, "policy_step", step)


def _serve_unchanged_state(monkeypatch):
    import r2d2dpg_torch.serving.service as service

    monkeypatch.setattr(service, "scatter_carries", lambda slabs, slots, carries: None)


def _serve_half_batch(monkeypatch):
    from r2d2dpg_torch.serving.service import PolicyService

    real = PolicyService.policy_step

    def step(self, slots, resets, obs):
        half = max(len(slots) // 2, 1)
        out = real(self, slots[:half], resets[:half], obs[:half])
        rest = np.repeat(out.mean(0, keepdims=True), len(slots) - half, 0)
        return np.concatenate([out, rest])

    monkeypatch.setattr(PolicyService, "policy_step", step)


SERVING = {"action_altered": _serve_action_altered, "unchanged_state": _serve_unchanged_state,
           "half_batch": _serve_half_batch}


@pytest.mark.parametrize("fault", sorted(SERVING))
def test_serving_faults_come_out_not_correct(monkeypatch, fault):
    SERVING[fault](monkeypatch)
    c = tiny.cell("serve", _conf(), rate_per_s=800, warmup_s=0.1)
    _, _, out = tiny.run(c, seed=4, seconds=0.3)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["learn", "train", "serve"])
def test_the_sound_run_is_correct(kind):
    kw = {"rate_per_s": 800, "warmup_s": 0.1} if kind == "serve" else {}
    _, _, out = tiny.run(tiny.cell(kind, _conf(), **kw), seed=21, seconds=0.3)
    assert out["correct"], out["checks"]
