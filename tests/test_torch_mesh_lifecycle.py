"""The run's lifecycle in a world of D ranks: checkpoints, resume, evals.

Held at pendulum_tiny with gloo child processes (``spawn_world``, each
world under a timeout):

- **Bitwise resume.**  At D = 2, ``train.main --phases 4`` with a
  checkpoint every 2 phases, then ``--resume --phases 2``, ends bitwise on
  the uninterrupted ``--phases 6`` run on every rank (params, the rank's
  arena priorities and window, its env state and its draw stream), for
  ``--spmd 2`` and for ``--learner-dp 2``.
- **The global layout.**  The ``--spmd 2`` checkpoint (and
  ``global_state``, the same tree) of the state after
  one train phase (each rank given its slice of JAX's state after warm-up
  and fill, and JAX's per-device draws of the phase, as in
  ``tests/test_torch_parallel.py``) holds JAX ``SPMDTrainer``'s global
  state on a 2-device CPU mesh: every leaf of every field but the draws
  within atol 1e-5, rtol 1e-4 (that test's tolerance), the counters exact.
- **Cross-size resume.**  The ``--learner-dp 2`` checkpoint restores at
  D = 1 with every leaf equal to the saved global one (exact); the
  ``--spmd 2`` one refuses at D = 1 (``--spmd 1`` and the plain trainer)
  with a message naming both world sizes.
- **Eval.**  At D = 2 (``--spmd`` and ``--learner-dp``), rank 0 prints
  exactly one ``eval`` line per cadence and rank 1 none; each equals an
  ``Evaluator`` run with the same draws (``Draws(seed + 1)``, in order) on
  the params rank 0 evaluated, and the last of those equal the final
  params of both ranks (exact).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.parallel import make_mesh
from r2d2dpg_torch.utils.checkpoint import CheckpointManager, resume_state, to_tree
from test_torch_parallel import _leaves_equal, _rank_draws, _rank_slice, spawn_world

TOL = dict(atol=1e-5, rtol=1e-4)

RESUME_BODY = """
from r2d2dpg_torch import train
base = ["--config", "pendulum_tiny", "--log-every", "0", "--device", "cpu"]
out = {}
for name, flag in (("spmd", "--spmd"), ("dp", "--learner-dp")):
    ck = os.path.join(OUT, "ck_" + name)
    whole = train.main(base + [flag, "2", "--phases", "6"])
    train.main(base + [flag, "2", "--phases", "4", "--checkpoint-dir", ck,
                       "--checkpoint-every", "2"])
    resumed = train.main(base + [flag, "2", "--phases", "2", "--checkpoint-dir", ck,
                                 "--resume", "--checkpoint-every", "0"])
    out[name] = [{"train": s.train, "arena": s.arena, "window": s.window,
                  "env_state": s.env_state, "phase_idx": s.phase_idx,
                  "draws": s.draws.generator.get_state()} for s in (whole, resumed)]
torch.save(out, os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    out = tmp_path_factory.mktemp("resume")
    return out, spawn_world(2, RESUME_BODY, out, timeout=240)


@pytest.mark.parametrize("name", ["spmd", "dp"])
def test_save_resume_continue_is_bitwise_the_whole_run(name, resumed):
    _, outs = resumed
    for rank, out in enumerate(outs):
        whole, got = out[name]
        assert got["phase_idx"] == whole["phase_idx"]
        assert got["train"].step == whole["train"].step
        assert _leaves_equal(got["train"], whole["train"]), f"rank {rank}"
        for field in ("arena", "window", "env_state"):
            assert _leaves_equal(got[field], whole[field]), f"rank {rank} {field}"
        assert torch.equal(got["draws"], whole["draws"]), f"rank {rank}"
    # The spmd ranks draw their own streams; the dp ranks one replicated one.
    differ = not torch.equal(outs[0][name][0]["draws"], outs[1][name][0]["draws"])
    assert differ == (name == "spmd")


def _load_step(directory):
    ckpt = CheckpointManager(str(directory))
    step = os.path.join(ckpt.directory, str(ckpt.latest_step))
    return {f[:-3]: torch.load(os.path.join(step, f), weights_only=True)
            for f in os.listdir(step)}


def _assert_tree(got, want, path="", exact=False):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree(got[k], want[k], f"{path}/{k}", exact)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree(g, w, f"{path}/{i}", exact)
    elif isinstance(want, torch.Tensor):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if exact or not want.is_floating_point():
            assert torch.equal(got, want), path
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL, err_msg=path)
    else:
        assert got == want, path


def test_dp2_checkpoint_restores_at_world_one(resumed):
    out, _ = resumed
    saved = _load_step(out / "ck_dp")
    t = PENDULUM_TINY.build_dp_learner(make_mesh(1, "cpu"), True, "cpu")
    st = resume_state(t, CheckpointManager(str(out / "ck_dp")))
    for f in dataclasses.fields(st):
        _assert_tree(to_tree(getattr(st, f.name)), saved[f.name], f.name, exact=True)
    # The global arena: both ranks' blocks, capacity 256.
    assert saved["arena"]["priority"].shape == (PENDULUM_TINY.trainer.capacity,)


def test_spmd2_checkpoint_refuses_another_world_size(resumed):
    out, _ = resumed
    ckpt = CheckpointManager(str(out / "ck_spmd"))
    assert ckpt.saved_draw_streams() == 2
    for t in (PENDULUM_TINY.build_spmd(make_mesh(1, "cpu"), "cpu"),
              PENDULUM_TINY.build("cpu")):
        with pytest.raises(ValueError, match="saved at world size 2 .* this run has "
                                             "world size 1"):
            resume_state(t, ckpt)


LAYOUT_BODY = """
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.training.draws import Draws
from r2d2dpg_torch.utils.checkpoint import CheckpointManager, to_tree
t = PENDULUM_TINY.build_spmd(mesh, "cpu")
inp = torch.load(os.path.join(OUT, f"in{mesh.rank}.pt"), weights_only=False)
state, _ = t.train_phase(inp)
assert inp.draws.remaining() == 0
# The recorded draws are spent; a generator stands in for the save.
state = dataclasses.replace(state, draws=Draws(0, "cpu").fold(mesh.rank))
CheckpointManager(os.path.join(OUT, "ck")).save(state.phase_idx, state, trainer=t)
glob = t.global_state(state)  # the same gathers, in one tree (None off rank 0)
torch.save({"gen": state.draws.generator.get_state(),
            "global": None if glob is None else to_tree(glob)},
           os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


def test_spmd2_checkpoint_is_jax_global_state(tmp_path):
    import jax

    from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
    from r2d2dpg_tpu.parallel import make_mesh as jmesh
    from r2d2dpg_torch.convert import trainer_state_from_jax
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
    for d in range(world):
        dr = _rank_draws(js.rng, d, jt.config, jt.env.spec.action_dim)
        torch.save(trainer_state_from_jax(_rank_slice(host, d, world, cap),
                                          ReplayDraws(dr), device="cpu"),
                   tmp_path / f"in{d}.pt")
    js, _ = jt.train_phase(js)
    ref = trainer_state_from_jax(jax.device_get(js), None, device="cpu")
    outs = spawn_world(world, "import dataclasses\n" + LAYOUT_BODY, tmp_path, timeout=180)

    saved = _load_step(tmp_path / "ck")
    assert set(saved) == {f.name for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(ref):
        if f.name != "draws":
            _assert_tree(saved[f.name], to_tree(getattr(ref, f.name)), f.name)
    assert saved["arena"]["data"]["obs"].shape[0] == cap
    assert saved["obs"].shape[0] == J_TINY.trainer.num_envs
    # global_state is what the save wrote (rank 0), and nothing elsewhere.
    assert outs[1]["global"] is None
    _assert_tree(saved, outs[0]["global"], "global_state", exact=True)
    # One generator state per rank, in rank order, and the world size.
    assert saved["draws"]["world_size"] == world
    for d in range(world):
        assert torch.equal(saved["draws"]["generator_states"][d], outs[d]["gen"])


EVAL_BODY = """
import contextlib, copy, io
from r2d2dpg_torch import train
from r2d2dpg_torch.training.evaluator import Evaluator
seen = []
plain_run = Evaluator.run


def run(self, params, draws):
    seen.append(copy.deepcopy(params))
    return plain_run(self, params, draws)


Evaluator.run = run
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    st = train.main(["--config", "pendulum_tiny", os.environ["FLAG"], "2", "--phases", "4",
                     "--eval-every", "2", "--eval-envs", "4", "--log-every", "0",
                     "--device", "cpu"])
torch.save({"lines": buf.getvalue().splitlines(), "seen": seen,
            "actor": st.train.actor_params}, os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


@pytest.mark.parametrize("flag", ["--spmd", "--learner-dp"])
def test_eval_runs_on_rank0_once_per_cadence(flag, tmp_path, monkeypatch):
    from r2d2dpg_torch.training.draws import Draws
    from r2d2dpg_torch.training.evaluator import Evaluator

    monkeypatch.setenv("FLAG", flag)
    outs = spawn_world(2, EVAL_BODY, tmp_path, timeout=180)
    evals = [json.loads(x[5:]) for x in outs[0]["lines"] if x.startswith("eval ")]
    t = PENDULUM_TINY.build("cpu")
    fill = t.window_fill_phases + t.replay_fill_phases
    assert [e["phase"] for e in evals] == [fill + 2, fill + 4]
    assert not any(x.startswith("eval ") for x in outs[1]["lines"]) and not outs[1]["seen"]
    assert len(outs[0]["seen"]) == 2
    ev = Evaluator(PENDULUM_TINY.env_factory("cpu"), t.agent.actor, 4)
    draws = Draws(PENDULUM_TINY.trainer.seed + 1, "cpu")
    for params, line in zip(outs[0]["seen"], evals):
        want = ev.run(params, draws)
        assert {k: line[k] for k in want} == want
    for out in outs:
        assert _leaves_equal(out["actor"], outs[0]["seen"][-1])
