"""The port's evaluator and eval CLI.

The port's ``Evaluator`` on pendulum_tiny actor params converted from the
JAX package, with the JAX evaluator's env-reset draws injected, matches
``r2d2dpg_tpu.training.evaluator.Evaluator.run`` within 1e-4 relative on
the mean, min and max return (200 steps of a float32 rollout, the LSTM
summed in another order).  The eval CLI then runs end to end from
checkpoints the port's train CLI wrote on the CPU: float32 and bf16, with
a relative ``--checkpoint-dir``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
from r2d2dpg_tpu.training.evaluator import Evaluator as JEvaluator
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.convert import net_params_from_flax
from r2d2dpg_torch.eval import main as eval_main
from r2d2dpg_torch.train import main as train_main
from r2d2dpg_torch.training import ReplayDraws
from r2d2dpg_torch.training.evaluator import Evaluator


@pytest.mark.parametrize("seed,head_scale", [(0, 1.0), (3, 300.0)])
def test_evaluator_matches_jax(seed, head_scale):
    """``head_scale`` 300 lifts the initial head's U(+-3e-3) weights so the
    policy's torques matter to the returns."""
    num_envs = 5
    jtrainer = J_TINY.build()
    jactor = jtrainer.agent.actor
    jparams = jactor.init(jax.random.PRNGKey(seed), jnp.zeros((1, 3)),
                          jactor.initial_carry(1), jnp.zeros((1,)))
    head = jparams["params"]["head"]
    jparams["params"]["head"] = {**head, "kernel": head["kernel"] * head_scale}
    key = jax.random.PRNGKey(100 + seed)
    want = JEvaluator(J_TINY.env_factory(), jtrainer.agent.actor, num_envs).run(
        jparams, key)
    # The JAX evaluator's reset draws (Pendulum._init_state per env).
    k_reset, _ = jax.random.split(key)
    k12 = jax.vmap(jax.random.split)(jax.random.split(k_reset, num_envs))
    theta = jax.vmap(lambda k: jax.random.uniform(k, (), minval=-jnp.pi, maxval=jnp.pi))(
        k12[:, 0])
    thdot = jax.vmap(lambda k: jax.random.uniform(k, (), minval=-1.0, maxval=1.0))(
        k12[:, 1])
    trainer = PENDULUM_TINY.build("cpu")
    episode = trainer.env.spec.episode_length
    # Each step also draws the lanes' next start state (used only at the
    # boundary, after which an env no longer counts).
    draws = ReplayDraws(
        [torch.tensor(np.asarray(theta)), torch.tensor(np.asarray(thdot))]
        + [torch.zeros(num_envs)] * (2 * episode)
    )
    got = Evaluator(trainer.env, trainer.agent.actor, num_envs).run(
        net_params_from_flax(jax.device_get(jparams)), draws)
    assert draws.remaining() == 0
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


def test_eval_cli_from_train_cli_checkpoints(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for ckdir, flags in (("fp32", []), ("bf16", ["--compute-dtype", "bfloat16"])):
        train_main(["--config", "pendulum_tiny", "--phases", "1", "--device", "cpu",
                    "--log-every", "0", "--checkpoint-dir", ckdir, *flags])
        capsys.readouterr()
        summary = eval_main(["--config", "pendulum_tiny", "--checkpoint-dir", ckdir,
                             "--episodes", "3", "--rounds", "2", "--device", "cpu",
                             *flags])
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert [x.get("round") for x in lines] == [0, 1, None]
        assert lines[-1] == summary
        assert summary["learner_step"] == 1 and summary["checkpoint_step"] == 5
        assert np.isfinite(summary["eval_return_mean"])
        for line in lines[:2]:
            assert line["eval_return_min"] <= line["eval_return_mean"] <= line["eval_return_max"]
    with pytest.raises(ValueError, match="critic_params"):
        eval_main(["--config", "pendulum_tiny", "--checkpoint-dir", "fp32",
                   "--twin-critic", "1", "--device", "cpu"])


def test_train_cli_logs_csv_evals_and_flight_events(tmp_path, capsys):
    """--logdir writes the log rows (with rates) and eval rows as CSV, a
    second run appends to it, and --eval-every prints one eval line per
    cadence hit; the checkpoint saves land in the flight recorder."""
    import csv

    from r2d2dpg_torch.obs import get_flight_recorder

    logdir, ck = str(tmp_path / "log"), str(tmp_path / "ck")
    common = ["--config", "pendulum_tiny", "--device", "cpu", "--log-every", "2",
              "--logdir", logdir, "--eval-every", "2", "--eval-envs", "2",
              "--checkpoint-dir", ck, "--checkpoint-every", "4"]
    train_main(common + ["--phases", "4"])
    out = capsys.readouterr().out.splitlines()
    evals = [json.loads(x[len("eval "):]) for x in out if x.startswith("eval ")]
    assert [e["phase"] for e in evals] == [6, 8]  # fill 4, then every 2
    rows = list(csv.DictReader(open(f"{logdir}/metrics.csv")))
    assert [r["step"] for r in rows] == ["2", "4", "6", "6", "8", "8"]
    assert rows[3]["eval_return_mean"] and rows[2]["critic_loss"]
    assert rows[2]["env_steps_per_sec"]
    saves = [e["step"] for e in get_flight_recorder().events()
             if e["kind"] == "checkpoint_save" and e["directory"] == ck]
    assert saves == [4, 8]
    train_main(common + ["--phases", "2", "--resume"])
    rows = list(csv.DictReader(open(f"{logdir}/metrics.csv")))
    assert [r["step"] for r in rows][-2:] == ["10", "10"]
    assert float(rows[-1]["wall_seconds"]) >= float(rows[5]["wall_seconds"])
