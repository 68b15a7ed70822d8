"""Port parity: the named configs and the training CLI's overrides against JAX.

Every config of the JAX package has a port config of the same name whose
agent, trainer and net fields equal JAX's, and whose env factory takes
JAX's arguments (the DM-Control configs' domain, task, pixels and action
repeat).  The port's CLI flags give the same config as the JAX CLI's
``_apply_overrides`` for each flag the port has.  Exact equality: these
are constants.  ``train --config walker_r2d2 --device cpu`` runs 2 train
phases at reduced widths through ``--overlap-learner 0`` and ``1``,
``--pipeline 1`` and ``--spmd 2`` (2 gloo processes).
"""

import dataclasses
import inspect
import types

import pytest
import torch

from r2d2dpg_tpu.configs import CONFIGS as J_CONFIGS
from r2d2dpg_tpu.train import _apply_overrides as j_apply_overrides
from r2d2dpg_tpu.train import parse_args as j_parse_args
from r2d2dpg_torch.configs import CONFIGS, get_config
from r2d2dpg_torch.envs.core import EnvSpec
from r2d2dpg_torch.models import ConvTorso, MLPTorso, MixedPrecisionLSTMCell
from r2d2dpg_torch.train import _apply_overrides, parse_args

DMC = ("walker_r2d2", "walker_r2d2_ns5", "humanoid_r2d2", "cheetah_pixels")
NET_FIELDS = ("use_lstm", "pixels", "hidden", "compute_dtype")


def _fields_equal(port, ref):
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("name", sorted(J_CONFIGS))
def test_config_constants_equal_jax(name):
    port, ref = get_config(name), J_CONFIGS[name]
    assert port.name == ref.name
    _fields_equal(port.agent, ref.agent)
    _fields_equal(port.trainer, ref.trainer)
    for f in NET_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert set(CONFIGS) == set(J_CONFIGS)


@pytest.mark.parametrize("name", DMC)
def test_dmc_env_factories_name_roadmap_item_7(name):
    """The DM-Control factories (ROADMAP item 7 until the envs were
    ported) build JAX's env: the same arguments, the same spec; the
    config builds the plain trainer on it."""
    from r2d2dpg_torch.envs import DMCHostEnv
    from r2d2dpg_torch.training.trainer import Trainer

    def args(factory):
        return inspect.getclosurevars(factory).nonlocals

    cfg = get_config(name)
    got, want = args(cfg.env_factory), args(J_CONFIGS[name].env_factory)
    assert got == want and set(got) == {"domain", "task", "pixels", "action_repeat"}
    trainer = cfg.build("cpu")
    assert type(trainer) is Trainer and isinstance(trainer.env, DMCHostEnv)
    ref = J_CONFIGS[name].env_factory()
    assert trainer.env.spec.__dict__ == ref.spec.__dict__
    assert trainer.env.action_repeat == ref.action_repeat == want["action_repeat"]
    assert trainer.env.native == ref.native


@pytest.mark.parametrize("name,obs_shape,act,seq_len", [
    ("humanoid_r2d2", (67,), 21, 85),
    ("cheetah_pixels", (64, 64, 3), 6, 45),
    ("walker_r2d2_ns5", (24,), 6, 45),
])
def test_build_agent_at_published_shapes(name, obs_shape, act, seq_len):
    cfg = get_config(name)
    env = types.SimpleNamespace(spec=EnvSpec(name, obs_shape, act, pixels=cfg.pixels))
    agent = cfg.build_agent(env)
    assert agent.config.seq_len == seq_len
    torso = ConvTorso if cfg.pixels else MLPTorso
    assert isinstance(agent.actor.torso, torso) and isinstance(agent.critic.torso, torso)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16").build_agent(env)
    assert isinstance(bf16.critic.core.cell, MixedPrecisionLSTMCell)
    p = bf16.actor.init_params(torch.Generator().manual_seed(0), "cpu")
    obs = torch.zeros((2,) + obs_shape, dtype=torch.uint8 if cfg.pixels else torch.float32)
    a, _ = bf16.actor.apply_params(p, obs, bf16.actor.initial_carry(2, "cpu"), torch.zeros(2))
    assert a.shape == (2, act) and a.dtype == torch.float32


FLAG_SETS = [
    ("--twin-critic", "1"),
    ("--twin-critic", "0"),
    ("--target-policy-sigma", "0.2"),
    ("--compute-dtype", "bfloat16"),
    ("--compute-dtype", "float32"),
    ("--n-step", "3"),
    ("--actor-lr", "3e-4"),
    ("--critic-lr", "2e-3"),
    ("--sigma-max", "0.8"),
    ("--ladder-alpha", "4.5"),
    ("--seed", "9"),
    ("--twin-critic", "1", "--target-policy-sigma", "0.2", "--compute-dtype",
     "bfloat16", "--n-step", "4", "--actor-lr", "1e-3", "--critic-lr", "5e-4",
     "--sigma-max", "0.5", "--ladder-alpha", "3"),
    ("--num-envs", "8"),
    ("--batch-size", "32"),
    ("--learner-steps", "3"),
    ("--min-replay", "500"),
    ("--param-sync-every", "2"),
    ("--num-envs", "2", "--batch-size", "16", "--learner-steps", "2",
     "--min-replay", "40", "--param-sync-every", "0", "--seed", "3"),
    ("--overlap-learner", "1"),
    ("--overlap-learner", "0", "--learner-steps", "8"),
]


@pytest.mark.parametrize("name", ["pendulum_r2d2", "cheetah_pixels"])
@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "_".join(f))
def test_cli_overrides_equal_jax(name, flags):
    argv = ["--config", name, *flags]
    port = _apply_overrides(get_config(name), parse_args(argv))
    ref = j_apply_overrides(J_CONFIGS[name], j_parse_args(argv))
    _fields_equal(port.agent, ref.agent)
    _fields_equal(port.trainer, ref.trainer)
    for f in NET_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("name", ["pendulum_r2d2", "cheetah_pixels"])
@pytest.mark.parametrize("flags", [
    ("--batch-size", "128"), ("--batch-size", "16", "--actor-lr", "2e-4"),
    ("--critic-lr", "3e-3"),
], ids=lambda f: "_".join(f))
def test_lr_scale_batch_equals_jax(name, flags, capsys):
    """``--lr-scale-batch 1``: the JAX CLI scales the resolved learning
    rates by batch_size / the config's batch in ``run`` (train.py), after
    ``_apply_overrides``; the port does it inside ``_apply_overrides``."""
    argv = ["--config", name, "--lr-scale-batch", "1", *flags]
    port = _apply_overrides(get_config(name), parse_args(argv))
    ref = j_apply_overrides(J_CONFIGS[name], j_parse_args(argv))
    scale = ref.trainer.batch_size / J_CONFIGS[name].trainer.batch_size
    assert port.agent.actor_lr == ref.agent.actor_lr * scale
    assert port.agent.critic_lr == ref.agent.critic_lr * scale
    _fields_equal(port.trainer, ref.trainer)
    assert "lr-scale-batch: linear rule" in capsys.readouterr().out


# ------------------------------------------------------------------ telemetry
TELEMETRY_FLAGS = [
    (),
    ("--obs-port", "0", "--obs-host", "127.0.0.1", "--flight-path", "f.jsonl"),
    ("--health-wait-p99", "7.5", "--health-stale-after", "11", "--quality-max-lag", "3"),
    ("--device-peak-flops", "6.7e13", "--profile-window", "4:3"),
    ("--profile-phases", "2", "--nan-debug"),
    ("--actors", "3", "--replay-shards", "2", "--shard-procs", "2",
     "--health-wait-p99", "2"),
]
TELEMETRY_DESTS = ("obs_port", "obs_host", "flight_path", "health_wait_p99",
                   "health_stale_after", "quality_max_lag", "device_peak_flops",
                   "profile_window", "profile_phases", "nan_debug")


@pytest.mark.parametrize("flags", TELEMETRY_FLAGS, ids=lambda f: "_".join(f) or "defaults")
def test_telemetry_flags_and_health_config_equal_jax(flags):
    """The telemetry flags parse to JAX's values (defaults included), and
    ``_health_config`` builds JAX's ``HealthConfig`` from them."""
    from r2d2dpg_tpu.train import _health_config as j_health_config
    from r2d2dpg_torch.train import _health_config

    argv = ["--config", "pendulum_tiny", *flags]
    port, ref = parse_args(argv), j_parse_args(argv)
    for dest in TELEMETRY_DESTS:
        assert getattr(port, dest) == getattr(ref, dest), dest
    assert dataclasses.asdict(_health_config(port)) == dataclasses.asdict(
        j_health_config(ref))


def _jax_refusal(argv):
    from r2d2dpg_tpu import train as jtrain

    with pytest.raises(SystemExit) as e:
        jtrain.run(jtrain.parse_args(argv))
    return str(e.value)


def _port_refusal(argv):
    from r2d2dpg_torch.train import main

    with pytest.raises(SystemExit) as e:
        main([*argv, "--device", "cpu"])
    return str(e.value)


TELEMETRY_REFUSALS = {
    "window_without_logdir": (("--profile-window", "1:1"), "requires --logdir", True),
    # JAX's text says "the one jax profiler session"; the port's profiler
    # is torch's, and its text says "the one profiler session".
    "window_and_phases": (("--profile-window", "1:1", "--profile-phases", "2",
                           "--logdir", "/tmp/never_used_refused"), "pick one", False),
    "window_grammar": (("--profile-window", "nope", "--logdir",
                        "/tmp/never_used_refused"), "--profile-window: ", True),
    "actors_x_profile_phases": (("--actors", "2", "--profile-phases", "2"),
                                "does not compose", True),
    # JAX refuses --resume/--eval-every with --pipeline too; the port's
    # pipeline runs them, so its message names --profile-phases alone.
    "pipeline_x_profile_phases": (("--pipeline", "1", "--profile-phases", "2"),
                                  "does not support", False),
}


@pytest.mark.parametrize("name", sorted(TELEMETRY_REFUSALS))
def test_telemetry_refusals_equal_jax(name):
    flags, match, same_text = TELEMETRY_REFUSALS[name]
    argv = ["--config", "pendulum_tiny", *flags]
    want, got = _jax_refusal(argv), _port_refusal(argv)
    assert match in want and match in got, (want, got)
    if same_text:
        assert got == want


# The rows chaos drills and the direct data plane add to the JAX CLI's
# refusals (``r2d2dpg_tpu/topology.py``), each with JAX's text.
CHAOS_REFUSALS = {
    "chaos_without_actors": (("--chaos-spec", "kill_actor@p2"), "require --actors"),
    "shard_chaos_without_shard_procs": (
        ("--actors", "2", "--replay-shards", "2", "--chaos-spec", "kill_shard@p2"),
        "shard-procs"),
    "shard_direct_without_sampler_path": (("--shard-direct", "1"), "requires --actors"),
    "data_plane_chaos_without_shard_direct": (
        ("--actors", "2", "--replay-shards", "2", "--chaos-spec",
         "partition_data_plane@p2"), "shard-direct"),
    "sampler_chaos_without_shards": (
        ("--actors", "2", "--chaos-spec", "stall_sampler@p2:1s"), "replay-shards"),
    "malformed_spec": (("--actors", "2", "--chaos-spec", "stall_actor@p2"),
                       "--chaos-spec: "),
}


@pytest.mark.parametrize("name", sorted(CHAOS_REFUSALS))
def test_chaos_and_shard_direct_refusals_equal_jax(name):
    flags, match = CHAOS_REFUSALS[name]
    argv = ["--config", "pendulum_tiny", *flags]
    want = _jax_refusal(argv)
    assert match in want
    assert _port_refusal(argv) == want


# ------------------------------------------- fleet telemetry and autoscaler
FLEET_PLANE_FLAGS = [
    (),
    ("--actors", "2", "--obs-fleet", "1"),
    ("--actors", "2", "--autoscale", "1"),
    ("--actors", "3", "--obs-fleet", "1", "--autoscale", "1", "--autoscale-dry-run", "1",
     "--autoscale-min", "2", "--autoscale-max", "5", "--autoscale-cooldown", "3",
     "--autoscale-every", "0.5", "--autoscale-fire", "2", "--health-stale-after", "4"),
]
FLEET_PLANE_DESTS = ("obs_fleet", "autoscale", "autoscale_dry_run", "autoscale_min",
                     "autoscale_max", "autoscale_cooldown", "autoscale_every",
                     "autoscale_fire")


@pytest.mark.parametrize("flags", FLEET_PLANE_FLAGS, ids=lambda f: "_".join(f) or "defaults")
def test_fleet_plane_flags_and_health_config_equal_jax(flags):
    """``--obs-fleet`` and the ``--autoscale*`` flags parse to JAX's values
    (defaults included), and ``_health_config`` builds JAX's config from
    them: ``telem_expected`` follows ``--obs-fleet``."""
    from r2d2dpg_tpu.train import _health_config as j_health_config
    from r2d2dpg_torch.train import _health_config

    argv = ["--config", "pendulum_tiny", *flags]
    port, ref = parse_args(argv), j_parse_args(argv)
    for dest in FLEET_PLANE_DESTS:
        assert getattr(port, dest) == getattr(ref, dest), dest
    assert dataclasses.asdict(_health_config(port)) == dataclasses.asdict(
        j_health_config(ref))
    assert _health_config(port).telem_expected is ("--obs-fleet" in flags)


# JAX's refusal rows and value checks for these flags
# (``r2d2dpg_tpu/topology.py``), each with JAX's text.
FLEET_PLANE_REFUSALS = {
    "autoscale_without_actors": ("--autoscale", "1"),
    "autoscale_knobs_without_autoscale": ("--actors", "2", "--autoscale-dry-run", "1"),
    "autoscale_min_without_autoscale": ("--actors", "2", "--autoscale-min", "2"),
    "obs_fleet_without_fleet": ("--obs-fleet", "1"),
    "autoscale_cooldown": ("--actors", "2", "--autoscale", "1", "--autoscale-cooldown", "0"),
    "autoscale_every": ("--actors", "2", "--autoscale", "1", "--autoscale-every", "0"),
    "autoscale_fire": ("--actors", "2", "--autoscale", "1", "--autoscale-fire", "0"),
    "autoscale_min": ("--actors", "2", "--autoscale", "1", "--autoscale-min", "0"),
    "autoscale_max_below_min": ("--actors", "2", "--autoscale", "1", "--autoscale-min",
                                "3", "--autoscale-max", "2"),
    "autoscale_max_below_actors": ("--actors", "3", "--autoscale", "1",
                                   "--autoscale-max", "2"),
}


@pytest.mark.parametrize("name", sorted(FLEET_PLANE_REFUSALS))
def test_fleet_plane_refusals_equal_jax(name):
    argv = ["--config", "pendulum_tiny", *FLEET_PLANE_REFUSALS[name]]
    want = _jax_refusal(argv)
    assert want.startswith("--")
    assert _port_refusal(argv) == want


@pytest.mark.fleet
def test_train_cli_obs_fleet_autoscale_folds_actor_series(tmp_path, monkeypatch, capsys):
    """``train --actors 2 --obs-fleet 1 --autoscale 1``: the actors' TELEM
    series are on the final scrape under ``actor=``/``host=``, the
    autoscale instruments are registered, and the ``fleet:`` line carries
    the autoscaler's counts (a healthy run takes no action)."""
    import socket

    from r2d2dpg_torch.obs import registry as obs_registry
    from r2d2dpg_torch.train import main

    # A fresh registry and mirror: this file's earlier fleet runs leave
    # staleness closures of stopped servers on the process registry.
    monkeypatch.setattr(obs_registry, "_REGISTRY", obs_registry.Registry())
    monkeypatch.setattr(obs_registry, "_MIRROR", obs_registry.RemoteMirror())
    main(["--config", "pendulum_tiny", "--actors", "2", "--phases", "3", "--device", "cpu",
          "--logdir", str(tmp_path), "--log-every", "1", "--obs-fleet", "1",
          "--autoscale", "1", "--autoscale-every", "0.5"])
    prom = (tmp_path / "metrics_final.prom").read_text()
    host = socket.gethostname()
    for a in ("0", "1"):
        assert f'r2d2dpg_actor_phases_total{{actor="{a}",host="{host}"}}' in prom, a
        assert f'r2d2dpg_fleet_telem_staleness_seconds{{actor="{a}"}}' in prom, a
    assert "r2d2dpg_autoscale_target_actors 2" in prom.splitlines()
    line = next(x for x in capsys.readouterr().out.splitlines()
                if x.startswith("fleet: ") and "wall_s" in x)
    words = line.split()[1:]
    stats = dict(zip(words[::2], words[1::2]))
    assert float(stats["autoscale_target"]) == 2.0
    assert float(stats["autoscale_actions"]) == 0.0
    assert float(stats["actor_restarts"]) == 0.0


def test_nan_debug_switches_anomaly_mode():
    from r2d2dpg_torch.utils.profiling import nan_debug

    try:
        nan_debug(True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    finally:
        nan_debug(False)
    assert not torch.is_anomaly_enabled()


def test_train_cli_obs_port_writes_port_file_and_registry_columns(tmp_path):
    """``python -m r2d2dpg_torch train ... --obs-port 0 --logdir D``: the
    package's dispatch runs the train CLI, which prints the ``obs:`` line,
    writes ``D/obs_port.txt`` and folds the registry into the CSV."""
    import csv
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = tmp_path / "run"
    res = subprocess.run(
        [sys.executable, "-m", "r2d2dpg_torch", "train", "--config", "pendulum_tiny",
         "--phases", "3", "--device", "cpu", "--obs-port", "0", "--obs-host",
         "127.0.0.1", "--logdir", str(d), "--log-every", "1"],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    port = int((d / "obs_port.txt").read_text())
    assert f"obs: /metrics + /metrics.json + /health on port {port}" in res.stdout
    with open(d / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert float(rows[-1]["r2d2dpg_trainer_learner_steps"]) == 3.0
    assert float(rows[-1]["r2d2dpg_device_learn_flops_total"]) > 0
    assert "r2d2dpg_health_status" in rows[-1]  # the armed engine's gauges


def test_train_cli_profile_phases_writes_a_trace(tmp_path):
    from r2d2dpg_torch.train import main

    main(["--config", "pendulum_tiny", "--phases", "3", "--device", "cpu",
          "--profile-phases", "2", "--logdir", str(tmp_path), "--log-every", "0"])
    (trace,) = (tmp_path / "profile").iterdir()
    assert trace.name.endswith(".pt.trace.json")
    names = {e.get("name") for e in __import__("json").loads(trace.read_text())[
        "traceEvents"]}
    assert "trainer/train_phase" in names


@pytest.mark.fleet
def test_train_cli_actors_stamps_final_evidence(tmp_path):
    """``train --actors 2 --phases 3 --logdir D`` writes the final scrape,
    the final /health verdict and the quality plane before the supervisor
    stops: all actors alive, the verdict free of actors_down."""
    import json

    from r2d2dpg_torch.train import main

    main(["--config", "pendulum_tiny", "--actors", "2", "--phases", "3",
          "--device", "cpu", "--logdir", str(tmp_path), "--log-every", "1"])
    prom = (tmp_path / "metrics_final.prom").read_text()
    assert "r2d2dpg_fleet_actors_alive 2" in prom.splitlines()
    assert "r2d2dpg_fleet_actors_expected 2" in prom.splitlines()
    health = json.loads((tmp_path / "health_final.json").read_text())
    assert "actors_down" not in {f["rule"] for f in health["findings"]}
    quality = json.loads((tmp_path / "quality_final.json").read_text())
    assert isinstance(quality, dict) and quality


@pytest.mark.fleet
def test_shard_procs_run_dir_fuses_trace_shard_spans(tmp_path, capsys):
    """A ``--shard-procs 1`` run directory holds the shard process's raw
    ``trace_shard0.jsonl``; ``obs.flight merge --trace-out`` fuses its hops
    with the learner's ``trace.json`` into one timeline."""
    import json

    from r2d2dpg_torch.obs import flight
    from r2d2dpg_torch.train import main

    main(["--config", "pendulum_tiny", "--actors", "2", "--replay-shards", "2",
          "--shard-procs", "1", "--phases", "3", "--device", "cpu", "--logdir",
          str(tmp_path), "--trace-sample", "1", "--log-every", "0"])
    assert (tmp_path / "trace_shard0.jsonl").exists()
    assert not (tmp_path / "trace_shard0.json").exists()
    fused = tmp_path / "fused.json"
    flight.main(["merge", str(tmp_path), "-o", str(tmp_path / "merged.jsonl"),
                 "--trace-out", str(fused)])
    events = json.loads(fused.read_text())["traceEvents"]
    by_file = {}
    for e in events:
        by_file.setdefault(e["args"]["file"], set()).add(e["name"])
    assert {"req_receive", "shard_draw", "batch_encode"} <= by_file["trace_shard0.jsonl"]
    assert {"sample_req", "batch_return", "learn"} <= by_file["trace.json"]
    assert "flight merge:" in capsys.readouterr().err


def test_serve_selftest_with_obs_port_starts_exporter(tmp_path, capsys):
    """``serve --selftest 8 --obs-port 0``: the process exporter comes up,
    armed for a serving process, and answers /health and /metrics."""
    import json
    import urllib.request

    from r2d2dpg_torch import obs
    from r2d2dpg_torch.serve import main as serve_main
    from r2d2dpg_torch.train import main as train_main

    ck = str(tmp_path / "ck")
    train_main(["--config", "pendulum_tiny", "--phases", "1", "--device", "cpu",
                "--log-every", "0", "--checkpoint-dir", ck, "--checkpoint-light"])
    obs.stop_exporter()
    try:
        out = serve_main(["--config", "pendulum_tiny", "--checkpoint-dir", ck,
                          "--device", "cpu", "--selftest", "8", "--obs-port", "0",
                          "--obs-host", "127.0.0.1"])
        assert out["codes"] == {"ok": 8}
        ex = obs.current_exporter()
        assert ex is not None and ex.health.config.telem_expected is False
        assert f"on port {ex.port}" in capsys.readouterr().err
        base = f"http://127.0.0.1:{ex.port}"
        body = json.loads(urllib.request.urlopen(f"{base}/health", timeout=10).read())
        # The process registry is shared with earlier tests (a stopped
        # fleet's gauges may degrade the verdict); the scrape carries it.
        level = {"ok": 0, "degraded": 1, "critical": 2}[body["verdict"]]
        text = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        assert f"r2d2dpg_health_status {level}" in text.splitlines()
    finally:
        obs.stop_exporter()


# ------------------------------------------------- walker_r2d2 through the CLI
WALKER_CLI = ["--config", "walker_r2d2", "--device", "cpu", "--num-envs", "4",
              "--batch-size", "4", "--min-replay", "4", "--learner-steps", "2",
              "--phases", "2", "--log-every", "1"]


@pytest.mark.parametrize("flags", [("--overlap-learner", "0"), ("--overlap-learner", "1"),
                                   ("--pipeline", "1")],
                         ids=["overlap0", "overlap1", "pipeline"])
def test_train_cli_runs_walker(flags, capsys):
    from r2d2dpg_tpu import topology as jtopology
    from r2d2dpg_torch.parallel import HostSPMDTrainer
    from r2d2dpg_torch.train import main

    state = main(WALKER_CLI + list(flags))
    out = capsys.readouterr().out.splitlines()
    want = jtopology.resolve(j_parse_args(["--config", "walker_r2d2", *flags])).describe()
    assert out[0] == "backend: cpu" and out[1] == f"topology: {want}"
    assert state.train.step == 2 * 2
    logged = [x for x in out if x.startswith("phase ")]
    assert logged and "critic_loss" in logged[-1]
    built = _apply_overrides(get_config("walker_r2d2"),
                             parse_args(WALKER_CLI + list(flags))).build("cpu")
    assert isinstance(built, HostSPMDTrainer) == (flags == ("--overlap-learner", "1"))


WALKER_SPMD_BODY = """
from r2d2dpg_torch.train import main
import contextlib, io
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    state = main(%r)
torch.save({"out": buf.getvalue(), "step": state.train.step,
            "env_steps": state.env_steps}, os.path.join(OUT, f"rank{mesh.rank}.pt"))
""" % (WALKER_CLI + ["--spmd", "2"],)


def test_train_cli_runs_walker_spmd2(tmp_path):
    """``--spmd 2`` with a DM-Control config: the host-pool trainer in 2
    gloo processes, each stepping its own pool of 2 envs."""
    from r2d2dpg_tpu import topology as jtopology

    from test_torch_parallel import spawn_world

    outs = spawn_world(2, WALKER_SPMD_BODY, tmp_path, timeout=600)
    want = jtopology.resolve(j_parse_args(["--config", "walker_r2d2", "--spmd", "2"]))
    lines = outs[0]["out"].splitlines()
    assert f"topology: {want.describe()}" in lines
    assert [o["step"] for o in outs] == [4, 4]
    assert outs[0]["env_steps"] == outs[1]["env_steps"]
    assert any(x.startswith("phase ") and "critic_loss" in x for x in lines)
    assert outs[1]["out"] == ""  # rank 1 prints nothing
