"""The pipelined executor over the host-pool trainer in a world of D ranks
(``training/pipeline.py`` over ``parallel/hybrid.py``; ``train --spmd D
--pipeline 1`` with a DM-Control config).

- **The version rule.**  Each collect phase ``k`` of a pipelined section
  acts with the params after ``max(0, k' - d - 1)`` drains, ``k'`` its
  last refresh phase (``k' = k - k % param_sync_every``) and ``d`` the
  queue depth, for d = 1, 2, 3 and ``param_sync_every`` 1 and 2, on the
  plain ``Trainer`` (pendulum_tiny) and on the hybrid at D = 1
  (``test_hybrid_spmd.py``'s tiny walker shapes); no refresh waits.
  The collector waits there before each phase until the learner has
  drained every item put so far, so the newest version is ``k``.
- **Determinism** (pendulum_tiny): a pipelined run is bitwise equal to
  itself from the same seed, also when a learner hook sleeps 50 ms a
  drain (the learner the slower side) and when the collector waits for
  the learner before each phase (the collector the slower side), and to a
  one-thread replay of its schedule (collect phase k with the params after
  drain ``max(0, k' - d - 1)``, then drain k).
- **D = 2 and 4** as gloo processes (``spawn_world``), each on its own
  pool of ``4/D`` lanes: the pipelined hybrid on the native walker-walk
  pool (the actor's head zeroed and a constant sigma of 1, as in
  ``tests/test_torch_hybrid.py``, so every collected action is the
  injected normal, clipped, and the env data stays bitwise whatever the
  row layout) and on ``HostStandInEnv`` with 3-step episodes (smooth
  numpy dynamics, so learned behaviour params act and episodes finish)
  against the same runs at D = 1: params and priorities at atol 1e-5,
  rtol 1e-4 (``test_hybrid_world_matches_jax_mesh``'s tolerance), each
  rank's env rows, the logged episode sums, ``env_steps``; every rank's
  params bitwise rank 0's; every rank's recorded versions rank 0's and the
  rule's; the collector thread calls no ``torch.distributed`` collective
  (``testing.count_collectives``) while the learner thread calls them.
- **D = 2 against JAX.**  JAX's ``PipelineExecutor`` over its
  ``HostSPMDTrainer`` on a 2-device mesh reaches the same ``phase_idx``,
  ``env_steps``, ``train.step`` and ``total_added`` (its collector takes
  the newest params, so only the counters compare); the port's
  ``enabled=False`` at D = 2, JAX's draws injected, matches JAX's
  phase-locked mesh (``tests/test_torch_hybrid.py::_check_rank``).
- **The CLI at D = 2**: ``--config walker_r2d2 --spmd 2 --pipeline 1``
  with tiny overrides runs on both ranks (rank 0 alone prints, with
  JAX's topology stamp and the two degrade lines; ``--trace-sample``
  traces on rank 0; ``--profile-window`` captures on every rank), on
  ``--spmd 1``'s schedule and bitwise across ranks; its
  final checkpoint (the global state) resumes at D = 2; ``--minutes``
  with rank 1's clock an hour ahead stops every rank after the same
  drain, rc 0; ``--nan-inject-phase 1`` exits 2 on every rank;
  ``--config pendulum_tiny --spmd 2 --pipeline 1`` ends with JAX's
  executor message.

Every spawned world has a timeout, so a hang fails.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from r2d2dpg_torch.configs import PENDULUM_TINY, WALKER_R2D2
from r2d2dpg_torch.parallel import distributed, make_mesh
from r2d2dpg_torch.replay import StagedSequences
from r2d2dpg_torch.training.assembler import emit
from r2d2dpg_torch.training.pipeline import (
    PipelineConfig,
    PipelineExecutor,
    drain_staged,
    merge_state,
    split_state,
)
from r2d2dpg_torch.tree import tree_leaves

from test_torch_hybrid import EXACT_ACTIONS, TINY_SRC, TOL, _check_rank, _jax_hybrid, _tiny
from test_torch_parallel import PRELUDE, REPO, _leaves_equal, spawn_world
from test_torch_pipeline import _assert_states_bitwise

pytestmark = pytest.mark.pipeline


def _versions(n, depth, sync):
    """The rule's version for each of ``n`` collect phases."""
    return [max(0, (k - k % sync) - depth - 1) for k in range(n)]


def _slow_collector(ex):
    """Make ``ex``'s collector the slower side: before collect phase ``k``
    it waits until the learner has drained the ``k`` items put so far and
    published version ``k``, the newest a collector could take (the rule's
    is ``k - d - 1``)."""
    published, put = [], []
    publish, collect = ex._publish, ex._collect_phase_pipelined

    def counting(*args, **kwargs):
        out = publish(*args, **kwargs)
        published.append(out)
        return out

    def slow(*args):
        while len(published) < len(put) + 1:  # versions 0 .. k are out
            time.sleep(0.002)
        put.append(None)
        return collect(*args)

    ex._publish, ex._collect_phase_pipelined = counting, slow


# ------------------------------------------------------------ the rule
@pytest.mark.parametrize("sync", [1, 2])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("kind", ["plain", "hybrid1"])
def test_each_phase_acts_with_the_rule_version(kind, depth, sync):
    n_train = 6
    if kind == "plain":
        cfg = dataclasses.replace(PENDULUM_TINY, trainer=dataclasses.replace(
            PENDULUM_TINY.trainer, param_sync_every=sync))
        t = cfg.build("cpu")
    else:
        t = _tiny(WALKER_R2D2, param_sync_every=sync).build_spmd(make_mesh(1, "cpu"), "cpu")
    ex = PipelineExecutor(t, PipelineConfig(queue_depth=depth))
    _slow_collector(ex)
    s = ex.run(t.window_fill_phases + t.replay_fill_phases + n_train, log_every=0)
    assert s.train.step == n_train * t.config.learner_steps
    assert ex.param_versions == _versions(n_train, depth, sync)
    assert ex.version_waits == 0


# ------------------------------------------------------------ determinism
N_TRAIN = 8
LOG_EVERY = 3


def _pipelined(hook=None, slow_collector=False, depth=2, sync=1):
    cfg = dataclasses.replace(PENDULUM_TINY, trainer=dataclasses.replace(
        PENDULUM_TINY.trainer, param_sync_every=sync))
    t = cfg.build("cpu")
    ex = PipelineExecutor(t, PipelineConfig(queue_depth=depth))
    if slow_collector:
        _slow_collector(ex)
    n = t.window_fill_phases + t.replay_fill_phases + N_TRAIN
    return ex, ex.run(n, log_every=LOG_EVERY, log_fn=lambda *_: None, learner_hook=hook)


def test_pipelined_run_is_a_function_of_its_seed():
    ex, a = _pipelined()
    _, b = _pipelined()
    _assert_states_bitwise(a, b)

    def slow(n, train):
        time.sleep(0.05)
        return train

    slow_ex, c = _pipelined(slow)
    _assert_states_bitwise(a, c)
    # The learner was the slower side: the queue filled up.
    assert slow_ex.collect_wait.snapshot()[1] > 0.0
    starved_ex, d = _pipelined(slow_collector=True)
    _assert_states_bitwise(a, d)
    for e in (ex, slow_ex, starved_ex):
        assert e.param_versions == _versions(N_TRAIN, 2, 1) and e.version_waits == 0


@pytest.mark.parametrize("depth,sync", [(2, 1), (1, 2)])
def test_pipelined_run_equals_its_one_thread_replay(depth, sync):
    """Collect phase k with the params after drain ``max(0, k' - d - 1)``,
    then drain k, all on this thread, from the same state and forks."""
    cfg = dataclasses.replace(PENDULUM_TINY, trainer=dataclasses.replace(
        PENDULUM_TINY.trainer, param_sync_every=sync))
    t = cfg.build("cpu")
    ex = PipelineExecutor(t, PipelineConfig(queue_depth=depth))
    fill = t.window_fill_phases + t.replay_fill_phases
    got = ex.run(fill + N_TRAIN, log_every=0)

    r = cfg.build("cpu")
    state = r.run(fill, log_every=0)
    cs, ls = split_state(state)
    published = [ls.train]  # version v: the learner's state after v drains
    nets = (r.agent.actor, r.agent.critic)
    for k, v in enumerate(_versions(N_TRAIN, depth, sync)):
        train = published[v]
        cs = r._collect(cs, behavior=train.actor_params,
                        critic_params=r.agent.behavior_critic_params(train), nets=nets)
        ls, _ = drain_staged(r, ls, StagedSequences(seq=emit(cs.window)), prefetch=True)
        published.append(ls.train)
    want = merge_state(state, cs, ls, behavior_params=ls.train.actor_params)
    _assert_states_bitwise(got, want)


# ------------------------------------------------------------ D ranks
# One pipelined run on this rank's mesh: walker on the native pool with
# the head zeroed (exact actions), or the stand-in with 3-step episodes.
PIPE_SRC = """
def run_pipelined(mesh, cfg, depth, n_train, zero_head):
    import dataclasses, torch
    from r2d2dpg_torch.testing import count_collectives
    from r2d2dpg_torch.training.pipeline import PipelineConfig, PipelineExecutor
    t = cfg.build_spmd(mesh, "cpu")
    s = t.init()
    if zero_head:
        head = {k: torch.zeros_like(v) if k.startswith("head.") else v
                for k, v in s.train.actor_params.items()}
        s = dataclasses.replace(
            s, train=dataclasses.replace(s.train, actor_params=head,
                                         target_actor_params=dict(head)),
            behavior_params=dict(head))
    ex = PipelineExecutor(t, PipelineConfig(queue_depth=depth))
    logged = []
    n = t.window_fill_phases + t.replay_fill_phases + n_train
    with count_collectives() as calls:
        s = ex.run(n, state=s, log_every=2,
                   metrics_fn=lambda p, sc: logged.append((p, sc)))
    return {"train": s.train, "priority": s.arena.priority,
            "total_added": s.arena.total_added, "phase_idx": s.phase_idx,
            "env_steps": s.env_steps, "obs": s.obs, "episode_return": s.episode_return,
            "logged": logged, "versions": ex.param_versions,
            "waits": ex.version_waits, "calls": dict(calls)}
"""
DEPTH = 1
RUNS = {  # name -> (n_train, zero head)
    "walker": (4, True),
    "stand_in": (5, False),
}
MESH_SRC = TINY_SRC + PIPE_SRC + f"""
from r2d2dpg_torch.configs import WALKER_R2D2
from r2d2dpg_torch.testing import HostStandInEnv
DEPTH, RUNS = {DEPTH!r}, {RUNS!r}


def configs():
    walker = _tiny(WALKER_R2D2, learner_steps=2, **EXACT_ACTIONS)
    stand_in = dataclasses.replace(
        _tiny(WALKER_R2D2, learner_steps=2),
        env_factory=lambda device: HostStandInEnv(0, device, episode_length=3))
    return {{"walker": walker, "stand_in": stand_in}}


def run_all(mesh):
    return {{name: run_pipelined(mesh, cfg, DEPTH, *RUNS[name])
             for name, cfg in configs().items()}}
"""
_ns: dict = {}
exec(MESH_SRC, _ns)

WORLD_BODY = MESH_SRC + """
out = run_all(mesh)
if os.path.exists(os.path.join(OUT, "in.pt")):
    # The phase-locked anchor through the executor, JAX's draws injected.
    from r2d2dpg_torch.training.pipeline import PipelineConfig, PipelineExecutor
    from r2d2dpg_torch.training import ReplayDraws
    ls, draws, train0 = torch.load(os.path.join(OUT, "in.pt"), weights_only=False)
    cfg = _tiny(WALKER_R2D2, False, ls, **EXACT_ACTIONS)
    t = cfg.build_spmd(mesh, "cpu")
    rd = ReplayDraws(draws)
    s = t.init(rd)
    s = dataclasses.replace(s, train=train0, behavior_params={
        k: v.clone() for k, v in train0.actor_params.items()})
    n = t.window_fill_phases + t.replay_fill_phases + 1
    logged = []
    s = PipelineExecutor(t, PipelineConfig(enabled=False)).run(
        n, state=s, log_every=n, metrics_fn=lambda p, sc: logged.append(sc))
    skip = ("episode_return_mean", "episodes", "env_steps")
    out["off"] = {"kind": type(t).__name__, "mesh": t.mesh.size, "obs": s.obs,
                  "window": s.window, "priority": s.arena.priority, "meta": s.arena.meta,
                  "arena_obs": s.arena.data.obs, "cursor": s.arena.cursor,
                  "train": s.train, "left": rd.remaining(), "env_steps": s.env_steps,
                  "phase_idx": s.phase_idx, "episode_return": s.episode_return,
                  "metrics": {k: v for k, v in logged[-1].items() if k not in skip}}
torch.save(out, os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


@pytest.fixture(scope="module")
def world_of_one():
    return _ns["run_all"](make_mesh(1, "cpu"))


def _check_against_one(got, ref, world, rank, name):
    n_train = RUNS[name][0]
    e = 4 // world
    rows = slice(rank * e, (rank + 1) * e)
    assert got["versions"] == ref["versions"] == _versions(n_train, DEPTH, 1)
    assert got["waits"] == 0
    assert got["calls"].get("pipeline-collector", 0) == 0, got["calls"]
    assert got["calls"].get("MainThread", 0) > 0
    for key in ("phase_idx", "env_steps", "total_added"):
        assert got[key] == ref[key], key
    assert got["train"].step == ref["train"].step == 2 * n_train
    for a, b in zip(tree_leaves(got["train"]), tree_leaves(ref["train"]), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL, err_msg=name)
    np.testing.assert_allclose(got["priority"].numpy(), ref["priority"].numpy(), **TOL)
    for key in ("obs", "episode_return"):
        np.testing.assert_allclose(got[key].numpy(), ref[key][rows].numpy(), **TOL,
                                   err_msg=f"{name} {key}")
    assert [p for p, _ in got["logged"]] == [p for p, _ in ref["logged"]]
    for (_, a), (_, b) in zip(got["logged"], ref["logged"]):
        assert a["env_steps"] == b["env_steps"] and a["episodes"] == b["episodes"]
        np.testing.assert_allclose(a["episode_return_mean"], b["episode_return_mean"], **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_pipelined_hybrid_world_matches_world_of_one(world, world_of_one, tmp_path):
    jax_ref = None
    if world == 2:
        from r2d2dpg_torch.convert import train_state_from_jax

        ref, metrics, draws, init_train = _jax_hybrid(2, False, 1)
        jax_ref = (ref, metrics)
        torch.save((1, draws, train_state_from_jax(init_train, "cpu")), tmp_path / "in.pt")
    outs = spawn_world(world, WORLD_BODY, tmp_path, timeout=120)
    # The stand-in's episodes end every 3 steps: the logged sums are the
    # mesh's, summed on the learner thread.
    assert world_of_one["stand_in"]["logged"][-1][1]["episodes"] > 0
    for rank, out in enumerate(outs):
        for name in RUNS:
            _check_against_one(out[name], world_of_one[name], world, rank, name)
            assert _leaves_equal(out[name]["train"], outs[0][name]["train"])
            assert torch.equal(out[name]["priority"], outs[0][name]["priority"])
        if jax_ref is not None:
            _check_rank(out["off"], *jax_ref, world, rank)
    if jax_ref is not None:
        assert _jax_pipelined_counters() == tuple(
            outs[0]["walker"][k] for k in ("phase_idx", "env_steps")) + (
            outs[0]["walker"]["train"].step, outs[0]["walker"]["total_added"])


def _jax_pipelined_counters():
    """JAX's executor over its ``HostSPMDTrainer`` on a 2-device mesh, the
    walker run's schedule: (phase_idx, env_steps, train.step, total_added)."""
    from r2d2dpg_tpu.configs import WALKER_R2D2 as J_WALKER
    from r2d2dpg_tpu.parallel import make_mesh as jmesh
    from r2d2dpg_tpu.training.pipeline import PipelineConfig as JConfig
    from r2d2dpg_tpu.training.pipeline import PipelineExecutor as JExecutor

    jt = _tiny(J_WALKER, learner_steps=2, **EXACT_ACTIONS).build_spmd(jmesh(2))
    n = jt.window_fill_phases + jt.replay_fill_phases + RUNS["walker"][0]
    js = JExecutor(jt, JConfig(queue_depth=DEPTH)).run(n, log_every=0)
    return (int(js.phase_idx), int(js.env_steps), int(js.train.step),
            int(js.arena.total_added))


# ------------------------------------------------------------ the CLI at D = 2
WALKER_CLI = ["--config", "walker_r2d2", "--device", "cpu", "--num-envs", "4",
              "--batch-size", "4", "--min-replay", "4", "--learner-steps", "2",
              "--log-every", "1", "--pipeline", "1"]
CLI_BODY = f"WALKER_CLI = {WALKER_CLI!r}\n" + """
import contextlib, io, types
from r2d2dpg_torch import train
from r2d2dpg_torch.training import pipeline as pipeline_mod


def run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = train.main(WALKER_CLI + ["--spmd", "2"] + argv)
    return {"lines": buf.getvalue().splitlines(), "train": st.train,
            "phase_idx": st.phase_idx, "env_steps": st.env_steps,
            "priority": st.arena.priority}


ck, logdir = os.path.join(OUT, "ck"), os.path.join(OUT, "log")
if MODE == "lifecycle":
    out = {"first": run(["--phases", "2", "--checkpoint-dir", ck, "--checkpoint-every", "2",
                         "--eval-every", "1", "--trace-sample", "1", "--logdir", logdir,
                         "--profile-window", "1:1", "--obs-port", "0",
                         "--obs-host", "127.0.0.1"]),
           "resumed": run(["--phases", "2", "--checkpoint-dir", ck, "--resume"])}
else:
    if mesh.rank == 1:
        # An hour ahead from the second reading on (the first sets the
        # deadline): this rank's own clock would stop it at its first check.
        real, calls = time.monotonic, [0]

        def ahead():
            calls[0] += 1
            return real() + (3600.0 if calls[0] > 1 else 0.0)

        pipeline_mod.time = types.SimpleNamespace(monotonic=ahead, time=time.time)
    out = {"minutes": run(["--phases", "1000", "--minutes", "0.1", "--overlap-learner", "1",
                           "--checkpoint-dir", ck, "--checkpoint-light"])}
torch.save(out, os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


def _cli_world(tmp_path_factory, mode):
    out = tmp_path_factory.mktemp(mode)
    return out, spawn_world(2, f"import time\nMODE = {mode!r}\n" + CLI_BODY, out,
                            timeout=120)


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """A run with a final checkpoint, then its ``--resume``."""
    return _cli_world(tmp_path_factory, "lifecycle")


def test_cli_walker_spmd2_pipeline_runs_on_both_ranks(cli_world, capsys):
    from r2d2dpg_tpu import topology as jtopology
    from r2d2dpg_tpu import train as jtrain
    from r2d2dpg_torch.train import main

    logdir, (r0, r1) = cli_world[0] / "log", cli_world[1]
    got, other = r0["first"], r1["first"]
    want = jtopology.resolve(jtrain.parse_args(
        ["--config", "walker_r2d2", "--spmd", "2", "--pipeline", "1"])).describe()
    lines = got["lines"]
    assert lines[:2] == ["backend: cpu", f"topology: {want}"]
    assert any("periodic checkpoints not supported" in x for x in lines)
    assert sum(x.startswith("obs: /metrics") for x in lines) == 1
    assert any("in-run evals (--eval-every) do not run" in x for x in lines)
    assert [x.split()[1] for x in lines if x.startswith("phase ")] == [
        f"{p}/6" for p in range(1, 7)]
    assert sum(x.startswith("pipeline: ") and "overlap_fraction" in x for x in lines) == 1
    assert not any(x.startswith("eval ") for x in lines)
    assert other["lines"] == []  # rank 1 prints nothing
    assert got["train"].step == other["train"].step == 4
    assert _leaves_equal(got["train"], other["train"])
    assert torch.equal(got["priority"], other["priority"])
    # Rank 0 writes the sampled hops; every rank captures its profile window.
    import json

    trace = json.loads((logdir / "trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"]]
    for hop in ("collect", "enqueue", "arena_add", "learn"):
        assert names.count(hop) == 2, hop
    assert len(list((logdir / "profile_window").glob("profile_p1-1_pid*.json"))) == 2
    # The same schedule as the run at D = 1.  (Its numbers are not held
    # here: at walker width from the seed's init, the actions' last-ulp
    # differences between 4-row and 2-row products grow in the physics,
    # already in the phase-locked --spmd 2 against --spmd 1; the executor
    # test above holds D = 2 and 4 to D = 1 with exact actions.)
    one = main(WALKER_CLI + ["--spmd", "1", "--phases", "2"])
    capsys.readouterr()
    assert (one.phase_idx, one.env_steps, one.train.step) == (
        got["phase_idx"], got["env_steps"], got["train"].step)


def test_cli_final_checkpoint_resumes_at_spmd2(cli_world):
    from r2d2dpg_torch.utils.checkpoint import CheckpointManager

    out, (r0, r1) = cli_world
    # Each run's final save, the global state: rank 0 wrote phase 6's and
    # every rank resumed from it; the resumed run then saved phase 8's.
    assert CheckpointManager(str(out / "ck")).all_steps() == [6, 8]
    res = r0["resumed"]
    assert "resumed from phase 6 (learner step 4)" in res["lines"]
    assert [x.split()[1] for x in res["lines"] if x.startswith("phase ")] == ["7/8", "8/8"]
    assert r1["resumed"]["lines"] == []
    assert res["phase_idx"] == r1["resumed"]["phase_idx"] == 8
    assert res["train"].step == r1["resumed"]["train"].step == 8
    assert _leaves_equal(res["train"], r1["resumed"]["train"])
    assert res["env_steps"] == 8 * 20 * 4


def test_cli_minutes_stops_every_rank_after_the_same_drain(tmp_path_factory):
    """Rank 1's clock is an hour ahead: rank 0's decides, for both.  (With
    ``--overlap-learner 1``, which the pipeline's collector leaves aside,
    and a light final checkpoint, rank 0's.)"""
    from r2d2dpg_torch.utils.checkpoint import CheckpointManager

    out, ranks = _cli_world(tmp_path_factory, "minutes")
    r0, r1 = (r["minutes"] for r in ranks)
    assert CheckpointManager(str(out / "ck"), light=True).all_steps() == [r0["phase_idx"]]
    fill = 4  # walker_r2d2 at 4 envs: 3 warm-up + 1 fill phases
    assert r0["phase_idx"] == r1["phase_idx"] > fill
    assert r0["train"].step == r1["train"].step == 2 * (r0["phase_idx"] - fill)
    assert _leaves_equal(r0["train"], r1["train"])
    assert r0["env_steps"] == r1["env_steps"] == r0["phase_idx"] * 20 * 4


def _spawn_rcs(world, body, out_dir, timeout):
    """``spawn_world``'s processes, for bodies that may exit nonzero:
    returns each rank's (returncode, output)."""
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
    return [(p.returncode, out) for p, out in zip(procs, outs)]


ERR_BODY = f"WALKER_CLI = {WALKER_CLI!r}\n" + """
from r2d2dpg_torch import train
try:
    train.main(["--config", "pendulum_tiny", "--spmd", "2", "--pipeline", "1",
                "--device", "cpu"])
    err = None
except ValueError as e:
    err = str(e)
with open(os.path.join(OUT, f"err{mesh.rank}.txt"), "w") as f:
    f.write(repr(err))
train.main(WALKER_CLI + ["--spmd", "2", "--phases", "4", "--nan-inject-phase", "1",
                         "--logdir", os.path.join(OUT, "log")])
"""


def test_cli_nan_inject_exits_2_and_spmd_trainer_gets_jax_message(tmp_path):
    """``--nan-inject-phase 1``: every rank's watchdog trips after the
    same drain (the metrics are mesh means) and every rank exits 2, none
    left in a collective; before it, ``pendulum_tiny`` (a tensor env, so an
    ``SPMDTrainer``) refuses with JAX's executor message on both ranks."""
    import json
    import types

    from r2d2dpg_tpu.training.pipeline import PipelineExecutor as JExecutor

    with pytest.raises(ValueError) as want:
        JExecutor(types.SimpleNamespace(axis="dp"))
    got = _spawn_rcs(2, ERR_BODY, tmp_path, timeout=120)
    for rank, (rc, out) in enumerate(got):
        assert rc == 2, f"rank {rank}:\n{out[-3000:]}"
        assert "watchdog: DIVERGENCE" in out
        assert (tmp_path / f"err{rank}.txt").read_text() == repr(str(want.value))
    events = [json.loads(x) for x in (tmp_path / "log" / "flight.jsonl").open()]
    kinds = [e["kind"] for e in events]
    assert "watchdog_trip" in kinds and "abort" in kinds
