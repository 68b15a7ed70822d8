"""The fleet in a world of D ranks: rank 0 leads, the other ranks follow.

``FleetLearner`` and ``SamplerLearner`` run on rank 0 of a dp mesh and
broadcast each iteration's control record and packed batch
(``parallel/control.py``); ranks > 0 run ``follow_drain`` /
``follow_pull`` on the same ``DPLearnerTrainer``.  Held here at
pendulum_tiny with gloo child processes (``spawn_world``, each world under
a timeout, so a hang fails instead of stalling the run):

- **The drain follower.**  Eight staged batches (numpy, from a seed; odd
  ones with the producer's priorities, all with provenance) reach rank 0's
  staging queue from an in-process source: 2 absorbs and 6 drain-learns
  at every D, so the drained counts, the control records (9: one per
  drain and the STOP) and the payload broadcasts (8) are exact on every
  rank.  At D = 2 and 4 the params are within atol 1e-5, rtol 1e-4 of the
  D = 1 ``FleetLearner`` fed the same batches, and the concatenated
  capacity blocks' priorities likewise (the dp learner test's tolerance:
  a rank's step sums over its ``B/D`` rows, then the gradient average).
- **The pull follower.**  A loopback ``ShardSet`` of 2 shards filled with
  the same batches on rank 0, 3 pull-learn phases; the shard draws are
  numpy's ``default_rng(seed)`` on rank 0 at every D.  The PRIO writes
  rank 0 makes (shard, slots, generations) equal D = 1's exactly and their
  priorities within atol 1e-5, rtol 1e-4; no other rank writes any.
- **A rank-0 error.**  Rank 0's ``health_fn`` raises after the third
  drain-learn (the queue has run dry): rank 0 raises its own error and
  every follower ``RuntimeError("rank 0 stopped: RuntimeError")``.
- **The skewed clock.**  At D = 2 under ``--minutes``, rank 1's
  ``time.monotonic`` jumps an hour ahead after the first phase: both
  ranks stop after the same phase (rank 0's clock decides), rc 0.
- **The CLI.**  ``train.main --actors 2 --learner-dp 2 --phases 3`` (and
  with ``--replay-shards 2``) with real actor processes: rank 0 prints
  the ``topology:`` line equal to JAX's ``describe()``, both ranks end on
  the same learner step and params (bitwise: replicated).
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import _leaves_equal, spawn_world

TOL = dict(atol=1e-5, rtol=1e-4)
N_BATCHES = 8
PARAMS = ("actor_params", "critic_params", "target_actor_params", "target_critic_params")

# The staged batches every world is fed: the learner's own layout
# (``staged_template``), values from one numpy seed.
BATCHES = f"N_BATCHES = {N_BATCHES}\n" + """
import threading
import numpy as np
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.fleet import FleetConfig
from r2d2dpg_torch.fleet.ingest import staged_template
from r2d2dpg_torch.tree import tree_map

t = PENDULUM_TINY.build_dp_learner(mesh, False, "cpu")
state = t.init()
rng = np.random.default_rng(7)


def batch(i):
    b = staged_template(state.window, 4, i % 2 == 1, True)
    b.seq.obs[:] = rng.normal(size=b.seq.obs.shape)
    b.seq.action[:] = rng.uniform(-1, 1, size=b.seq.action.shape)
    b.seq.reward[:] = rng.normal(size=b.seq.reward.shape)
    b.seq.discount[:] = 1.0
    b.seq.reset[:] = 0.0
    tree_map(lambda c: c.__setitem__(slice(None), 0.1 * rng.normal(size=c.shape)),
             b.seq.carries)
    if b.priorities is not None:
        b.priorities[:] = rng.uniform(0.5, 2.0, size=4)
    b.behavior_version[:] = i
    b.collect_id[:] = i
    return {"staged": b, "actor_id": str(i % 2), "ep_return_sum": -1.0,
            "ep_count": 1.0, "env_steps_delta": 16.0}


msgs = [batch(i) for i in range(N_BATCHES)]
"""

DRAIN_BODY = BATCHES + """
from r2d2dpg_torch.fleet import FleetLearner
from r2d2dpg_torch.fleet.ingest import follow_drain

if mesh.rank == 0:
    learner = FleetLearner(t, FleetConfig(num_actors=2, idle_timeout_s=30.0))
    learner.start()
    feed = threading.Thread(target=lambda: [learner.queue.put(m) for m in msgs])
    feed.start()
    try:
        out = learner.run(len(msgs) - 2, state=state, log_every=2, log_fn=lambda *_: None)
    finally:
        feed.join()
        learner.close()
    stats = learner.stats()
else:
    out = follow_drain(t, state)
    stats = {}
cp = t.control
torch.save({"train": out.train, "priority": out.arena.priority, "phase_idx": out.phase_idx,
            "stats": stats, "records": cp.records, "payloads": cp.payloads},
           os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""

PULL_BODY = BATCHES + """
from r2d2dpg_torch.fleet import SamplerLearner
from r2d2dpg_torch.fleet.sampler import follow_pull

writes = []
if mesh.rank == 0:
    learner = SamplerLearner(t, FleetConfig(num_actors=2), num_shards=2,
                             total_capacity=64)
    learner.start()
    for shard_id, shard in enumerate(learner.shards.shards):
        plain = shard.update_priorities

        def record(slots, gens, prios, _plain=plain, _id=shard_id):
            writes.append((_id, np.array(slots), np.array(gens), np.array(prios)))
            return _plain(slots, gens, prios)

        shard.update_priorities = record
    for i, m in enumerate(msgs):
        learner.shards.add(i % 2, m)
    try:
        out = learner.run(3, state=state, log_every=1, log_fn=lambda *_: None)
    finally:
        learner.close()
else:
    out = follow_pull(t, state)
torch.save({"train": out.train, "writes": writes, "phase_idx": out.phase_idx,
            "records": t.control.records},
           os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


def _params_close(got, want):
    for name in PARAMS:
        for k, v in getattr(want, name).items():
            np.testing.assert_allclose(getattr(got, name)[k].numpy(), v.numpy(), **TOL,
                                       err_msg=f"{name}.{k}")


@pytest.fixture(scope="module")
def drain_dp1(tmp_path_factory):
    return spawn_world(1, DRAIN_BODY, tmp_path_factory.mktemp("drain1"), timeout=180)[0]


@pytest.fixture(scope="module")
def pull_dp1(tmp_path_factory):
    return spawn_world(1, PULL_BODY, tmp_path_factory.mktemp("pull1"), timeout=180)[0]


@pytest.mark.parametrize("world", [2, 4])
def test_drain_follower_matches_dp1(world, drain_dp1, tmp_path):
    ref = drain_dp1
    assert ref["stats"]["train_phases"] == N_BATCHES - 2
    assert ref["stats"]["absorb_drains"] == 2
    assert (ref["records"], ref["payloads"]) == (N_BATCHES + 1, N_BATCHES)
    outs = spawn_world(world, DRAIN_BODY, tmp_path, timeout=180)
    assert outs[0]["stats"]["train_phases"] == N_BATCHES - 2
    assert outs[0]["stats"]["absorb_drains"] == 2
    assert outs[0]["stats"]["control_records"] == N_BATCHES + 1
    for out in outs:
        # Every rank took part in every broadcast and ends on rank 0's phase.
        assert (out["records"], out["payloads"]) == (N_BATCHES + 1, N_BATCHES)
        assert out["phase_idx"] == ref["phase_idx"]
        assert out["train"].step == ref["train"].step == N_BATCHES - 2
        _params_close(out["train"], ref["train"])
    assert all(_leaves_equal(o["train"], outs[0]["train"]) for o in outs[1:])
    prio = torch.cat([o["priority"] for o in outs])
    np.testing.assert_allclose(prio.numpy(), ref["priority"].numpy(), **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_pull_follower_prio_frames_match_dp1(world, pull_dp1, tmp_path):
    ref = pull_dp1
    assert len(ref["writes"]) >= 3 and ref["records"] == 4
    outs = spawn_world(world, PULL_BODY, tmp_path, timeout=180)
    got = outs[0]["writes"]
    assert [w[0] for w in got] == [w[0] for w in ref["writes"]]
    for (shard, slots, gens, prios), (_, rslots, rgens, rprios) in zip(got, ref["writes"]):
        np.testing.assert_array_equal(slots, rslots, err_msg=f"shard {shard}")
        np.testing.assert_array_equal(gens, rgens)
        np.testing.assert_allclose(prios, rprios, **TOL)
    for out in outs:
        assert out["records"] == 4 and out["phase_idx"] == ref["phase_idx"]
        _params_close(out["train"], ref["train"])
    assert all(not o["writes"] for o in outs[1:])
    assert all(_leaves_equal(o["train"], outs[0]["train"]) for o in outs[1:])


ERROR_BODY = BATCHES + """
from r2d2dpg_torch.fleet import FleetLearner
from r2d2dpg_torch.fleet.ingest import follow_drain

drained = []
try:
    if mesh.rank == 0:
        learner = FleetLearner(t, FleetConfig(num_actors=2, queue_depth=8,
                                              idle_timeout_s=30.0))
        learner.start()
        for m in msgs[:5]:
            learner.queue.put(m)

        def health():
            if len(drained) >= 3:
                raise RuntimeError("fleet: the supervisor gave up actor(s) [1]")

        try:
            learner.run(10, state=state, log_every=0, health_fn=health,
                        phase_fn=drained.append)
        finally:
            learner.close()
    else:
        follow_drain(t, state)
    err = None
except RuntimeError as e:
    err = str(e)
torch.save({"err": err, "drained": drained}, os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


def test_rank0_error_stops_every_rank(tmp_path):
    outs = spawn_world(2, ERROR_BODY, tmp_path, timeout=120)
    assert outs[0]["drained"] == [1, 2, 3]
    assert outs[0]["err"] == "fleet: the supervisor gave up actor(s) [1]"
    assert outs[1]["err"] == "rank 0 stopped: RuntimeError"


SKEW_BODY = """
import time
from r2d2dpg_torch import train
from r2d2dpg_torch.training import trainer as trainer_mod

if mesh.rank == 1:
    # An hour ahead from the second reading on (the first sets the
    # deadline): this rank's own clock would stop it after one phase.
    real, calls = time.monotonic, [0]

    def ahead():
        calls[0] += 1
        return real() + (3600.0 if calls[0] > 1 else 0.0)

    trainer_mod.time = type("T", (), {"monotonic": staticmethod(ahead)})
st = train.main(["--config", "pendulum_tiny", "--learner-dp", "2", "--minutes", "0.03",
                 "--log-every", "0", "--device", "cpu"])
torch.save({"phase_idx": st.phase_idx, "step": st.train.step},
           os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


def test_skewed_clock_stops_every_rank_after_the_same_phase(tmp_path):
    outs = spawn_world(2, SKEW_BODY, tmp_path, timeout=120)
    assert outs[0]["phase_idx"] == outs[1]["phase_idx"] > 2
    assert outs[0]["step"] == outs[1]["step"]


CLI_BODY = """
import contextlib, io, json
from r2d2dpg_torch import train
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    st = train.main(["--config", "pendulum_tiny", "--actors", "2", "--learner-dp", "2",
                     "--phases", "3", "--device", "cpu", "--log-every", "1",
                     *json.loads(os.environ["FLAGS"])])
torch.save({"lines": buf.getvalue().splitlines(), "train": st.train},
           os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


@pytest.mark.parametrize("flags", [(), ("--replay-shards", "2")],
                         ids=["central_drain", "replay_shards"])
def test_cli_fleet_into_learner_dp2(flags, tmp_path, monkeypatch):
    import json

    from r2d2dpg_tpu import topology as jtopology
    from r2d2dpg_tpu import train as jtrain

    monkeypatch.setenv("FLAGS", json.dumps(list(flags)))
    outs = spawn_world(2, CLI_BODY, tmp_path, timeout=240)
    want = jtopology.resolve(jtrain.parse_args(
        ["--config", "pendulum_tiny", "--actors", "2", "--learner-dp", "2", *flags])).describe()
    lines = outs[0]["lines"]
    assert f"topology: {want}" in lines
    assert sum(x.startswith("phase ") for x in lines) == 3
    words = next(x for x in lines if x.startswith("fleet: ") and "wall_s" in x).split()[1:]
    stats = dict(zip(words[::2], map(float, words[1::2])))
    # One record per drain or pull (2 absorbs at min_replay 8, then the
    # 3 learns) and the STOP.
    assert stats["control_records"] == (4 if flags else 6)
    assert not any(x.startswith(("phase ", "topology:")) for x in outs[1]["lines"])
    assert outs[0]["train"].step == outs[1]["train"].step == 3
    assert _leaves_equal(outs[0]["train"], outs[1]["train"])


RESUME_BODY = """
import contextlib, io
from r2d2dpg_torch import train
base = ["--config", "pendulum_tiny", "--actors", "2", "--learner-dp", "2", "--device", "cpu",
        "--log-every", "1", "--checkpoint-dir", os.path.join(OUT, "ck")]
first = train.main(base + ["--phases", "3", "--checkpoint-every", "2"])
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    st = train.main(base + ["--phases", "5", "--resume"])
torch.save({"lines": buf.getvalue().splitlines(), "first": first.train.step,
            "train": st.train}, os.path.join(OUT, f"rank{mesh.rank}.pt"))
"""


def test_cli_fleet_resume_at_learner_dp2(tmp_path):
    """Every rank reads the same light checkpoint and counter sidecar,
    held equal across ranks, and the drained count continues (``--phases``
    is the total across incarnations, as in JAX)."""
    outs = spawn_world(2, RESUME_BODY, tmp_path, timeout=240)
    assert [o["first"] for o in outs] == [3, 3]
    assert any(x.startswith("fleet: resumed learner from step 3 (drained 3 phases")
               for x in outs[0]["lines"])
    assert sum(x.startswith("phase ") for x in outs[0]["lines"]) == 2
    assert outs[0]["train"].step == outs[1]["train"].step == 5
    assert _leaves_equal(outs[0]["train"], outs[1]["train"])
