"""The rank launcher and the learn loop on several chips, at toy size on the
CPU: a world of 4 over gloo runs the window and comes out correct against
the one-chip reference; the timed path broken in every rank (the state
left unchanged, half the batch, the exchange between chips left out, an
index altered) comes out not correct; and a child that fails, hangs or
loads a forbidden module ends the run with a failed result within its time
limit, leaving no process behind."""

import json
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.drivers import learn_dp
from perfbench.tests import faulty_rank, tiny

CPU_WORLD = {"world": 4}


def test_a_world_of_four_runs_the_window_and_is_correct():
    conf = tiny.config_file("pendulum_tiny")
    _, window, out = tiny.run(tiny.cell("learn_dp", conf, **CPU_WORLD), seed=2**31 + 3,
                              seconds=0.5)
    assert out["correct"], out["checks"]
    assert window.attempted > 0 and window.failed == 0
    assert window.checks["rank_faults"] == 0 and window.checks["index_misses"] == 0
    assert out["device"]["count"] == 4
    assert set(out["metrics"]) == {"learner_steps_per_s", "setup_s"}
    # Each rank's 2 rows of the batch of 8: the same losses as one chip's
    # 8 rows, to rounding.
    _, one, _ = tiny.run(tiny.cell("learn", conf), seed=2**31 + 3)
    assert window.checks["loss_gap"] <= 10 * max(one.checks["loss_gap"], 1e-7)


def test_a_traced_world_reads_rank_zeros_trace():
    conf = tiny.config_file("pendulum_tiny")
    _, window, out = tiny.run(tiny.cell("learn_dp", conf, **CPU_WORLD), seed=7, seconds=0.3,
                              trace=True)
    assert out["correct"], out["checks"]
    assert window.trace["units"] == 3
    # Every device reading is rank 0's trace, as the idle share's reader takes it.
    assert (out["device"]["busy_s"], out["device"]["window_s"]) == (
        window.trace["busy_s"], window.trace["wall_s"])
    assert "replay_sample_ms.learn" in out["metrics"]
    assert "collective_ms_per_step.learn_dp4" not in out["metrics"]  # no NCCL kernels here


@pytest.mark.parametrize("fault", sorted(faulty_rank.PLANTS))
def test_the_timed_path_broken_in_every_rank_comes_out_not_correct(monkeypatch, fault):
    faulty_rank.PLANTS[fault](monkeypatch)
    monkeypatch.setattr(learn_dp, "FOLLOWER", "perfbench.tests.faulty_rank")
    c = tiny.cell("learn_dp", tiny.config_file("pendulum_tiny"), planted=fault, **CPU_WORLD)
    _, _, out = tiny.run(c, seed=21, seconds=0.3)
    assert not out["correct"], out["checks"]
    assert out["checks"]["rank_faults"]["value"] == 0


RUN = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.drivers import learn_dp
from perfbench.tests import tiny
from perfbench import ranks
learn_dp.FOLLOWER = "perfbench.tests.faulty_rank"
ranks.SETUP_TIMEOUT_S = 20.0
c = tiny.cell("learn_dp", tiny.config_file("pendulum_tiny"), world=4, planted={planted!r})
r, w, out = tiny.run(c, seed=11, seconds=0.5)
sys.exit(harness.finish(r, w))
"""


@pytest.mark.parametrize("planted", ["exit", "hang", "forbidden"])
def test_a_child_at_fault_gives_a_failed_result_in_time(planted):
    mark = f"perfbench-test-{uuid.uuid4().hex}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PERFBENCH_TEST_MARK=mark)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RUN.format(root=str(harness.ROOT),
                                                           planted=planted)],
                          capture_output=True, text=True, timeout=150, cwd=harness.ROOT,
                          env=env)
    took = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["rank_faults"] == {"value": 1.0, "limit": 0}
    assert "perfbench: " in proc.stderr
    assert took < 120
    assert not _processes_with(mark)


LONG_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import harness, ranks
from perfbench.tests import tiny
ranks.SETUP_TIMEOUT_S, ranks.MARGIN_S = 12.0, 6.0
assert ranks.deadline_s({seconds!r}) == 12.0 + {seconds!r} + 6.0
c = tiny.cell("learn_dp", tiny.config_file("pendulum_tiny"), world=4)
r, w, out = tiny.run(c, seed=2**31 + 29, seconds={seconds!r})
print(json.dumps({{"window_s": w.readings["window_s"]}}), file=sys.stderr)
sys.exit(harness.finish(r, w))
"""


def test_the_deadline_grows_with_the_window():
    """A window longer than the set-up limit and the margin together (which
    a fixed deadline of their sum would have ended) runs to its end."""
    seconds = 20.0
    proc = subprocess.run([sys.executable, "-c", LONG_RUN.format(root=str(harness.ROOT),
                                                                seconds=seconds)],
                          capture_output=True, text=True, timeout=150, cwd=harness.ROOT,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["checks"]["rank_faults"]["value"] == 0


def _processes_with(mark: str):
    """Processes whose environment holds ``mark``: what a run left behind."""
    found = []
    for d in Path("/proc").iterdir():
        try:
            if d.name.isdigit() and mark.encode() in (d / "environ").read_bytes():
                found.append(d.name)
        except OSError:
            continue
    return found
