"""What decides ``correct``: the numbers a cell's limits name, each held to
its limit, and the loss gaps they are taken from."""

import json
import statistics

import pytest

from perfbench import compare, harness
from perfbench.tests import tiny


def _flat_loss_gaps(prog, ref):
    """Every step's loss gaps as one list, loss by loss."""
    gaps = []
    for j in range(len(ref[0])):
        scale = statistics.median(abs(r[j]) for r in ref)
        gaps += [abs(p[j] - r[j]) / max(abs(r[j]), scale, 1e-12) for p, r in zip(prog, ref)]
    return gaps


def test_the_loss_gaps_are_each_steps_and_the_first_steps_alone():
    ref = [(1.25, -3e-3), (1.5, 2e-3), (0.75, -1e-3)]
    prog = [(1.25 + 1e-6, -3e-3 + 2e-9), (1.5, 2e-3 + 7e-8), (0.75 - 3e-5, -1e-3)]
    per_step = compare._loss_gaps(prog, ref)
    assert [g for j in range(2) for g in (s[j] for s in per_step)] == _flat_loss_gaps(prog, ref)
    assert max(max(s) for s in per_step) == max(_flat_loss_gaps(prog, ref))
    assert max(per_step[0]) == pytest.approx(1e-6 / 1.25)


def test_only_the_numbers_a_cell_limits_are_judged():
    got = compare.verdict({"loss_gap": 3e-5, "first_loss_gap": 1e-7}, {"first_loss_gap": 2e-5})
    assert got == [{"name": "first_loss_gap", "value": 1e-7, "limit": 2e-5, "ok": True}]
    missing = compare.verdict({"grad_gap": 0.0}, {"grad_gap": 1e-5, "change_gap": 1e-5})
    assert [c["ok"] for c in missing] == [False, True] and missing[0]["value"] is None


def _learn_cells():
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in manifest["workloads"]
            if harness.find_cell(w["name"], manifest).traffic["kind"] == "learn"]


@pytest.mark.parametrize("name", _learn_cells())
def test_a_learn_cells_limits_name_numbers_its_driver_gives(name):
    real = harness.find_cell(name)
    conf = tiny.config_file("pendulum_tiny")
    c = tiny.cell("learn", conf, limits=real.limits)
    _, window, out = tiny.run(c, seed=2**31 + 23)
    assert set(real.limits) <= set(window.checks)
    assert set(out["checks"]) == set(real.limits) and out["correct"], out["checks"]
