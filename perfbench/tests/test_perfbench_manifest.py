"""``BENCHMARK.json`` names only files the harness has, and each per-layer
reader reads what it should from a traced run's context and nothing where
there is nothing to read."""

import json
import re

import pytest
import torch

from perfbench import harness, readers

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = harness.find_cell(cell, MANIFEST)
    assert (harness.HERE / "drivers" / f"{c.traffic['kind']}.py").exists()
    assert c.end_to_end and c.per_layer
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    for m in c.per_layer:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in c.end_to_end}
    assert c.limits and all(v >= 0 for v in c.limits.values())


def test_names_units_and_bounds_keep_to_the_contract():
    every = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]] + CELLS
    every += [c["name"] for c in MANIFEST["configs"]]
    assert len(every) == len(set(every))
    assert all(NAME.match(n) for n in every)
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _ctx(**kw):
    ctx = {"trace": {"units": 2, "wall_s": 0.4, "busy_s": 0.1, "kernels": 100,
                     "by_name": {"(anonymous namespace)::scatter_last_wins(float*)": (2, 4e-6),
                                 "gemm": (50, 0.05),
                                 "ncclDevKernel_AllGather_RING_LL(ncclDevComm*)": (4, 0.002)}},
           "spans": {"sample": [0.001, 0.003]}, "units": 10, "window_s": 2.0,
           "unit_flops": 1e12, "dtype": "float32", "scatter_bytes": [1024, 1024],
           "health": {"step_p50_ms": 1.5, "batch_occupancy": 0.9},
           "device": torch.device("cpu")}
    ctx.update(kw)
    return ctx


def test_readers_read_the_context():
    ctx = _ctx()
    assert harness.read_metric("replay_sample_ms.learn", ctx) == pytest.approx(2.0)
    assert harness.read_metric("kernels_per_step.learn", ctx) == 50
    assert harness.read_metric("device_ms_per_phase.train", ctx) == pytest.approx(50.0)
    assert harness.read_metric("device_idle.serve", ctx) == pytest.approx(0.75)
    assert harness.read_metric("policy_step_ms.serve", ctx) == 1.5
    assert harness.read_metric("batch_occupancy.serve", ctx) == 0.9
    assert harness.read_metric("collective_ms_per_step.learn_dp4", ctx) == pytest.approx(1.0)
    del ctx["trace"]["by_name"]["ncclDevKernel_AllGather_RING_LL(ncclDevComm*)"]
    assert harness.read_metric("collective_ms_per_step.learn_dp4", ctx) is None


def test_shares_of_a_peak_need_a_known_card(monkeypatch):
    ctx = _ctx()
    assert harness.read_metric("learner_mfu.learn", ctx) is None  # a CPU run reads no share
    monkeypatch.setattr(readers, "card", lambda ctx: readers.PEAKS["cards"]["H100"])
    assert harness.read_metric("learner_mfu.learn", ctx) == pytest.approx(100 * 5e12 / 6.7e13)
    want = 100 * (1024 / 3.35e12) / 2e-6
    assert harness.read_metric("scatter_roofline.train", ctx) == pytest.approx(want)


def test_readers_return_nothing_without_a_trace():
    ctx = _ctx(trace=None, spans={}, health={}, scatter_bytes=[])
    for m in MANIFEST["per_layer"]:
        assert harness.read_metric(m["name"], ctx) is None, m["name"]
