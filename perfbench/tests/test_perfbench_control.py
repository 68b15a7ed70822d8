"""The control, the plain reference in TF32 in the program's place, comes
out not correct under each training cell's limits, and so do the planted
faults of ``control.py``; the sound program comes out correct.  At toy
size on the CPU here; at the cells' own sizes on the card (``cuda``)."""

import pytest
import torch

from perfbench import control, harness
from perfbench.tests import tiny

KINDS = ["learn", "train", "learn_dp"]


def _fails(reading, limits):
    return any(reading[k] > limits[k] for k in limits if k in reading)


@pytest.mark.parametrize("kind", KINDS)
def test_control_and_faults_fail_at_toy_size(kind):
    c = tiny.cell(kind, tiny.config_file("pendulum_tiny"))
    limits = c.limits
    readings = control.training_readings(c, 13, torch.device("cpu"))
    names = ["control", "half_batch", "index_altered"]
    names += ["exchange_left_out"] if kind == "learn_dp" else []
    assert set(names) == set(readings)
    for name in names:
        assert _fails(readings[name], limits), (name, readings[name])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["walker_r2d2.learn", "cheetah_pixels.learn",
                                  "walker_r2d2.train"])
def test_control_fails_at_the_cells_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    c = harness.find_cell(cell)
    readings = control.training_readings(c, 2**31 + 5, torch.device("cuda", 0))
    assert _fails(readings["control"], c.limits), readings["control"]
