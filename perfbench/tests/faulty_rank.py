"""Child ranks of the learn loop on several chips with a fault planted, for
the tests: the mix's ``planted`` names it.

Faults of the launcher, in one rank:

- ``exit``: rank 2 joins the process group, then fails;
- ``hang``: rank 1 never gets ready (the set-up limit ends the run);
- ``forbidden``: rank 3 runs its whole session with a JAX module loaded.

Faults of the timed path, in every rank: ``PLANTS``, each given
``monkeypatch`` (the test's process, rank 0) or a stand-in whose
``setattr`` is the builtin (a child).
"""

from __future__ import annotations

import dataclasses
import sys
import time
import types

from perfbench.drivers import learn_dp
from perfbench.tests import test_perfbench_faults as faults


def _no_exchange(mp):
    """Each rank updates on its own rows' gradients: the gradients' pmean
    left out."""
    from r2d2dpg_torch.agents.ddpg import R2D2DPG

    mp.setattr(R2D2DPG, "_pmean_grads", lambda self, grads: grads)


def _index_altered(mp):
    """The global draw's first index moved by one where it is produced; the
    rows stay the drawn ones."""
    from r2d2dpg_torch.replay.arena import CapacityBlockArena

    real = CapacityBlockArena._sample

    def sample(self, state, batch_size, generator, uniforms):
        res = real(self, state, batch_size, generator, uniforms)
        idx = res.indices.clone()
        idx[0] = (idx[0] + 1) % self.capacity
        return dataclasses.replace(res, indices=idx)

    mp.setattr(CapacityBlockArena, "_sample", sample)


PLANTS = {"unchanged_state": faults._unchanged_state, "half_batch": faults._half_batch,
          "no_exchange": _no_exchange, "index_altered": _index_altered}


def follow(run, group):
    planted = run.cell.traffic["planted"]
    if planted in PLANTS:
        PLANTS[planted](types.SimpleNamespace(setattr=setattr))
    if planted == "exit" and group.rank == 2:
        group.join_group(learn_dp.program.device(run.device))
        raise RuntimeError("planted: rank 2 fails after joining the group")
    if planted == "hang" and group.rank == 1:
        while True:
            time.sleep(1)
    report = learn_dp.follow(run, group)
    if planted == "forbidden" and group.rank == 3:
        sys.modules["jax"] = types.ModuleType("jax")
    return report
