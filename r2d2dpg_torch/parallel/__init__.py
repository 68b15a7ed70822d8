"""The multi-device learner paths over ``torch.distributed``.

Port of ``r2d2dpg_tpu/parallel/``.  The design, decided before the code:

- **One process per device.**  JAX drives D devices from one process; the
  port runs D processes, one device each, over ``torch.distributed``:
  NCCL between cards, gloo between CPU processes (``distributed.py``).
- **World size 1 runs in-process.**  ``--spmd 1`` and ``--learner-dp 1``
  bring up a process group of one (``make_mesh(1)``), so one card runs the
  same collective calls as D.  D > 1 is launched with ``torchrun
  --nproc-per-node D -m r2d2dpg_torch.train ...``; a CLI whose ``--spmd D``
  or ``--learner-dp D`` differs from ``WORLD_SIZE`` refuses at startup.
- **Rank r** computes on ``cuda:<LOCAL_RANK>``, or on the CPU when the
  caller asks for it (a missing card is an error).
- **Side effects stay on rank 0**: logs, the exporter, ``topology.txt``
  and flight dumps (``distributed.is_primary``).

Two trainers, as in JAX:

- ``SPMDTrainer`` (``--spmd D``): every rank runs the whole loop on its
  ``1/D`` of the envs, the window and the arena; gradients averaged.
- ``DPLearnerTrainer`` (``--learner-dp D``): params, draws and counters
  replicated, the batch split ``B/D`` per rank, the arena split into
  contiguous capacity blocks of ``C/D``; the priority scatter kernel runs
  on every rank's block.

``HostSPMDTrainer`` (the host-pool trainer) waits for the DM-Control envs.
"""

from r2d2dpg_torch.parallel import distributed
from r2d2dpg_torch.parallel.dp_learner import DPLearnerTrainer
from r2d2dpg_torch.parallel.mesh import DP_AXIS, Mesh, make_mesh, replicated, sharded
from r2d2dpg_torch.parallel.spmd import SPMDTrainer

__all__ = [
    "DP_AXIS",
    "DPLearnerTrainer",
    "Mesh",
    "SPMDTrainer",
    "distributed",
    "make_mesh",
    "replicated",
    "sharded",
]
