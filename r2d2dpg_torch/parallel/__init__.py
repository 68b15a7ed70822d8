"""The multi-device learner paths over ``torch.distributed``.

Port of ``r2d2dpg_tpu/parallel/``.  **The one rule: rank 0 decides, and
every rank hears the decision before it acts.**  Any choice read from host
state (the clock, the ingest queue, the supervisor, the shards, the health
checks, an exception on rank 0) reaches every rank through a broadcast
before any rank acts on it (``control.py``): the fleet loops begin each
iteration with one fixed-shape control record from rank 0, an exception
on rank 0 sends ``error`` before it propagates, and the ``--minutes``
deadline is rank 0's (``Trainer._agree``).  A world of one runs the same
broadcasts.  The design, decided before the code:

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
- **Side effects stay on rank 0**: logs, the exporter, ``topology.txt``,
  flight dumps, checkpoint files and the eval line
  (``distributed.is_primary``).
- **The fleet is rank 0's** (``--actors N --learner-dp D``): one ingest
  server and one supervisor for the whole fleet, as JAX's single process
  has; each drain's (or pull's) packed batch reaches every rank by one
  broadcast of the device buffer, and ranks > 0 run ``follow_drain`` /
  ``follow_pull`` on the same trainer.
- **A checkpoint is the global state** in JAX's layout (``layout.py``):
  saved by every rank, gathered to rank 0 one field at a time and written
  there; every rank reads the same files back and keeps its rows.

Two trainers, as in JAX:

- ``SPMDTrainer`` (``--spmd D``): every rank runs the whole loop on its
  ``1/D`` of the envs, the window and the arena; gradients averaged.
- ``DPLearnerTrainer`` (``--learner-dp D``): params, draws and counters
  replicated, the batch split ``B/D`` per rank, the arena split into
  contiguous capacity blocks of ``C/D``; the priority scatter kernel runs
  on every rank's block.

And ``HostSPMDTrainer`` (``hybrid.py``) for host-pool envs
(``DMCHostEnv``): each rank steps its own pool of ``num_envs/D`` envs from
the host, the arena is replicated, the learner batch split ``B/D`` per
rank; ``--spmd D`` with a DM-Control config, or ``--overlap-learner 1`` on
a mesh of one.
"""

from r2d2dpg_torch.parallel import distributed
from r2d2dpg_torch.parallel.dp_learner import DPLearnerTrainer
from r2d2dpg_torch.parallel.hybrid import HostSPMDTrainer
from r2d2dpg_torch.parallel.mesh import DP_AXIS, Mesh, make_mesh, replicated, sharded
from r2d2dpg_torch.parallel.spmd import SPMDTrainer

__all__ = [
    "DP_AXIS",
    "DPLearnerTrainer",
    "HostSPMDTrainer",
    "Mesh",
    "SPMDTrainer",
    "distributed",
    "make_mesh",
    "replicated",
    "sharded",
]
