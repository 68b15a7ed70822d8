"""Data-parallel learner: capacity-split replay, batch split over the ranks.

Port of ``r2d2dpg_tpu/parallel/dp_learner.py``.  The layout contract is
JAX's:

| state | layout |
|---|---|
| params, optimizer state, draws, counters | replicated |
| env side (``--actors 0``: the in-process collect) | replicated: one logical stream |
| replay arena (data, priority, meta) | one contiguous capacity block of ``C/D`` per rank |
| ring cursor, ``total_added`` | replicated |
| learner batch | ``B/D`` rows per rank |

JAX annotates shardings and lets GSPMD place the collectives; here they
are explicit, one process per device:

- ``CapacityBlockArena`` (``replay/arena.py``) owns the replay
  collectives: the global prioritized draw over the all-gathered block
  priorities (every rank draws the same ``B`` indices from the same
  replicated uniforms), a reduce-scatter that hands each rank its ``B/D``
  rows, and the write-back through the scatter kernel on the rank's block.
- The learner averages the critic and actor gradients over the mesh
  (``R2D2DPG.bind_mesh``: the trainer binds it, as GSPMD inserts the psum,
  so the agent it is given keeps ``axis_name=None`` as JAX requires).
- ``_reshard_batch`` keeps this rank's columns of the IS weights and the
  smoothing normal (both replicated over the whole batch; the rows come
  from the arena, or from ``_put_staged(axis=1)`` on the sampler path).
- ``_pmean`` averages the learner metrics, which each rank computes on its
  ``B/D`` rows.
- ``_reshard_add`` is the base identity: every rank already holds the
  ``B`` fresh rows (the replicated collect, or the whole staged batch),
  and the arena keeps the ones that fall in its block.

So a world of one is bitwise the plain ``Trainer`` (every collective is
the identity there), and a world of D computes the same function up to
the order of its sums.  ``lstate_shardings`` has no counterpart: eager
torch keeps each tensor where it was made, so there is no output layout
to pin.  A checkpoint holds the global state (``parallel/layout.py``):
the capacity blocks concatenated, the rest rank 0's; its draws are
replicated, so it resumes at any D that divides capacity, batch and
``num_envs``.

The fleet feeds it through rank 0 (``parallel/control.py``): rank 0 runs
the ingest server, the supervisor and the drain (or pull) loop, and
broadcasts each iteration's control record and packed batch; every other
rank runs the follower loop on the same trainer, so every rank holds the
whole staged batch (axis 0) or keeps its ``B/D`` rows of a pulled one
(axis 1), and the sampler's TD priorities are gathered back to rank 0 in
global batch order for its PRIO frames.
"""

from __future__ import annotations

from r2d2dpg_torch.agents.ddpg import R2D2DPG
from r2d2dpg_torch.envs.core import Environment
from r2d2dpg_torch.models.actor_critic import require_lstm_core
from r2d2dpg_torch.obs.registry import get_registry
from r2d2dpg_torch.parallel.layout import MeshState
from r2d2dpg_torch.parallel.mesh import DP_AXIS, Mesh, sharded
from r2d2dpg_torch.parallel.spmd import pmean_metrics
from r2d2dpg_torch.replay.arena import CapacityBlockArena
from r2d2dpg_torch.training.trainer import Metrics, Trainer, TrainerConfig
from r2d2dpg_torch.tree import tree_leaves, tree_map


class DPLearnerTrainer(MeshState, Trainer):
    """Capacity-split replay + data-parallel learner on a ``dp`` mesh.

    ``config`` is global (total capacity, global batch size)."""

    axis = None  # the collectives live in the arena, the agent and _pmean

    def __init__(
        self,
        env: Environment,
        agent: R2D2DPG,
        config: TrainerConfig,
        mesh: Mesh,
    ):
        if agent.config.axis_name is not None:
            raise ValueError(
                "DPLearnerTrainer uses pjit-style gradient sync; build the "
                "agent with axis_name=None (got "
                f"{agent.config.axis_name!r})"
            )
        for net in (agent.actor, agent.critic):
            require_lstm_core(net, "DPLearnerTrainer")
        d = mesh.shape[DP_AXIS]
        # capacity: the arena splits over it; batch_size: the learner splits
        # over it; num_envs: staged batches arrive in multiples of it.
        for field in ("capacity", "batch_size", "num_envs"):
            if getattr(config, field) % d:
                raise ValueError(
                    f"TrainerConfig.{field}={getattr(config, field)} must "
                    f"be divisible by the mesh size {d}"
                )
        self.mesh = mesh
        self.num_devices = d
        super().__init__(env, agent.bind_mesh(mesh, axis_name=DP_AXIS), config,
                         mesh.device)
        self.arena = CapacityBlockArena(
            config.capacity, mesh,
            prioritized=config.prioritized, alpha=config.priority_alpha,
        )
        reg = get_registry()
        self._obs_shard_occ = reg.gauge(
            "r2d2dpg_dp_shard_occupancy",
            "filled replay slots in this dp shard's capacity block",
            labelnames=("shard",),
        )
        self._obs_learn_width = reg.gauge(
            "r2d2dpg_dp_shard_learn_width",
            "staged sequences per dp shard in the most recent drain "
            "dispatch (global staged B / mesh size)",
        )

    # ----------------------------------------------------- distribution hooks
    def _pmean(self, metrics: Metrics) -> Metrics:
        return pmean_metrics(self.mesh, metrics)

    def _reshard_batch(self, batch, weights, normal):
        """This rank's columns of the replicated weights ``[B]`` and normal
        ``[U + n, B, A]``; the rows of ``batch`` already are this rank's."""
        place = sharded(self.mesh)
        return (batch, place(weights),
                None if normal is None else place(normal, axis=1))

    # ---------------------------------------------------------- fleet hooks
    def _put_staged(self, staged, axis: int = 0):
        """A fleet batch for this rank.

        ``axis=0`` is the staged fleet layout (leaves ``[B, ...]``): every
        rank keeps the whole batch, since the ring add needs every fresh
        row and keeps the ones in its block.  ``axis=1`` is the sampler's
        pulled layout (leaves ``[K, B, ...]``): each rank keeps its ``B/D``
        rows, so the learn step's rows arrive already split.  The width
        must divide the mesh (JAX replicates an indivisible width on one
        process; a world of one divides every width)."""
        b = int(tree_leaves(staged)[0].shape[axis])
        if b % self.num_devices:
            raise ValueError(
                f"staged width {b} does not divide the "
                f"{self.num_devices}-device mesh"
            )
        if axis == 0:
            return staged
        place = sharded(self.mesh)
        return tree_map(lambda x: place(x, axis=axis), staged)

    def _is_sharded(self, path) -> bool:
        """The arena's buffers split into capacity blocks; the rest is
        replicated."""
        return path[0] == "arena" and path[1:2] in (("data",), ("priority",), ("meta",))

    # ------------------------------------------------------------------ obs
    def dp_note_learn_width(self, b: int) -> None:
        """Record the per-rank rows of a real drain-learn dispatch (the
        fleet drain loop calls it at the dispatch site)."""
        split = b % self.num_devices == 0
        self._obs_learn_width.set(float(b // self.num_devices if split else b))

    def _log_extra_refs(self, arena_state) -> list:
        return [self.arena.per_shard_occupancy(arena_state, self.num_devices)]

    def _log_extra_publish(self, fetched) -> None:
        for i, v in enumerate(fetched[0]):
            self._obs_shard_occ.labels(shard=str(i)).set(float(v))
