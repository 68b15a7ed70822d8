"""The global state of a trainer on a ``dp`` mesh, and this rank's slice of it.

A checkpoint holds the GLOBAL state in the JAX package's layout
(``r2d2dpg_tpu/parallel/spmd.py::_state_spec``, and the dp learner's
capacity-split arena): a sharded leaf is every rank's block concatenated
along axis 0 in rank order, a replicated leaf is rank 0's.  Which leaves
are sharded is each trainer's ``_is_sharded(path)``, with ``path`` the
field names from ``TrainerState`` down (``("arena", "priority")``).

- ``global_field(state, name)`` is collective: every rank calls it, each
  sharded leaf is gathered to rank 0 one at a time and moved to the host
  there, and rank 0 gets the field (every other rank None).  The
  checkpoint manager writes a field before it gathers the next, so the
  global state is never whole in one place.
- ``local_state(global_state)`` keeps this rank's rows of a global state
  read from disk (every rank reads the same files) and moves them to the
  rank's device.
- A trainer whose ranks draw from streams of their own (``--spmd D``,
  ``draw_streams = D``) stores them as ``RankDraws``: one generator state
  per rank and the world size.  Its full checkpoint resumes only at that
  world size.
- ``_check_replicated`` holds the replicated leaves equal across ranks
  after a restore, with one all-gather of their checksums.
- ``_agree(flag)`` is rank 0's ``flag`` on every rank (one broadcast);
  ``control`` carries the fleet loops' records (``parallel/control.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from r2d2dpg_torch.parallel.control import ControlPlane
from r2d2dpg_torch.training.draws import Draws

Path = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class RankDraws:
    """Per-rank draw streams in a global state: ``[D, n]`` generator states
    in rank order, and D."""

    generator_states: torch.Tensor
    world_size: int


def _map(node: Any, path: Path, fn: Callable[[Any, Path], Any]) -> Any:
    """``node`` rebuilt with ``fn(child, path + (key,))`` for each child of
    a dataclass, dict, list or tuple; other nodes as they are."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: fn(getattr(node, f.name), path + (f.name,))
            for f in dataclasses.fields(node)})
    if isinstance(node, dict):
        return {k: fn(v, path + (str(k),)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(fn(v, path + (str(i),)) for i, v in enumerate(node))
    return node


_CHECKSUM_PERIOD = 65521  # the position weights are 1 + position % this


def _checksum(x: torch.Tensor) -> torch.Tensor:
    """Two int64 sums over ``x``'s bytes: plain, and weighted by ``1 +
    position % 65521``.  The bytes are summed by column of rows of 65521
    (no widened copy: a replicated arena is a GB), then weighted."""
    b = x.detach().contiguous().reshape(-1).view(torch.uint8)
    full = b.numel() - b.numel() % _CHECKSUM_PERIOD
    w = torch.arange(1, _CHECKSUM_PERIOD + 1, dtype=torch.int64, device=b.device)
    cols = b[:full].view(-1, _CHECKSUM_PERIOD).sum(dim=0, dtype=torch.int64)
    tail = b[full:].to(torch.int64)
    return torch.stack([cols.sum() + tail.sum(),
                        (cols * w).sum() + (tail * w[:tail.numel()]).sum()])


class MeshState:
    """Global/local state hooks for a trainer with a ``mesh`` (mixed into
    ``SPMDTrainer`` and ``DPLearnerTrainer`` ahead of ``Trainer``)."""

    mesh: Any
    config: Any

    def _is_sharded(self, path: Path) -> bool:
        raise NotImplementedError

    @property
    def draw_streams(self) -> int:
        """Independent draw streams the state carries (1: replicated)."""
        return 1

    @functools.cached_property
    def control(self) -> ControlPlane:
        """The fleet loops' control records on this mesh (one per trainer)."""
        return ControlPlane(self.mesh)

    def _agree(self, flag: bool) -> bool:
        t = torch.tensor([int(bool(flag))], dtype=torch.int64, device=self.mesh.device)
        return bool(self.mesh.broadcast_(t).item())

    # ------------------------------------------------------ local -> global
    def global_field(self, state, name: str) -> Any:
        """The global value of one top-level field on rank 0 (None on the
        other ranks).  Collective."""
        mesh = self.mesh
        primary = mesh.rank == 0

        def walk(node, path):
            if isinstance(node, torch.Tensor):
                if not self._is_sharded(path):
                    return node
                parts = mesh.gather(node)
                return torch.cat([p.cpu() for p in parts]) if primary else None
            if isinstance(node, Draws) and self.draw_streams > 1:
                parts = mesh.gather(node.generator.get_state().to(mesh.device))
                if not primary:
                    return None
                return RankDraws(torch.stack([p.cpu() for p in parts]), mesh.size)
            return _map(node, path, walk)

        out = walk(getattr(state, name), (name,))
        return out if primary else None

    def global_state(self, state):
        """The whole global state on rank 0 (None elsewhere), one field at
        a time.  Collective."""
        fields = {f.name: self.global_field(state, f.name)
                  for f in dataclasses.fields(state)}
        return dataclasses.replace(state, **fields) if self.mesh.rank == 0 else None

    def _global_template(self, state):
        """``state`` with every sharded leaf widened to its global shape
        (``meta`` tensors: shapes and dtypes only), for a restore."""
        d = self.mesh.size

        def walk(node, path):
            if isinstance(node, torch.Tensor):
                if not self._is_sharded(path):
                    return node
                return torch.empty((d * node.shape[0],) + tuple(node.shape[1:]),
                                   dtype=node.dtype, device="meta")
            if isinstance(node, Draws) and self.draw_streams > 1:
                n = node.generator.get_state().numel()
                return RankDraws(torch.empty((d, n), dtype=torch.uint8, device="meta"), d)
            return _map(node, path, walk)

        return walk(state, ())

    # ------------------------------------------------------ global -> local
    def local_state(self, global_state):
        """This rank's slice of ``global_state`` on its device."""
        mesh = self.mesh
        dev = mesh.device

        def walk(node, path):
            if isinstance(node, torch.Tensor):
                if not self._is_sharded(path):
                    return node.to(dev)
                n = node.shape[0] // mesh.size
                return node.narrow(0, mesh.rank * n, n).to(dev, copy=True)
            if isinstance(node, RankDraws):
                if node.world_size != mesh.size:
                    raise ValueError(
                        f"the state holds the draw streams of {node.world_size} "
                        f"ranks; this run has {mesh.size}")
                draws = Draws(self.config.seed, dev).fold(mesh.rank)
                draws.generator.set_state(node.generator_states[mesh.rank].clone())
                return draws
            return _map(node, path, walk)

        return walk(global_state, ())

    def _check_replicated(self, state, extra: Optional[Dict[str, float]] = None) -> None:
        """Raise on every rank unless the replicated leaves of ``state`` (and
        the host numbers ``extra``) are equal on every rank."""
        sums = []

        def walk(node, path):
            if isinstance(node, torch.Tensor):
                if not self._is_sharded(path):
                    sums.append(_checksum(node.to(self.mesh.device)))
            elif isinstance(node, Draws):
                if self.draw_streams == 1:
                    sums.append(_checksum(node.generator.get_state().to(self.mesh.device)))
            elif isinstance(node, (bool, int, float)):
                sums.append(_checksum(torch.tensor([float(node)], dtype=torch.float64,
                                                   device=self.mesh.device)))
            else:
                _map(node, path, walk)
            return node

        walk(state, ())
        for v in (extra or {}).values():
            walk(v, ())
        mine = torch.stack(sums).reshape(1, -1)
        every = self.mesh.all_gather(mine)
        differ = [r for r in range(self.mesh.size) if not torch.equal(every[r], every[0])]
        if differ:
            raise ValueError(
                f"the replicated state differs across ranks after the restore "
                f"(ranks {differ} disagree with rank 0): do all ranks read the "
                "same checkpoint?")
