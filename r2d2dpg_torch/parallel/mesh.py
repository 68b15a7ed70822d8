"""The ``dp`` mesh of the port: a process group and this process's place in it.

Port of ``r2d2dpg_tpu/parallel/mesh.py``.  A JAX mesh names every device of
the job and a ``NamedSharding`` places an array over it; here each process
owns one device, so a ``Mesh`` is the group's size, this process's rank and
device, and the group itself.  The two JAX shardings become the two block
helpers the trainers use: ``sharded`` keeps this rank's contiguous block of
an axis (JAX's ``P("dp")`` splits axis 0 into equal contiguous blocks in
device order, the same rows), ``replicated`` keeps everything.

The collectives the trainers need are methods, each one call on the
group: ``pmean_`` (NCCL/gloo ``AVG``, in place), ``psum_``, ``pmax_``,
``all_gather`` and ``reduce_scatter`` (both along axis 0, in rank order),
``broadcast_`` (rank ``src``'s tensor into every rank's, in place),
``gather`` (every rank's tensor to one rank) and ``barrier``.  A mesh of
one runs the same calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from r2d2dpg_torch.device import DeviceLike
from r2d2dpg_torch.parallel import distributed

DP_AXIS = "dp"


def _dist():
    import torch.distributed as dist

    return dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D ``dp`` mesh: ``size`` processes, this one at ``rank`` on
    ``device``, talking over ``group`` (``None``: the default group)."""

    size: int
    rank: int
    device: torch.device
    group: Any = None
    axis_name: str = DP_AXIS

    @property
    def shape(self):
        """JAX's ``mesh.shape``: axis name -> size."""
        return {self.axis_name: self.size}

    def block(self, n: int) -> slice:
        """This rank's contiguous block of an axis of ``n`` (``n % size == 0``)."""
        if n % self.size:
            raise ValueError(f"axis of {n} not divisible by the mesh size {self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    # ---------------------------------------------------------- collectives
    def _reduce_(self, x: torch.Tensor, op) -> torch.Tensor:
        _dist().all_reduce(x, op=op, group=self.group)
        return x

    def psum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the mesh, in place."""
        return self._reduce_(x, _dist().ReduceOp.SUM)

    def pmean_(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the mesh, in place (``AVG``: NCCL scales each rank's
        floats by 1/D and sums; exact at D = 1)."""
        return self._reduce_(x, _dist().ReduceOp.AVG)

    def pmax_(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce_(x, _dist().ReduceOp.MAX)

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` into every rank's ``x``, in place (``x``
        must be contiguous and of one shape and dtype on every rank)."""
        _dist().broadcast(x, src=src, group=self.group)
        return x

    def gather(self, x: torch.Tensor, dst: int = 0) -> Optional[list]:
        """Every rank's ``x`` (one shape on every rank), in rank order, on
        rank ``dst``; None elsewhere."""
        x = x.contiguous()
        out = ([torch.empty_like(x) for _ in range(self.size)]
               if self.rank == dst else None)
        _dist().gather(x, gather_list=out, dst=dst, group=self.group)
        return out

    def barrier(self) -> None:
        """Return once every rank has reached this call (one small sum on
        the mesh device, so it orders after this rank's queued work)."""
        self.psum_(torch.zeros(1, device=self.device))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along axis 0 in rank order."""
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _dist().all_gather_into_tensor(out, x, group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x``, this rank's block of axis 0 of it."""
        x = x.contiguous()
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"axis of {n} not divisible by the mesh size {self.size}")
        out = x.new_empty((n // self.size,) + tuple(x.shape[1:]))
        _dist().reduce_scatter_tensor(out, x, op=_dist().ReduceOp.SUM, group=self.group)
        return out


def make_mesh(n_devices: Optional[int] = None, device: DeviceLike = None) -> Mesh:
    """A ``dp`` mesh over the job's processes, one device each.

    With no process group yet, ``make_mesh(1)`` (or ``make_mesh()``) brings
    up a group of one in this process; ``n_devices`` must equal the world
    size, as JAX's rule (``requested n devices, have m``)."""
    distributed.initialize(device)
    if not distributed.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"requested {n_devices} devices, have 1")
        distributed.initialize_local(device)
    have = distributed.world_size()
    if n_devices is not None and n_devices != have:
        raise ValueError(f"requested {n_devices} devices, have {have}")
    dev = distributed.local_device(device)
    want = distributed.backend_for(dev)
    got = _dist().get_backend()
    if got != want:
        raise ValueError(
            f"the process group runs {got!r}, and a mesh on {dev} needs {want!r}"
        )
    return Mesh(size=have, rank=distributed.rank(), device=dev)


def sharded(mesh: Mesh) -> Callable[..., torch.Tensor]:
    """Leading-axis placement over ``dp``: ``sharded(mesh)(x, axis=0)`` is
    this rank's contiguous block of ``x`` along ``axis``."""

    def place(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        return x.narrow(axis, mesh.block(x.shape[axis]).start, x.shape[axis] // mesh.size)

    return place


def replicated(mesh: Mesh) -> Callable[..., torch.Tensor]:
    """Replicated placement: every rank keeps all of ``x``."""
    del mesh
    return lambda x, axis=0: x
