"""Process-group bring-up for the multi-device paths.

Port of ``r2d2dpg_tpu/parallel/distributed.py``.  JAX drives every device
of a host from one process; the port runs **one process per device** over
``torch.distributed`` (NCCL between cards, gloo on the CPU):

    # D processes, one card each (a multi-GPU host):
    torchrun --nproc-per-node D -m r2d2dpg_torch.train --config ... --spmd D

    # in code, the same program on every rank:
    from r2d2dpg_torch.parallel import distributed
    distributed.initialize(device)      # no-op without a cluster config
    mesh = distributed.global_mesh(device)

``initialize`` keeps the JAX rule: with no cluster configuration it does
nothing, so a single-process run needs no special case at its call sites.
The configuration is torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or explicit arguments.
``make_mesh(1)`` (``parallel/mesh.py``) then brings up a group of one in
this process, on a free loopback port, so a world of one runs the same
collective calls as a world of D.

Rank ``r`` computes on ``cuda:<LOCAL_RANK>`` (``local_device``), or on the
CPU when the caller asks for it; a missing card is an error, as everywhere
in the port.  Side effects (logs, the exporter, ``topology.txt``, flight
dumps) belong to rank 0: ``is_primary``.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch

from r2d2dpg_torch.device import DeviceLike, resolve_device

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _dist():
    import torch.distributed as dist

    return dist


def backend_for(device: torch.device) -> str:
    """NCCL between cards, gloo between CPU processes."""
    return "nccl" if device.type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on the loopback interface (bound, read, released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(
    device: DeviceLike = None,
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> bool:
    """Join the process group of a multi-process run (idempotent).

    - Under ``torchrun`` every argument comes from the environment.
    - Elsewhere pass ``init_method`` (``tcp://host:port``), ``world_size``
      and ``rank``.
    - With no cluster configuration at all this is a no-op.

    The backend follows ``device`` (``cuda`` by default): NCCL on a card,
    gloo on the CPU.  Returns whether a group is up afterwards."""
    if is_initialized():
        return True
    env = {k: os.environ.get(k) for k in _ENV}
    if init_method is None and env["MASTER_ADDR"] and env["MASTER_PORT"]:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and env["WORLD_SIZE"]:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env["RANK"]:
        rank = int(env["RANK"])
    if init_method is None or world_size is None or rank is None:
        return False  # single process: nothing to bring up
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _dist().init_process_group(
        backend_for(dev), init_method=init_method, world_size=world_size,
        rank=rank,
    )
    return True


def initialize_local(device: DeviceLike = None) -> None:
    """A process group of one in this process (``make_mesh(1)`` with no
    cluster configuration), on a free loopback port."""
    if is_initialized():
        return
    initialize(device, init_method=f"tcp://127.0.0.1:{free_port()}",
               world_size=1, rank=0)


def rank() -> int:
    """This process's rank (0 without a group)."""
    return _dist().get_rank() if is_initialized() else 0


def world_size() -> int:
    """Processes in the group (1 without a group)."""
    return _dist().get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """The rank among this host's processes (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_device(device: DeviceLike = None) -> torch.device:
    """Rank ``r``'s device: ``cuda:<LOCAL_RANK>`` unless ``device`` names
    the CPU.  Raises without a card, as ``resolve_device`` does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return dev


def global_mesh(device: DeviceLike = None):
    """A ``dp`` mesh over every process of the job (a mesh of one without
    a cluster configuration)."""
    from r2d2dpg_torch.parallel.mesh import make_mesh

    initialize(device)
    return make_mesh(world_size(), device)


def is_primary() -> bool:
    """True on the process that owns logging/checkpoint side effects."""
    return rank() == 0


def shutdown() -> None:
    """Tear the process group down (no-op without one)."""
    if is_initialized():
        _dist().destroy_process_group()
