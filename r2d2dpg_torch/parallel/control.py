"""Rank 0 decides; every rank hears the decision before it acts.

The fleet loops of a world of D (``fleet/ingest.py``'s drain,
``fleet/sampler.py``'s pull) read their choices from host state that only
rank 0 holds: the ingest queue, the supervisor, the shards, the clock.
Rank 0 runs the loop; every other rank runs a follower on the same
trainer.  Each iteration begins with one control record, a fixed-shape
int64 tensor on the mesh device that rank 0 broadcasts, then (for
``absorb`` and ``learn``) the iteration's payload, the one packed device
buffer the leader's host-to-device copy made:

    slot  0   op: ABSORB | LEARN | STOP | ERROR
          1   width (sequences of the staged or pulled batch)
          2   priorities resolved by the producer (0/1)
          3   provenance present (0/1)
          4   the leader's drained-phase count after this iteration
          5   the learn step's replay size (the sampler's fleet-wide
              occupancy: the N of the IS weights)
          6   payload bytes
          7   the leader fetches its log-cadence values after this
              iteration (0/1): the followers join its collectives
          8.. the reason of an ERROR, ASCII, zero-padded

An exception on rank 0 sends ``ERROR`` with the exception's type name
before it propagates; a follower then raises ``RuntimeError("rank 0
stopped: <reason>")`` instead of waiting in the next collective.  A world
of one sends the same records.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional

import torch

from r2d2dpg_torch.parallel.mesh import Mesh

ABSORB, LEARN, STOP, ERROR = 1, 2, 3, 4
_OPS = (ABSORB, LEARN, STOP, ERROR)
_REASON_SLOT = 8
_REASON_BYTES = 32
RECORD_LEN = _REASON_SLOT + _REASON_BYTES // 8


@dataclasses.dataclass(frozen=True)
class Record:
    """One decoded control record."""

    op: int
    width: int = 0
    resolved: bool = False
    provenance: bool = False
    drained: int = 0
    size: int = 0
    nbytes: int = 0
    log: bool = False
    reason: str = ""


def _encode_reason(reason: str) -> list:
    raw = reason.encode("ascii", "replace")[:_REASON_BYTES]
    raw = raw + b"\0" * (_REASON_BYTES - len(raw))
    return [int.from_bytes(raw[i:i + 8], "little", signed=True)
            for i in range(0, _REASON_BYTES, 8)]


def _decode_reason(words) -> str:
    raw = b"".join(int(w).to_bytes(8, "little", signed=True) for w in words)
    return raw.rstrip(b"\0").decode("ascii", "replace")


class ControlPlane:
    """The leader's and the followers' end of the control records.

    ``records`` and ``payloads`` count the broadcasts this rank took part
    in (a world of one counts the leader's)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.records = 0
        self.payloads = 0
        self.closed = False  # a STOP or ERROR went out (leader) / came in

    def open(self) -> None:
        """Start a loop: counts from 0, nothing sent yet."""
        self.records = self.payloads = 0
        self.closed = False

    # ------------------------------------------------------------- leader
    def send(self, op: int, *, width: int = 0, resolved: bool = False,
             provenance: bool = False, drained: int = 0, size: int = 0,
             nbytes: int = 0, log: bool = False, reason: str = "") -> None:
        """Rank 0: broadcast one record."""
        words = [op, width, int(resolved), int(provenance), drained, size,
                 nbytes, int(log)] + _encode_reason(reason)
        self.mesh.broadcast_(torch.tensor(words, dtype=torch.int64,
                                          device=self.mesh.device))
        self.records += 1
        if op in (STOP, ERROR):
            self.closed = True

    def stop(self, drained: int = 0) -> None:
        self.send(STOP, drained=drained)

    def fail(self, exc: BaseException) -> None:
        """Rank 0: tell the followers it stopped on ``exc``."""
        self.send(ERROR, reason=type(exc).__name__)

    @contextlib.contextmanager
    def leading(self) -> Iterator["ControlPlane"]:
        """Around the leader's loop: an exception sends ERROR before it
        propagates, a normal exit sends STOP (unless one went out)."""
        try:
            yield self
        except BaseException as e:
            if not self.closed:
                self.fail(e)
            raise
        if not self.closed:
            self.stop()

    def send_payload(self, buf: torch.Tensor) -> None:
        """Rank 0: broadcast the iteration's packed device buffer.  The call
        is synchronous for the current stream (torch's NCCL group makes it
        wait on the communication stream, where it also records ``buf``),
        so ``buf`` may be reused or freed once it returns."""
        self.mesh.broadcast_(buf)
        self.payloads += 1

    # ---------------------------------------------------------- followers
    def recv(self) -> Record:
        """Ranks > 0: the next record.  An ERROR raises here."""
        t = torch.zeros(RECORD_LEN, dtype=torch.int64, device=self.mesh.device)
        w = self.mesh.broadcast_(t).tolist()
        self.records += 1
        rec = Record(op=w[0], width=w[1], resolved=bool(w[2]),
                     provenance=bool(w[3]), drained=w[4], size=w[5],
                     nbytes=w[6], log=bool(w[7]),
                     reason=_decode_reason(w[_REASON_SLOT:]))
        if rec.op in (STOP, ERROR):
            self.closed = True
        if rec.op == ERROR:
            raise RuntimeError(f"rank 0 stopped: {rec.reason}")
        if rec.op not in _OPS:
            raise RuntimeError(f"rank {self.mesh.rank}: unknown control op {rec.op}")
        return rec

    def recv_payload(self, nbytes: int) -> torch.Tensor:
        """Ranks > 0: the iteration's packed buffer, received in place into
        a fresh device buffer of ``nbytes``."""
        buf = torch.empty(nbytes, dtype=torch.uint8, device=self.mesh.device)
        self.mesh.broadcast_(buf)
        self.payloads += 1
        return buf


def control_plane(trainer) -> Optional[ControlPlane]:
    """The control plane of a trainer on a mesh, one per trainer (None for
    the plain ``Trainer``: one process, nothing to tell)."""
    return getattr(trainer, "control", None)
