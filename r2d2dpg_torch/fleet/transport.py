"""Fleet wire protocol: length-prefixed, CRC-checked frames over sockets.

Port of ``r2d2dpg_tpu/fleet/transport.py``, byte for byte the same frames
(pure Python and numpy there too; copied so the port imports nothing of
the JAX package).  Actors and the learner's ingest server are separate OS
processes (Ape-X / R2D2 topology, PAPERS.md 1803.00933), so experience and
params cross a byte stream: localhost TCP (``"host:port"``) or a Unix
domain socket (``"unix:/path"``).  Every message is one frame::

    +--------+------+-----------+--------+----------------+
    | magic  | kind | length u64| crc32  | payload bytes  |
    | 4B R2F1|  1B  |    8B     |   4B   |  <= max_frame  |
    +--------+------+-----------+--------+----------------+

- **Length prefix** bounds the read; a declared length past
  ``max_frame_bytes`` is refused BEFORE any allocation (``FrameTooLarge``).
- **CRC32** (zlib) over the payload catches truncation and bit-rot
  (``FrameCRCError``).
- **EOF mid-frame** raises ``FrameTruncated``.

Payload encoding is per frame kind: control frames (ACK/BYE) carry small
pickled dicts (``pack_obj``/``unpack_obj``, at annotated call sites only;
``scripts/lint_fleet_wire.sh`` holds the rule), HELLO carries JSON (it is
parsed before authentication), and the tensor frames (SEQS/PARAMS) carry
the zero-copy binary format of ``fleet/wire.py``, sent without an
intermediate join through ``send_frame_parts``.

Backpressure is explicit: ``send_frame`` is a blocking ``sendall`` on a
socket whose buffers are clamped small (``configure_socket``), and every
experience frame is acknowledged, so an actor has at most one
unacknowledged batch in flight.  Liveness is bounded: both wire ends arm a
read deadline; a silent deadline sends one PING and a second silence reaps
the peer (``recv_frame_heartbeat`` -> ``PeerDeadError``).

``to_host`` is the port's own: it copies a tree of tensors to numpy in one
batched device-to-host transfer (the JAX package's calls ``jax.device_get``).
``flatten_tree`` is the one walker that takes the fleet's trees apart and
rebuilds them (``to_host`` here, ``ingest.put_staged`` on the learner).
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import socket
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"R2F1"
_HEADER = struct.Struct("!4sBQI")  # magic, kind, payload length, crc32
HEADER_BYTES = _HEADER.size

# Frame kinds (one byte on the wire).
K_HELLO = 1  # actor -> ingest: {"actor_id", ...} once per connection (JSON
# — the one frame parsed BEFORE authentication; see pack_hello)
K_SEQS = 2  # actor -> ingest: one staged experience batch + actor stats
K_ACK = 3  # ingest -> actor: {"code": OK|SHED_INGEST, "param_version": v}
K_PARAMS = 4  # ingest -> actor: {"version": v, "params": {...numpy trees}}
K_BYE = 5  # either side: orderly goodbye
K_TELEM = 6  # actor -> ingest: registry-scalar snapshot (~1 Hz, no ack)
K_PING = 7  # either side: liveness probe after a silent read deadline
K_PONG = 8  # either side: liveness answer (any frame also proves liveness)
# In-network experience sampling (fleet/sampler.py, ``--replay-shards``):
# the learner PULLS training batches from replay shards
# instead of draining every collected sequence.  Payloads ride the
# fleet/wire.py zero-copy codec (pack_sample_req / pack_shard_batch /
# pack_prio_update; golden byte-layout tests in tests/test_wire.py).
K_SAMPLE_REQ = 9  # learner -> shard: {"req_id", "shard", "quota"}
K_BATCH = 10  # shard -> learner: sampled sequences + slots/gens/probs + sums
K_PRIO = 11  # learner -> shard: TD priority write-back keyed slot/generation
# Split-plane wire (the direct shard data plane, ``--shard-direct``): when the
# actor ships SEQS directly to its shard, the accounting deltas still ride
# the learner control connection as a tiny pickled frame, banked
# learner-side and cleared only on ack.
K_STATS = 12  # actor -> ingest: accounting deltas only (no staged payload)

# 256 MiB default ceiling: a humanoid-shaped staged batch (256 envs x seq
# 85) is ~20 MiB, so this bounds corruption blast radius without touching
# any real config.
MAX_FRAME_BYTES = 256 * 1024 * 1024

# Clamp for SO_SNDBUF/SO_RCVBUF: big enough to stream a batch without
# per-chunk stalls, small enough that a wedged peer surfaces as a blocked
# send in seconds (the backpressure signal), not minutes of kernel-buffered
# stale experience.
SOCKET_BUF_BYTES = 1 * 1024 * 1024

# Default read deadline on both wire ends: a blocking read that sees no
# bytes for this long raises ``FrameDeadline`` (the reader then PINGs once
# and reaps the peer on a second silent deadline — ``recv_frame_heartbeat``).
# Generous on purpose: the longest LEGITIMATE silence on the fleet wire is
# an actor awaiting its ack while the learner's first drain-learn compiles
# behind a full staging queue (up to ``startup_shed_grace_s`` ~120 s), so
# the default deadline must dominate it.  Drills and tests dial it down.
READ_DEADLINE_S = 300.0

# Read deadline from a connection's start to its first SEQS frame (actor)
# or first ack (learner's handler): a fresh actor's start-up and the
# learner's first drain are legitimate silence.  The larger of this and the
# read deadline applies.
WARMUP_DEADLINE_S = 120.0


class FrameError(Exception):
    """Base class for wire-protocol violations."""


class FrameTruncated(FrameError):
    """Peer closed (or stream ended) mid-frame."""


class FrameCRCError(FrameError):
    """Payload bytes do not match the header's CRC32."""


class FrameTooLarge(FrameError):
    """Declared payload length exceeds the frame ceiling."""


class FrameBadMagic(FrameError):
    """Stream is not positioned at a frame boundary (or not our protocol)."""


class FrameDeadline(FrameError):
    """No bytes arrived within the socket's read deadline (peer silent).

    ``mid_frame`` distinguishes the two silences: ``False`` = the stream
    is AT a frame boundary (nothing consumed — safe to PING and keep
    reading), ``True`` = bytes of a frame were already consumed (or its
    header was), so the stream can never be resynchronized and the only
    honest verdict is to reap the peer."""

    def __init__(self, msg: str, *, mid_frame: bool = False):
        super().__init__(msg)
        self.mid_frame = mid_frame


class PeerDeadError(FrameError):
    """Peer stayed silent through a deadline AND the PING that followed it.

    The liveness verdict of ``recv_frame_heartbeat``: the connection is
    reaped (ingest handler closes + ``peer_dead`` flight event; an actor
    exits with a retryable code so the supervisor's backoff restart takes
    over) instead of hanging forever on a wedged peer."""


# ------------------------------------------------------------------ framing
def encode_frame(
    kind: int, payload: bytes, *, max_frame_bytes: int = MAX_FRAME_BYTES
) -> bytes:
    """Header + payload as one bytes object (small frames; big ones go
    through ``send_frame`` which avoids the extra copy)."""
    if len(payload) > max_frame_bytes:
        raise FrameTooLarge(
            f"payload {len(payload)}B exceeds frame ceiling {max_frame_bytes}B"
        )
    return (
        _HEADER.pack(MAGIC, kind, len(payload), zlib.crc32(payload)) + payload
    )


def send_frame(
    sock: socket.socket,
    kind: int,
    payload: bytes,
    *,
    max_frame_bytes: int = MAX_FRAME_BYTES,
) -> int:
    """Blocking framed send; the blocking IS the backpressure (module doc).
    Returns total bytes on the wire (header + payload) for obs counters."""
    if len(payload) > max_frame_bytes:
        raise FrameTooLarge(
            f"payload {len(payload)}B exceeds frame ceiling {max_frame_bytes}B"
        )
    sock.sendall(_HEADER.pack(MAGIC, kind, len(payload), zlib.crc32(payload)))
    sock.sendall(payload)
    return HEADER_BYTES + len(payload)


def send_frame_parts(
    sock: socket.socket,
    kind: int,
    parts,
    *,
    max_frame_bytes: int = MAX_FRAME_BYTES,
) -> int:
    """Framed send of a multi-part payload WITHOUT joining it first.

    ``fleet/wire.py`` hands tensor bytes as memoryviews straight into the
    arrays being sent; joining them into one payload would re-copy every
    tensor byte — the exact copy the zero-copy wire exists to avoid.  The
    CRC runs incrementally over the parts, then header + parts go out as
    ONE scatter-gather ``sendmsg`` (a per-part ``sendall`` would be a
    dozen syscalls per frame, each tiny scalar slot flushing as its own
    TCP_NODELAY segment).  Returns total bytes on the wire."""
    total = sum(len(p) for p in parts)
    if total > max_frame_bytes:
        raise FrameTooLarge(
            f"payload {total}B exceeds frame ceiling {max_frame_bytes}B"
        )
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    header = _HEADER.pack(MAGIC, kind, total, crc)
    pending = [memoryview(header)] + [memoryview(p) for p in parts]
    while pending:
        # Blocking sendmsg may still send PARTIALLY (socket buffers are
        # deliberately clamped small here); advance through the iovec.
        # The slice keeps many-leaf trees (param snapshots) under the
        # kernel's IOV_MAX.
        sent = sock.sendmsg(pending[:512])
        while pending and sent >= len(pending[0]):
            sent -= len(pending[0])
            pending.pop(0)
        if sent:
            pending[0] = pending[0][sent:]
    return HEADER_BYTES + total


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except socket.timeout:
            # The socket's read deadline (settimeout) fired: the peer went
            # silent — between frames (got == 0) or mid-frame (a torn
            # write from a wedged sender).  Either way the read is bounded:
            # this surfaces as FrameDeadline instead of hanging forever.
            raise FrameDeadline(
                f"no bytes within the read deadline ({got}/{n} received)",
                mid_frame=got > 0,
            )
        if not chunk:
            raise FrameTruncated(f"EOF after {got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(
    sock: socket.socket, *, max_frame_bytes: int = MAX_FRAME_BYTES
) -> Tuple[int, bytes]:
    """Read one frame -> (kind, payload).  Raises FrameError subclasses on
    any protocol violation (the caller decides whether that kills the
    connection — it should)."""
    header = _recv_exact(sock, HEADER_BYTES)
    magic, kind, length, crc = _HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameBadMagic(f"bad magic {magic!r}")
    if length > max_frame_bytes:
        raise FrameTooLarge(
            f"declared payload {length}B exceeds frame ceiling "
            f"{max_frame_bytes}B"
        )
    try:
        payload = _recv_exact(sock, length)
    except FrameDeadline as e:
        # The header is already consumed: even a deadline whose payload
        # read got 0 bytes leaves the stream mid-frame — a later retry
        # would parse payload bytes as a header (FrameBadMagic) instead
        # of reaching the liveness verdict.
        e.mid_frame = True
        raise
    if zlib.crc32(payload) != crc:
        raise FrameCRCError(
            f"crc mismatch on {length}B payload (kind {kind})"
        )
    return kind, payload


def recv_frame_heartbeat(
    sock: socket.socket,
    *,
    max_frame_bytes: int = MAX_FRAME_BYTES,
    bytes_in=None,
    bytes_out=None,
) -> Tuple[int, bytes]:
    """Deadline-aware framed read with PING/PONG liveness, both wire ends.

    Reads until a NON-heartbeat frame arrives.  A first silent read
    deadline (``FrameDeadline`` — the socket's ``settimeout``) sends one
    PING and waits a second deadline for ANY frame; a second silence is
    the liveness verdict: ``PeerDeadError``, and the caller reaps the
    connection.  An incoming PING is answered with PONG (the peer is
    probing us); a PONG — or any real frame — proves the peer alive and
    re-arms the probe.  A socket with no timeout set never deadlines,
    which degrades to plain ``recv_frame`` semantics.

    ``bytes_in``/``bytes_out``, when given, are called with the wire byte
    counts of the heartbeat frames this helper consumes/produces, so the
    obs byte counters stay honest about probe traffic."""
    pinged = False
    while True:
        try:
            kind, payload = recv_frame(sock, max_frame_bytes=max_frame_bytes)
        except FrameDeadline as e:
            if e.mid_frame:
                # Partial frame consumed: the stream cannot resynchronize
                # (a retry would parse leftover payload as a header), so
                # a mid-frame stall goes straight to the liveness verdict
                # instead of a PING whose answer we could never read.
                raise PeerDeadError(
                    f"peer stalled mid-frame past the read deadline ({e})"
                )
            if pinged:
                raise PeerDeadError(
                    f"peer silent through a read deadline and the PING "
                    f"that followed it ({e})"
                )
            n = send_frame(sock, K_PING, b"")
            if bytes_out is not None:
                bytes_out(n)
            pinged = True
            continue
        pinged = False  # ANY frame proves the peer alive, not just PONG
        if bytes_in is not None and kind in (K_PING, K_PONG):
            bytes_in(HEADER_BYTES + len(payload))
        if kind == K_PING:
            n = send_frame(sock, K_PONG, b"")
            if bytes_out is not None:
                bytes_out(n)
            continue
        if kind == K_PONG:
            continue
        return kind, payload


# --------------------------------------------------------------------- auth
def hello_auth_proof(token: str) -> str:
    """The HELLO authentication proof for a shared ``--fleet-token``.

    An HMAC over a fixed context string rather than the raw token, so the
    secret itself never crosses the wire (a captured HELLO replays this
    one protocol's HELLO and nothing else — the cross-host threat model is
    a misdirected or stale peer, not an active MITM; that needs TLS).
    Both ends compute it; the ingest server compares with
    ``hmac.compare_digest`` (fleet/ingest.py)."""
    import hashlib
    import hmac as _hmac

    return _hmac.new(
        token.encode(), b"r2d2dpg-fleet-hello-v1", hashlib.sha256
    ).hexdigest()


def pack_hello(hello: Dict[str, Any]) -> bytes:
    """Encode a HELLO payload — JSON, never pickle.

    HELLO is the ONE frame a learner parses from a peer it has not yet
    authenticated (the ``--fleet-token`` proof rides INSIDE it), so its
    decoder must be data-only: a pickle here would hand arbitrary code
    execution to anything that can reach a routable bind, before the auth
    check ever runs.  Every field both ends exchange (ids, counts, the
    negotiation strings, the hex proof) is JSON-native."""
    return json.dumps(hello).encode("utf-8")


def unpack_hello(payload: bytes) -> Dict[str, Any]:
    """Decode a HELLO payload (see ``pack_hello``: JSON, safe on
    untrusted bytes).  Malformed payloads raise ``FrameError`` — the
    caller drops the connection, the same posture as any protocol
    violation."""
    try:
        hello = json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise FrameError(f"malformed HELLO (JSON object expected): {e}")
    if not isinstance(hello, dict):
        raise FrameError(
            f"malformed HELLO: JSON object expected, got {type(hello).__name__}"
        )
    return hello


# ----------------------------------------------------------------- payloads
def pack_obj(obj: Any) -> bytes:
    """Serialize one POST-AUTH control-frame payload (ACK/BYE dicts).

    Pickle is banned from the SEQS/PARAMS steady-state paths
    (``scripts/lint_fleet_wire.sh``): tensor payloads go through
    ``fleet/wire.py``.  Control frames are small dicts exchanged a
    handful of times per phase between AUTHENTICATED peers — pickle's
    flexibility is fine there.  The one pre-auth frame, HELLO, must use
    ``pack_hello``/``unpack_hello`` (JSON) instead: its bytes come from a
    peer nothing has vouched for yet."""
    return pickle.dumps(obj, protocol=4)


def unpack_obj(payload: bytes) -> Any:
    return pickle.loads(payload)


def flatten_tree(tree: Any, is_leaf: Callable[[Any], bool]):
    """The nodes of ``tree`` that satisfy ``is_leaf``, in a fixed order,
    and a function that rebuilds the tree from a list of replacements.

    Dataclasses, dicts, lists and tuples are walked; every other node
    (numbers, None, strings) is kept as it is."""
    leaves: List[Any] = []

    def walk(node):
        if is_leaf(node):
            leaves.append(node)
            return lambda it: next(it)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            parts = [(f.name, walk(getattr(node, f.name)))
                     for f in dataclasses.fields(node)]
            return lambda it: dataclasses.replace(
                node, **{name: b(it) for name, b in parts})
        if isinstance(node, dict):
            parts = [(k, walk(v)) for k, v in node.items()]
            return lambda it: {k: b(it) for k, b in parts}
        if isinstance(node, (list, tuple)):
            parts = [walk(v) for v in node]
            return lambda it: type(node)(b(it) for b in parts)
        return lambda it: node

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def to_host(tree: Any) -> Any:
    """Tensor tree -> numpy tree, ready for the wire.

    One batched transfer, not one per leaf: the tensor leaves are packed
    into one byte buffer on their device (one ``torch.cat``, each leaf
    starting at a multiple of its item size), and that buffer crosses to
    the host in one synchronous copy, which waits for the work on the
    current stream that produced the leaves.  The numpy leaves are typed
    views of that new host buffer: it shares no memory with the tensors,
    so no later step on the device (or, on the CPU, in place) can change
    a published snapshot.  Non-tensor leaves (numbers, None, numpy arrays)
    pass through; dataclasses, dicts, lists and tuples keep their
    structure.  A bfloat16 leaf comes back as float32 (exact): numpy has
    no bfloat16."""
    import torch

    leaves, rebuild = flatten_tree(tree, lambda x: isinstance(x, torch.Tensor))
    if not leaves:
        return tree
    wide = [x.float() if x.dtype == torch.bfloat16 else x for x in leaves]
    parts, layout, off = [], [], 0
    for w in wide:
        pad = -off % w.element_size()
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=w.device))
        off += pad
        parts.append(w.detach().contiguous().reshape(-1).view(torch.uint8))
        layout.append((off, np.dtype(str(w.dtype).replace("torch.", ""))))
        off += parts[-1].numel()
    host = torch.cat(parts).cpu().numpy()
    return rebuild([
        host[o:o + x.numel() * dtype.itemsize].view(dtype).reshape(tuple(x.shape))
        for x, (o, dtype) in zip(leaves, layout)
    ])


# ------------------------------------------------------------------- address
def parse_address(addr: str):
    """``"host:port"`` -> (AF_INET, (host, port)); ``"unix:/path"`` ->
    (AF_UNIX, path)."""
    if addr.startswith("unix:"):
        return socket.AF_UNIX, addr[len("unix:"):]
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"address {addr!r} is neither 'host:port' nor 'unix:/path'"
        )
    return socket.AF_INET, (host, int(port))


def configure_socket(sock: socket.socket) -> socket.socket:
    """Apply the fleet's socket discipline: clamped buffers (bounded
    kernel-side staleness — module doc) and no Nagle delay on TCP (acks are
    tiny; a 40 ms coalescing stall per phase would dwarf them)."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, SOCKET_BUF_BYTES)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, SOCKET_BUF_BYTES)
    if sock.family == socket.AF_INET:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def is_loopback_address(addr: str) -> bool:
    """True for addresses that PROVABLY never leave this host: Unix
    sockets, literal 127.0.0.0/8 IPs and ``localhost``.  A wildcard or
    routable bind — and any other hostname, which could resolve anywhere
    (a name merely STARTING with "127." proves nothing) — is not loopback:
    callers warn loudly when binding one without ``--fleet-token``
    (docs/FLEET.md "Authentication")."""
    if addr.startswith("unix:"):
        return True
    host, _, _ = addr.rpartition(":")
    if host == "localhost":
        return True
    import ipaddress

    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False  # a hostname, not a literal IP: not provably local


def connect(
    addr: str,
    *,
    timeout: float = 30.0,
    read_deadline_s: Optional[float] = READ_DEADLINE_S,
) -> socket.socket:
    """Dial an ingest server; returns a configured, connected socket.

    ``read_deadline_s`` arms the socket's blocking-I/O timeout: a read (or
    a backpressured send) that makes no progress for that long raises
    instead of hanging forever — ``recv_frame`` surfaces it as
    ``FrameDeadline`` and ``recv_frame_heartbeat`` turns it into the
    PING-then-reap liveness protocol.  ``None`` restores the legacy
    unbounded posture (debug only)."""
    family, target = parse_address(addr)
    sock = socket.socket(family, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    try:
        sock.connect(target)
    except OSError:
        sock.close()
        raise
    sock.settimeout(read_deadline_s)
    return configure_socket(sock)
