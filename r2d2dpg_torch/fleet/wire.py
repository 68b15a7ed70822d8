"""Zero-copy wire codec for the fleet's SEQS/PARAMS payloads.

Port of ``r2d2dpg_tpu/fleet/wire.py`` (numpy there too; copied so the port
imports nothing of the JAX package).  The byte layout is identical: the
goldens of ``tests/test_wire.py`` hold for both packages, and frames cross
between them in both directions.  It reads the port's ``SequenceBatch``/
``StagedSequences`` (numpy leaves on the wire) and ``obs/trace.py``'s
``TraceStamp``.  The Ape-X topology (PAPERS.md 1803.00933) lives on
experience/param throughput, so the steady-state path uses a schema-cached
binary format rather than pickle:

::

    payload := wire_header | [trace] | [schema] | body
    wire_header (16B, "!BBBBIQ"):
        version (1B) | compress (1B) | flags (1B) | reserved (1B)
        schema_id (u32 = crc32 of the schema JSON)
        raw_len   (u64 = DECOMPRESSED body length)
    trace (present iff flags bit 1, 32B "!Qddd"): a SAMPLED batch's trace
        id + actor-side hop timestamps (collect start/end, encode end) —
        the experience-path tracing sidecar (obs/trace.py).  Unsampled
        frames carry nothing: tracing at rate 0 is byte-identical to a
        wire without it.
    schema (present iff flags bit 0): u32 length + compact JSON describing
        tree structure + per-leaf dtypes/shapes.  Scalars (phase counters,
        episode deltas) live in the BODY (8B each), so the schema is
        byte-identical across a connection's frames and is sent ONCE —
        steady-state frames carry a 4-byte id reference instead.
    body := the leaves' raw little-endian bytes, depth-first, contiguous
        (optionally zlib/zstd-compressed as one block).

Decode allocates nothing per tensor: each array is a ``np.frombuffer``
view straight into the received payload (read-only — the drain program's
``device_put`` is the first and only copy).  Encode hands the socket a
list of buffer views (``transport.send_frame_parts``) so tensor bytes are
never joined into an intermediate payload copy either.

**Precision** (negotiated at HELLO, one setting per fleet): ``f32`` puts
every leaf on the wire in its storage dtype — bit-exact, the default and
the determinism anchor.  ``bf16`` downcasts float32 leaves to bfloat16 on
the wire and restores float32 on receive, EXCEPT the leaves named in
``F32_PINNED_LEAVES`` (rewards and discounts feed return targets;
priorities feed the sampling distribution — all stay exact).  A bf16 fleet trades ~2x wire
bytes for ~3 decimal digits on observations/actions/carries/params — a
*different, equally valid* trajectory, same class as the fleet's other
nondeterminism (docs/FLEET.md "Precision caveats").

**Zip-bomb guard**: the frame ceiling is enforced against the DECLARED
DECOMPRESSED length (``raw_len``) before any allocation or decompression,
and the decompressor is hard-capped at ``raw_len`` output bytes — a
malicious or corrupt 1 KiB frame cannot balloon into an OOM.  A declared
length the stream does not actually produce (either direction) is a
``WireFormatError``.

Both ends are subprocesses of one trusted run (transport.py's integrity
model), but unlike pickle this codec is also *safe* to point at untrusted
bytes: the schema walk can only ever build numpy views and plain
scalars — there is no object construction to hijack.
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from r2d2dpg_torch.fleet.transport import (
    MAX_FRAME_BYTES,
    FrameError,
    FrameTooLarge,
)
from r2d2dpg_torch.obs.trace import TraceStamp
from r2d2dpg_torch.replay.arena import SequenceBatch, StagedSequences

WIRE_VERSION = 1

ENC_F32 = "f32"
ENC_BF16 = "bf16"
ENCODINGS = (ENC_F32, ENC_BF16)

COMP_NONE = "none"
COMP_ZLIB = "zlib"
COMP_ZSTD = "zstd"
COMPRESSIONS = (COMP_NONE, COMP_ZLIB, COMP_ZSTD)

try:  # optional: this container ships zlib only; negotiation refuses zstd
    import zstandard as _zstd  # type: ignore
except ImportError:  # pragma: no cover - environment-dependent
    _zstd = None


def available_compressions() -> Tuple[str, ...]:
    """The compressions THIS process can actually run (zstd is gated on the
    optional ``zstandard`` module; zlib is stdlib and always there)."""
    out: Tuple[str, ...] = (COMP_NONE, COMP_ZLIB)
    if _zstd is not None:
        out += (COMP_ZSTD,)
    return out


class WireFormatError(FrameError):
    """Payload violates the wire codec (malformed header/schema/body)."""


# Leaves that keep their storage dtype even on a bf16 wire: rewards and
# discounts feed n-step return targets (dm_control emits FRACTIONAL
# discounts, not just 0/1 masks) and priorities feed the sampling CDF —
# quantizing any of them changes WHAT is learned, not just how precisely
# states are seen.
F32_PINNED_LEAVES = frozenset({"reward", "discount", "priorities"})

_PAYLOAD_HEADER = struct.Struct("!BBBBIQ")
_SCHEMA_LEN = struct.Struct("!I")
_F64 = struct.Struct("<d")
_I64 = struct.Struct("<q")
_FLAG_SCHEMA_INLINE = 1
# Trace sidecar: a SAMPLED frame carries a fixed 32-byte stamp —
# trace id + the actor-side hop timestamps (collect start/end, encode end)
# — right after the wire header, BEFORE any inline schema.  A sidecar
# instead of schema fields keeps the schema byte-stable (same crc32 id
# sampled or not) and keeps unsampled frames byte-identical to a wire
# with tracing off: the determinism anchor costs nothing at rate 0.
_FLAG_TRACE = 2
_TRACE_SIDECAR = struct.Struct("!Qddd")
_COMP_CODES = {COMP_NONE: 0, COMP_ZLIB: 1, COMP_ZSTD: 2}
_COMP_NAMES = {v: k for k, v in _COMP_CODES.items()}
# Arrays at least this big go on the socket as memoryviews (zero-copy);
# smaller ones (and 0-d scalar arrays) are cheaper to copy than to track.
_VIEW_MIN_BYTES = 4096
# Receiver-side schema cache bound: a well-behaved fleet uses a handful of
# schemas per connection, so the cap only bites a peer streaming endless
# DISTINCT inline schemas — which would otherwise grow the unpacker's
# memory without bound (the same OOM class the raw_len ceiling closes).
_SCHEMA_CACHE_MAX = 64

HEADER_BYTES = _PAYLOAD_HEADER.size


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """The negotiated fast-lane shape: one per fleet, agreed at HELLO."""

    encoding: str = ENC_F32
    compress: str = COMP_NONE
    zlib_level: int = 1  # speed over ratio: the wire is a hot path

    def validate(self) -> "WireConfig":
        if self.encoding not in ENCODINGS:
            raise ValueError(
                f"wire encoding {self.encoding!r} not in {ENCODINGS}"
            )
        if self.compress not in COMPRESSIONS:
            raise ValueError(
                f"wire compression {self.compress!r} not in {COMPRESSIONS}"
            )
        if self.compress not in available_compressions():
            raise ValueError(
                f"wire compression {self.compress!r} is not available in "
                f"this environment (no zstandard module); have "
                f"{available_compressions()}"
            )
        return self


def negotiation_fields(config: WireConfig) -> Dict[str, Any]:
    """The HELLO fields both ends compare (fleet/ingest.py refuses a
    mismatch with ``utils.codes.REFUSED_WIRE`` — one fleet, one wire)."""
    return {
        "wire_version": WIRE_VERSION,
        "encoding": config.encoding,
        "compress": config.compress,
    }


def check_negotiation(hello: Dict[str, Any], config: WireConfig) -> Optional[str]:
    """Compare an actor's HELLO against the learner's wire config; returns
    a human-readable mismatch description, or None when compatible.

    A HELLO without negotiation keys (a pre-wire actor) reads as
    wire_version 0 and is ALWAYS refused — old actors speak pickled SEQS
    frames this codec cannot decode, so there is no legacy acceptance
    path, only a refusal that names the version gap."""
    got_version = hello.get("wire_version", 0)
    if got_version != WIRE_VERSION:
        return f"wire_version {got_version} != {WIRE_VERSION}"
    got_enc = hello.get("encoding", ENC_F32)
    if got_enc != config.encoding:
        return f"encoding {got_enc!r} != negotiated {config.encoding!r}"
    got_comp = hello.get("compress", COMP_NONE)
    if got_comp != config.compress:
        return f"compress {got_comp!r} != negotiated {config.compress!r}"
    return None


# ---------------------------------------------------------------- dtypes
# numpy has no bfloat16 (the JAX package takes the dtype from a library
# that comes with JAX).  Here a bf16 leaf is its 16-bit patterns: BF16 marks the
# wire dtype in leaf records, the schema names it "bfloat16" as the JAX
# codec does, and the two functions below round as that dtype does
# (nearest, ties to even; a NaN becomes the quiet NaN of its sign;
# subnormals, infinities and signed zeros carried exactly).
BF16 = "bfloat16"


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (``uint16``), rounded to nearest
    even; bit for bit what the JAX codec puts on the wire."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    # The add wraps only past 0xFFFF8000, which is NaN and replaced below.
    rounded = ((b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) >> 16)
    nan = (b & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = ((b >> 16) & np.uint32(0x8000)) | np.uint32(0x7FC0)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns -> float32 (exact: the pattern is the high
    half of the float32's)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def _dtype_from_name(name: str):
    """A schema dtype name -> numpy dtype, or ``BF16`` for ``"bfloat16"``."""
    if name == BF16:
        return BF16
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise WireFormatError(f"unknown wire dtype {name!r}: {e}")
    if dt.hasobject:
        raise WireFormatError(f"refusing object dtype {name!r} on the wire")
    return dt


def _dtype_name(dt) -> str:
    return BF16 if dt is BF16 else dt.name


def _itemsize(dt) -> int:
    return 2 if dt is BF16 else dt.itemsize


# ------------------------------------------------------------------ pack
def _describe(obj: Any, path: Tuple[str, ...], encoding: str, leaves: List):
    """Walk one payload tree: append leaf records, return the schema node.

    Schema nodes are deliberately tiny JSON: ``"n"``/``"i"``/``"f"``/
    ``"t"`` for None/int/float/bool, ``{"d": [[key, child], ...]}`` for
    dicts, ``{"S": [seq, priorities]}`` (4 children when quality
    provenance is stamped) / ``{"B": [six fields]}`` for the two
    registered fleet dataclasses, ``{"a": [storage, wire, shape]}``
    for arrays.  Scalar VALUES go in the body (8B slots), so the schema —
    and therefore its crc32 id — is stable across a run's frames."""
    if obj is None:
        return "n"
    if isinstance(obj, StagedSequences):
        children = [
            _describe(obj.seq, path + ("seq",), encoding, leaves),
            _describe(
                obj.priorities, path + ("priorities",), encoding, leaves
            ),
        ]
        # Provenance extends the node to 4 children ONLY when
        # stamped: a provenance-free staged batch emits the original
        # 2-child schema, so pre-plane frames — and every golden byte
        # layout pinned on them — stay byte-identical, and an old decoder
        # meeting a new ACTOR fails on the schema id, never mid-body.
        if obj.behavior_version is not None or obj.collect_id is not None:
            children.append(
                _describe(
                    obj.behavior_version,
                    path + ("behavior_version",),
                    encoding,
                    leaves,
                )
            )
            children.append(
                _describe(
                    obj.collect_id, path + ("collect_id",), encoding, leaves
                )
            )
        return {"S": children}
    if isinstance(obj, SequenceBatch):
        return {
            "B": [
                _describe(getattr(obj, f), path + (f,), encoding, leaves)
                for f in ("obs", "action", "reward", "discount", "reset", "carries")
            ]
        }
    if isinstance(obj, dict):
        pairs = []
        for k, v in obj.items():
            if not isinstance(k, str):
                raise WireFormatError(
                    f"non-string dict key {k!r} at /{'/'.join(path)}"
                )
            pairs.append([k, _describe(v, path + (k,), encoding, leaves)])
        return {"d": pairs}
    if isinstance(obj, (tuple, list)):
        # Tuples vs lists are distinct pytree structures (LSTM carries
        # are tuples) — preserve which one crossed the wire.
        tag = "u" if isinstance(obj, tuple) else "l"
        return {
            tag: [
                _describe(v, path + (str(i),), encoding, leaves)
                for i, v in enumerate(obj)
            ]
        }
    if isinstance(obj, (bool, np.bool_)):  # before int: bool IS an int
        leaves.append(("t", obj, None))
        return "t"
    if isinstance(obj, (int, np.integer)):
        leaves.append(("i", obj, None))
        return "i"
    if isinstance(obj, (float, np.floating)):
        leaves.append(("f", obj, None))
        return "f"
    if isinstance(obj, np.ndarray):
        storage = obj.dtype
        if storage.hasobject:
            raise WireFormatError(
                f"object-dtype array at /{'/'.join(path)} cannot cross the wire"
            )
        if storage.byteorder == ">":
            # Schema dtype names carry no byte order, so big-endian bytes
            # would be silently reinterpreted on decode — refuse; callers
            # normalize to native (the wire is little-endian by contract).
            raise WireFormatError(
                f"big-endian array at /{'/'.join(path)}: normalize to "
                f"native byte order before the wire"
            )
        wire_dt = storage
        if (
            encoding == ENC_BF16
            and storage == np.float32
            and (not path or path[-1] not in F32_PINNED_LEAVES)
        ):
            wire_dt = BF16
        leaves.append(("a", obj, wire_dt))
        return {"a": [storage.name, _dtype_name(wire_dt), list(obj.shape)]}
    raise WireFormatError(
        f"unsupported wire leaf type {type(obj).__name__} at /{'/'.join(path)}"
    )


def _leaf_part(kind: str, value: Any, wire_dt):
    """One leaf -> one bytes-like body part (memoryview for big arrays)."""
    if kind == "t":
        return _I64.pack(1 if value else 0)
    if kind == "i":
        return _I64.pack(int(value))
    if kind == "f":
        return _F64.pack(float(value))
    arr = np.ascontiguousarray(value)
    if wire_dt is BF16:
        arr = f32_to_bf16_bits(arr)
    elif arr.dtype != wire_dt:
        arr = np.ascontiguousarray(arr.astype(wire_dt))
    if arr.nbytes >= _VIEW_MIN_BYTES:
        return memoryview(arr.view(np.uint8)).cast("B")
    return arr.tobytes()


class TreePacker:
    """Per-connection sender state: which schema ids the peer already has.

    ``always_inline=True`` is for broadcast frames (the pack-once param
    snapshot, sent to every handler's actor including freshly reconnected
    ones that never saw an earlier inline schema)."""

    def __init__(
        self,
        config: WireConfig,
        *,
        always_inline: bool = False,
        max_frame_bytes: int = MAX_FRAME_BYTES,
    ):
        self.config = config.validate()
        self.always_inline = always_inline
        self.max_frame_bytes = max_frame_bytes
        # Insertion-ordered and bounded at HALF the receiver's cache cap:
        # when the receiver FIFO-evicts a schema, the sender must have
        # already forgotten it too (and so re-inline on the next use) —
        # an unbounded sent-set would reference ids the peer no longer
        # holds and kill the connection.  Half, not equal, so the sender
        # always re-inlines strictly before the receiver could evict.
        self._sent_ids: Dict[int, None] = {}
        self.last_raw_len = 0
        self.last_payload_len = 0

    def pack(
        self, obj: Any, *, trace: Optional[TraceStamp] = None
    ) -> List[Any]:
        """Payload as a list of bytes-like parts (feed to
        ``transport.send_frame_parts`` or ``b"".join`` for storage).

        ``trace`` (a sampled batch's ``obs.trace.TraceStamp``) rides as the
        fixed-size sidecar; the packer stamps ``t_encode_end`` itself once
        the body parts (and any compression) are built — encode cannot be
        timed from outside the payload that carries the timing."""
        leaves: List = []
        schema = _describe(obj, (), self.config.encoding, leaves)
        sjson = json.dumps(schema, separators=(",", ":")).encode()
        schema_id = zlib.crc32(sjson)
        inline = self.always_inline or schema_id not in self._sent_ids
        body_parts = [_leaf_part(k, v, dt) for k, v, dt in leaves]
        raw_len = sum(len(p) for p in body_parts)
        if raw_len > self.max_frame_bytes:
            raise FrameTooLarge(
                f"payload body {raw_len}B exceeds frame ceiling "
                f"{self.max_frame_bytes}B"
            )
        comp = self.config.compress
        if comp != COMP_NONE and raw_len == 0:
            # A leafless tree has no body to compress; stamping the
            # compression code anyway would hand the receiver a "stream"
            # it can never finish inflating — mark the frame uncompressed.
            comp = COMP_NONE
        if comp != COMP_NONE:
            # Incremental compressor fed part-by-part: joining the raw
            # body first would re-copy every tensor byte — the exact copy
            # the zero-copy wire exists to avoid.  Output chunks stay a
            # parts list for send_frame_parts.
            if comp == COMP_ZLIB:
                c = zlib.compressobj(self.config.zlib_level)
            else:
                c = _zstd.ZstdCompressor().compressobj()
            compressed = []
            for p in body_parts:
                chunk = c.compress(p)
                if chunk:
                    compressed.append(chunk)
            compressed.append(c.flush())
            body_parts = compressed
        flags = _FLAG_SCHEMA_INLINE if inline else 0
        if trace is not None:
            flags |= _FLAG_TRACE
        head = _PAYLOAD_HEADER.pack(
            WIRE_VERSION,
            _COMP_CODES[comp],
            flags,
            0,
            schema_id,
            raw_len,
        )
        if trace is not None:
            # Stamped HERE, after the schema walk / body build / compression
            # above: the encode hop ends where the sidecar is written.
            trace.t_encode_end = time.time()
            head += _TRACE_SIDECAR.pack(
                int(trace.trace_id) & 0xFFFFFFFFFFFFFFFF,
                float(trace.t_collect_start),
                float(trace.t_collect_end),
                float(trace.t_encode_end),
            )
        if inline:
            head += _SCHEMA_LEN.pack(len(sjson)) + sjson
        parts = [head, *body_parts]
        self._sent_ids.pop(schema_id, None)  # refresh insertion order
        self._sent_ids[schema_id] = None
        while len(self._sent_ids) > _SCHEMA_CACHE_MAX // 2:
            self._sent_ids.pop(next(iter(self._sent_ids)))
        self.last_raw_len = raw_len
        self.last_payload_len = sum(len(p) for p in parts)
        return parts


# ---------------------------------------------------------------- unpack
def _take(cursor: List[int], body, nbytes: int) -> int:
    off = cursor[0]
    if off + nbytes > len(body):
        raise WireFormatError(
            f"body overrun: leaf needs {nbytes}B at offset {off} of a "
            f"{len(body)}B body"
        )
    cursor[0] = off + nbytes
    return off


def _rebuild(node: Any, body, cursor: List[int]) -> Any:
    if node == "n":
        return None
    if node == "t":
        return bool(_I64.unpack_from(body, _take(cursor, body, 8))[0])
    if node == "i":
        return int(_I64.unpack_from(body, _take(cursor, body, 8))[0])
    if node == "f":
        return float(_F64.unpack_from(body, _take(cursor, body, 8))[0])
    if isinstance(node, dict) and len(node) == 1:
        ((tag, val),) = node.items()
        if tag == "d":
            if not isinstance(val, list):
                raise WireFormatError(f"malformed dict schema {val!r}")
            out = {}
            for entry in val:
                if not (
                    isinstance(entry, list)
                    and len(entry) == 2
                    and isinstance(entry[0], str)
                ):
                    raise WireFormatError(f"malformed dict entry {entry!r}")
                out[entry[0]] = _rebuild(entry[1], body, cursor)
            return out
        if tag in ("u", "l") and isinstance(val, list):
            seq = [_rebuild(c, body, cursor) for c in val]
            return tuple(seq) if tag == "u" else seq
        if tag == "S" and isinstance(val, list) and len(val) in (2, 4):
            # 2 children: a provenance-free frame (old schema, or a
            # collector that does not stamp) — decodes with provenance
            # None, which DISARMS the downstream lag/age folds
            # (obs/quality.py) rather than refusing the frame.
            fields = [_rebuild(c, body, cursor) for c in val]
            if len(fields) == 2:
                return StagedSequences(seq=fields[0], priorities=fields[1])
            return StagedSequences(
                seq=fields[0],
                priorities=fields[1],
                behavior_version=fields[2],
                collect_id=fields[3],
            )
        if tag == "B" and isinstance(val, list) and len(val) == 6:
            fields = [_rebuild(c, body, cursor) for c in val]
            return SequenceBatch(
                obs=fields[0],
                action=fields[1],
                reward=fields[2],
                discount=fields[3],
                reset=fields[4],
                carries=fields[5],
            )
        if tag == "a" and isinstance(val, list) and len(val) == 3:
            storage_name, wire_name, shape = val
            if not (
                isinstance(shape, list)
                and all(isinstance(s, int) and s >= 0 for s in shape)
            ):
                raise WireFormatError(f"malformed array shape {shape!r}")
            storage_dt = _dtype_from_name(storage_name)
            wire_dt = _dtype_from_name(wire_name)
            count = math.prod(shape)
            off = _take(cursor, body, count * _itemsize(wire_dt))
            if wire_dt is BF16:
                # Restored to float32 (numpy has no bfloat16: a leaf whose
                # storage is bfloat16 comes back widened to float32, exact).
                arr = bf16_bits_to_f32(
                    np.frombuffer(body, dtype=np.uint16, count=count, offset=off)
                ).reshape(shape)
                if storage_dt is not BF16 and storage_dt != np.float32:
                    arr = arr.astype(storage_dt)
                return arr
            if storage_dt is BF16:
                raise WireFormatError(
                    "bfloat16 storage on a non-bfloat16 wire dtype"
                )
            arr = np.frombuffer(
                body, dtype=wire_dt, count=count, offset=off
            ).reshape(shape)
            if wire_dt != storage_dt:
                arr = arr.astype(storage_dt)
            return arr
    raise WireFormatError(f"malformed schema node {node!r}")


# -------------------------------------------------------- sampler frames
# The in-network-sampling control/tensor payloads (transport.K_SAMPLE_REQ /
# K_BATCH / K_PRIO, fleet/sampler.py).  Each is an ordinary tree through
# the zero-copy codec above — these helpers exist so both ends build the
# SAME key order (the schema JSON, and therefore its crc32 id and the
# golden byte layout in tests/test_wire.py, is keyed on it) and so the
# unpack side validates shape before anything touches the fields.  No new
# byte format: the zip-bomb guard, schema cache, and malformed-frame
# refusals of ``TreeUnpacker`` apply to these frames verbatim.


def pack_sample_req(
    packer: "TreePacker",
    *,
    req_id: int,
    shard: int,
    quota: int,
    trace: Optional[TraceStamp] = None,
) -> List[Any]:
    """SAMPLE_REQ payload: the learner asks shard ``shard`` for ``quota``
    of this phase's draws (two-level level 1 — quotas are drawn from a
    multinomial over the shards' advertised priority sums).

    ``trace``: a SAMPLED phase's stamp rides the same 32B
    sidecar the SEQS path uses, carrying the trace id ACROSS the shard
    socket so the shard process can stamp its ``req_receive ->
    shard_draw -> batch_encode`` hops into the same trace.  ``None``
    (the default, and the only value at trace rate 0) leaves the frame
    byte-identical to the pre-sidecar layout — the golden-wire tests and
    the loopback determinism anchor hold untouched."""
    return packer.pack(
        {"req_id": int(req_id), "shard": int(shard), "quota": int(quota)},
        trace=trace,
    )


def unpack_sample_req(obj: Any) -> Dict[str, int]:
    if not (
        isinstance(obj, dict)
        and all(isinstance(obj.get(k), int) for k in ("req_id", "shard", "quota"))
    ):
        raise WireFormatError(f"malformed SAMPLE_REQ payload {type(obj).__name__}")
    if obj["quota"] < 0 or obj["shard"] < 0:
        raise WireFormatError("SAMPLE_REQ quota/shard must be >= 0")
    return obj


def pack_shard_batch(
    packer: "TreePacker",
    *,
    req_id: int,
    shard: int,
    staged: Any,  # replay.StagedSequences (priorities None: learner ranks IS-side)
    slots: np.ndarray,
    gens: np.ndarray,
    probs: np.ndarray,
    priority_sum: float,
    occupancy: int,
    epoch: int = 0,
    behavior: Optional[np.ndarray] = None,
    collect: Optional[np.ndarray] = None,
    actors: Optional[np.ndarray] = None,
    trace: Optional[TraceStamp] = None,
) -> List[Any]:
    """BATCH payload: a shard's training-ready answer.  ``slots``/``gens``
    are the write-back handles (PRIO frames echo them; a generation the
    ring has moved past is ignored shard-side), ``probs`` the
    within-shard probabilities, and ``priority_sum``/``occupancy`` the
    shard's post-sample advertisement.  The in-learner loopback reads
    the shard sums directly (fresher than any frame), so the
    advertisement exists FOR the cross-process deployment: a remote
    learner refreshes its quota weights from these fields instead of a
    separate poll frame, which is why ``unpack_shard_batch`` validates
    them even though the loopback never consumes them.

    ``epoch`` is the shard INCARNATION fence: a standalone
    shard process (fleet/shard.py) stamps its supervisor-assigned epoch
    into every BATCH, and the learner echoes it back in the PRIO
    write-back — a restarted shard comes back empty under a bumped
    epoch, so handles sampled from the previous incarnation can never
    clobber the new ring (slot generations restart at zero and WOULD
    collide without the fence).  The in-learner loopback has exactly one
    incarnation and packs the constant 0.

    ``behavior``/``collect``/``actors`` are the drawn slots'
    quality provenance — behavior param version, collector phase clock,
    and the shard-stamped HELLO-authenticated actor code per sequence
    (``obs/quality.py`` sentinel ``-1`` for unknown).  All-or-nothing:
    omitted entirely (the default) the payload is byte-identical to the
    pre-plane layout, so the existing golden BATCH tests hold and an
    old shard's frames decode with the quality folds disarmed rather
    than refused.

    ``trace`` echoes a traced SAMPLE_REQ's sidecar back on the BATCH
    (the packer stamps ``t_encode_end`` with the shard's encode end):
    the id correlates the reply with the learner-side chain, and
    unsampled frames stay byte-identical (the rate-0 anchor)."""
    payload = {
        "req_id": int(req_id),
        "shard": int(shard),
        "epoch": int(epoch),
        "priority_sum": float(priority_sum),
        "occupancy": int(occupancy),
        "slots": np.ascontiguousarray(slots, np.int64),
        "gens": np.ascontiguousarray(gens, np.int64),
        "probs": np.ascontiguousarray(probs, np.float64),
    }
    if behavior is not None or collect is not None or actors is not None:
        if behavior is None or collect is None or actors is None:
            raise WireFormatError(
                "BATCH provenance must be all-present or all-absent"
            )
        payload["behavior"] = np.ascontiguousarray(behavior, np.int64)
        payload["collect"] = np.ascontiguousarray(collect, np.int64)
        payload["actors"] = np.ascontiguousarray(actors, np.int64)
    payload["staged"] = staged
    return packer.pack(payload, trace=trace)


def unpack_shard_batch(obj: Any) -> Dict[str, Any]:
    if not (
        isinstance(obj, dict)
        and isinstance(obj.get("req_id"), int)
        and isinstance(obj.get("shard"), int)
        and isinstance(obj.get("epoch"), int)
        and isinstance(obj.get("staged"), StagedSequences)
        # The advertisement fields must be well-formed even though the
        # in-process loopback reads shard sums directly: a cross-process
        # learner refreshes its quota weights from them (pack_shard_batch
        # docstring), and a remote frame omitting them must refuse here,
        # not KeyError in that learner's quota math.
        and isinstance(obj.get("priority_sum"), float)
        and isinstance(obj.get("occupancy"), int)
        and obj["priority_sum"] >= 0.0
        and obj["occupancy"] >= 0
        and all(
            isinstance(obj.get(k), np.ndarray)
            for k in ("slots", "gens", "probs")
        )
    ):
        raise WireFormatError("malformed BATCH payload")
    n = obj["slots"].shape[0]
    if not (
        obj["gens"].shape == (n,)
        and obj["probs"].shape == (n,)
        and np.shape(obj["staged"].seq.reward)[0] == n
    ):
        raise WireFormatError("BATCH handles/probs/sequences length mismatch")
    # Quality provenance: optional as a TRIPLE — absent frames
    # (an old shard) decode with the folds disarmed, but a frame carrying
    # a partial or mis-shaped triple is malformed, not "partially armed".
    prov = [k for k in ("behavior", "collect", "actors") if k in obj]
    if prov:
        if len(prov) != 3 or not all(
            isinstance(obj[k], np.ndarray)
            and obj[k].dtype == np.int64
            and obj[k].shape == (n,)
            for k in prov
        ):
            raise WireFormatError("malformed BATCH provenance triple")
        if any(int(obj[k].min()) < -1 for k in prov if n):
            raise WireFormatError("BATCH provenance below the -1 sentinel")
    # Range discipline (the validate-before-touch contract): a negative
    # shard index or slot from a confused/hostile peer must refuse HERE,
    # not alias to python negative indexing in the shard's ring arrays.
    if (
        obj["shard"] < 0
        or obj["epoch"] < 0
        or (n and int(obj["slots"].min()) < 0)
    ):
        raise WireFormatError("BATCH shard/epoch/slots must be >= 0")
    return obj


def pack_prio_update(
    packer: "TreePacker",
    *,
    shard: int,
    slots: np.ndarray,
    gens: np.ndarray,
    priorities: np.ndarray,
    epoch: int = 0,
    trace: Optional[TraceStamp] = None,
) -> List[Any]:
    """PRIO payload: learner TD-error write-back, keyed (shard, slot,
    generation) — the reverse ride of the versioned param-publish path.
    ``priorities`` stays float32 on every lane (``F32_PINNED_LEAVES``:
    it feeds the sampling CDF).  ``epoch`` echoes the BATCH the handles
    came from (``pack_shard_batch``): a standalone shard ignores a PRIO
    whose epoch is not its own — a verdict about a previous incarnation's
    ring must never touch the restarted one (slot generations restart at
    zero, so without the fence stale handles would falsely match).
    ``trace``: the same optional sidecar ride as the other
    sampler frames — None leaves the bytes untouched."""
    return packer.pack(
        {
            "shard": int(shard),
            "epoch": int(epoch),
            "slots": np.ascontiguousarray(slots, np.int64),
            "gens": np.ascontiguousarray(gens, np.int64),
            "priorities": np.ascontiguousarray(priorities, np.float32),
        },
        trace=trace,
    )


def coalesce_prio_update(
    slots: np.ndarray, gens: np.ndarray, priorities: np.ndarray
):
    """Coalesce one phase's write-back handles for a single (shard,
    epoch) PRIO frame: with-replacement draws repeat (slot,
    generation) keys, and applying those duplicates sequentially is
    last-write-wins — so only each key's LAST priority needs to cross
    the sampling boundary.  Surviving entries keep their original
    relative order (deterministic: a pure function of the input order),
    and the shard-side result is bit-identical to applying the
    uncoalesced stream.  Returns ``(slots, gens, priorities)`` as
    contiguous int64/int64/float32 arrays."""
    slots = np.ascontiguousarray(slots, np.int64).reshape(-1)
    gens = np.ascontiguousarray(gens, np.int64).reshape(-1)
    priorities = np.ascontiguousarray(priorities, np.float32).reshape(-1)
    if not (slots.shape == gens.shape == priorities.shape):
        raise WireFormatError(
            "coalesce: slots/gens/priorities length mismatch"
        )
    if slots.size <= 1:
        return slots, gens, priorities
    # Last occurrence per (slot, gen): unique over the REVERSED key rows
    # keeps each key's first-seen index there, i.e. its last-seen index
    # here; re-sorting the kept indices restores input order.
    keys = np.stack([slots, gens], axis=1)
    _, rev_idx = np.unique(keys[::-1], axis=0, return_index=True)
    keep = np.sort(slots.size - 1 - rev_idx)
    return slots[keep], gens[keep], priorities[keep]


def unpack_prio_update(obj: Any) -> Dict[str, Any]:
    if not (
        isinstance(obj, dict)
        and isinstance(obj.get("shard"), int)
        and isinstance(obj.get("epoch"), int)
        and all(
            isinstance(obj.get(k), np.ndarray)
            for k in ("slots", "gens", "priorities")
        )
    ):
        raise WireFormatError("malformed PRIO payload")
    n = obj["slots"].shape[0]
    if not (obj["gens"].shape == (n,) and obj["priorities"].shape == (n,)):
        raise WireFormatError("PRIO handles/priorities length mismatch")
    if (
        obj["shard"] < 0
        or obj["epoch"] < 0
        or (n and int(obj["slots"].min()) < 0)
    ):
        raise WireFormatError("PRIO shard/epoch/slots must be >= 0")
    return obj


class TreeUnpacker:
    """Per-connection receiver state: schema cache keyed by schema id.

    A frame referencing an id this connection never saw inline is a
    protocol error (the sender's cache and ours live and die with the
    same socket), and errors kill the connection — transport.py's rule."""

    def __init__(self, *, max_frame_bytes: int = MAX_FRAME_BYTES):
        self.max_frame_bytes = max_frame_bytes
        self._schemas: Dict[int, Any] = {}
        self.last_raw_len = 0
        self.last_payload_len = 0
        # The most recent frame's trace sidecar (None when unsampled) —
        # the receiver reads it right after unpack() to record the
        # actor-side hops (fleet/ingest.py).
        self.last_trace: Optional[TraceStamp] = None

    def unpack(self, payload: bytes) -> Any:
        if len(payload) < HEADER_BYTES:
            raise WireFormatError(
                f"payload {len(payload)}B shorter than wire header"
            )
        version, comp_code, flags, _rsvd, schema_id, raw_len = (
            _PAYLOAD_HEADER.unpack_from(payload, 0)
        )
        if version != WIRE_VERSION:
            raise WireFormatError(
                f"wire version {version} != supported {WIRE_VERSION}"
            )
        comp = _COMP_NAMES.get(comp_code)
        if comp is None:
            raise WireFormatError(f"unknown compression code {comp_code}")
        # THE zip-bomb guard: the ceiling applies to the DECLARED
        # DECOMPRESSED size, checked before any body allocation.
        if raw_len > self.max_frame_bytes:
            raise FrameTooLarge(
                f"declared decompressed payload {raw_len}B exceeds frame "
                f"ceiling {self.max_frame_bytes}B"
            )
        off = HEADER_BYTES
        self.last_trace = None
        if flags & _FLAG_TRACE:
            if len(payload) < off + _TRACE_SIDECAR.size:
                raise WireFormatError("truncated trace sidecar")
            tid, t0, t1, t2 = _TRACE_SIDECAR.unpack_from(payload, off)
            off += _TRACE_SIDECAR.size
            self.last_trace = TraceStamp(
                trace_id=tid,
                t_collect_start=t0,
                t_collect_end=t1,
                t_encode_end=t2,
            )
        if flags & _FLAG_SCHEMA_INLINE:
            if len(payload) < off + _SCHEMA_LEN.size:
                raise WireFormatError("truncated schema length")
            (slen,) = _SCHEMA_LEN.unpack_from(payload, off)
            off += _SCHEMA_LEN.size
            if off + slen > len(payload):
                raise WireFormatError(
                    f"schema ({slen}B) overruns payload ({len(payload)}B)"
                )
            sbytes = payload[off : off + slen]
            off += slen
            if zlib.crc32(sbytes) != schema_id:
                raise WireFormatError("schema bytes do not match schema id")
            try:
                schema = json.loads(sbytes)
            except ValueError as e:
                raise WireFormatError(f"unparseable schema JSON: {e}")
            except RecursionError:
                raise WireFormatError("schema nesting exceeds decode depth")
            # pop-then-insert so a RE-inlined schema moves to the newest
            # FIFO position — leaving it at its original slot would evict
            # it while the sender (which did refresh) still references it.
            self._schemas.pop(schema_id, None)
            self._schemas[schema_id] = schema
            while len(self._schemas) > _SCHEMA_CACHE_MAX:
                # FIFO eviction (dicts iterate in insertion order): the
                # hot schemas are re-inlined by the sender on a cache
                # miss via the unknown-id error path killing the
                # connection — in practice never, since real fleets use
                # a handful of schemas.
                self._schemas.pop(next(iter(self._schemas)))
        else:
            schema = self._schemas.get(schema_id)
            if schema is None:
                raise WireFormatError(
                    f"unknown schema id {schema_id:#010x} (a connection's "
                    f"first frame of each shape must inline its schema)"
                )
            # LRU refresh on REFERENCE, mirroring the sender's refresh on
            # every pack: both caches see the same access sequence, so
            # with the sender's cap at half this one's it always forgets
            # (and re-inlines) a schema strictly before this side could
            # evict it — FIFO here would age out a schema the sender
            # keeps hot by id.
            self._schemas.pop(schema_id)
            self._schemas[schema_id] = schema
        body = memoryview(payload)[off:]
        if comp != COMP_NONE and raw_len == 0:
            # The packer marks leafless frames uncompressed, so this
            # combination is never legitimate — and it MUST be refused
            # here: zlib's max_length=0 below would mean "no output
            # limit", turning a declared-zero-length bomb into unbounded
            # inflation before the length check could fire.
            raise WireFormatError(
                "compressed frame declaring zero decompressed length"
            )
        if comp == COMP_NONE:
            if len(body) != raw_len:
                raise WireFormatError(
                    f"body {len(body)}B != declared raw length {raw_len}B"
                )
        elif comp == COMP_ZLIB:
            d = zlib.decompressobj()
            try:
                # max_length=raw_len hard-caps the output allocation (the
                # ceiling was already enforced on raw_len above); the
                # memoryview goes in directly — no copy of the compressed
                # body on the hot path.
                raw = d.decompress(body, raw_len)
            except zlib.error as e:
                raise WireFormatError(f"zlib error: {e}")
            if (
                len(raw) != raw_len
                or not d.eof
                or d.unconsumed_tail
                or d.unused_data  # trailing bytes AFTER the stream's end
            ):
                raise WireFormatError(
                    f"declared decompressed length {raw_len}B does not "
                    f"match the stream (got {len(raw)}B, eof={d.eof})"
                )
            body = memoryview(raw)
        else:
            if _zstd is None:
                raise WireFormatError(
                    "zstd-compressed frame but no zstandard module"
                )
            try:
                raw = _zstd.ZstdDecompressor().decompress(
                    body, max_output_size=raw_len
                )
            except _zstd.ZstdError as e:
                # Mirror the zlib branch: codec violations must surface
                # as FrameError so handler loops kill the CONNECTION,
                # not their own thread.
                raise WireFormatError(f"zstd error: {e}")
            if len(raw) != raw_len:
                raise WireFormatError(
                    f"declared decompressed length {raw_len}B != {len(raw)}B"
                )
            body = memoryview(raw)
        cursor = [0]
        try:
            obj = _rebuild(schema, body, cursor)
        except RecursionError:
            # A pathologically nested schema must surface as a protocol
            # error (FrameError contract), not escape the handler's
            # except clause and kill its thread silently.
            raise WireFormatError("schema nesting exceeds decode depth")
        if cursor[0] != raw_len:
            raise WireFormatError(
                f"schema consumed {cursor[0]}B of a {raw_len}B body"
            )
        self.last_raw_len = raw_len
        self.last_payload_len = len(payload)
        return obj
