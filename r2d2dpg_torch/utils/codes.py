"""Response and shed codes of the serving admission layer and the fleet.

A copy of ``r2d2dpg_tpu/utils/codes.py``.  The codes cross process
boundaries verbatim (the serve CLI's JSONL replies, the fleet wire's acks,
flight events), so every string is letter-for-letter the JAX package's.
"""

from __future__ import annotations

OK = "ok"
# The micro-batcher's bounded request queue is full.
SHED_QUEUE = "shed_queue_full"
# The session-slot table is full after a TTL sweep.
SHED_SESSIONS = "shed_session_capacity"
# Fleet ingest: the learner's staging queue is full; the batch is shed and
# the actor keeps collecting.
SHED_INGEST = "shed_ingest_queue_full"
# Fleet ingest HELLO: the actor's wire version/encoding/compression does
# not match the learner's (fleet/wire.py); the connection is refused.
REFUSED_WIRE = "refused_wire_mismatch"
# Fleet ingest HELLO: the actor's --fleet-token proof does not match.
REFUSED_AUTH = "refused_auth"
SHUTDOWN = "shutdown"

# Process exit codes of refused HELLOs: deterministic misconfiguration, so
# the supervisor gives the slot up instead of restarting it forever.
EXIT_WIRE_REFUSED = 64
EXIT_AUTH_REFUSED = 65
TERMINAL_ACTOR_EXITS = {
    EXIT_WIRE_REFUSED: "wire_refused",
    EXIT_AUTH_REFUSED: "auth_refused",
}

ALL_SHED_CODES = (SHED_QUEUE, SHED_SESSIONS, SHED_INGEST)
