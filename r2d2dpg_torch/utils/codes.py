"""Response and shed codes of the serving admission layer.

A copy of the serving codes of ``r2d2dpg_tpu/utils/codes.py``.  They cross
process boundaries verbatim (the serve CLI's JSONL replies, flight events),
so every string is letter-for-letter the JAX package's.  The fleet's codes
(ingest sheds, refused HELLOs, actor exit codes) come with the fleet slice.
"""

from __future__ import annotations

OK = "ok"
# The micro-batcher's bounded request queue is full.
SHED_QUEUE = "shed_queue_full"
# The session-slot table is full after a TTL sweep.
SHED_SESSIONS = "shed_session_capacity"
SHUTDOWN = "shutdown"
