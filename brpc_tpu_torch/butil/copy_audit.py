"""Copy audit — the Python half of the data-plane copy counters.

The zero-copy invariant must be *asserted by tests, not claimed by
comments*: the C++ engine counts its own payload copies in
``engine.telemetry()['data_plane_copies']``; this module counts the
Python side's.  Every place the Python stack materializes or copies
payload bytes at data-plane scale (``IOBuf._append_copy``, ``fetch`` /
``to_bytes``, shm staging, scatter-gather landing) reports here when
auditing is on.

Off by default and gated by a single module-level bool so the hot path
pays one global load + branch; tests flip it with :func:`audit`.

Stages (fixed vocabulary — tests diff these, no "unknown" bucket):

- ``ingest``       bytes copied INTO pool blocks (``_append_copy``)
- ``materialize``  IOBuf → flat bytes (``fetch``/``to_bytes``/copy_to)
- ``gather``       multi-block scatter-gather joined into one buffer
- ``stage_shm``    the shm lane's one staging memcpy into a ring slot
- ``spill_host``   the KV host tier's one memcpy per spilled page

A copy of ``brpc_tpu/butil/copy_audit.py``.  The port has no C++
engine; its ``stage_shm`` point is the shm ring's staging copy
(``transport/shm_ring.py``) and its ``spill_host`` point the host tier's
spill (``kv/pages.py``), where the JAX package records them.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

STAGES = ("ingest", "materialize", "gather", "stage_shm", "spill_host")

# copies below this size are bookkeeping (headers, metas, small
# payloads), not data-plane traffic — the audit tracks tensor-scale
# movement only
AUDIT_FLOOR = 64 * 1024

enabled = False          # module-global: one load on the hot path

_lock = threading.Lock()
_counts: Dict[str, int] = {s: 0 for s in STAGES}
_bytes: Dict[str, int] = {s: 0 for s in STAGES}


def record(stage: str, nbytes: int) -> None:
    """Count one payload copy of ``nbytes`` (callers pre-check
    ``enabled`` and the floor — this function trusts them)."""
    with _lock:
        _counts[stage] += 1
        _bytes[stage] += nbytes


def snapshot() -> Tuple[Dict[str, int], Dict[str, int]]:
    with _lock:
        return dict(_counts), dict(_bytes)


def total_copies() -> int:
    with _lock:
        return sum(_counts.values())


def reset() -> None:
    with _lock:
        for s in STAGES:
            _counts[s] = 0
            _bytes[s] = 0


class audit:
    """``with copy_audit.audit() as snap:`` — enables auditing for the
    block; ``snap()`` returns (counts, bytes) accumulated since entry."""

    def __enter__(self):
        global enabled
        reset()
        self._was = enabled
        enabled = True
        return snapshot

    def __exit__(self, *exc):
        global enabled
        enabled = self._was
        return False
