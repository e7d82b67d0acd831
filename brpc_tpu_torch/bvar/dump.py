"""Periodic bvar dump-to-file
(≈ brpc's src/bvar/variable.cpp:690-729: ``FLAGS_bvar_dump``
writes every exposed variable to ``bvar_dump_file`` each
``bvar_dump_interval`` seconds — the hook fleet monitors scrape).

Flags (live-tunable via /flags like the reference's reloadable gflags):

- ``bvar_dump``          master switch (off by default)
- ``bvar_dump_file``     target path; parent dirs are created
- ``bvar_dump_interval`` seconds between dumps
- ``bvar_dump_prefix``   only variables whose name starts with this

Writes are atomic (temp file + rename) so a scraper never reads a
half-written snapshot.

A copy of ``brpc_tpu/bvar/dump.py``: each tick is a task on the
process's ``fiber.timer_thread``, which schedules the next.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..butil.flags import define_flag, get_flag
from ..butil.logging_util import LOG
from .variable import dump_exposed

define_flag("bvar_dump", False,
            "periodically dump every exposed bvar to bvar_dump_file",
            validator=lambda v: True)
define_flag("bvar_dump_file", "monitor/bvar.data",
            "target file for the periodic bvar dump",
            validator=lambda v: bool(str(v)))
define_flag("bvar_dump_interval", 10,
            "seconds between bvar dumps",
            validator=lambda v: int(v) > 0)
define_flag("bvar_dump_prefix", "",
            "only dump variables whose exposed name starts with this",
            validator=lambda v: True)

_started = False
_start_lock = threading.Lock()
_dump_lock = threading.Lock()


def dump_once(path: Optional[str] = None) -> str:
    """Write one snapshot (atomically); returns the path written."""
    path = path or str(get_flag("bvar_dump_file", "monitor/bvar.data"))
    prefix = str(get_flag("bvar_dump_prefix", ""))
    snapshot = dump_exposed(prefix)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    # serialized + thread-tagged tmp: concurrent dump_once calls (the
    # periodic tick racing an on-demand dump) must never interleave
    # writes into one tmp file and promote a torn snapshot
    with _dump_lock:
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            for name in sorted(snapshot):
                f.write(f"{name} : {snapshot[name]}\n")
        os.replace(tmp, path)             # atomic snapshot swap
    return path


def ensure_dumper() -> None:
    """Start the periodic dump task (idempotent).  A no-op while the
    ``bvar_dump`` flag is off — call again after enabling it (servers
    call this on start, so the common path is: set the flag, start the
    server).  Once running, flipping the flag off pauses writes; the
    idle tick is a dict lookup every interval."""
    global _started
    if not get_flag("bvar_dump", False):
        return                  # nothing to run; retry after enabling
    with _start_lock:
        if _started:
            return
        _started = True
    from ..fiber.timer_thread import global_timer_thread

    def tick():
        try:
            if get_flag("bvar_dump", False):
                dump_once()
        except Exception as e:
            LOG.warning("bvar dump failed: %s", e)
        finally:
            global_timer_thread().schedule(
                tick, max(int(get_flag("bvar_dump_interval", 10)), 1))

    global_timer_thread().schedule(
        tick, max(int(get_flag("bvar_dump_interval", 10)), 1))
