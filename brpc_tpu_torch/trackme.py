"""trackme — fleet version phone-home.

≈ brpc's src/brpc/details/trackme.cpp: clients ping a central "trackme"
server at a gentle interval reporting their framework version; the
server answers with a severity + message so operators can flag fleets
running buggy/ancient builds.  The server half is the builtin
``/trackme`` page (flag-tunable version gates); the client half is
:func:`start_trackme`, driven by the ``trackme_server`` flag.

A copy of ``brpc_tpu/trackme.py``: the client pings through the port's
``tools/rpc_view.fetch`` on the port's ``butil/periodic_task``.
"""

from __future__ import annotations

import json
from typing import Optional

from . import __version__
from .butil.flags import define_flag, get_flag
from .butil.logging_util import LOG
from .butil.periodic_task import PeriodicTask

define_flag("trackme_server", "",
            "host:port pinged periodically with this process's framework "
            "version (empty = off)", lambda v: True)
define_flag("trackme_interval_s", 300,
            "seconds between trackme pings", lambda v: int(v) > 0)
define_flag("trackme_min_version", "",
            "server side: versions below this answer severity=warn",
            lambda v: True)
define_flag("trackme_fatal_version", "",
            "server side: versions below this answer severity=fatal",
            lambda v: True)

SEV_OK = 0
SEV_WARN = 1
SEV_FATAL = 2


def _version_tuple(v: str):
    out = []
    for part in v.split("."):
        digits = "".join(ch for ch in part if ch.isdigit())
        out.append(int(digits or 0))
    return tuple(out)


def handle_trackme_query(ver: str) -> dict:
    """Server side: classify a reported version against the gates."""
    sev, msg = SEV_OK, ""
    fatal = str(get_flag("trackme_fatal_version", ""))
    warn = str(get_flag("trackme_min_version", ""))
    try:
        vt = _version_tuple(ver)
        if fatal and vt < _version_tuple(fatal):
            sev, msg = SEV_FATAL, f"version {ver} < fatal floor {fatal}"
        elif warn and vt < _version_tuple(warn):
            sev, msg = SEV_WARN, f"version {ver} < advised floor {warn}"
    except ValueError:
        sev, msg = SEV_WARN, f"unparsable version {ver!r}"
    return {"severity": sev, "message": msg, "server_version": __version__}


_task: Optional[PeriodicTask] = None


def start_trackme(server: Optional[str] = None,
                  interval_s: Optional[float] = None) -> bool:
    """Begin pinging the trackme server (explicit addr or the
    ``trackme_server`` flag).  Idempotent; returns False when no server
    is configured."""
    global _task
    addr = server or str(get_flag("trackme_server", ""))
    if not addr:
        return False
    if _task is not None:
        return True
    ivl = float(interval_s or get_flag("trackme_interval_s", 300))

    def ping():
        from .tools.rpc_view import fetch
        try:
            body = fetch(addr, f"trackme?ver={__version__}", timeout=5.0)
            reply = json.loads(body)
        except Exception as e:
            LOG.debug("trackme ping failed: %s", e)
            return
        sev = int(reply.get("severity", 0))
        if sev >= SEV_FATAL:
            LOG.error("TRACKME: %s", reply.get("message", ""))
        elif sev >= SEV_WARN:
            LOG.warning("TRACKME: %s", reply.get("message", ""))

    _task = PeriodicTask(ivl, ping, run_immediately=True)
    return True


def stop_trackme() -> None:
    global _task
    if _task is not None:
        _task.stop()
        _task = None
