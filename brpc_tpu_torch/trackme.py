"""trackme — fleet version check-in, the server half.

≈ brpc's src/brpc/details/trackme.cpp: clients ping a central "trackme"
server at a gentle interval reporting their framework version; the
server answers with a severity + message so operators can flag fleets
running buggy/ancient builds.  The server half is the builtin
``/trackme`` page (flag-tunable version gates).

The server half of ``brpc_tpu/trackme.py``: :func:`handle_trackme_query`
and its two flags.  The client half (``start_trackme``/``stop_trackme``,
the ``trackme_server`` and ``trackme_interval_s`` flags) pings through
``tools/rpc_view`` and waits for the port of ``tools/``.
"""

from __future__ import annotations

from . import __version__
from .butil.flags import define_flag, get_flag

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
