"""Health checking -- revive failed connections by periodic re-connect.

The port of ``brpc_tpu/transport/health_check.py`` (brpc's
``details/health_check.cpp``): when a client socket with a health-check
interval fails (``Socket.set_failed``), the process timer thread
(``fiber/timer_thread.py``) tries ``Socket.reconnect_now`` every
interval; on success the socket is revived in place (same id, the
``"single"`` connection every channel to the peer shares) and
``socket_revive_count`` counts it.  Revival stops once the socket is
destroyed (``Socket.close``) or after ``max_attempts`` tries.  Cut, as in
the JAX package: the application-level check RPC
(``health_check_path``).
"""

from __future__ import annotations

from ..butil.logging_util import LOG
from ..bvar.reducer import Adder
from ..fiber.timer_thread import global_timer_thread
from .socket import Socket

_revived = Adder("socket_revive_count")


def start_health_check(sid: int, interval_s: float,
                       max_attempts: int = 0) -> None:
    """Schedule reconnect attempts for the failed socket ``sid`` every
    ``interval_s`` (the ``health_check_interval_s`` flag, 3 s by
    default)."""
    attempt = {"n": 0}

    def check() -> None:
        s = Socket.address(sid)
        if s is None or not s.failed or s.remote_side is None:
            return                       # destroyed or already revived
        attempt["n"] += 1
        if s.reconnect_now():
            _revived << 1
            return
        if max_attempts and attempt["n"] >= max_attempts:
            LOG.warning("health check giving up on socket %d (%s)",
                        sid, s.remote_side)
            return
        global_timer_thread().schedule(check, delay_s=interval_s)

    global_timer_thread().schedule(check, delay_s=interval_s)


def revive_count() -> int:
    """Sockets revived by the health check in this process."""
    return _revived.get_value()
