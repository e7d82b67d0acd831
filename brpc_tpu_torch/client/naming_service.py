"""Naming services — who are my servers?

≈ brpc's src/brpc/naming_service.h:36-61 +
periodic_naming_service.cpp: a NamingService pushes full server lists to
NamingServiceActions; most implementations poll a source periodically and
push on change. A watcher (the LB) applies deltas through
DoublyBufferedData so selection never takes the update lock.

Server entries may carry a tag (``host:port tag``) — PartitionChannel
reads partition tags like ``2/4`` from it
(brpc's src/brpc/partition_channel.h:46).

A copy of ``brpc_tpu/client/naming_service.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import time as _time

from ..butil.endpoint import EndPoint, parse_endpoint
from ..butil.extension import extension
from ..butil.flags import define_flag, get_flag
from ..butil.logging_util import LOG
from ..fiber.timer_thread import global_timer_thread

DEFAULT_REFRESH_S = 5.0

define_flag("lame_duck_ttl_s", 10.0,
            "how long a lame-duck mark keeps a node out of LB "
            "selection before it may rejoin (a restarted replica "
            "re-qualifies after this TTL even when the naming source "
            "still lists it); refreshed by every further lame-duck "
            "signal from the node",
            validator=lambda v: isinstance(v, (int, float)) and v > 0)


class LameDuckRegistry:
    """Process-global endpoint → lame-duck-until (monotonic seconds).

    The operability plane's client half: a server entering drain says
    so on every response (meta TLV 23 / ``x-lame-duck`` / GOAWAY) and
    with every ``ELAMEDUCK`` rejection; the mark removes the node from
    LB selection IMMEDIATELY — in-flight responses are still accepted,
    and the circuit breaker sees no error (a planned restart is not a
    failure).  Marks expire after ``lame_duck_ttl_s`` so the restarted
    replica rejoins without any naming-source round trip; a fresh
    naming push that no longer lists the node removes it the ordinary
    way."""

    def __init__(self):
        self._lock = threading.Lock()
        self._until: dict = {}          # EndPoint -> monotonic expiry
        self.marks = 0                  # lifetime marks (diagnostics)

    def mark(self, ep, ttl_s: Optional[float] = None) -> None:
        if ep is None:
            return
        ttl = float(ttl_s if ttl_s is not None
                    else get_flag("lame_duck_ttl_s", 10.0))
        with self._lock:
            self._until[ep] = _time.monotonic() + ttl
            self.marks += 1

    def clear(self, ep) -> None:
        """Drop a mark — fed by any CLEAN response from the endpoint
        (no lame-duck TLV): the restarted successor on the same
        address must not inherit its predecessor's mark.  Unmarked
        endpoints exit on the GIL-atomic dict read, so the completion
        paths may call this per response."""
        if ep in self._until:
            with self._lock:
                self._until.pop(ep, None)

    def is_lame(self, ep) -> bool:
        until = self._until.get(ep)
        if until is None:
            return False
        if _time.monotonic() >= until:
            with self._lock:
                # re-check under the lock: a racing mark() must win
                u2 = self._until.get(ep)
                if u2 is not None and _time.monotonic() >= u2:
                    del self._until[ep]
            return False
        return True

    def snapshot(self) -> dict:
        now = _time.monotonic()
        with self._lock:
            return {ep: round(u - now, 3)
                    for ep, u in self._until.items() if u > now}

    def reset(self) -> None:
        with self._lock:
            self._until.clear()


_lame_ducks: Optional[LameDuckRegistry] = None
_lame_lock = threading.Lock()


def global_lame_ducks() -> LameDuckRegistry:
    global _lame_ducks
    if _lame_ducks is None:
        with _lame_lock:
            if _lame_ducks is None:
                _lame_ducks = LameDuckRegistry()
    return _lame_ducks


@dataclass(frozen=True)
class ServerNode:
    endpoint: EndPoint
    tag: str = ""

    def __str__(self) -> str:
        return f"{self.endpoint} {self.tag}".strip()


def parse_server_line(line: str) -> Optional[ServerNode]:
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    parts = line.split(None, 1)
    try:
        ep = parse_endpoint(parts[0])
    except (ValueError, IndexError):
        return None
    return ServerNode(ep, parts[1].strip() if len(parts) > 1 else "")


class NamingService:
    """Implementations override :meth:`fetch_servers` (pull model) or run
    their own push loop calling ``self.push(nodes)``."""

    def __init__(self):
        self._watchers: List[Callable[[List[ServerNode]], None]] = []
        self._watch_lock = threading.Lock()
        # serializes deliveries so a watcher never sees an older list
        # after a newer one (watch()'s initial snapshot vs a racing push)
        self._deliver_lock = threading.Lock()
        self._last: Optional[List[ServerNode]] = None
        self._timer_id = 0
        self._stopped = False
        self.refresh_interval_s = DEFAULT_REFRESH_S

    # -- override points ---------------------------------------------------

    def fetch_servers(self) -> Optional[Sequence[ServerNode]]:
        """Return the full current list, or None on transient failure
        (watchers keep the previous list — the reference's degrade
        behavior)."""
        raise NotImplementedError

    def run_once(self) -> None:
        nodes = None
        try:
            nodes = self.fetch_servers()
        except Exception as e:
            LOG.warning("naming fetch failed: %s", e)
        if nodes is not None:
            self.push(list(nodes))

    # -- machinery ---------------------------------------------------------

    def start(self, url_path: str) -> int:
        """Parse/validate the source; begin periodic refresh."""
        self.run_once()
        self._schedule()
        return 0

    def _schedule(self) -> None:
        if self._stopped or self.refresh_interval_s <= 0:
            return
        self._timer_id = global_timer_thread().schedule(
            self._tick, self.refresh_interval_s)

    def _tick(self) -> None:
        if self._stopped:
            return
        self.run_once()
        self._schedule()

    def push(self, nodes: List[ServerNode]) -> None:
        """≈ NamingServiceActions::ResetServers: full-list semantics."""
        with self._deliver_lock:
            with self._watch_lock:
                if self._last is not None and nodes == self._last:
                    return
                self._last = list(nodes)
                watchers = list(self._watchers)
            for w in watchers:
                try:
                    w(list(nodes))
                except Exception:
                    LOG.exception("naming watcher raised")

    def watch(self, fn: Callable[[List[ServerNode]], None]) -> None:
        with self._deliver_lock:
            with self._watch_lock:
                self._watchers.append(fn)
                last = list(self._last) if self._last is not None else None
            if last is not None:
                fn(last)

    def stop(self) -> None:
        self._stopped = True
        if self._timer_id:
            global_timer_thread().unschedule(self._timer_id)

    @property
    def current(self) -> List[ServerNode]:
        with self._watch_lock:
            return list(self._last or [])


def naming_registry():
    return extension("naming_service")


def create_naming_service(url: str) -> Optional[NamingService]:
    """``scheme://rest`` → a STARTED NamingService instance."""
    from ..policy import naming as _builtin   # registers the schemes
    if "://" not in url:
        return None
    scheme, rest = url.split("://", 1)
    factory = naming_registry().find(scheme)
    if factory is None:
        LOG.error("unknown naming scheme %r (known: %s)", scheme,
                  naming_registry().list())
        return None
    ns = factory()
    if ns.start(rest) != 0:
        return None
    return ns
