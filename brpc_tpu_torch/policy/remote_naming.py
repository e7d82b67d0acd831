"""Watch-based remote naming service — membership from a fleet
controller endpoint over HTTP long-poll.

≈ brpc's src/brpc/policy/consul_naming_service.cpp: the
reference watches consul with blocking queries (``?index=N&wait=60s``),
resumes from the ``X-Consul-Index`` response header, and degrades to a
file-based snapshot when the registry is unreachable.  A fleet's
membership comes from a controller service the same way — this NS
speaks that shape natively:

    ``watch://host:port/path``

- GET ``path?index=N&wait=Ws``: the controller blocks until its
  membership index advances past N (or the wait expires), then answers
  the full list — one ``host:port [tag]`` per line (the file-NS line
  format) — with the new index in the ``X-Fleet-Index`` header.
- No ``X-Fleet-Index`` header ⇒ the endpoint is a plain snapshot;
  the NS falls back to periodic polling at ``refresh_interval_s``.
- Every successful fetch is mirrored to
  ``<remote_ns_backup_dir>/<sanitized-url>``; when the controller is
  unreachable before the first fetch, the backup seeds the server list
  (the reference's degrade-to-file behavior), so a restarting client
  rides out a controller outage.

The long-poll runs on a dedicated daemon thread (not the shared
periodic timer): a blocking watch must never stall other naming
services' refreshes.

A copy of ``brpc_tpu/policy/remote_naming.py``.
"""

from __future__ import annotations

import os
import re
import threading
import urllib.error
import urllib.request
from typing import List, Optional

from ..butil.flags import define_flag, get_flag
from ..butil.logging_util import LOG
from ..client.naming_service import (NamingService, ServerNode,
                                     naming_registry, parse_server_line)

define_flag("remote_ns_wait_s", 30,
            "long-poll wait the watch:// naming service asks of the "
            "controller", lambda v: int(v) > 0)
define_flag("remote_ns_backup_dir", "",
            "mirror watch:// membership to files here and seed from "
            "them when the controller is down at startup ('' = off)",
            lambda v: True)

INDEX_HEADER = "X-Fleet-Index"


def _backup_path(url: str) -> Optional[str]:
    d = str(get_flag("remote_ns_backup_dir", "") or "")
    if not d:
        return None
    return os.path.join(d, re.sub(r"[^A-Za-z0-9_.-]", "_", url))


def parse_membership(text: str) -> List[ServerNode]:
    nodes = []
    for line in text.splitlines():
        node = parse_server_line(line)
        if node is not None:
            nodes.append(node)
    return nodes


class WatchNamingService(NamingService):
    """Blocking long-poll against a membership endpoint, with index
    resumption and degrade-to-file."""

    def __init__(self):
        super().__init__()
        self.refresh_interval_s = 0        # we own our cadence
        self._url = ""
        self._index = 0
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()

    # -- NamingService ----------------------------------------------------

    def start(self, url_path: str) -> int:
        # url_path is everything after "watch://"
        if not url_path or "/" not in url_path and ":" not in url_path:
            return -1
        if "/" not in url_path.split("?", 1)[0]:
            # bare host:port — without a path the long-poll selector
            # would be "?index=..." (no leading '/'), a malformed
            # origin-form that strict servers reject; poll the root.
            # The slash goes BEFORE any query string.
            if "?" in url_path:
                host, q = url_path.split("?", 1)
                url_path = host + "/?" + q
            else:
                url_path += "/"
        self._url = "http://" + url_path
        self._thread = threading.Thread(
            target=self._watch_loop, name=f"ns-watch {url_path}",
            daemon=True)
        self._thread.start()
        return 0

    def stop(self) -> None:
        super().stop()
        self._wake.set()

    def fetch_servers(self):
        return self.current

    # -- watch loop -------------------------------------------------------

    def _fetch(self, wait_s: int) -> Optional[List[ServerNode]]:
        """One blocking query; returns the list or None on failure.
        Advances the resumption index from the response header."""
        sep = "&" if "?" in self._url else "?"
        url = f"{self._url}{sep}index={self._index}&wait={wait_s}s"
        req = urllib.request.Request(url, headers={
            "Accept": "text/plain"})
        # the controller may hold the request for the full wait; pad the
        # socket timeout so a healthy long-poll never trips it
        with urllib.request.urlopen(req, timeout=wait_s + 10) as resp:
            body = resp.read().decode("utf-8", "replace")
            idx = resp.headers.get(INDEX_HEADER)
            if idx is not None:
                try:
                    self._index = max(self._index, int(idx))
                except ValueError:
                    pass
            else:
                self._index = -1          # snapshot endpoint: poll mode
            return parse_membership(body)

    def _watch_loop(self) -> None:
        import time as _time
        backoff = 1.0
        seeded = False
        while not self._stopped:
            wait_s = int(get_flag("remote_ns_wait_s", 30))
            prev_index = self._index
            t0 = _time.monotonic()
            try:
                nodes = self._fetch(wait_s)
            except (urllib.error.URLError, OSError, ValueError) as e:
                if not seeded and self._last is None:
                    self._seed_from_backup()
                    seeded = True
                LOG.warning("watch NS %s unreachable (%s); retry in %.0fs",
                            self._url, e, backoff)
                self._wake.wait(backoff)
                backoff = min(backoff * 2, 30.0)
                continue
            backoff = 1.0
            if nodes is not None:
                self.push(nodes)
                self._mirror_to_backup(nodes)
            if self._index < 0:
                # plain snapshot endpoint — no server-side blocking, so
                # pace the polling ourselves
                self._wake.wait(
                    float(get_flag("remote_ns_snapshot_poll_s", 5.0)))
            elif self._index == prev_index \
                    and _time.monotonic() - t0 < 1.0:
                # a controller that claims indexed semantics but answers
                # instantly without advancing would otherwise be
                # hammered at one request per RTT — floor the cadence
                self._wake.wait(1.0)

    # -- degrade-to-file --------------------------------------------------

    def _mirror_to_backup(self, nodes: List[ServerNode]) -> None:
        path = _backup_path(self._url)
        if path is None:
            return
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write("\n".join(str(n) for n in nodes) + "\n")
            os.replace(tmp, path)
        except OSError as e:
            LOG.warning("watch NS backup write failed: %s", e)

    def _seed_from_backup(self) -> None:
        path = _backup_path(self._url)
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                nodes = parse_membership(f.read())
        except OSError:
            return
        if nodes:
            LOG.warning("watch NS %s: seeding %d servers from backup %s",
                        self._url, len(nodes), path)
            self.push(nodes)


define_flag("remote_ns_snapshot_poll_s", 5.0,
            "poll period for watch:// endpoints that answer without an "
            "index header", lambda v: float(v) > 0)

naming_registry().register("watch", WatchNamingService)
