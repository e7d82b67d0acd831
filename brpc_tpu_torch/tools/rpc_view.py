"""rpc_view — browse a remote server's builtin portal.

A copy of ``brpc_tpu/tools/rpc_view.py`` (≈ brpc's
tools/rpc_view/rpc_view.cpp), nothing cut: not just a fetcher — a
local HTTP proxy that serves any remote rank's portal to a browser,
rewriting the page's absolute links so navigation (vars trends, rpcz
drill-downs, hotspots, flags) keeps flowing through the proxy.  The
operator debugging rank 1234 of a fleet points a browser at
``localhost:<proxy>/10.0.0.5:8080/status`` and walks the whole portal.

    python -m brpc_tpu_torch.tools.rpc_view host:port [page]     # one page
    python -m brpc_tpu_torch.tools.rpc_view --proxy 8888         # browse mode
"""

from __future__ import annotations

import http.client
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple


def fetch_raw(server: str, page: str = "status",
              timeout: float = 10.0) -> Tuple[int, str, bytes, str]:
    """(status, content_type, body, location) from a remote portal page
    (location is "" unless the upstream answered a redirect)."""
    host, _, port = server.partition(":")
    conn = http.client.HTTPConnection(host, int(port or 80),
                                      timeout=timeout)
    try:
        conn.request("GET", "/" + page.lstrip("/"))
        resp = conn.getresponse()
        body = resp.read()
        ctype = resp.headers.get("Content-Type", "text/plain")
        return resp.status, ctype, body, resp.headers.get("Location", "")
    finally:
        conn.close()


def fetch(server: str, page: str = "status", timeout: float = 10.0) -> str:
    status, _, body, _loc = fetch_raw(server, page, timeout)
    if status != 200:
        raise RuntimeError(f"HTTP {status}: {body[:200]!r}")
    return body.decode("utf-8", "replace")


# absolute-path link attributes and redirects get re-rooted under the
# proxy's /<target>/ prefix so the browser stays inside the proxy
_LINK_RE = re.compile(
    rb"""((?:href|src|action)\s*=\s*["'])/(?!/)""", re.IGNORECASE)
_TARGET_RE = re.compile(r"^/([^/]+:\d+)(/.*)?$")


def rewrite_links(body: bytes, target: str) -> bytes:
    """Re-root absolute links: href="/vars" → href="/<target>/vars"."""
    return _LINK_RE.sub(
        lambda m: m.group(1) + b"/" + target.encode() + b"/", body)


class ViewProxy:
    """The browsing proxy.  URL shape: ``/<host:port>/<portal path>``;
    ``/`` lists usage.  Serves on a daemon thread."""

    def __init__(self, port: int = 0, timeout: float = 10.0):
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                m = _TARGET_RE.match(self.path)
                if m is None:
                    body = (b"rpc_view proxy: browse a remote portal at "
                            b"/<host:port>/<page>\n")
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                target, rest = m.group(1), (m.group(2) or "/status")
                try:
                    status, ctype, body, location = fetch_raw(
                        target, rest, timeout=proxy.timeout)
                except (OSError, http.client.HTTPException) as e:
                    body = f"upstream {target} unreachable: {e}\n".encode()
                    self.send_response(502)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if ctype.startswith("text/html"):
                    body = rewrite_links(body, target)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                if location:
                    # re-root absolute redirects so the browser stays
                    # inside the proxy's /<target>/ namespace
                    if location.startswith("/") \
                            and not location.startswith("//"):
                        location = f"/{target}{location}"
                    self.send_header("Location", location)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.timeout = timeout
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thr: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thr = threading.Thread(target=self.httpd.serve_forever,
                                     daemon=True, name="rpc_view-proxy")
        self._thr.start()
        return self.port

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="view a tpu-rpc server portal")
    ap.add_argument("server", nargs="?", help="host:port")
    ap.add_argument("page", nargs="?", default="status")
    ap.add_argument("--proxy", type=int, metavar="PORT",
                    help="serve a browsing proxy instead of fetching once")
    args = ap.parse_args(argv)
    if args.proxy is not None:
        proxy = ViewProxy(port=args.proxy)
        port = proxy.start()
        print(f"rpc_view proxy on http://127.0.0.1:{port}/ — open "
              f"http://127.0.0.1:{port}/<host:port>/status")
        try:
            proxy._thr.join()
        except KeyboardInterrupt:
            proxy.stop()
        return 0
    if not args.server:
        ap.error("server required unless --proxy is given")
    print(fetch(args.server, args.page), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
