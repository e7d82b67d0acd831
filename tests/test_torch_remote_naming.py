"""The port's ``watch://`` naming service, case by case as
``tests/test_remote_naming.py``, with the same tiny HTTP controller:
long-poll membership, index resumption, a membership change under live
traffic with no dropped request, and degrade-to-file; plus the port's and
the JAX package's watchers reading one controller alike."""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import pytest

from brpc_tpu.client.naming_service import \
    create_naming_service as jcreate_naming_service
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.client import Channel
from brpc_tpu_torch.client.naming_service import create_naming_service
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.server.service import Service


class FakeController:
    """Blocking-query membership endpoint (the consul shape)."""

    def __init__(self):
        self.index = 1
        self.members = []          # list of "host:port[ tag]" strings
        self._cond = threading.Condition()
        self.queries = []          # (index, wait) seen, for assertions
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def do_GET(self):
                q = parse_qs(urlparse(self.path).query)
                idx = int(q.get("index", ["0"])[0])
                wait = q.get("wait", ["1s"])[0]
                wait_s = float(wait[:-1]) if wait.endswith("s") else 1.0
                with outer._cond:
                    outer.queries.append((idx, wait_s))
                    # block until membership advances past the caller's
                    # index (a real controller caps the wait)
                    outer._cond.wait_for(
                        lambda: outer.index > idx,
                        timeout=min(wait_s, 5.0))
                    body = ("\n".join(outer.members) + "\n").encode()
                    index = outer.index
                self.send_response(200)
                self.send_header("X-Fleet-Index", str(index))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self._thr = threading.Thread(target=self.httpd.serve_forever,
                                     daemon=True)
        self._thr.start()

    def set_members(self, members):
        with self._cond:
            self.members = list(members)
            self.index += 1
            self._cond.notify_all()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def controller():
    c = FakeController()
    yield c
    c.stop()


def _wait_until(pred, timeout=10.0, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def test_watch_pushes_initial_membership(controller):
    controller.set_members(["10.0.0.1:80 a", "10.0.0.2:81 b"])
    ns = create_naming_service(
        f"watch://127.0.0.1:{controller.port}/members")
    assert ns is not None
    try:
        assert _wait_until(lambda: len(ns.current) == 2)
        tags = sorted(n.tag for n in ns.current)
        assert tags == ["a", "b"]
    finally:
        ns.stop()


def test_watch_long_poll_propagates_fast(controller):
    """The change must arrive via the BLOCKING query (sub-second), not a
    polling period."""
    controller.set_members(["10.0.0.1:80"])
    ns = create_naming_service(
        f"watch://127.0.0.1:{controller.port}/members")
    try:
        assert _wait_until(lambda: len(ns.current) == 1)
        t0 = time.time()
        controller.set_members(["10.0.0.1:80", "10.0.0.3:82"])
        assert _wait_until(lambda: len(ns.current) == 2, timeout=5.0)
        assert time.time() - t0 < 2.0, "change rode a poll, not the watch"
        # index resumption: later queries must carry an advanced index
        assert _wait_until(
            lambda: any(q[0] >= 2 for q in controller.queries))
    finally:
        ns.stop()


class Echo(Service):
    def __init__(self, name):
        self.name = name
        self.hits = 0

    def Who(self, cntl, request):
        self.hits += 1
        return self.name.encode()


def test_membership_change_mid_traffic_no_dropped_requests(controller):
    """Flip membership under live load: every request must succeed, and
    traffic must shift to the new member."""
    servers, svcs = [], []
    for name in ("A", "B", "C"):
        svc = Echo(name)
        s = Server()
        s.add_service(svc, name="E")
        assert s.start("127.0.0.1:0") == 0
        servers.append(s)
        svcs.append(svc)
    try:
        addr = lambda i: str(servers[i].listen_endpoint)  # noqa: E731
        controller.set_members([addr(0), addr(1)])

        ch = Channel()
        assert ch.init(
            f"watch://127.0.0.1:{controller.port}/members", "rr") == 0
        assert _wait_until(
            lambda: len(ch.load_balancer.servers) == 2)

        failures = []
        seen = set()
        stop = threading.Event()

        def hammer():
            from brpc_tpu_torch.client import Controller
            while not stop.is_set():
                cntl = Controller()
                cntl.timeout_ms = 5_000
                c = ch.call_method("E.Who", b"", cntl=cntl)
                if c.failed:
                    failures.append(c.error_text)
                    return
                seen.add(bytes(c.response))

        t = threading.Thread(target=hammer)
        t.start()
        try:
            assert _wait_until(lambda: {b"A", b"B"} <= seen)
            # flip: A out, C in — while the hammer runs
            controller.set_members([addr(1), addr(2)])
            assert _wait_until(lambda: b"C" in seen, timeout=10.0)
        finally:
            stop.set()
            t.join(15)
        assert not failures, failures
        # propagation settled: A no longer selected
        from brpc_tpu_torch.client import Controller
        a_hits = svcs[0].hits
        for _ in range(20):
            cntl = Controller()
            cntl.timeout_ms = 5_000
            c = ch.call_method("E.Who", b"", cntl=cntl)
            assert not c.failed, c.error_text
        assert svcs[0].hits == a_hits, "removed server still selected"
        assert svcs[2].hits > 0
    finally:
        for s in servers:
            s.stop()


def test_degrade_to_file(controller, tmp_path):
    """Controller down at startup ⇒ membership seeds from the mirrored
    backup of the last successful fetch."""
    set_flag("remote_ns_backup_dir", str(tmp_path))
    try:
        controller.set_members(["10.0.0.9:99 backup-me"])
        url = f"watch://127.0.0.1:{controller.port}/members"
        ns = create_naming_service(url)
        assert _wait_until(lambda: len(ns.current) == 1)
        ns.stop()
        controller.stop()        # registry goes dark

        ns2 = create_naming_service(url)
        try:
            assert _wait_until(lambda: len(ns2.current) == 1, timeout=15.0)
            assert ns2.current[0].tag == "backup-me"
        finally:
            ns2.stop()
    finally:
        set_flag("remote_ns_backup_dir", "")


def test_port_and_jax_watchers_agree(controller):
    """Both packages' watchers of one controller see the same members,
    through a change."""
    controller.set_members(["10.0.0.1:80 a", "10.0.0.2:81 1/2 w=3"])
    url = f"watch://127.0.0.1:{controller.port}/members"
    mine, theirs = create_naming_service(url), jcreate_naming_service(url)
    try:
        def same():
            a = [(str(n.endpoint), n.tag) for n in mine.current]
            b = [(str(n.endpoint), n.tag) for n in theirs.current]
            return a == b and len(a) == want
        want = 2
        assert _wait_until(same)
        controller.set_members(["10.0.0.3:82"])
        want = 1
        assert _wait_until(same)
    finally:
        mine.stop()
        theirs.stop()
