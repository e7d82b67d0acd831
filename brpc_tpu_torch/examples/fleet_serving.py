"""Fleet-shaped serving demo: the operations stack end to end.

The port of ``examples/fleet_serving.py``.  One script plays every role
a real serving fleet has:

  1. a **fleet controller** (stdlib HTTP) exporting long-poll
     membership with index resumption — the ``watch://`` naming shape;
  2. three **serving ranks** — native-engine servers whose hot method is
     answered GIL-free by the C++ engine (``@raw_method(native="echo")``)
     while rpcz spans persist to sqlite for post-mortem browsing;
  3. a **client** on a ``watch://`` channel with round-robin balancing,
     sending pipelined batches while a membership flip happens live;
  4. an **operator**: rpc_view browsing proxy over the ranks' portals +
     a parallel_http fleet probe.

It sets the process-wide ``rpcz_dir`` flag (cleared again at the end)
and persists spans, so run it in a process of its own.

Run: ``python -m brpc_tpu_torch.examples.fleet_serving --device cpu``
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..butil.flags import set_flag
from ..client import Channel
from ..client import Controller as Cntl
from ..rpcz import browse_persisted, global_span_store
from ..server import Server, ServerOptions, Service, raw_method
from ..tools.parallel_http import parallel_fetch
from ..tools.rpc_view import ViewProxy
from . import parse_args


class Controller:
    """Blocking-query membership endpoint (the consul shape)."""

    def __init__(self):
        self.index, self.members = 1, []
        self._cond = threading.Condition()
        outer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                q = parse_qs(urlparse(self.path).query)
                idx = int(q.get("index", ["0"])[0])
                with outer._cond:
                    outer._cond.wait_for(lambda: outer.index > idx,
                                         timeout=5.0)
                    body = ("\n".join(outer.members) + "\n").encode()
                    cur = outer.index
                self.send_response(200)
                self.send_header("X-Fleet-Index", str(cur))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def set_members(self, members):
        with self._cond:
            self.members = list(members)
            self.index += 1
            self._cond.notify_all()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class Rank(Service):
    @raw_method(native="echo")          # answered inside the C++ engine
    def Infer(self, payload, attachment):
        return payload, attachment


def main(argv=None) -> int:
    parse_args(__doc__, argv)
    rpcz_dir = tempfile.mkdtemp(prefix="fleet-rpcz-")
    assert set_flag("rpcz_dir", rpcz_dir)
    ranks, ctrl, proxy = [], None, None
    ch, direct = Channel(), Channel()
    try:
        # serving ranks: native engine on the data port (framed protocols
        # only, GIL-free dispatch) + an internal operator port serving the
        # HTTP portal — the production split
        for _ in range(3):
            o = ServerOptions()
            o.native, o.usercode_inline = True, True
            o.internal_port = 0            # ephemeral operator port
            s = Server(o)
            ranks.append(s)
            s.add_service(Rank(), name="M")
            assert s.start("127.0.0.1:0") == 0
        addrs = [str(s.listen_endpoint) for s in ranks]
        ops = [str(s.internal_endpoint) for s in ranks]
        print(f"ranks: {addrs}")
        print(f"operator ports: {ops}")

        # controller announces the first two ranks
        ctrl = Controller()
        ctrl.set_members(addrs[:2])
        assert ch.init(f"watch://127.0.0.1:{ctrl.port}/members", "rr") == 0
        deadline = time.time() + 10
        while len(ch.load_balancer.servers) < 2:
            assert time.time() < deadline, "watch NS never delivered members"
            time.sleep(0.05)

        # traffic: balanced unary calls over the watch channel, plus a
        # PIPELINED batch on a direct single-rank channel (pipelining
        # rides one exclusive connection, so it is a single-server lane —
        # the balanced channel falls back to per-call RPCs for batches)
        for i in range(4):
            r, _ = ch.call_raw("M.Infer", b"req-%d" % i, timeout_ms=5_000)
            assert bytes(r) == b"req-%d" % i
        assert direct.init(addrs[0]) == 0
        out = direct.call_batch("M.Infer",
                                [b"b%03d" % i for i in range(256)],
                                timeout_ms=10_000)
        assert len(out) == 256 and bytes(out[7]) == b"b007"
        print("traffic flowing: balanced unary + 256-call pipelined batch "
              "(direct rank channel) OK")

        # live membership flip: rank 0 out, rank 2 in — no traffic stops
        ctrl.set_members(addrs[1:])
        deadline = time.time() + 5
        while time.time() < deadline:
            r, _ = ch.call_raw("M.Infer", b"during-flip", timeout_ms=5_000)
            assert bytes(r) == b"during-flip"
            if len(ch.load_balancer.servers) == 2 \
                    and str(ch.load_balancer.servers[0].endpoint) != addrs[0]:
                break
            time.sleep(0.02)
        live = [str(n.endpoint) for n in ch.load_balancer.servers]
        assert addrs[0] not in live and addrs[2] in live, live
        print(f"membership flipped under load -> {live}")

        # operator: browse a rank's portal (internal port) through the
        # rpc_view proxy
        proxy = ViewProxy()
        port = proxy.start()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/{ops[1]}/status", timeout=5) as r:
            assert r.status == 200
        print(f"rpc_view proxy: http://127.0.0.1:{port}/{ops[1]}/status OK")

        # operator: probe the whole fleet at once (demo caveat: all three
        # "ranks" share THIS process's bvar registry, so the counter is
        # the first rank's — one process per rank in a real fleet)
        res = parallel_fetch(ops, "/vars/rpc_server_m_infer_native_requests")
        for a in ops:
            body = res[a].body.decode().strip() if res[a].ok else "DOWN"
            print(f"  {a} native_requests: {body}")

        # post-mortem: natively-answered calls never enter Python (that is
        # the lane's contract) — send one TRACED call, which always routes
        # through the full dispatch and always records a span, then browse
        # the sqlite mirror that will outlive these ranks
        cntl = Cntl()
        cntl.timeout_ms = 5_000
        cntl.trace_id = 0xF1EE7
        c = ch.call_method("M.Infer", b"traced", cntl=cntl)
        assert not c.failed, c.error_text
        global_span_store().flush_now()
        spans = browse_persisted(limit=5, trace_id=0xF1EE7)
        print(f"rpcz sqlite mirror ({rpcz_dir}): traced span persisted = "
              f"{[s['method'] for s in spans]}")
        assert spans, "traced span must be browsable post-mortem"
    finally:
        if proxy is not None:
            proxy.stop()
        ch.close()
        direct.close()
        for s in ranks:
            s.stop()
        if ctrl is not None:
            ctrl.close()
        set_flag("rpcz_dir", "")
        shutil.rmtree(rpcz_dir, ignore_errors=True)
    print("fleet demo OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
