"""RESP, thrift and memcache held against the JAX package
(``tests/test_ecosystem.py:22-298``): the RESP codec byte for byte and
its partial decodes; redis on the port's one port from the port's and
the JAX redis clients, a pipeline, redis beside tpu_std on one
connection's port; the memcache clients of both packages against the
test's mini memcached; thrift both ways (the port's client against the
JAX server, the JAX client against the port's server), an unknown method
and a raising one; the thrift wire constants."""

import socketserver
import threading

import pytest

from brpc_tpu.client.memcache_client import MemcacheClient as JMemcacheClient
from brpc_tpu.client.redis_client import RedisClient as JRedisClient
from brpc_tpu.protocol import resp as jresp
from brpc_tpu.protocol import thrift_proto as jthrift
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch.client import Channel
from brpc_tpu_torch.client.memcache_client import MemcacheClient
from brpc_tpu_torch.client.redis_client import RedisClient
from brpc_tpu_torch.protocol import resp as tresp
from brpc_tpu_torch.protocol import thrift_proto as tthrift
from brpc_tpu_torch.server import Server, Service


# -- the RESP codec ----------------------------------------------------------

_REPLIES = ["OK", 42, -7, True, False, b"hi", b"", None, [b"a", 1],
            [], [[b"x"], None, "s"], tresp.RedisError("boom"),
            tresp.RedisError("WRONGTYPE no"), tresp.RedisError("a\r\nb")]


@pytest.mark.parametrize("i", range(len(_REPLIES)))
def test_resp_replies_encode_as_jax(i):
    mine = _REPLIES[i]
    theirs = jresp.RedisError(str(mine)) \
        if isinstance(mine, tresp.RedisError) else mine
    assert tresp.encode_reply(mine) == jresp.encode_reply(theirs)


@pytest.mark.parametrize("args", [("GET", "k"), ("SET", "k", b"\x00v"),
                                  ("DEL",), ("INCRBY", "n", 5)])
def test_resp_commands_encode_as_jax(args):
    assert tresp.encode_command(*args) == jresp.encode_command(*args)


@pytest.mark.parametrize("data", [b"+PONG\r\n", b"$3\r\nabc\r\n",
                                  b"*2\r\n:1\r\n:2\r\n", b"$-1\r\n",
                                  b"-ERR x\r\n", b"$10\r\nabc",
                                  b"*2\r\n:1\r\n", b"+PO", b"",
                                  b"*1\r\n$-1\r\n"])
def test_resp_decodes_and_partials_as_jax(data):
    mine, mpos = tresp.decode_one(data)
    theirs, jpos = jresp.decode_one(data)
    assert mpos == jpos
    if isinstance(theirs, jresp.RedisError):
        assert isinstance(mine, tresp.RedisError) and str(mine) == str(theirs)
    elif theirs is jresp.NIL:
        assert mine is tresp.NIL
    else:
        assert mine == theirs


# -- redis on the one port ---------------------------------------------------

class MiniRedis:
    """In-memory command handler registered as the "redis" service."""

    def __init__(self):
        self.store = {}
        self.lock = threading.Lock()

    def on_command(self, args):
        cmd = args[0].upper()
        with self.lock:
            if cmd == b"PING":
                return "PONG"
            if cmd == b"SET":
                self.store[args[1]] = args[2]
                return "OK"
            if cmd == b"GET":
                return self.store.get(args[1])
            if cmd == b"DEL":
                return sum(self.store.pop(k, None) is not None
                           for k in args[1:])
            if cmd == b"INCR":
                v = int(self.store.get(args[1], b"0")) + 1
                self.store[args[1]] = str(v).encode()
                return v
            raise tresp.RedisError(f"unknown command {cmd.decode()}")


class Echo(Service):
    def Echo(self, cntl, request):
        return bytes(request)


@pytest.fixture(scope="module")
def redis_server():
    srv = Server()
    assert srv.add_service(MiniRedis(), name="redis") == 0
    assert srv.add_service(Echo(), name="E") == 0
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


_CLIENTS = {"port": (RedisClient, tresp.RedisError),
            "jax": (JRedisClient, jresp.RedisError)}


@pytest.mark.parametrize("client", ["port", "jax"])
def test_redis_client_against_the_ports_one_port(redis_server, client):
    cls, err = _CLIENTS[client]
    r = cls(str(redis_server.listen_endpoint))
    try:
        assert r.ping() == "PONG"
        assert r.set(f"k-{client}", b"v1") == "OK"
        assert r.get(f"k-{client}") == b"v1"
        assert r.get("missing") is None
        assert r.incr(f"ctr-{client}") == 1
        assert r.incr(f"ctr-{client}") == 2
        assert r.delete(f"k-{client}") == 1
        with pytest.raises(err):
            r.command("NOPE")
    finally:
        r.close()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_redis_pipeline(redis_server, client):
    r = _CLIENTS[client][0](str(redis_server.listen_endpoint))
    try:
        replies = r.pipeline([("SET", f"p{client}%d" % i, "x%d" % i)
                              for i in range(10)]
                             + [("GET", f"p{client}7")])
        assert replies[:10] == ["OK"] * 10
        assert replies[10] == b"x7"
    finally:
        r.close()


def test_redis_and_rpc_share_the_port(redis_server):
    """RESP and tpu_std on one port, detected message by message."""
    ch = Channel()
    ch.init(str(redis_server.listen_endpoint))
    assert ch.call("E.Echo", b"rpc-here") == b"rpc-here"
    r = RedisClient(str(redis_server.listen_endpoint))
    try:
        assert r.ping() == "PONG"
        assert ch.call("E.Echo", b"again") == b"again"
    finally:
        r.close()
        ch.close()


def test_redis_without_a_service_closes_the_connection():
    """No "redis" service: RESP is claimed by no handler and the server
    closes the connection at once, in both packages; the port's redis
    client raises (the JAX client would hang in its own ``close``)."""
    import socket

    from brpc_tpu.server import Service as JService

    class JEcho(JService):
        def Echo(self, cntl, request):
            return request

    for srv, svc in ((Server(), Echo()), (JServer(), JEcho())):
        assert srv.add_service(svc, name="E") == 0
        assert srv.start("127.0.0.1:0") == 0
        ep = srv.listen_endpoint
        try:
            with socket.create_connection((ep.host, ep.port),
                                          timeout=5) as c:
                c.sendall(tresp.encode_command("PING"))
                assert c.recv(100) == b""
            if isinstance(srv, Server):
                r = RedisClient(str(ep))
                with pytest.raises(ConnectionError):
                    r.ping()
                r.close()
        finally:
            srv.stop()


# -- the memcache clients ----------------------------------------------------

class _MiniMemcached(socketserver.ThreadingTCPServer):
    """A tiny text-protocol memcached for the clients."""
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self):
        self.store = {}
        self.cas_counter = [0]
        super().__init__(("127.0.0.1", 0), _McHandler)


class _McHandler(socketserver.StreamRequestHandler):
    def handle(self):
        srv = self.server
        while True:
            line = self.rfile.readline()
            if not line:
                return
            parts = line.strip().split()
            if not parts:
                continue
            verb = parts[0]
            if verb in (b"set", b"add", b"replace", b"cas"):
                key, flags, n = parts[1].decode(), int(parts[2]), int(parts[4])
                data = self.rfile.read(n + 2)[:n]
                exists = key in srv.store
                if (verb == b"add" and exists) or \
                        (verb == b"replace" and not exists):
                    self.wfile.write(b"NOT_STORED\r\n")
                    continue
                if verb == b"cas":
                    cur = srv.store.get(key)
                    if cur is None:
                        self.wfile.write(b"NOT_FOUND\r\n")
                        continue
                    if cur[2] != int(parts[5]):
                        self.wfile.write(b"EXISTS\r\n")
                        continue
                srv.cas_counter[0] += 1
                srv.store[key] = (data, flags, srv.cas_counter[0])
                self.wfile.write(b"STORED\r\n")
            elif verb in (b"gets", b"get"):
                for k in parts[1:]:
                    ent = srv.store.get(k.decode())
                    if ent is not None:
                        data, flags, cas = ent
                        self.wfile.write(b"VALUE %s %d %d %d\r\n%s\r\n"
                                         % (k, flags, len(data), cas, data))
                self.wfile.write(b"END\r\n")
            elif verb == b"delete":
                ok = srv.store.pop(parts[1].decode(), None)
                self.wfile.write(b"DELETED\r\n" if ok else b"NOT_FOUND\r\n")
            elif verb in (b"incr", b"decr"):
                k = parts[1].decode()
                ent = srv.store.get(k)
                if ent is None:
                    self.wfile.write(b"NOT_FOUND\r\n")
                    continue
                v = int(ent[0]) + (int(parts[2]) if verb == b"incr"
                                   else -int(parts[2]))
                srv.store[k] = (str(v).encode(), ent[1], ent[2])
                self.wfile.write(b"%d\r\n" % v)
            elif verb == b"version":
                self.wfile.write(b"VERSION mini-1.0\r\n")
            else:
                self.wfile.write(b"ERROR\r\n")


@pytest.fixture(scope="module")
def memcached():
    srv = _MiniMemcached()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _memcache_session(mc, p: str) -> list:
    """Every verb once; the answers in order."""
    out = [mc.version().startswith("VERSION"), mc.set(p + "a", b"hello", 7)]
    value, flags, cas = mc.gets(p + "a")
    out += [value, flags, cas is not None, mc.get(p + "missing"),
            mc.add(p + "a", b"nope"), mc.replace(p + "a", b"world"),
            mc.get(p + "a"), mc.set(p + "n", b"10"), mc.incr(p + "n", 5),
            mc.decr(p + "n", 3), mc.incr(p + "missing"),
            mc.delete(p + "a"), mc.delete(p + "a")]
    mc.set(p + "c", b"1")
    _, _, cas = mc.gets(p + "c")
    out += [mc.cas(p + "c", b"2", cas), mc.cas(p + "c", b"3", cas)]
    return out


def test_memcache_clients_answer_as_jax(memcached):
    mine = MemcacheClient(memcached)
    theirs = JMemcacheClient(memcached)
    try:
        got = _memcache_session(mine, "port-")
        assert got == _memcache_session(theirs, "jax-")
        assert got == [True, True, b"hello", 7, True, None, False, True,
                       b"world", True, 15, 12, None, True, False, True,
                       False]
    finally:
        mine.close()
        theirs.close()


# -- thrift ------------------------------------------------------------------

class _Calc:
    """Thrift service: ``handle(method, body) -> body``."""

    def __init__(self, tbinary):
        self._tb = tbinary

    def handle(self, method, body):
        if method == "echo":
            return body
        if method == "greet":
            name, _ = self._tb.read_string(body, 0)
            return self._tb.write_string(b"hello " + name)
        if method == "boom":
            raise RuntimeError("kaboom")
        raise KeyError(method)


@pytest.fixture(scope="module")
def thrift_servers():
    port, jax_ = Server(), JServer()
    assert port.add_service(_Calc(tthrift.TBinary), name="thrift") == 0
    assert jax_.add_service(_Calc(jthrift.TBinary), name="thrift") == 0
    assert port.start("127.0.0.1:0") == 0
    assert jax_.start("127.0.0.1:0") == 0
    yield {"port": port, "jax": jax_}
    port.stop()
    jax_.stop()


_PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def _thrift_client(client, server):
    cls = tthrift.ThriftClient if client == "port" else jthrift.ThriftClient
    return cls(str(server.listen_endpoint))


@pytest.mark.parametrize("client,server", _PAIRS,
                         ids=[f"{c}-to-{s}" for c, s in _PAIRS])
def test_thrift_call_roundtrip(thrift_servers, client, server):
    tc = _thrift_client(client, thrift_servers[server])
    tb = tthrift.TBinary
    try:
        assert tc.call("echo", b"\x0b\x00\x01payload\x00") \
            == b"\x0b\x00\x01payload\x00"
        out = tc.call("greet", tb.write_string(b"tpu"))
        assert tb.read_string(out, 0)[0] == b"hello tpu"
    finally:
        tc.close()


@pytest.mark.parametrize("client,server", _PAIRS,
                         ids=[f"{c}-to-{s}" for c, s in _PAIRS])
def test_thrift_unknown_method_and_exception(thrift_servers, client, server):
    tc = _thrift_client(client, thrift_servers[server])
    err = tthrift.ThriftApplicationError if client == "port" \
        else jthrift.ThriftApplicationError
    try:
        with pytest.raises(err) as ei:
            tc.call("nope")
        assert ei.value.code == 1                    # UNKNOWN_METHOD
        with pytest.raises(err) as ei:
            tc.call("boom")
        assert ei.value.code == 6                    # INTERNAL_ERROR
        assert "kaboom" in ei.value.message
        # the connection still serves after the exceptions
        assert tc.call("echo", b"\x00") == b"\x00"
    finally:
        tc.close()


def test_thrift_wire_format_constants():
    frame = tthrift.pack_message(tthrift.M_CALL, "m", 7, b"\x00")
    assert frame == jthrift.pack_message(jthrift.M_CALL, "m", 7, b"\x00")
    # [len][0x80 01 00 01][i32 len "m"]["m"][i32 7][body]
    assert frame[4:8] == b"\x80\x01\x00\x01"
    assert frame[8:12] == b"\x00\x00\x00\x01"
    assert frame[12:13] == b"m"
    assert tthrift.unpack_message(frame[4:]) == (tthrift.M_CALL, "m", 7,
                                                 b"\x00")
    for name in ("VERSION_1", "M_CALL", "M_REPLY", "M_EXCEPTION",
                 "M_ONEWAY", "EX_UNKNOWN_METHOD", "EX_INTERNAL_ERROR"):
        assert getattr(tthrift, name) == getattr(jthrift, name)
    assert tthrift.TBinary.app_exception(6, "x") \
        == jthrift.TBinary.app_exception(6, "x")
