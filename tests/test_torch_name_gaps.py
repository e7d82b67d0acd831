"""The public names of twinned modules that the port lacked until now,
ported and held to the JAX package's behavior, and the names the port is
deliberately without, each shown with what stands in its place (ROADMAP
C9):

- ported: ``EndPoint.is_unix`` (``unix:/path`` parses and prints),
  ``flags.non_negative``, ``protocol.meta``'s ``LAME_DUCK_TLV`` and
  ``TAG_LAME_DUCK`` (byte-equal to JAX's and to what a draining port
  server writes) and ``transport.socket.encode_ack_frame`` (byte-equal to
  JAX's at 0 to 9000 ids, and what ``Socket.flush_acks`` writes);
- present through their base class: ``InProcessFabric``'s ``release``,
  ``release_socket``, ``sweep_expired`` and ``live_descriptors`` (the
  port's fabrics share one descriptor registry);
- without: ``RpcMessage.split_attachment`` (the port's cut holds the
  payload and the attachment apart already), ``SocketPool.try_take``
  (JAX's direct-read socket takes itself from its pool to flush acks;
  the port's pool flushes them on ``put``), ``Controller.obtain``/
  ``recycle`` (a call builds its own controller),
  ``ServerController.reset_slim`` (the kind-3 lane builds a controller
  per request), the JAX ``Socket`` methods the event dispatcher's
  rewrite replaced, ``client.controller.process_rpc_response`` (the
  reader delivers a response onto its call through
  ``channel._Waiter.deliver``) and ``ici.fabric.JaxTransferFabric``
  (``CudaIpcFabric`` has its surface, over CUDA IPC);
- attachments: the port's ``Controller`` and ``ServerController`` hold
  them as ``bytes`` where the JAX ones hand out lazy ``IOBuf``s, so a
  handler written for brpc_tpu that appends to its response attachment
  takes the port's idiom, an assignment.
"""

import struct
import threading

import numpy as np

import socket

import pytest

from brpc_tpu.butil import flags as jflags
from brpc_tpu.butil.endpoint import parse_endpoint as jparse_endpoint
from brpc_tpu.butil.iobuf import IOBuf as JIOBuf
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import controller as jcontroller
from brpc_tpu.client.controller import Controller as JController
from brpc_tpu.ici import fabric as jfabric
from brpc_tpu.ici.fabric import InProcessFabric as JInProcessFabric
from brpc_tpu.protocol import meta as jmeta
from brpc_tpu.protocol.meta import RpcMeta as JRpcMeta
from brpc_tpu.protocol.tpu_std import RpcMessage as JRpcMessage
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu.server.controller import ServerController as JServerController
from brpc_tpu.transport.socket import Socket as JSocket
from brpc_tpu.transport.socket import encode_ack_frame as jencode_ack_frame
from brpc_tpu.transport.socket_map import SocketPool as JSocketPool
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.endpoint import EndPoint, parse_endpoint
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.client import channel as tchannel
from brpc_tpu_torch.client import controller as tcontroller
from brpc_tpu_torch.ici import fabric as tfabric
from brpc_tpu_torch.ici.fabric import CudaIpcFabric, InProcessFabric
from brpc_tpu_torch.protocol import meta as tmeta
from brpc_tpu_torch.protocol.meta import RpcMeta
from brpc_tpu_torch.protocol.tpu_std import RpcMessage
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.server.controller import ServerController
from brpc_tpu_torch.transport.socket import Socket, encode_ack_frame
from brpc_tpu_torch.transport.socket_map import SocketPool, socket_pool_of


@pytest.mark.parametrize("text", ["unix:/tmp/brpc.sock", "unix:rel.sock",
                                  "127.0.0.1:8000", "[::1]:9", "host:1",
                                  "ici://pod/3"])
def test_endpoint_is_unix_as_jax(text):
    mine, theirs = parse_endpoint(text), jparse_endpoint(text)
    assert mine.is_unix == theirs.is_unix
    assert str(mine) == str(theirs)
    assert (mine.host, mine.port) == (theirs.host, theirs.port)
    assert EndPoint(host="unix:/x").is_unix


@pytest.mark.parametrize("v", [-2, -1, 0, 1, 7, 0.5, -0.5])
def test_non_negative_as_jax(v):
    assert flags.non_negative(v) == jflags.non_negative(v)


@pytest.mark.parametrize("att", [b"", b"tail-bytes"])
def test_attachment_held_apart_where_jax_splits(att):
    """JAX's ``split_attachment`` cuts the attachment off the payload; the
    port's message holds both apart from its cut, and has no such name."""
    meta = RpcMeta()
    meta.attachment_size = len(att)
    msg = RpcMessage(meta, b"body", att, 0)
    assert not hasattr(msg, "split_attachment")
    assert msg.payload == b"body" and msg.attachment == att
    jmeta = JRpcMeta()
    jmeta.attachment_size = len(att)
    buf = JIOBuf()
    buf.append(b"body" + att)
    jmsg = JRpcMessage(jmeta, buf)
    assert jmsg.split_attachment().to_bytes() == att
    assert jmsg.payload.to_bytes() == b"body"


class Echo(Service):
    def Echo(self, cntl, request):
        return request


def test_socket_pool_without_try_take():
    """JAX's ``try_take`` lets a direct-read socket take itself from its
    pool to flush acks; the port's pool has no such name, and a checked
    out connection is the caller's until ``put`` (which flushes acks)."""
    assert hasattr(JSocketPool, "try_take")
    assert not hasattr(SocketPool, "try_take")
    srv = Server()
    srv.add_service(Echo(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    opts = ChannelOptions()
    opts.connection_type = "pooled"
    ch = Channel(opts)
    ch.init(str(srv.listen_endpoint))
    try:
        assert ch.call("E.Echo", b"x", timeout_ms=5000) == b"x"
        pool = socket_pool_of(srv.listen_endpoint)
        free = pool.free_count()
        sid, rc = pool.get()
        assert rc == 0
        assert pool.free_count() == free - 1   # checked out: not idle
        pool.put(sid)
        assert pool.free_count() == free
    finally:
        ch.close()
        srv.stop()


def test_in_process_fabric_registry_names():
    fab = InProcessFabric()
    jfab = JInProcessFabric()
    for name in ("release", "release_socket", "sweep_expired",
                 "live_descriptors", "post", "redeem"):
        assert hasattr(fab, name) and hasattr(jfab, name), name
    a = fab.post(object(), 4, socket_id=7)
    fab.post(object(), 4, socket_id=8)
    assert fab.live_descriptors == 2
    assert fab.release_socket(7) == 1 and fab.live_descriptors == 1
    assert not fab.release(a)
    assert fab.sweep_expired(0.0) == 1 and fab.live_descriptors == 0


def test_controllers_are_built_per_call():
    """The JAX client recycles controllers through a free list
    (``Controller.obtain``/``recycle``); the port builds one per call and
    keeps no list, and its server's kind-3 lane builds a controller per
    request where JAX resets a pooled one (``reset_slim``)."""
    assert hasattr(JController, "obtain") and hasattr(JController, "recycle")
    assert not hasattr(Controller, "obtain")
    assert not hasattr(Controller, "recycle")
    assert hasattr(JServerController, "reset_slim")
    assert not hasattr(ServerController, "reset_slim")
    assert Controller() is not Controller()


# the JAX Socket's methods the port's dispatcher rewrite replaced, each
# with what stands in its place
_SOCKET_NAMES = {
    "create": "__init__",           # a connected socket is wrapped at once
    "connect_if_not": "__init__",   # socket_map dials before wrapping
    "revive": "reconnect_now",      # revival in place
    "reset_connection": "reconnect_now",
    "add_inflight": "add_waiter",   # calls wait by correlation id
    "remove_inflight": "pop_waiter",
    "write_parts": "write",         # write takes the frame's parts
    "flush_pending_acks": "flush_acks",
    "ensure_client_lane": "ensure_dispatched",
}


@pytest.mark.parametrize("name", sorted(_SOCKET_NAMES))
def test_socket_names_replaced(name):
    assert hasattr(JSocket, name)
    assert not hasattr(Socket, name)
    assert hasattr(Socket, _SOCKET_NAMES[name])


def test_socket_state_is_plain_attributes():
    """``failed``, ``read_portal`` and ``last_protocol`` are attributes of
    the port's Socket (JAX properties); a failure's code and text go to
    the calls waiting on it, not to ``error``/``error_text``."""
    a, b = socket.socketpair()
    try:
        s = Socket(a, remote_side=EndPoint(host="127.0.0.1", port=1))
        assert s.failed is False
        assert s.read_portal is None and s.last_protocol is None
        assert not hasattr(s, "error_text")
        s.close()
        assert s.failed is True
    finally:
        b.close()


# the attachment types each server's controller handed its handler
_SEEN = {}


class _AttachmentStyles(Service):
    """The JAX idiom (``examples/echo.py``: append the request's
    attachment to the response's) beside the port's (assign it)."""

    def JaxStyle(self, cntl, request):
        _SEEN["port"] = (type(cntl.request_attachment),
                         type(cntl.response_attachment))
        cntl.response_attachment.append_iobuf(cntl.request_attachment)
        return request

    def PortStyle(self, cntl, request):
        cntl.response_attachment = bytes(cntl.request_attachment)
        return request


class _JaxAttachmentStyle(JService):
    def JaxStyle(self, cntl, request):
        _SEEN["jax"] = (type(cntl.request_attachment),
                        type(cntl.response_attachment))
        cntl.response_attachment.append_iobuf(cntl.request_attachment)
        return request


def _att_call(ch, method, cntl, att=b"att-bytes"):
    cntl.timeout_ms = 10_000
    cntl.request_attachment = att
    ch.call_method(method, b"req", cntl=cntl)
    return cntl


def test_attachments_are_bytes_where_jax_hands_out_iobufs():
    """The port's controllers hold their attachments as ``bytes``; the
    JAX ones hand out lazy ``IOBuf``s.  A handler written for brpc_tpu
    that calls ``append_iobuf`` on its response attachment fails on the
    port's server (the call answers the AttributeError), and the port's
    idiom, an assignment, carries the same bytes.  The port keeps bytes:
    every lane of it is built on them (the engine's messages, the fast
    lane and the channel copy into ``bytes``), so its examples
    (``brpc_tpu_torch/examples/echo.py``) assign the attachment."""
    assert isinstance(Controller().response_attachment, bytes)
    assert isinstance(JController().response_attachment, JIOBuf)
    srv, jsrv = Server(), JServer()
    srv.add_service(_AttachmentStyles(), name="A")
    jsrv.add_service(_JaxAttachmentStyle(), name="A")
    assert srv.start("127.0.0.1:0") == 0 and jsrv.start("127.0.0.1:0") == 0
    ch, jch = Channel(), JChannel()
    try:
        assert ch.init(str(srv.listen_endpoint)) == 0
        c = _att_call(ch, "A.JaxStyle", Controller())
        assert c.failed and "append_iobuf" in c.error_text
        c = _att_call(ch, "A.PortStyle", Controller())
        assert not c.failed and c.response == b"req"
        assert c.response_attachment == b"att-bytes"
        # the JAX handler as it is, on the JAX server: the same bytes
        # back to the port's client and to the JAX client
        jep = str(jsrv.listen_endpoint)
        ch2 = Channel()
        assert ch2.init(jep) == 0 and jch.init(jep) == 0
        c = _att_call(ch2, "A.JaxStyle", Controller())
        assert not c.failed and c.response_attachment == b"att-bytes"
        ch2.close()
        c = _att_call(jch, "A.JaxStyle", JController(), JIOBuf(b"att-bytes"))
        assert not c.failed
        assert isinstance(c.response_attachment, JIOBuf)
        assert bytes(c.response_attachment) == b"att-bytes"
        assert _SEEN["port"] == (bytes, bytes)
        assert _SEEN["jax"] == (JIOBuf, JIOBuf)
    finally:
        ch.close()
        srv.stop()
        jsrv.stop()


def test_lame_duck_tlv_as_jax():
    """``LAME_DUCK_TLV`` and ``TAG_LAME_DUCK`` equal JAX's, the meta
    encoder writes that TLV, and a draining port server's answer carries
    it: the response meta's bytes end with it and re-encode byte for byte
    through the JAX package's RpcMeta."""
    assert tmeta.LAME_DUCK_TLV == jmeta.LAME_DUCK_TLV \
        == b"\x17\x01\x00\x00\x00\x01"
    assert tmeta.TAG_LAME_DUCK == jmeta.TAG_LAME_DUCK == 23
    meta, jm = RpcMeta(), JRpcMeta()
    for m in (meta, jm):
        m.correlation_id, m.error_code, m.lame_duck = 9, 2004, 1
    assert meta.encode() == jm.encode()
    assert meta.encode().endswith(tmeta.LAME_DUCK_TLV)

    srv = Server()
    srv.add_service(Echo(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    probe = socket.create_connection(
        (str(srv.listen_endpoint.host), srv.listen_endpoint.port), timeout=10)

    def answer_meta(cid: int) -> bytes:
        """Send one Echo request on the probe; its answer's meta bytes."""
        mb = (tmeta.TLV_CORRELATION + struct.pack("<Q", cid)
              + tmeta.encode_tlv(4, b"E") + tmeta.encode_tlv(5, b"Echo"))
        body = mb + b"probe"
        probe.sendall(b"TRPC" + struct.pack("<II", len(body), len(mb))
                      + body)
        buf = b""
        while len(buf) < 12 or len(buf) < 12 + struct.unpack_from(
                "<I", buf, 4)[0]:
            chunk = probe.recv(65536)
            assert chunk, "connection closed"
            buf += chunk
        return buf[12:12 + struct.unpack_from("<I", buf, 8)[0]]

    try:
        # answered before the drain, so the connection is the server's
        assert not answer_meta(50).endswith(tmeta.LAME_DUCK_TLV)
        assert srv.drain(0) == 0
        meta_bytes = answer_meta(51)
        assert meta_bytes.endswith(tmeta.LAME_DUCK_TLV)
        decoded = JRpcMeta.decode(meta_bytes)
        assert decoded.lame_duck == 1 and decoded.correlation_id == 51
        assert decoded.encode() == meta_bytes
    finally:
        probe.close()
        srv.stop()


_ACK_RNG = np.random.default_rng(22)


@pytest.mark.parametrize("n", [0, 1, 4096, 4097, 9000])
def test_encode_ack_frame_as_jax(n):
    """``encode_ack_frame`` writes JAX's bytes (a frame per 4096 ids,
    back to back), and ``Socket.flush_acks`` writes exactly them."""
    ids = [int(i) * 2 + 1        # odd u64s up to 2**64 - 1
           for i in _ACK_RNG.integers(0, 2 ** 63, n, dtype=np.int64)]
    want = jencode_ack_frame(ids)
    assert encode_ack_frame(ids) == want
    assert want.count(b"TICI") >= -(-n // 4096)
    a, b = socket.socketpair()
    try:
        s = Socket(a, remote_side=EndPoint(host="127.0.0.1", port=1))
        s.defer_acks = True
        s.queue_ack(ids)
        s.flush_acks()
        b.settimeout(10)
        got = b""
        while len(got) < len(want):
            chunk = b.recv(1 << 20)
            assert chunk
            got += chunk
        assert got == want
        s.close()
    finally:
        b.close()


def test_process_rpc_response_is_the_waiters_deliver(monkeypatch):
    """JAX's client messenger hands a response to
    ``process_rpc_response``; the port has no such name: the reader of a
    connection delivers the frame onto its call through the waiting
    attempt's ``channel._Waiter.deliver``."""
    assert callable(jcontroller.process_rpc_response)
    assert not hasattr(tcontroller, "process_rpc_response")
    assert not hasattr(tchannel, "process_rpc_response")
    delivered = []
    deliver = tchannel._Waiter.deliver

    def counted(self, msg, sock):
        delivered.append(threading.current_thread().name)
        return deliver(self, msg, sock)

    monkeypatch.setattr(tchannel._Waiter, "deliver", counted)
    srv = Server()
    srv.add_service(Echo(), name="E")
    assert srv.start("127.0.0.1:0") == 0
    opts = ChannelOptions()
    opts.connection_type = "single"
    ch = Channel(opts)
    try:
        assert ch.init(str(srv.listen_endpoint)) == 0
        assert ch.call("E.Echo", b"x", timeout_ms=5000) == b"x"
        assert len(delivered) == 1
        assert delivered[0] != threading.current_thread().name
    finally:
        ch.close()
        srv.stop()


def test_jax_transfer_fabric_stands_as_cuda_ipc_fabric():
    """JAX's ``JaxTransferFabric`` (PJRT's transfer server) has no
    namesake in the port: ``CudaIpcFabric`` carries its surface over
    CUDA IPC, and where CUDA is absent it says so: not supported, no
    address, and ``start`` raises."""
    assert hasattr(jfabric, "JaxTransferFabric")
    assert not hasattr(tfabric, "JaxTransferFabric")
    for name in ("supported", "start", "address", "post", "redeem",
                 "release", "live_descriptors"):
        assert hasattr(jfabric.JaxTransferFabric, name), name
        assert hasattr(CudaIpcFabric, name), name
    fab = CudaIpcFabric()
    assert fab.live_descriptors == 0
    if CudaIpcFabric.supported():
        pytest.skip("CUDA is available: the fabric starts")
    assert fab.address == b""
    with pytest.raises(RuntimeError, match="CUDA"):
        fab.start()
