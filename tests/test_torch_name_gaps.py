"""The public names of twinned modules that the port lacked until now,
ported and held to the JAX package's behavior, and the names the port is
deliberately without, each shown with what stands in its place (ROADMAP
C9):

- ported: ``EndPoint.is_unix`` (``unix:/path`` parses and prints) and
  ``flags.non_negative``;
- present through their base class: ``InProcessFabric``'s ``release``,
  ``release_socket``, ``sweep_expired`` and ``live_descriptors`` (the
  port's fabrics share one descriptor registry);
- without: ``RpcMessage.split_attachment`` (the port's cut holds the
  payload and the attachment apart already), ``SocketPool.try_take``
  (JAX's direct-read socket takes itself from its pool to flush acks;
  the port's pool flushes them on ``put``), ``Controller.obtain``/
  ``recycle`` (a call builds its own controller),
  ``ServerController.reset_slim`` (the kind-3 lane builds a controller
  per request), and the JAX ``Socket`` methods the event dispatcher's
  rewrite replaced;
- attachments: the port's ``Controller`` and ``ServerController`` hold
  them as ``bytes`` where the JAX ones hand out lazy ``IOBuf``s, so a
  handler written for brpc_tpu that appends to its response attachment
  takes the port's idiom, an assignment.
"""

import socket

import pytest

from brpc_tpu.butil import flags as jflags
from brpc_tpu.butil.endpoint import parse_endpoint as jparse_endpoint
from brpc_tpu.butil.iobuf import IOBuf as JIOBuf
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client.controller import Controller as JController
from brpc_tpu.ici.fabric import InProcessFabric as JInProcessFabric
from brpc_tpu.protocol.meta import RpcMeta as JRpcMeta
from brpc_tpu.protocol.tpu_std import RpcMessage as JRpcMessage
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import Service as JService
from brpc_tpu.server.controller import ServerController as JServerController
from brpc_tpu.transport.socket import Socket as JSocket
from brpc_tpu.transport.socket_map import SocketPool as JSocketPool
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.endpoint import EndPoint, parse_endpoint
from brpc_tpu_torch.client import Channel, ChannelOptions, Controller
from brpc_tpu_torch.ici.fabric import InProcessFabric
from brpc_tpu_torch.protocol.meta import RpcMeta
from brpc_tpu_torch.protocol.tpu_std import RpcMessage
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.server.controller import ServerController
from brpc_tpu_torch.transport.socket import Socket
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
    idiom, an assignment, carries the same bytes.  Whether the port keeps
    bytes or hands out IOBufs is the first thing the examples' port
    (ROADMAP Queue A) must decide."""
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
