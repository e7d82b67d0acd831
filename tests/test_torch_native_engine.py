"""The port's native engine (``brpc_tpu_torch/native``): its build, its
closed enums, its wire code under adversarial bytes, and the bridge's
socket and device-attachment plumbing, on the CPU.

- The engine builds with g++ from ``native/src/engine.cpp`` into
  ``native/_build/`` (a name hashed from the source, the Makefile and
  the ABI) and loads as ``brpc_tpu_torch.native._native``.
- The fallback reason mirrors (``native_bridge.FB_REASON_NAMES``,
  ``stream_slim.STREAM_FB_NAMES``) track ``kFbNames`` and
  ``kStreamFbNames`` of the port's engine.cpp member for member.
- The JAX package's adversarial wire suites for the engine's client
  calls (``tests/test_native_raw_adversarial.py``,
  ``tests/test_native_batch_adversarial.py``, built on conftest's shared
  byte layouts) run against the port's engine.
- Adversarial frames sent to a port ``Server(native=True)`` end the
  same way as on a JAX one (the same answer bytes, or the connection
  closed), and the engine serves the next connection.
- A native connection is a ``NativeSocket`` in the port's socket
  registry while it lives; a device echo on the CPU posts its
  descriptors on it and the TICI acks that come back through the
  engine's ``EV_ACK`` release them.
"""

import os
import re
import socket
import struct
import time

import pytest
import torch

import test_native_batch_adversarial as batch_adv
import test_native_raw_adversarial as raw_adv
from brpc_tpu.native import load as jload
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import ServerOptions as JServerOptions
from brpc_tpu.server.service import raw_method as jraw_method
from brpc_tpu_torch import native
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.ici.fabric import in_process_fabric
from brpc_tpu_torch.models.embedding_ps import EmbeddingPS, PSConfig
from brpc_tpu_torch.models.ps_service import PSService
from brpc_tpu_torch.server import Server, ServerOptions, raw_method
from brpc_tpu_torch.server.stream_slim import STREAM_FB_NAMES
from brpc_tpu_torch.transport.native_bridge import (FB_REASON_NAMES,
                                                    NativeSocket)
from brpc_tpu_torch.transport.socket import Socket, socket_pool
from conftest import WIRE_TAIL, wire_tlv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "brpc_tpu_torch", "native", "src", "engine.cpp")


def _port_native():
    nat = native.load()
    if nat is None:
        pytest.skip("native engine unavailable (no toolchain)")
    return nat


def test_engine_builds_into_build_dir_and_loads():
    nat = _port_native()
    assert nat.__name__ == "brpc_tpu_torch.native._native"
    path = os.path.realpath(nat.__file__)
    build = os.path.realpath(native.BUILD_DIR)
    assert os.path.dirname(path) == build
    assert path == os.path.realpath(native.library_path())
    assert re.fullmatch(r"_native-[0-9a-f]{16}\.so", os.path.basename(path))
    assert nat.Engine.__module__ == "brpc_tpu_torch.native"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "brpc_tpu_torch/native/_build/" in f.read().split()


def _cpp_names(array: str) -> tuple:
    with open(SRC) as f:
        src = f.read()
    body = re.search(r"static const char\* %s\[[A-Z_]+\] = \{(.*?)\};"
                     % array, src, re.S).group(1)
    return tuple(re.findall(r'"([a-z_]+)"', body))


@pytest.mark.parametrize("array,mirror", [
    ("kFbNames", FB_REASON_NAMES), ("kStreamFbNames", STREAM_FB_NAMES)],
    ids=["fb", "stream_fb"])
def test_fallback_reason_mirrors_track_the_engine(array, mirror):
    assert _cpp_names(array) == tuple(mirror)


_RAW_CASES = sorted(n for n in dir(raw_adv) if n.startswith("test_"))
_BATCH_CASES = sorted(n for n in dir(batch_adv) if n.startswith("test_"))


@pytest.mark.parametrize("case", _RAW_CASES)
def test_raw_call_adversarial_on_port_engine(case, monkeypatch):
    """Each scenario of the JAX raw_call suite, against the port's
    engine."""
    nat = _port_native()
    monkeypatch.setattr(raw_adv, "_native", lambda: nat)
    getattr(raw_adv, case)()


@pytest.mark.parametrize("case", _BATCH_CASES)
def test_call_batch_adversarial_on_port_engine(case, monkeypatch):
    """Each scenario of the JAX call_batch suite, against the port's
    engine."""
    nat = _port_native()
    monkeypatch.setattr(batch_adv, "_native", lambda: nat)
    getattr(batch_adv, case)()


class _Echo:
    def Echo(self, cntl, request):
        return request


class _JRawEcho:
    @jraw_method
    def Raw(self, payload, attachment):
        return bytes(payload)


class _RawEcho:
    @raw_method
    def Raw(self, payload, attachment):
        return bytes(payload)


def _frame_with(meta: bytes, body: bytes, meta_size=None,
                body_size=None) -> bytes:
    full = meta + body
    return b"TRPC" + struct.pack(
        "<II", len(full) if body_size is None else body_size,
        len(meta) if meta_size is None else meta_size) + full


_CID = wire_tlv(1, struct.pack("<Q", 9))
_ADVERSARIAL = {
    "bad-magic": b"XXXXgarbage that no protocol claims\r\n\r\n" * 4,
    "body-over-cap": b"TRPC" + struct.pack("<II", 1 << 31, 8) + b"\0" * 16,
    "meta-over-body": _frame_with(_CID + WIRE_TAIL, b"", meta_size=4096,
                                  body_size=40),
    "tlv-overruns-meta": _frame_with(
        b"\x04" + struct.pack("<I", 1 << 20) + b"S" + wire_tlv(5, b"M"),
        b"p"),
    "attachment-over-body": _frame_with(
        _CID + wire_tlv(3, struct.pack("<I", 1 << 20))
        + wire_tlv(4, b"E") + wire_tlv(5, b"Echo"), b"tiny"),
    "raw-attachment-over-body": _frame_with(
        _CID + wire_tlv(3, struct.pack("<I", 1 << 20))
        + wire_tlv(4, b"R") + wire_tlv(5, b"Raw"), b"tiny"),
    "ack-count-huge": b"TICI" + struct.pack("<I", 1 << 30) + b"\0" * 8,
    "stream-over-cap": b"TSTR" + struct.pack("<BQI", 0, 1, 1 << 31),
    "truncated-frame": _frame_with(_CID + WIRE_TAIL, b"x" * 64)[:30],
    "malformed-http": b"GET / HTTP/1.1\r\nno colon header\r\n\r\n",
}


def _outcome(ep, data: bytes) -> bytes:
    """What the server answers to ``data`` before it ends the connection
    (or before the client gives up after 1 s of silence, marked)."""
    with socket.create_connection((ep.host, ep.port), timeout=1) as c:
        c.sendall(data)
        if data.startswith(b"TRPC") and len(data) < 40:
            c.shutdown(socket.SHUT_WR)      # truncated: the peer leaves
        got = b""
        try:
            while True:
                chunk = c.recv(65536)
                if not chunk:
                    return got + b"<closed>"
                got += chunk
        except socket.timeout:
            return got + b"<open>"


@pytest.fixture(scope="module", params=[True, False],
                ids=["inline", "fiber"])
def adversarial_servers(request):
    """Port and JAX engines serving the same methods, with user code on
    the loops (the slim lanes) or on fibers (the classic lane)."""
    _port_native()
    if jload() is None:
        pytest.skip("the JAX engine is unavailable (no toolchain)")
    opts = ServerOptions()
    opts.native = True
    opts.usercode_inline = request.param
    port = Server(opts)
    assert port.add_service(_Echo(), name="E") == 0
    assert port.add_service(_RawEcho(), name="R") == 0
    jopts = JServerOptions()
    jopts.native = True
    jopts.usercode_inline = request.param
    jaxs = JServer(jopts)
    assert jaxs.add_service(_Echo(), name="E") == 0
    assert jaxs.add_service(_JRawEcho(), name="R") == 0
    for srv in (port, jaxs):
        assert srv.start("127.0.0.1:0") == 0
    yield port, jaxs
    port.stop()
    jaxs.stop()


@pytest.mark.parametrize("case", sorted(_ADVERSARIAL))
def test_adversarial_frames_end_alike_and_engine_serves_on(
        adversarial_servers, case):
    port, jaxs = adversarial_servers
    data = _ADVERSARIAL[case]
    got = _outcome(port.listen_endpoint, data)
    assert got == _outcome(jaxs.listen_endpoint, data), case
    ch = Channel()
    ch.init(str(port.listen_endpoint))
    c = ch.call_method("E.Echo", b"still serving")
    ch.close()
    assert not c.failed and bytes(c.response) == b"still serving"


def test_native_connection_is_a_socket_in_the_registry():
    _port_native()
    opts = ServerOptions()
    opts.native = opts.usercode_inline = True
    srv = Server(opts)
    assert srv.add_service(_Echo(), name="E") == 0
    assert srv.start("127.0.0.1:0") == 0
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        assert not ch.call_method("E.Echo", b"x").failed
        socks = [s for _, s in socket_pool().live_items()
                 if isinstance(s, NativeSocket)]
        assert len(socks) == 1 and Socket.address(socks[0].id) is socks[0]
        assert socks[0].conn is None
        assert socks[0].local_side == srv.listen_endpoint
        assert srv.connection_count() == 1
        ch.close()
        deadline = time.time() + 5
        while Socket.address(socks[0].id) is not None \
                and time.time() < deadline:
            time.sleep(0.01)
        assert Socket.address(socks[0].id) is None
        assert srv.connection_count() == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("inline", [True, False], ids=["inline", "fiber"])
def test_device_echo_acks_come_back_through_the_engine(inline):
    """Device echoes on the CPU: the response descriptor posts on the
    NativeSocket, the client's TICI ack arrives through ``EV_ACK`` and
    releases it (``only_socket`` ownership), and nothing stays live."""
    _port_native()
    cfg = PSConfig(vocab=64, dim=16, slots=4, hidden=32, classes=4)
    opts = ServerOptions()
    opts.native = True
    opts.usercode_inline = inline
    srv = Server(opts)
    assert srv.add_service(PSService(EmbeddingPS(cfg, device="cpu")),
                           name="PS") == 0
    assert srv.start("127.0.0.1:0") == 0
    fabric = in_process_fabric()
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        x = torch.arange(1024, dtype=torch.float32)
        resident = 0
        for _ in range(4):
            cntl = Controller()
            cntl.request_device_attachment = x
            c = ch.call_method("PS.EchoTensor", b"", cntl=cntl)
            assert not c.failed, c.error_text
            att = c.response_device_attachment
            resident += att.device_resident
            assert torch.equal(att.tensor("cpu"), x)
        assert resident >= 3        # the first call exchanges domains
        ch.close()
        deadline = time.time() + 5
        while fabric.live_descriptors and time.time() < deadline:
            time.sleep(0.01)
        assert fabric.live_descriptors == 0
    finally:
        srv.stop()
