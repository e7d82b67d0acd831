"""The port's cross-process device lane on the CPU: the counterparts of
``tests/test_ici_xfer.py``, over the port's Server and Channel.

1. A child *port* server in another interpreter (it imports only
   ``brpc_tpu_torch``).  The domain tokens differ, so the in-process
   fabric refuses; with no transfer fabric the host-staged inline lane
   carries the tensor both ways.  The same child answers byte echoes over
   the shm data plane: the attachment crosses the process boundary in
   each side's ring.
2. The ``KIND_TRANSFER`` wire path with a stand-in of
   :class:`CudaIpcFabric` (its registry, reach and sweeps are the real
   class's; only the CUDA export and pull are replaced): both legs ride
   descriptors, acks return every descriptor's credit, the domain
   advertises ``token@address``, a JAX-style address is out of reach
   (inline), a foreign ``extra`` is refused loudly, forged acks from
   another connection are refused, and a dead connection's and an expired
   descriptor's tensors are released (the port's divergence from the JAX
   transfer fabric, which sweeps neither).
3. On a card only: the real CUDA IPC fabric between this process and a
   child on the same card (skipped here).

Every wait is an event, a condition or a bounded join.
"""

import gc
import json
import os
import socket
import subprocess
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.ici import endpoint as ep_mod
from brpc_tpu_torch.ici import fabric
from brpc_tpu_torch.ici.attachment import (KIND_INLINE, KIND_TRANSFER,
                                           encode_descriptor)
from brpc_tpu_torch.ici.endpoint import (endpoint_of, prepare_send,
                                         process_ack, split_device_attachment)
from brpc_tpu_torch.ops.device_ops import dtype_name
from brpc_tpu_torch.protocol.meta import RpcMeta
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.transport import shm_ring
from brpc_tpu_torch.transport.socket import Socket

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 10.0
ATT_1MB = bytes(range(256)) * 4096


@pytest.fixture()
def needs_shm():
    """Skip where this host can make no shm ring (decided per test, not
    at import)."""
    if not shm_ring.shm_supported():
        pytest.skip("no tmpfs/mmap shm ring here")

_CHILD = r"""
import json, sys
sys.path.insert(0, %(repo)r)
import torch
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.ici.fabric import in_process_fabric, transfer_fabric
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.transport import shm_ring
DEVICE = %(device)r
if %(transfer)r:
    assert set_flag("ici_transfer_enabled", True)

class TE(Service):
    def Echo(self, cntl, request):
        att = cntl.request_device_attachment
        if att is None:
            return b"no-tensor"
        cntl.response_device_attachment = att.tensor(DEVICE) * 2
        return json.dumps({"kind": att.kind,
                           "inline": len(cntl.request_attachment)}).encode()

    def Bytes(self, cntl, request):
        cntl.response_attachment = cntl.request_attachment
        return b"done"

    def Stats(self, cntl, request):
        f = transfer_fabric()
        return json.dumps({
            "shm": shm_ring.shm_stats(),
            "live": f.live_descriptors if f is not None else 0,
            "inproc": in_process_fabric().live_descriptors,
            "jax": "jax" in sys.modules}).encode()

srv = Server()
srv.add_service(TE(), name="TE")
assert srv.start("127.0.0.1:0") == 0
print("PORT=%%d" %% srv.listen_endpoint.port, flush=True)
sys.stdin.readline()        # the parent closes stdin to stop us
srv.stop()
"""


def _spawn_child(device="cpu", transfer=False):
    """A child port server; returns ``(proc, "127.0.0.1:port")``.  The
    port is read on a thread, so the wait is bounded; a child that does
    not come up is killed and fails the caller."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD % {"repo": REPO, "device": device,
                                         "transfer": transfer}],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    got = {}

    def read_port():
        for line in proc.stdout:
            if line.startswith("PORT="):
                got["port"] = int(line.strip().split("=")[1])
                return

    reader = threading.Thread(target=read_port, daemon=True)
    reader.start()
    reader.join(timeout=120)
    if "port" not in got:
        proc.kill()
        proc.wait(timeout=10)
        raise AssertionError(f"child server did not come up "
                             f"(rc={proc.poll()})")
    return proc, f"127.0.0.1:{got['port']}"


def _stop_child(proc):
    try:
        proc.stdin.close()
        proc.wait(timeout=10)
    except Exception:
        proc.kill()
        proc.wait(timeout=10)


@pytest.fixture(scope="module")
def child_server():
    proc, addr = _spawn_child()
    yield addr
    _stop_child(proc)


def _call(ch, method, device_att=None, attachment=b""):
    cntl = Controller()
    cntl.timeout_ms = 30_000
    cntl.request_device_attachment = device_att
    cntl.request_attachment = attachment
    c = ch.call_method(method, b"", cntl=cntl)
    assert not c.failed, (c.error_code, c.error_text)
    return c


# -- 1. a child port server --------------------------------------------------

def test_cross_process_host_staged_fallback(child_server):
    """Different processes, no transfer fabric: device attachments arrive
    inline and round-trip correctly."""
    ch = Channel()
    assert ch.init(child_server) == 0
    x = torch.arange(256, dtype=torch.float32)
    for _ in range(2):               # the first exchanges domains
        c = _call(ch, "TE.Echo", device_att=x)
        assert json.loads(c.response)["kind"] == KIND_INLINE
        att = c.response_device_attachment
        assert att is not None and att.kind == KIND_INLINE
        assert not att.device_resident
        np.testing.assert_allclose(att.numpy(), x.numpy() * 2)
    stats = json.loads(_call(ch, "TE.Stats").response)
    assert stats["jax"] is False     # the child imported only the port
    ch.close()


def test_cross_process_shm_lane(needs_shm, child_server):
    """Byte attachments between two port processes: after the handshake
    the request rides this process's ring, the child echoes it by
    reference, and every slot comes back."""
    ch = Channel()
    assert ch.init(child_server) == 0
    staged0 = shm_ring.shm_stats()["staged"]
    for i in range(4):
        c = _call(ch, "TE.Bytes", attachment=ATT_1MB)
        assert bytes(c.response_attachment) == ATT_1MB, i
        del c
    assert shm_ring.shm_stats()["staged"] - staged0 == 3
    stats = json.loads(_call(ch, "TE.Stats").response)
    assert stats["shm"]["desc_reused"] >= 3
    gc.collect()
    assert shm_ring.outstanding_tx_slots() == 0
    ch.close()


# -- 2. the KIND_TRANSFER wire path with a stand-in fabric --------------------

ADDR = fabric.ipc_address(b"standin-host", b"GPU-standin")


class StandInXfer(fabric.CudaIpcFabric):
    """:class:`CudaIpcFabric` with the CUDA halves replaced: ``post``
    registers the tensor with a blob of dummy handles, ``redeem`` hands
    back a fresh copy of the registered tensor (as the IPC pull does).
    Reach ignores the token, so peers in this process stand in for peers
    in another."""

    def __init__(self):
        super().__init__()
        self._addr = ADDR
        self.pulls = 0
        self._released = threading.Condition()

    def can_reach(self, peer_domain):
        return fabric.peer_transfer_addr(peer_domain) == self._addr

    def post(self, tensor, nbytes, on_release=None, socket_id=0,
             conn_key=None):
        t = tensor.detach().contiguous()
        blob = fabric.encode_export_blob(fabric.ExportBlob(
            self._addr, b"\x11" * 64, 0, b"\x22" * 64, dtype_name(t.dtype),
            tuple(t.shape)))
        return self._register(t, nbytes, on_release, socket_id, conn_key,
                              export=(None, blob))

    def redeem(self, blob, uuid, device=None):
        assert blob.address == self._addr
        self.pulls += 1
        with self._lock:
            entry = self._posted[uuid]
        return entry.tensor.clone().to(device or "cpu")

    def _on_release(self, entry):
        entry.export = None              # no CUDA event to destroy
        super()._on_release(entry)
        with self._released:
            self._released.notify_all()

    def wait_empty(self, timeout=WAIT_S):
        with self._released:
            return self._released.wait_for(
                lambda: self.live_descriptors == 0, timeout)


@pytest.fixture()
def standin(monkeypatch):
    fab = StandInXfer()
    fabric.set_transfer_fabric(fab)
    # force the "another process" decision: the in-process path needs a
    # loopback peer; refusing it sends prepare_send to the transfer branch
    monkeypatch.setattr(ep_mod, "_is_local_peer", lambda sock: False)
    yield fab
    fabric.set_transfer_fabric(None)


class XferEcho(Service):
    def __init__(self):
        self.kinds = []

    def Echo(self, cntl, request):
        att = cntl.request_device_attachment
        self.kinds.append((att.kind, len(cntl.request_attachment)))
        cntl.response_device_attachment = att.tensor("cpu") + 1
        return b"plus-one"


def test_transfer_descriptor_path(standin):
    svc = XferEcho()
    srv = Server()
    assert srv.add_service(svc, name="X") == 0
    assert srv.start("127.0.0.1:0") == 0
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        x = torch.arange(64, dtype=torch.float32)
        kinds = []
        for _ in range(3):               # the first exchanges domains
            c = _call(ch, "X.Echo", device_att=x)
            att = c.response_device_attachment
            kinds.append((att.kind, len(c.response_attachment)))
            out = att.tensor("cpu")
            assert torch.equal(out, x + 1) and out is not x
        # the first request rides inline (the client learns the server's
        # domain from its answer), every other leg is a descriptor with no
        # byte inline: the server knew the client's domain at once
        assert svc.kinds == [(KIND_INLINE, 0)] + [(KIND_TRANSFER, 0)] * 2
        assert kinds == [(KIND_TRANSFER, 0)] * 3
        assert standin.pulls == 5        # two requests, three responses
        # the acks return every descriptor's credit
        assert standin.wait_empty()
        assert ch._sock.ici_endpoint.outstanding_bytes == 0
        ch.close()
    finally:
        srv.stop()


def test_transfer_domain_advertised(standin):
    d = fabric.local_domain_id()
    assert d == fabric.domain_token(d) + b"@" + ADDR
    assert fabric.peer_transfer_addr(d) == ADDR
    assert fabric.parse_ipc_address(ADDR) == (b"standin-host", b"GPU-standin")
    assert fabric.peer_transfer_addr(b"plain-token") is None
    # a foreign token with an address: out of the in-process fabric's reach
    assert not fabric.in_process_fabric().can_reach(b"other-token@" + ADDR)


def test_reach_is_the_host_and_card():
    """The real fabric reaches another process on its own host and card,
    and nothing else: not itself, not another card, not a JAX PJRT
    address (which does not parse as the port's)."""
    fab = fabric.CudaIpcFabric()
    assert not fab.can_reach(b"tok@" + ADDR)             # not started
    fab._addr = ADDR
    own = fabric.domain_token(fabric.local_domain_id())
    assert fab.can_reach(b"0123456789abcdef@" + ADDR)
    assert not fab.can_reach(own + b"@" + ADDR)
    assert not fab.can_reach(b"0123456789abcdef@" + fabric.ipc_address(
        b"standin-host", b"GPU-other"))
    assert not fab.can_reach(b"0123456789abcdef@10.0.0.1:1234")
    assert fabric.parse_ipc_address(b"10.0.0.1:1234") is None


def _socket(peer_domain):
    a, b = socket.socketpair()
    sock = Socket(a, remote_side=EndPoint(host="127.0.0.1", port=1))
    sock.ici_peer_domain = peer_domain
    return sock, b


def test_jax_style_address_goes_inline(standin):
    """A peer advertising a JAX PJRT transfer address is not reachable:
    its device attachment rides inline, nothing is posted."""
    sock, other = _socket(b"0123456789abcdef@10.0.0.1:1234")
    try:
        meta = RpcMeta()
        tail = prepare_send(sock, meta, torch.ones(4))
        assert tail is not None and len(tail) == 16
        assert meta.ici_desc[0] == KIND_INLINE
        assert standin.live_descriptors == 0
        meta = RpcMeta()                       # the port's address: posted
        sock.ici_peer_domain = b"0123456789abcdef@" + ADDR
        assert prepare_send(sock, meta, torch.ones(4)) is None
        assert meta.ici_desc[0] == KIND_TRANSFER
        assert standin.live_descriptors == 1
    finally:
        sock.close()
        other.close()
    assert standin.live_descriptors == 0       # the close swept it


def test_foreign_extra_refused_loudly(standin):
    """A KIND_TRANSFER descriptor whose ``extra`` is not the port's blob
    (a JAX transfer address) raises naming it, never reaches the fabric's
    pull, and still returns the poster's credit."""
    for extra in (b"10.0.0.1:1234", b"CIPC\x09junk", b""):
        meta = RpcMeta()
        meta.ici_desc = encode_descriptor(KIND_TRANSFER, 7, 16, "float32",
                                          (4,), extra=extra)
        _, att = split_device_attachment(meta, b"", 0)
        with pytest.raises(RuntimeError, match="not a CUDA IPC export blob"):
            att.tensor("cpu")
        assert not att._redeemed
        att.settle()
        assert att._redeemed
    assert standin.pulls == 0
    # a well-formed blob whose dtype disagrees with the descriptor
    blob = fabric.encode_export_blob(fabric.ExportBlob(
        ADDR, b"\0" * 64, 0, b"\0" * 64, "int32", (4,)))
    meta = RpcMeta()
    meta.ici_desc = encode_descriptor(KIND_TRANSFER, 7, 16, "float32", (4,),
                                      extra=blob)
    _, att = split_device_attachment(meta, b"", 0)
    with pytest.raises(RuntimeError, match="export is a int32"):
        att.tensor("cpu")
    assert standin.pulls == 0


def test_forged_ack_from_other_connection_refused(standin):
    class _Sock:
        def __init__(self, sid):
            self.id = sid
    uuid = standin.post(torch.ones(4), 16, socket_id=101)
    process_ack((uuid,), _Sock(202))
    assert standin.live_descriptors == 1       # forged: refused
    process_ack((uuid,), _Sock(101))
    assert standin.live_descriptors == 0


def test_dead_connection_and_expired_descriptors_released(standin):
    """The divergence from the JAX transfer fabric: a connection that dies
    before its peer acks, or a descriptor never redeemed within the TTL,
    releases the posted tensor and its window credit."""
    sock, other = _socket(b"0123456789abcdef@" + ADDR)
    ep = endpoint_of(sock)
    uuid = ep.post(torch.arange(16, dtype=torch.float32), 64, fabric=standin)
    assert (standin.live_descriptors, ep.outstanding_bytes) == (1, 64)
    with standin._lock:
        ref = weakref.ref(standin._posted[uuid].tensor)
    gc.collect()
    assert ref() is not None                   # the registry pins it
    sock.close()
    other.close()
    gc.collect()
    assert (standin.live_descriptors, ep.outstanding_bytes) == (0, 0)
    assert ref() is None

    uuid = standin.post(torch.ones(8), 32, socket_id=0)
    with standin._lock:
        yref = weakref.ref(standin._posted[uuid].tensor)
        standin._posted[uuid].posted_at -= 1000.0
    assert standin.sweep_expired(120.0) == 1
    gc.collect()
    assert standin.live_descriptors == 0 and yref() is None


def test_transfer_fabric_flag_and_install():
    """``transfer_fabric()`` is the installed fabric whatever the flag,
    and none without CUDA when the flag is on and nothing is installed."""
    fabric.set_transfer_fabric(None)
    assert fabric.transfer_fabric() is None
    fab = StandInXfer()
    fabric.set_transfer_fabric(fab)
    try:
        assert fabric.transfer_fabric() is fab
        assert fabric.transfer_ready() == ADDR
        assert fabric.installed_transfer_fabric() is fab
    finally:
        fabric.set_transfer_fabric(None)
    assert fabric.installed_transfer_fabric() is None
    assert b"@" not in fabric.local_domain_id()


# -- 3. the real CUDA IPC fabric, on a card ----------------------------------

def test_cuda_ipc_fabric_across_processes_on_card():
    """A child on the same card with ``ici_transfer_enabled`` in both
    processes: after the domain exchange both legs are KIND_TRANSFER with
    no inline bytes, the payload comes back doubled, and both processes
    end with no live descriptor.  The payload is written by a kernel
    queued behind a spin of about 50 ms on the posting stream, so that
    the call starts while the tensor still holds -1s: the child reads the
    right bytes only if it waits on the post's event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; python3 chip_smoke.py phase 10x "
                    "runs this check and more on the card")
    assert set_flag("ici_transfer_enabled", True)
    proc, addr = _spawn_child(device="cuda", transfer=True)
    try:
        ch = Channel()
        assert ch.init(addr) == 0
        kinds = []
        base = torch.arange(1 << 18, dtype=torch.float32, device="cuda")
        for i in range(3):
            x = torch.full_like(base, -1.0)
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000_000)
            torch.mul(base, i + 1, out=x)
            c = _call(ch, "TE.Echo", device_att=x)
            att = c.response_device_attachment
            kinds.append((json.loads(c.response)["kind"], att.kind,
                          len(c.response_attachment)))
            assert torch.equal(att.tensor("cuda"), x * 2)
        assert kinds[1:] == [(KIND_TRANSFER, KIND_TRANSFER, 0)] * 2
        stats = json.loads(_call(ch, "TE.Stats").response)
        assert stats["live"] == 0 and stats["jax"] is False
        xfab = fabric.transfer_fabric()
        assert xfab is not None and xfab.live_descriptors == 0
        ch.close()
    finally:
        _stop_child(proc)
        assert set_flag("ici_transfer_enabled", False)
