"""The port's device-attachment lane on the CPU: the cases of
``tests/test_ici.py`` that apply to one device, over the port's Server
and Channel on loopback.

Descriptors and ack frames must be the JAX package's bytes; a device
echo in one process must hand back the very tensor that was sent; window
credit must come back without the TTL sweep; every failure must be a
clean error.  Waits poll with a 5 s limit; flags are restored in
``finally``.
"""

import gc
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from brpc_tpu.ici import attachment as jatt
from brpc_tpu.protocol.meta import RpcMeta as JRpcMeta
from brpc_tpu.transport.socket import encode_ack_frame
from brpc_tpu_torch.butil.flags import get_flag, set_flag
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.ici import IciEndpoint, local_domain_id
from brpc_tpu_torch.ici.attachment import (KIND_INLINE, KIND_INPROC,
                                           KIND_TRANSFER, DeviceAttachment,
                                           decode_descriptor,
                                           encode_descriptor)
from brpc_tpu_torch.ici.endpoint import (live_endpoints, prepare_send,
                                         process_ack, split_device_attachment)
from brpc_tpu_torch.ici.fabric import (InProcessFabric, domain_token,
                                       in_process_fabric, peer_transfer_addr)
from brpc_tpu_torch.protocol.meta import RpcMeta
from brpc_tpu_torch.protocol.tpu_std import (AckFrame, MAX_BODY_SIZE,
                                             pack_ack_frame, read_frame)
from brpc_tpu_torch.server import Server, Service

WAIT_S = 5.0


class TensorEcho(Service):
    def Echo(self, cntl, request):
        att = cntl.request_device_attachment
        if att is None:
            return b"no-tensor"
        cntl.response_device_attachment = att.tensor("cpu")
        return b"ok"

    def Make(self, cntl, request):
        n = int(request or b"16")
        cntl.response_device_attachment = torch.arange(n, dtype=torch.float32)
        return b"made"


@pytest.fixture()
def server():
    srv = Server()
    srv.add_service(TensorEcho(), name="TE")
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


def _channel(server):
    ch = Channel()
    assert ch.init(str(server.listen_endpoint)) == 0
    return ch


def _call(ch, method, request=b"", device_att=None, attachment=b""):
    cntl = Controller()
    cntl.timeout_ms = 10_000
    cntl.request_device_attachment = device_att
    cntl.request_attachment = attachment
    return ch.call_method(method, request, cntl=cntl)


def _wait_drained(eps):
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        if all(ep.outstanding_bytes == 0 for ep in eps):
            return True
        time.sleep(0.01)
    return False


# -- codec, frames, fabric -------------------------------------------------

@pytest.mark.parametrize("args", [
    (KIND_INPROC, 12345, 4096, "float32", (32, 32), b"xtra"),
    (KIND_INLINE, 0, 8, "int8", (), b""),
    (KIND_TRANSFER, 2**63 + 1, 2**32 - 1, "bfloat16", (1, 2, 3), b"h:1"),
])
def test_descriptor_codec_matches_jax(args):
    d = encode_descriptor(*args)
    assert d == jatt.encode_descriptor(*args)
    assert decode_descriptor(d) == args == jatt.decode_descriptor(d)


def test_ack_frame_matches_jax_and_reads_back():
    ids = list(range(1, 5000))                    # two frames: 4096 + 903
    frame = pack_ack_frame(ids)
    assert frame == encode_ack_frame(ids)
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        got = read_frame(b).ids + read_frame(b).ids
    finally:
        a.close()
        b.close()
    assert got == tuple(ids)


def test_ack_frame_is_an_ackframe():
    a, b = socket.socketpair()
    try:
        a.sendall(pack_ack_frame([7, 8]))
        msg = read_frame(b)
    finally:
        a.close()
        b.close()
    assert isinstance(msg, AckFrame) and msg.ids == (7, 8)


def test_domain_token_has_no_separator():
    dom = local_domain_id()
    assert len(dom) == 16 and b"@" not in dom
    assert domain_token(dom) == dom and peer_transfer_addr(dom) is None
    assert peer_transfer_addr(b"tok@10.0.0.1:99") == b"10.0.0.1:99"
    assert domain_token(b"tok@10.0.0.1:99") == b"tok"


def test_in_process_fabric_post_redeem_release():
    f = InProcessFabric()
    x = torch.ones(128)
    did = f.post(x, 512)
    assert f.posted_bytes == 512
    assert f.redeem(did) is x                     # zero copies
    assert f.redeem(did, device="cpu") is x
    assert f.release(did)
    assert f.posted_bytes == 0
    assert not f.release(did)                     # double release: no-op
    assert f.redeem(did) is None


def test_fabric_take_consumes():
    f = InProcessFabric()
    x = torch.zeros(4)
    did = f.post(x, 16, conn_key=b"k")
    assert f.take(did, conn_key=b"other") is None
    assert f.take(did, conn_key=b"k") is x
    assert f.take(did, conn_key=b"k") is None and f.posted_bytes == 0


def test_fabric_ttl_sweep():
    f = InProcessFabric()
    f.post(torch.zeros(4), 16)
    time.sleep(0.05)
    assert f.sweep_expired(0.01) == 1
    assert f.posted_bytes == 0 and f.live_descriptors == 0


def test_redeem_bound_to_connection_pair():
    f = InProcessFabric()
    x = torch.ones(16)
    key = (("127.0.0.1", 1111), ("127.0.0.1", 2222))
    did = f.post(x, 64, conn_key=key)
    assert f.redeem(did, conn_key=(("127.0.0.1", 1111),
                                   ("127.0.0.1", 3333))) is None
    assert f.redeem(did, conn_key=None) is None
    assert f.redeem(did, conn_key=key) is x
    f.release(did)


# -- window and acks -------------------------------------------------------

def test_window_blocks_when_full():
    old = get_flag("ici_window_bytes")
    assert set_flag("ici_window_bytes", 1024)
    f = in_process_fabric()
    try:
        ep = IciEndpoint(0)
        d1 = ep.post(torch.zeros(128), 512)
        d2 = ep.post(torch.zeros(128), 512)
        assert d1 and d2
        results = []
        t = threading.Thread(target=lambda: results.append(
            ep.post(torch.zeros(1), 512, timeout_s=WAIT_S)))
        t.start()
        time.sleep(0.1)
        assert not results                        # blocked on the window
        f.release(d1)                             # ack -> credit back
        t.join(timeout=WAIT_S)
        assert results and results[0] is not None
        f.release(d2)
        f.release(results[0])
        assert ep.outstanding_bytes == 0
    finally:
        set_flag("ici_window_bytes", old)


def test_window_full_times_out():
    old = get_flag("ici_window_bytes")
    assert set_flag("ici_window_bytes", 64)
    try:
        ep = IciEndpoint(0)
        d1 = ep.post(torch.zeros(16), 64)
        assert d1 is not None
        assert ep.post(torch.zeros(16), 64, timeout_s=0.1) is None
        in_process_fabric().release(d1)
    finally:
        set_flag("ici_window_bytes", old)


def test_oversized_payload_admitted_alone():
    old = get_flag("ici_window_bytes")
    assert set_flag("ici_window_bytes", 100)
    try:
        ep = IciEndpoint(0)
        did = ep.post(torch.zeros(1000), 4000, timeout_s=2.0)
        assert did is not None
        in_process_fabric().release(did)
    finally:
        set_flag("ici_window_bytes", old)


def test_forged_ack_from_other_connection_rejected():
    f = in_process_fabric()
    ep = IciEndpoint(777_777)
    did = ep.post(torch.zeros(8), 32)

    class FakeSock:
        def __init__(self, sid):
            self.id = sid

    process_ack((did,), FakeSock(999_999))        # wrong connection
    assert f.redeem(did) is not None
    assert ep.outstanding_bytes == 32
    process_ack((did,), FakeSock(777_777))        # the rightful owner
    assert f.redeem(did) is None
    assert ep.outstanding_bytes == 0


def test_socket_death_reclaims_posted_descriptors():
    f = in_process_fabric()
    ep = IciEndpoint(31_337_000)
    did = ep.post(torch.zeros(8), 32)
    assert f.release_socket(31_337_000) == 1
    assert ep.outstanding_bytes == 0
    assert f.redeem(did) is None


def test_dead_connection_reclaims_its_descriptors(server):
    """A client that closes with a response descriptor unredeemed: the
    server's connection teardown releases it."""
    fabric = in_process_fabric()
    ch = _channel(server)
    _call(ch, "TE.Make", b"8").response_device_attachment.tensor("cpu")
    before = fabric.live_descriptors
    att = _call(ch, "TE.Make", b"64").response_device_attachment
    assert att.device_resident
    assert fabric.live_descriptors >= 1
    ch.close()
    # the server's connection thread reclaims it when it sees the close
    deadline = time.time() + WAIT_S
    while fabric.live_descriptors > before and time.time() < deadline:
        time.sleep(0.01)
    assert fabric.live_descriptors <= before
    with pytest.raises(RuntimeError, match="expired"):
        att.tensor("cpu")


# -- over RPC --------------------------------------------------------------

def test_device_echo_zero_copy_on_second_call(server):
    ch = _channel(server)
    x0 = torch.arange(1024, dtype=torch.float32)
    c = _call(ch, "TE.Echo", device_att=x0)
    assert not c.failed, c.error_text
    # first request: no learned domain yet -> inline, still delivered
    assert torch.equal(c.response_device_attachment.tensor("cpu"), x0)
    x = torch.arange(262144, dtype=torch.float32)          # 1 MiB
    c = _call(ch, "TE.Echo", device_att=x)
    assert not c.failed, c.error_text
    att = c.response_device_attachment
    assert att.device_resident
    out = att.tensor("cpu")
    assert out is x                               # the very same tensor
    ch.close()


def test_device_response_first_call(server):
    ch = _channel(server)
    c = _call(ch, "TE.Make", b"64")
    assert not c.failed, c.error_text
    att = c.response_device_attachment
    # the server learned our domain from the request meta
    assert att.device_resident
    assert (att.dtype, att.shape, len(att)) == ("float32", (64,), 256)
    assert torch.equal(att.tensor("cpu"), torch.arange(64.0))
    assert c.response == b"made"
    ch.close()


def test_window_ack_credit_cycle(server):
    # held, so that no endpoint of an earlier connection released
    # meanwhile lends its id to a new one
    before = list(live_endpoints())
    ch = _channel(server)
    _call(ch, "TE.Make", b"8").response_device_attachment.tensor("cpu")
    c = _call(ch, "TE.Echo", device_att=torch.ones(4096))
    assert not c.failed
    c.response_device_attachment.tensor("cpu")    # redeem -> ack flows
    eps = [ep for ep in live_endpoints()
           if not any(ep is old for old in before)]
    assert len(eps) == 2                          # client's and server's
    assert _wait_drained(eps), [(ep.posted_count, ep.acked_count,
                                 ep.outstanding_bytes) for ep in eps]
    assert all(ep.acked_count for ep in eps)
    ch.close()


def test_fallback_when_fabric_unreachable(server):
    ch = _channel(server)
    _call(ch, "TE.Make", b"8").response_device_attachment.tensor("cpu")
    ch._sock.ici_peer_domain = b"\x00" * 16       # no fabric reaches it
    x = torch.arange(512, dtype=torch.float32)
    c = _call(ch, "TE.Echo", device_att=x)
    assert not c.failed, c.error_text
    out = c.response_device_attachment.tensor("cpu")
    assert torch.equal(out, x) and out is not x
    ch.close()


def test_user_attachment_coexists_with_device_attachment():
    class Both(Service):
        def M(self, cntl, request):
            assert cntl.request_attachment == b"user-bytes"
            cntl.response_attachment = b"resp-bytes"
            cntl.response_device_attachment = \
                cntl.request_device_attachment.tensor("cpu") * 2
            return b"ok"

    srv = Server()
    srv.add_service(Both(), name="B")
    assert srv.start("127.0.0.1:0") == 0
    try:
        ch = _channel(srv)
        for _ in range(2):                        # inline, then descriptor
            c = _call(ch, "B.M", device_att=torch.ones(32),
                      attachment=b"user-bytes")
            assert not c.failed, c.error_text
            assert c.response_attachment == b"resp-bytes"
            assert torch.equal(c.response_device_attachment.tensor("cpu"),
                               torch.full((32,), 2.0))
        ch.close()
    finally:
        srv.stop()


def test_expired_descriptor_raises_clean_error(server):
    ch = _channel(server)
    _call(ch, "TE.Make", b"8").response_device_attachment.tensor("cpu")
    att = _call(ch, "TE.Make", b"32").response_device_attachment
    assert att.device_resident
    in_process_fabric().release(att.desc_id)      # as the TTL sweep would
    with pytest.raises(RuntimeError, match="expired"):
        att.tensor("cpu")
    ch.close()


def test_dropped_attachment_acks_on_gc(server):
    # held, so that no endpoint of an earlier connection released
    # meanwhile lends its id to a new one
    before = list(live_endpoints())
    ch = _channel(server)
    _call(ch, "TE.Make", b"8").response_device_attachment.tensor("cpu")
    c = _call(ch, "TE.Make", b"256")
    assert c.response_device_attachment.device_resident
    eps = [ep for ep in live_endpoints()
           if not any(ep is old for old in before)]
    assert len(eps) == 1 and eps[0].outstanding_bytes == 1024   # server's
    c.response_device_attachment = None           # dropped unredeemed
    del c
    gc.collect()
    assert _wait_drained(eps)
    ch.close()


def test_ici_disabled_still_delivers(server):
    assert set_flag("ici_enabled", False)
    try:
        ch = _channel(server)
        for _ in range(2):
            x = torch.arange(128, dtype=torch.float32)
            c = _call(ch, "TE.Echo", device_att=x)
            assert not c.failed, c.error_text
            att = c.response_device_attachment
            assert att is not None and not att.device_resident
            assert torch.equal(att.tensor("cpu"), x)
        ch.close()
    finally:
        assert set_flag("ici_enabled", True)


def test_malformed_descriptor_dropped_cleanly():
    meta = RpcMeta()
    meta.ici_desc = b"\x01"                       # truncated
    out, dev = split_device_attachment(meta, b"payload", 1)
    assert dev is None and out == b"payload"
    meta.ici_desc = encode_descriptor(9, 1, 4, "float32", (1,))  # bad kind
    assert split_device_attachment(meta, b"payload", 1) == (b"payload", None)
    meta.ici_desc = encode_descriptor(KIND_INLINE, 0, 99, "float32", (1,))
    assert split_device_attachment(meta, b"short", 1) == (b"short", None)


class _SockStub:
    id = 1
    ici_peer_domain = None
    ici_conn_token = None
    remote_side = None
    local_side = None
    ici_endpoint = None


def test_attachment_past_4gib_fails_cleanly():
    huge = torch.empty(2**31, dtype=torch.float32, device="meta")   # 8 GiB
    with pytest.raises(RuntimeError, match="4GiB"):
        prepare_send(_SockStub(), RpcMeta(), huge)


def test_inline_attachment_past_frame_cap_fails_cleanly(server):
    """The inline lane refuses a payload no frame can carry before any
    staging; over RPC that is a clean EOVERCROWDED, and the connection
    keeps serving."""
    cap = torch.empty(MAX_BODY_SIZE // 4, device="meta")
    with pytest.raises(RuntimeError, match="inline"):
        prepare_send(_SockStub(), RpcMeta(), cap)
    assert set_flag("ici_enabled", False)
    try:
        ch = _channel(server)
        c = _call(ch, "TE.Echo", device_att=torch.zeros(MAX_BODY_SIZE // 4))
        assert c.failed and c.error_code == Errno.EOVERCROWDED
        assert "inline" in c.error_text
        c = _call(ch, "TE.Echo", device_att=torch.ones(4))
        assert not c.failed
        assert torch.equal(c.response_device_attachment.tensor("cpu"),
                           torch.ones(4))
        ch.close()
    finally:
        assert set_flag("ici_enabled", True)


def test_ignored_request_attachment_settles_before_response(server):
    """TE.Make never redeems the request descriptor: the server settles
    it before writing the response, so the ack is on the wire first and
    the client has its credit back the moment the call returns."""
    ch = _channel(server)
    x = torch.arange(8192, dtype=torch.float32)
    for i in range(4):
        c = _call(ch, "TE.Make", b"8", device_att=x)
        assert not c.failed, (i, c.error_text)
        assert c.response == b"made"
        c.response_device_attachment.tensor("cpu")
        ep = ch._sock.ici_endpoint
        if i > 0:                                 # descriptor calls
            assert ep is not None and ep.posted_count == i
            assert ep.outstanding_bytes == 0      # no wait needed
    ch.close()


def test_transfer_descriptor_raises_and_acks():
    """A KIND_TRANSFER descriptor of the JAX cross-process fabric (its
    ``extra`` is a PJRT transfer address, not the port's CUDA IPC export
    blob) is refused: tensor() raises naming the foreign ``extra`` and
    never opens it, and the handle still returns the poster's credit."""
    meta = RpcMeta()
    meta.ici_desc = encode_descriptor(KIND_TRANSFER, 42, 16, "float32", (4,),
                                      extra=b"10.0.0.1:1234")
    _, att = split_device_attachment(meta, b"", 0)
    assert att is not None and att.device_resident
    with pytest.raises(RuntimeError,
                       match=r"extra b'10\.0\.0\.1:1234' is not a CUDA IPC"):
        att.tensor("cpu")
    assert not att._redeemed
    att.settle()
    assert att._redeemed


def test_port_meta_carries_jax_descriptors():
    """RpcMeta tags 15-17 are the JAX encoder's bytes."""
    m, j = RpcMeta(), JRpcMeta()
    for meta in (m, j):
        meta.correlation_id = 3
        meta.ici_domain = local_domain_id()
        meta.ici_desc = encode_descriptor(KIND_INPROC, 5, 16, "float32", (4,))
        meta.ici_conn = b"\x01" * 8
    assert m.encode() == j.encode()
    back = RpcMeta.decode(j.encode())
    assert (back.ici_domain, back.ici_desc, back.ici_conn) == (
        j.ici_domain, j.ici_desc, j.ici_conn)


def test_device_attachment_handle_basics():
    att = DeviceAttachment(KIND_INLINE, 0, 8, "float32", (2,),
                           host_bytes=struct.pack("<2f", 1.5, 2.5))
    assert len(att) == 8 and not att.device_resident
    np.testing.assert_array_equal(att.numpy(), [1.5, 2.5])
    assert att.tensor("cpu").dtype == torch.float32
