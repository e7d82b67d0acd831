"""The port's shm data plane (``brpc_tpu_torch/transport/shm_ring.py``) on
the CPU: the counterparts of the Python-lane cases of
``tests/test_data_plane.py``, over the port's Server and Channel on
loopback, and the lane between the port and the JAX package.

- the lane engages after the handshake, echoes re-describe the request's
  slot, and responses are staged in the server's ring once the client
  has mapped it; a response view holds its slot until it is dropped;
- every ineligible shape rides the byte lane under one named reason
  (under threshold, over slot, ring exhausted, peer without the
  capability, flag off, a retry attempt), byte-identically on the wire;
- the offer is sent again after it was lost, the free is
  generation-checked, a serialize failure strands no slot, an
  unresolvable descriptor fails loudly on both sides, and 1000 calls
  leave every slot free;
- port client <-> JAX server and JAX client <-> port server ride each
  other's rings bit-exact, both ways;
- a ring that does not fit its directory is declined there
  (``posix_fallocate``): it lands in the next one, or nowhere, and then
  the lane counts ``shm_unavailable``.
"""

import errno
import gc
import os
import socket
import struct
import threading

import pytest

from brpc_tpu.butil.flags import get_flag as jget_flag
from brpc_tpu.butil.flags import set_flag as jset_flag
from brpc_tpu.butil.iobuf import IOBuf
from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import ChannelOptions as JChannelOptions
from brpc_tpu.client import Controller as JController
from brpc_tpu.server import Server as JServer
from brpc_tpu.server import ServerOptions as JServerOptions
from brpc_tpu.server import Service as JService
from brpc_tpu.transport import shm_ring as jshm
from brpc_tpu_torch.butil.flags import get_flag, set_flag
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.protocol.meta import (TAG_SHM_DESC, RpcMeta, encode_tlv)
from brpc_tpu_torch.protocol.tpu_std import pack_frame, read_frame
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.transport import shm_ring

_FLAGS = ("rpc_shm_data_plane", "rpc_shm_threshold", "rpc_shm_slot_bytes",
          "rpc_shm_slots")

ATT_1MB = bytes(range(256)) * 4096          # patterned, not zeros
ATT_300K = (b"\x5a" + bytes(range(255))) * 1200


@pytest.fixture()
def needs_shm():
    """Skip where this host can make no shm ring (decided per test, not
    at import)."""
    if not shm_ring.shm_supported():
        pytest.skip("no tmpfs/mmap shm ring here")


@pytest.fixture(autouse=True)
def _shm_env():
    saved = {k: get_flag(k) for k in _FLAGS}
    jsaved = {k: jget_flag(k) for k in _FLAGS}
    shm_ring._reset_for_tests()
    jshm._reset_for_tests()
    yield
    for k, v in saved.items():
        assert set_flag(k, v)
    for k, v in jsaved.items():
        jset_flag(k, v)
    shm_ring._reset_for_tests()
    jshm._reset_for_tests()


class DataSvc(Service):
    def Echo(self, cntl, request):
        # the response attachment IS the request's view: echo by reference
        cntl.response_attachment = cntl.request_attachment
        return b"done"

    def Gen(self, cntl, request):
        # a fresh attachment: staged into the server's own ring
        cntl.response_attachment = ATT_300K
        return b"gen"

    def Bad(self, cntl, request):
        # an eligible attachment and a response that cannot serialize
        cntl.response_attachment = ATT_300K
        return 12345


@pytest.fixture()
def server():
    srv = Server()
    assert srv.add_service(DataSvc(), name="D") == 0
    assert srv.start("127.0.0.1:0") == 0
    yield srv
    srv.stop()


def _channel(srv):
    ch = Channel()
    assert ch.init(str(srv.listen_endpoint)) == 0
    return ch


def _call(ch, method, att=b""):
    cntl = Controller()
    cntl.timeout_ms = 10_000
    cntl.request_attachment = att
    return ch.call_method(method, b"x", cntl=cntl)


def _echo(ch, att):
    c = _call(ch, "D.Echo", att)
    assert not c.failed, (c.error_code, c.error_text)
    return bytes(c.response_attachment)


def _fb(reason):
    return shm_ring.shm_fallback_counters()[reason]


def _nonzero_fallbacks():
    return {k: v for k, v in shm_ring.shm_fallback_counters().items() if v}


# -- the lane ----------------------------------------------------------------

def test_shm_lane_engages_after_handshake(needs_shm, server):
    ch = _channel(server)
    for i in range(4):
        assert _echo(ch, ATT_1MB) == ATT_1MB, f"call {i}"
    st = shm_ring.shm_stats()
    # call 1 = handshake (bytes); calls 2-4 stage and echo by reference
    assert st["staged"] == 3
    assert st["desc_reused"] == 3
    assert st["resolved"] >= 6             # server and client resolves
    assert set(_nonzero_fallbacks()) <= {"shm_handshake", "shm_peer_no_cap"}
    ch.close()


def test_shm_controller_lane_and_response_staging(needs_shm, server):
    ch = _channel(server)
    for _ in range(3):
        assert _echo(ch, ATT_1MB) == ATT_1MB
    assert shm_ring.shm_stats()["desc_reused"] >= 2
    # a fresh response attachment: staged in the server's ring once the
    # client has acked the mapping
    for _ in range(3):
        r = _call(ch, "D.Gen")
        assert not r.failed, (r.error_code, r.error_text)
        assert isinstance(r.response_attachment, memoryview)
        assert r.response_attachment == ATT_300K
    assert shm_ring.shm_stats()["staged"] >= 4
    # a response's slot recycles when its view is dropped, not when the
    # next request goes out on the connection
    ring = shm_ring.process_tx_ring()
    assert ring.nslots - ring.free_count() >= 1
    r2 = _call(ch, "D.Echo")
    assert not r2.failed
    assert ring.nslots - ring.free_count() >= 1     # still held
    del r, r2
    gc.collect()
    _call(ch, "D.Echo")               # carries the owed releases back
    assert ring.free_count() == ring.nslots
    ch.close()


# -- named fallbacks ---------------------------------------------------------

def test_fallback_under_threshold(needs_shm, server):
    ch = _channel(server)
    small = b"s" * 1024
    before = _fb("shm_under_threshold")
    r0 = shm_ring.shm_stats()["resolved"]
    assert _echo(ch, small) == small
    assert _fb("shm_under_threshold") == before + 1
    assert shm_ring.shm_stats()["resolved"] == r0   # pure byte lane
    ch.close()


def test_fallback_over_slot(needs_shm, server):
    assert set_flag("rpc_shm_slot_bytes", 256 * 1024)   # 1 MiB > a slot
    ch = _channel(server)
    before = _fb("shm_over_slot")
    assert _echo(ch, ATT_1MB) == ATT_1MB
    assert _fb("shm_over_slot") >= before + 1
    ch.close()


def test_fallback_ring_exhausted(needs_shm, server):
    ch = _channel(server)
    for _ in range(2):                     # the handshake
        assert _echo(ch, ATT_1MB) == ATT_1MB
    gc.collect()
    ring = shm_ring.process_tx_ring()
    held = []
    while (s := ring.alloc(owner="test")) is not None:
        held.append(s)
    before = _fb("shm_ring_exhausted")
    assert _echo(ch, ATT_1MB) == ATT_1MB   # byte lane, correct
    # the client's request half and the server's response half (one
    # process, one ring) each count once
    assert _fb("shm_ring_exhausted") == before + 2
    for s in held:
        ring.free(s)
    ch.close()


def test_fallback_peer_without_capability(needs_shm, server, monkeypatch):
    """The peer never maps our ring: the offer is answered plainly, the
    client stops offering, and every later eligible attachment counts
    ``shm_peer_no_cap``, still byte-correct."""
    monkeypatch.setattr(shm_ring, "attach_spec",
                        lambda spec: shm_ring.count_fallback(
                            "shm_attach_failed") or None)
    ch = _channel(server)
    for _ in range(2):
        assert _echo(ch, ATT_1MB) == ATT_1MB
    before = _fb("shm_peer_no_cap")
    assert _echo(ch, ATT_1MB) == ATT_1MB
    assert _fb("shm_peer_no_cap") >= before + 1
    assert shm_ring.shm_stats()["staged"] == 0
    ch.close()


def test_fallback_disabled_flag(server):
    assert set_flag("rpc_shm_data_plane", False)
    ch = _channel(server)
    before = _fb("shm_disabled")
    assert _echo(ch, ATT_1MB) == ATT_1MB
    assert _fb("shm_disabled") == before + 1
    assert shm_ring.shm_stats()["staged"] == 0
    ch.close()


def test_fallback_multi_attempt(needs_shm):
    """A retry attempt (an earlier attempt's descriptor may still be
    live) stays off the lane under its named reason."""

    class _Sock:
        id = 999
        shm = None
    sock = _Sock()
    st = shm_ring.sock_state(sock)
    st.offered = st.tx_ok = True
    before = _fb("shm_multi_attempt")
    extra, wire_att, slot, offered = shm_ring.client_prepare(
        sock, ATT_1MB, multi_attempt=True)
    assert wire_att is not None and slot is None and not offered
    assert _fb("shm_multi_attempt") == before + 1


def test_reoffer_after_lost_offer(needs_shm):
    """A lost offer response must not disable the lane for the
    connection's life: after ``_REOFFER_AFTER`` unanswered eligible calls
    the offer is sent again; a peer that refused stays refused."""
    assert shm_ring.process_tx_ring() is not None

    class _Sock:
        id = 1001
        shm = None
    sock = _Sock()
    _, _, slot, offered = shm_ring.client_prepare(sock, ATT_1MB)
    assert offered and slot is None
    for _ in range(shm_ring._REOFFER_AFTER - 1):
        _, _, slot, offered = shm_ring.client_prepare(sock, ATT_1MB)
        assert not offered and slot is None
    _, _, slot, offered = shm_ring.client_prepare(sock, ATT_1MB)
    assert not offered                     # the call that trips the count
    _, _, slot, offered = shm_ring.client_prepare(sock, ATT_1MB)
    assert offered, "the offer was never sent again"
    shm_ring.sock_state(sock).peer_refused = True
    for _ in range(shm_ring._REOFFER_AFTER + 2):
        _, _, slot, offered = shm_ring.client_prepare(sock, ATT_1MB)
        assert not offered


def test_generation_checked_free(needs_shm):
    """A stale settle (a slot swept by a dead connection's owner sweep
    and re-allocated) must not free the new tenant's slot."""
    ring = shm_ring.ShmRing(64 * 1024, 2)
    try:
        s1 = ring.alloc(owner=("req", 1))
        g1 = ring.gen_of(s1)
        assert ring.free_owner(("req", 1)) == 1
        s2 = ring.alloc(owner=("req", 2))
        while s2 != s1:                    # force the same index
            other = s2
            s2 = ring.alloc(owner=("req", 2))
            ring.free(other)
        free_before = ring.free_count()
        ring.free(s1, g1)                  # the stale settle
        assert ring.free_count() == free_before
        ring.free(s2, ring.gen_of(s2))
        assert ring.free_count() == free_before + 1
    finally:
        ring.close()


def test_serialize_failure_does_not_leak_response_slot(needs_shm, server):
    ch = _channel(server)
    for _ in range(2):                     # handshake and mapping ack
        assert _echo(ch, ATT_1MB) == ATT_1MB
    ring = shm_ring.process_tx_ring()
    for _ in range(ring.nslots + 2):       # a leak would exhaust the ring
        r = _call(ch, "D.Bad")
        assert r.failed and "serialization" in r.error_text
    del r
    gc.collect()
    assert ring.free_count() == ring.nslots
    ch.close()


def test_unresolvable_response_descriptor_fails_loudly(needs_shm):
    """A response descriptor naming an unknown ring raises (never
    'success' with an empty attachment), and the request lease still
    settles."""
    ring = shm_ring.process_tx_ring()

    class _Sock:
        id = 1002
        shm = None
    sock = _Sock()
    slot = ring.alloc(owner=("req", sock.id))
    lease = (slot, ring.gen_of(slot))
    free_before = ring.free_count()
    meta = RpcMeta()
    meta.shm_desc = shm_ring.encode_desc(b"\xde\xad\xbe\xef" * 2, 0, 0, 1024)
    with pytest.raises(shm_ring.ShmDescriptorError):
        shm_ring.client_on_response_meta(sock, meta, staged_slot=lease)
    assert ring.free_count() == free_before + 1


def test_unresolvable_request_descriptor_answers_erequest(server):
    """The server's mirror: a request descriptor it cannot resolve is
    answered EREQUEST, not served with an empty attachment."""
    meta = RpcMeta()
    meta.correlation_id = 9
    meta.service_name, meta.method_name = "D", "Echo"
    desc = encode_tlv(TAG_SHM_DESC, shm_ring.encode_desc(b"\x01" * 8, 0, 0,
                                                          4096))
    s = socket.create_connection(("127.0.0.1", server.listen_endpoint.port),
                                 timeout=10)
    try:
        s.sendall(pack_frame(meta, b"x", extra_meta=desc))
        rmeta, _, _ = read_frame(s)
    finally:
        s.close()
    assert rmeta.correlation_id == 9
    assert rmeta.error_code == Errno.EREQUEST
    assert "unresolvable shm" in rmeta.error_text


def test_no_unknown_fallback_bucket():
    assert shm_ring.FALLBACK_REASONS == jshm.FALLBACK_REASONS
    assert "unknown" not in shm_ring.FALLBACK_REASONS
    assert set(shm_ring.shm_fallback_counters()) \
        == set(shm_ring.FALLBACK_REASONS)
    with pytest.raises(AssertionError):
        shm_ring.count_fallback("something_unnamed")


def test_codecs_match_jax():
    desc = shm_ring.encode_desc(b"r" * 8, 3, 3 * 4096 + 7, 1000)
    assert desc == jshm.encode_desc(b"r" * 8, 3, 3 * 4096 + 7, 1000)
    assert shm_ring.decode_desc(desc) == jshm.decode_desc(desc)
    rel = shm_ring.encode_release(b"r" * 8, [1, 5, 9])
    assert rel == jshm.encode_release(b"r" * 8, [1, 5, 9])
    assert shm_ring.decode_release(rel) == jshm.decode_release(rel)
    assert shm_ring.decode_release(rel[:-1]) is None
    assert shm_ring._host_token() == jshm._host_token()
    if shm_ring.shm_supported():
        spec = shm_ring.process_tx_ring().spec()
        assert jshm.decode_spec(spec) == shm_ring.decode_spec(spec)
        assert shm_ring.decode_spec(spec[:-1]) is None


def test_meta_shm_tags_match_jax():
    """RpcMeta tags 18-21 are the JAX encoder's bytes, as fields and as
    pre-encoded TLVs after the encoded meta, and decode both ways."""
    from brpc_tpu.protocol.meta import RpcMeta as JRpcMeta
    from brpc_tpu.protocol.meta import encode_tlv as jencode_tlv
    vals = {"shm_offer": b"SHMR\x01spec", "shm_accept": b"r" * 8,
            "shm_release": shm_ring.encode_release(b"r" * 8, [2, 3]),
            "shm_desc": shm_ring.encode_desc(b"r" * 8, 1, 4096, 1000)}
    m, j = RpcMeta(), JRpcMeta()
    for meta in (m, j):
        meta.correlation_id = 11
        for k, v in vals.items():
            setattr(meta, k, v)
    assert m.encode() == j.encode()
    for wire in (m.encode(), j.encode()):
        for back in (RpcMeta.decode(wire), JRpcMeta.decode(wire)):
            assert {k: bytes(getattr(back, k)) for k in vals} == vals
    tags = (("shm_offer", 18), ("shm_accept", 19), ("shm_release", 20),
            ("shm_desc", 21))
    extra = b"".join(encode_tlv(t, vals[k]) for k, t in tags)
    assert extra == b"".join(jencode_tlv(t, vals[k]) for k, t in tags)
    plain = RpcMeta()
    plain.correlation_id = 11
    back = JRpcMeta.decode(plain.encode() + extra)
    assert {k: bytes(getattr(back, k)) for k in vals} == vals


def test_wire_bytes_identical_for_ineligible_shape(needs_shm, server):
    """The raw response to an under-threshold attachment is the same bytes
    with the shm plane on or off."""
    from brpc_tpu.protocol.meta import (TAG_METHOD, TAG_SERVICE,
                                        TLV_ATTACHMENT, TLV_CORRELATION)
    from brpc_tpu.protocol.meta import encode_tlv as jencode_tlv

    def exchange(port):
        att = b"A" * 4096
        payload = b"pp"
        mb = (TLV_CORRELATION + struct.pack("<Q", 7)
              + TLV_ATTACHMENT + struct.pack("<I", len(att))
              + jencode_tlv(TAG_SERVICE, b"D")
              + jencode_tlv(TAG_METHOD, b"Echo"))
        frame = (b"TRPC"
                 + struct.pack("<II", len(mb) + len(payload) + len(att),
                               len(mb))
                 + mb + payload + att)
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            s.sendall(frame)
            buf = b""
            while len(buf) < 12:
                buf += s.recv(65536)
            body, _meta = struct.unpack_from("<II", buf, 4)
            while len(buf) < 12 + body:
                buf += s.recv(65536)
            return buf[:12 + body]
        finally:
            s.close()

    port = server.listen_endpoint.port
    assert set_flag("rpc_shm_data_plane", True)
    with_shm = exchange(port)
    assert set_flag("rpc_shm_data_plane", False)
    without = exchange(port)
    assert with_shm == without


def test_shm_ring_slots_returned_after_soak(needs_shm, server):
    ch = _channel(server)
    for i in range(1000):
        c = _call(ch, "D.Echo", ATT_300K)
        assert not c.failed and len(c.response_attachment) == len(ATT_300K), i
    del c
    gc.collect()
    ring = shm_ring.process_tx_ring()
    assert ring.free_count() == ring.nslots
    ch.close()
    assert shm_ring.outstanding_tx_slots() == 0


# -- between the packages ----------------------------------------------------

class JDataSvc(JService):
    def Echo(self, cntl, request):
        cntl.response_attachment.append_iobuf(cntl.request_attachment)
        return b"done"

    def Gen(self, cntl, request):
        cntl.response_attachment.append_user_data(ATT_300K)
        return b"gen"


def test_port_client_on_jax_server_both_ways_bit_exact(needs_shm):
    """The port client's requests ride its ring into the JAX server, which
    echoes them by reference; the JAX server's fresh responses ride the
    JAX ring back into the port client."""
    opts = JServerOptions()
    opts.native = False
    opts.usercode_inline = False
    srv = JServer(opts)
    srv.add_service(JDataSvc(), name="D")
    assert srv.start("127.0.0.1:0") == 0
    try:
        ch = _channel(srv)
        for i in range(4):
            assert _echo(ch, ATT_1MB) == ATT_1MB, i
        for _ in range(3):
            r = _call(ch, "D.Gen")
            assert not r.failed and bytes(r.response_attachment) == ATT_300K
            assert isinstance(r.response_attachment, memoryview)
        assert shm_ring.shm_stats()["staged"] == 3      # the port's requests
        assert jshm.shm_stats()["desc_reused"] == 3     # the JAX echoes
        assert jshm.shm_stats()["staged"] >= 2          # the JAX responses
        del r
        gc.collect()
        _call(ch, "D.Echo")                             # the owed releases
        ch.close()
        assert shm_ring.outstanding_tx_slots() == 0
        assert jshm.outstanding_tx_slots() == 0
    finally:
        srv.stop()


def test_jax_client_on_port_server_both_ways_bit_exact(needs_shm, server):
    co = JChannelOptions()
    co.connection_type = "pooled"
    ch = JChannel(co)
    ch.init(str(server.listen_endpoint))

    def jcall(method, att=None):
        cntl = JController()
        cntl.timeout_ms = 10_000
        if att is not None:
            cntl.request_attachment = IOBuf(att)
        r = ch.call_method(method, b"x", cntl=cntl)
        assert not r.failed, (r.error_code, r.error_text)
        return r.response_attachment.to_bytes()

    for i in range(4):
        assert jcall("D.Echo", ATT_1MB) == ATT_1MB, i
    for _ in range(3):
        assert jcall("D.Gen") == ATT_300K
    assert jshm.shm_stats()["staged"] == 3              # the JAX requests
    assert shm_ring.shm_stats()["desc_reused"] == 3     # the port's echoes
    assert shm_ring.shm_stats()["staged"] >= 2          # the port's responses
    gc.collect()
    jcall("D.Echo")                                     # the owed releases
    assert shm_ring.outstanding_tx_slots() == 0
    assert jshm.outstanding_tx_slots() == 0


# -- where a ring lives ----------------------------------------------------

def test_ring_for_this_process_alone_lives_in_tempdir(monkeypatch, tmp_path):
    """A tx ring rebuilt with ``reset_tx_ring(local_only=True)`` (users in
    this process only, as chip_smoke.py's 6d (e)) is made under
    ``tempfile.gettempdir()``, never in /dev/shm; the next plain reset
    puts rings back in the shared directories (a ring for other
    processes)."""
    import tempfile
    local, shared = tmp_path / "tmp", tmp_path / "shm"
    local.mkdir()
    shared.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(local))
    monkeypatch.setattr(shm_ring, "_ring_dirs", lambda: iter([str(shared)]))
    monkeypatch.setattr(shm_ring, "_avail", True)
    assert shm_ring.reset_tx_ring(local_only=True)
    ring = shm_ring.process_tx_ring()
    assert os.path.dirname(ring.path) == str(local)
    assert list(shared.iterdir()) == []
    assert shm_ring.reset_tx_ring()
    assert not os.path.exists(ring.path)
    ring = shm_ring.process_tx_ring()
    assert os.path.dirname(ring.path) == str(shared)
    assert list(local.iterdir()) == []
    assert shm_ring.reset_tx_ring()


# -- a ring that does not fit ------------------------------------------------

def test_fallocate_decline_moves_on_then_declines(monkeypatch, tmp_path):
    """``posix_fallocate`` failing in a directory (a tmpfs too small for
    the ring) passes the ring to the next directory; failing in every one
    declines it: ``process_tx_ring()`` is None, the lane counts
    ``shm_unavailable`` and the call rides the byte lane."""
    small, big = tmp_path / "small", tmp_path / "big"
    small.mkdir()
    big.mkdir()
    monkeypatch.setattr(shm_ring, "_ring_dirs",
                        lambda: iter([str(small), str(big)]))
    real = os.posix_fallocate
    full = {str(small)}

    def fallocate(fd, off, n):
        if os.path.dirname(os.readlink(f"/proc/self/fd/{fd}")) in full:
            raise OSError(errno.ENOSPC, "No space left on device")
        return real(fd, off, n)

    monkeypatch.setattr(os, "posix_fallocate", fallocate)
    monkeypatch.setattr(shm_ring, "_avail", True)
    ring = shm_ring.process_tx_ring()
    assert ring is not None and os.path.dirname(ring.path) == str(big)
    assert os.path.getsize(ring.path) == ring.size
    assert list(small.iterdir()) == []            # nothing left behind
    assert shm_ring.reset_tx_ring()
    assert not os.path.exists(ring.path)

    full.add(str(big))
    assert shm_ring.process_tx_ring() is None
    assert list(big.iterdir()) == []

    class _Sock:
        id = 1003
        shm = None
    before = _fb("shm_unavailable")
    _, wire, slot, offered = shm_ring.client_prepare(_Sock(), ATT_1MB)
    assert wire is ATT_1MB and slot is None and not offered
    assert _fb("shm_unavailable") == before + 1


def test_reset_tx_ring_refused_while_a_slot_is_out(needs_shm):
    assert set_flag("rpc_shm_slot_bytes", 8192)
    ring = shm_ring.process_tx_ring()
    assert ring.slot_bytes == 8192
    slot = ring.alloc(owner="t")
    assert not shm_ring.reset_tx_ring()
    ring.free(slot)
    assert set_flag("rpc_shm_slot_bytes", 16384)
    assert shm_ring.reset_tx_ring()
    assert shm_ring.process_tx_ring().slot_bytes == 16384


# -- the IOBuf half, and the fast lane on the ring ----------------------------

def test_iobuf_half_resolve_spill_and_allocator(needs_shm):
    """``resolve_ex`` gives a view and the local ring's file ref,
    ``sendfile_spill`` ships a staged span over a socket with headers in
    front, ``slot_of`` maps an offset back to its slot and
    ``shard_stats`` counts each shard's free slots, as in the JAX
    ring."""
    ring = shm_ring.process_tx_ring()
    slot = ring.alloc(owner=("req", 0))
    off, n = ring.write(slot, ATT_300K)
    try:
        assert ring.slot_of(off) == slot
        st = ring.shard_stats()
        assert st["shards"] == ring.nshards
        assert sum(st[f"shard_{i}_free"] for i in range(ring.nshards)) \
            == ring.free_count() == ring.nslots - 1
        view, ref = shm_ring.resolve_ex(ring.ring_id, off, n)
        assert bytes(view) == ATT_300K and ref == (ring.fd, off)
        view.release()
        assert shm_ring.resolve_ex(b"\0" * 8, off, n) is None
        a, b = socket.socketpair()
        got = bytearray()

        def drain():
            b.settimeout(10)
            while len(got) < n + 3:
                chunk = b.recv(1 << 20)
                if not chunk:
                    return
                got.extend(chunk)

        reader = threading.Thread(target=drain)
        reader.start()             # the span outgrows the socket buffer
        try:
            spilled0 = shm_ring.shm_stats()["spilled"]
            assert ring.sendfile_spill(a.fileno(), off, n, b"HDR") == n
            reader.join(10)
            assert bytes(got) == b"HDR" + ATT_300K
            assert shm_ring.shm_stats()["spilled"] == spilled0 + 1
        finally:
            a.close()
            b.close()
            reader.join(10)
    finally:
        ring.free(slot)


def test_wrap_view_iobuf_and_defer_settle():
    """A view wrapped as an IOBuf settles its slot when the buffer is
    dropped; a deferred settle runs when the next request is prepared on
    the socket."""
    settled = []
    buf = shm_ring.wrap_view_iobuf(memoryview(b"abcdef")[1:4],
                                   lambda: settled.append("iobuf"))
    assert buf.to_bytes() == b"bcd" and not settled
    del buf
    gc.collect()
    assert settled == ["iobuf"]

    class Sock:
        id = 0
        shm = None

    sock = Sock()
    shm_ring.defer_settle(sock, lambda: settled.append("deferred"))
    shm_ring.defer_settle(sock, None)
    assert settled == ["iobuf"]
    shm_ring.client_prepare(sock, None)
    assert settled == ["iobuf", "deferred"]
    shm_ring.client_prepare(sock, None)
    assert settled == ["iobuf", "deferred"]


def test_fast_lane_rides_the_ring(needs_shm, server):
    """A pooled call's 1 MiB attachment rides the ring from the second
    call on (the first carries the offer), on the engine's ``sync_call``;
    the response is a view whose release settles its slot, and every
    slot comes back."""
    from brpc_tpu_torch.client import ChannelOptions, fast_call
    co = ChannelOptions()
    co.connection_type = "pooled"
    ch = Channel(co)
    assert ch.init(str(server.listen_endpoint)) == 0
    calls0 = fast_call.lane_counters()["sync_call"]
    staged0 = shm_ring.shm_stats()["staged"]
    for _ in range(4):
        c = _call(ch, "D.Echo", ATT_1MB)
        assert not c.failed, c.error_text
        att = c.response_attachment
        assert bytes(att) == ATT_1MB
        del att, c
    assert fast_call.lane_counters()["sync_call"] == calls0 + 4
    assert shm_ring.shm_stats()["staged"] >= staged0 + 3
    gc.collect()
    assert shm_ring.outstanding_tx_slots() == 0
