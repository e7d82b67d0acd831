"""The port's HPACK and h2 session against the JAX package's:
``tests/test_h2.py``'s RFC 7541/7540 vectors on the port's copies, the
port's encoder decoded by the JAX decoder and the reverse (the same
bytes for the same header lists), and a port session talking to a JAX
session both ways, with flow control and PING."""

import struct

import numpy as np
import pytest

from brpc_tpu.protocol import h2_session as jh2
from brpc_tpu.protocol import hpack as jhp
from brpc_tpu_torch.protocol import h2_session as th2
from brpc_tpu_torch.protocol.hpack import (Decoder, Encoder, HpackError,
                                           decode_int, encode_int,
                                           huffman_decode, huffman_encode)
from brpc_tpu_torch.protocol.h2_session import PREFACE, H2Session


def test_hpack_integer_rfc_examples():
    # RFC 7541 C.1: 10 in 5-bit prefix; 1337 in 5-bit prefix
    assert encode_int(10, 5) == b"\x0a"
    assert encode_int(1337, 5) == b"\x1f\x9a\x0a"
    assert decode_int(b"\x0a", 0, 5) == (10, 1)
    assert decode_int(b"\x1f\x9a\x0a", 0, 5) == (1337, 3)


def test_huffman_rfc_vectors():
    # RFC 7541 C.4.1-C.4.3
    assert huffman_encode(b"www.example.com").hex() == \
        "f1e3c2e5f23a6ba0ab90f4ff"
    assert huffman_encode(b"no-cache").hex() == "a8eb10649cbf"
    assert huffman_decode(bytes.fromhex("25a849e95ba97d7f")) == \
        b"custom-key"
    assert huffman_decode(bytes.fromhex("25a849e95bb8e8b4bf")) == \
        b"custom-value"


def test_rfc_request_examples_with_huffman():
    """RFC 7541 C.4: three requests on one connection, decoded by the
    port (the dynamic table carried across them)."""
    d = Decoder()
    assert d.decode(bytes.fromhex(
        "828684418cf1e3c2e5f23a6ba0ab90f4ff")) == [
        (":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com")]
    assert d.decode(bytes.fromhex("828684be5886a8eb10649cbf")) == [
        (":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com"), ("cache-control", "no-cache")]
    assert d.decode(bytes.fromhex(
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf")) == [
        (":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
        (":authority", "www.example.com"), ("custom-key", "custom-value")]


def test_huffman_roundtrip_all_bytes():
    data = bytes(range(256)) * 3
    assert huffman_decode(huffman_encode(data)) == data
    assert jhp.huffman_decode(huffman_encode(data)) == data


def test_huffman_bad_padding_rejected():
    with pytest.raises(HpackError):
        huffman_decode(b"\x00")      # '0' bits of padding are invalid


def test_static_and_huffman_tables_are_the_rfcs():
    from brpc_tpu.protocol import hpack_tables as jt
    from brpc_tpu_torch.protocol import hpack_tables as tt
    assert tt.STATIC_TABLE == jt.STATIC_TABLE and len(tt.STATIC_TABLE) == 61
    assert tt.HUFFMAN_CODES == jt.HUFFMAN_CODES
    assert len(tt.HUFFMAN_CODES) == 257


def _header_lists(seed: int):
    rng = np.random.default_rng(seed)
    names = [":status", ":path", "content-type", "grpc-status",
             "x-long-header-name", "authorization", "cookie", "te",
             "grpc-message", "x-custom"]
    out = []
    for _ in range(6):
        hs = []
        for _ in range(int(rng.integers(1, 7))):
            name = names[int(rng.integers(len(names)))]
            value = "".join(chr(int(c)) for c in
                            rng.integers(32, 127, int(rng.integers(0, 40))))
            hs.append((name, value))
        out.append(hs)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_encoders_equal_and_cross_decode(seed):
    """The same header lists through one encoder each: equal bytes, and
    each package's decoder reads the other's blocks (dynamic tables kept
    in step across the sequence)."""
    te, je = Encoder(), jhp.Encoder()
    td, jd = Decoder(), jhp.Decoder()
    for hs in _header_lists(seed):
        tb, jb = te.encode(hs), je.encode(hs)
        assert tb == jb
        assert jd.decode(tb) == hs
        assert td.decode(jb) == hs


def test_table_size_update_cross_decodes():
    te, jd = Encoder(), jhp.Decoder()
    hs = [("x-a", "1" * 50), ("x-b", "2" * 50)]
    assert jd.decode(te.encode(hs)) == hs
    te.set_max_table_size(64)               # the peer's SETTINGS cap
    block = te.encode(hs)
    assert block[0] & 0xE0 == 0x20          # a dynamic table size update
    assert jd.decode(block) == hs


def test_hpack_dynamic_table_shrinks_repeat_headers():
    e, d = Encoder(), Decoder()
    hs = [(":status", "200"), ("x-long-header-name", "v" * 64)]
    w1 = e.encode(hs)
    w2 = e.encode(hs)
    assert d.decode(w1) == hs
    assert d.decode(w2) == hs
    assert len(w2) < len(w1) // 4        # fully indexed second time


def test_hpack_sensitive_headers_never_indexed():
    e, d = Encoder(), Decoder()
    hs = [("authorization", "Bearer tok")]
    w1 = e.encode(hs)
    w2 = e.encode(hs)
    assert len(w2) >= len(w1) - 1        # no dynamic-table win
    assert d.decode(w1) == hs and d.decode(w2) == hs


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_h2_session_loopback_request_response(client, server):
    mods = {"port": th2, "jax": jh2}
    c = mods[client].H2Session(is_server=False)
    s = mods[server].H2Session(is_server=True)
    c.start()
    sid = c.next_stream_id()
    c.send_headers(sid, [(":method", "POST"), (":path", "/x")])
    c.send_data(sid, b"hello", end_stream=True)
    events = s.feed(c.take_output())
    kinds = [e[0] for e in events]
    assert "headers" in kinds and "data" in kinds
    hev = next(e for e in events if e[0] == "headers")
    assert (":path", "/x") in hev[2]
    dev = next(e for e in events if e[0] == "data")
    assert dev[2] == b"hello" and dev[3] is True
    s.send_headers(sid, [(":status", "200")])
    s.send_data(sid, b"world", end_stream=True)
    s.send_headers(sid, [("grpc-status", "0")], end_stream=True)
    revents = c.feed(s.take_output())
    assert any(e[0] == "data" and e[2] == b"world" for e in revents)
    assert revents[-1] == ("headers", sid, [("grpc-status", "0")], True)


def test_port_and_jax_sessions_frame_alike():
    """One script through both packages' client sessions: the same
    wire bytes."""
    wires = []
    for mod in (th2, jh2):
        c = mod.H2Session(is_server=False)
        c.start()
        sid = c.next_stream_id()
        c.send_headers(sid, [(":method", "POST"), (":path", "/a/b"),
                             ("content-type", "application/grpc")])
        c.send_data(sid, bytes(range(256)) * 100, end_stream=True)
        c.send_rst(c.next_stream_id(), 8)
        c.send_goaway(0)
        wires.append(c.take_output())
    assert wires[0] == wires[1]


def test_h2_flow_control_blocks_and_resumes():
    client = H2Session(is_server=False)
    client.start()
    sid = client.next_stream_id()
    client.send_headers(sid, [(":method", "POST"), (":path", "/big")])
    client.take_output()
    big = bytes(200_000)                 # > 65535 default window
    client.send_data(sid, big, end_stream=True)
    sent1 = client.take_output()
    assert 0 < len(sent1) < len(big) + 1000   # clipped at the window
    upd = struct.pack(">I", 150_000)
    client._on_frame(th2.F_WINDOW_UPDATE, 0, 0, upd, [])
    client._on_frame(th2.F_WINDOW_UPDATE, 0, sid, upd, [])
    sent2 = client.take_output()
    total_payload = sum(len(f) for f in (sent1, sent2))
    assert total_payload > len(big)      # everything (plus frame headers)


def test_flow_control_across_packages():
    """A port client pushing 300 KB to a JAX server session: the JAX
    side's WINDOW_UPDATEs release the port's window-blocked DATA until
    every byte arrives, and the reverse."""
    for cmod, smod in ((th2, jh2), (jh2, th2)):
        c = cmod.H2Session(is_server=False)
        s = smod.H2Session(is_server=True)
        c.start()
        s.feed(c.take_output())
        c.feed(s.take_output())          # settings + acks both ways
        s.feed(c.take_output())
        sid = c.next_stream_id()
        c.send_headers(sid, [(":method", "POST"), (":path", "/big")])
        payload = bytes(range(256)) * 1200
        c.send_data(sid, payload, end_stream=True)
        got = bytearray()
        ended = False
        for _ in range(100):
            for ev in s.feed(c.take_output()):
                if ev[0] == "data":
                    got += ev[2]
                    ended = ended or ev[3]
            c.feed(s.take_output())      # window updates flow back
            if ended:
                break
        assert ended and bytes(got) == payload


def test_h2_ping_is_acked():
    for mod in (th2, jh2):
        server = mod.H2Session(is_server=True)
        server.feed(PREFACE)
        server.take_output()
        ping = struct.pack(">I", 8)[1:] + bytes([0x6, 0x0]) + \
            struct.pack(">I", 0) + b"12345678"
        events = server.feed(ping)
        assert ("ping", b"12345678") in events
        out = server.take_output()
        assert b"12345678" in out            # PING ACK echoed
        # the ack a port session sends is what the JAX one sends
        assert out == struct.pack(">I", 8)[1:] + bytes([0x6, 0x1]) + \
            struct.pack(">I", 0) + b"12345678"


def test_bad_preface_and_goaway():
    s = H2Session(is_server=True)
    with pytest.raises(th2.H2Error):
        s.feed(b"GET / HTTP/1.1\r\n\r\n" + b"x" * 10)
    c = H2Session(is_server=False)
    c.start()
    c.take_output()
    goaway = struct.pack(">I", 8)[1:] + bytes([0x7, 0x0]) + \
        struct.pack(">I", 0) + struct.pack(">II", 3, 0)
    assert c.feed(goaway) == [("goaway", 3, 0, b"")]
    assert c.goaway_received
