"""The port's engine's ``call_batch`` on adversarial wire bytes, as
``tests/test_native_batch_adversarial.py:79-159`` holds the JAX engine's:
responses out of order land by correlation id; a duplicate or
out-of-range id, bad magic and an oversized ack count are refused; a
peer that goes silent times out; TICI frames between responses come back
as acks; a response with an error or an attachment comes back whole for
the Python meta decode; and the request frames are well formed, their
ids consecutive from the base.  The same scripted peers then answer the
JAX engine, and both engines must return the same results."""

import socket
import struct
import threading

import pytest

from brpc_tpu_torch.native import load
from brpc_tpu_torch.protocol.meta import RpcMeta

TAIL = b"\x04\x01\x00\x00\x00S" + b"\x05\x01\x00\x00\x00M"


def _tlv(tag, data):
    return bytes([tag]) + struct.pack("<I", len(data)) + data


def _resp_frame(cid, payload=b"ok", extra_meta=b""):
    meta = _tlv(1, struct.pack("<Q", cid)) + extra_meta
    return (b"TRPC" + struct.pack("<II", len(meta) + len(payload),
                                  len(meta)) + meta + payload)


def _native():
    nat = load()
    if nat is None or not hasattr(nat, "call_batch"):
        pytest.skip("native engine unavailable (no toolchain)")
    return nat


def _jax_native():
    from brpc_tpu.native import load as jload
    nat = jload()
    if nat is None or not hasattr(nat, "call_batch"):
        pytest.skip("JAX native engine unavailable")
    return nat


def _complete_frames(data: bytes, want: int) -> bool:
    off = count = 0
    while count < want:
        if len(data) - off < 12 or data[off:off + 4] != b"TRPC":
            return False
        (body,) = struct.unpack_from("<I", data, off + 4)
        if len(data) - off < 12 + body:
            return False
        off += 12 + body
        count += 1
    return True


def _run(nat, responder, n=2, timeout=5.0, base=1000):
    a, b = socket.socketpair()
    a.setblocking(False)

    def peer():
        b.settimeout(10)
        buf = b""
        try:
            while not _complete_frames(buf, n):
                c = b.recv(65536)
                if not c:
                    break
                buf += c
        except socket.timeout:
            pass
        reply = responder(buf)
        if reply:
            b.sendall(reply)

    t = threading.Thread(target=peer)
    t.start()
    try:
        payloads = [b"p%d" % i for i in range(n)]
        return nat.call_batch(a.fileno(), TAIL, payloads, timeout, base,
                              b"", b"")
    finally:
        t.join(15)
        a.close()
        b.close()


def _normal(results):
    out = []
    for r in results:
        if type(r) is tuple:
            out.append(("whole", bytes(r[0]), r[1]))
        else:
            out.append(("plain", bytes(r)))
    return out


@pytest.mark.parametrize("engine", ["port", "jax"])
def test_happy_path_out_of_order(engine):
    nat = _native() if engine == "port" else _jax_native()
    results, acks = _run(
        nat, lambda req: _resp_frame(1001, b"second")
        + _resp_frame(1000, b"first"))
    assert bytes(results[0]) == b"first"
    assert bytes(results[1]) == b"second"
    assert acks == []


REFUSED = {
    "duplicate_cid": (lambda req: _resp_frame(1000) + _resp_frame(1000),
                      "cid"),
    "cid_out_of_range": (lambda req: _resp_frame(9999) + _resp_frame(1000),
                         "cid"),
    "bad_magic": (lambda req: b"JUNKJUNKJUNKJUNK" * 4, "magic"),
    "oversized_ack_count": (
        lambda req: b"TICI" + struct.pack("<I", 1 << 20)
        + _resp_frame(1000) + _resp_frame(1001), "ack"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused(case):
    responder, word = REFUSED[case]
    for nat in (_native(), _jax_native()):
        with pytest.raises(ValueError, match=word):
            _run(nat, responder)


def test_truncated_stream_times_out():
    nat = _native()
    with pytest.raises(TimeoutError):
        _run(nat, lambda req: _resp_frame(1000), timeout=0.5)


def test_tici_interleave_collected():
    nat = _native()
    tici = b"TICI" + struct.pack("<I", 2) + struct.pack("<QQ", 7, 8)
    results, acks = _run(
        nat, lambda req: _resp_frame(1000) + tici + _resp_frame(1001))
    assert bytes(results[0]) == b"ok"
    assert sorted(acks) == [7, 8]


def test_error_response_returned_whole_for_python_decode():
    nat = _native()
    err_meta = _tlv(6, struct.pack("<i", 1003)) + _tlv(7, b"nope")
    results, _ = _run(
        nat, lambda req: _resp_frame(1000, b"", extra_meta=err_meta)
        + _resp_frame(1001))
    assert type(results[0]) is tuple
    body, msize = results[0]
    meta = RpcMeta.decode(bytes(memoryview(body)[:msize]))
    assert meta.error_code == 1003 and meta.error_text == "nope"
    assert type(results[1]) is not tuple


def test_attachment_response_returned_whole():
    nat = _native()
    att_meta = _tlv(3, struct.pack("<I", 2))
    results, _ = _run(
        nat, lambda req: _resp_frame(1000, b"bodyAT", extra_meta=att_meta)
        + _resp_frame(1001))
    assert type(results[0]) is tuple


def test_request_frames_well_formed_and_equal_to_jax():
    seen = {}

    def capture(key):
        def responder(req):
            seen[key] = req
            return _resp_frame(1000) + _resp_frame(1001)
        return responder

    _run(_native(), capture("port"))
    _run(_jax_native(), capture("jax"))
    req = seen["port"]
    assert req == seen["jax"]
    cids = []
    off = 0
    while off < len(req):
        assert req[off:off + 4] == b"TRPC"
        body, msize = struct.unpack_from("<II", req, off + 4)
        assert msize <= body
        meta = req[off + 12:off + 12 + msize]
        assert meta[0] == 1
        cids.append(struct.unpack_from("<Q", meta, 5)[0])
        off += 12 + body
    assert cids == [1000, 1001]


def test_both_engines_agree_on_mixed_responses():
    err_meta = _tlv(6, struct.pack("<i", 1003)) + _tlv(7, b"nope")
    tici = b"TICI" + struct.pack("<I", 1) + struct.pack("<Q", 9)

    def responder(req):
        return (_resp_frame(1002, b"third") + tici
                + _resp_frame(1000, b"", extra_meta=err_meta)
                + _resp_frame(1001, b"second"))

    port = _run(_native(), responder, n=3)
    jax = _run(_jax_native(), responder, n=3)
    assert _normal(port[0]) == _normal(jax[0])
    assert list(port[1]) == list(jax[1]) == [9]
