"""Shared pieces of the port's overload, deadline and drain tests (not a
test module): raw tpu_std frames as the JAX package's own tests build
them, a recording server that plays scripted answers to each request
frame, and small services for both packages' servers."""

import socket as pysock
import struct
import threading
import time

from brpc_tpu.protocol.meta import RpcMeta as JRpcMeta
from brpc_tpu.protocol.meta import TLV_CORRELATION, TLV_TIMEOUT, encode_tlv
from brpc_tpu_torch.protocol.meta import RpcMeta
from brpc_tpu_torch.protocol.tpu_std import (AckFrame, pack_frame,
                                             read_frame)


def frame(service: bytes, cid: int, mth: bytes, payload: bytes = b"",
          timeout_ms=None, tenant: bytes = b"") -> bytes:
    """A tpu_std request frame, TLV by TLV, as ``tests/test_*_plane.py``
    build theirs (an explicit ``timeout_ms=0`` rides TLV 13)."""
    mb = TLV_CORRELATION + struct.pack("<Q", cid)
    mb += encode_tlv(4, service) + encode_tlv(5, mth)
    if timeout_ms is not None:
        mb += TLV_TIMEOUT + struct.pack("<I", timeout_ms)
    if tenant:
        mb += encode_tlv(22, tenant)
    body = mb + payload
    return b"TRPC" + struct.pack("<II", len(body), len(mb)) + body


def read_frames(c: pysock.socket, n: int, timeout=10.0) -> dict:
    """Read ``n`` whole response frames; ``{cid: meta}`` decoded by the
    JAX package's RpcMeta."""
    c.settimeout(timeout)
    buf = b""
    out = {}
    while len(out) < n:
        while True:
            if len(buf) >= 12:
                (blen,) = struct.unpack_from("<I", buf, 4)
                if len(buf) >= 12 + blen:
                    break
            chunk = c.recv(65536)
            if not chunk:
                raise EOFError("connection closed")
            buf += chunk
        (blen,) = struct.unpack_from("<I", buf, 4)
        (mlen,) = struct.unpack_from("<I", buf, 8)
        meta = JRpcMeta.decode(buf[12:12 + mlen])
        assert meta is not None
        out[meta.correlation_id] = meta
        buf = buf[12 + blen:]
    return out


def connect(ep) -> pysock.socket:
    return pysock.create_connection((str(ep.host), ep.port), timeout=10)


class Recorder:
    """A tpu_std server that records each request frame (connection
    number, correlation id, TLV-13 budget) and answers it by a script:
    ``script(n)`` for the n-th request gives ``"close"`` (drop the
    connection unanswered), ``("answer", delay_s)`` or ``"ignore"``."""

    def __init__(self, script):
        self.script = script
        self.frames = []            # (conn number, cid, timeout_ms)
        self._lock = threading.Lock()
        self._lsock = pysock.socket()
        self._lsock.setsockopt(pysock.SOL_SOCKET, pysock.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(16)
        self.port = self._lsock.getsockname()[1]
        self._conns = []
        self._stop = False
        threading.Thread(target=self._accept, daemon=True).start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def _accept(self):
        n = 0
        while not self._stop:
            try:
                c, _ = self._lsock.accept()
            except OSError:
                return
            self._conns.append(c)
            threading.Thread(target=self._serve, args=(c, n),
                             daemon=True).start()
            n += 1

    def _serve(self, c, conn_no):
        wlock = threading.Lock()
        try:
            while True:
                msg = read_frame(c)
                if isinstance(msg, AckFrame):
                    continue
                meta = msg[0]
                with self._lock:
                    idx = len(self.frames)
                    self.frames.append((conn_no, meta.correlation_id,
                                        meta.timeout_ms))
                act = self.script(idx)
                if act == "close":
                    c.shutdown(pysock.SHUT_RDWR)
                    c.close()
                    return
                if act == "ignore":
                    continue
                threading.Thread(target=self._answer,
                                 args=(c, wlock, meta, act[1], idx),
                                 daemon=True).start()
        except (OSError, EOFError):
            pass

    @staticmethod
    def _answer(c, wlock, meta, delay_s, idx):
        time.sleep(delay_s)
        out = RpcMeta()
        out.correlation_id = meta.correlation_id
        try:
            with wlock:
                c.sendall(pack_frame(out, b"answer-%d" % idx))
        except OSError:
            pass

    def close(self):
        self._stop = True
        self._lsock.close()
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass


class HoldSvc:
    """``Echo`` records what ran; ``Hold`` blocks until released (one
    admission slot per call, on its connection's thread); ``Sleep``
    naps; ``seen_remaining`` records ``cntl.deadline_remaining_ms()``."""

    def __init__(self):
        self.echo_calls = []
        self.seen_remaining = []
        self.release = threading.Event()
        self.holding = 0
        self._lock = threading.Lock()

    def Echo(self, cntl, request):
        self.echo_calls.append(bytes(request))
        self.seen_remaining.append(cntl.deadline_remaining_ms())
        return b"ok:" + bytes(request)

    def Hold(self, cntl, request):
        with self._lock:
            self.holding += 1
        try:
            self.release.wait(30)
        finally:
            with self._lock:
                self.holding -= 1
        return b"released"

    def Sleep(self, cntl, request):
        time.sleep(float(bytes(request) or b"0.2"))
        return b"slept"


def wait_for(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)
