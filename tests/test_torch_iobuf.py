"""The port's IOBuf and copy ledger against the JAX package's: the same
seeded sequence of append / cut / fetch / pop operations on both
buffers, the bytes held equal after every step, and the ``copy_audit``
stages and byte counts of those operations equal; then the two wired
stages, a host-tier spill and an shm staging, counted alike."""

import numpy as np
import pytest
import torch

from brpc_tpu.butil import copy_audit as jaudit
from brpc_tpu.butil.iobuf import IOBuf as JIOBuf
from brpc_tpu.butil.iobuf import IOPortal as JIOPortal
from brpc_tpu_torch.butil import copy_audit as taudit
from brpc_tpu_torch.butil.iobuf import IOBuf as TIOBuf
from brpc_tpu_torch.butil.iobuf import IOPortal as TIOPortal

# sizes around the block size (8 KiB) and the audit floor (64 KiB)
_SIZES = (1, 17, 4095, 8192, 8193, 20_000, 65_536, 70_000, 200_000)
_OPS = ("append_bytes", "append_bytearray", "append_iobuf", "cutn",
        "pop_front", "pop_back", "fetch", "to_bytes", "as_contiguous",
        "append_user_data", "copy_to", "push_back")


def _script(seed: int, n: int = 60):
    """A seeded op sequence, the same for both packages."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n):
        op = _OPS[int(rng.integers(len(_OPS)))]
        size = int(_SIZES[int(rng.integers(len(_SIZES)))])
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        steps.append((op, size, data))
    return steps


def _run(IOBuf, steps):
    """Apply ``steps`` to a fresh buffer; yields (op, observed) pairs
    and the buffer's bytes after every step."""
    buf, side = IOBuf(), IOBuf()
    trace = []
    for op, size, data in steps:
        seen = None
        if op == "append_bytes":
            buf.append(data)
        elif op == "append_bytearray":
            buf.append(bytearray(data))
        elif op == "append_iobuf":
            other = IOBuf(bytearray(data))
            buf.append(other)
        elif op == "cutn":
            cut = buf.cutn(size)
            seen = cut.to_bytes()
            side.append(cut)
        elif op == "pop_front":
            seen = buf.pop_front(size)
        elif op == "pop_back":
            seen = buf.pop_back(size)
        elif op == "fetch":
            seen = buf.fetch(size)
        elif op == "to_bytes":
            seen = buf.to_bytes()
        elif op == "as_contiguous":
            view, copied = buf.as_contiguous()
            seen = (bytes(view), copied)
        elif op == "append_user_data":
            buf.append_user_data(memoryview(data))
        elif op == "copy_to":
            seen = buf.copy_to(min(size, len(buf)))
        elif op == "push_back":
            buf.push_back(data[0])
        trace.append((op, seen, len(buf), buf.to_bytes()
                      if len(buf) < 300_000 else len(buf)))
    trace.append(("side", side.to_bytes(), len(side), None))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_seeded_ops_give_equal_bytes(seed):
    steps = _script(seed)
    assert _run(TIOBuf, steps) == _run(JIOBuf, steps)


@pytest.mark.parametrize("seed", range(3))
def test_copy_audit_counts_equal(seed):
    steps = _script(100 + seed, n=40)
    with jaudit.audit() as jsnap:
        _run(JIOBuf, steps)
        jcounts = jsnap()
    with taudit.audit() as tsnap:
        _run(TIOBuf, steps)
        tcounts = tsnap()
    assert tcounts == jcounts
    assert taudit.STAGES == jaudit.STAGES


def test_every_iobuf_audit_point_counted_alike():
    """``ingest`` (a copy into pool blocks), ``gather`` (a chained
    buffer joined) and ``materialize`` (fetch / to_bytes), each once."""
    steps = [("append_bytearray", 70_000, bytes(70_000)),
             ("append_user_data", 70_000, bytes(range(256)) * 274),
             ("as_contiguous", 0, b""),
             ("fetch", 100_000, b"")]
    counts = []
    for IOBuf, audit in ((JIOBuf, jaudit), (TIOBuf, taudit)):
        with audit.audit() as snap:
            buf = IOBuf()
            for op, size, data in steps:
                if op == "append_bytearray":
                    buf.append(bytearray(data))
                elif op == "append_user_data":
                    buf.append_user_data(memoryview(data))
                elif op == "as_contiguous":
                    buf.as_contiguous()
                else:
                    buf.fetch(size)
            counts.append(snap())
    assert counts[0] == counts[1]
    assert {s: n for s, n in counts[1][0].items() if n} == \
        {"ingest": 1, "gather": 1, "materialize": 1}
    assert counts[1][1]["gather"] == 70_000 + 70_144


def test_audit_floor_and_off_state():
    assert taudit.AUDIT_FLOOR == jaudit.AUDIT_FLOOR == 64 * 1024
    assert not taudit.enabled
    taudit.reset()
    buf = TIOBuf()
    buf.append(bytearray(200_000))
    buf.to_bytes()
    assert taudit.total_copies() == 0       # off: nothing counted
    with taudit.audit() as snap:
        buf.append(bytearray(100))          # under the floor
        assert taudit.total_copies() == 0
        buf.fetch(70_000)
        assert snap() == ({**{s: 0 for s in taudit.STAGES},
                           "materialize": 1},
                          {**{s: 0 for s in taudit.STAGES},
                           "materialize": 70_000})
    assert not taudit.enabled


def test_portal_reads_a_socket_like_jax():
    import socket
    a, b = socket.socketpair()
    try:
        payload = bytes(range(256)) * 700
        out = []
        for Portal in (JIOPortal, TIOPortal):
            b.sendall(payload)
            portal = Portal()
            while len(portal) < len(payload):
                assert portal.append_from_socket(a, 65536) > 0
            out.append(portal.to_bytes())
        assert out[0] == out[1] == payload
    finally:
        a.close()
        b.close()


def test_host_spill_is_audited_like_jax():
    """One page into the host tier: one ``spill_host`` copy of its
    bytes in both packages."""
    from brpc_tpu.kv.pages import HostPagePool as JPool
    from brpc_tpu_torch.kv.pages import HostPagePool as TPool
    page = np.random.default_rng(7).integers(
        0, 256, 128 * 1024, dtype=np.uint8)
    small = page[:1024]
    snaps = []
    for Pool, conv, audit in ((JPool, lambda x: x, jaudit),
                              (TPool, torch.from_numpy, taudit)):
        pool = Pool(4, 256 * 1024)
        with audit.audit() as snap:
            h = pool.stage(conv(page))
            h2 = pool.stage(conv(small))        # under the floor
            snaps.append(snap())
        assert h is not None and h2 is not None
    assert snaps[0] == snaps[1]
    assert snaps[1][0]["spill_host"] == 1
    assert snaps[1][1]["spill_host"] == 128 * 1024


def test_shm_staging_is_audited_like_jax():
    """One attachment staged into an shm ring slot: one ``stage_shm``
    copy in both packages."""
    from brpc_tpu.transport import shm_ring as jshm
    from brpc_tpu_torch.transport import shm_ring as tshm
    if not (jshm.shm_supported() and tshm.shm_supported()):
        pytest.skip("no tmpfs/mmap shm ring here")
    data = bytes(range(256)) * 512          # 128 KiB
    snaps = []
    for mod, audit in ((jshm, jaudit), (tshm, taudit)):
        ring = mod.ShmRing(256 * 1024, 2)
        try:
            slot = ring.alloc(owner=("req", 1))
            with audit.audit() as snap:
                off, n = ring.write(slot, data)
                snaps.append(snap())
            assert n == len(data)
            assert bytes(ring.view(off, n)) == data
            ring.free(slot)
        finally:
            ring.close()
    assert snaps[0] == snaps[1]
    assert snaps[1][0]["stage_shm"] == 1
    assert snaps[1][1]["stage_shm"] == len(data)
