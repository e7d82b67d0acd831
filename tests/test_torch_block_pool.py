"""The port's device block pool (``brpc_tpu_torch/ici/block_pool.py``)
beside the JAX package's, on the CPU: ``tests/test_ici.py``'s three pool
cases with ``device="cpu"``, the same seeded payload sequence through
both pools (equal landed bytes, ``recycled`` and ``pooled_bytes``), the
recycled storage's address held steady, the default pool's device rule,
and ``tests/test_iobuf.py``'s GC recycling case on the port's
``HostBlockPool``."""

import gc
import sys

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.ici.block_pool import DeviceBlockPool as JPool
from brpc_tpu_torch.butil.iobuf import HostBlockPool, IOBuf
from brpc_tpu_torch.ici import DeviceBlockPool, default_device_pool
from brpc_tpu_torch.ici.block_pool import DEFAULT_POOL_BYTES, DeviceBlock


def test_device_block_pool_recycles_storage():
    """Same-size landings reuse the same storage (``data_ptr`` steady, as
    ``unsafe_buffer_pointer`` is in the JAX case)."""
    pool = DeviceBlockPool(max_bytes=1 << 20, device="cpu")
    payload = np.arange(8192, dtype=np.uint8).tobytes()
    a1 = pool.land(payload)
    ptr1 = a1.data_ptr()
    assert a1.dtype == torch.uint8 and a1.device.type == "cpu"
    np.testing.assert_array_equal(a1.numpy(),
                                  np.frombuffer(payload, np.uint8))
    pool.recycle(a1)
    del a1
    a2 = pool.land(b"\xff" * 8192)
    assert pool.recycled == 1
    assert int(a2[0]) == 0xFF
    assert a2.data_ptr() == ptr1
    assert pool.pooled_bytes == 0


def test_device_block_pool_respects_cap():
    pool = DeviceBlockPool(max_bytes=100, device="cpu")
    a = pool.land(b"x" * 4096)
    pool.recycle(a)
    assert pool.pooled_bytes == 0
    b = pool.land(b"y" * 4096)
    assert pool.recycled == 0 and b.data_ptr() != 0


def test_device_block_iobuf_interface():
    """A DeviceBlock plugs into IOBuf, and its bytes are staged to the
    host only when read."""
    pool = DeviceBlockPool(device="cpu")
    blk = pool.allocate(64)
    assert isinstance(blk, DeviceBlock) and blk.capacity == 64
    assert blk.data._host is None
    buf = IOBuf()
    buf._append_ref(blk, 0, 64)
    buf._size = 64
    assert bytes(buf) == b"\x00" * 64
    assert blk.data._host is not None


def test_payload_sequence_equals_jax():
    """One seeded sequence of landings and recycles through both pools:
    equal bytes after every landing, equal counters at every step."""
    rng = np.random.default_rng(16)
    sizes = [4096, 8192, 4096, 300, 8192, 4096, 65536, 300]
    jp = JPool(max_bytes=20_000)
    tp = DeviceBlockPool(max_bytes=20_000, device="cpu")
    held = []
    for i, n in enumerate(sizes):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        ja, ta = jp.land(data), tp.land(data)
        assert np.asarray(ja).tobytes() == ta.numpy().tobytes() == data
        held.append((ja, ta))
        if i % 2:
            for ja, ta in held:
                jp.recycle(ja)
                tp.recycle(ta)
            held = []
        assert (jp.landed, jp.recycled, jp.pooled_bytes) == \
            (tp.landed, tp.recycled, tp.pooled_bytes)
    assert tp.recycled > 0 and tp.pooled_bytes > 0


def test_pool_device_rule():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceBlockPool()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device_pool()
    pool = default_device_pool("cpu")
    assert pool is default_device_pool(device="cpu")
    assert pool.device.type == "cpu" and pool.max_bytes == \
        DEFAULT_POOL_BYTES
    assert DeviceBlockPool(device="cpu").land(b"").numel() == 0


@pytest.mark.skipif(sys.version_info < (3, 12),
                    reason="recycling requires PEP-688 Block.__buffer__")
def test_host_block_pool_gc_recycling():
    """``tests/test_iobuf.py::test_block_pool_gc_recycling`` on the port's
    HostBlockPool: storage goes back only when the last reference
    dies."""
    pool = HostBlockPool(block_size=1024)
    blk = pool.allocate()
    assert blk.capacity == 1024
    data_id = id(blk.data)
    del blk
    gc.collect()
    blk2 = pool.allocate()
    assert pool.reused == 1
    assert id(blk2.data) == data_id


def test_jax_pool_is_jax():
    """The reference pool lands jax arrays (what the sequence case above
    compares against)."""
    a = JPool().land(b"ab")
    assert isinstance(a, jax.Array) and a.dtype == np.uint8
