"""The port's device ops against the JAX package's, on the CPU.

- ``checksum_u32``: equal to the JAX one (its Pallas kernel in interpret
  mode, as ``test_device_layer.py`` runs it) exactly, bit for bit, on
  every payload kind, including the dtype canonicalisation (8-byte dtypes
  narrow first, then every non-4-byte dtype widens to f32);
- ``embedding_bag``: equal to the JAX one within 1e-6 relative (a mean
  of the same f32 values, summed in another order), NaN rows included;
- ``tensor_bytes`` / ``bytes_to_tensor``: round trips, with the JAX
  package's dtype names and bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops import device_ops as jops
from brpc_tpu_torch.ops import device_ops as tops

RNG = np.random.default_rng(0)
_INT32 = RNG.integers(-2**31, 2**31, 8 * 128 * 3 + 5,
                      dtype=np.int64).astype(np.int32)
_F32 = np.arange(1000, dtype=np.float32)
_F32_BAD = _F32.copy()
_F32_BAD[500] = 123.0

# name -> numpy payload (bf16 is carried as its raw int16 words)
PAYLOADS = {
    "f32_arange": _F32,
    "f32_corrupted": _F32_BAD,
    "int32_random": _INT32,
    "int8": RNG.integers(-128, 128, 1000).astype(np.int8),
    "bool": RNG.integers(0, 2, 777).astype(bool),
    "uint8": RNG.integers(0, 256, 300).astype(np.uint8),
    "int16": RNG.integers(-2**15, 2**15, 300).astype(np.int16),
    "float16": RNG.normal(size=300).astype(np.float16),
    "np_int64": np.arange(5, dtype=np.int64),
    "np_int64_wide": np.array([2**40 + 3, -2**35 - 1], dtype=np.int64),
    "np_uint64": np.array([5, 2**63 + 7], dtype=np.uint64),
    "np_float64": RNG.normal(size=100),
    "scalar": np.float32(3.5),
    "empty": np.zeros((0,), np.float32),
    "non_contiguous": np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2],
}


def _jax_checksum(arr):
    return jops.checksum_u32(arr)


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_checksum_matches_jax(name):
    arr = PAYLOADS[name]
    want = _jax_checksum(arr)
    # a non-tensor lands on the device it is given, then is summed there
    assert tops.checksum_u32(arr, device="cpu") == want
    # a CPU tensor of the same values
    t = torch.from_numpy(np.array(arr))
    if name == "non_contiguous":
        t = torch.arange(24, dtype=torch.float32).reshape(4, 6)[:, ::2]
        assert not t.is_contiguous()
    assert tops.checksum_u32(t) == want
    assert tops.checksum_u32_plain(t) == want


def test_checksum_detects_corruption():
    assert tops.checksum_u32(PAYLOADS["f32_arange"], device="cpu") != \
        tops.checksum_u32(PAYLOADS["f32_corrupted"], device="cpu")


def test_checksum_bf16_matches_jax():
    x = jnp.asarray(RNG.normal(size=513), jnp.bfloat16)
    words = np.asarray(x).view(np.int16)
    t = torch.from_numpy(words.copy()).view(torch.bfloat16)
    assert tops.checksum_u32(t) == _jax_checksum(x)


def test_checksum_int32_wraps_like_jax():
    big = np.full(1000, 2**31 - 1, np.int32)      # sum wraps many times
    assert tops.checksum_u32(torch.from_numpy(big)) == _jax_checksum(big)
    assert tops.checksum_u32(torch.from_numpy(big)) == \
        (1000 * (2**31 - 1)) % 2**32


def test_checksum_rejects_complex():
    with pytest.raises(TypeError):
        tops.checksum_u32(torch.zeros(3, dtype=torch.complex64))


TABLE = np.arange(20, dtype=np.float32).reshape(10, 2)


@pytest.mark.parametrize("ids", [
    [[0, 1], [2, 2]],
    [[0, 12], [-1, 3]],             # out of range -> NaN row; -1 = last
    [[-10, 9], [-11, 4]],           # -10 wraps to row 0; -11 is NaN
])
def test_embedding_bag_matches_jax(ids):
    ids = np.array(ids, np.int32)
    want = np.asarray(jops.embedding_bag(jnp.asarray(TABLE), ids))
    got = tops.embedding_bag(torch.from_numpy(TABLE), ids).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)   # NaN == NaN here


def test_embedding_bag_random_matches_jax():
    table = RNG.normal(size=(64, 16)).astype(np.float32)
    ids = RNG.integers(0, 64, (8, 4)).astype(np.int32)
    want = np.asarray(jops.embedding_bag(jnp.asarray(table), ids))
    got = tops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "int8",
                                   "bool"])
def test_tensor_bytes_roundtrip(dtype):
    vals = RNG.normal(size=(3, 5)) * 10
    jx = jnp.asarray(vals.astype(np.float32)).astype(jnp.dtype(dtype))
    host = np.asarray(jx)
    t = tops.bytes_to_tensor(host.tobytes(), dtype, host.shape, device="cpu")
    data, name, shape = tops.tensor_bytes(t)
    # the port's wire name and bytes are the JAX package's
    assert name == str(host.dtype) == dtype
    assert shape == host.shape
    assert bytes(data) == host.tobytes()
    # and the JAX package lands the port's bytes on the same values
    back = jops.bytes_to_tensor(bytes(data), name, shape)
    assert back.dtype == host.dtype
    np.testing.assert_array_equal(back.view(np.uint8), host.view(np.uint8))
    if dtype != "bfloat16":        # the JAX package cannot stage bf16 bytes
        jdata, jname, jshape = jops.tensor_bytes(host)
        assert (bytes(jdata), jname, jshape) == (bytes(data), name, shape)
    assert torch.equal(tops.bytes_to_tensor(data, name, shape,
                                            device="cpu"), t)


def test_tensor_bytes_of_numpy_and_empty():
    arr = np.arange(6, dtype=np.int8).reshape(2, 3)
    data, name, shape = tops.tensor_bytes(arr)
    assert (bytes(data), name, shape) == (arr.tobytes(), "int8", (2, 3))
    empty = tops.bytes_to_tensor(b"", "float32", (0, 4), device="cpu")
    assert empty.shape == (0, 4) and empty.dtype == torch.float32
    with pytest.raises(ValueError):
        tops.bytes_to_tensor(b"abc", "float32", (1,), device="cpu")
    with pytest.raises(ValueError):
        tops.bytes_to_tensor(b"abcd", "complex7", (1,), device="cpu")
