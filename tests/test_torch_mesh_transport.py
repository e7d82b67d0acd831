"""The port's MeshTransport (``brpc_tpu_torch/parallel/mesh_transport.py``)
against the JAX package's, on the CPU.

The port runs one process per rank (a gloo group of 2 or 4 ranks, one
pool per world size for the whole module); the JAX reference runs on a
mesh of as many of ``tests/conftest.py``'s virtual CPU devices.  Both get
the same numpy inputs; rank r's result is held to block r of the JAX
result along the sharded dim, or to the whole where JAX replicates it.
The collectives move f32 values without arithmetic or with one sum, so
results are held exactly (sums to 1e-6).

The gradient of each differentiable collective is held against
``jax.grad`` of its JAX twin (``shard_map(check_vma=False)``): ring_shift,
all_to_all, all_gather, psum and reduce_scatter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from brpc_tpu.parallel.mesh_transport import MeshTransport as JaxTransport
from brpc_tpu_torch.parallel import mesh_transport as mt
from brpc_tpu_torch.parallel.spmd import SpmdPool

import torch_spmd_cases as cases

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = SpmdPool(world, "cpu", str(
                tmp_path_factory.mktemp(f"pg{world}")), timeout_s=60)
        return made[world]

    yield get
    for pool in made.values():
        pool.close()


def _jax_transport(n):
    return JaxTransport(mesh=Mesh(np.array(jax.devices()[:n]), ("ici",)),
                        axis="ici")


def _blocks(a, n):
    return np.split(np.asarray(a), n, axis=0)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_scatter_gather(pools, world):
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    res = pools(world).run(cases.transport_ops, x,
                           np.zeros((world, world), np.float32))
    jt = _jax_transport(world)
    for r, out in enumerate(res):
        assert out["n_peers"] == world
        assert out["endpoint"] == str(jt.endpoint(r))
        np.testing.assert_array_equal(out["scatter"], _blocks(x, world)[r])
        np.testing.assert_array_equal(out["gather"],
                                      jt.gather(jt.scatter(x, axis=0)))
        np.testing.assert_array_equal(out["replicate"], x)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ring_shift(pools, world):
    x = np.arange(world * world, dtype=np.float32).reshape(world, world)
    res = pools(world).run(cases.transport_ops, x,
                           np.zeros((world, world), np.float32))
    jt = _jax_transport(world)
    xs = jt.scatter(x, axis=0)
    for steps in (1, 3):
        want = np.asarray(jt.ring_shift(xs, steps))
        np.testing.assert_array_equal(
            want, np.roll(x, steps, axis=0))
        for r, out in enumerate(res):
            np.testing.assert_array_equal(out[f"shift{steps}"],
                                          _blocks(want, world)[r])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_psum_allgather_reduce_scatter(pools, world):
    x = np.random.default_rng(0).normal(size=(world, 16)).astype(np.float32)
    res = pools(world).run(cases.transport_ops, x,
                           np.zeros((world, world), np.float32))
    jt = _jax_transport(world)
    xs = jt.scatter(x, axis=0)
    total = np.asarray(jt.psum(xs))                  # (1, 16) replicated
    ag = np.asarray(jt.all_gather(xs))               # (n, 16) replicated
    rs = np.asarray(jt.reduce_scatter(xs))           # (n, 16/n) by row
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["psum"], total, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out["all_gather"], ag)
        np.testing.assert_allclose(out["reduce_scatter"],
                                   _blocks(rs, world)[r], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_all_to_all(pools, world):
    a2a = np.arange(world * world * 2, dtype=np.float32).reshape(
        world, world * 2)
    res = pools(world).run(cases.transport_ops,
                           np.zeros((world, world), np.float32), a2a)
    jt = _jax_transport(world)
    want = np.asarray(jt.all_to_all(jt.scatter(a2a, axis=0), split_axis=1,
                                    concat_axis=0))
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["all_to_all"],
                                      _blocks(want, world)[r])


GRAD_CASES = [("psum", {}), ("all_gather", {}), ("reduce_scatter", {}),
              ("ring_shift", {"steps": 1}), ("ring_shift", {"steps": -3}),
              ("all_to_all", {"split_axis": 1, "concat_axis": 0})]


@pytest.mark.parametrize("name,kw", GRAD_CASES,
                         ids=[f"{n}{''.join(map(str, k.values()))}"
                              for n, k in GRAD_CASES])
def test_collective_grad_matches_jax(pools, name, kw):
    world = 4
    rng = np.random.default_rng(3)
    x = rng.normal(size=(world, 2 * world)).astype(np.float32)
    jt = _jax_transport(world)
    fn = getattr(jt, name)
    out_shape = fn(jt.scatter(x, axis=0), **kw).shape
    c = rng.normal(size=out_shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(fn(a, **kw) * c))(
        jt.scatter(x, axis=0)))
    got = pools(world).run(cases.collective_grad, name, x, c, kw)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g, _blocks(want, world)[r], rtol=1e-6,
                                   atol=1e-6)


def test_pvary_and_summed_gather_transpose(pools):
    """pvary's backward sums the ranks' cotangents (psum's transpose) and
    all_gather_sum_grad's reduce-scatters them (all_gather's), where the
    cotangents differ by rank."""
    world = 4
    rng = np.random.default_rng(4)
    x = rng.normal(size=(world, 3)).astype(np.float32)
    c = rng.normal(size=(world, 3)).astype(np.float32)
    got = pools(world).run(cases.transpose_pair, x, c)
    for r, (g_pvary, g_gather) in enumerate(got):
        np.testing.assert_allclose(g_pvary, c.sum(axis=0, keepdims=True),
                                   rtol=1e-6, atol=1e-6)
        # rank q weighs the gathered rows by q + 1: block r's cotangent
        # summed over the ranks is c[r] * (1 + 2 + ... + n)
        np.testing.assert_allclose(
            g_gather, c[r:r + 1] * world * (world + 1) / 2, rtol=1e-6,
            atol=1e-6)


def test_other_device_tensor_refused(pools):
    msgs = pools(2).run(cases.cuda_tensor_refused)
    assert all(m and "not staged across" in m for m in msgs), msgs


def test_cuda_by_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.default_mesh("ici")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.MeshTransport()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.backend_for("cuda")
    assert mt.backend_for("cpu") == "gloo"
