"""The port's parameter-server service over RPC on the CPU, and across the
wire with the JAX package both ways.

- the port's version of ``test_device_layer.py::test_ps_service_over_rpc``,
  plus the service's error codes and NaN rows for ids out of range;
- a JAX Channel calls the port's ``PS.EchoTensor`` and ``PS.Lookup``, and
  a port Channel calls the JAX ``PSService``.  The two processes' fabrics
  never share a token, so every device attachment rides inline; values,
  dtypes and shapes must come back equal, and ``Lookup`` must equal the
  other framework's within 1e-6 relative (the same f32 mean, summed in
  another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.client import Channel as JChannel
from brpc_tpu.client import Controller as JController
from brpc_tpu.models import embedding_ps as jps
from brpc_tpu.models import ps_service as jsvc
from brpc_tpu.ops.device_ops import embedding_bag as jax_embedding_bag
from brpc_tpu.server import Server as JServer
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.client import Channel, Controller
from brpc_tpu_torch.models import embedding_ps as tps
from brpc_tpu_torch.models import ps_service as tsvc
from brpc_tpu_torch.server import Server
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=16, slots=4, hidden=32, classes=4)
TIMEOUT_MS = 30_000
RTOL = 1e-6
IDS = np.array([[1, 2, 3, 4], [60, 5, 6, 7], [0, 0, 63, 9]], np.int32)


def _call(ch, method, request=b"", device_att=None, attachment=b""):
    cntl = Controller()
    cntl.timeout_ms = TIMEOUT_MS
    cntl.request_device_attachment = device_att
    cntl.request_attachment = attachment
    return ch.call_method(method, request, cntl=cntl)


def _serve(svc, server_cls):
    srv = server_cls()
    assert srv.add_service(svc, name="PS") == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv


def test_ps_service_over_rpc():
    svc = tsvc.PSService(device="cpu")
    srv = _serve(svc, Server)
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        cfg = svc.model.cfg
        ids = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
        c = _call(ch, "PS.Lookup", tsvc.pack_ids(ids))
        assert not c.failed, c.error_text
        info = json.loads(c.response)
        att = c.response_device_attachment
        assert att is not None
        assert (att.dtype, list(att.shape)) == (info["dtype"], info["shape"])
        pooled = att.tensor("cpu")
        assert pooled.shape == (2, cfg.dim)
        torch.testing.assert_close(pooled, svc.model.lookup(ids), rtol=RTOL,
                                   atol=0)
        # train over RPC: labels as bytes, then as a device attachment
        labels = np.array([1, 2], np.int32)
        losses = []
        for dev in (False, True, True):
            c = _call(ch, "PS.Train", tsvc.pack_ids(ids),
                      device_att=torch.from_numpy(labels) if dev else None,
                      attachment=b"" if dev else labels.tobytes())
            assert not c.failed, c.error_text
            losses.append(json.loads(c.response)["loss"])
        assert losses[-1] < losses[0]
        c = _call(ch, "PS.Predict", tsvc.pack_ids(ids))
        assert json.loads(c.response) == {"dtype": "float32",
                                          "shape": [2, cfg.classes]}
        assert c.response_device_attachment.tensor("cpu").shape == \
            (2, cfg.classes)
        stat = json.loads(_call(ch, "PS.Stat").response)
        assert stat == {"vocab": cfg.vocab, "dim": cfg.dim,
                        "hidden": cfg.hidden, "classes": cfg.classes,
                        "sharded": False}
        ch.close()
    finally:
        srv.stop()


def test_ps_service_errors_and_bad_ids():
    svc = tsvc.PSService(tps.EmbeddingPS(tps.PSConfig(**CFG), device="cpu"))
    srv = _serve(svc, Server)
    try:
        ch = Channel()
        ch.init(str(srv.listen_endpoint))
        for method in ("PS.Lookup", "PS.Predict", "PS.Train"):
            c = _call(ch, method, b"\x01")
            assert c.error_code == Errno.EREQUEST, method
        c = _call(ch, "PS.EchoTensor")
        assert c.error_code == Errno.EREQUEST
        c = _call(ch, "PS.Train", tsvc.pack_ids(IDS),
                  attachment=np.zeros(2, np.int32).tobytes())
        assert c.error_code == Errno.EREQUEST
        assert "mismatch" in c.error_text
        # ids out of range give NaN rows, as jnp.take does; -1 is the last
        bad = np.array([[1, 999], [-1, 2]], np.int32)
        c = _call(ch, "PS.Lookup", tsvc.pack_ids(bad))
        assert not c.failed, c.error_text
        out = c.response_device_attachment.tensor("cpu")
        assert torch.isnan(out[0]).all() and torch.isfinite(out[1]).all()
        emb = svc.model.params["emb"]
        torch.testing.assert_close(out[1], (emb[-1] + emb[2]) / 2)
        assert not _call(ch, "PS.Stat").failed   # the server still serves
        ch.close()
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def twin_params():
    jp = jps.init_params(jax.random.PRNGKey(0), jps.PSConfig(**CFG))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def port_server(twin_params):
    model = tps.EmbeddingPS(tps.PSConfig(**CFG), device="cpu",
                            params=twin_params[1])
    srv = _serve(tsvc.PSService(model), Server)
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def jax_server(twin_params):
    model = jps.EmbeddingPS(jps.PSConfig(**CFG), seed=0)
    # a copy: the JAX train step donates the params it is given
    model.params = {k: jnp.array(v) for k, v in twin_params[0].items()}
    srv = _serve(jsvc.PSService(model), JServer)
    yield srv
    srv.stop()


ECHO_PAYLOADS = {
    "float32": np.arange(1000, dtype=np.float32).reshape(10, 100) / 7,
    "int32": np.arange(-50, 50, dtype=np.int32),
    "int8": np.arange(-64, 64, dtype=np.int8).reshape(2, 64),
    "bool": np.array([True, False, True]),
}


def _jax_call(ep, method, request, device_att=None):
    ch = JChannel()
    assert ch.init(str(ep)) == 0
    out = []
    for _ in range(2):            # the second call knows the peer's domain
        cntl = JController()
        cntl.timeout_ms = TIMEOUT_MS
        cntl.request_device_attachment = device_att
        c = ch.call_method(method, request, cntl=cntl)
        assert not c.failed, c.error_text
        out.append(c)
    return out


@pytest.mark.parametrize("dtype", sorted(ECHO_PAYLOADS))
def test_jax_channel_echoes_through_port(port_server, dtype):
    x = ECHO_PAYLOADS[dtype]
    for c in _jax_call(port_server.listen_endpoint, "PS.EchoTensor", b"",
                       jnp.asarray(x)):
        att = c.response_device_attachment
        assert not att.device_resident            # inline between frameworks
        got = np.asarray(att.tensor())
        assert got.dtype == x.dtype and got.shape == x.shape
        np.testing.assert_array_equal(got, x)


def test_jax_channel_looks_up_through_port(port_server, twin_params):
    want = np.asarray(jax_embedding_bag(twin_params[0]["emb"], IDS))
    for c in _jax_call(port_server.listen_endpoint, "PS.Lookup",
                       jsvc.pack_ids(IDS)):
        info = json.loads(c.response)
        got = np.asarray(c.response_device_attachment.tensor())
        assert info == {"dtype": "float32", "shape": [3, CFG["dim"]]}
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", sorted(ECHO_PAYLOADS))
def test_port_channel_echoes_through_jax(jax_server, dtype):
    x = torch.from_numpy(ECHO_PAYLOADS[dtype].copy())
    ch = Channel()
    ch.init(str(jax_server.listen_endpoint))
    for _ in range(2):
        c = _call(ch, "PS.EchoTensor", device_att=x)
        assert not c.failed, c.error_text
        att = c.response_device_attachment
        assert not att.device_resident
        got = att.tensor("cpu")
        assert got.dtype == x.dtype and torch.equal(got, x)
    ch.close()


def test_port_channel_looks_up_through_jax(jax_server, twin_params):
    model = tps.EmbeddingPS(tps.PSConfig(**CFG), device="cpu",
                            params=twin_params[1])
    want = model.lookup(IDS)
    ch = Channel()
    ch.init(str(jax_server.listen_endpoint))
    for _ in range(2):
        c = _call(ch, "PS.Lookup", tsvc.pack_ids(IDS))
        assert not c.failed, c.error_text
        assert json.loads(c.response) == {"dtype": "float32",
                                          "shape": [3, CFG["dim"]]}
        got = c.response_device_attachment.tensor("cpu")
        torch.testing.assert_close(got, want, rtol=RTOL, atol=0)
    # and the JAX server trains on labels the port sends as a tensor
    labels = torch.tensor([0, 1, 2], dtype=torch.int32)
    c = _call(ch, "PS.Train", tsvc.pack_ids(IDS), device_att=labels)
    assert not c.failed, c.error_text
    assert np.isfinite(json.loads(c.response)["loss"])
    ch.close()
