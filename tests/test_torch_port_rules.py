"""The port stands alone: it imports neither ``jax`` nor any module of
``brpc_tpu``, and its entry points never fall back to the CPU on their
own."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "brpc_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "lanes_ab.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "brpc_tpu" or name.startswith("brpc_tpu."))


_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "brpc_tpu" or name.startswith("brpc_tpu."):
            raise ImportError("the port must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
import brpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(brpc_tpu_torch.__path__,
                                               "brpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "brpc_tpu" or m.startswith("brpc_tpu.")
       or m == "jax" and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def test_imports_with_jax_and_brpc_tpu_blocked():
    n_modules = len(list(pkgutil.walk_packages([PKG], "brpc_tpu_torch.")))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == n_modules >= 73
    names = {m.name for m in pkgutil.walk_packages([PKG], "brpc_tpu_torch.")}
    assert {"brpc_tpu_torch.utils.checkpoint",
            "brpc_tpu_torch.models.transformer_lm",
            "brpc_tpu_torch.models.moe",
            "brpc_tpu_torch.ops.flash_attention",
            "brpc_tpu_torch.ops.device_ops",
            "brpc_tpu_torch.butil.flags",
            "brpc_tpu_torch.transport.socket",
            "brpc_tpu_torch.transport.shm_ring",
            "brpc_tpu_torch.ici.cuda_ipc",
            "brpc_tpu_torch.ici.attachment",
            "brpc_tpu_torch.ici.fabric",
            "brpc_tpu_torch.ici.endpoint",
            "brpc_tpu_torch.models.embedding_ps",
            "brpc_tpu_torch.models.ps_service",
            "brpc_tpu_torch.streaming",
            "brpc_tpu_torch.protocol.streaming",
            "brpc_tpu_torch.server.admission",
            "brpc_tpu_torch.models.lm_telemetry",
            "brpc_tpu_torch.kv",
            "brpc_tpu_torch.kv.pages",
            "brpc_tpu_torch.kv.transport",
            "brpc_tpu_torch.kv.disagg",
            "brpc_tpu_torch.parallel",
            "brpc_tpu_torch.parallel.mesh_transport",
            "brpc_tpu_torch.parallel.spmd",
            "brpc_tpu_torch.parallel.ring_attention",
            "brpc_tpu_torch.parallel.pipeline",
            "brpc_tpu_torch.parallel.multiproc_dryrun",
            "brpc_tpu_torch.profiling",
            "brpc_tpu_torch.butil.fast_rand",
            "brpc_tpu_torch.butil.time_utils",
            "brpc_tpu_torch.butil.logging_util",
            "brpc_tpu_torch.butil.flat_map",
            "brpc_tpu_torch.rpcz",
            "brpc_tpu_torch.rpcz_stitch",
            "brpc_tpu_torch.server.method_status"} <= names
    assert set(_CLIENT_ENGINE_MODULES) <= names
    assert {f"brpc_tpu_torch.bvar.{m}" for m in _BVAR_MODULES} <= names
    assert set(_CLUSTER_MODULES) <= names


_BVAR_MODULES = ("variable", "reducer", "sampler", "window", "percentile",
                 "latency_recorder", "passive_status", "multi_dimension",
                 "collector", "trend", "prometheus", "default_variables",
                 "dump")

_IMPORT_ONE = r"""
import importlib, importlib.abc, sys
sys.modules["jax"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "brpc_tpu" or name.startswith("brpc_tpu."):
            raise ImportError("the port must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
importlib.import_module(sys.argv[1])
print("imported", sys.argv[1])
"""


# the cluster client, the fiber runtime and the fleet plane
_CLUSTER_MODULES = (
    "brpc_tpu_torch.butil.extension",
    "brpc_tpu_torch.butil.doubly_buffered",
    "brpc_tpu_torch.butil.work_stealing_queue",
    "brpc_tpu_torch.fiber",
    "brpc_tpu_torch.fiber.runtime",
    "brpc_tpu_torch.fiber.timer_thread",
    "brpc_tpu_torch.client.naming_service",
    "brpc_tpu_torch.policy.naming",
    "brpc_tpu_torch.policy.remote_naming",
    "brpc_tpu_torch.client.circuit_breaker",
    "brpc_tpu_torch.client.load_balancer",
    "brpc_tpu_torch.policy.load_balancers",
    "brpc_tpu_torch.client.load_balancer_with_naming",
    "brpc_tpu_torch.client.parallel_channel",
    "brpc_tpu_torch.client.partition_channel",
    "brpc_tpu_torch.fleet",
)


@pytest.mark.parametrize("module", ["brpc_tpu_torch.bvar",
                                    "brpc_tpu_torch.rpcz",
                                    "brpc_tpu_torch.rpcz_stitch",
                                    *_CLUSTER_MODULES])
def test_observability_imports_alone_with_jax_and_brpc_tpu_blocked(module):
    """The observability framework, the cluster client and the fleet
    plane stand on their own: each of their entry modules imports in a
    fresh interpreter with ``jax`` and every ``brpc_tpu`` module
    refused."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["imported", module]


# the HTTP/1.1, h2/gRPC and builtin-portal lanes
_HTTP_MODULES = (
    "brpc_tpu_torch.butil.copy_audit",
    "brpc_tpu_torch.butil.iobuf",
    "brpc_tpu_torch.fiber.butex",
    "brpc_tpu_torch.protocol.base",
    "brpc_tpu_torch.transport.input_messenger",
    "brpc_tpu_torch.protocol.compress",
    "brpc_tpu_torch.protocol.json2pb",
    "brpc_tpu_torch.protocol.http",
    "brpc_tpu_torch.server.interceptors",
    "brpc_tpu_torch.server.http_dispatch",
    "brpc_tpu_torch.server.builtin",
    "brpc_tpu_torch.protocol.hpack_tables",
    "brpc_tpu_torch.protocol.hpack",
    "brpc_tpu_torch.protocol.h2_session",
    "brpc_tpu_torch.protocol.h2_rpc",
    "brpc_tpu_torch.client.grpc_client",
)


@pytest.mark.parametrize("module", _HTTP_MODULES)
def test_http_lanes_import_alone_with_jax_and_brpc_tpu_blocked(module):
    """Each module of the HTTP, h2/gRPC and portal lanes imports in a
    fresh interpreter with ``jax`` and every ``brpc_tpu`` module
    refused, and its source names neither package in any import (nor
    in an ``import_module`` string)."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["imported", module]
    rel = module.replace(".", os.sep)
    path = os.path.join(ROOT, rel + ".py")
    if not os.path.exists(path):
        path = os.path.join(ROOT, rel, "__init__.py")
    with open(path) as f:
        src = f.read()
    import re
    assert not re.search(r"^\s*(from|import)\s+(jax|brpc_tpu)(\.|\s|$)",
                         src, re.M), path
    assert not re.search(r"import_module\(\s*[\"'](jax|brpc_tpu)[\"'.]",
                         src), path


# the native engine's client half: the socket map, the health check,
# the client completion lane and the fast lane
_CLIENT_ENGINE_MODULES = (
    "brpc_tpu_torch.transport.socket_map",
    "brpc_tpu_torch.transport.health_check",
    "brpc_tpu_torch.transport.client_lane",
    "brpc_tpu_torch.client.fast_call",
)


@pytest.mark.parametrize("module", _CLIENT_ENGINE_MODULES)
def test_client_engine_modules_import_alone_with_jax_and_brpc_tpu_blocked(
        module):
    """Each module of the engine's client half imports in a fresh
    interpreter with ``jax`` and every ``brpc_tpu`` module refused, and
    its source names neither package in any import."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["imported", module]
    with open(os.path.join(ROOT, module.replace(".", os.sep) + ".py")) as f:
        src = f.read()
    import re
    assert not re.search(r"^\s*(from|import)\s+(jax|brpc_tpu)(\.|\s|$)",
                         src, re.M), module


# the butil leaves, versioned ids and the execution queue, the block pool
_LEAF_MODULES = (
    "brpc_tpu_torch.butil",
    "brpc_tpu_torch.butil.crc32c",
    "brpc_tpu_torch.butil.resource_pool",
    "brpc_tpu_torch.butil.simple_data_pool",
    "brpc_tpu_torch.butil.periodic_task",
    "brpc_tpu_torch.butil.sanitizers",
    "brpc_tpu_torch.fiber.versioned_id",
    "brpc_tpu_torch.fiber.execution_queue",
    "brpc_tpu_torch.ici.block_pool",
)


@pytest.mark.parametrize("module", _LEAF_MODULES)
def test_leaf_modules_import_alone_with_jax_and_brpc_tpu_blocked(module):
    """Each of the leaves, the call-id and queue modules and the device
    block pool imports in a fresh interpreter with ``jax`` and every
    ``brpc_tpu`` module refused, and its source names neither package in
    any import."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["imported", module]
    rel = module.replace(".", os.sep)
    path = os.path.join(ROOT, rel + ".py")
    if not os.path.exists(path):
        path = os.path.join(ROOT, rel, "__init__.py")
    with open(path) as f:
        src = f.read()
    import re
    assert not re.search(r"^\s*(from|import)\s+(jax|brpc_tpu)(\.|\s|$)",
                         src, re.M), path


def test_block_pool_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    from brpc_tpu_torch.ici import DeviceBlockPool, default_device_pool
    for call in (DeviceBlockPool, default_device_pool,
                 lambda: DeviceBlockPool(max_bytes=1 << 20, device="cuda:0"),
                 lambda: default_device_pool("cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the CPU is served only when asked for
    assert DeviceBlockPool(device="cpu").device.type == "cpu"
    assert default_device_pool("cpu").land(b"ab").tolist() == [97, 98]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_brpc_tpu_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    from brpc_tpu_torch.models.lm_service import LMService
    from brpc_tpu_torch.models.transformer_lm import (LMConfig, init_params,
                                                      make_decode,
                                                      make_scan_generator)
    from brpc_tpu_torch.utils.convert import params_from_numpy
    cfg = LMConfig(vocab=16, dim=8, heads=2, depth=1, max_seq=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMService(cfg=cfg, device="cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_decode(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_scan_generator(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({})
    # the CPU is served only when asked for
    assert LMService(cfg=cfg, device="cpu").device.type == "cpu"


def test_training_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    from brpc_tpu_torch.models.transformer_lm import (LMConfig, make_forward,
                                                      make_train_step,
                                                      make_value_and_grad)
    from brpc_tpu_torch.utils.checkpoint import TensorSpec, TrainCheckpointer
    cfg = LMConfig(vocab=16, dim=8, heads=2, depth=1, max_seq=8,
                   use_flash=True)
    for fn in (make_forward, make_train_step, make_value_and_grad):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(cfg)
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.restore(like={"w": TensorSpec((2,), torch.float32, "cuda:0")})
    # the CPU is served only when asked for
    assert make_train_step(cfg, device="cpu") is not None
    assert ckpt.restore(like={"w": TensorSpec((2,), torch.float32,
                                              "cpu")})["w"].device.type == "cpu"


def test_ps_and_lane_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    import numpy as np
    from brpc_tpu_torch.ici.attachment import KIND_INLINE, DeviceAttachment
    from brpc_tpu_torch.models.embedding_ps import EmbeddingPS, PSConfig
    from brpc_tpu_torch.models.ps_service import PSService
    from brpc_tpu_torch.ops.device_ops import bytes_to_tensor, checksum_u32
    cfg = PSConfig(vocab=8, dim=4, slots=2, hidden=4, classes=2)
    att = DeviceAttachment(KIND_INLINE, 0, 4, "float32", (1,),
                           host_bytes=b"\0\0\0\0")
    for call in (EmbeddingPS, lambda: EmbeddingPS(cfg), PSService,
                 lambda: checksum_u32(np.arange(4, dtype=np.float32)),
                 att.tensor,
                 lambda: bytes_to_tensor(b"\0" * 4, "float32", (1,))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the CPU is served only when asked for
    assert EmbeddingPS(cfg, device="cpu").device.type == "cpu"
    assert PSService(EmbeddingPS(cfg, device="cpu")).model.cfg == cfg
    assert checksum_u32(np.arange(4, dtype=np.float32), device="cpu") == \
        checksum_u32(torch.arange(4, dtype=torch.float32))
    assert att.tensor("cpu").device.type == "cpu"


def test_parallel_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    from brpc_tpu_torch.parallel import (MeshTransport, default_mesh,
                                         global_mesh_transport, make_mesh)
    from brpc_tpu_torch.parallel.multiproc_dryrun import (dryrun_multichip,
                                                          run)
    from brpc_tpu_torch.parallel.spmd import SpmdPool, init_world, run_spmd
    init = str(tmp_path / "rendezvous")
    for call in (default_mesh, MeshTransport, global_mesh_transport,
                 lambda: make_mesh((1,), ("ici",)),
                 lambda: init_world(0, 1, init_file=init),
                 lambda: SpmdPool(1, init_dir=str(tmp_path)),
                 lambda: run_spmd(print, 1, init_dir=str(tmp_path)),
                 lambda: dryrun_multichip(1), lambda: run(2, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # nothing was spawned and no group was made on the way
    assert not torch.distributed.is_initialized()
    assert list(tmp_path.iterdir()) == []


def test_cpu_checksum_runs_plain_and_launches_nothing():
    from brpc_tpu_torch.ops import device_ops
    before = device_ops.CHECKSUM.launches
    x = torch.arange(1000, dtype=torch.float32)
    assert device_ops.checksum_u32(x) == device_ops.checksum_u32_plain(x)
    assert device_ops.CHECKSUM.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        device_ops.CHECKSUM(x.view(torch.int32))
    assert device_ops.CHECKSUM.launches == before


def test_decode_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    from brpc_tpu_torch.models.lm_service import ContinuousBatcher, LMService
    from brpc_tpu_torch.models.transformer_lm import (LMConfig,
                                                      empty_batch_cache,
                                                      make_batch_decode,
                                                      make_decode_loop)
    cfg = LMConfig(vocab=16, dim=8, heads=2, depth=1, max_seq=8)
    for call in (lambda: make_batch_decode(cfg),
                 lambda: make_batch_decode(cfg, chunk=4),
                 lambda: empty_batch_cache(cfg, 2),
                 lambda: make_decode_loop(cfg, 2),
                 lambda: ContinuousBatcher(cfg, None),
                 lambda: LMService(cfg=cfg, decode_slots=2),
                 lambda: LMService(cfg=cfg, decode_slots=2,
                                   prefill_chunk_tokens=4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the CPU is served only when asked for, and the service's batcher
    # lands where the service does
    svc = LMService(cfg=cfg, decode_slots=2, device="cpu")
    assert svc.batcher().device.type == "cpu"
    assert empty_batch_cache(cfg, 2, device="cpu")["len"].device.type \
        == "cpu"
    assert len(make_batch_decode(cfg, chunk=4, device="cpu")) == 3


def test_paged_decode_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    from brpc_tpu_torch.models.lm_service import ContinuousBatcher, LMService
    from brpc_tpu_torch.models.transformer_lm import (LMConfig,
                                                      empty_paged_cache,
                                                      make_paged_batch_decode,
                                                      make_paged_io,
                                                      make_paged_spec_verify)
    cfg = LMConfig(vocab=16, dim=8, heads=2, depth=1, max_seq=8)
    for call in (lambda: make_paged_batch_decode(cfg, 4),
                 lambda: make_paged_io(cfg, 4),
                 lambda: make_paged_io(cfg, 4, chunk=4),
                 lambda: make_paged_spec_verify(cfg, 4, 4),
                 lambda: empty_paged_cache(cfg, 3, 2, 4),
                 lambda: ContinuousBatcher(cfg, None, paged=True, page=4),
                 lambda: LMService(cfg=cfg, decode_slots=2, paged=True,
                                   page=4),
                 lambda: LMService(cfg=cfg, decode_slots=2, paged=True,
                                   page=4, spec_decode_k=3, draft_params={})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the CPU is served only when asked for, and the paged batcher lands
    # where the service does
    svc = LMService(cfg=cfg, decode_slots=2, paged=True, page=4,
                    device="cpu")
    bat = svc.batcher()
    assert bat.paged and bat.device.type == "cpu" and bat.num_pages == 5
    assert empty_paged_cache(cfg, 3, 2, 4, device="cpu")["pk0"].device.type \
        == "cpu"


def test_disagg_entry_points_raise_without_cuda():
    """A prefill tier and a decode tier's service need ``device="cpu"``
    on a host without CUDA; asked for, both tiers land on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    from brpc_tpu_torch.kv import DecodeTierService, PrefillService
    from brpc_tpu_torch.models.lm_service import LMService
    from brpc_tpu_torch.models.transformer_lm import LMConfig
    cfg = LMConfig(vocab=16, dim=8, heads=2, depth=1, max_seq=8)
    for call in (lambda: PrefillService(cfg=cfg),
                 lambda: PrefillService(cfg=cfg, device="cuda:0",
                                        fallback_local=False),
                 lambda: DecodeTierService(LMService(cfg=cfg,
                                                     decode_slots=2))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    pre = PrefillService(cfg=cfg, device="cpu")
    dec = LMService(cfg=cfg, device="cpu", decode_slots=2, paged=True,
                    page=4)
    assert pre.device.type == dec.device.type == "cpu"
    assert DecodeTierService(dec).lm.batcher().device.type == "cpu"
    assert pre.model_fingerprint() == dec.model_fingerprint()


def test_transfer_fabric_entry_points_raise_without_cuda():
    """The CUDA IPC fabric's entry points raise on a host without CUDA,
    and with ``ici_transfer_enabled`` on such a host has no transfer
    fabric (its device attachments to other processes go inline)."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without")
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.ici import cuda_ipc, fabric
    fab = fabric.CudaIpcFabric()
    assert not fab.supported()
    blob = fabric.ExportBlob(fabric.ipc_address(b"h", b"GPU-0"), b"\0" * 64,
                             0, b"\0" * 64, "float32", (4,))
    for call in (fab.start,
                 lambda: fab.post(torch.ones(4), 16),
                 lambda: cuda_ipc.export(torch.ones(4)),
                 lambda: cuda_ipc.pull(0, b"\0" * 64, 0, b"\0" * 64, 16,
                                       torch.float32, (4,), "cpu")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="cannot map"):
        fab.redeem(blob, 1)
    assert fab.live_descriptors == 0 and fab.address == b""
    fabric.set_transfer_fabric(None)
    assert set_flag("ici_transfer_enabled", True)
    try:
        assert fabric.transfer_fabric() is None
        assert fabric.transfer_ready() is None
        assert b"@" not in fabric.local_domain_id()
    finally:
        assert set_flag("ici_transfer_enabled", False)
        fabric.set_transfer_fabric(None)


# the native engine's loader and the lanes that serve through it
_NATIVE_MODULES = (
    "brpc_tpu_torch.native",
    "brpc_tpu_torch.transport.native_bridge",
    "brpc_tpu_torch.server.rpc_dispatch",
    "brpc_tpu_torch.server.slim_dispatch",
    "brpc_tpu_torch.server.http_slim",
    "brpc_tpu_torch.server.stream_slim",
)


@pytest.mark.parametrize("module", _NATIVE_MODULES)
def test_native_modules_import_alone_with_jax_and_brpc_tpu_blocked(module):
    """Each module of the native engine's server half imports in a fresh
    interpreter with ``jax`` and every ``brpc_tpu`` module refused, and
    its source names neither package in any import."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["imported", module]
    rel = module.replace(".", os.sep)
    path = os.path.join(ROOT, rel + ".py")
    if not os.path.exists(path):
        path = os.path.join(ROOT, rel, "__init__.py")
    with open(path) as f:
        src = f.read()
    import re
    assert not re.search(r"^\s*(from|import)\s+(jax|brpc_tpu)(\.|\s|$)",
                         src, re.M), path


def test_engine_source_differs_from_jax_only_in_module_names():
    """The port's engine.cpp is the JAX package's with the module's names
    changed: the tool path in one comment, the module docstring and the
    three type names.  The JAX file is read as text."""
    def lines(*parts):
        with open(os.path.join(ROOT, *parts, "src", "engine.cpp")) as f:
            return f.read().split("\n")

    jax_src = lines("brpc_tpu", "native")
    port_src = lines("brpc_tpu_torch", "native")
    assert len(jax_src) == len(port_src)
    diff = {i + 1: (a, b) for i, (a, b) in enumerate(zip(jax_src, port_src))
            if a != b}
    assert set(diff) == {224, 6668, 6675, 6684, 6693}, sorted(diff)
    for n in (6675, 6684, 6693):
        a, b = diff[n]
        assert b == a.replace('"brpc_tpu.native.', '"brpc_tpu_torch.native.')
    assert diff[6668][1] == diff[6668][0].replace(
        "for brpc_tpu (", "for brpc_tpu_torch (")
    assert "tests/test_torch_native_engine.py" in diff[224][1]


_BUILD_ONE = r"""
import os, sys
import brpc_tpu_torch.native as native
tmp = sys.argv[1]
native._DIR = tmp
native.SOURCE = os.path.join(tmp, "src", "engine.cpp")
native.BUILD_DIR = os.path.join(tmp, "_build")
mod = native.load()
assert mod is not None, "the engine did not load"
print(os.path.realpath(mod.__file__))
"""


def test_two_processes_build_the_engine_at_once(tmp_path):
    """Two processes that find no library of the engine's hash build at
    once: the file lock lets one build, both load the same library, and
    no temporary file is left behind."""
    import shutil
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no C++ toolchain")
    src = os.path.join(PKG, "native")
    os.makedirs(tmp_path / "src")
    shutil.copy(os.path.join(src, "Makefile"), tmp_path / "Makefile")
    shutil.copy(os.path.join(src, "src", "engine.cpp"),
                tmp_path / "src" / "engine.cpp")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE,
                               str(tmp_path)], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.split()[-1] for out, _ in outs}
    assert len(paths) == 1
    built = sorted(os.listdir(tmp_path / "_build"))
    assert built == [".lock", os.path.basename(paths.pop())]


# the Python transport on the event dispatcher, and the ecosystem
# protocols on the one port
_DISPATCHER_MODULES = (
    "brpc_tpu_torch.transport.event_dispatcher",
    "brpc_tpu_torch.transport.acceptor",
    "brpc_tpu_torch.transport.socket",
    "brpc_tpu_torch.protocol.tpu_std",
    "brpc_tpu_torch.protocol.streaming",
    "brpc_tpu_torch.protocol.resp",
    "brpc_tpu_torch.protocol.thrift_proto",
    "brpc_tpu_torch.client.redis_client",
    "brpc_tpu_torch.client.memcache_client",
    "brpc_tpu_torch.server.server",
)


@pytest.mark.parametrize("module", _DISPATCHER_MODULES)
def test_dispatcher_modules_import_alone_with_jax_and_brpc_tpu_blocked(
        module):
    """Each module of the dispatcher-driven transport and of the RESP,
    thrift, redis and memcache twins imports in a fresh interpreter with
    ``jax`` and every ``brpc_tpu`` module refused, and its source names
    neither package in any import."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["imported", module]
    with open(os.path.join(ROOT, module.replace(".", os.sep) + ".py")) as f:
        src = f.read()
    import re
    assert not re.search(r"^\s*(from|import)\s+(jax|brpc_tpu)(\.|\s|$)",
                         src, re.M), module


# the operability and tooling layer: the tools, the static checks and hot
# restart
_TOOLS_MODULES = (
    "brpc_tpu_torch.tools",
    "brpc_tpu_torch.tools.rpc_view",
    "brpc_tpu_torch.tools.rpc_dump",
    "brpc_tpu_torch.tools.rpc_replay",
    "brpc_tpu_torch.tools.rpc_press",
    "brpc_tpu_torch.tools.parallel_http",
    "brpc_tpu_torch.tools.trace_dump",
    "brpc_tpu_torch.tools.fleet_dump",
    "brpc_tpu_torch.tools.perf_guard",
    "brpc_tpu_torch.tools.check",
    "brpc_tpu_torch.tools.check.base",
    "brpc_tpu_torch.tools.check.cppscan",
    "brpc_tpu_torch.tools.check.contracts",
    "brpc_tpu_torch.tools.check.lanes",
    "brpc_tpu_torch.tools.check.enums",
    "brpc_tpu_torch.tools.check.blocking",
    "brpc_tpu_torch.tools.check.__main__",
    "brpc_tpu_torch.server.hot_restart",
    "brpc_tpu_torch.trackme",
)


@pytest.mark.parametrize("module", _TOOLS_MODULES)
def test_tools_and_hot_restart_import_alone_with_jax_and_brpc_tpu_blocked(
        module):
    """Each tool, each analyzer of the static checks and the hot-restart
    handoff imports in a fresh interpreter with ``jax`` and every
    ``brpc_tpu`` module refused, and its source names neither package in
    any import."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["imported", module]
    rel = module.replace(".", os.sep)
    path = os.path.join(ROOT, rel + ".py")
    if not os.path.exists(path):
        path = os.path.join(ROOT, rel, "__init__.py")
    with open(path) as f:
        src = f.read()
    import re
    assert not re.search(r"^\s*(from|import)\s+(jax|brpc_tpu)(\.|\s|$)",
                         src, re.M), path


def test_every_jax_tool_and_hot_restart_has_a_twin():
    """Every module of ``brpc_tpu/tools/``, ``brpc_tpu/tools/check/``
    (``run_all.sh`` too) and ``brpc_tpu/server/hot_restart.py`` has a twin
    at the same relative path in the port."""
    jax_root = os.path.join(ROOT, "brpc_tpu")
    rels = ["server/hot_restart.py"]
    for sub in ("tools", "tools/check"):
        rels += [f"{sub}/{f}" for f in os.listdir(os.path.join(jax_root, sub))
                 if f.endswith((".py", ".sh"))]
    missing = [r for r in rels if not os.path.exists(os.path.join(PKG, r))]
    assert len(rels) == 19 and not missing, missing
