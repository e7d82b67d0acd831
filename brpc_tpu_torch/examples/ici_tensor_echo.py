"""Device-resident tensor echo — this framework's rdma_performance
analogue (≈ reference example/rdma_performance).

The port of ``examples/ici_tensor_echo.py``: a 1 MiB float32 tensor on
the device rides an RPC as a DEVICE attachment (a descriptor on the
wire, the payload through the in-process fabric with window/ack flow
control) to ``PSService.EchoTensor`` and back.  As in brpc_tpu the echo
hands back the very tensor that was posted (``out is x``: no copy on the
device).  One addition: every call checksums the payload before the send
and after the landing (``ops.device_ops.checksum_u32``, the
``checksum.cu`` kernel on a CUDA tensor: two launches a call) and the
sums must agree.  The GB/s line times the echoes alone, not the
checksums.  ``PSService()`` builds its default ``EmbeddingPS`` on the
device, as brpc_tpu's does.

Run: ``python -m brpc_tpu_torch.examples.ici_tensor_echo --device cpu``
"""

from __future__ import annotations

import time

import torch

from ..client import Channel, Controller
from ..models.ps_service import PSService
from ..ops.device_ops import checksum_u32
from ..server import Server
from . import parse_args


def echo(channel: Channel, x: torch.Tensor, device) -> tuple:
    """One EchoTensor call: (the landed tensor, seconds of the echo)."""
    t0 = time.perf_counter()
    cntl = Controller()
    cntl.timeout_ms = 30_000
    cntl.request_device_attachment = x
    c = channel.call_method("PS.EchoTensor", b"", cntl=cntl)
    assert not c.failed, c.error_text
    out = c.response_device_attachment.tensor(device)
    return out, time.perf_counter() - t0


def checked_echo(channel: Channel, x: torch.Tensor, device) -> tuple:
    before = checksum_u32(x)
    out, dt = echo(channel, x, device)
    after = checksum_u32(out)
    assert before == after, f"checksum {before:#010x} -> {after:#010x}"
    return out, dt


def main(argv=None) -> int:
    dev = parse_args(__doc__, argv).device
    server = Server()
    server.add_service(PSService(device=dev), name="PS")
    assert server.start("127.0.0.1:0") == 0

    channel = Channel()
    try:
        channel.init(str(server.listen_endpoint))

        x = torch.arange((1 << 20) // 4, dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        nbytes = x.numel() * x.element_size()
        print(f"backend={dev.type} tensor={nbytes} bytes")

        # warm (the first exchange handshakes the fabric domain)
        for _ in range(3):
            out, _ = checked_echo(channel, x, dev)

        n = 100
        dt = 0.0
        for _ in range(n):
            out, t = checked_echo(channel, x, dev)
            dt += t
        assert out is x, "device path should be zero-copy end to end"
        print(f"{n} echoes of {nbytes} bytes: "
              f"{n * nbytes * 2 / dt / 1e9:.2f} GB/s device-resident")
    finally:
        channel.close()
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
