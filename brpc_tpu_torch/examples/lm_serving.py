"""LM serving — completions over the framework.

The port of ``examples/lm_serving.py``: starts an ``LMService``
(TransformerLM + KV-cache greedy decode, its default config: dim 64,
depth 2, max_seq 128), then a client requests completions over plain
RPC.  brpc_tpu labels its first request "compiles" and the rest "cached"
(XLA); nothing compiles here, but the first request builds the
libraries' state (cuBLAS handles on the card), so the labels are
"warm-up" and "warm".  The 12-token prompt is under the flash crossover,
so the model runs dense attention and launches no hand kernel.
:func:`serve` takes optional ``params`` (the tests pass brpc_tpu's own
``LMService`` draws); without them the service draws its own from a
seeded ``torch.Generator``.  Greedy decoding is deterministic, so the
three completions must be equal.

Run: ``python -m brpc_tpu_torch.examples.lm_serving --device cpu``
"""

from __future__ import annotations

import time

import numpy as np

from ..client import Channel, Controller
from ..models.lm_service import (LMService, pack_generate_request,
                                 unpack_generated)
from ..server import Server
from . import parse_args


def serve(device, params=None) -> list:
    """``LM.Info`` and three ``LM.Generate`` calls (a 12-token prompt, 16
    new tokens); the three generated id arrays."""
    srv = Server()
    srv.add_service(LMService(params=params, device=device), name="LM")
    assert srv.start("127.0.0.1:0") == 0
    ch = Channel()
    outs = []
    try:
        ch.init(str(srv.listen_endpoint))
        info = ch.call("LM.Info", b"")
        print("model:", info.decode())

        prompt = np.arange(12, dtype=np.int32).reshape(1, 12)
        for i in range(3):
            cntl = Controller()
            cntl.timeout_ms = 120_000
            t0 = time.perf_counter()
            c = ch.call_method("LM.Generate",
                               pack_generate_request(prompt, 16), cntl=cntl)
            dt = time.perf_counter() - t0
            assert not c.failed, c.error_text
            ids = unpack_generated(c.response)
            outs.append(ids)
            label = "warm-up" if i == 0 else "warm"
            print(f"request {i} ({label}): {dt*1e3:7.1f} ms  "
                  f"-> {ids[0][:8].tolist()}...")
    finally:
        ch.close()
        srv.stop()
    assert all(np.array_equal(o, outs[0]) for o in outs), \
        "greedy completions of one prompt differ"
    return outs


def main(argv=None) -> int:
    serve(parse_args(__doc__, argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
