"""Operational tools -- load generation, traffic capture and replay,
portal viewing, the bench-regression gate and the static checks.

The port of ``brpc_tpu/tools/`` (≈ brpc's tools/ rpc_press, rpc_replay,
rpc_view, parallel_http and src/brpc/rpc_dump.h): the press drives the
client's fast lane, dumps are raw tpu_std frames (replayable bytes, no
intermediate format, read alike by both packages), and the viewer reads
the builtin portal.  Each module runs as ``python -m
brpc_tpu_torch.tools.<name>``.

Submodules import lazily (PEP 562): the server's dump hook must not pull
the whole client stack in at dispatch time.
"""

_EXPORTS = {
    "Press": "rpc_press", "PressOptions": "rpc_press",
    "DumpReader": "rpc_dump", "dump_enabled": "rpc_dump",
    "maybe_dump_request": "rpc_dump", "close_dump": "rpc_dump",
    "Replayer": "rpc_replay", "ReplayOptions": "rpc_replay",
    "fetch": "rpc_view",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
