"""Native C++ IO engine — build-on-demand loader.

The port's copy of ``brpc_tpu/native``.  The engine (``src/engine.cpp``,
the JAX package's source with its module names changed) runs epoll
loops, tpu_std frame cutting, HTTP/1.1 header scans and vectored writes
in C++ with the GIL released; Python is entered once per complete
message or once per read burst on the slim lanes.  It is a host engine:
it serves the CUDA model's RPCs, it launches nothing on the card.

``load()`` compiles the engine with g++ on first use and returns the
module, or None when no toolchain is available — the server then serves
through the Python transport, as the JAX package's does.

Two differences from the JAX loader, both for processes that build at
once (a test run under xdist starts several workers that each load the
engine): the library is named by a hash of the source, the Makefile,
the Python ABI and the variant (``_build/_native-<hash>.so``), so an
edited source builds anew and an unchanged one is reused, and the build
runs under an ``fcntl`` lock into a temporary name that ``os.replace``
moves into place, so no process loads a half-written library.  With
``BRPC_TPU_TORCH_NATIVE_ASAN=1`` in the environment the sanitizer build
(``make asan``) is loaded instead; the host python must then have
libasan preloaded.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from typing import Optional

from ..butil.logging_util import LOG

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCE = os.path.join(_DIR, "src", "engine.cpp")
ASAN_ENV = "BRPC_TPU_TORCH_NATIVE_ASAN"
_BUILD_TIMEOUT_S = 300
_lock = threading.Lock()
_module = None
_tried = False


def library_path(asan: bool = False) -> str:
    """The engine library this checkout loads: named by a hash of the
    source, the Makefile (its flags), the interpreter's ABI tag and the
    variant."""
    digest = hashlib.sha256()
    for path in (SOURCE, os.path.join(_DIR, "Makefile")):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update((sysconfig.get_config_var("SOABI") or sys.version)
                  .encode())
    digest.update(b"asan" if asan else b"release")
    stem = "_native_asan" if asan else "_native"
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(asan: bool = False) -> str:
    """Build the engine if this checkout has no library of its hash yet;
    returns the library's path.  Concurrent builders serialize on a file
    lock and the first one's library is the one every process loads."""
    so = library_path(asan)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a+") as lk:
        fcntl.flock(lk.fileno(), fcntl.LOCK_EX)
        try:
            if os.path.exists(so):
                return so      # another process built it while we waited
            tmp = f"{so}.{os.getpid()}.tmp"
            var = "ASAN_OUT" if asan else "OUT"
            LOG.info("building native engine (%s)...", os.path.basename(so))
            # the interpreter's own headers: python3-config may be
            # missing or name another python
            inc = sysconfig.get_paths()["include"]
            try:
                subprocess.run(
                    ["make", "-C", _DIR, f"{var}={tmp}",
                     f"PY_INCLUDES=-I{inc}"]
                    + (["asan"] if asan else []),
                    check=True, capture_output=True,
                    timeout=_BUILD_TIMEOUT_S)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lk.fileno(), fcntl.LOCK_UN)
    return so


def load() -> Optional[object]:
    """The compiled engine module, building it if needed (None if the
    build fails — callers fall back to the Python transport)."""
    global _module, _tried
    with _lock:
        if _module is not None or _tried:
            return _module
        _tried = True
        try:
            so = build(asan=os.environ.get(ASAN_ENV) == "1")
            spec = importlib.util.spec_from_file_location(
                "brpc_tpu_torch.native._native", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        except Exception as e:
            detail = getattr(e, "stderr", b"") or b""
            LOG.warning("native engine unavailable (%s %s); using the "
                        "Python transport", e,
                        detail[-2000:].decode("utf-8", "replace"))
            _module = None
        return _module


def available() -> bool:
    return load() is not None
