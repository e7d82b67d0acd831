"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``ops/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``; so is ``ipc.cu``, the CUDA IPC interface of the transfer
fabric, which launches no kernel.  Libraries land in ``ops/_build/`` (listed in ``.gitignore``),
named by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header builds anew and an unchanged one is
reused.  Nothing is built at import: the first launch builds, and
:func:`build_all` builds every source at once (one ``nvcc`` per source,
all started together).  A failed build raises; there is no fallback.  :class:`CudaKernel` binds one C entry point of a
library and counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "checksum.cu", "ipc.cu")
# link flags of one source: the CUDA IPC interface also calls the driver
# API (cuMemGetAddressRange)
LINK_FLAGS = {"ipc.cu": ["-lcuda"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by source
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def _lib_path(source: str) -> str:
    """The library of ``source``, named by a hash of the source, of every
    ``csrc/*.cuh`` header (any source may include any of them) and of the
    flags."""
    digest = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    digest.update(" ".join(_flags(source)).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _flags(source: str) -> List[str]:
    link = LINK_FLAGS.get(source, [])
    if "-lcuda" in link:
        # the driver library to link against is the toolkit's stub; the
        # loader finds the driver's own libcuda.so.1 at run time
        stubs = os.path.join(os.path.dirname(os.path.dirname(nvcc_path())),
                             "lib64", "stubs")
        if os.path.isdir(stubs):
            link = [f"-L{stubs}", *link]
    return NVCC_FLAGS + link


def _start(source: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *_flags(source), "-o", tmp,
           os.path.join(CSRC, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(source: str, out: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[source] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(f"{out}.{os.getpid()}.tmp", out)


def build_all(sources: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every kernel source that has no current library, one
    ``nvcc`` process per source, all running together.  Returns
    ``{source: library path}``; raises on the first failed build."""
    sources = list(sources or SOURCES)
    with _lock:
        paths = {src: _lib_path(src) for src in sources}
        procs = {src: _start(src, paths[src]) for src in sources
                 if not os.path.isfile(paths[src])}
        errors = []
        for src, proc in procs.items():
            try:
                _finish(src, paths[src], proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    path = build_all([source])[source]
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(path)
    return lib


class CudaKernel:
    """ctypes binding of one C entry point of a ``csrc/`` library, with its
    launch count: it adds one where it launches, and nowhere else (under a
    lock: a prefill tier launches from one thread per connection)."""

    def __init__(self, name: str, source: str, argtypes: list):
        self.name = name
        self.source = source
        self.launches = 0
        self._count_lock = threading.Lock()
        self._argtypes = argtypes
        self._fn = None

    def _launch(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.name)
            fn.restype = ctypes.c_int
            fn.argtypes = self._argtypes
            err = getattr(lib, os.path.splitext(self.source)[0]
                          + "_error_string")
            err.restype = ctypes.c_char_p
            err.argtypes = [ctypes.c_int]
            self._err = err
            self._fn = fn
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{self._err(code).decode()} ({code})")
        with self._count_lock:
            self.launches += 1
