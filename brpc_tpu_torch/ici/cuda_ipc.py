"""CUDA IPC: export a device tensor's allocation to another process on the
same card, and pull a peer's export into a fresh tensor.

The Python side of ``ops/csrc/ipc.cu`` (built by ``ops/cuda_build.py`` at
first use, loaded with ctypes), used by :class:`.fabric.CudaIpcFabric`.
Nothing falls back: without CUDA every entry raises, and a failed export,
open, wait or close raises with the CUDA error's name.  The
expandable-segments allocator (``PYTORCH_CUDA_ALLOC_CONF=
expandable_segments:True``) maps memory that ``cudaIpcGetMemHandle``
cannot export, so an export under it raises naming that setting.

An export is ``(mem_handle, offset, event_handle, event)``: the 64-byte
handle of the ``cudaMalloc`` block holding the tensor, the tensor's
offset in it, and an interprocess event recorded on the posting stream
(the producer's kernels come first), with its 64-byte handle.  The
poster destroys the event when the descriptor is released.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, NamedTuple

import torch

HANDLE_BYTES = 64                  # cudaIpcMemHandle_t, cudaIpcEventHandle_t

_u64 = ctypes.c_uint64
_buf = ctypes.POINTER(ctypes.c_char)          # a 64-byte output buffer
_lib = None
_lib_lock = threading.Lock()


def _ipc():
    """The loaded ``ipc.cu`` library, built at first use."""
    global _lib
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA IPC needs a CUDA card; CUDA is not "
                           "available here")
    with _lib_lock:
        if _lib is None:
            from ..ops import cuda_build
            lib = cuda_build.load("ipc.cu")
            sigs = {
                "ipc_export": [ctypes.c_int, _u64, _u64, _buf,
                               ctypes.POINTER(_u64), _buf,
                               ctypes.POINTER(_u64)],
                "ipc_event_destroy": [ctypes.c_int, _u64],
                "ipc_open": [ctypes.c_int, ctypes.c_char_p,
                             ctypes.POINTER(_u64)],
                "ipc_wait": [ctypes.c_int, ctypes.c_char_p, _u64],
                "ipc_close": [ctypes.c_int, _u64],
                "ipc_handle_bytes": []}
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            lib.ipc_error_string.restype = ctypes.c_char_p
            lib.ipc_error_string.argtypes = [ctypes.c_int]
            if lib.ipc_handle_bytes() != HANDLE_BYTES:
                raise RuntimeError("cudaIpcMemHandle_t is not 64 bytes")
            _lib = lib
    return _lib


def _check(code: int, what: str) -> None:
    if code != 0:
        name = _ipc().ipc_error_string(code).decode()
        raise RuntimeError(f"CUDA IPC {what} failed: {name} ({code})")


def _expandable_segments() -> bool:
    for var in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        conf = os.environ.get(var, "").replace(" ", "").lower()
        if "expandable_segments:true" in conf:
            return True
    return False


class Export(NamedTuple):
    mem_handle: bytes
    offset: int
    event_handle: bytes
    event: int
    device: int


def export(t: torch.Tensor) -> Export:
    """Export contiguous CUDA tensor ``t``'s memory, with an event recorded
    on its device's current stream.  The caller keeps ``t`` alive until
    the peer is done, then calls :func:`destroy_event`."""
    lib = _ipc()
    if not t.is_cuda or not t.is_contiguous():
        raise ValueError("CUDA IPC exports contiguous CUDA tensors")
    if _expandable_segments():
        raise RuntimeError(
            "CUDA IPC cannot export memory of the expandable-segments "
            "allocator: unset PYTORCH_CUDA_ALLOC_CONF=expandable_segments:"
            "True in the posting process")
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    mh = ctypes.create_string_buffer(HANDLE_BYTES)
    eh = ctypes.create_string_buffer(HANDLE_BYTES)
    offset, event = _u64(0), _u64(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(lib.ipc_export(dev, t.data_ptr(), stream, mh,
                          ctypes.byref(offset), eh, ctypes.byref(event)),
           "export")
    return Export(mh.raw, offset.value, eh.raw, event.value, dev)


def destroy_event(exp: Export) -> None:
    _check(_ipc().ipc_event_destroy(exp.device, exp.event), "event destroy")


class _CudaBytes:
    """A peer's mapped bytes as a ``__cuda_array_interface__`` object, for
    ``torch.as_tensor``."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


# open mappings of this process, by handle: a block mapped by two pulls
# at once is opened once (CUDA maps a handle once per context)
_maps: Dict[bytes, List[int]] = {}            # handle -> [base, users]
_maps_lock = threading.Lock()


def _open(device: int, mem_handle: bytes) -> int:
    with _maps_lock:
        m = _maps.get(mem_handle)
        if m is None:
            base = _u64(0)
            _check(_ipc().ipc_open(device, mem_handle, ctypes.byref(base)),
                   "open")
            m = _maps[mem_handle] = [base.value, 0]
        m[1] += 1
        return m[0]


def _close(device: int, mem_handle: bytes) -> None:
    with _maps_lock:
        m = _maps[mem_handle]
        m[1] -= 1
        if m[1]:
            return
        del _maps[mem_handle]
    _check(_ipc().ipc_close(device, m[0]), "close")


def pull(device: int, mem_handle: bytes, offset: int, event_handle: bytes,
         nbytes: int, dtype: torch.dtype, shape, out_device) -> torch.Tensor:
    """Copy a peer's exported tensor into a fresh tensor on
    ``out_device``: map the block on card ``device``, make the current
    stream wait on the peer's event, copy, finish the copy, unmap.  The
    caller owns the result; the peer may reuse its memory as soon as this
    returns."""
    lib = _ipc()
    stream = torch.cuda.current_stream(device)
    base = _open(device, mem_handle)
    try:
        _check(lib.ipc_wait(device, event_handle, stream.cuda_stream), "wait")
        out = torch.empty(tuple(shape), dtype=dtype, device=out_device)
        if nbytes:
            src = torch.as_tensor(_CudaBytes(base + offset, nbytes),
                                  device=torch.device("cuda", device))
            out.view(-1).view(torch.uint8).copy_(src)
        stream.synchronize()
    finally:
        _close(device, mem_handle)
    return out
