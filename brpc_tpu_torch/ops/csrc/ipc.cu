// CUDA IPC for the cross-process transfer fabric, bound through a plain C
// interface (ctypes) by brpc_tpu_torch/ici/cuda_ipc.py.
//
// Not a kernel: nothing here launches one.  It is the port's counterpart
// of the PJRT transfer server behind the JAX package's `JaxTransferFabric`
// (brpc_tpu/ici/fabric.py:234-339): a process posting a device tensor
// exports the allocation that holds it, and a peer process on the same
// card maps it and copies the tensor out.
//
//   ipc_export  the cudaIpcMemHandle_t of the allocation holding `ptr`
//               and `ptr`'s offset in it, plus an interprocess event
//               recorded on `stream` and its handle.  PyTorch's caching
//               allocator hands out pieces of larger cudaMalloc blocks, so
//               the base comes from cuMemGetAddressRange.
//   ipc_open    the device pointer of a peer's handle (lazy peer access).
//   ipc_wait    make `stream` wait on a peer's event: the producer's
//               kernels that wrote the tensor come before any read of it.
//   ipc_close / ipc_event_destroy   drop a mapping or an exported event.
//
// Every entry returns 0 or an error code; ipc_error_string names it
// (cudaGetErrorName, or cuGetErrorName for a driver call's code, which is
// offset by DRIVER_BASE).  Device pointers, streams and events cross the
// interface as 64-bit integers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int DRIVER_BASE = 1 << 20;

int rt(cudaError_t e) { return e == cudaSuccess ? 0 : (int)e; }
int drv(CUresult r) { return r == CUDA_SUCCESS ? 0 : DRIVER_BASE + (int)r; }

}  // namespace

extern "C" {

const char* ipc_error_string(int code) {
  if (code >= DRIVER_BASE) {
    const char* name = nullptr;
    if (cuGetErrorName((CUresult)(code - DRIVER_BASE), &name) != CUDA_SUCCESS
        || name == nullptr)
      return "unknown CUDA driver error";
    return name;
  }
  return cudaGetErrorName((cudaError_t)code);
}

int ipc_export(int device, uint64_t ptr, uint64_t stream,
               unsigned char* mem_handle, uint64_t* offset,
               unsigned char* event_handle, uint64_t* event) {
  int err = rt(cudaSetDevice(device));
  if (err) return err;
  CUdeviceptr base = 0;
  size_t size = 0;
  err = drv(cuMemGetAddressRange(&base, &size, (CUdeviceptr)ptr));
  if (err) return err;
  cudaIpcMemHandle_t mh;
  err = rt(cudaIpcGetMemHandle(&mh, (void*)base));
  if (err) return err;
  cudaEvent_t ev;
  err = rt(cudaEventCreateWithFlags(
      &ev, cudaEventInterprocess | cudaEventDisableTiming));
  if (err) return err;
  cudaIpcEventHandle_t eh;
  err = rt(cudaEventRecord(ev, (cudaStream_t)stream));
  if (!err) err = rt(cudaIpcGetEventHandle(&eh, ev));
  if (err) {
    cudaEventDestroy(ev);
    return err;
  }
  memcpy(mem_handle, &mh, sizeof(mh));
  memcpy(event_handle, &eh, sizeof(eh));
  *offset = ptr - (uint64_t)base;
  *event = (uint64_t)ev;
  return 0;
}

int ipc_event_destroy(int device, uint64_t event) {
  int err = rt(cudaSetDevice(device));
  return err ? err : rt(cudaEventDestroy((cudaEvent_t)event));
}

int ipc_open(int device, const unsigned char* mem_handle, uint64_t* base) {
  int err = rt(cudaSetDevice(device));
  if (err) return err;
  cudaIpcMemHandle_t mh;
  memcpy(&mh, mem_handle, sizeof(mh));
  void* p = nullptr;
  err = rt(cudaIpcOpenMemHandle(&p, mh, cudaIpcMemLazyEnablePeerAccess));
  if (err) return err;
  *base = (uint64_t)p;
  return 0;
}

int ipc_wait(int device, const unsigned char* event_handle, uint64_t stream) {
  int err = rt(cudaSetDevice(device));
  if (err) return err;
  cudaIpcEventHandle_t eh;
  memcpy(&eh, event_handle, sizeof(eh));
  cudaEvent_t ev;
  err = rt(cudaIpcOpenEventHandle(&ev, eh));
  if (err) return err;
  err = rt(cudaStreamWaitEvent((cudaStream_t)stream, ev, 0));
  // the wait is enqueued: the local handle can go
  int err2 = rt(cudaEventDestroy(ev));
  return err ? err : err2;
}

int ipc_close(int device, uint64_t base) {
  int err = rt(cudaSetDevice(device));
  return err ? err : rt(cudaIpcCloseMemHandle((void*)base));
}

int ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

}  // extern "C"
