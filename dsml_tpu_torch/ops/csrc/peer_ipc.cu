// CUDA IPC helpers of the ring transport (dsml_tpu_torch/parallel/peer.py):
// no kernel, only the runtime calls that PyTorch does not expose.
//
// The ring's receive slots are allocated here with cudaMalloc, one
// allocation per slot, so that a slot's IPC handle maps exactly that slot in
// the neighbour's process (a handle maps its whole cudaMalloc block, and
// PyTorch's caching allocator would hand out a piece of a larger one; its
// expandable segments cannot be exported at all). The neighbour opens the
// handle once and keeps the mapping until the ring closes; it must close the
// mapping before the owner frees the slot. A process cannot open a handle of
// its own allocation, so a ring of one never comes here.
//
// Every call takes the device ordinal and sets it first: this library links
// its own copy of the CUDA runtime, whose current device is not PyTorch's.
//
// Interface: plain C, loaded with ctypes. Each function returns a
// cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <cstring>

extern "C" int peer_malloc(int device, size_t bytes, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaMalloc(ptr, bytes);
}

extern "C" int peer_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFree(ptr);
}

// handle: CUDA_IPC_HANDLE_SIZE (64) bytes out
extern "C" int peer_ipc_handle(int device, void* ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return err;
}

extern "C" int peer_ipc_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  // the owner may sit on another card of the host: map across NVLink/PCIe
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int peer_ipc_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaIpcCloseMemHandle(ptr);
}

// a stream-ordered device copy (either side may be peer-mapped)
extern "C" int peer_copy(int device, void* dst, const void* src, size_t bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault, static_cast<cudaStream_t>(stream));
}

extern "C" int peer_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

extern "C" const char* peer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
