// Ring put over peer device pointers (B6), and the buffers and events it
// moves through.
//
// Replaces digital_signal_processsing_tpu/parallel/ring_pallas.py
//   _ring_kernel (B6): a remote copy started and awaited inside the kernel,
//   each device pushing its buffer into its right neighbour's.
//
// ring_put_kernel stores a rank's buffer straight into its right neighbour's
// receive buffer through a device pointer that names the neighbour's memory:
// a CUDA IPC mapping of the neighbour's allocation (the same card or a peer
// card), or the rank's own buffer at world size 1. Stores are 16 bytes a
// thread where both ends are 16-byte aligned, and the ragged tail (or the
// whole buffer, when a source is not aligned) moves a byte a thread.
//
// The receive buffers are cudaMalloc'ed here, not by PyTorch's caching
// allocator: that allocator sub-allocates its blocks, and an IPC handle names
// the base of a whole allocation. The host side (parallel/ring_pallas.py)
// exchanges the handles once per buffer key, opens the neighbour's, and
// orders a put against the neighbour's use with interprocess events: the
// sender records "sent" after its put, the receiver's stream waits on it, and
// the receiver records "consumed" after its last read, which the sender's
// stream waits on before the put that reuses the buffer.
//
// What bounds it on the H100: bytes. A put reads the buffer once and writes
// it once, 2 x its bytes at the card's copy rate on one card (NVLink's 450
// GB/s each way across cards, not measured here).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace dsp {

constexpr int kRingThreads = 256;
constexpr int64_t kRingMaxBlocks = 132 * 8;

__global__ void __launch_bounds__(kRingThreads)
ring_put_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int64_t bytes,
                int64_t vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int64_t i = tid; i < vec; i += stride) d4[i] = s4[i];
  for (int64_t i = vec * 16 + tid; i < bytes; i += stride) dst[i] = src[i];
}

}  // namespace dsp

// Copy `bytes` from src (this process's memory) to dst (a mapped neighbour's
// receive buffer, or local memory) on `stream`.
extern "C" int dsp_ring_put(const void* src, void* dst, int64_t bytes, void* stream) {
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes == 0) return static_cast<int>(cudaSuccess);
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
                        15u) == 0;
  const int64_t vec = aligned ? bytes / 16 : 0;
  const int64_t work = vec > 0 ? vec : bytes;
  int64_t blocks = (work + dsp::kRingThreads - 1) / dsp::kRingThreads;
  if (blocks > dsp::kRingMaxBlocks) blocks = dsp::kRingMaxBlocks;
  dsp::ring_put_kernel<<<static_cast<unsigned>(blocks), dsp::kRingThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), bytes, vec);
  return static_cast<int>(cudaGetLastError());
}

// A zeroed receive buffer of `bytes` and its IPC handle (64 bytes) in `handle`.
extern "C" int dsp_ring_alloc(int64_t bytes, void** ptr, char* handle) {
  *ptr = nullptr;
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::memcpy(handle, &h, sizeof(h));
  return static_cast<int>(cudaSuccess);
}

extern "C" int dsp_ring_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// Map another process's receive buffer into this one.
extern "C" int dsp_ring_open(const char* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  *ptr = nullptr;
  return static_cast<int>(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int dsp_ring_close(void* ptr) { return static_cast<int>(cudaIpcCloseMemHandle(ptr)); }

// An interprocess event (no timing) and its IPC handle (64 bytes).
extern "C" int dsp_ring_event(void** event, char* handle) {
  cudaEvent_t ev = nullptr;
  cudaError_t err =
      cudaEventCreateWithFlags(&ev, cudaEventInterprocess | cudaEventDisableTiming);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcEventHandle_t h;
  err = cudaIpcGetEventHandle(&h, ev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::memcpy(handle, &h, sizeof(h));
  *event = ev;
  return static_cast<int>(cudaSuccess);
}

extern "C" int dsp_ring_event_open(const char* handle, void** event) {
  cudaIpcEventHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  cudaEvent_t ev = nullptr;
  cudaError_t err = cudaIpcOpenEventHandle(&ev, h);
  *event = ev;
  return static_cast<int>(err);
}

extern "C" int dsp_ring_event_destroy(void* event) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(event)));
}

extern "C" int dsp_ring_record(void* event, void* stream) {
  return static_cast<int>(
      cudaEventRecord(static_cast<cudaEvent_t>(event), static_cast<cudaStream_t>(stream)));
}

// Make `stream` wait for the work before the event's latest record.
extern "C" int dsp_ring_wait(void* stream, void* event) {
  return static_cast<int>(cudaStreamWaitEvent(static_cast<cudaStream_t>(stream),
                                              static_cast<cudaEvent_t>(event), 0));
}
