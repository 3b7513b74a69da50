// Ring put over peer device pointers (B6), the fused ring averager (B7), and
// the counters that order both against the neighbours' use of a buffer.
//
// Replaces digital_signal_processsing_tpu/parallel/ring_pallas.py
//   _ring_kernel (B6): a remote copy started and awaited inside the kernel,
//   each device pushing its buffer into its right neighbour's;
//   _fused_ring_windowed_kernel (B7): the windowed averager over a shard
//   whose grid starts the halo's remote copy at step 0, runs the interior
//   tiles while it flies and the halo tile last, after a semaphore wait.
//
// Buffers. Each rank cudaMalloc's one receive buffer a key (not PyTorch's
// caching allocator: it sub-allocates, and an IPC handle names the base of a
// whole allocation): a header of 64-bit counters, one 128-byte line each,
// then two slots. A rank maps its right neighbour's buffer once (CUDA IPC; a
// peer card's memory or the same card's) and writes into it through that
// mapping. parallel/ring_pallas.py lays the header out and numbers the calls.
//
// Ordering, on the device only (the TPU's DMA semaphores). Call N of a key
// uses slot (N - 1) % 2 on every rank. The sender waits until the receiver's
// consumed[slot] >= N - 2 (its read of the slot's last payload is done),
// puts, and publishes sent[slot] = N in the receiver's header with a release
// at system scope. The receiver waits until its sent[slot] >= N, reads the
// slot, and publishes consumed[slot] = N. A wait names the call it waits for,
// so it never binds to another call's signal, whatever order the hosts issue
// in. A stream waits by a stream memory operation (dsp_ring_wait,
// cuStreamWaitValue64: the host engine polls, the context holds no SM, and
// several contexts time-slicing one card go on running).
//
// ring_put_kernel (B6) stores a buffer into the right neighbour's slot, 16
// bytes a thread where both ends are 16-byte aligned (the ragged tail, or the
// whole buffer when the source is not aligned, a byte a thread); every block
// fences its stores and counts itself done, and the last one publishes sent.
// The receiver copies the slot out (ring_pallas.py): the put lands in memory
// the receiver owns and mapped once; its output tensor is new every call and
// could be mapped only by a host exchange each call.
//
// ring_windowed_kernel (B7) is B1's span kernel (run_tile.cuh) with the ring
// around it: block 0 first puts the shard's last H = k*C samples into the
// right neighbour's slot and publishes sent; blocks [0, interior_blocks) run
// B1's spans over the tiles whose window lies inside the shard; the last
// block runs the head tiles [0, head_tiles), whose windows reach before the
// shard, seeded from this rank's slot, and then publishes consumed. Where a
// halo arrives, the head is a launch of its own behind the stream's wait for
// sent (ring_pallas.py): a head block waiting inside the kernel held its
// context on a time-sliced card, and the put as a launch of its own before
// B1's was slower there too (tools/ab_ring.py times both).
//
// What bounds them on the H100: bytes. B6's function reads the shard once
// and writes it once (2 x its bytes); its design moves the bytes twice, the
// put across the link (NVLink's 450 GB/s each way across cards) and the
// copy out of the slot. B7's is B1's: 2 bytes in and 2 out a sample; the
// put is 2 bytes a sample of the halo.

#include <cstdint>
#include <cstring>

#include <cuda.h>
#include <cuda_runtime.h>

#include "run_tile.cuh"

namespace dsp {
namespace ring {

constexpr int kPutThreads = 256;
constexpr int64_t kPutMaxBlocks = 132 * 8;

static __device__ __forceinline__ void publish(unsigned long long* counter,
                                               unsigned long long value) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(counter), "l"(value) : "memory");
}

// B6. sent: the receiver's sent[slot] (through the mapping), published with
// `call` by the last block to finish, or null (a plain copy); done: this
// rank's count of the finished blocks of its put into this slot (a line a
// slot), zero between the slot's puts.
__global__ void __launch_bounds__(kPutThreads)
ring_put_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int64_t bytes,
                int64_t vec, unsigned long long* sent, unsigned long long call,
                unsigned int* done) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int64_t i = tid; i < vec; i += stride) d4[i] = s4[i];
  for (int64_t i = vec * 16 + tid; i < bytes; i += stride) dst[i] = src[i];
  if (sent == nullptr) return;
  __threadfence_system();  // this thread's stores before its block's count
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(done, 1u) == gridDim.x - 1) {
    __threadfence_system();  // every block's count, and so its stores, before sent
    *done = 0u;  // the slot's next put waits for the read of this one, after sent
    publish(sent, call);
  }
}

// B7's ring: the put (tail non-null) and the head block's release of the
// slot (consumed non-null).
struct RingArgs {
  const int16_t* tail;                 // the shard's last H samples
  int16_t* slot;                       // the right neighbour's slot, through the mapping
  unsigned long long* sent;            // the right neighbour's sent[slot], through the mapping
  unsigned long long* consumed;        // this rank's consumed[slot]
  unsigned long long call;
  int interior_blocks;  // blocks over tiles [first_tile, end_tile)
  int head_tiles;       // tiles [0, head_tiles) in the last block; 0: none
};

// Block 0's put of the tail: 16-byte stores where the tail is aligned (the
// slot always is), then sent.
static __device__ __forceinline__ void put_tail(const RingArgs& r, int halo) {
  int from = 0;
  if ((reinterpret_cast<uintptr_t>(r.tail) & 15u) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(r.tail);
    uint4* d4 = reinterpret_cast<uint4*>(r.slot);
    from = halo / 8 * 8;
    for (int i = threadIdx.x; i < halo / 8; i += blockDim.x) d4[i] = s4[i];
  }
  for (int i = from + threadIdx.x; i < halo; i += blockDim.x) r.slot[i] = r.tail[i];
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) publish(r.sent, r.call);
}

template <int C>
static __device__ __forceinline__ void span(const runs::Args& a, const runs::Span<true>& sp) {
  if constexpr (C == 0) {
    runs::scan_generic_span<runs::kHillisSteele, true>(a, sp);
  } else {
    runs::scan_span<runs::kHillisSteele, C, true>(a, sp);
  }
}

// C: B1's instance (1, 2, 4, 8, 16) or 0, the generic kernel. a.seed: this
// rank's slot, or null (rank 0: zeros before the shard).
template <int C>
__global__ void __launch_bounds__(kThreads, C >= 8 ? 3 : 4)
ring_windowed_kernel(runs::Args a, RingArgs r) {
  if (blockIdx.x == 0 && r.tail != nullptr) put_tail(r, a.halo);
  if (static_cast<int>(blockIdx.x) < r.interior_blocks) {
    span<C>(a, runs::span_of<true>(a, blockIdx.x));
    return;
  }
  if (r.head_tiles == 0) return;
  span<C>(a, runs::Span<true>(a, 0, r.head_tiles));
  if (r.consumed != nullptr) {
    __syncthreads();  // every read of the slot is done
    if (threadIdx.x == 0) publish(r.consumed, r.call);
  }
}

template <int C>
static runs::Launch launch_of() {
  static int allowed[kMaxDevices] = {};
  return {reinterpret_cast<const void*>(ring_windowed_kernel<C>), allowed};
}

static bool pick_c(int c, runs::Launch* out) {
  switch (c) {
    case 0: *out = launch_of<0>(); return true;
    case 1: *out = launch_of<1>(); return true;
    case 2: *out = launch_of<2>(); return true;
    case 4: *out = launch_of<4>(); return true;
    case 8: *out = launch_of<8>(); return true;
    case 16: *out = launch_of<16>(); return true;
    default: return false;
  }
}

// A driver entry point of the stream memory operations, through the runtime
// (the build links nothing new).
using StreamValue64 = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t, unsigned int);

static StreamValue64 driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess) {
    return nullptr;
  }
  return reinterpret_cast<StreamValue64>(fn);
}

}  // namespace ring
}  // namespace dsp

// B6: copy `bytes` from src (this process's memory) to dst (a mapped
// neighbour's slot, or local memory) on `stream`; with sent non-null, the
// last block publishes `call` there (done: this rank's zeroed block count).
extern "C" int dsp_ring_put(const void* src, void* dst, int64_t bytes, void* sent, int64_t call,
                            void* done, void* stream) {
  if (bytes < 0 || (sent != nullptr && (done == nullptr || call < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bytes == 0 && sent == nullptr) return static_cast<int>(cudaSuccess);
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
                        15u) == 0;
  const int64_t vec = aligned ? bytes / 16 : 0;
  const int64_t work = vec > 0 ? vec : bytes;
  int64_t blocks = (work + dsp::ring::kPutThreads - 1) / dsp::ring::kPutThreads;
  if (blocks > dsp::ring::kPutMaxBlocks) blocks = dsp::ring::kPutMaxBlocks;
  if (blocks < 1) blocks = 1;
  dsp::ring::ring_put_kernel<<<static_cast<unsigned>(blocks), dsp::ring::kPutThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), bytes, vec,
      static_cast<unsigned long long*>(sent), static_cast<unsigned long long>(call),
      static_cast<unsigned int*>(done));
  return static_cast<int>(cudaGetLastError());
}

// B7 over the n-sample shard x into y: B1's spans over tiles [interior_begin,
// interior_end) in blocks of span_tiles, then, in the last block, the head
// tiles [0, head_tiles) seeded from `seed` (this rank's slot, or null). With
// tail non-null, block 0 first puts the shard's last window * channels
// samples into `slot` and publishes `call` at `sent`; with consumed
// non-null, the head block publishes `call` there when it is done. kernel_c, nrun and
// smem_bytes as B1's geometry (ops/pallas_scan.py) gives them.
extern "C" int dsp_ring_windowed(const int16_t* x, int16_t* y, const int16_t* seed, int64_t n,
                                 int64_t window, int64_t channels, int64_t kernel_c, int64_t nrun,
                                 int64_t interior_begin, int64_t interior_end, int64_t span_tiles,
                                 int64_t head_tiles, int64_t smem_bytes, const int16_t* tail,
                                 int16_t* slot, void* sent, void* consumed,
                                 int64_t call, void* stream) {
  using namespace dsp;
  runs::Launch l;
  if (!ring::pick_c(static_cast<int>(kernel_c), &l)) return static_cast<int>(cudaErrorInvalidValue);
  runs::Args a;
  int err = runs::runs_args(&a, x, y, seed, n, window, channels, kernel_c, nrun, 0, -1, 1,
                            smem_bytes);
  if (err != 0) return err;
  const int64_t tiles = a.end_tile;
  if (head_tiles < 0 || head_tiles > interior_begin || interior_begin > interior_end ||
      interior_end > tiles || span_tiles < 1 || call < 1 ||
      (tail != nullptr && (slot == nullptr || sent == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t range = interior_end - interior_begin;
  a.first_tile = interior_begin;
  a.end_tile = interior_end;
  a.span_tiles = static_cast<int>(range > 0 && span_tiles > range ? range : span_tiles);
  ring::RingArgs r;
  r.tail = tail;
  r.slot = slot;
  r.sent = static_cast<unsigned long long*>(sent);
  r.consumed = static_cast<unsigned long long*>(consumed);
  r.call = static_cast<unsigned long long>(call);
  r.interior_blocks = static_cast<int>((range + a.span_tiles - 1) / a.span_tiles);
  r.head_tiles = static_cast<int>(head_tiles);
  int64_t blocks = r.interior_blocks + (head_tiles > 0 ? 1 : 0);
  if (blocks == 0 && tail != nullptr) blocks = 1;  // the put alone
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  cudaError_t e = allow_smem(l.kernel, l.allowed, static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a, &r};
  e = cudaLaunchKernel(l.kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
                       static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave B7's kernel for kernel_c: as dsp_windowed_attrs.
extern "C" int dsp_ring_windowed_attrs(int64_t kernel_c, int64_t smem_bytes, int64_t* out) {
  dsp::runs::Launch l;
  if (!dsp::ring::pick_c(static_cast<int>(kernel_c), &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dsp::runs::runs_attrs(l, smem_bytes, out);
}

// Whether the current card flushes remote writes after a stream wait
// (CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES) into *out; a cudaError_t.
extern "C" int dsp_ring_can_flush(int64_t* out) {
  int dev = 0, can = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&can, cudaDevAttrCanFlushRemoteWrites, dev);
  *out = can;
  return static_cast<int>(err);
}

// `stream` waits until the 64-bit counter at `counter` (this process's
// memory or a mapped neighbour's) is >= value: cuStreamWaitValue64. The
// neighbour's payload and then its sent arrive as remote writes, which the
// card may reorder; where the card can, the wait flushes them
// (CU_STREAM_WAIT_VALUE_FLUSH), so the work after it sees the payload.
// Returns the driver's CUresult, whose codes are the runtime's for the
// errors it gives here (invalid value, not supported, invalid handle).
extern "C" int dsp_ring_wait(void* counter, int64_t value, void* stream) {
  static const dsp::ring::StreamValue64 wait = dsp::ring::driver_entry("cuStreamWaitValue64");
  if (wait == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  int64_t flush = 0;
  const int err = dsp_ring_can_flush(&flush);
  if (err != 0) return err;
  const unsigned int flags = CU_STREAM_WAIT_VALUE_GEQ | (flush ? CU_STREAM_WAIT_VALUE_FLUSH : 0u);
  return static_cast<int>(wait(static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(counter),
                               static_cast<cuuint64_t>(value), flags));
}

// `stream` sets the counter to `value` once the work before it is done, with
// a fence before the write (cuStreamWriteValue64): a release.
extern "C" int dsp_ring_signal(void* counter, int64_t value, void* stream) {
  static const dsp::ring::StreamValue64 write = dsp::ring::driver_entry("cuStreamWriteValue64");
  if (write == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  return static_cast<int>(write(static_cast<CUstream>(stream),
                                reinterpret_cast<CUdeviceptr>(counter),
                                static_cast<cuuint64_t>(value), CU_STREAM_WRITE_VALUE_DEFAULT));
}

// A zeroed receive buffer of `bytes` and its IPC handle (64 bytes) in
// `handle`; the zeros are in place before this returns, ahead of any
// neighbour's put.
extern "C" int dsp_ring_alloc(int64_t bytes, void** ptr, char* handle) {
  *ptr = nullptr;
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
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
