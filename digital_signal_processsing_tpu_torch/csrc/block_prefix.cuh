// Per-channel prefix sums of an interleaved tile held in shared memory.
//
// Used by the cumsum's generic kernel (cumsum.cu); the other kernels take its
// helpers (kThreads, widen, allow_smem).
// A tile of `nf` frames by `C` channels sits in shared memory as uint32,
// frame-major: buf[f * C + c]. The frames are cut into S segments of R
// frames (the last may be shorter). Work item w = s * C + c walks one
// segment of one channel, so neighbouring threads read neighbouring words;
// the host picks R odd, which keeps the segment starts of one warp on
// distinct banks for C = 1 and C = 2.
//
// Three phases, each followed by __syncthreads() in the caller:
//   segment_sums     seg[c * S + s] = sum of the segment
//   segment_offsets  seg becomes the exclusive prefix over segments; each
//                    channel's total goes to the caller's `total`
//   segment_apply    buf becomes the inclusive per-channel prefix
//
// All sums are uint32, where wraparound is defined: the callers only use
// differences of prefixes (exact mod 2^32) or want the int32 modular prefix.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace dsp {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// Raises `kernel`'s dynamic shared-memory limit on the current device to
// `bytes` when it is below that, and not on every launch. `allowed` is the
// caller's per-kernel record of the limit set on each device.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int* allowed, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

static __device__ __forceinline__ uint32_t widen(int16_t v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}

static __device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

static __device__ void segment_sums(const uint32_t* buf, uint32_t* seg, int nf,
                                    int C, int R, int S) {
  for (int w = threadIdx.x; w < S * C; w += blockDim.x) {
    const int s = w / C;
    const int c = w - s * C;
    const int f1 = min(s * R + R, nf);
    uint32_t acc = 0;
    for (int f = s * R; f < f1; ++f) acc += buf[f * C + c];
    seg[c * S + s] = acc;
  }
}

// One warp per channel; total(c, sum) receives channel c's sum over the tile
// (from the warp's lane 0).
template <typename Total>
static __device__ void segment_offsets(uint32_t* seg, int C, int S, Total total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int c = warp; c < C; c += nwarps) {
    uint32_t run = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const uint32_t v = s < S ? seg[c * S + s] : 0u;
      const uint32_t incl = warp_inclusive_scan(v);
      if (s < S) seg[c * S + s] = run + incl - v;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) total(c, run);
  }
}

static __device__ void segment_apply(uint32_t* buf, const uint32_t* seg, int nf,
                                     int C, int R, int S) {
  for (int w = threadIdx.x; w < S * C; w += blockDim.x) {
    const int s = w / C;
    const int c = w - s * C;
    const int f1 = min(s * R + R, nf);
    uint32_t acc = seg[c * S + s];
    for (int f = s * R; f < f1; ++f) {
      acc += buf[f * C + c];
      buf[f * C + c] = acc;
    }
  }
}

}  // namespace dsp
