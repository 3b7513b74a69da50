// Per-channel inclusive cumsum of an interleaved int16 stream, int32 modular
// (B4).
//
// Replaces digital_signal_processsing_tpu/ops/pallas_scan.py _cumsum_kernel.
//
// y[f*C + c] = sum_{f' <= f} x[f'*C + c]  mod 2^32, read as int32.
//
// The TPU kernel walks its grid in order and carries a row of sums in VMEM
// scratch. CUDA blocks run in no order, so the carry takes three launches:
//   1. cumsum_totals_kernel  per block, per channel totals of its tile;
//   2. cumsum_carry_kernel   one block per channel scans those totals
//                            (exclusive) in place;
//   3. cumsum_apply_kernel   each block scans its tile (block_prefix.cuh)
//                            starting from its channel carries.
// All sums are uint32, so wraparound is defined and matches int32 modular
// arithmetic bit for bit.
//
// What bounds it on the H100: memory bytes. The stream is read twice (2
// bytes a sample each time) and the int32 prefix written once (4 bytes);
// the totals are C words a block. A single-pass decoupled look-back would
// read the stream once.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"

namespace dsp {

static __device__ void load_tile(const int16_t* __restrict__ x, uint32_t* buf,
                                 int64_t t0, int64_t n, int T) {
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    const int64_t g = t0 + j;
    buf[j] = g < n ? widen(x[g]) : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
cumsum_totals_kernel(const int16_t* __restrict__ x, uint32_t* __restrict__ totals,
                     int64_t n, int C, int tf, int R, int S) {
  extern __shared__ uint32_t smem[];
  const int T = tf * C;
  uint32_t* buf = smem;
  uint32_t* seg = smem + T;
  load_tile(x, buf, static_cast<int64_t>(blockIdx.x) * T, n, T);
  __syncthreads();
  segment_sums(buf, seg, tf, C, R, S);
  __syncthreads();
  segment_offsets(seg, C, S, nullptr, totals + static_cast<int64_t>(blockIdx.x) * C);
}

// Block c scans totals[b*C + c] over b, exclusive, in place.
__global__ void __launch_bounds__(kThreads)
cumsum_carry_kernel(uint32_t* __restrict__ totals, int64_t blocks, int C) {
  __shared__ uint32_t warp_sums[32];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t run = 0;
  for (int64_t b0 = 0; b0 < blocks; b0 += blockDim.x) {
    const int64_t b = b0 + threadIdx.x;
    const uint32_t v = b < blocks ? totals[b * C + c] : 0u;
    const uint32_t incl = warp_inclusive_scan(v);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const uint32_t ws = lane < nwarps ? warp_sums[lane] : 0u;
      warp_sums[lane] = warp_inclusive_scan(ws);
    }
    __syncthreads();
    const uint32_t before = warp > 0 ? warp_sums[warp - 1] : 0u;
    if (b < blocks) totals[b * C + c] = run + before + incl - v;
    run += warp_sums[nwarps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
}

__global__ void __launch_bounds__(kThreads)
cumsum_apply_kernel(const int16_t* __restrict__ x, int32_t* __restrict__ y,
                    const uint32_t* __restrict__ carry, int64_t n, int C, int tf, int R,
                    int S) {
  extern __shared__ uint32_t smem[];
  const int T = tf * C;
  uint32_t* buf = smem;
  uint32_t* seg = smem + T;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * T;
  load_tile(x, buf, t0, n, T);
  __syncthreads();
  segment_sums(buf, seg, tf, C, R, S);
  __syncthreads();
  segment_offsets(seg, C, S, carry + static_cast<int64_t>(blockIdx.x) * C, nullptr);
  __syncthreads();
  segment_apply(buf, seg, tf, C, R, S);
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int64_t g = t0 + t;
    if (g >= n) break;
    y[g] = static_cast<int32_t>(buf[t]);
  }
}

}  // namespace dsp

// totals: scratch of (blocks * channels) words, blocks = ceil(n / (tile_frames * channels)).
extern "C" int dsp_cumsum_i16(const int16_t* x, int32_t* y, int32_t* totals, int64_t n,
                              int64_t channels, int64_t tile_frames, int64_t seg_frames,
                              int64_t segs, int64_t smem_bytes, void* stream) {
  const int64_t tile = tile_frames * channels;
  const int64_t blocks = (n + tile - 1) / tile;
  if (blocks <= 0 || blocks > 0x7fffffff || channels > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int C = static_cast<int>(channels);
  const int tf = static_cast<int>(tile_frames);
  const int R = static_cast<int>(seg_frames);
  const int S = static_cast<int>(segs);
  const auto smem = static_cast<size_t>(smem_bytes);
  auto* tot = reinterpret_cast<uint32_t*>(totals);
  static int allowed_totals[dsp::kMaxDevices] = {};
  static int allowed_apply[dsp::kMaxDevices] = {};
  cudaError_t err;
  if ((err = dsp::allow_smem(dsp::cumsum_totals_kernel, allowed_totals,
                             static_cast<int>(smem_bytes))) != cudaSuccess ||
      (err = dsp::allow_smem(dsp::cumsum_apply_kernel, allowed_apply,
                             static_cast<int>(smem_bytes))) != cudaSuccess) {
    return static_cast<int>(err);
  }
  dsp::cumsum_totals_kernel<<<static_cast<unsigned>(blocks), dsp::kThreads, smem, s>>>(
      x, tot, n, C, tf, R, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dsp::cumsum_carry_kernel<<<static_cast<unsigned>(C), dsp::kThreads, 0, s>>>(tot, blocks, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dsp::cumsum_apply_kernel<<<static_cast<unsigned>(blocks), dsp::kThreads, smem, s>>>(
      x, y, tot, n, C, tf, R, S);
  return static_cast<int>(cudaGetLastError());
}
