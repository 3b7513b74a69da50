// Direct moving averager over an interleaved int16 stream (B5): the window
// sum as k shifted adds, k <= 256.
//
// Replaces digital_signal_processsing_tpu/ops/pallas_direct.py _direct_kernel,
// the reference's shared-memory tiled averager (profilable_sm_averager.cu:14-45).
//
// out[i] = trunc( sum_{j=0..k-1} x[i - j*C] / k ),  x[<0] = 0.
//
// Each block owns a tile of T = tf*C output samples starting at a frame
// boundary and stages [tile - (k-1)*C, tile end) into shared memory as int32,
// zeros before the stream and past its end. The TPU kernel took that halo
// from the previous tile in VMEM scratch; here every block re-reads it from
// global memory, so blocks need no carry and run in any order. Each thread
// sums k values an output in int32, exact because 256 * 32768 < 2^31.
//
// What bounds the work on the H100: at 2 bytes in and 2 out a sample, memory
// bytes bound it only for a window of a few tens or less; beyond that the k
// adds a sample do. At 64M samples that is 0.080 ms by bytes (3.35 TB/s)
// against 0.086 ms by int32 adds at k=64 and 0.342 ms at k=256 (a clock of
// an SM adds 192: 64 lanes of IADD3 at two adds, 64 of IMAD at one; 132 SMs
// at 1.98 GHz). What limits this design is nearer: each tap is one
// shared-memory load, 32 words a clock an SM, so 0.51 ms at k=64 and 2.05 ms
// at k=256. The loads are conflict-free (neighbouring threads read
// neighbouring words); reusing loaded values across outputs in registers is
// a later step.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"

namespace dsp {

__global__ void __launch_bounds__(kThreads)
direct_kernel(const int16_t* __restrict__ x, int16_t* __restrict__ y, int64_t n, int window,
              int C, int tf) {
  extern __shared__ int32_t buf[];
  const int T = tf * C;
  const int L = (window - 1) * C;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * T;
  const int64_t start = t0 - L;
  for (int j = threadIdx.x; j < L + T; j += blockDim.x) {
    const int64_t g = start + j;
    buf[j] = (g >= 0 && g < n) ? static_cast<int32_t>(x[g]) : 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int64_t g = t0 + t;
    if (g >= n) break;
    const int32_t* p = buf + L + t;
    int32_t acc = 0;
#pragma unroll 8
    for (int j = 0; j < window; ++j) acc += p[-j * C];
    y[g] = static_cast<int16_t>(acc / window);  // C++ division truncates toward zero
  }
}

}  // namespace dsp

extern "C" int dsp_direct_i16(const int16_t* x, int16_t* y, int64_t n, int64_t window,
                              int64_t channels, int64_t tile_frames, int64_t smem_bytes,
                              void* stream) {
  const int64_t tile = tile_frames * channels;
  if (n <= 0 || tile <= 0 || tile > 0x7fffffff || window < 1 || window > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[dsp::kMaxDevices] = {};
  cudaError_t err = dsp::allow_smem(dsp::direct_kernel, allowed, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dsp::direct_kernel<<<static_cast<unsigned>(blocks), dsp::kThreads,
                       static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream)>>>(
      x, y, n, static_cast<int>(window), static_cast<int>(channels),
      static_cast<int>(tile_frames));
  return static_cast<int>(cudaGetLastError());
}
