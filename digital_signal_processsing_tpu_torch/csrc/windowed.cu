// Windowed moving averager over an interleaved int16 stream (B1), and the
// same function over the stream's int32 pair view (B2).
//
// Replaces digital_signal_processsing_tpu/ops/pallas_scan.py
//   _windowed_averager_kernel (B1) and _windowed_packed_kernel (B2).
//
// out[i] = trunc( sum_{j=0..k-1} x[i - j*C] / k ), x[<0] = 0 or the seed.
//
// Each block owns a tile of T = tf*C output samples starting at a frame
// boundary. It loads [tile - lead*C, tile end) into shared memory (the halo
// from global memory, or from the seed before the stream starts), forms the
// block-local per-channel prefix P over that buffer (block_prefix.cuh) and
// writes trunc((P[i] - P[i - k*C]) / k). Blocks need no carry and run in any
// order. The local prefix may wrap, but the difference is exact mod 2^32 for
// k <= 65535, so the arithmetic is uint32 and only the final difference is
// read as int32. Positions past the end load as zero and are never stored.
//
// What bounds it on the H100: memory bytes. The stream moves once in and
// once out (4 bytes a sample); the halo is re-read per block, mostly from
// L2. The buffer takes 4 bytes of shared memory a sample, so a large halo
// leaves one block an SM; the host sends such halos to the two-pass path
// (windowed_supported in ops/pallas_scan.py). The shared-memory scan costs
// two passes over the buffer; it is simple, not yet fast: loads are 2 or 4
// bytes a thread, not 16.
//
// B2 loads and stores 32-bit words, each holding two adjacent samples (the
// reference's int2 rung); the buffer and tile are then kept even in length.
// Its seed is the lead*C samples before the stream, as lead*C/2 words.
//
// dsp_windowed_i16_range launches B1 over a range of its blocks only: the
// fused ring averager (B7, parallel/ring_pallas.py) runs the blocks whose
// window lies inside the shard while the halo is in flight, then the head
// blocks seeded from the received halo. Blocks carry nothing, so the split
// changes no output.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"

namespace dsp {

// n: samples in the stream (2 * words for B2). lead >= window frames of
// halo are loaded before the tile; lead*C and tf*C are even for B2.
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
windowed_kernel(const void* __restrict__ xin, void* __restrict__ yout,
                const int16_t* __restrict__ seed, int64_t n, int window, int C,
                int lead, int tf, int R, int S, int64_t block0) {
  extern __shared__ uint32_t smem[];
  const int T = tf * C;
  const int H = window * C;
  const int Hl = lead * C;
  const int L = Hl + T;
  const int nf = lead + tf;
  uint32_t* buf = smem;
  uint32_t* seg = smem + L;
  const int64_t t0 = (static_cast<int64_t>(blockIdx.x) + block0) * T;
  const int64_t start = t0 - Hl;

  if constexpr (kPacked) {
    const uint32_t* x = static_cast<const uint32_t*>(xin);
    const uint32_t* seed32 = reinterpret_cast<const uint32_t*>(seed);
    const int64_t n32 = n / 2;
    const int64_t w0 = start / 2;  // start is even
    const int64_t hw = Hl / 2;     // seed words
    for (int j = threadIdx.x; j < L / 2; j += blockDim.x) {
      const int64_t gw = w0 + j;
      uint32_t w = 0u;
      if (gw >= 0) {
        if (gw < n32) w = x[gw];
      } else if (seed32 != nullptr && gw >= -hw) {
        w = seed32[hw + gw];
      }
      buf[2 * j] = widen(static_cast<int16_t>(w & 0xffffu));
      buf[2 * j + 1] = widen(static_cast<int16_t>(w >> 16));
    }
  } else {
    const int16_t* x = static_cast<const int16_t*>(xin);
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      const int64_t g = start + j;
      int16_t v = 0;
      if (g >= 0) {
        if (g < n) v = x[g];
      } else if (seed != nullptr && g >= -H) {
        v = seed[H + g];
      }
      buf[j] = widen(v);
    }
  }
  __syncthreads();
  segment_sums(buf, seg, nf, C, R, S);
  __syncthreads();
  segment_offsets(seg, C, S, nullptr, nullptr);
  __syncthreads();
  segment_apply(buf, seg, nf, C, R, S);
  __syncthreads();

  if constexpr (kPacked) {
    uint32_t* y = static_cast<uint32_t*>(yout);
    const int64_t n32 = n / 2;
    for (int p = threadIdx.x; p < T / 2; p += blockDim.x) {
      const int64_t gw = t0 / 2 + p;
      if (gw >= n32) break;
      const int i = Hl + 2 * p;
      const uint32_t lo = static_cast<uint16_t>(window_mean(buf[i] - buf[i - H], window));
      const uint32_t hi =
          static_cast<uint16_t>(window_mean(buf[i + 1] - buf[i + 1 - H], window));
      y[gw] = lo | (hi << 16);
    }
  } else {
    int16_t* y = static_cast<int16_t*>(yout);
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const int64_t g = t0 + t;
      if (g >= n) break;
      const int i = Hl + t;
      y[g] = window_mean(buf[i] - buf[i - H], window);
    }
  }
}

template <bool kPacked>
static int launch_windowed(const void* x, void* y, const int16_t* seed, int64_t n,
                           int64_t window, int64_t channels, int64_t lead,
                           int64_t tile_frames, int64_t seg_frames, int64_t segs,
                           int64_t smem_bytes, int64_t block_begin, int64_t block_end,
                           void* stream) {
  const int64_t tile = tile_frames * channels;
  const int64_t blocks = (n + tile - 1) / tile;
  if (block_end < 0) block_end = blocks;  // every block
  if (block_begin < 0 || block_begin >= block_end || block_end > blocks ||
      block_end - block_begin > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = windowed_kernel<kPacked>;
  static int allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, allowed, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(block_end - block_begin), kThreads,
           static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream)>>>(
      x, y, seed, n, static_cast<int>(window), static_cast<int>(channels),
      static_cast<int>(lead), static_cast<int>(tile_frames), static_cast<int>(seg_frames),
      static_cast<int>(segs), block_begin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsp

extern "C" int dsp_windowed_i16(const int16_t* x, int16_t* y, const int16_t* seed,
                                int64_t n, int64_t window, int64_t channels,
                                int64_t lead, int64_t tile_frames, int64_t seg_frames,
                                int64_t segs, int64_t smem_bytes, void* stream) {
  return dsp::launch_windowed<false>(x, y, seed, n, window, channels, lead, tile_frames,
                                     seg_frames, segs, smem_bytes, 0, -1, stream);
}

// Blocks [block_begin, block_end) of dsp_windowed_i16's grid; block b owns
// outputs [b * tile, (b + 1) * tile), tile = tile_frames * channels.
extern "C" int dsp_windowed_i16_range(const int16_t* x, int16_t* y, const int16_t* seed,
                                      int64_t n, int64_t window, int64_t channels,
                                      int64_t lead, int64_t tile_frames, int64_t seg_frames,
                                      int64_t segs, int64_t smem_bytes, int64_t block_begin,
                                      int64_t block_end, void* stream) {
  return dsp::launch_windowed<false>(x, y, seed, n, window, channels, lead, tile_frames,
                                     seg_frames, segs, smem_bytes, block_begin, block_end,
                                     stream);
}

// n32: int32 words; the stream holds 2 * n32 samples. seed32: the lead *
// channels / 2 words before the stream, or null for zeros.
extern "C" int dsp_windowed_packed(const int32_t* x, int32_t* y, const int32_t* seed32,
                                   int64_t n32, int64_t window, int64_t channels, int64_t lead,
                                   int64_t tile_frames, int64_t seg_frames, int64_t segs,
                                   int64_t smem_bytes, void* stream) {
  return dsp::launch_windowed<true>(x, y, reinterpret_cast<const int16_t*>(seed32), 2 * n32,
                                    window, channels, lead, tile_frames, seg_frames, segs,
                                    smem_bytes, 0, -1, stream);
}

extern "C" const char* dsp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
