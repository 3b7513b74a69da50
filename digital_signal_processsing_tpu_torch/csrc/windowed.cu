// Windowed moving averager over an interleaved int16 stream (B1), and the
// same function over the stream's int32 pair view (B2).
//
// Replaces digital_signal_processsing_tpu/ops/pallas_scan.py
//   _windowed_averager_kernel (B1) and _windowed_packed_kernel (B2).
//
// out[i] = trunc( sum_{j=0..k-1} x[i - j*C] / k ), x[<0] = 0 or the seed.
//
// B1. The TPU kernel walks its grid in order and keeps the raw last H = k*C
// samples (tail_ref) from one tile to the next; CUDA blocks run in no order.
// Here B1 is run_tile.cuh's span kernel with the Hillis-Steele scan, the
// fastest of B3's three on the H100: persistent blocks each walk a span of
// 8192-sample tiles, every thread's 32 samples in registers from one 16-byte
// load to one 16-byte store, two block barriers a tile, the window read
// from a ring of the span's absolute prefixes (the ring is the tail, as
// tail_ref is the TPU's), the division by k a multiply-high. A span starts
// by scanning the H samples before it, from x or, before the stream, from
// the seed (the halo a shard or a chunk receives). So no block carries
// anything to another: block b of a launch owns the outputs of its span
// only, and dsp_windowed_i16_range runs any range of tiles, tile t owning
// outputs [t * 8192, (t + 1) * 8192). The fused ring averager (B7,
// ring.cu) runs the same spans: the tiles whose window lies inside the shard
// while the halo is in flight, then the head tiles seeded from the received
// halo; the split changes no output.
//
// Where the halo comes from: a span of one tile loads and scans the H
// samples before every tile (mostly from L2); a span of many keeps them in
// its ring and pays that once a span. The wrapper takes spans of one wave
// of resident blocks (ops/pallas_scan.py); chip_smoke.py phase 5 times both.
//
// What bounds B1 on the H100: memory bytes, 2 bytes in and 2 out a sample
// (0.08 ms at 64M samples). The ring is 4 bytes a sample of H plus a tile,
// so a large halo leaves one block an SM (windowed_supported).
//
// B2 loads and stores 32-bit words, each holding two adjacent samples (the
// reference's int2 rung): each block loads its tile and a lead of halo into
// shared memory and forms the block-local per-channel prefix there
// (block_prefix.cuh); the buffer and tile are kept even in length. Its seed
// is the lead*C samples before the stream, as lead*C/2 words. It is simple,
// not yet fast: its loads are 4 bytes a thread, not 16.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"
#include "run_tile.cuh"

namespace dsp {

// B2. n: samples in the stream (2 * words). lead >= window frames of halo
// are loaded before the tile; lead*C and tf*C are even.
__global__ void __launch_bounds__(kThreads)
packed_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
              const uint32_t* __restrict__ seed32, int64_t n, int window, int C, int lead,
              int tf, int R, int S) {
  extern __shared__ uint32_t smem[];
  const int T = tf * C;
  const int H = window * C;
  const int Hl = lead * C;
  const int L = Hl + T;
  const int nf = lead + tf;
  uint32_t* buf = smem;
  uint32_t* seg = smem + L;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * T;
  const int64_t start = t0 - Hl;
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
  __syncthreads();
  segment_sums(buf, seg, nf, C, R, S);
  __syncthreads();
  segment_offsets(seg, C, S, [](int, uint32_t) {});
  __syncthreads();
  segment_apply(buf, seg, nf, C, R, S);
  __syncthreads();
  for (int p = threadIdx.x; p < T / 2; p += blockDim.x) {
    const int64_t gw = t0 / 2 + p;
    if (gw >= n32) break;
    const int i = Hl + 2 * p;
    const uint32_t lo = static_cast<uint16_t>(window_mean(buf[i] - buf[i - H], window));
    const uint32_t hi = static_cast<uint16_t>(window_mean(buf[i + 1] - buf[i + 1 - H], window));
    y[gw] = lo | (hi << 16);
  }
}

}  // namespace dsp

// B1 over tiles [tile_begin, tile_end) (tile_end < 0: to the stream's end)
// of the n-sample stream x into y, in spans of span_tiles. seed: the
// window * channels samples before x, or null for zeros. kernel_c: the
// channels (1, 2, 4, 8, 16: their instance) or 0 (the generic kernel, any
// C); nrun, smem_bytes as ops/pallas_scan.py's ScanGeometry computes them.
extern "C" int dsp_windowed_i16_range(const int16_t* x, int16_t* y, const int16_t* seed,
                                      int64_t n, int64_t window, int64_t channels,
                                      int64_t kernel_c, int64_t nrun, int64_t tile_begin,
                                      int64_t tile_end, int64_t span_tiles, int64_t smem_bytes,
                                      void* stream) {
  using namespace dsp::runs;
  Launch l;
  if (!pick_c<kHillisSteele, true>(static_cast<int>(kernel_c), &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_runs(l, x, y, seed, n, window, channels, kernel_c, nrun, tile_begin, tile_end,
                     span_tiles, smem_bytes, stream);
}

// What the compiler gave B1's kernel for kernel_c: as dsp_scan_attrs.
extern "C" int dsp_windowed_attrs(int64_t kernel_c, int64_t smem_bytes, int64_t* out) {
  using namespace dsp::runs;
  Launch l;
  if (!pick_c<kHillisSteele, true>(static_cast<int>(kernel_c), &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return runs_attrs(l, smem_bytes, out);
}

// B2. n32: int32 words; the stream holds 2 * n32 samples. seed32: the lead *
// channels / 2 words before the stream, or null for zeros.
extern "C" int dsp_windowed_packed(const int32_t* x, int32_t* y, const int32_t* seed32,
                                   int64_t n32, int64_t window, int64_t channels, int64_t lead,
                                   int64_t tile_frames, int64_t seg_frames, int64_t segs,
                                   int64_t smem_bytes, void* stream) {
  const int64_t tile = tile_frames * channels;
  const int64_t blocks = (2 * n32 + tile - 1) / tile;
  if (n32 < 1 || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[dsp::kMaxDevices] = {};
  cudaError_t err = dsp::allow_smem(dsp::packed_kernel, allowed, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dsp::packed_kernel<<<static_cast<unsigned>(blocks), dsp::kThreads,
                       static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(x), reinterpret_cast<uint32_t*>(y),
      reinterpret_cast<const uint32_t*>(seed32), 2 * n32, static_cast<int>(window),
      static_cast<int>(channels), static_cast<int>(lead), static_cast<int>(tile_frames),
      static_cast<int>(seg_frames), static_cast<int>(segs));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dsp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
