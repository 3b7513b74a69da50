// Windowed moving averager over an interleaved int16 stream (B1), and over
// the stream's int32 pair view (B2, the same launch on the same bytes).
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
// B2, the same function over the stream's int32 pair view, is this launch:
// on the card an int32 word is two adjacent int16 samples at the same
// address, so the wrapper (ops/pallas_scan.py windowed_averager_packed)
// passes the words' int16 view and its output's to dsp_windowed_i16_range,
// seeded from the last H samples of the pair-word seed. The reference packs
// pairs for its TPU's transport (int16 tiles relayout more slowly there);
// B1's 16-byte runs already move 8 samples a load here.

#include <cstdint>

#include <cuda_runtime.h>

#include "run_tile.cuh"

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

extern "C" const char* dsp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
