// Carried scan averager over an interleaved int16 stream (B3), with three
// in-tile scans.
//
// Replaces digital_signal_processsing_tpu/ops/pallas_scan.py
//   _scan_averager_kernel and its in-tile scans _tile_cumsum_blelloch,
//   _tile_cumsum_hillis_steele and _tile_cumsum_mxu.
//
// out[i] = trunc((cum[i] - cum[i - k*C]) / k), cum the per-channel inclusive
// prefix of the stream (cum[<0] = 0): B1's function, reached by a scan.
//
// What bounds it on the H100: by count, memory bytes (2 bytes in and 2 out a
// sample; 0.08 ms at 64M samples). The design keeps every other cost below
// that: the samples stay in registers from their 16-byte load to their
// 16-byte store, and a tile costs two block barriers.
//
// Blocks and spans. The TPU kernel walks its grid in order and carries a
// per-channel row of sums in VMEM; CUDA blocks run in no order, so each
// block owns one contiguous span of tiles and walks it in order, as one
// wave of resident blocks. The tile, the ring, the channel instances, the
// generic kernel for any other C and the three in-tile scans are in
// run_tile.cuh, which B1 (windowed.cu) shares; B3 is its instances without
// a seed, over the whole stream.
#include <cstdint>

#include <cuda_runtime.h>

#include "run_tile.cuh"

namespace dsp {
namespace b3 {

using namespace runs;

static bool pick(int variant, int c, Launch* out) {
  switch (variant) {
    case kBlelloch: return pick_c<kBlelloch, false>(c, out);
    case kHillisSteele: return pick_c<kHillisSteele, false>(c, out);
    case kTensorCore: return pick_c<kTensorCore, false>(c, out);
    default: return false;
  }
}

}  // namespace b3
}  // namespace dsp

// variant: 0 Blelloch, 1 Hillis-Steele, 2 tensor cores. kernel_c: 1, 2, 4, 8
// or 16 (the stream's channels: their instance) or 0 (the generic kernel, any
// C, not the tensor cores); nrun: the ring's runs; the rest as
// ops/pallas_scan.py's ScanGeometry computes them.
extern "C" int dsp_scan_i16(const int16_t* x, int16_t* y, int64_t n, int64_t window,
                            int64_t channels, int64_t variant, int64_t kernel_c, int64_t nrun,
                            int64_t span_tiles, int64_t smem_bytes, void* stream) {
  dsp::runs::Launch l;
  if (!dsp::b3::pick(static_cast<int>(variant), static_cast<int>(kernel_c), &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dsp::runs::launch_runs(l, x, y, nullptr, n, window, channels, kernel_c, nrun, 0, -1,
                                span_tiles, smem_bytes, stream);
}

// What the compiler gave B3's kernel (variant, kernel_c): registers a
// thread, local bytes a thread, shared bytes a block (static and dynamic),
// blocks an SM with `smem_bytes` of dynamic shared memory (4 int64 in out).
extern "C" int dsp_scan_attrs(int64_t variant, int64_t kernel_c, int64_t smem_bytes, int64_t* out) {
  dsp::runs::Launch l;
  if (!dsp::b3::pick(static_cast<int>(variant), static_cast<int>(kernel_c), &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dsp::runs::runs_attrs(l, smem_bytes, out);
}
