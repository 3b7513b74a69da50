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
// The TPU kernel walks its grid in order and carries a per-channel row of
// sums and the previous tile's prefix in VMEM. CUDA blocks run in no order,
// so a loop inside the block takes the place of the sequential grid: each
// block owns one contiguous span of tiles and walks it in order.
//   - First it scans the k*C samples before the span (zeros before the
//     stream). That seeds the tail, the last k*C prefix values (the
//     counterpart of concat_ref's previous half), and the carry.
//   - Then, tile by tile: load the tile and scan it per channel with the
//     variant's algorithm (res = the in-tile inclusive prefix); write
//     trunc((res[t] - (tail[t] - carry)) / k) for t < k*C and
//     trunc((res[t] - res[t - k*C]) / k) beyond; keep the tile's last k*C
//     prefixes plus the carry as the next tail; add the tile's totals to
//     the carry.
// The carry starts at 0 in each span, because only differences of the
// prefix are used. Sums are uint32, exact mod 2^32 for k <= 65535, as in
// block_prefix.cuh. The host makes the tile at least k*C samples, so a
// window never reaches past the tail.
//
// The in-tile scans (a template parameter):
//   kBlelloch      the work-efficient up-sweep and down-sweep per channel
//                  over the tile's frames (blelloch_scan_averager.cu:72-114),
//                  in the inclusive (Brent-Kung) form, which takes any frame
//                  count without padding to a power of two.
//   kHillisSteele  stride-doubling over the flat tile from stride C
//                  (hillis_steele_averager.cu:48), double-buffered in shared
//                  memory: O(n log n) work, the reference's work-inefficient
//                  rung, on purpose.
//   kTensorCore    the counterpart of the TPU's bf16-limb MXU scan. The tile
//                  is rows of 16 samples; each row's per-channel prefix is
//                  X @ U, U[i][j] = 1 iff j >= i and (j - i) % C == 0, on the
//                  tensor cores (WMMA 16x16x16, 8-bit inputs, int32 sums),
//                  exact through the split x = hi * 256 + lo (hi signed, lo
//                  unsigned). The rows' per-channel totals are then scanned as
//                  in kBlelloch and added back. Needs C | 16 and a tile of
//                  whole 256-sample row blocks.
//
// What bounds it on the H100: by count, memory bytes (2 bytes in and 2 out a
// sample; the halo is read once a span, where B1 reads it once a tile). In
// practice the scans' barriers (about 2*log2(frames) a tile for kBlelloch,
// log2(T/C) passes for kHillisSteele) and shared-memory traffic set the
// time. The host sizes the spans to one wave of resident blocks, so that
// the blocks on one SM hide each other's barriers.

#include <cstdint>

#include <cuda_runtime.h>
#include <mma.h>

#include "block_prefix.cuh"

namespace dsp {

enum ScanVariant : int { kBlelloch = 0, kHillisSteele = 1, kTensorCore = 2 };

constexpr int kRow = 16;                // samples in a tensor-core row
constexpr int kRowBlock = kRow * kRow;  // samples in one 16 x 16 product

// Inclusive prefix, in place, of C interleaved sequences of n values,
// a[f * C + c]: the up-sweep, then the inclusive down-sweep. The caller
// synchronises before reading the result.
static __device__ void tree_scan(uint32_t* a, int n, int C) {
  int s = 1;
  for (; s < n; s <<= 1) {
    const int items = (n / (2 * s)) * C;
    for (int w = threadIdx.x; w < items; w += blockDim.x) {
      const int j = w / C;
      const int c = w - j * C;
      const int f = (j + 1) * 2 * s - 1;
      a[f * C + c] += a[(f - s) * C + c];
    }
    __syncthreads();
  }
  for (s >>= 1; s >= 1; s >>= 1) {
    const int items = n > s ? ((n - s) / (2 * s)) * C : 0;
    for (int w = threadIdx.x; w < items; w += blockDim.x) {
      const int j = w / C;
      const int c = w - j * C;
      const int f = (j + 1) * 2 * s + s - 1;
      a[f * C + c] += a[(f - s) * C + c];
    }
    __syncthreads();
  }
}

// Inclusive per-channel prefix of the flat tile a[0..T) by stride doubling
// from stride C, ping-ponging between a and b; returns the buffer holding it.
static __device__ uint32_t* hillis_steele_scan(uint32_t* a, uint32_t* b, int T, int C) {
  for (int s = C; s < T; s <<= 1) {
    for (int i = threadIdx.x; i < T; i += blockDim.x) b[i] = i >= s ? a[i] + a[i - s] : a[i];
    __syncthreads();
    uint32_t* spare = a;
    a = b;
    b = spare;
  }
  return a;
}

// Inclusive per-channel prefix of a tile given as hi * 256 + lo (T bytes
// each, rows of 16 samples) into res (T words). U is the 16 x 16 0/1
// matrix; rt a scratch of (T / 16) * C words.
static __device__ void tensor_core_scan(const signed char* hi, const unsigned char* lo,
                                        const unsigned char* U, uint32_t* res, uint32_t* rt,
                                        int T, int C) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_b, kRow, kRow, kRow, signed char, wmma::row_major> u_s;
  wmma::fragment<wmma::matrix_b, kRow, kRow, kRow, unsigned char, wmma::row_major> u_u;
  wmma::load_matrix_sync(u_s, reinterpret_cast<const signed char*>(U), kRow);
  wmma::load_matrix_sync(u_u, U, kRow);
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int b = warp; b < T / kRowBlock; b += nwarps) {
    wmma::fragment<wmma::matrix_a, kRow, kRow, kRow, signed char, wmma::row_major> a_hi;
    wmma::fragment<wmma::matrix_a, kRow, kRow, kRow, unsigned char, wmma::row_major> a_lo;
    wmma::fragment<wmma::accumulator, kRow, kRow, kRow, int> y_hi;
    wmma::fragment<wmma::accumulator, kRow, kRow, kRow, int> y_lo;
    wmma::load_matrix_sync(a_hi, hi + b * kRowBlock, kRow);
    wmma::load_matrix_sync(a_lo, lo + b * kRowBlock, kRow);
    wmma::fill_fragment(y_hi, 0);
    wmma::fill_fragment(y_lo, 0);
    wmma::mma_sync(y_hi, a_hi, u_s, y_hi);
    wmma::mma_sync(y_lo, a_lo, u_u, y_lo);
    // same fragment type, so the same element mapping: combine in registers
    for (int e = 0; e < y_hi.num_elements; ++e) y_hi.x[e] = y_hi.x[e] * 256 + y_lo.x[e];
    wmma::store_matrix_sync(reinterpret_cast<int*>(res) + b * kRowBlock, y_hi, kRow,
                            wmma::mem_row_major);
  }
  __syncthreads();
  // lane 16 - C + c of a row holds channel c's row total (C | 16)
  const int R = T / kRow;
  for (int w = threadIdx.x; w < R * C; w += blockDim.x) {
    const int r = w / C;
    const int c = w - r * C;
    rt[w] = res[r * kRow + kRow - C + c];
  }
  __syncthreads();
  tree_scan(rt, R, C);
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const int r = i / kRow;
    if (r > 0) res[i] += rt[(r - 1) * C + i % C];
  }
}

// tiles = ceil(n / (tf * C)); block b walks tiles [b * span_tiles, ...).
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int16_t* __restrict__ x, int16_t* __restrict__ y, int64_t n, int window,
            int C, int tf, int64_t tiles, int span_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = tf * C;
  const int H = window * C;
  // Shared memory, in this order (ScanGeometry.smem_bytes in ops/pallas_scan.py):
  //   kBlelloch      res (T words), tail (H words), carry (2C words)
  //   kHillisSteele  res, alt (T words each), tail, carry
  //   kTensorCore    U (256 bytes), res, hi (T bytes), lo (T bytes), tail,
  //                  rt ((T / 16) * C words), carry
  unsigned char* p = smem;
  unsigned char* U = nullptr;
  if constexpr (kVariant == kTensorCore) {
    U = p;
    p += kRowBlock;
  }
  uint32_t* res = reinterpret_cast<uint32_t*>(p);
  p += 4 * T;
  uint32_t* alt = nullptr;
  signed char* hi = nullptr;
  unsigned char* lo = nullptr;
  if constexpr (kVariant == kHillisSteele) {
    alt = reinterpret_cast<uint32_t*>(p);
    p += 4 * T;
  }
  if constexpr (kVariant == kTensorCore) {
    hi = reinterpret_cast<signed char*>(p);
    p += T;
    lo = p;
    p += T;
  }
  uint32_t* tail = reinterpret_cast<uint32_t*>(p);
  p += 4 * H;
  uint32_t* rt = nullptr;
  if constexpr (kVariant == kTensorCore) {
    rt = reinterpret_cast<uint32_t*>(p);
    p += 4 * (T / kRow) * C;
  }
  uint32_t* carry = reinterpret_cast<uint32_t*>(p);
  uint32_t* carry_next = carry + C;

  if constexpr (kVariant == kTensorCore) {
    for (int e = threadIdx.x; e < kRowBlock; e += blockDim.x) {
      const int i = e / kRow;
      const int j = e - i * kRow;
      U[e] = (j >= i && (j - i) % C == 0) ? 1 : 0;
    }
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) carry[c] = 0u;
  // (the first tile's load barrier orders these writes before their reads)

  const int64_t first = static_cast<int64_t>(blockIdx.x) * span_tiles;
  const int64_t end = first + span_tiles < tiles ? first + span_tiles : tiles;
  // Tile first - 1 seeds the span: only its last H samples are loaded.
  for (int64_t tile = first - 1; tile < end; ++tile) {
    const int64_t t0 = tile * T;
    const int64_t from = tile < first ? t0 + T - H : t0;
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      const int64_t g = t0 + i;
      const int16_t v = (g >= from && g >= 0 && g < n) ? x[g] : static_cast<int16_t>(0);
      if constexpr (kVariant == kTensorCore) {
        hi[i] = static_cast<signed char>(v >> 8);
        lo[i] = static_cast<unsigned char>(v & 0xff);
      } else {
        res[i] = widen(v);
      }
    }
    __syncthreads();
    uint32_t* cum = res;
    if constexpr (kVariant == kBlelloch) {
      tree_scan(res, tf, C);
    } else if constexpr (kVariant == kHillisSteele) {
      cum = hillis_steele_scan(res, alt, T, C);
    } else {
      tensor_core_scan(hi, lo, U, res, rt, T, C);
    }
    __syncthreads();
    if (tile >= first) {
      for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const int64_t g = t0 + t;
        if (g >= n) break;
        const uint32_t before = t >= H ? cum[t - H] : tail[t] - carry[t % C];
        y[g] = window_mean(cum[t] - before, window);
      }
      __syncthreads();
    }
    for (int j = threadIdx.x; j < H; j += blockDim.x) tail[j] = cum[T - H + j] + carry[j % C];
    for (int c = threadIdx.x; c < C; c += blockDim.x) carry_next[c] = carry[c] + cum[T - C + c];
    __syncthreads();
    uint32_t* spare = carry;
    carry = carry_next;
    carry_next = spare;
  }
}

template <int kVariant>
static int launch_scan(const int16_t* x, int16_t* y, int64_t n, int64_t window,
                       int64_t channels, int64_t tile_frames, int64_t span_tiles,
                       int64_t smem_bytes, void* stream) {
  const int64_t tile = tile_frames * channels;
  if (n <= 0 || tile <= 0 || span_tiles <= 0 || window * channels > tile ||
      tile > 0x7fffffff || span_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n + tile - 1) / tile;
  const int64_t blocks = (tiles + span_tiles - 1) / span_tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = scan_kernel<kVariant>;
  static int allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, allowed, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem_bytes),
           static_cast<cudaStream_t>(stream)>>>(
      x, y, n, static_cast<int>(window), static_cast<int>(channels),
      static_cast<int>(tile_frames), tiles, static_cast<int>(span_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsp

// variant: 0 Blelloch, 1 Hillis-Steele, 2 tensor cores (dsp::ScanVariant).
extern "C" int dsp_scan_i16(const int16_t* x, int16_t* y, int64_t n, int64_t window,
                            int64_t channels, int64_t variant, int64_t tile_frames,
                            int64_t span_tiles, int64_t smem_bytes, void* stream) {
  switch (variant) {
    case dsp::kBlelloch:
      return dsp::launch_scan<dsp::kBlelloch>(x, y, n, window, channels, tile_frames,
                                              span_tiles, smem_bytes, stream);
    case dsp::kHillisSteele:
      return dsp::launch_scan<dsp::kHillisSteele>(x, y, n, window, channels, tile_frames,
                                                  span_tiles, smem_bytes, stream);
    case dsp::kTensorCore:
      return dsp::launch_scan<dsp::kTensorCore>(x, y, n, window, channels, tile_frames,
                                                span_tiles, smem_bytes, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
