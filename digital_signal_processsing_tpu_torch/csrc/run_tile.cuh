// The tile of runs shared by the averager's two span kernels: B3, the
// carried scan averager (scan.cu), and B1, the windowed averager
// (windowed.cu); the cumsum (B4, cumsum.cu) takes its steps 1-4.
//
// Both compute out[i] = trunc((cum[i] - cum[i - k*C]) / k) over an
// interleaved int16 stream, cum the per-channel inclusive prefix, with the
// same blocks: each block owns one contiguous span of 8192-sample tiles and
// walks it in order. It first scans the ceil(H / tile) tiles before the span
// (H = k*C; only the H samples before the span are loaded, the rest read as
// zero), which seeds its ring, then the span. Sums are uint32, exact mod
// 2^32, and start at 0 in each span: only differences are used. So no block
// carries anything to another, and a launch may cover any range of tiles.
//
// The tile: 256 threads, each holding kNQ = 4 runs of 8 consecutive samples
// (one 16-byte vector of int16) in registers, 8192 samples of the stream.
// Run q of thread (warp w, lane l) is run (w*kNQ + q)*32 + l of the tile, so
// a warp's load or store of run q is 512 contiguous bytes. Per tile:
//   1. load the runs (in a tile wholly inside the stream the thread's four
//      16-byte loads issue together; at its edges, or where x or y is not
//      16-byte aligned, run by run and sample by sample);
//   2. the in-run prefix per channel (the variant's lowest levels, below);
//   3. per q, the lanes' run totals scanned across the warp (the variant's
//      middle levels), chained over q in registers;
//   4. the warp totals to shared memory; barrier; every thread reads the 8
//      warp totals and scans them (the variant's top levels): its warp's
//      offset and the tile's total, which it adds to the span's carry, kept
//      in registers;
//   5. the absolute prefix (carry, warp, lane and run offsets added) written
//      to a ring of the last NRUN runs in shared memory, word m of run r at
//      ring[m * NRUN + r mod NRUN]; barrier;
//   6. each output reads cum[i - H] from the ring, subtracts, divides by k
//      (a multiply-high by floor((2^64-1)/k) + 1, exact for |sum| < 2^32) and
//      leaves as 16-byte stores.
// NRUN is a multiple of 32 and at least the tile's runs plus ceil(H/8) + 1,
// so the ring still holds every cum[i - H] when the tile has been written;
// the lanes of a warp touch 32 consecutive slots in step 5 and 6, which are
// on 32 banks. No tail is copied: the ring is the tail.
//
// Channels. C is a template parameter for C in {1, 2, 4, 8, 16}: a run of 8
// holds whole frames (channel m % C for sample m) up to C = 8, and half a
// frame at C = 16, where the lanes of each parity scan their half. Any
// other C takes scan_generic_kernel (below, Blelloch and Hillis-Steele
// only): the same tiles, loads, stores and ring, the raw samples through the
// ring, and each channel scanned there by one warp, 32 of its samples (C
// apart) a row. It moves the same bytes as the instances; its scan costs a
// third barrier a tile and leaves C < 8 some warps idle.
//
// kSeedable (B1's instances): a launch covers the tiles [first_tile,
// end_tile) only, and the positions before the stream read the seed (the H
// samples before it, a shard's or a chunk's halo) where one is given.
//
// Each kernel's body is a device function of its block's span (scan_span,
// scan_generic_span), so that the fused ring averager (B7, ring.cu) runs the
// same spans in blocks of its own.
//
// The in-tile scans (a template parameter), each its algorithm at every
// level where it runs:
//   kBlelloch      Brent-Kung's inclusive up-sweep and down-sweep: over the
//                  frames of a run in registers, across the 32 lanes by
//                  __shfl_up_sync (5 levels up, 4 down), over the 8 warp
//                  totals in registers.
//   kHillisSteele  stride doubling, O(n log n) work: across the lanes by
//                  __shfl_up_sync at strides 1, 2, 4, 8, 16 (Kogge-Stone) and
//                  over the 8 warp totals at strides 1, 2, 4; inside a run
//                  the sum is sequential (8 samples, no doubling there).
//   kTensorCore    the counterpart of the TPU's bf16-limb MXU scan: the
//                  runs q = 2b and 2b + 1 of a warp are a 16 x 32 int8
//                  matrix A (row g: lanes 4g..4g+3's run 2b, row g + 8 their
//                  run 2b + 1), exact through x = hi * 256 + lo, hi signed and
//                  lo unsigned; each row's per-channel prefix is A U, U[i][j]
//                  = 1 iff j >= i and (j - i) % C == 0, by mma.sync
//                  m16n8k32 (s8 x s8 and u8 x s8, int32 sums) from and into
//                  registers, 4 products of 8 columns a limb. The k and n
//                  columns are permuted so that lane (g, t) holds samples
//                  8t..8t+7 of its rows in both A and D: its own run. The
//                  rows' per-channel totals then cross the warp's groups of
//                  4 lanes by __shfl_up_sync (strides 4, 8, 16); the warp
//                  totals add up in order.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"

namespace dsp {
namespace runs {

enum ScanVariant : int { kBlelloch = 0, kHillisSteele = 1, kTensorCore = 2 };

constexpr int kRun = 8;  // samples a run: one 16-byte vector of int16
constexpr int kNQ = 4;   // runs a thread: 32 samples, 8192 a tile
static_assert(kNQ % 2 == 0, "the tensor cores take runs in pairs");
constexpr int kWarps = kThreads / 32;
constexpr int kTileRuns = kWarps * 32 * kNQ;
constexpr long long kTile = static_cast<long long>(kTileRuns) * kRun;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int16_t* x;
  int16_t* y;
  long long len;       // samples of the stream
  long long end_tile;  // the launch's tiles end here (B3: the stream's tiles)
  unsigned long long magic;  // floor((2^64 - 1) / k) + 1 (k >= 2)
  int channels;        // C
  int window;          // k
  int halo;            // H = k*C: samples back to the sample before the window
  int span_tiles;      // tiles a block walks
  int seed_tiles;      // ceil(H / tile): the tiles scanned before the span
  int nrun;            // runs in the ring
  int vec;             // 16-byte loads and stores (x and y both aligned)
  // B1 (kSeedable) only:
  const int16_t* seed;   // the H samples before the stream, or null (zeros)
  long long first_tile;  // the launch's first tile
};

// trunc(s / k) for the int32 reading of the window sum (|s| < 2^31).
static __device__ __forceinline__ int16_t mean_of(uint32_t wsum, const Args& a) {
  const int32_t s = static_cast<int32_t>(wsum);
  const uint32_t m = static_cast<uint32_t>(s < 0 ? -s : s);
  const uint32_t q = a.window == 1 ? m : static_cast<uint32_t>(__umul64hi(m, a.magic));
  return static_cast<int16_t>(s < 0 ? -static_cast<int32_t>(q) : static_cast<int32_t>(q));
}

static __device__ __forceinline__ uint32_t widen16(uint32_t half) {
  return static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(half & 0xffffu)));
}

static __device__ __forceinline__ void widen_run(const int4& r, uint32_t (&v)[kRun]) {
  const uint32_t w[4] = {static_cast<uint32_t>(r.x), static_cast<uint32_t>(r.y),
                         static_cast<uint32_t>(r.z), static_cast<uint32_t>(r.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = widen16(w[i]);
    v[2 * i + 1] = widen16(w[i] >> 16);
  }
}

// Sample p of the stream: x[p], or with kSeedable (B1) for p < 0 the seed's
// sample H + p (read only where a seed was given: lo >= 0 otherwise).
template <bool kSeedable>
static __device__ __forceinline__ uint32_t sample(const Args& a, const int16_t* x, long long p) {
  if constexpr (kSeedable) {
    if (p < 0) return widen(a.seed[a.halo + p]);
  }
  return widen(x[p]);
}

// The first sample a 16-byte load may read: lo, and never before the stream.
template <bool kSeedable>
static __device__ __forceinline__ long long vector_lo(long long lo) {
  return kSeedable && lo < 0 ? 0 : lo;
}

// The run of the stream from sample p0 on, samples [lo, len) loaded, the rest 0.
template <bool kSeedable>
static __device__ __forceinline__ void load_run(const Args& a, const int16_t* x, long long p0,
                                                long long lo, uint32_t (&v)[kRun]) {
  if (a.vec && p0 >= vector_lo<kSeedable>(lo) && p0 + kRun <= a.len) {
    widen_run(__ldcs(reinterpret_cast<const int4*>(x + p0)), v);
  } else {
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      const long long p = p0 + m;
      v[m] = (p >= lo && p < a.len) ? sample<kSeedable>(a, x, p) : 0u;
    }
  }
}

static __device__ __forceinline__ void store_run(const Args& a, int16_t* y, long long p0,
                                                 const int16_t (&o)[kRun]) {
  if (a.vec && p0 + kRun <= a.len) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = static_cast<uint32_t>(static_cast<uint16_t>(o[2 * i])) |
             (static_cast<uint32_t>(static_cast<uint16_t>(o[2 * i + 1])) << 16);
    }
    __stcs(reinterpret_cast<int4*>(y + p0), make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                                                      static_cast<int>(w[2]), static_cast<int>(w[3])));
  } else {
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      if (p0 + m < a.len) y[p0 + m] = o[m];
    }
  }
}

// The thread's runs of the tile from sample t0 on, run q being run
// (w*kNQ + q)*32 + l of the tile: in a tile wholly loaded, the kNQ 16-byte
// loads issue together; at the stream's edges, run by run.
template <bool kSeedable>
static __device__ __forceinline__ void load_tile(const Args& a, const int16_t* x, long long t0,
                                                 long long lo, uint32_t (&v)[kNQ][kRun]) {
  const long long p0 = t0 + static_cast<long long>(((threadIdx.x >> 5) * kNQ * 32 +
                                                    (threadIdx.x & 31)) * kRun);
  if (a.vec && t0 >= vector_lo<kSeedable>(lo) && t0 + kTile <= a.len) {
    int4 r[kNQ];
#pragma unroll
    for (int q = 0; q < kNQ; ++q) r[q] = __ldcs(reinterpret_cast<const int4*>(x + p0 + 32 * kRun * q));
#pragma unroll
    for (int q = 0; q < kNQ; ++q) widen_run(r[q], v[q]);
  } else {
#pragma unroll
    for (int q = 0; q < kNQ; ++q) load_run<kSeedable>(a, x, p0 + 32 * kRun * q, lo, v[q]);
  }
}

// A span of tiles [first, end) and its first read: H samples before the
// span, clipped to the stream unless a seed (B1) stands before it.
template <bool kSeedable>
struct Span {
  long long first, end, lo;
  __device__ __forceinline__ Span(const Args& a, long long first_, long long end_)
      : first(first_), end(end_) {
    lo = first * kTile - a.halo;
    if (!kSeedable || a.seed == nullptr) lo = lo > 0 ? lo : 0;
  }
};

// Span b of the launch's tiles, the span of block b. B3's launch starts at tile 0.
template <bool kSeedable>
static __device__ __forceinline__ Span<kSeedable> span_of(const Args& a, long long b) {
  long long first = b * a.span_tiles;
  if constexpr (kSeedable) first += a.first_tile;
  return Span<kSeedable>(a, first, first + a.span_tiles < a.end_tile ? first + a.span_tiles
                                                                     : a.end_tile);
}

// ---- Brent-Kung (kBlelloch) ---------------------------------------------------

__host__ __device__ constexpr int pow2_at_least(int f) { return f <= 1 ? 1 : 2 * pow2_at_least((f + 1) / 2); }

// Inclusive prefix of v[q + S*f], f < F, in place: up-sweep, then the
// inclusive down-sweep (tree_scan's levels; every index a constant).
template <int F, int S, int q, int N>
static __device__ __forceinline__ void bk_registers(uint32_t (&v)[N]) {
  constexpr int kTop = pow2_at_least(F);
#pragma unroll
  for (int s = 1; s < F; s <<= 1) {
#pragma unroll
    for (int f = 2 * s - 1; f < F; f += 2 * s) v[q + S * f] += v[q + S * (f - s)];
  }
#pragma unroll
  for (int s = kTop / 4; s >= 1; s >>= 1) {
#pragma unroll
    for (int f = 3 * s - 1; f < F; f += 2 * s) v[q + S * f] += v[q + S * (f - s)];
  }
}

// bk_registers for each of the S channels of v (v[c + S*f] is frame f of channel c).
template <int F, int S, int c = 0, int N>
static __device__ __forceinline__ void bk_channels(uint32_t (&v)[N]) {
  bk_registers<F, S, c>(v);
  if constexpr (c + 1 < S) bk_channels<F, S, c + 1>(v);
}

// Inclusive prefix of one value a lane across the lanes of one phase (lane
// l is element l / PH of phase l % PH): the up-sweep (elements 2d-1, 4d-1,
// ... add the partial sum d elements back), then the inclusive down-sweep
// (elements 3d-1, 5d-1, ... add the sum d elements back).
template <int PH>
static __device__ __forceinline__ uint32_t bk_lanes(uint32_t x, int lane) {
  constexpr int kN = 32 / PH;
  const int e = lane / PH;
#pragma unroll
  for (int d = 1; d < kN; d <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, x, d * PH);
    if ((e & (2 * d - 1)) == 2 * d - 1) x += up;
  }
#pragma unroll
  for (int d = kN / 4; d >= 1; d >>= 1) {
    const uint32_t up = __shfl_up_sync(kFull, x, d * PH);
    if (((e + 1 - d) & (2 * d - 1)) == 0 && e >= 3 * d - 1) x += up;
  }
  return x;
}

// ---- stride doubling (kHillisSteele) -----------------------------------------

static __device__ __forceinline__ uint32_t ks_lanes(uint32_t x, int lane, int from = 1) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d < from) continue;
    const uint32_t up = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += up;
  }
  return x;
}

// ---- the tensor cores (kTensorCore) -------------------------------------------

// Four bytes of samples v[I0..I0+3]: the high limb (signed) or the low one.
template <bool HI, int I0>
static __device__ __forceinline__ uint32_t limbs(const uint32_t (&v)[kRun]) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) r |= ((HI ? (v[I0 + i] >> 8) : v[I0 + i]) & 0xffu) << (8 * i);
  return r;
}

template <bool SIGNED_A>
static __device__ __forceinline__ void mma_k32(const uint32_t (&a)[4], const uint32_t (&b)[2],
                                               int32_t (&d)[4]) {
  if constexpr (SIGNED_A) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%10,%10,%10,%10};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%10,%10,%10,%10};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0));
  }
}

// B = U with its rows and columns permuted, as lane (g, t) holds it for the
// product of columns nb*8..nb*8+7: k row 4t + i is sample 8t + i of a row and
// k row 16 + 4t + i sample 8t + 4 + i; n column c = 2t' + e of the block is
// output 8t' + 2nb + e. This lane's column is c = g.
template <int CE>
static __device__ __forceinline__ void u_fragment(int lane, int nb, uint32_t (&b)[2]) {
  const int g = lane >> 2, t = lane & 3;
  const int j = 8 * (g >> 1) + 2 * nb + (g & 1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 8 * t + 4 * r + i;
      if (j >= s && (j - s) % CE == 0) w |= 1u << (8 * i);
    }
    b[r] = w;
  }
}

// Runs 2p (row g) and 2p + 1 (row g + 8) of the lane become their rows'
// inclusive per-channel prefix: A's fragment holds the lane's own samples
// (registers 0 and 2 row g, 1 and 3 row g + 8), D's columns 2t and 2t + 1 of
// product nb are the lane's outputs 2nb and 2nb + 1.
static __device__ __forceinline__ void row_products(uint32_t (&v)[kNQ][kRun], int p,
                                                    const uint32_t (&u)[4][2]) {
  const uint32_t ahi[4] = {limbs<true, 0>(v[2 * p]), limbs<true, 0>(v[2 * p + 1]),
                           limbs<true, 4>(v[2 * p]), limbs<true, 4>(v[2 * p + 1])};
  const uint32_t alo[4] = {limbs<false, 0>(v[2 * p]), limbs<false, 0>(v[2 * p + 1]),
                           limbs<false, 4>(v[2 * p]), limbs<false, 4>(v[2 * p + 1])};
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    int32_t hi[4], lo[4];
    mma_k32<true>(ahi, u[nb], hi);
    mma_k32<false>(alo, u[nb], lo);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      v[2 * p][2 * nb + e] = static_cast<uint32_t>(hi[e] * 256 + lo[e]);
      v[2 * p + 1][2 * nb + e] = static_cast<uint32_t>(hi[2 + e] * 256 + lo[2 + e]);
    }
  }
}

// ---- steps 2-4 of a tile -----------------------------------------------------

// v: the thread's runs as loaded -> their in-run inclusive prefixes (step 2);
// off[q][c]: run q's offset in the tile (lanes and warps, step 3-4) plus
// carry[c], for channel SL * phase + c; carry advanced by the tile's totals.
// wt: kWarps * C words of shared memory, written by lanes < PH, then one
// barrier. Shared by scan_kernel below and the cumsum (cumsum.cu, B4), which
// starts every tile from carry 0.
template <int V, int C>
static __device__ __forceinline__ void tile_prefix(uint32_t (&v)[kNQ][kRun],
                                                   uint32_t (&off)[kNQ][C < kRun ? C : kRun],
                                                   uint32_t (&carry)[C < kRun ? C : kRun],
                                                   uint32_t* wt, int lane, int warp,
                                                   const uint32_t (&u)[4][2]) {
  constexpr int SL = C < kRun ? C : kRun;  // channels a run
  constexpr int PH = C / SL;                // phases of the lanes
  const int phase = lane & (PH - 1);
  // 2-3. in-run prefix, then the lanes' offsets chained over q
  uint32_t wsum[SL];
#pragma unroll
  for (int c = 0; c < SL; ++c) wsum[c] = 0u;
  if constexpr (V == kTensorCore) {
#pragma unroll
    for (int p = 0; p < kNQ / 2; ++p) row_products(v, p, u);
  }
#pragma unroll
  for (int q = 0; q < kNQ; ++q) {
    if constexpr (V == kBlelloch) {
      bk_channels<kRun / SL, SL>(v[q]);
    } else if constexpr (V == kHillisSteele) {
#pragma unroll
      for (int m = SL; m < kRun; ++m) v[q][m] += v[q][m - SL];
    }
#pragma unroll
    for (int c = 0; c < SL; ++c) {
      uint32_t incl, own;
      if constexpr (V == kBlelloch) {
        own = v[q][kRun - SL + c];
        incl = bk_lanes<PH>(own, lane);
      } else if constexpr (V == kHillisSteele) {
        own = v[q][kRun - SL + c];
        incl = ks_lanes(own, lane, PH);
      } else {
        // the row's total from the last lane of its group holding this
        // channel; rows cross the warp's groups
        own = __shfl_sync(kFull, v[q][kRun - SL + c], (lane & ~3) | (4 - PH) | phase);
        incl = ks_lanes(own, lane, 4);
      }
      off[q][c] = wsum[c] + incl - own;
      wsum[c] += __shfl_sync(kFull, incl, 32 - PH + phase);
    }
  }
  // 4. the warp totals, and this warp's offset in the tile
  if (lane < PH) {
#pragma unroll
    for (int c = 0; c < SL; ++c) wt[warp * C + SL * lane + c] = wsum[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < SL; ++c) {
    uint32_t w[kWarps];
#pragma unroll
    for (int i = 0; i < kWarps; ++i) w[i] = wt[i * C + SL * phase + c];
    uint32_t incl[kWarps];
#pragma unroll
    for (int i = 0; i < kWarps; ++i) incl[i] = w[i];
    if constexpr (V == kBlelloch) {
      bk_registers<kWarps, 1, 0>(incl);
    } else if constexpr (V == kHillisSteele) {
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
#pragma unroll
        for (int i = kWarps - 1; i >= d; --i) incl[i] += incl[i - d];
      }
    } else {
#pragma unroll
      for (int i = 1; i < kWarps; ++i) incl[i] += incl[i - 1];
    }
    uint32_t mine = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) mine = i == warp ? incl[i] - w[i] : mine;
    const uint32_t add = carry[c] + mine;
#pragma unroll
    for (int q = 0; q < kNQ; ++q) off[q][c] += add;
    carry[c] += incl[kWarps - 1];
  }
}

// ---- the kernel -------------------------------------------------------------

// C: 1, 2, 4, 8 or 16, the stream's channels. A run holds SL channels,
// m % SL for sample m; at C = 16 it holds half a frame, channels 8 (r % 2) + m
// for run r, so the lanes alternate between the two halves (PH = 2 phases,
// the lane's phase its parity) and each half scans across the lanes of its
// own phase.
template <int V, int C, bool kSeedable>
static __device__ __forceinline__ void scan_span(const Args& a, const Span<kSeedable>& sp) {
  constexpr int SL = C < kRun ? C : kRun;  // channels a run
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                       // kRun * nrun words
  uint32_t* wt = smem + kRun * a.nrun;         // kWarps * C words

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int16_t* x = a.x;
  int16_t* y = a.y;
  const long long first = sp.first, end = sp.end, lo = sp.lo;  // lo: the first read
  const long long base = first - a.seed_tiles;  // ring runs count from this tile

  uint32_t u[4][2] = {};
  if constexpr (V == kTensorCore) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) u_fragment<C>(lane, nb, u[nb]);
  }
  uint32_t carry[SL];  // channel SL * phase + c
#pragma unroll
  for (int c = 0; c < SL; ++c) carry[c] = 0u;

  for (long long tile = base; tile < end; ++tile) {
    const long long t0 = tile * kTile;
    uint32_t v[kNQ][kRun];
    load_tile<kSeedable>(a, x, t0, lo, v);
    uint32_t off[kNQ][SL];
    tile_prefix<V, C>(v, off, carry, wt, lane, warp, u);
    // 5. absolute prefixes into the ring; r0: the slot of the tile's run 0
    const int r0 = static_cast<int>(((tile - base) * kTileRuns) % a.nrun);
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
      int r = r0 + (warp * kNQ + q) * 32 + lane;
      r = r >= a.nrun ? r - a.nrun : r;
#pragma unroll
      for (int m = 0; m < kRun; ++m) {
        v[q][m] += off[q][m % SL];
        ring[m * a.nrun + r] = v[q][m];
      }
    }
    __syncthreads();
    if (tile < first) continue;
    // 6. cum[i] - cum[i - H], divided: with H = 8 hq + hr, sample m of run r
    // reads word m - hr of run r - hq, or word m - hr + 8 of run r - hq - 1
    // for m < hr (the ring holds them: seed_tiles * tile >= H)
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
      const int run = (warp * kNQ + q) * 32 + lane;
      int hi = r0 + run - (a.halo >> 3);
      hi = hi < 0 ? hi + a.nrun : hi >= a.nrun ? hi - a.nrun : hi;
      const int lo = hi == 0 ? a.nrun - 1 : hi - 1;
      const int hr = a.halo & 7;
      int16_t o[kRun];
#pragma unroll
      for (int m = 0; m < kRun; ++m) {
        const int slot = m < hr ? (m - hr + kRun) * a.nrun + lo : (m - hr) * a.nrun + hi;
        o[m] = mean_of(v[q][m] - ring[slot], a);
      }
      store_run(a, y, t0 + static_cast<long long>(run) * kRun, o);
    }
  }
}

template <int V, int C, bool kSeedable>
__global__ void __launch_bounds__(kThreads, C >= 8 ? 3 : 4) scan_kernel(Args a) {
  scan_span<V, C, kSeedable>(a, span_of<kSeedable>(a, blockIdx.x));
}

// ---- any other C: the generic kernel ----------------------------------------

constexpr int kRows = 4;  // rows of a channel scanned together

// Slot r of the generic kernel's flat ring, one word of skew every 32, so
// that a warp's runs of 8 fall on 32 banks and its lanes' stride-C walks at
// most two to a bank (tests/test_torch_scan.py checks both).
static __device__ __forceinline__ int skew(int r) { return r + (r >> 5); }

// Any C, the stream interleaved as for the instances above, each thread's
// runs loaded and stored as there. A run holds samples of several channels
// in a pattern that moves with the tile, so the scan goes through the ring:
//   1. the raw samples to their slots (flat, 8 * nrun words, skewed); barrier;
//   2. warp w takes channels w, w + 8, ...: the channel's samples of the
//      tile, stride C apart, in rows of 32 lanes, kRows rows at a time: each
//      row's inclusive prefix across the lanes (Brent-Kung or Kogge-Stone,
//      as above), the channel's carry (shared, one word a channel) added,
//      the absolute prefix written back in place; barrier;
//   3. each output reads cum[i] and cum[i - H] from the ring, subtracts,
//      divides, and leaves as in step 6 above.
// A barrier before step 1 keeps the last tile's outputs ahead of the next
// tile's samples, so the ring needs only a tile and H + 8 slots.
template <int V, bool kSeedable>
static __device__ __forceinline__ void scan_generic_span(const Args& a,
                                                         const Span<kSeedable>& sp) {
  static_assert(V != kTensorCore, "the tensor cores take C dividing 16 only");
  extern __shared__ __align__(16) uint32_t smem[];
  const int rs = kRun * a.nrun;                // ring slots
  uint32_t* ring = smem;                       // skew(rs) words
  uint32_t* carry = smem + rs + (rs >> 5);     // C words
  const int C = a.channels;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = sp.first, end = sp.end, lo = sp.lo;
  const long long base = first - a.seed_tiles;
  const int step = static_cast<int>((32LL * C) % rs);  // a lane's slot, row to row
  for (int c = threadIdx.x; c < C; c += kThreads) carry[c] = 0u;

  for (long long tile = base; tile < end; ++tile) {
    const long long t0 = tile * kTile;
    uint32_t v[kNQ][kRun];
    load_tile<kSeedable>(a, a.x, t0, lo, v);
    const int r0 = static_cast<int>(((tile - base) * kTile) % rs);  // slot of the tile's sample 0
    __syncthreads();
    // 1. the raw samples to their slots
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
      const int r = r0 + ((warp * kNQ + q) * 32 + lane) * kRun;
#pragma unroll
      for (int m = 0; m < kRun; ++m) ring[skew(r + m >= rs ? r + m - rs : r + m)] = v[q][m];
    }
    __syncthreads();
    // 2. each channel's prefix, rows of 32 of its samples (tile sample jc + C i
    // for i = 32 row + lane)
    const int c0 = static_cast<int>(((t0 % C) + C) % C);  // the channel of the tile's sample 0
    for (int c = warp; c < C; c += kWarps) {
      const int jc = c >= c0 ? c - c0 : c + C - c0;
      const int nc = jc < kTile ? static_cast<int>((kTile - jc + C - 1) / C) : 0;
      int r = static_cast<int>((r0 + jc + static_cast<long long>(C) * lane) % rs);
      uint32_t cy = carry[c];
      for (int i0 = 0; i0 < nc; i0 += 32 * kRows) {
        int slot[kRows];
        uint32_t val[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          slot[u] = i0 + 32 * u + lane < nc ? skew(r) : -1;
          val[u] = slot[u] >= 0 ? ring[slot[u]] : 0u;
          r += step;
          r -= r >= rs ? rs : 0;
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          val[u] = V == kBlelloch ? bk_lanes<1>(val[u], lane) : ks_lanes(val[u], lane);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (slot[u] >= 0) ring[slot[u]] = cy + val[u];
          cy += __shfl_sync(kFull, val[u], 31);
        }
      }
      if (lane == 0) carry[c] = cy;
    }
    __syncthreads();
    if (tile < first) continue;
    // 3. cum[i] - cum[i - H], divided
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
      const int run = (warp * kNQ + q) * 32 + lane;
      int16_t o[kRun];
#pragma unroll
      for (int m = 0; m < kRun; ++m) {
        int at = r0 + run * kRun + m;
        at -= at >= rs ? rs : 0;
        const int back = at >= a.halo ? at - a.halo : at - a.halo + rs;
        o[m] = mean_of(ring[skew(at)] - ring[skew(back)], a);
      }
      store_run(a, a.y, t0 + static_cast<long long>(run) * kRun, o);
    }
  }
}

template <int V, bool kSeedable>
__global__ void __launch_bounds__(kThreads, 4) scan_generic_kernel(Args a) {
  scan_generic_span<V, kSeedable>(a, span_of<kSeedable>(a, blockIdx.x));
}

// ---- the launch (host) ------------------------------------------------------

struct Launch {
  const void* kernel;
  int* allowed;
};

template <int V, int C, bool kSeedable>
static Launch launch_of() {
  static int allowed[kMaxDevices] = {};
  return {reinterpret_cast<const void*>(scan_kernel<V, C, kSeedable>), allowed};
}

template <int V, bool kSeedable>
static Launch generic_of() {
  static int allowed[kMaxDevices] = {};
  return {reinterpret_cast<const void*>(scan_generic_kernel<V, kSeedable>), allowed};
}

// kernel_c: 1, 2, 4, 8 or 16 (the stream's channels: their instance) or 0
// (the generic kernel, any C, not the tensor cores).
template <int V, bool kSeedable>
static bool pick_c(int c, Launch* out) {
  switch (c) {
    case 1: *out = launch_of<V, 1, kSeedable>(); return true;
    case 2: *out = launch_of<V, 2, kSeedable>(); return true;
    case 4: *out = launch_of<V, 4, kSeedable>(); return true;
    case 8: *out = launch_of<V, 8, kSeedable>(); return true;
    case 16: *out = launch_of<V, 16, kSeedable>(); return true;
    case 0:
      if constexpr (V == kTensorCore) {
        return false;
      } else {
        *out = generic_of<V, kSeedable>();
        return true;
      }
    default: return false;
  }
}

// The arguments of a launch over tiles [tile_begin, tile_end) of the
// n-sample stream (tile_end < 0: to its end) in spans of span_tiles tiles.
// nrun: the ring's runs; seed: the H samples before the stream or null. The
// geometry as ops/pallas_scan.py's ScanGeometry computes it; a cudaError_t.
static int runs_args(Args* a, const int16_t* x, int16_t* y, const int16_t* seed, int64_t n,
                     int64_t window, int64_t channels, int64_t kernel_c, int64_t nrun,
                     int64_t tile_begin, int64_t tile_end, int64_t span_tiles,
                     int64_t smem_bytes) {
  if (n <= 0 || window < 1 || window > 65535 || channels < 1 || n % channels != 0 ||
      span_tiles < 1 || nrun < 32 || nrun % 32 != 0 || (kernel_c != 0 && kernel_c != channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t halo = window * channels;
  const int64_t ring_words = kernel_c == 0 ? kRun * nrun + nrun / 4 + channels
                                           : kRun * nrun + kWarps * channels;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tile_end < 0) tile_end = tiles;
  if (nrun < kTile / kRun + (halo + kRun - 1) / kRun + 1 || halo > 0x7fffffff / 2 ||
      smem_bytes != 4 * ring_words || tile_begin < 0 || tile_begin >= tile_end ||
      tile_end > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a->x = x;
  a->y = y;
  a->seed = seed;
  a->len = n;
  a->first_tile = tile_begin;
  a->end_tile = tile_end;
  a->magic = ~0ull / static_cast<unsigned long long>(window) + 1;
  a->channels = static_cast<int>(channels);
  a->window = static_cast<int>(window);
  a->halo = static_cast<int>(halo);
  const int64_t range = tile_end - tile_begin;
  a->span_tiles = static_cast<int>(span_tiles < range ? span_tiles : range);
  a->seed_tiles = static_cast<int>((halo + kTile - 1) / kTile);
  a->nrun = static_cast<int>(nrun);
  a->vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if ((range + a->span_tiles - 1) / a->span_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSuccess);
}

// Launches `l` over tiles [tile_begin, tile_end), one block a span (as
// runs_args); a cudaError_t.
static int launch_runs(const Launch& l, const int16_t* x, int16_t* y, const int16_t* seed,
                       int64_t n, int64_t window, int64_t channels, int64_t kernel_c,
                       int64_t nrun, int64_t tile_begin, int64_t tile_end, int64_t span_tiles,
                       int64_t smem_bytes, void* stream) {
  Args a;
  const int bad = runs_args(&a, x, y, seed, n, window, channels, kernel_c, nrun, tile_begin,
                            tile_end, span_tiles, smem_bytes);
  if (bad != 0) return bad;
  const int64_t blocks = (a.end_tile - a.first_tile + a.span_tiles - 1) / a.span_tiles;
  cudaError_t err = allow_smem(l.kernel, l.allowed, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchKernel(l.kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
                         static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave `l`: registers a thread, local bytes a thread,
// shared bytes a block (static and dynamic), blocks an SM with `smem_bytes`
// of dynamic shared memory (4 int64 in out); a cudaError_t.
static int runs_attrs(const Launch& l, int64_t smem_bytes, int64_t* out) {
  if (smem_bytes < 0 || smem_bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(l.kernel, l.allowed, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, l.kernel)) != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, kThreads,
                                                      static_cast<size_t>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int64_t>(attr.localSizeBytes);
  out[2] = static_cast<int64_t>(attr.sharedSizeBytes) + smem_bytes;
  out[3] = blocks;
  return 0;
}

}  // namespace runs
}  // namespace dsp
