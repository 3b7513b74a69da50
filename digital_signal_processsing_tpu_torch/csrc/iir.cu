// IIR block scans over planar (channels, t) float32: the first-order
// recurrence (B10, and B11 as a compose of affine maps), the cascade of
// second-order sections in one pass with a fixed-depth look-back (B12),
// unrolled for 1..8 sections (B13) or with its lane pass on the tensor cores
// (B14), and one section a launch (B15).
//
// Replaces, in digital_signal_processsing_tpu/ops/iir.py:
//   B10 _iir1_scalar_kernel        y[t] = a*y[t-1] + b*x[t], zero initial state;
//   B11 _iir1_kernel               the same function, per-element affine maps;
//   B12 _biquad_fused_loop_kernel  the whole SOS cascade per tile, seeded or not;
//   B13 _biquad_fused_kernel       B12 with the sections unrolled;
//   B14 _biquad_fused_mxu_kernel   B12's function, the lane pass a matrix product;
//   B15 _biquad_kernel             one section's block scan, launched per section.
// B11 and B14 are the reference's A/B anchors: other spellings of B10's and
// B12's functions, kept so that the two designs can be timed side by side.
// B12's single pass, and B13 as its instances with the section count fixed,
// have their own note below (sos_lookback_kernel); the rest of this note is
// the three-launch design of B10 and B15.
// A section is the JAX package's direct form II transposed:
//   y = b0*x + s1;  s1' = b1*x - a1*y + s2;  s2' = b2*x - a2*y.
// With zero input its state moves by Phi = [[-a1, 1], [-a2, 0]] and y reads s1.
//
// The TPU kernels walk their grid in order and carry the state in VMEM
// scratch. CUDA blocks run in no order, so the carry takes three launches
// (the design of cumsum.cu):
//   1. tile kernel, ends   every tile but the last runs the cascade from zero
//                          state and writes its end state z_t (D floats, D = 2S
//                          for S sections, 1 for the first order);
//   2. carry_kernel        a warp a channel scans s_{t+1} = M s_t + z_t from the
//                          seed (zero, or the chunk's incoming state) and leaves
//                          s_t, the state entering tile t, in place of z_t. M is
//                          the zero-input transition of the whole cascade over
//                          one tile: D x D and block lower triangular (a
//                          section's zero-input response drives the sections
//                          after it). The wrapper computes it once in float64
//                          from the sos rows and rounds it once;
//   3. tile kernel, apply  every tile runs the cascade from s_t and writes y;
//                          the thread holding sample n-1 writes the state after
//                          it, the chunk's end state (the samples past n are
//                          zeros and never reach it).
// Inside a tile a block walks sub-tiles of kSub samples in order, carrying
// each section's state in shared memory. In a sub-tile, thread i owns kSeg
// consecutive samples: the block loads the sub-tile with coalesced 16-byte
// loads into a shared buffer whose rows (one a thread) are padded to kRow
// floats, so that a warp's reads of one column fall on distinct banks, and
// each thread keeps its row in registers through every section. Per section:
//   a. the thread runs its samples from zero state (5 FMAs a sample), keeping
//      y and its end state z_i;
//   b. a block scan of the z_i. Every segment has the same transition
//      Phi^kSeg, so a warp's Hillis-Steele steps take the powers Phi^(kSeg d)
//      from the section's table, and thread 0 chains the warp totals from the
//      section's carry with Phi^(32 kSeg);
//   c. the thread adds the zero-input response of its true start state s,
//      y_j += (Phi^j s)[0], iterating s <- Phi s (3 operations a sample).
// A section's output is the next section's input in place in registers: x is
// read once and y written once a launch, each sample through shared memory
// once each way. Coefficients and powers come
// from a table the wrapper builds (float64, rounded once): a changed sos
// rebuilds nothing. Every operation is an IEEE fp32 FMA or product, never a
// tensor core (TF32 would keep 10 mantissa bits).
//
// What bounds it on the H100: memory bytes. The function reads x once and
// writes y once, 8 bytes a sample (0.160 ms for 16 x 2^22 samples at
// 3.35 TB/s); the three launches read x twice (launches 1 and 3), 12 bytes a
// sample. Their operations, about 2 x 8 a sample and section, stay below that
// at 66.9 TFLOP/s. B15 moves 8 bytes a sample and section through device
// memory, as the TPU anchor does.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"

namespace dsp {
namespace iir {

constexpr int kThreads = 256;          // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16;               // consecutive samples a thread
constexpr int kRow = kSeg + 1;         // a thread's row of the shared buffer
constexpr int kSub = kThreads * kSeg;  // samples a sub-tile
constexpr int kTab = 144;              // floats of a section's table
constexpr int kTab1 = 40;              // floats of the first-order table
constexpr int kPow = 8;                // where a section's powers start
constexpr int kPow1 = 4;               // where the first-order powers start
constexpr int kMaxSections = 16;       // 2S state lanes of one carry warp
constexpr int kMaxUnrolled = 8;        // B13's largest instance: butter(16) is 8 sections
constexpr int kChunkTiles = 64;        // tile states a carry warp stages at once
constexpr unsigned kFull = 0xffffffffu;

// A section's table (kTab floats): b0, b1, b2, a1, a2 at 0..4; at kPow + 4m
// the 2x2 Phi^(kSeg m), row-major, for m = 0..32.
// The first-order table (kTab1 floats): a, b at 0, 1; a^(kSeg m) at kPow1 + m.

static __device__ __forceinline__ int slot(int k) { return (k / kSeg) * kRow + k % kSeg; }

// buf[slot(k)] = x[k] for k < count, 0 beyond; 16-byte loads when `vec`.
static __device__ void load_sub(const float* x, float* buf, int count, bool vec) {
  if (vec && count == kSub) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int q = threadIdx.x; q < kSub / 4; q += kThreads) {
      const float4 v = x4[q];
      float* p = buf + slot(4 * q);  // kSeg % 4 == 0: the four share a row
      p[0] = v.x;
      p[1] = v.y;
      p[2] = v.z;
      p[3] = v.w;
    }
  } else {
    for (int k = threadIdx.x; k < kSub; k += kThreads) buf[slot(k)] = k < count ? x[k] : 0.0f;
  }
}

static __device__ void store_sub(float* y, const float* buf, int count, bool vec) {
  if (vec && count == kSub) {
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int q = threadIdx.x; q < kSub / 4; q += kThreads) {
      const float* p = buf + slot(4 * q);
      y4[q] = make_float4(p[0], p[1], p[2], p[3]);
    }
  } else {
    for (int k = threadIdx.x; k < count; k += kThreads) y[k] = buf[slot(k)];
  }
}

struct Coef {
  float b0, b1, b2, a1, a2;
};

static __device__ __forceinline__ Coef coef_of(const float* t) {
  return Coef{t[0], t[1], t[2], t[3], t[4]};
}

// One section over the sub-tile, in place in `v` (this thread's samples, in
// registers). `pw`: the section's powers in shared memory; `car`: its carry
// (2 floats, the state at the sub-tile's start, left at its end); `jlast`:
// the index in `v` of sample n-1 when its state is the chunk's end state,
// else -1.
static __device__ __forceinline__ void section_pass(float (&v)[kSeg], const float* pw, Coef k,
                                                    float* car, float* wtot, float* wbeg,
                                                    int jlast, float* end) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a. zero-state run of this thread's samples
  float s1 = 0.0f, s2 = 0.0f, p1 = 0.0f, p2 = 0.0f;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const float xv = v[j];
    const float yv = fmaf(k.b0, xv, s1);
    s1 = fmaf(k.b1, xv, fmaf(-k.a1, yv, s2));
    s2 = fmaf(k.b2, xv, -k.a2 * yv);
    v[j] = yv;
    if (j == jlast) {
      p1 = s1;
      p2 = s2;
    }
  }
  // b. w_i = sum over the warp's segments j <= i of Phi^(kSeg (i - j)) z_j
  float w1 = s1, w2 = s2;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u1 = __shfl_up_sync(kFull, w1, d);
    const float u2 = __shfl_up_sync(kFull, w2, d);
    if (lane >= d) {
      const float* P = pw + 4 * d;
      w1 = fmaf(P[0], u1, fmaf(P[1], u2, w1));
      w2 = fmaf(P[2], u1, fmaf(P[3], u2, w2));
    }
  }
  float e1 = __shfl_up_sync(kFull, w1, 1);
  float e2 = __shfl_up_sync(kFull, w2, 1);
  if (lane == 0) {
    e1 = 0.0f;
    e2 = 0.0f;
  }
  if (lane == 31) {
    wtot[2 * warp] = w1;
    wtot[2 * warp + 1] = w2;
  }
  __syncthreads();
  if (tid == 0) {
    const float* P = pw + 4 * 32;
    float c1 = car[0], c2 = car[1];
    for (int w = 0; w < kWarps; ++w) {
      wbeg[2 * w] = c1;
      wbeg[2 * w + 1] = c2;
      const float n1 = fmaf(P[0], c1, fmaf(P[1], c2, wtot[2 * w]));
      const float n2 = fmaf(P[2], c1, fmaf(P[3], c2, wtot[2 * w + 1]));
      c1 = n1;
      c2 = n2;
    }
    car[0] = c1;
    car[1] = c2;
  }
  __syncthreads();
  // the true state entering this thread's samples
  const float* P = pw + 4 * lane;
  const float c1 = wbeg[2 * warp], c2 = wbeg[2 * warp + 1];
  float r1 = fmaf(P[0], c1, fmaf(P[1], c2, e1));
  float r2 = fmaf(P[2], c1, fmaf(P[3], c2, e2));
  // c. add its zero-input response
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    v[j] += r1;
    const float n1 = fmaf(-k.a1, r1, r2);
    r2 = -k.a2 * r1;
    r1 = n1;
    if (j == jlast) {
      end[0] = r1 + p1;
      end[1] = r2 + p2;
    }
  }
}

// Launches 1 and 3 of the cascade. Block (t, c) runs tile t of channel c.
// `ends` != 0: launch 1, from zero state, writing the tile's end state to
// carry[c, t]; y and state_out are null. Else launch 3, from carry[c, t],
// writing y and, where it holds sample n-1, state_out[(k C + c) 2 + j].
// NS sections are unrolled with their coefficients in registers; B15 takes
// NS = 1, the one instance.
template <int NS>
__global__ void __launch_bounds__(kThreads)
sos_tile_kernel(const float* x, float* y, const float* __restrict__ tab, int sections,
                float* __restrict__ carry, float* __restrict__ state_out, int64_t n,
                int64_t tile, int64_t ntiles, int C, int ends) {
  __shared__ float buf[kThreads * kRow];
  __shared__ float stab[kMaxSections * kTab];
  __shared__ float scar[2 * kMaxSections];
  __shared__ float wtot[2 * kWarps];
  __shared__ float wbeg[2 * kWarps];
  constexpr int S = NS;
  const int D = 2 * S;
  const int tid = threadIdx.x;
  const int c = blockIdx.y;
  const int64_t t = blockIdx.x;
  for (int i = tid; i < S * kTab; i += kThreads) stab[i] = tab[i];
  float* cst = carry + (static_cast<int64_t>(c) * ntiles + t) * D;
  if (tid < D) scar[tid] = ends ? 0.0f : cst[tid];
  __syncthreads();
  Coef reg[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) reg[k] = coef_of(stab + k * kTab);
  const float* xr = x + static_cast<int64_t>(c) * n;
  float* yr = y != nullptr ? y + static_cast<int64_t>(c) * n : nullptr;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
  const int64_t t0 = t * tile;
  const int64_t t1 = t0 + tile < n ? t0 + tile : n;
  const bool writes_state = state_out != nullptr && t == ntiles - 1;
  float* seg = buf + tid * kRow;
  for (int64_t s0 = t0; s0 < t1; s0 += kSub) {
    const int count = static_cast<int>(t1 - s0 < kSub ? t1 - s0 : kSub);
    load_sub(xr + s0, buf, count, vec);
    __syncthreads();
    int jlast = -1;
    if (writes_state && n - 1 - s0 < kSub) {
      const int p = static_cast<int>(n - 1 - s0);
      if (p / kSeg == tid) jlast = p % kSeg;
    }
    // the thread's samples stay in registers through every section
    float v[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) v[j] = seg[j];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      float* end = jlast >= 0 ? state_out + (static_cast<int64_t>(k) * C + c) * 2 : nullptr;
      section_pass(v, stab + k * kTab + kPow, reg[k], scar + 2 * k, wtot, wbeg, jlast, end);
    }
#pragma unroll
    for (int j = 0; j < kSeg; ++j) seg[j] = v[j];
    __syncthreads();
    if (yr != nullptr) store_sub(yr + s0, buf, count, vec);
    __syncthreads();
  }
  if (ends && tid < D) cst[tid] = scar[tid];
}

// The first-order tile kernel (B10): the same walk with a 1-D state, the
// previous output. Launch 1 (`ends`) writes the tile's last output from zero
// state to carry[c, t]; launch 3 runs from carry[c, t] and writes y.
__global__ void __launch_bounds__(kThreads)
iir1_tile_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const float* __restrict__ tab, float* __restrict__ carry, int64_t n,
                 int64_t tile, int64_t ntiles, int ends) {
  __shared__ float buf[kThreads * kRow];
  __shared__ float pw[kTab1];
  __shared__ float wtot[kWarps];
  __shared__ float wbeg[kWarps];
  __shared__ float scar;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.y;
  const int64_t t = blockIdx.x;
  if (tid < kTab1) pw[tid] = tab[tid];
  float* cst = carry + static_cast<int64_t>(c) * ntiles + t;
  if (tid == 0) scar = ends ? 0.0f : *cst;
  __syncthreads();
  const float a = pw[0], b = pw[1];
  const float* ap = pw + kPow1;
  const float* xr = x + static_cast<int64_t>(c) * n;
  float* yr = y != nullptr ? y + static_cast<int64_t>(c) * n : nullptr;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
  const int64_t t0 = t * tile;
  const int64_t t1 = t0 + tile < n ? t0 + tile : n;
  float* seg = buf + tid * kRow;
  for (int64_t s0 = t0; s0 < t1; s0 += kSub) {
    const int count = static_cast<int>(t1 - s0 < kSub ? t1 - s0 : kSub);
    load_sub(xr + s0, buf, count, vec);
    __syncthreads();
    // a. zero-state run, the thread's samples in registers
    float y[kSeg];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      s = fmaf(a, s, b * seg[j]);
      y[j] = s;
    }
    // b. block scan of the segments' last outputs
    float w = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = fmaf(ap[d], u, w);
    }
    float e = __shfl_up_sync(kFull, w, 1);
    if (lane == 0) e = 0.0f;
    if (lane == 31) wtot[warp] = w;
    __syncthreads();
    if (tid == 0) {
      float cv = scar;
      for (int q = 0; q < kWarps; ++q) {
        wbeg[q] = cv;
        cv = fmaf(ap[32], cv, wtot[q]);
      }
      scar = cv;
    }
    __syncthreads();
    // c. add the zero-input response a^(j+1) v of the true previous output v
    float v = fmaf(ap[lane], wbeg[warp], e);
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      v *= a;
      seg[j] = y[j] + v;
    }
    __syncthreads();
    if (yr != nullptr) store_sub(yr + s0, buf, count, vec);
    __syncthreads();
  }
  if (ends && tid == 0) *cst = scar;
}

// Launch 2. Warp c walks channel c's tiles: carry[c, t] <- s_t, with s_0 the
// seed (zero when null; for D = 2S its layout is (S, C, 2)) and
// s_{t+1} = M s_t + z_t, z_t read from carry[c, t]. Lane r < D holds s[r] and
// row r of M (zeros past D <= W); the tiles' states are staged through shared
// memory in chunks. W is a compile-time width, so the W shuffles of a step
// run with no branch around them.
template <int W>
__global__ void __launch_bounds__(32)
carry_kernel(float* __restrict__ carry, const float* __restrict__ M,
             const float* __restrict__ seed, int64_t ntiles, int C, int D) {
  __shared__ float st[kChunkTiles * 32];
  const int c = blockIdx.x;
  const int r = threadIdx.x;
  float m[W];
#pragma unroll
  for (int q = 0; q < W; ++q) m[q] = (r < D && q < D) ? M[r * D + q] : 0.0f;
  float s = 0.0f;
  if (seed != nullptr && r < D) s = seed[(static_cast<int64_t>(r >> 1) * C + c) * 2 + (r & 1)];
  float* base = carry + static_cast<int64_t>(c) * ntiles * D;
  for (int64_t t0 = 0; t0 < ntiles; t0 += kChunkTiles) {
    const int cnt = static_cast<int>(ntiles - t0 < kChunkTiles ? ntiles - t0 : kChunkTiles);
    float* g = base + t0 * D;
    // unrolled so that the loads are in flight together, not one at a time
#pragma unroll 8
    for (int k = r; k < cnt * D; k += 32) st[k] = g[k];
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < cnt; ++i) {
      const float z = r < D ? st[i * D + r] : 0.0f;
      if (r < D) st[i * D + r] = s;
      // z of the last tile was never written (launch 1 skips it): s is not used after it
      float acc0 = z, acc1 = 0.0f;
#pragma unroll
      for (int q = 0; q < W; q += 2) {
        acc0 = fmaf(m[q], __shfl_sync(kFull, s, q), acc0);
        if constexpr (W > 1) acc1 = fmaf(m[q + 1], __shfl_sync(kFull, s, q + 1), acc1);
      }
      s = acc0 + acc1;
    }
    __syncwarp();
#pragma unroll 8
    for (int k = r; k < cnt * D; k += 32) g[k] = st[k];
    __syncwarp();
  }
}

// Launch 2 at the narrowest width that holds D state lanes.
static cudaError_t launch_carry(float* carry, const float* M, const float* seed, int64_t ntiles,
                                int C, int D, cudaStream_t s) {
  const auto g = static_cast<unsigned>(C);
  if (D <= 1) {
    carry_kernel<1><<<g, 32, 0, s>>>(carry, M, seed, ntiles, C, D);
  } else if (D <= 2) {
    carry_kernel<2><<<g, 32, 0, s>>>(carry, M, seed, ntiles, C, D);
  } else if (D <= 4) {
    carry_kernel<4><<<g, 32, 0, s>>>(carry, M, seed, ntiles, C, D);
  } else if (D <= 8) {
    carry_kernel<8><<<g, 32, 0, s>>>(carry, M, seed, ntiles, C, D);
  } else if (D <= 16) {
    carry_kernel<16><<<g, 32, 0, s>>>(carry, M, seed, ntiles, C, D);
  } else {
    carry_kernel<32><<<g, 32, 0, s>>>(carry, M, seed, ntiles, C, D);
  }
  return cudaGetLastError();
}

using TileKernel = void (*)(const float*, float*, const float*, int, float*, float*, int64_t,
                            int64_t, int64_t, int, int);

static bool bad_geometry(int64_t n, int64_t channels, int64_t tile) {
  if (n < 1 || channels < 1 || channels > 65535 || tile < kSub || tile % kSub != 0) return true;
  return (n + tile - 1) / tile > 0x7fffffff;
}

// The three launches of one cascade of `sections` (S) sections, kernel k.
static cudaError_t cascade(TileKernel k, const float* x, float* y, const float* tab,
                           float* carry, const float* M, const float* seed, float* state_out,
                           int64_t n, int C, int S, int64_t tile, cudaStream_t s) {
  const int64_t ntiles = (n + tile - 1) / tile;
  cudaError_t err;
  if (ntiles > 1) {
    k<<<dim3(static_cast<unsigned>(ntiles - 1), static_cast<unsigned>(C)), kThreads, 0, s>>>(
        x, nullptr, tab, S, carry, nullptr, n, tile, ntiles, C, 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = launch_carry(carry, M, seed, ntiles, C, 2 * S, s)) != cudaSuccess) return err;
  k<<<dim3(static_cast<unsigned>(ntiles), static_cast<unsigned>(C)), kThreads, 0, s>>>(
      x, y, tab, S, carry, state_out, n, tile, ntiles, C, 0);
  return cudaGetLastError();
}

// ---- B12: the cascade in one pass, with a fixed-depth look-back ------------
//
// One launch reads x once and runs the cascade once. Blocks are persistent
// (as many as fit the card) and take tiles by an atomic ticket, channels
// interleaved: ticket k is tile k / C of channel k % C. A block takes a ticket
// only when it is ready to start that tile, so tiles start in ticket order; it
// only ever waits on tiles of smaller tickets, which blocks already running
// hold, so it cannot deadlock. For each tile:
//   A. stage. The tile's sub-tiles (kSub = 256 kSeg samples, thread i owning
//      kSeg consecutive samples, rows swizzled so that a quarter warp's 16-byte
//      reads fall on distinct banks) go to shared memory by 16-byte cp.async,
//      a copy group a sub-tile, and stay there, up to `hold` sub-tiles; a
//      longer tile streams its other sub-tiles through one slot, and reads
//      them again in D.
//   B. the tile's end state from zero state, as a linear map, not a cascade
//      run, started on each sub-tile as its copy group lands. From zero state
//      the state after a segment is z_i = K x_i (K is D x kSeg, D = 2S); the
//      tile's is sum_i M_seg^(n-1-i) z_i. Lane l takes W_l = M_seg^(31-l) K
//      (the wrapper's table, read through L1): its kSeg-term dot product for
//      each component q (D FMAs a sample), the D partial sums summed over the
//      warp by a transposing butterfly (a lane keeps half of its sums and
//      sends the other half, log2 DP steps, DP = D rounded up to a power of
//      two: a template, so the sums stay in registers). A warp chains its
//      groups of successive sub-tiles by M_sub (Horner), then weighs its sum
//      by M_warp^e, e its last group's distance from the tile's end; the
//      warps' sums are added in a fixed order.
//   C. the look-back. The tile publishes z_t, then
//        s_t = sum_{m=1..L} M^(m-1) z_{t-m} + M^L s_{t-L}
//      (tiles t < L compose back to the seed: M^t s_0), with M the cascade's
//      zero-input transition over a tile and L a depth fixed by S, and
//      publishes s_t for tile t+L. The z terms are summed before the wait on
//      s_{t-L}, so a step of the chain costs one poll and D FMAs. The sum
//      is always taken in the same order: two calls give bit-identical y.
//      Each published float is one 64-bit word, a flag in its high half, so
//      a reader needs no fence; the words are zeroed by a memset a call.
//   D. the cascade once, from s_t, over the staged sub-tiles in order: a
//      section is steps a-c of the three-launch design above, with one
//      block barrier (the warps' totals are chained by every warp, lanes
//      0..7 scanning them with the powers Phi^(32 kSeg d), each warp keeping
//      its own copy of the carry); the thread holding sample n-1 keeps its
//      segment's input and start state a section and, after the sections,
//      runs them to n-1 for the chunk's end state.
// Tables (float64, rounded once, built by the wrapper): a section's row
// (kTabL floats: b0 b1 b2 a1 a2; Phi^(kSeg m), m = 0..32, at 8;
// Phi^(32 kSeg m), m = 0..8, at kWarpPow) in shared memory; W, M_sub,
// M_warp^e (e < 8) and M^m (m <= L) in device memory, read through L1.
// kSeg = 16, 256 threads and the tile were chosen by tools/ab_lookback_direct.py.
//
// What bounds it on the H100: memory bytes, 8 a sample (0.160 ms for
// 16 x 2^22 samples at 3.35 TB/s); it moves 8 plus 8 D bytes a tile of
// look-back records. Its operations, D FMAs a sample for B and about 8 a
// sample and section for D, stay below that at 66.9 TFLOP/s. What holds it
// above: a tile's loads, B and D follow one another in each block, and the
// blocks of an SM run nearly in step, so memory and compute add up more than
// they overlap; a block cannot prefetch its next tile, as holding a ticket
// before it can start the tile stalls the look-back of the tiles behind it.
//
// B13 (the TPU's _biquad_fused_kernel, B12 with its sections unrolled) is
// this kernel with NS = 1..8 sections fixed at compile time and zero state:
// D = 2 NS is a constant, so the end-state pass's Horner and weight steps and
// the look-back's D-term sums unroll with every index constant. The
// arithmetic and its order are B12's, term for term. Unrolling the sections
// of D as well, with each section's coefficients in registers for the whole
// launch, was slower on the H100 (it spilled under the 80 registers that
// three blocks an SM leave; tools/ab_windowed_b13.py times both), so D's
// section loop stays B12's. What bounds B13 is what bounds B12: the stage and
// store traffic, then the end-state pass and the sections, one after another
// in each block.
constexpr int kLbThreads = 256;             // B12's threads a block
constexpr int kLbWarps = kLbThreads / 32;
constexpr int kTabL = 176;     // floats of a section's B12 row
constexpr int kWarpPow = 140;  // where Phi^(32 kSeg m) starts in it
constexpr int kLbSeg = 16;     // B12's consecutive samples a thread
constexpr int kMaxDepth = 8;   // the deepest look-back
constexpr int kHoldBytes = 65536;  // shared bytes of staged sub-tiles a block holds at most
constexpr unsigned long long kFlag = 1ull << 32;

// The look-back depth for S sections.
static __host__ __device__ constexpr int lookback_depth(int sections) {
  return sections <= 8 ? 8 : 4;
}

template <int SEG>
static __device__ __forceinline__ int swizzle(int row) {
  return (row / (32 / SEG)) & (SEG / 4 - 1);
}

// Sample k of a sub-tile in a slot: row k / SEG, its 16-byte chunks swizzled.
template <int SEG>
static __device__ __forceinline__ int lb_slot(int k) {
  const int row = k / SEG, p = k % SEG;
  return row * SEG + 4 * ((p >> 2) ^ swizzle<SEG>(row)) + (p & 3);
}

// slot <- x[0, count), zeros beyond: 16-byte cp.async where whole and aligned.
template <int SEG>
static __device__ __forceinline__ void lb_load(const float* x, float* slot, int count, bool vec) {
  constexpr int kSub = kLbThreads * SEG;
  for (int g = threadIdx.x; g < kSub / 4; g += kLbThreads) {
    float* dst = slot + lb_slot<SEG>(4 * g);
    if (vec && 4 * g + 4 <= count) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(x + 4 * g));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = 4 * g + e < count ? x[4 * g + e] : 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

static __device__ __forceinline__ void lb_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits until at most `pending` (0..3) of the thread's latest copy groups are in flight.
static __device__ __forceinline__ void lb_wait_for(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

template <int SEG>
static __device__ __forceinline__ void lb_store(float* y, const float* slot, int count, bool vec) {
  constexpr int kSub = kLbThreads * SEG;
  for (int g = threadIdx.x; g < kSub / 4 && 4 * g < count; g += kLbThreads) {
    const float* src = slot + lb_slot<SEG>(4 * g);
    if (vec && 4 * g + 4 <= count) {
      reinterpret_cast<float4*>(y)[g] = *reinterpret_cast<const float4*>(src);
    } else {
      for (int e = 0; 4 * g + e < count && e < 4; ++e) y[4 * g + e] = src[e];
    }
  }
}

template <int SEG>
static __device__ __forceinline__ void lb_row(const float* slot, float (&v)[SEG]) {
  const int row = threadIdx.x;
  const float4* p = reinterpret_cast<const float4*>(slot + row * SEG);
  const int f = swizzle<SEG>(row);
#pragma unroll
  for (int q = 0; q < SEG / 4; ++q) {
    const float4 a = p[q ^ f];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

template <int SEG>
static __device__ __forceinline__ void lb_put_row(float* slot, const float (&v)[SEG]) {
  const int row = threadIdx.x;
  float4* p = reinterpret_cast<float4*>(slot + row * SEG);
  const int f = swizzle<SEG>(row);
#pragma unroll
  for (int q = 0; q < SEG / 4; ++q) p[q ^ f] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

static __device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

static __device__ __forceinline__ void st_relaxed(unsigned long long* p, float v) {
  const unsigned long long w = kFlag | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

// The published float at p, once its flag is set.
static __device__ __forceinline__ float lb_poll(const unsigned long long* p) {
  unsigned long long w = ld_relaxed(p);
  while (!(w & kFlag)) {
    __nanosleep(32);
    w = ld_relaxed(p);
  }
  return __uint_as_float(static_cast<unsigned>(w));
}

// One section over a thread's samples (steps a-c), in place in v. tb: the
// section's row (its powers); k: its coefficients; car: this warp's copy of its carry (left at the sub-tile's
// end); wt: the warps' totals (16 floats, by the section's parity). Returns
// the thread's start state in r1, r2.
template <int SEG>
static __device__ __forceinline__ void lb_section(float (&v)[SEG], const float* tb, const Coef k,
                                                  float* car, float* wt, float& r1, float& r2) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float b0 = k.b0, b1 = k.b1, b2 = k.b2, a1 = k.a1, a2 = k.a2;
  // a. zero-state run
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < SEG; ++j) {
    const float xv = v[j];
    const float yv = fmaf(b0, xv, s1);
    s1 = fmaf(b1, xv, fmaf(-a1, yv, s2));
    s2 = fmaf(b2, xv, -a2 * yv);
    v[j] = yv;
  }
  // b. the warp's Hillis-Steele steps with Phi^(SEG d), then the warps'
  // totals, chained by lanes 0..7 of every warp with Phi^(32 SEG d)
  const float4* lp = reinterpret_cast<const float4*>(tb + 8);
  const float4* wp = reinterpret_cast<const float4*>(tb + kWarpPow);
  float w1 = s1, w2 = s2;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u1 = __shfl_up_sync(kFull, w1, d);
    const float u2 = __shfl_up_sync(kFull, w2, d);
    if (lane >= d) {
      const float4 P = lp[d];
      w1 = fmaf(P.x, u1, fmaf(P.y, u2, w1));
      w2 = fmaf(P.z, u1, fmaf(P.w, u2, w2));
    }
  }
  float e1 = __shfl_up_sync(kFull, w1, 1);
  float e2 = __shfl_up_sync(kFull, w2, 1);
  if (lane == 0) {
    e1 = 0.0f;
    e2 = 0.0f;
  }
  if (lane == 31) {
    wt[2 * warp] = w1;
    wt[2 * warp + 1] = w2;
  }
  const float c1 = car[0], c2 = car[1];
  __syncthreads();  // the section's one barrier
  float t1 = lane < kLbWarps ? wt[2 * lane] : 0.0f;
  float t2 = lane < kLbWarps ? wt[2 * lane + 1] : 0.0f;
#pragma unroll
  for (int d = 1; d < kLbWarps; d <<= 1) {
    const float u1 = __shfl_up_sync(kFull, t1, d);
    const float u2 = __shfl_up_sync(kFull, t2, d);
    if (lane >= d) {
      const float4 P = wp[d];
      t1 = fmaf(P.x, u1, fmaf(P.y, u2, t1));
      t2 = fmaf(P.z, u1, fmaf(P.w, u2, t2));
    }
  }
  float x1 = __shfl_sync(kFull, t1, warp > 0 ? warp - 1 : 0);
  float x2 = __shfl_sync(kFull, t2, warp > 0 ? warp - 1 : 0);
  if (warp == 0) {
    x1 = 0.0f;
    x2 = 0.0f;
  }
  const float l1 = __shfl_sync(kFull, t1, kLbWarps - 1);
  const float l2 = __shfl_sync(kFull, t2, kLbWarps - 1);
  const float4 PW = wp[warp];
  const float g1 = fmaf(PW.x, c1, fmaf(PW.y, c2, x1));  // the state entering this warp
  const float g2 = fmaf(PW.z, c1, fmaf(PW.w, c2, x2));
  const float4 P8 = wp[kLbWarps];
  __syncwarp();  // every lane has read the carry
  if (lane == 0) {
    car[0] = fmaf(P8.x, c1, fmaf(P8.y, c2, l1));
    car[1] = fmaf(P8.z, c1, fmaf(P8.w, c2, l2));
  }
  const float4 PL = lp[lane];
  r1 = fmaf(PL.x, g1, fmaf(PL.y, g2, e1));
  r2 = fmaf(PL.z, g1, fmaf(PL.w, g2, e2));
  // c. the zero-input response of the start state
  float q1 = r1, q2 = r2;
#pragma unroll
  for (int j = 0; j < SEG; ++j) {
    v[j] += q1;
    const float n1 = fmaf(-a1, q1, q2);
    q2 = -a2 * q1;
    q1 = n1;
  }
}

// A warp's partial sums p[q] (q < DP) of one group, summed over its 32 lanes:
// log2(DP) steps in which a lane keeps half of its values and sends its
// partner the other half, then plain steps. Lane l ends with component
// l / (32 / DP), which the lanes sharing it hold alike.
template <int DP>
static __device__ __forceinline__ float warp_components(float (&p)[DP]) {
  constexpr int kLog = DP == 4 ? 2 : DP == 8 ? 3 : DP == 16 ? 4 : 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int lv = 0; lv < kLog; ++lv) {
    const int h = DP >> (lv + 1);
    const int d = 16 >> lv;
    const bool up = (lane & d) != 0;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      if (i < h) {
        const float send = up ? p[i] : p[i + h];
        const float keep = up ? p[i + h] : p[i];
        p[i] = keep + __shfl_xor_sync(kFull, send, d);
      }
    }
  }
  float v = p[0];
#pragma unroll
  for (int lv = kLog; lv < 5; ++lv) v += __shfl_xor_sync(kFull, v, 16 >> lv);
  return v;
}

// Shared floats of the block's buffers past its slots.
static __host__ __device__ constexpr int lb_small_floats(int sections, int seg) {
  return sections * kTabL + 2 * kLbWarps * 2 * sections + 32 + sections * (seg + 2);
}

// The block's ticket `tk`: tile t of channel c, and what it stages.
struct LbTile {
  int64_t t, t0, t1;
  int c, subs, keep;
};

template <int SEG>
static __device__ __forceinline__ LbTile lb_tile(long long tk, int C, int64_t n, int64_t tile,
                                                 int hold) {
  constexpr int kSub = kLbThreads * SEG;
  LbTile g;
  g.t = tk / C;
  g.c = static_cast<int>(tk - g.t * C);
  g.t0 = g.t * tile;
  g.t1 = g.t0 + tile < n ? g.t0 + tile : n;
  g.subs = static_cast<int>((g.t1 - g.t0 + kSub - 1) / kSub);
  g.keep = g.subs > hold ? hold - 1 : g.subs;  // sub-tiles held from staging to D
  return g;
}

// Stages the held sub-tiles of a tile into `buf` (cp.async, not waited for).
template <int SEG>
static __device__ __forceinline__ void lb_stage(const float* x, float* buf, const LbTile& g,
                                                int64_t n) {
  constexpr int kSub = kLbThreads * SEG;
  const float* xr = x + g.c * n + g.t0;
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  for (int j = 0; j < g.keep; ++j) {
    const int64_t left = g.t1 - g.t0 - static_cast<int64_t>(j) * kSub;
    lb_load<SEG>(xr + static_cast<int64_t>(j) * kSub, buf + j * kSub,
                 static_cast<int>(left < kSub ? left : kSub), vec);
  }
}

// mats: W (D SEG 32 floats; lane l's weights of component q, samples
// 4 i4 .. 4 i4 + 3, at float4 (q SEG / 4 + i4) 32 + l), then M_sub (D x D),
// M_warp^e for e < 8, M^m for m <= L, each D x D stored [q][r] (entry r, q).
// rec: the ticket, then z records then s records, C ntiles D words each.
// DP: D rounded up to 4, 8, 16 or 32, the partial sums a lane keeps in B.
// NS: 0, the section count `sections` read at run time (B12); or 1..8, the
// count fixed at compile time (B13: `sections` == NS, zero state).
template <int SEG, int DP, int NS>
__global__ void __launch_bounds__(kLbThreads, 3)
sos_lookback_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float* __restrict__ tab, const float* __restrict__ mats,
                    const float* __restrict__ seed, float* __restrict__ state_out,
                    unsigned long long* __restrict__ rec, int sections, int64_t n, int64_t tile,
                    int64_t ntiles, int C, int hold) {
  constexpr int kSub = kLbThreads * SEG;
  constexpr int kSh = DP == 4 ? 3 : DP == 8 ? 2 : DP == 16 ? 1 : 0;  // lane >> kSh: its component in B
  extern __shared__ __align__(16) float lsm[];
  __shared__ long long ticket;
  const int S = NS > 0 ? NS : sections, D = 2 * S, L = lookback_depth(S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane < D ? lane : 0;  // this lane's state component (lanes < D)
  float* slots = lsm;               // `hold` sub-tiles
  float* stab = slots + hold * kSub;
  float* scar = stab + S * kTabL;   // kLbWarps copies of the carry, D floats each
  float* zpart = scar + kLbWarps * D;  // the warps' sums of the end state
  float* wtot = zpart + kLbWarps * D;  // 2 x 16: the warps' totals by section parity
  float* endbuf = wtot + 32;        // S x (SEG + 2): the end-state thread's inputs
  const float4* W = reinterpret_cast<const float4*>(mats);
  const float* Msub = mats + D * SEG * 32;
  const float* Qw = Msub + D * D;
  const float* Mp = Qw + 8 * D * D;
  unsigned long long* zrec = rec + 1;
  unsigned long long* srec = zrec + ntiles * C * D;
  for (int i = tid; i < S * kTabL; i += kLbThreads) stab[i] = tab[i];
  const int64_t total = ntiles * C;
  const int G = static_cast<int>(tile / (32 * SEG));  // warp groups of a whole tile
  // A block takes a ticket only when it is ready to start that tile: tiles
  // then start in ticket order, which the look-back's progress needs (a ticket
  // held while the block finishes another tile stalls the tiles behind it)
  for (;;) {
    if (tid == 0) ticket = static_cast<long long>(atomicAdd(rec, 1ull));
    __syncthreads();
    const long long tk = ticket;
    if (tk >= total) break;
    // A. stage, a copy group a sub-tile: B starts on the first while the rest land
    const LbTile g = lb_tile<SEG>(tk, C, n, tile, hold);
    lb_stage<SEG>(x, slots, g, n);
    const int64_t t = g.t, t0 = g.t0;
    const int c = g.c, subs = g.subs, keep = g.keep;
    float* cur = slots;
    const float* xr = x + c * n;
    float* yr = y + c * n;
    const bool vec = ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
    const bool last = t == ntiles - 1;
    auto count_of = [&](int j) {
      const int64_t left = g.t1 - t0 - static_cast<int64_t>(j) * kSub;
      return static_cast<int>(left < kSub ? left : kSub);
    };
    auto stream_in = [&](int j) {  // sub-tile j through the streaming slot
      __syncthreads();
      lb_load<SEG>(xr + t0 + static_cast<int64_t>(j) * kSub, cur + keep * kSub, count_of(j), vec);
      lb_wait();
      __syncthreads();
    };
    // B. the end state from zero state (no tile reads the last tile's)
    if (!last) {
      const int comp = lane >> kSh;  // the component this lane sums up
      const int rc = comp < D ? comp : 0;
      float acc = 0.0f;
      int groups = 0;
      for (int j = 0; j < subs; ++j) {
        if (j < keep) {
          lb_wait_for(keep - 1 - j);
          __syncthreads();
        } else {
          stream_in(j);
        }
        if (kLbWarps * j + warp >= G) continue;  // warp-uniform: past the tile
        float xv[SEG];
        lb_row<SEG>(cur + (j < keep ? j : keep) * kSub, xv);
        float p[DP];
#pragma unroll
        for (int q = 0; q < DP; ++q) {
          float p0 = 0.0f, p1 = 0.0f;
          if (q < D) {
            const float4* wq = W + q * (SEG / 4) * 32 + lane;
#pragma unroll
            for (int i4 = 0; i4 < SEG / 4; ++i4) {
              const float4 w = __ldg(wq + 32 * i4);
              p0 = fmaf(w.x, xv[4 * i4], p0);
              p1 = fmaf(w.y, xv[4 * i4 + 1], p1);
              p0 = fmaf(w.z, xv[4 * i4 + 2], p0);
              p1 = fmaf(w.w, xv[4 * i4 + 3], p1);
            }
          }
          p[q] = p0 + p1;
        }
        const float u = warp_components<DP>(p);
        if (groups > 0) {  // acc <- M_sub acc + u
          float h = u;
          for (int q = 0; q < D; ++q) {
            h = fmaf(__ldg(Msub + q * D + rc), __shfl_sync(kFull, acc, q << kSh), h);
          }
          acc = h;
        } else {
          acc = u;
        }
        ++groups;
      }
      float v = 0.0f;
      if (groups > 0) {  // weigh by M_warp^e, e the last group's distance from the tile's end
        const int e = G - 1 - (kLbWarps * (groups - 1) + warp);
        const float* Q = Qw + e * D * D;
        for (int q = 0; q < D; ++q) v = fmaf(__ldg(Q + q * D + rc), __shfl_sync(kFull, acc, q << kSh), v);
      }
      if (comp < D && (lane & ((1 << kSh) - 1)) == 0) zpart[warp * D + comp] = v;
    } else {
      lb_wait();
    }
    __syncthreads();
    // C. the look-back (warp 0; lane q < D holds component q)
    if (warp == 0) {
      const int64_t base = (static_cast<int64_t>(c) * ntiles + t) * D;
      if (!last) {
        float z = 0.0f;
        for (int w = 0; w < kLbWarps; ++w) z += zpart[w * D + r];
        if (lane < D) st_relaxed(zrec + base + lane, z);
      }
      const int terms = t < L ? static_cast<int>(t) : L;
      // every z record's load in flight before any wait
      unsigned long long zw[kMaxDepth];
#pragma unroll
      for (int m = 0; m < kMaxDepth; ++m) {
        zw[m] = (m < terms && lane < D) ? ld_relaxed(zrec + base - (m + 1) * D + lane) : kFlag;
      }
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < kMaxDepth; ++m) {
        if (m < terms) {
          while (!(zw[m] & kFlag)) {
            __nanosleep(32);
            zw[m] = ld_relaxed(zrec + base - (m + 1) * D + lane);
          }
          const float zm = __uint_as_float(static_cast<unsigned>(zw[m]));
          const float* P = Mp + m * D * D;
          for (int q = 0; q < D; ++q) s = fmaf(__ldg(P + q * D + r), __shfl_sync(kFull, zm, q), s);
        }
      }
      float sb = 0.0f;  // s_{t-L}, or the seed
      if (lane < D) {
        if (t >= L) {
          sb = lb_poll(srec + base - static_cast<int64_t>(L) * D + lane);
        } else if (seed != nullptr) {
          sb = seed[(static_cast<int64_t>(lane >> 1) * C + c) * 2 + (lane & 1)];
        }
      }
      const float* P = Mp + terms * D * D;
      for (int q = 0; q < D; ++q) s = fmaf(__ldg(P + q * D + r), __shfl_sync(kFull, sb, q), s);
      if (lane < D) {
        if (t + L < ntiles) st_relaxed(srec + base + lane, s);
        for (int w = 0; w < kLbWarps; ++w) scar[w * D + lane] = s;
      }
    }
    __syncthreads();
    // D. the cascade from s_t
    int mine = -1, jl = 0, jsub = -1;  // the thread and sample index of n - 1
    if (last && state_out != nullptr) {
      const int64_t p = n - 1 - t0;
      jsub = static_cast<int>(p / kSub);
      mine = static_cast<int>((p % kSub) / SEG);
      jl = static_cast<int>(p % SEG);
    }
    for (int j = 0; j < subs; ++j) {
      if (j >= keep) stream_in(j);
      float* slot = cur + (j < keep ? j : keep) * kSub;
      const bool ends = j == jsub && tid == mine;
      float v[SEG];
      lb_row<SEG>(slot, v);
#pragma unroll 1
      for (int k = 0; k < S; ++k) {
        float* eb = endbuf + k * (SEG + 2);
        if (ends) {
#pragma unroll
          for (int i = 0; i < SEG; ++i) eb[i] = v[i];
        }
        float r1, r2;
        lb_section<SEG>(v, stab + k * kTabL, coef_of(stab + k * kTabL), scar + warp * D + 2 * k,
                        wtot + 16 * (k & 1), r1, r2);
        if (ends) {
          eb[SEG] = r1;
          eb[SEG + 1] = r2;
        }
      }
      lb_put_row<SEG>(slot, v);
      __syncthreads();
      lb_store<SEG>(yr + t0 + static_cast<int64_t>(j) * kSub, slot, count_of(j), vec);
      if (j == jsub && tid == mine) {  // the state after sample n - 1, a section at a time
        for (int k = 0; k < S; ++k) {
          const float* tb = stab + k * kTabL;
          const float* eb = endbuf + k * (SEG + 2);
          const float b0 = tb[0], b1 = tb[1], b2 = tb[2], a1 = tb[3], a2 = tb[4];
          float s1 = eb[SEG], s2 = eb[SEG + 1];
          for (int i = 0; i <= jl; ++i) {
            const float u = eb[i];
            const float yv = fmaf(b0, u, s1);
            s1 = fmaf(b1, u, fmaf(-a1, yv, s2));
            s2 = fmaf(b2, u, -a2 * yv);
          }
          state_out[(static_cast<int64_t>(k) * C + c) * 2] = s1;
          state_out[(static_cast<int64_t>(k) * C + c) * 2 + 1] = s2;
        }
      }
    }
    __syncthreads();  // the slots and the ticket are free for the next tile
  }
}

using LbKernel = void (*)(const float*, float*, const float*, const float*, const float*,
                          float*, unsigned long long*, int, int64_t, int64_t, int64_t, int, int);

constexpr int kLbInstances = 4 + kMaxUnrolled;  // B12 by DP, then B13 by NS

// The instantiation for S sections (B13's when `unrolled`, 1..kMaxUnrolled
// sections), its index among the instances, and so its record of the shared
// memory allowed on each device.
static LbKernel lb_kernel(int sections, bool unrolled, int* which) {
  if (unrolled) {
    *which = 3 + sections;
    switch (sections) {
      case 1: return sos_lookback_kernel<kLbSeg, 4, 1>;
      case 2: return sos_lookback_kernel<kLbSeg, 4, 2>;
      case 3: return sos_lookback_kernel<kLbSeg, 8, 3>;
      case 4: return sos_lookback_kernel<kLbSeg, 8, 4>;
      case 5: return sos_lookback_kernel<kLbSeg, 16, 5>;
      case 6: return sos_lookback_kernel<kLbSeg, 16, 6>;
      case 7: return sos_lookback_kernel<kLbSeg, 16, 7>;
      default: return sos_lookback_kernel<kLbSeg, 16, 8>;
    }
  }
  const int D = 2 * sections;
  *which = D <= 4 ? 0 : D <= 8 ? 1 : D <= 16 ? 2 : 3;
  switch (*which) {
    case 0: return sos_lookback_kernel<kLbSeg, 4, 0>;
    case 1: return sos_lookback_kernel<kLbSeg, 8, 0>;
    case 2: return sos_lookback_kernel<kLbSeg, 16, 0>;
    default: return sos_lookback_kernel<kLbSeg, 32, 0>;
  }
}

static int lb_allowed[kLbInstances][kMaxDevices] = {};

// Sub-tiles a block holds for a tile of `tile` samples, and its shared bytes.
static int lb_hold(int64_t tile) {
  constexpr int kSub = kLbThreads * kLbSeg;
  const int64_t subs = (tile + kSub - 1) / kSub;
  const int cap = kHoldBytes / (4 * kSub);
  return static_cast<int>(subs < cap ? subs : cap);
}

static int lb_smem_bytes(int sections, int hold) {
  return 4 * (hold * kLbThreads * kLbSeg + lb_small_floats(sections, kLbSeg));
}

static cudaError_t lb_occupancy(int sections, bool unrolled, int hold, int* blocks) {
  int which = 0;
  const LbKernel k = lb_kernel(sections, unrolled, &which);
  const int bytes = lb_smem_bytes(sections, hold);
  cudaError_t err = allow_smem(k, lb_allowed[which], bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, reinterpret_cast<const void*>(k),
                                                       kLbThreads, bytes);
}

static int lb_blocks[kMaxDevices][2][kMaxSections + 1]
                    [kHoldBytes / (4 * kLbThreads * kLbSeg) + 1] = {};

// B12 (B13 when `unrolled`): the records' memset and the one launch, as many
// blocks as fit the card.
static cudaError_t lookback_cascade(const float* x, float* y, const float* tab, const float* mats,
                                    const float* seed, float* state_out, unsigned long long* rec,
                                    int64_t n, int C, int S, int64_t tile, bool unrolled,
                                    cudaStream_t s) {
  const int64_t ntiles = (n + tile - 1) / tile;
  const int hold = lb_hold(tile);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& per_sm = lb_blocks[dev][unrolled][S][hold];
  if (per_sm == 0 && (err = lb_occupancy(S, unrolled, hold, &per_sm)) != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  const int64_t total = ntiles * C;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const auto grid = static_cast<unsigned>(total < resident ? total : resident);
  const size_t words = 1 + 2 * static_cast<size_t>(total) * 2 * S;
  if ((err = cudaMemsetAsync(rec, 0, 8 * words, s)) != cudaSuccess) return err;
  int which = 0;
  const LbKernel k = lb_kernel(S, unrolled, &which);
  k<<<grid, kLbThreads, lb_smem_bytes(S, hold), s>>>(x, y, tab, mats, seed, state_out, rec, S,
                                                     n, tile, ntiles, C, hold);
  return cudaGetLastError();
}

// ---- B11: the first-order recurrence as a compose of affine maps ----------
//
// The TPU kernel gives every sample the map y -> alpha*y + beta with
// (alpha, beta) = (a, b*x), composes the maps by Hillis-Steele steps across
// the 128 lanes of a row, then down the rows, and applies the composed maps
// to the carried y; it keeps no table of powers of a (B10 does). Here a
// thread composes its kSeg samples' maps in order, a warp composes the
// threads' maps with shuffles, and thread 0 composes the warps' maps,
// through shared memory, onto the block's running map. Map l after map r is
// (l.alpha r.alpha, l.alpha r.beta + l.beta). The cross-tile carry is B10's
// three launches with maps in place of states: launch 1 writes each tile's
// composed map from zero state (alpha = a^tile, beta = the tile's last
// output) to carry[c, t]; launch 2 (affine_carry_kernel) composes them
// along the channel and leaves the state entering each tile; launch 3
// applies. Every power of a is a product taken in the kernel.
//
// alpha is a product of up to a tile's factors a and is composed in
// float64, rounded to float32 only where it multiplies a beta: composed in
// float32, its rounding grows with the length of the product, and a float32
// compose failed the port's bound (1e-5 of max|y| from B10's plain version)
// at a = 0.9999 over 16 x 2^22 samples on an H100. beta stays float32, as
// B10's state.
//
// What bounds it on the H100: memory bytes, as B10 (8 bytes a sample for the
// function, 12 as built: x is read by launches 1 and 3). It does about 6
// float32 and 1 float64 operations a sample, far below either rate.
__global__ void __launch_bounds__(kThreads)
iir1_affine_tile_kernel(const float* __restrict__ x, float* __restrict__ y, float a, float b,
                        float* __restrict__ carry, int64_t n, int64_t tile, int64_t ntiles,
                        int ends) {
  __shared__ float buf[kThreads * kRow];
  __shared__ double walpha[kWarps];
  __shared__ float wbeta[kWarps];
  __shared__ float wbeg[kWarps];
  __shared__ double run_alpha;  // the tile's map so far
  __shared__ float run_beta;    // in launch 3, the state
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.y;
  const int64_t t = blockIdx.x;
  float* cst = carry + (static_cast<int64_t>(c) * ntiles + t) * 2;
  if (tid == 0) {
    run_alpha = 1.0;
    run_beta = ends ? 0.0f : cst[0];
  }
  __syncthreads();
  const float* xr = x + static_cast<int64_t>(c) * n;
  float* yr = y != nullptr ? y + static_cast<int64_t>(c) * n : nullptr;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
  const int64_t t0 = t * tile;
  const int64_t t1 = t0 + tile < n ? t0 + tile : n;
  float* seg = buf + tid * kRow;
  for (int64_t s0 = t0; s0 < t1; s0 += kSub) {
    const int count = static_cast<int>(t1 - s0 < kSub ? t1 - s0 : kSub);
    load_sub(xr + s0, buf, count, vec);
    __syncthreads();
    // a. this thread's maps composed in order; beta is the zero-state output
    float beta[kSeg];
    double ma = 1.0;
    float mb = 0.0f;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      mb = fmaf(a, mb, b * seg[j]);
      ma *= a;
      beta[j] = mb;
    }
    // b. the warp's threads composed, inclusive, then shifted to exclusive
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double ua = __shfl_up_sync(kFull, ma, d);
      const float ub = __shfl_up_sync(kFull, mb, d);
      if (lane >= d) {
        mb = fmaf(static_cast<float>(ma), ub, mb);
        ma *= ua;
      }
    }
    double ea = __shfl_up_sync(kFull, ma, 1);
    float eb = __shfl_up_sync(kFull, mb, 1);
    if (lane == 0) {
      ea = 1.0;
      eb = 0.0f;
    }
    if (lane == 31) {
      walpha[warp] = ma;
      wbeta[warp] = mb;
    }
    __syncthreads();
    // the warps' maps composed onto the running map; wbeg[w] is the state
    // entering warp w's samples
    if (tid == 0) {
      double ra = run_alpha;
      float rb = run_beta;
      for (int w = 0; w < kWarps; ++w) {
        wbeg[w] = rb;
        rb = fmaf(static_cast<float>(walpha[w]), rb, wbeta[w]);
        ra *= walpha[w];
      }
      run_alpha = ra;
      run_beta = rb;
    }
    __syncthreads();
    // c. apply: y_j = a^(j+1) v + beta_j, v the state entering the thread's samples
    float v = fmaf(static_cast<float>(ea), wbeg[warp], eb);
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      v *= a;
      seg[j] = beta[j] + v;
    }
    __syncthreads();
    if (yr != nullptr) store_sub(yr + s0, buf, count, vec);
    __syncthreads();
  }
  if (ends && tid == 0) {
    cst[0] = static_cast<float>(run_alpha);
    cst[1] = run_beta;
  }
}

// B11's launch 2. Warp c composes channel c's tile maps (carry[c, t] =
// (alpha, beta), alpha composed in float64) 32 tiles at a time and writes
// the state entering tile t to carry[c, t, 0]; the stream starts from zero.
// The last tile's map was never written (launch 1 skips it) and is never
// needed: it counts as the identity.
__global__ void __launch_bounds__(32)
affine_carry_kernel(float* __restrict__ carry, int64_t ntiles) {
  const int lane = threadIdx.x;
  float* base = carry + static_cast<int64_t>(blockIdx.x) * ntiles * 2;
  float s = 0.0f;
  for (int64_t t0 = 0; t0 < ntiles; t0 += 32) {
    const int64_t t = t0 + lane;
    double ma = 1.0;
    float mb = 0.0f;
    if (t < ntiles - 1) {
      ma = base[2 * t];
      mb = base[2 * t + 1];
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double ua = __shfl_up_sync(kFull, ma, d);
      const float ub = __shfl_up_sync(kFull, mb, d);
      if (lane >= d) {
        mb = fmaf(static_cast<float>(ma), ub, mb);
        ma *= ua;
      }
    }
    double ea = __shfl_up_sync(kFull, ma, 1);
    float eb = __shfl_up_sync(kFull, mb, 1);
    if (lane == 0) {
      ea = 1.0;
      eb = 0.0f;
    }
    if (t < ntiles) base[2 * t] = fmaf(static_cast<float>(ea), s, eb);
    s = fmaf(static_cast<float>(__shfl_sync(kFull, ma, 31)), s, __shfl_sync(kFull, mb, 31));
  }
}

// ---- B14: the cascade with its lane pass on the tensor cores ---------------
//
// The TPU kernel is B12 with the in-row (lane) pass of each section spelled
// as a matrix product. With A = Phi = [[-a1, 1], [-a2, 0]] and, for input u,
// c = u (k1, k2), k1 = b1 - a1 b0, k2 = b2 - a2 b0, a section's state moves
// by s' = A s + c, so from zero state at a row's start the state entering
// lane l is s_ex[l] = sum_{j<l} A^(l-1-j) c[j]: its first component is the
// row of u times a matrix T, T[j][l] = (A^(l-1-j))_00 k1 + (A^(l-1-j))_01 k2
// for j < l, else 0, which depends only on the coefficients. The TPU builds
// T once a launch and runs four (rows, 128) @ (128, 128) products a section
// (bf16x3, its HIGHEST precision); then B12's row scan, the carry, and
// y = b0 u + s1.
//
// Here a row is a segment of kL = 32 samples and T is 32 x 32 float64, built
// by the wrapper and never rounded. The products are FP64 tensor-core
// instructions (mma.sync m16n8k8 .f64, Hopper's DMMA shape; the older
// m8n8k4 issues four times the instructions for the same work and ran
// slower on the H100) whose A fragments are the samples themselves: a
// float32 sample is exact in float64, and so are the products and sums to
// float64 rounding, so the lane pass keeps the float32 recurrence's
// accuracy. (One TF32 product keeps 10 mantissa bits, about 1e-3 of
// max|y|.)
//
// The block. Its 8 warps each carry one (channel, tile) of the launch, all
// sharing one staging: T, in the order the B fragments are read, and the
// section's table, for every section (at most 16), are copied to shared
// memory once a block, behind its one barrier. A warp walks its tile in
// sub-tiles of 32 segments (1024 samples, two m-tiles of 16 segments),
// staged by cp.async into its own rows of 36 floats (so that the A reads fall
// on distinct banks), and runs every section over them in place; nothing
// else is shared between warps, so a section costs no block barrier. For
// each section and k-step pair k2 a lane (g = lane/4, tq = lane%4) reads its
// A values, samples 8 k2 + tq and 8 k2 + 4 + tq of segments 8 m + g
// (m < 4), and its B values of n-tile q, T[8 k2 + tq][8 q + g] and
// T[8 k2 + 4 + tq][8 q + g], once for both m-tiles. n-tile q (lanes
// 8q..8q+7) needs only samples j < 8 q + 8, so the pairs k2 > q multiply
// zero blocks of T and are skipped: 20 of the 32 (q, 4-sample) blocks are
// kept, 20 DMMA of 16 x 8 x 8 a section and sub-tile. The accumulators
// (lanes 8q + 2 tq + i of segment 8m + g) stay in registers; the end state,
// s_ex at lane 32, is one float64 step from s_ex1[30], s_ex1[31] and the
// samples 30 and 31, taken by lane tq = 3 of each segment. Rounded to
// float32, the end states go through B12's row scan (lanes of one warp,
// Phi^(32 d) from the table, Phi^1024 onto the section's carry), and each
// sample gets y = b0 u + s_ex1 + (A^l s_r)_1 of its segment's entry state
// s_r, in place in the warp's rows. Launches 2 and 3 are B12's (the carry
// warp, the cascade's transition over a tile).
//
// What bounds it on the H100: the function's bytes, 8 a sample (0.160 ms for
// 16 x 2^22 samples); the design's operations, 20 blocks of 8 x 4 = 640 FP64
// multiply-adds a segment, 40 flops a sample and section, twice (launches 1
// and 3), at the tensor cores' 67 TFLOP/s in FP64 (NVIDIA's data sheet), are
// about 2.5 times that bound at 5 sections. It is the anchor against B12,
// whose scan does about 16 float32 operations a sample and section.
constexpr int kL = 32;                        // samples a segment
constexpr int kMxuWarps = 8;                  // warps a block, one (channel, tile) each
constexpr int kMxuThreads = 32 * kMxuWarps;
constexpr int kMxuSub = 32 * kL;              // samples a warp's sub-tile
constexpr int kMxuFrags = 20;                 // (n-tile q, 4-sample kk) blocks, kk < 2q + 2
constexpr int kMxuSec = 32 * kMxuFrags + 4;   // doubles a section: T's fragments, a1 a2 k1 k2
constexpr int kMxuRow = kL + 4;               // floats of a segment's row in a warp's buffer
constexpr int kTabMxu = 272;                  // floats of a section's table
constexpr int kPowL = 8 + 4 * 33;             // where A^l, l = 0..31, starts

// A section's B14 table (kTabMxu floats): b0, b1, b2, a1, a2 at 0..4, k1 and
// k2 at 5, 6; at kPow + 4m the 2x2 Phi^(kL m), row-major, for m = 0..32; at
// kPowL + 4l the 2x2 A^l, l < 32. A section's fragments (kMxuSec doubles):
// block (q, kk) at 32 (q (q + 1) + kk), lane i's B value T[4 kk + i%4][8 q +
// i/4]; then a1, a2, k1, k2 in float64.

static __host__ __device__ constexpr int mxu_smem_bytes(int sections) {
  return sections * (8 * kMxuSec + 4 * kTabMxu) +
         4 * kMxuWarps * (32 * kMxuRow + 2 * kMaxSections);
}

// d += a b over one 16x8x8 FP64 tile (mma.sync, Hopper's DMMA shape): A
// row-major (a0: row lane/4, a1: row lane/4 + 8, column lane%4; a2, a3: the
// same rows, column lane%4 + 4), B column-major (b0: row lane%4, b1: row
// lane%4 + 4, column lane/4), D (d0, d1: row lane/4, d2, d3: row lane/4 + 8;
// columns 2 (lane%4) and 2 (lane%4) + 1).
static __device__ __forceinline__ void dmma(double& d0, double& d1, double& d2, double& d3,
                                                double a0, double a1, double a2, double a3,
                                                double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The warp's rows take samples x[0, count), zeros beyond: 16-byte copies
// (cp.async, waited for here) when `vec` and the sub-tile is whole, else
// plain loads.
static __device__ __forceinline__ void mxu_load(const float* x, float* rows, int count, bool vec,
                                                int lane) {
  if (vec && count == kMxuSub) {
#pragma unroll
    for (int i = 0; i < kMxuSub / 128; ++i) {
      const int q = lane + 32 * i;  // float4 q: segment q / 8, samples 4 (q % 8) ..
      cp_async16(rows + (q >> 3) * kMxuRow + 4 * (q & 7), x + 4 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    for (int i = lane; i < kMxuSub; i += 32) rows[(i / kL) * kMxuRow + i % kL] = i < count ? x[i] : 0.0f;
  }
  __syncwarp();
}

static __device__ __forceinline__ void mxu_store(float* y, const float* rows, int count, bool vec,
                                                 int lane) {
  if (vec && count == kMxuSub) {
#pragma unroll
    for (int i = 0; i < kMxuSub / 128; ++i) {
      const int q = lane + 32 * i;
      reinterpret_cast<float4*>(y)[q] =
          *reinterpret_cast<const float4*>(rows + (q >> 3) * kMxuRow + 4 * (q & 7));
    }
  } else {
    for (int i = lane; i < count; i += 32) y[i] = rows[(i / kL) * kMxuRow + i % kL];
  }
}

// One section over a warp's sub-tile, in place in its rows; car: the
// section's carry (2 floats, the state at the sub-tile's start, left at its
// end).
static __device__ __forceinline__ void mxu_section(float* rows, const double* frag,
                                                   const float* tb, float* car, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  // the lane pass: s_ex1 of every sample, FP64 on the tensor cores
  double acc[4][4][2];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q][0] = acc[m][q][1] = 0.0;
  }
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) {  // samples 8 k2 .. 8 k2 + 7: k-steps 2 k2, 2 k2 + 1
    double a[4][2];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      a[m][0] = rows[(8 * m + g) * kMxuRow + 8 * k2 + tq];
      a[m][1] = rows[(8 * m + g) * kMxuRow + 8 * k2 + 4 + tq];
    }
#pragma unroll
    for (int q = k2; q < 4; ++q) {  // k2 <= q: the blocks of T that are not zero
      const double b0 = frag[32 * (q * (q + 1) + 2 * k2) + lane];
      const double b1 = frag[32 * (q * (q + 1) + 2 * k2 + 1) + lane];
#pragma unroll
      for (int m = 0; m < 4; m += 2) {
        dmma(acc[m][q][0], acc[m][q][1], acc[m + 1][q][0], acc[m + 1][q][1], a[m][0],
                 a[m + 1][0], a[m][1], a[m + 1][1], b0, b1);
      }
    }
  }
  // the end state of segment 8m + g (lane tq = 3 holds s_ex1 at 30 and 31),
  // gathered to lane r = segment r
  const double a1 = frag[32 * kMxuFrags], a2 = frag[32 * kMxuFrags + 1];
  const double k1 = frag[32 * kMxuFrags + 2], k2 = frag[32 * kMxuFrags + 3];
  float w1 = 0.0f, w2 = 0.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float* row = rows + (8 * m + g) * kMxuRow;
    const double s30 = acc[m][3][0], s31 = acc[m][3][1];
    const double u30 = row[30], u31 = row[31];
    const float e1 = static_cast<float>(fma(-a1, s31, fma(-a2, s30, fma(k2, u30, k1 * u31))));
    const float e2 = static_cast<float>(fma(-a2, s31, k2 * u31));
    const int src = 4 * (lane & 7) + 3;
    const float v1 = __shfl_sync(kFull, e1, src);
    const float v2 = __shfl_sync(kFull, e2, src);
    if ((lane >> 3) == m) {
      w1 = v1;
      w2 = v2;
    }
  }
  // the row scan: w_r = sum over segments j <= r of Phi^(kL (r - j)) z_j
  const float* pw = tb + kPow;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u1 = __shfl_up_sync(kFull, w1, d);
    const float u2 = __shfl_up_sync(kFull, w2, d);
    if (lane >= d) {
      const float* P = pw + 4 * d;
      w1 = fmaf(P[0], u1, fmaf(P[1], u2, w1));
      w2 = fmaf(P[2], u1, fmaf(P[3], u2, w2));
    }
  }
  float e1 = __shfl_up_sync(kFull, w1, 1);
  float e2 = __shfl_up_sync(kFull, w2, 1);
  if (lane == 0) {
    e1 = 0.0f;
    e2 = 0.0f;
  }
  const float c1 = car[0], c2 = car[1];
  const float* P = pw + 4 * lane;
  const float r1 = fmaf(P[0], c1, fmaf(P[1], c2, e1));  // the state entering segment lane
  const float r2 = fmaf(P[2], c1, fmaf(P[3], c2, e2));
  const float l1 = __shfl_sync(kFull, w1, 31);
  const float l2 = __shfl_sync(kFull, w2, 31);
  __syncwarp();  // every lane has read the carry and its rows before they change
  if (lane == 0) {
    const float* Q = pw + 4 * 32;
    car[0] = fmaf(Q[0], c1, fmaf(Q[1], c2, l1));
    car[1] = fmaf(Q[2], c1, fmaf(Q[3], c2, l2));
  }
  // y = b0 u + s1, s1 = s_ex1 + (A^l s_r)_1
  const float b0 = tb[0];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float s1 = __shfl_sync(kFull, r1, 8 * m + g);
    const float s2 = __shfl_sync(kFull, r2, 8 * m + g);
    float* row = rows + (8 * m + g) * kMxuRow;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = 8 * q + 2 * tq;
      const float* A0 = tb + kPowL + 4 * l;
      float2 u = *reinterpret_cast<float2*>(row + l);
      u.x = fmaf(b0, u.x, fmaf(A0[0], s1, fmaf(A0[1], s2, static_cast<float>(acc[m][q][0]))));
      u.y = fmaf(b0, u.y, fmaf(A0[4], s1, fmaf(A0[5], s2, static_cast<float>(acc[m][q][1]))));
      *reinterpret_cast<float2*>(row + l) = u;
    }
  }
  __syncwarp();
}

// Launch 1 (ends) or 3 of B14 over `tasks` (channel, tile) pairs, warp w of
// block b taking pair 8b + w: channel task / per, tile task % per, per the
// tiles of a channel this launch runs.
__global__ void __launch_bounds__(kMxuThreads, 2)
sos_mxu_tile_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float* __restrict__ tab, const double* __restrict__ frags, int sections,
                    float* __restrict__ carry, int64_t n, int64_t tile, int64_t ntiles,
                    int64_t tasks, int ends) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* sfrag = reinterpret_cast<double*>(smem);
  float* stab = reinterpret_cast<float*>(sfrag + sections * kMxuSec);
  float* srows = stab + sections * kTabMxu;
  float* scar = srows + kMxuWarps * 32 * kMxuRow;
  {
    const float4* src = reinterpret_cast<const float4*>(frags);
    float4* dst = reinterpret_cast<float4*>(sfrag);
    for (int i = threadIdx.x; i < sections * kMxuSec / 2; i += kMxuThreads) dst[i] = src[i];
    for (int i = threadIdx.x; i < sections * kTabMxu; i += kMxuThreads) stab[i] = tab[i];
  }
  __syncthreads();  // the block's one barrier
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * kMxuWarps + warp;
  if (task >= tasks) return;
  const int64_t per = ends ? ntiles - 1 : ntiles;
  const int64_t c = task / per;
  const int64_t t = task - c * per;
  const int D = 2 * sections;
  float* rows = srows + warp * 32 * kMxuRow;
  float* car = scar + warp * 2 * kMaxSections;
  float* cst = carry + (c * ntiles + t) * D;
  if (lane < D) car[lane] = ends ? 0.0f : cst[lane];
  const float* xr = x + c * n;
  float* yr = y != nullptr ? y + c * n : nullptr;
  const bool vec = ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
  const int64_t t0 = t * tile;
  const int64_t t1 = t0 + tile < n ? t0 + tile : n;
  __syncwarp();
  for (int64_t s0 = t0; s0 < t1; s0 += kMxuSub) {
    const int count = static_cast<int>(t1 - s0 < kMxuSub ? t1 - s0 : kMxuSub);
    mxu_load(xr + s0, rows, count, vec, lane);
#pragma unroll 1
    for (int k = 0; k < sections; ++k) {
      mxu_section(rows, sfrag + k * kMxuSec, stab + k * kTabMxu, car + 2 * k, lane);
    }
    if (yr != nullptr) mxu_store(yr + s0, rows, count, vec, lane);
    __syncwarp();
  }
  if (ends && lane < D) cst[lane] = car[lane];
}

static int mxu_allowed[kMaxDevices] = {};

// The three launches of B14: tile ends, B12's carry warp, apply.
static cudaError_t mxu_cascade(const float* x, float* y, const float* tab, const double* frags,
                               float* carry, const float* M, int64_t n, int C, int S,
                               int64_t tile, cudaStream_t s) {
  const int64_t ntiles = (n + tile - 1) / tile;
  const int bytes = mxu_smem_bytes(S);
  cudaError_t err = allow_smem(sos_mxu_tile_kernel, mxu_allowed, bytes);
  if (err != cudaSuccess) return err;
  if (ntiles > 1) {
    const int64_t tasks = C * (ntiles - 1);
    sos_mxu_tile_kernel<<<static_cast<unsigned>((tasks + kMxuWarps - 1) / kMxuWarps),
                          kMxuThreads, bytes, s>>>(x, nullptr, tab, frags, S, carry, n, tile,
                                                   ntiles, tasks, 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = launch_carry(carry, M, nullptr, ntiles, C, 2 * S, s)) != cudaSuccess) return err;
  const int64_t tasks = C * ntiles;
  sos_mxu_tile_kernel<<<static_cast<unsigned>((tasks + kMxuWarps - 1) / kMxuWarps), kMxuThreads,
                        bytes, s>>>(x, y, tab, frags, S, carry, n, tile, ntiles, tasks, 0);
  return cudaGetLastError();
}

}  // namespace iir
}  // namespace dsp

// B12, one pass. x, y: (C, n); tab: S * kTabL floats; mats: W, M_sub,
// M_warp^e (e < 8) and M^m (m <= lookback_depth(S)), as sos_lookback_kernel
// reads them; seed, state_out: (S, C, 2) or null; rec: 1 + 2 C ceil(n / tile)
// 2S words of scratch (zeroed here).
extern "C" int dsp_sos_lookback(const float* x, float* y, const float* tab, const float* mats,
                                const float* seed, float* state_out, void* rec, int64_t n,
                                int64_t channels, int64_t sections, int64_t tile, void* stream) {
  using namespace dsp::iir;
  if (bad_geometry(n, channels, tile) || sections < 1 || sections > kMaxSections) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(lookback_cascade(
      x, y, tab, mats, seed, state_out, static_cast<unsigned long long*>(rec), n,
      static_cast<int>(channels), static_cast<int>(sections), tile, false,
      static_cast<cudaStream_t>(stream)));
}

// B13, zero state: B12's pass with 1..8 sections fixed at compile time.
// Arguments as dsp_sos_lookback's, without seed and state_out.
extern "C" int dsp_sos_unrolled(const float* x, float* y, const float* tab, const float* mats,
                                void* rec, int64_t n, int64_t channels, int64_t sections,
                                int64_t tile, void* stream) {
  using namespace dsp::iir;
  if (bad_geometry(n, channels, tile) || sections < 1 || sections > kMaxUnrolled) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(lookback_cascade(
      x, y, tab, mats, nullptr, nullptr, static_cast<unsigned long long*>(rec), n,
      static_cast<int>(channels), static_cast<int>(sections), tile, true,
      static_cast<cudaStream_t>(stream)));
}

// What the compiler gave B12's kernel (B13's when `unrolled`), and its blocks
// an SM at `sections` sections and a tile of `tile` samples: registers a
// thread, local bytes a thread, shared bytes a block (static and dynamic),
// blocks an SM (4 int64 in out).
extern "C" int dsp_sos_attrs(int64_t sections, int64_t tile, int64_t unrolled, int64_t* out) {
  using namespace dsp::iir;
  if (sections < 1 || sections > (unrolled ? kMaxUnrolled : kMaxSections) || tile < kSub ||
      tile % kSub != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hold = lb_hold(tile);
  int blocks = 0;
  cudaError_t err = lb_occupancy(static_cast<int>(sections), unrolled != 0, hold, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  int which = 0;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(
      &a, reinterpret_cast<const void*>(
              lb_kernel(static_cast<int>(sections), unrolled != 0, &which)));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  out[2] = static_cast<int64_t>(a.sharedSizeBytes) + lb_smem_bytes(static_cast<int>(sections), hold);
  out[3] = blocks;
  return 0;
}

// B15: section k reads the previous section's output and writes to y when
// S - 1 - k is even, else to `scratch` (so no launch reads what it writes);
// x, y, scratch: (C, n); tab: S * kTab floats; M: S 2x2 transitions over
// `tile` samples; carry: C * ceil(n / tile) * 2 floats; seed, state_out:
// (S, C, 2) or null.
extern "C" int dsp_sos_sections(const float* x, float* y, float* scratch, const float* tab,
                                float* carry, const float* M, const float* seed,
                                float* state_out, int64_t n, int64_t channels, int64_t sections,
                                int64_t tile, void* stream) {
  using namespace dsp::iir;
  if (bad_geometry(n, channels, tile) || sections < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int C = static_cast<int>(channels);
  const float* in = x;
  for (int64_t k = 0; k < sections; ++k) {
    float* out = (sections - 1 - k) % 2 == 0 ? y : scratch;
    const cudaError_t err = cascade(
        sos_tile_kernel<1>, in, out, tab + k * kTab, carry, M + 4 * k,
        seed != nullptr ? seed + k * C * 2 : nullptr,
        state_out != nullptr ? state_out + k * C * 2 : nullptr, n, C, 1, tile,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    in = out;
  }
  return 0;
}

// B10. x, y: (C, n); tab: kTab1 floats; carry: C * ceil(n / tile) floats;
// M: a^tile (one float).
extern "C" int dsp_iir1(const float* x, float* y, const float* tab, float* carry,
                        const float* M, int64_t n, int64_t channels, int64_t tile,
                        void* stream) {
  using namespace dsp::iir;
  if (bad_geometry(n, channels, tile)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto C = static_cast<unsigned>(channels);
  cudaError_t err;
  if (ntiles > 1) {
    iir1_tile_kernel<<<dim3(static_cast<unsigned>(ntiles - 1), C), kThreads, 0, s>>>(
        x, nullptr, tab, carry, n, tile, ntiles, 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if ((err = launch_carry(carry, M, nullptr, ntiles, static_cast<int>(channels), 1, s)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  iir1_tile_kernel<<<dim3(static_cast<unsigned>(ntiles), C), kThreads, 0, s>>>(
      x, y, tab, carry, n, tile, ntiles, 0);
  return static_cast<int>(cudaGetLastError());
}

// B11. x, y: (C, n); carry: C * ceil(n / tile) * 2 floats; a, b the
// recurrence's coefficients (no table).
extern "C" int dsp_iir1_affine(const float* x, float* y, float* carry, float a, float b,
                               int64_t n, int64_t channels, int64_t tile, void* stream) {
  using namespace dsp::iir;
  if (bad_geometry(n, channels, tile)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto C = static_cast<unsigned>(channels);
  cudaError_t err;
  if (ntiles > 1) {
    iir1_affine_tile_kernel<<<dim3(static_cast<unsigned>(ntiles - 1), C), kThreads, 0, s>>>(
        x, nullptr, a, b, carry, n, tile, ntiles, 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  affine_carry_kernel<<<C, 32, 0, s>>>(carry, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  iir1_affine_tile_kernel<<<dim3(static_cast<unsigned>(ntiles), C), kThreads, 0, s>>>(
      x, y, a, b, carry, n, tile, ntiles, 0);
  return static_cast<int>(cudaGetLastError());
}

// B14. x, y: (C, n); tab: S * kTabMxu floats; frags: S * kMxuSec doubles
// (each section's T in fragment order, then a1 a2 k1 k2); carry:
// C * ceil(n / tile) * 2S floats; M: the cascade's (2S, 2S) zero-input
// transition over `tile` samples.
extern "C" int dsp_sos_cascade_mxu(const float* x, float* y, const float* tab,
                                   const double* frags, float* carry, const float* M, int64_t n,
                                   int64_t channels, int64_t sections, int64_t tile,
                                   void* stream) {
  using namespace dsp::iir;
  if (bad_geometry(n, channels, tile) || tile % kMxuSub != 0 || sections < 1 ||
      sections > kMaxSections || channels * ((n + tile - 1) / tile) > 0x7fffffffLL * kMxuWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(mxu_cascade(x, y, tab, frags, carry, M, n, static_cast<int>(channels),
                                      static_cast<int>(sections), tile,
                                      static_cast<cudaStream_t>(stream)));
}

// What the compiler gave B14's tile kernel, and its blocks an SM at
// `sections` sections: registers a thread, local bytes a thread, shared
// bytes a block (static and dynamic), blocks an SM, warps a block (5 int64
// in out).
extern "C" int dsp_mxu_attrs(int64_t sections, int64_t* out) {
  using namespace dsp::iir;
  if (sections < 1 || sections > kMaxSections) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = mxu_smem_bytes(static_cast<int>(sections));
  cudaError_t err = dsp::allow_smem(sos_mxu_tile_kernel, mxu_allowed, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(sos_mxu_tile_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reinterpret_cast<const void*>(sos_mxu_tile_kernel), kMxuThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  out[2] = static_cast<int64_t>(a.sharedSizeBytes) + bytes;
  out[3] = blocks;
  out[4] = kMxuWarps;
  return 0;
}
