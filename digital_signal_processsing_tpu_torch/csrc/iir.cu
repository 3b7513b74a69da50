// IIR block scans over planar (channels, t) float32: the first-order
// recurrence (B10, and B11 as a compose of affine maps), the cascade of
// second-order sections with a runtime loop over sections (B12), unrolled
// for 1..8 sections (B13) or with its lane pass on the tensor cores (B14),
// and one section a launch (B15).
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
// Their notes are at their kernels below.
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
// 3.35 TB/s); this design reads x twice (launches 1 and 3), 12 bytes a
// sample. Its operations, about 2 x 8 a sample and section, stay below that
// at 66.9 TFLOP/s. B15 moves 8 bytes a sample and section through device
// memory, as the TPU anchor does. A single pass with a decoupled look-back
// would read x once.

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
constexpr int kMaxUnrolled = 8;        // B13: butter(16) is 8 sections
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
// NS > 0 unrolls NS sections with their coefficients in registers (B13, and
// B15 at NS = 1); NS = 0 loops over S sections (B12).
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
  const int S = NS > 0 ? NS : sections;
  const int D = 2 * S;
  const int tid = threadIdx.x;
  const int c = blockIdx.y;
  const int64_t t = blockIdx.x;
  for (int i = tid; i < S * kTab; i += kThreads) stab[i] = tab[i];
  float* cst = carry + (static_cast<int64_t>(c) * ntiles + t) * D;
  if (tid < D) scar[tid] = ends ? 0.0f : cst[tid];
  __syncthreads();
  Coef reg[NS > 0 ? NS : 1];
  if constexpr (NS > 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k) reg[k] = coef_of(stab + k * kTab);
  }
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
    if constexpr (NS > 0) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        float* end = jlast >= 0 ? state_out + (static_cast<int64_t>(k) * C + c) * 2 : nullptr;
        section_pass(v, stab + k * kTab + kPow, reg[k], scar + 2 * k, wtot, wbeg, jlast, end);
      }
    } else {
#pragma unroll 1
      for (int k = 0; k < S; ++k) {
        float* end = jlast >= 0 ? state_out + (static_cast<int64_t>(k) * C + c) * 2 : nullptr;
        section_pass(v, stab + k * kTab + kPow, coef_of(stab + k * kTab), scar + 2 * k, wtot,
                     wbeg, jlast, end);
      }
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

static TileKernel unrolled_kernel(int sections) {
  switch (sections) {
    case 1: return sos_tile_kernel<1>;
    case 2: return sos_tile_kernel<2>;
    case 3: return sos_tile_kernel<3>;
    case 4: return sos_tile_kernel<4>;
    case 5: return sos_tile_kernel<5>;
    case 6: return sos_tile_kernel<6>;
    case 7: return sos_tile_kernel<7>;
    case 8: return sos_tile_kernel<8>;
    default: return nullptr;
  }
}

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

// B12 (unrolled == 0) and B13 (unrolled != 0, 1..8 sections). x, y: (C, n);
// tab: S * kTab floats; carry: scratch of C * ceil(n / tile) * 2S floats;
// M: the cascade's (2S, 2S) zero-input transition over `tile` samples; seed,
// state_out: (S, C, 2) or null.
extern "C" int dsp_sos_cascade(const float* x, float* y, const float* tab, float* carry,
                               const float* M, const float* seed, float* state_out, int64_t n,
                               int64_t channels, int64_t sections, int64_t tile,
                               int64_t unrolled, void* stream) {
  using namespace dsp::iir;
  if (bad_geometry(n, channels, tile) || sections < 1 || sections > kMaxSections) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TileKernel k = sos_tile_kernel<0>;
  if (unrolled != 0 && (sections > kMaxUnrolled ||
                        (k = unrolled_kernel(static_cast<int>(sections))) == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cascade(k, x, y, tab, carry, M, seed, state_out, n,
                                  static_cast<int>(channels), static_cast<int>(sections), tile,
                                  static_cast<cudaStream_t>(stream)));
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
