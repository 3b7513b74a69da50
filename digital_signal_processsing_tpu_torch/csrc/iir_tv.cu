// Time-varying SOS cascades over planar (channels, n) float32: every section
// with per-sample rows (B16), one section with per-sample rows (B17), and
// every section with one row a frame (B18). One template, tv_tile_kernel;
// the three differ in the number of sections and in how a sample finds its row.
//
// Replaces, in digital_signal_processsing_tpu/ops/iir.py:
//   B16 _biquad_tv_fused_kernel   all time-varying sections over a tile;
//   B17 _biquad_tv_kernel         one time-varying section, seeded or not;
//   B18 _biquad_tv_frames_kernel  all sections, one coefficient row a frame.
// A section is the standard time-varying direct form II transposed, each row
// (b0 b1 b2 a0 a1 a2) divided by its own a0:
//   y = b0 x + s1;  s1' = b1 x - a1 y + s2;  s2' = b2 x - a2 y.
// Eliminating y, the state moves by the affine map s' = Phi s + c x with
// Phi = [[-a1, 1], [-a2, 0]]: a section over a run of samples is the affine
// map (A, z), A the product of the Phis and z the state reached from rest.
//
// Rows are (S, Cc, F, 6) float32: Cc = 1 rows shared by every channel, read
// with a channel stride of 0 and never copied a channel, or Cc = C; F = n (a
// row a sample) or a row a frame of `frame_len` samples (B18: row
// floor(t / frame_len), any frame_len).
//
// The TPU kernels walk their grid in order and carry the state in VMEM. CUDA
// blocks run in no order, so the carry takes three launches, B12's design
// (iir.cu) with the tile transition taken from the data:
//   1. tile kernel, ends   a block is a column of one tile: the signal of
//                          channel c from zero state, or the zero input from
//                          the unit state e_j of coefficient channel cc. It
//                          leaves its exit state: z_t of channel c, or column
//                          j of the tile's 2S x 2S transition M_t (block lower
//                          triangular: a section's zero-input output drives
//                          the sections after it; a unit column skips the
//                          sections before its own). So the transition is
//                          composed in the first launch, from the rows alone:
//                          once a tile for shared rows, whatever C is;
//   2. carry kernel        a warp a channel chains s_{t+1} = M_t s_t + z_t in
//                          float64 from the seed (zero, or the chunk's
//                          incoming state), leaving s_t in place of z_t;
//   3. tile kernel, apply  each tile of each channel from s_t, writing y; the
//                          thread holding sample n-1 writes the end state.
// Blocks are ordered channel (and column) fastest, so the blocks of one time
// tile run together and read its shared rows from L2 (B16's rows at the main
// path, 4 sections of 2^22 samples, are 403 MB: far more than the 50 MB L2).
// More than kGroup sections run as groups of kGroup, the signal passing
// through y in device memory between groups (the cost of the transition
// grows as S^2); B17 is the S = 1 instance, launched once a section by
// sosfilt_tv(method="scan").
//
// Inside a tile a block walks sub-tiles of kSub samples; thread i owns kSeg
// consecutive samples, loaded with coalesced 16-byte loads through a padded
// shared buffer, and keeps them in registers through every section. A
// section:
//   a. the thread divides its samples' rows by a0 (one IEEE reciprocal a row
//      and five products, float32) and runs them from rest in float64,
//      composing its segment's map (A_i, z_i);
//   b. a warp's Hillis-Steele steps compose the maps (six components, the
//      reference's _compose_affine), and thread 0 chains the warp totals from
//      the section's carry, in float64;
//   c. the thread applies its exclusive prefix to its warp's entry state in
//      float64 and runs the recurrence itself in float32 from that true
//      state, writing y in place.
// Steps a-c run in float64 because a resonant section's composed maps and
// segment states grow far past the state they sum to (a tone at a notch's
// frequency, pole angles of 0.1 rad): in float32 the entry states cost 2-14x
// the sequential recurrence's error at pole radius 0.95-0.995, in float64 the
// entry states are exact to float32 and the kernel sits at or under the
// sequential error. The rest is IEEE fp32 FMAs, products and reciprocals,
// never a tensor core; launch 2 accumulates in float64.
//
// What bounds it on the H100: memory bytes. The function reads x once, reads
// the rows once and writes y once: 8 bytes a sample and channel plus 24 a
// sample and section of per-sample rows (0.281 ms for B16 at 16 x 2^22 with
// 4 shared sections at 3.35 TB/s). This design reads x twice (launches 1 and
// 3) and the rows 1 + (S+1) times (the signal and the unit columns of
// launch 1, re-read from L2 where the blocks of a tile meet there), and it
// spends about 40 operations a sample and section (the divisions, both runs,
// the composed map) where the bound counts none: latency inside the block
// and the operation count hold it above the bound.

#include <cstdint>

#include <cuda_runtime.h>

namespace dsp {
namespace iir_tv {

constexpr int kThreads = 256;          // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 8;                // consecutive samples a thread
constexpr int kRow = kSeg + 1;         // a thread's row of the shared buffer
constexpr int kSub = kThreads * kSeg;  // samples a sub-tile
constexpr int kGroup = 16;             // sections a pass: 2 kGroup lanes of launch 2
constexpr unsigned kFull = 0xffffffffu;

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

// A thread's samples' coefficients, divided by a0 (zero past n).
struct Seg {
  float b0[kSeg], b1[kSeg], b2[kSeg], a1[kSeg], a2[kSeg];
};

static __device__ __forceinline__ void put_row(Seg& q, int j, const float* r) {
  const float2 u = reinterpret_cast<const float2*>(r)[0];  // b0 b1
  const float2 v = reinterpret_cast<const float2*>(r)[1];  // b2 a0
  const float2 w = reinterpret_cast<const float2*>(r)[2];  // a1 a2
  const float inv = 1.0f / v.y;
  q.b0[j] = u.x * inv;
  q.b1[j] = u.y * inv;
  q.b2[j] = v.x * inv;
  q.a1[j] = w.x * inv;
  q.a2[j] = w.y * inv;
}

static __device__ __forceinline__ void zero_row(Seg& q, int j) {
  q.b0[j] = q.b1[j] = q.b2[j] = q.a1[j] = q.a2[j] = 0.0f;
}

// The rows of samples g0 .. g0 + kSeg - 1 of one section (`r` its first row).
// FRAMES: sample g reads row floor(g / frame_len); the thread's first frame
// f0 and its offset rem0 in it come from the caller, so no division runs here.
template <bool FRAMES>
static __device__ __forceinline__ void load_rows(Seg& q, const float* r, int64_t g0, int64_t n,
                                                 int64_t frame_len, int64_t f0, int64_t rem0) {
  if constexpr (!FRAMES) {
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (g0 + j < n) {
        put_row(q, j, r + (g0 + j) * 6);
      } else {
        zero_row(q, j);
      }
    }
  } else {
    int64_t f = f0, rem = rem0;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (g0 + j < n) {
        if (j == 0 || rem == 0) {
          put_row(q, j, r + f * 6);
        } else {
          q.b0[j] = q.b0[j - 1];
          q.b1[j] = q.b1[j - 1];
          q.b2[j] = q.b2[j - 1];
          q.a1[j] = q.a1[j - 1];
          q.a2[j] = q.a2[j - 1];
        }
      } else {
        zero_row(q, j);
      }
      if (++rem == frame_len) {
        rem = 0;
        ++f;
      }
    }
  }
}

// One section over the sub-tile, in place in `v` (this thread's samples).
// `car`: the section's state at the sub-tile's start, left at its end; `jlast`:
// the index in `v` of sample n-1 when its state is the chunk's end state, else
// -1, with `end` where to write it.
template <bool FRAMES>
static __device__ __forceinline__ void section_pass(float (&v)[kSeg], const float* r, int64_t g0,
                                                    int64_t n, int64_t frame_len, int64_t f0,
                                                    int64_t rem0, float* car, double* wtot,
                                                    double* wbeg, int jlast, float* end) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  Seg q;
  load_rows<FRAMES>(q, r, g0, n, frame_len, f0, rem0);
  // a. the segment's map from rest in float64: z reached, A the product of the Phis
  double Z1 = 0.0, Z2 = 0.0, P11 = 1.0, P12 = 0.0, P21 = 0.0, P22 = 1.0;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const double xv = v[j], a1 = -q.a1[j], a2 = -q.a2[j];
    const double yv = fma(static_cast<double>(q.b0[j]), xv, Z1);
    const double n1 = fma(static_cast<double>(q.b1[j]), xv, fma(a1, yv, Z2));
    Z2 = fma(static_cast<double>(q.b2[j]), xv, a2 * yv);
    Z1 = n1;
    const double m11 = fma(a1, P11, P21);
    const double m12 = fma(a1, P12, P22);
    P21 = a2 * P11;
    P22 = a2 * P12;
    P11 = m11;
    P12 = m12;
  }
  // b. inclusive warp scan: (A, z) after (A', z') is (A A', A z' + z)
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double e11 = __shfl_up_sync(kFull, P11, d);
    const double e12 = __shfl_up_sync(kFull, P12, d);
    const double e21 = __shfl_up_sync(kFull, P21, d);
    const double e22 = __shfl_up_sync(kFull, P22, d);
    const double f1 = __shfl_up_sync(kFull, Z1, d);
    const double f2 = __shfl_up_sync(kFull, Z2, d);
    if (lane >= d) {
      const double n11 = fma(P11, e11, P12 * e21);
      const double n12 = fma(P11, e12, P12 * e22);
      const double n21 = fma(P21, e11, P22 * e21);
      const double n22 = fma(P21, e12, P22 * e22);
      Z1 = fma(P11, f1, fma(P12, f2, Z1));
      Z2 = fma(P21, f1, fma(P22, f2, Z2));
      P11 = n11;
      P12 = n12;
      P21 = n21;
      P22 = n22;
    }
  }
  // the exclusive prefix: the identity on lane 0
  double x11 = __shfl_up_sync(kFull, P11, 1);
  double x12 = __shfl_up_sync(kFull, P12, 1);
  double x21 = __shfl_up_sync(kFull, P21, 1);
  double x22 = __shfl_up_sync(kFull, P22, 1);
  double xz1 = __shfl_up_sync(kFull, Z1, 1);
  double xz2 = __shfl_up_sync(kFull, Z2, 1);
  if (lane == 0) {
    x11 = 1.0;
    x12 = 0.0;
    x21 = 0.0;
    x22 = 1.0;
    xz1 = 0.0;
    xz2 = 0.0;
  }
  if (lane == 31) {
    double* w = wtot + 6 * warp;
    w[0] = P11;
    w[1] = P12;
    w[2] = P21;
    w[3] = P22;
    w[4] = Z1;
    w[5] = Z2;
  }
  __syncthreads();
  if (tid == 0) {
    double c1 = car[0], c2 = car[1];
    for (int w = 0; w < kWarps; ++w) {
      const double* m = wtot + 6 * w;
      wbeg[2 * w] = c1;
      wbeg[2 * w + 1] = c2;
      const double n1 = fma(m[0], c1, fma(m[1], c2, m[4]));
      const double n2 = fma(m[2], c1, fma(m[3], c2, m[5]));
      c1 = n1;
      c2 = n2;
    }
    car[0] = static_cast<float>(c1);
    car[1] = static_cast<float>(c2);
  }
  __syncthreads();
  // c. the true state entering this thread's samples, and the recurrence from it
  const double c1 = wbeg[2 * warp], c2 = wbeg[2 * warp + 1];
  float s1 = static_cast<float>(fma(x11, c1, fma(x12, c2, xz1)));
  float s2 = static_cast<float>(fma(x21, c1, fma(x22, c2, xz2)));
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const float xv = v[j];
    const float yv = fmaf(q.b0[j], xv, s1);
    const float n1 = fmaf(q.b1[j], xv, fmaf(-q.a1[j], yv, s2));
    s2 = fmaf(q.b2[j], xv, -q.a2[j] * yv);
    s1 = n1;
    v[j] = yv;
    if (j == jlast) {
      end[0] = s1;
      end[1] = s2;
    }
  }
}

// Launches 1 (ends != 0) and 3 (ends == 0) of one group of S <= kGroup
// sections. Block b is column b % ncols of tile b / ncols. Launch 1: ncols =
// C + Cc 2S; column c < C is channel c's signal from zero state, leaving
// carry[c, t]; column C + cc 2S + j is the zero input from the unit state e_j
// with coefficient channel cc's rows, leaving column j of trans[cc, t]. Launch
// 3: ncols = C, from carry[c, t], writing y and, where it holds sample n-1,
// state_out[(k C + c) 2 + i]. NS > 0 fixes S (B17: NS = 1); FRAMES reads a row
// a frame (B18).
template <int NS, bool FRAMES>
__global__ void __launch_bounds__(kThreads)
tv_tile_kernel(const float* x, float* y, const float* __restrict__ rows, int64_t sec_stride,
               int64_t chan_stride, int64_t frame_len, int sections, float* __restrict__ carry,
               float* __restrict__ trans, float* __restrict__ state_out, int64_t n, int64_t tile,
               int64_t ntiles, int C, int Cc, int ends) {
  __shared__ float buf[kThreads * kRow];
  __shared__ float scar[2 * kGroup];
  __shared__ double wtot[6 * kWarps];
  __shared__ double wbeg[2 * kWarps];
  const int S = NS > 0 ? NS : sections;
  const int D = 2 * S;
  const int tid = threadIdx.x;
  const int64_t ncols = ends ? C + static_cast<int64_t>(Cc) * D : C;
  const int64_t col = blockIdx.x % ncols;
  const int64_t t = blockIdx.x / ncols;
  const bool signal = col < C;
  const int c = signal ? static_cast<int>(col) : 0;
  const int unit = signal ? -1 : static_cast<int>((col - C) % D);
  const int cc = signal ? (Cc == 1 ? 0 : c) : static_cast<int>((col - C) / D);
  const int first = signal ? 0 : unit / 2;
  if (tid < D) {
    float s = 0.0f;
    if (!ends) {
      s = carry[(static_cast<int64_t>(c) * ntiles + t) * D + tid];
    } else if (tid == unit) {
      s = 1.0f;
    }
    scar[tid] = s;
  }
  __syncthreads();
  const float* xr = x + static_cast<int64_t>(c) * n;
  float* yr = ends ? nullptr : y + static_cast<int64_t>(c) * n;
  const float* rc = rows + static_cast<int64_t>(cc) * chan_stride;
  const bool vec = ((reinterpret_cast<uintptr_t>(xr) |
                     reinterpret_cast<uintptr_t>(yr == nullptr ? xr : yr)) & 15) == 0;
  const int64_t t0 = t * tile;
  const int64_t t1 = t0 + tile < n ? t0 + tile : n;
  const bool writes_state = !ends && state_out != nullptr && t == ntiles - 1;
  float* seg = buf + tid * kRow;
  for (int64_t s0 = t0; s0 < t1; s0 += kSub) {
    const int count = static_cast<int>(t1 - s0 < kSub ? t1 - s0 : kSub);
    float v[kSeg];
    if (signal) {
      load_sub(xr + s0, buf, count, vec);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kSeg; ++j) v[j] = seg[j];
    } else {
#pragma unroll
      for (int j = 0; j < kSeg; ++j) v[j] = 0.0f;
    }
    int jlast = -1;
    if (writes_state && n - 1 - s0 < kSub) {
      const int p = static_cast<int>(n - 1 - s0);
      if (p / kSeg == tid) jlast = p % kSeg;
    }
    const int64_t g0 = s0 + static_cast<int64_t>(tid) * kSeg;
    int64_t f0 = 0, rem0 = 0;
    if constexpr (FRAMES) {
      f0 = g0 / frame_len;
      rem0 = g0 - f0 * frame_len;
    }
    if constexpr (NS > 0) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (k < first) continue;
        float* end = jlast >= 0 ? state_out + (static_cast<int64_t>(k) * C + c) * 2 : nullptr;
        section_pass<FRAMES>(v, rc + k * sec_stride, g0, n, frame_len, f0, rem0, scar + 2 * k,
                             wtot, wbeg, jlast, end);
      }
    } else {
#pragma unroll 1
      for (int k = first; k < S; ++k) {
        float* end = jlast >= 0 ? state_out + (static_cast<int64_t>(k) * C + c) * 2 : nullptr;
        section_pass<FRAMES>(v, rc + k * sec_stride, g0, n, frame_len, f0, rem0, scar + 2 * k,
                             wtot, wbeg, jlast, end);
      }
    }
    if (yr != nullptr) {
#pragma unroll
      for (int j = 0; j < kSeg; ++j) seg[j] = v[j];
      __syncthreads();
      store_sub(yr + s0, buf, count, vec);
    }
    __syncthreads();
  }
  if (ends && tid < D) {
    if (signal) {
      carry[(static_cast<int64_t>(c) * ntiles + t) * D + tid] = scar[tid];
    } else {
      trans[((static_cast<int64_t>(cc) * (ntiles - 1) + t) * D + tid) * D + unit] = scar[tid];
    }
  }
}

// Row r of M_t (zeros past D) into m.
template <int W>
static __device__ __forceinline__ void load_m(float (&m)[W], const float* mt, int64_t t, int r,
                                              int D) {
#pragma unroll
  for (int q = 0; q < W; ++q) m[q] = (r < D && q < D) ? mt[(t * D + r) * D + q] : 0.0f;
}

// Launch 2. Warp c walks channel c's tiles: carry[c, t] <- s_t, with s_0 the
// seed ((S, C, 2), zero when null) and s_{t+1} = M_t s_t + z_t, M_t read from
// trans[cc] (cc = 0 for shared rows) and z_t from carry[c, t], in float64.
// Lane r < D holds s[r]; the next tile's row of M and z are loaded while this
// tile's step runs. W is a compile-time width >= D.
template <int W>
__global__ void __launch_bounds__(32)
tv_carry_kernel(float* __restrict__ carry, const float* __restrict__ trans,
                const float* __restrict__ seed, int64_t ntiles, int C, int Cc, int D) {
  const int c = blockIdx.x;
  const int r = threadIdx.x;
  const int cc = Cc == 1 ? 0 : c;
  double s = 0.0;
  if (seed != nullptr && r < D) s = seed[(static_cast<int64_t>(r >> 1) * C + c) * 2 + (r & 1)];
  float* base = carry + static_cast<int64_t>(c) * ntiles * D;
  const float* mt = trans + static_cast<int64_t>(cc) * (ntiles - 1) * D * D;
  float m[W], mnext[W];
  float znext = 0.0f;
  if (ntiles > 1) {
    load_m(mnext, mt, 0, r, D);
    if (r < D) znext = base[r];
  }
  for (int64_t t = 0; t < ntiles; ++t) {
    const float z = znext;
    if (r < D) base[t * D + r] = static_cast<float>(s);
    if (t == ntiles - 1) break;
#pragma unroll
    for (int q = 0; q < W; ++q) m[q] = mnext[q];
    if (t + 1 < ntiles - 1) {
      load_m(mnext, mt, t + 1, r, D);
      if (r < D) znext = base[(t + 1) * D + r];
    }
    double acc0 = z, acc1 = 0.0;
#pragma unroll
    for (int q = 0; q < W; q += 2) {
      acc0 = fma(static_cast<double>(m[q]), __shfl_sync(kFull, s, q), acc0);
      if constexpr (W > 1) {
        acc1 = fma(static_cast<double>(m[q + 1]), __shfl_sync(kFull, s, q + 1), acc1);
      }
    }
    s = acc0 + acc1;
  }
}

static cudaError_t launch_carry(float* carry, const float* trans, const float* seed,
                                int64_t ntiles, int C, int Cc, int D, cudaStream_t s) {
  const auto g = static_cast<unsigned>(C);
  if (D <= 2) {
    tv_carry_kernel<2><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  } else if (D <= 4) {
    tv_carry_kernel<4><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  } else if (D <= 8) {
    tv_carry_kernel<8><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  } else if (D <= 16) {
    tv_carry_kernel<16><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  } else {
    tv_carry_kernel<32><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  }
  return cudaGetLastError();
}

using TileKernel = void (*)(const float*, float*, const float*, int64_t, int64_t, int64_t, int,
                            float*, float*, float*, int64_t, int64_t, int64_t, int, int, int);

}  // namespace iir_tv
}  // namespace dsp

// B16 (kind 0: per-sample rows, any S), B17 (kind 1: per-sample rows, S = 1)
// and B18 (kind 2: a row a frame of frame_len samples, any S). x, y: (C, n),
// y may be written in place of x only by the groups after the first; rows:
// (S, Cc, F, 6), 8-byte aligned, section k and coefficient channel cc at
// rows + k sec_stride + cc chan_stride (chan_stride 0 when Cc = 1); carry:
// C ceil(n / tile) 2G floats and trans: Cc (ceil(n / tile) - 1) (2G)^2 floats
// of scratch, G = min(S, 16); seed, state_out: (S, C, 2) or null.
extern "C" int dsp_tv_cascade(const float* x, float* y, const float* rows, int64_t sec_stride,
                              int64_t chan_stride, int64_t frame_len, float* carry, float* trans,
                              const float* seed, float* state_out, int64_t n, int64_t channels,
                              int64_t coef_channels, int64_t sections, int64_t tile, int64_t kind,
                              void* stream) {
  using namespace dsp::iir_tv;
  const bool bad =
      n < 1 || channels < 1 || channels > 65535 || tile < kSub || tile % kSub != 0 ||
      frame_len < 1 || sections < 1 || (coef_channels != 1 && coef_channels != channels) ||
      (kind == 1 && sections != 1) || kind < 0 || kind > 2 ||
      (reinterpret_cast<uintptr_t>(rows) & 7) != 0 || sec_stride % 2 != 0 || chan_stride % 2 != 0;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  const int64_t widest = channels + coef_channels * 2 * (sections < kGroup ? sections : kGroup);
  if ((ntiles - 1) * widest > 0x7fffffff || ntiles * channels > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TileKernel k = kind == 0   ? dsp::iir_tv::tv_tile_kernel<0, false>
                 : kind == 1 ? dsp::iir_tv::tv_tile_kernel<1, false>
                             : dsp::iir_tv::tv_tile_kernel<0, true>;
  const auto s = static_cast<cudaStream_t>(stream);
  const int C = static_cast<int>(channels);
  const int Cc = static_cast<int>(coef_channels);
  for (int64_t g = 0; g < sections; g += kGroup) {
    const int S = static_cast<int>(sections - g < kGroup ? sections - g : kGroup);
    const int D = 2 * S;
    const float* in = g == 0 ? x : y;
    const float* rg = rows + g * sec_stride;
    const float* sg = seed != nullptr ? seed + g * C * 2 : nullptr;
    float* og = state_out != nullptr ? state_out + g * C * 2 : nullptr;
    cudaError_t err;
    if (ntiles > 1) {
      const auto blocks = static_cast<unsigned>((ntiles - 1) * (C + static_cast<int64_t>(Cc) * D));
      k<<<blocks, kThreads, 0, s>>>(in, nullptr, rg, sec_stride, chan_stride, frame_len, S, carry,
                                    trans, nullptr, n, tile, ntiles, C, Cc, 1);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    if ((err = launch_carry(carry, trans, sg, ntiles, C, Cc, D, s)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    k<<<static_cast<unsigned>(ntiles * C), kThreads, 0, s>>>(
        in, y, rg, sec_stride, chan_stride, frame_len, S, carry, trans, og, n, tile, ntiles, C,
        Cc, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
