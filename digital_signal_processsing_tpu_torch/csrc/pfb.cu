// Polyphase filter-bank analysis: branch FIR + N-point channel DFT in one
// kernel, from the raw stream (B19) or from a commutated (M, N) tensor (B20).
//
// B19 replaces digital_signal_processsing_tpu/ops/channelizer.py
// _fused_pfb_raw_kernel, B20 replaces _fused_pfb_kernel there. Both compute,
// for output row m and channel k,
//
//   v[m, q] = sum_{r<P} hq[r, q] * in(m - d*r, q),   in(< 0, q) = 0
//   Y[m, k] = sum_q v[m, q] * exp(sign * 2*pi*i * q*k / N)
//
// with in(m, q) = x[N*m - q] (zero before the stream) for B19, the
// reverse-running commutator read straight from the stream, and
// in(m, q) = u[m, q] for B20. d is the dilation (2 for the oversampled bank).
// Input row rho is x[N*rho .. N*rho + N) for B19 and u[rho, :] for B20, so
// in(m, 0) is row m's first sample and, for B19, in(m, q > 0) is row m-1's
// sample N - q.
//
// What bounds it on the H100: by the work, memory bytes (4 read and 8
// written a sample; the FIR's 2P and the FFT's 5 log2 N flops a sample are
// far below 67 TFLOP/s fp32). The TPU kernels' lane rolls, per-lane tap
// tables, block-diagonal DFT matmuls and carry across the sequential grid
// serve its (8, 128) tiles and matrix unit; this design is for the card's
// memory system and registers instead:
//
// - The transform is known at compile time: pfb_fft_kernel<kRaw, LOG, K3>
//   for N = 3^K3 * 2^LOG (Plan<> below, every power of two 2..8192 and
//   3 * 2^a up to 6144), so every index into a thread's points is a constant.
// - Register-resident Stockham passes (stockham.cuh, shared with B8): T
//   threads carry a transform of M = 2^LOG points, P each. Up to M = 256
//   the T threads sit in one warp and the one exchange is a transpose by
//   shuffles (warp_fft: no shared memory, no barrier); above, the passes
//   exchange through padded shared memory as B8's do. Twiddles are
//   computed with sincospif of exact arguments.
// - Two real rows ride one complex transform: rows a = 2g and b = 2g + 1 of
//   a step go in as a + ib, and Y_a[k] = (Z[k] + conj Z[N-k]) / 2,
//   Y_b[k] = (Z[k] - conj Z[N-k]) / 2i. Z[N-k] is one shuffle away (warp
//   plans) or in the exchange buffer (the others). Each row's rounding is
//   then relative to the larger of the two spectra, so a row past the end of
//   the output is zeroed rather than transformed beside the last row.
// - N = 3M: three M-point sub-transforms of the points q = 3n + c, each by
//   the power-of-two plan, then a radix-3 pass in registers, Y[k' + Mc] =
//   sum_c' W_3^(c c') W_N^(c' k') X_c'[k'], with W_N^(k') = W_N^j W_N^(sT)
//   (k' = j + sT): W_N^j computed once a thread, W_N^(sT) a constant.
// - Any other N (1, odd N such as 7): a direct DFT over v lines in shared
//   memory, its twiddles staged once a block, k <= N/2 computed and
//   Y[N - k] = conj Y[k] stored beside it (pfb_direct_kernel).
// - The look-back is staged once: a block walks `steps` consecutive steps
//   of `rows` rows through a ring of input rows in shared memory, filled by
//   coalesced 16-byte cp.async copies (4-byte where rows or the source are
//   not 16-byte aligned), zeros outside the stream. The ring keeps the
//   `lookback` rows before the step (d*(P-1), +1 for B19), so each input
//   row comes from device memory once a block, and with `prefetch` the next
//   step's rows load while this step runs. Taps whose rows do not fit
//   beside the step (long filters at large N) read device memory. Blocks
//   carry nothing across blocks and run in any order.
// - Stores in whole 32-byte sectors: for the channel-major layouts (m
//   fastest) a warp plan's store gathers, by shuffles, 8 or more
//   consecutive rows of one channel into one store instruction (whole sectors
//   up to N = 128); the shared-memory plans store from the exchange buffer
//   with the row index fastest. The (M, N) layout stores with k fastest.
//   Where a step writes less than a 128-byte line of each channel (n = 1024:
//   8 rows), blocks walk interleaved steps instead of runs, so that the
//   blocks in flight complete each line in L2 together (walk()).
//
// The emulation in tests/test_torch_channelizer.py follows these steps in
// NumPy at the wrapper's launch geometry (ops/channelizer.py PfbGeometry).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"
#include "stockham.cuh"

namespace dsp {
namespace pfb {

using namespace stockham;

constexpr int kThreads = 256;
constexpr int kMaxN = 8192;

// The transform of N = 3^K3 * 2^LOG points: P points a thread in each of the
// 3^K3 sub-transforms of M = 2^LOG points, the radices of its passes (a warp
// plan: R0 = P and R1 = T = M/P, or R1 = 0 for one pass; the others exchange
// through shared memory), and the blocks an SM its launch bounds ask for
// (ops/channelizer.py PFB_PLANS mirrors P and the radices).
template <int LOG, int K3> struct Plan;
#define DSP_PFB_PLAN(LOG, K3, P_, WARP, R0_, R1_, R2_, R3_, B_)                          \
  template <> struct Plan<LOG, K3> {                                                    \
    static constexpr int P = P_, R0 = R0_, R1 = R1_, R2 = R2_, R3 = R3_, B = B_;         \
    static constexpr bool kWarp = WARP;                                                 \
  };
DSP_PFB_PLAN(1, 0, 2, true, 2, 0, 0, 0, 2)
DSP_PFB_PLAN(2, 0, 4, true, 4, 0, 0, 0, 2)
DSP_PFB_PLAN(3, 0, 8, true, 8, 0, 0, 0, 2)
DSP_PFB_PLAN(4, 0, 8, true, 8, 2, 0, 0, 2)
DSP_PFB_PLAN(5, 0, 8, true, 8, 4, 0, 0, 2)
DSP_PFB_PLAN(6, 0, 8, true, 8, 8, 0, 0, 3)
DSP_PFB_PLAN(7, 0, 16, true, 16, 8, 0, 0, 2)
DSP_PFB_PLAN(8, 0, 16, true, 16, 16, 0, 0, 2)
DSP_PFB_PLAN(9, 0, 16, false, 8, 8, 8, 0, 2)
DSP_PFB_PLAN(10, 0, 16, false, 4, 16, 16, 0, 2)
DSP_PFB_PLAN(11, 0, 16, false, 8, 16, 16, 0, 2)
DSP_PFB_PLAN(12, 0, 16, false, 16, 16, 16, 0, 2)
DSP_PFB_PLAN(13, 0, 32, false, 16, 16, 32, 0, 1)
DSP_PFB_PLAN(0, 1, 1, true, 1, 0, 0, 0, 2)
DSP_PFB_PLAN(1, 1, 2, true, 2, 0, 0, 0, 2)
DSP_PFB_PLAN(2, 1, 4, true, 4, 0, 0, 0, 2)
DSP_PFB_PLAN(3, 1, 4, true, 4, 2, 0, 0, 1)
DSP_PFB_PLAN(4, 1, 4, true, 4, 4, 0, 0, 2)
DSP_PFB_PLAN(5, 1, 8, true, 8, 4, 0, 0, 1)
DSP_PFB_PLAN(6, 1, 8, true, 8, 8, 0, 0, 1)
DSP_PFB_PLAN(7, 1, 8, false, 8, 4, 4, 0, 2)
DSP_PFB_PLAN(8, 1, 8, false, 8, 8, 4, 0, 2)
DSP_PFB_PLAN(9, 1, 8, false, 8, 8, 8, 0, 1)
DSP_PFB_PLAN(10, 1, 8, false, 8, 8, 4, 4, 1)
DSP_PFB_PLAN(11, 1, 8, false, 8, 8, 8, 4, 1)
#undef DSP_PFB_PLAN

// Exchange slots a transform of the shared-memory plans: N points, one pad
// after every 16, and 4 more, so that neighbouring transforms' slots of one
// channel fall on other banks.
__host__ __device__ constexpr int exchange_slots(int n) { return n + n / 16 + 4; }

struct Args {
  const float* src;   // B19: the (m * n,) stream; B20: the (m, n) branch inputs
  const float* hq;    // (p, n) branch taps
  const float2* tw;   // direct route: n twiddles exp(-2 pi i q / n)
  float* re;
  float* im;
  long long m;            // output rows
  long long sk, sm;       // output strides of channel k and row m, in floats
  long long total_steps;  // ceil(m / rows)
  int n, p, d;
  int rows;      // rows a step
  int rs;        // floats a ring row
  int lookback;  // ring rows kept before a step's first row
  int cap;       // ring rows: lookback + (1 + prefetch) * rows, interleaved
                 // (1 + prefetch) * (lookback + rows)
  int resident;  // taps r < resident read the ring, the rest device memory
  int steps;       // steps a block walks (a run of consecutive steps)
  int interleave;  // 1: block b walks steps b, b + blocks, ... (see walk)
  int prefetch;    // 1: the next step's rows load while this step runs
  int vec;       // rows and source 16-byte aligned: 16-byte copies
  int layout;    // 0 (M, N) planes, 1 (N, M) planes, 2 (N, M) complex64
  float im_sign;  // -sign: Y = conj(F) for sign +1, F for sign -1
};

static __device__ __forceinline__ int wrap(int s, int cap) {
  s = s < 0 ? s + cap : s;
  return s >= cap ? s - cap : s;
}

// One copy into shared memory, zero-filled where `live` is false.
template <int W>
static __device__ __forceinline__ void cp_async(float* dst, const float* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(live ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(live ? 4 : 0));
  }
}

static __device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
static __device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// Input rows [first, first + count) into the ring from slot `slot0` on
// (wrapping at cap), W floats a copy, neighbouring threads on neighbouring
// copies; rows outside [0, m) are zeros. NN = 0: a.n at run time.
template <int NN, int W>
static __device__ __forceinline__ void stage_w(const Args& a, float* ring, long long first,
                                               int count, int slot0) {
  const int n = NN ? NN : a.n;
  const int per = n / W;
  const int total = count * per;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / per;
    const int c = e - r * per;
    const long long row = first + r;
    int slot = slot0 + r;
    slot = slot >= a.cap ? slot - a.cap : slot;
    const bool live = row >= 0 && row < a.m;
    cp_async<W>(ring + slot * a.rs + c * W, live ? a.src + row * n + c * W : a.src, live);
  }
}

template <int NN>
static __device__ __forceinline__ void stage(const Args& a, float* ring, long long first,
                                             int count, int slot0) {
  if (a.vec) {
    stage_w<NN, 4>(a, ring, first, count, slot0);
  } else {
    stage_w<NN, 1>(a, ring, first, count, slot0);
  }
}

// The block's walk over its steps, each run by `step(f, base)` once its rows
// are in, `base` the ring slot of row f. A ring slot is refilled only after
// the barrier that ends the last step reading it. Two orders:
// - a run of consecutive steps (blocks [b*steps, (b+1)*steps)): rows
//   [f0 - lookback, f0 + rows) first, then each step's new rows one step
//   ahead (prefetch) or at its start, the look-back kept in the ring;
// - interleaved (steps b, b + blocks, ...), for the channel-major layouts
//   when a step's rows fill less than a 128-byte line of a channel: the
//   blocks running together then write neighbouring rows, so each line is
//   completed in L2 by neighbouring steps. Each step stages its own
//   look-back into a segment of lookback + rows rows (two with prefetch).
template <int NN, class Step>
static __device__ __forceinline__ void walk(const Args& a, float* ring, Step step) {
  const long long blocks = gridDim.x;
  const long long s0 = a.interleave ? blockIdx.x : static_cast<long long>(blockIdx.x) * a.steps;
  const long long ds = a.interleave ? blocks : 1;
  const long long left = a.total_steps - s0;
  const int steps = a.interleave ? static_cast<int>((left + blocks - 1) / blocks)
                                  : (left < a.steps ? static_cast<int>(left) : a.steps);
  const int seg = a.lookback + a.rows;
  const long long f0 = s0 * a.rows;
  stage<NN>(a, ring, f0 - a.lookback, seg, 0);
  commit();
  int base = a.lookback;
  for (int i = 0; i < steps; ++i) {
    const long long f = (s0 + i * ds) * a.rows;
    const long long fn = f + ds * a.rows;  // the next step's first row
    int next = wrap(base + a.rows, a.cap);
    if (a.interleave) {
      base = (a.prefetch ? (i & 1) * seg : 0) + a.lookback;
      next = (a.prefetch ? ((i + 1) & 1) * seg : 0);
      if (a.prefetch) {
        if (i + 1 < steps) stage<NN>(a, ring, fn - a.lookback, seg, next);
        commit();
        wait_group<1>();
      } else {
        if (i > 0) stage<NN>(a, ring, f - a.lookback, seg, 0);
        commit();
        wait_group<0>();
      }
    } else if (a.prefetch) {
      if (i + 1 < steps) stage<NN>(a, ring, fn, a.rows, next);
      commit();
      wait_group<1>();
    } else {
      if (i > 0) stage<NN>(a, ring, f, a.rows, base);
      commit();
      wait_group<0>();
    }
    __syncthreads();
    step(f, base);
    __syncthreads();
    base = next;
  }
}

// Input row `row` = f + delta: its ring row (resident) or its device row,
// nullptr outside [0, m).
static __device__ __forceinline__ const float* ring_row(const Args& a, const float* ring,
                                                        int base, int delta) {
  return ring + wrap(base + delta, a.cap) * a.rs;
}

static __device__ __forceinline__ const float* device_row(const Args& a, long long row) {
  return row >= 0 && row < a.m ? a.src + row * a.n : nullptr;
}

static __device__ __forceinline__ float at(const float* p, int i) {
  return p != nullptr ? p[i] : 0.0f;
}

// One tap's products for the thread's points: rows a and b at q = qj + o
// (o = K*s*T + c a constant) are pa[-o], pb[-o] for B19 (the row before,
// read backwards) or pa[o], pb[o] for B20; q = 0 reads a0[0], b0[0]. Device
// rows outside the stream are null and read as zeros.
template <bool kRaw, bool kDevice, int K, int P, int T>
static __device__ __forceinline__ void tap(float2 (&v)[K][P], const float* h, const float* pa,
                                           const float* pb, const float* a0, const float* b0) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int o = K * s * T + c;
      const int i = o == 0 ? 0 : (kRaw ? -o : o);
      const float* xa = o == 0 ? a0 : pa;
      const float* xb = o == 0 ? b0 : pb;
      const float hv = __ldg(h + o);
      v[c][s].x = fmaf(hv, kDevice ? at(xa, i) : xa[i], v[c][s].x);
      v[c][s].y = fmaf(hv, kDevice ? at(xb, i) : xb[i], v[c][s].y);
    }
  }
}

// The branch FIR of the thread's points for rows a = f + ga and b = a + 1,
// the taps in order r = 0..P-1: v[c][s] = (v[a, q], v[b, q]) at
// q = K*(j + s*T) + c. B19 reads in(row, 0) from the row's first sample and
// in(row, q > 0) from sample N - q of the row before, so a tap takes three
// input rows: a - dr - 1, a - dr and a - dr + 1. Taps r < resident read the
// ring, the rest device memory.
template <bool kRaw, int N, int K, int P, int T>
static __device__ __forceinline__ void branch_fir(const Args& a, const float* ring, int base,
                                                  long long f, int ga, int j,
                                                  float2 (&v)[K][P]) {
  const int qj = K * j;
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int s = 0; s < P; ++s) v[c][s] = make_float2(0.0f, 0.0f);
  }
  for (int r = 0; r < a.p; ++r) {
    const float* h = a.hq + r * N + qj;
    const int dr = a.d * r;
    if (r < a.resident) {
      const float* rowa = ring_row(a, ring, base, ga - dr);
      const float* rowb = ring_row(a, ring, base, ga + 1 - dr);
      if (kRaw) {
        const float* pa = ring_row(a, ring, base, ga - 1 - dr) + (N - qj);
        const float* pb = rowa + (N - qj);
        tap<true, false, K, P, T>(v, h, pa, pb, j == 0 ? rowa : pa, j == 0 ? rowb : pb);
      } else {
        tap<false, false, K, P, T>(v, h, rowa + qj, rowb + qj, rowa + qj, rowb + qj);
      }
    } else {
      const long long ra = f + ga - dr;
      const float* rowa = device_row(a, ra);
      const float* rowb = device_row(a, ra + 1);
      if (kRaw) {
        const float* prev = device_row(a, ra - 1);
        const float* pa = prev != nullptr ? prev + (N - qj) : nullptr;
        const float* pb = rowa != nullptr ? rowa + (N - qj) : nullptr;
        tap<true, true, K, P, T>(v, h, pa, pb, j == 0 ? rowa : pa, j == 0 ? rowb : pb);
      } else {
        const float* pa = rowa != nullptr ? rowa + qj : nullptr;
        const float* pb = rowb != nullptr ? rowb + qj : nullptr;
        tap<false, true, K, P, T>(v, h, pa, pb, pa, pb);
      }
    }
  }
}

// cos and sin of x (|x| < 5) in double, by their series: compile-time constants.
__host__ __device__ constexpr double series_cos(double x) {
  double t = 1.0, s = 1.0;
  for (int i = 1; i < 30; ++i) {
    t *= -x * x / ((2.0 * i - 1.0) * (2.0 * i));
    s += t;
  }
  return s;
}

__host__ __device__ constexpr double series_sin(double x) {
  double t = x, s = x;
  for (int i = 1; i < 30; ++i) {
    t *= -x * x / ((2.0 * i) * (2.0 * i + 1.0));
    s += t;
  }
  return s;
}

// W_N^E = exp(-2 pi i E / N), 0 <= E < N, rounded once to float32.
template <int N, int E> struct W {
  static constexpr double kA = 6.283185307179586476925286766559 * (E % N) / N;
  static constexpr double kX = kA > 3.14159265358979323846 ? kA - 6.283185307179586476925 : kA;
  static constexpr float re = static_cast<float>(series_cos(kX));
  static constexpr float im = static_cast<float>(-series_sin(kX));
};

// W_N^e for N = 3M and a run-time 0 <= e < 2M: W_M^(e/3) by sincospif of an
// exact argument, times the constant W_N^(e mod 3).
template <int N>
static __device__ __forceinline__ float2 w3m(int e) {
  constexpr int M = N / 3;
  const int u = e / 3, w = e - 3 * u;
  float s, c;
  sincospif(static_cast<float>(u) * (2.0f / M), &s, &c);
  const float2 z = make_float2(c, -s);
  if (w == 0) return z;
  return cmul(z, w == 1 ? make_float2(W<N, 1>::re, W<N, 1>::im)
                        : make_float2(W<N, 2>::re, W<N, 2>::im));
}

// The radix-3 pass of N = 3M: thread j's X_c[k'] (k' = j + s*T) in v[c][s]
// become Y[k' + M c] = sum_c' W_3^(c c') W_N^(c' k') X_c'[k'].
template <int N, int P, int T, int s = 0>
static __device__ __forceinline__ void radix3(float2 (&v)[3][P], float2 wj1, float2 wj2) {
  constexpr int e = s * T;
  const float2 w1 = cmul(wj1, make_float2(W<N, e>::re, W<N, e>::im));
  const float2 w2 = cmul(wj2, make_float2(W<N, 2 * e>::re, W<N, 2 * e>::im));
  const float2 x0 = v[0][s], t1 = cmul(v[1][s], w1), t2 = cmul(v[2][s], w2);
  const float2 sum = cadd(t1, t2), dif = csub(t1, t2);
  const float2 mid = make_float2(fmaf(-0.5f, sum.x, x0.x), fmaf(-0.5f, sum.y, x0.y));
  constexpr float h3 = 0.866025403784438646763723170753f;  // sin(2 pi / 3)
  v[0][s] = cadd(x0, sum);
  v[1][s] = make_float2(fmaf(h3, dif.y, mid.x), fmaf(-h3, dif.x, mid.y));
  v[2][s] = make_float2(fmaf(-h3, dif.y, mid.x), fmaf(h3, dif.x, mid.y));
  if constexpr (s + 1 < P) radix3<N, P, T, s + 1>(v, wj1, wj2);
}

// Y_a = (Z + conj Zp) / 2 and Y_b = (Z - conj Zp) / 2i: rows a and b of Z[k]
// = FFT(a + ib)[k], Zp = Z[N - k].
static __device__ __forceinline__ float2 split_a(float2 z, float2 zp) {
  return make_float2(0.5f * (z.x + zp.x), 0.5f * (z.y - zp.y));
}

static __device__ __forceinline__ float2 split_b(float2 z, float2 zp) {
  return make_float2(0.5f * (z.y + zp.y), 0.5f * (zp.x - z.x));
}

// Y[m, k] = y in the caller's layout; rows past m are not stored.
static __device__ __forceinline__ void put(const Args& a, int k, long long m, float2 y) {
  if (m >= a.m) return;
  const long long o = k * a.sk + m * a.sm;
  if (a.layout == 2) {
    *reinterpret_cast<float2*>(a.re + o) = make_float2(y.x, a.im_sign * y.y);
  } else {
    a.re[o] = y.x;
    a.im[o] = a.im_sign * y.y;
  }
}

// The split and the store of a warp plan. Thread j of transform g holds Z[k]
// in v[c][s], k = j + s*T + M*c. Z[N - k] sits in thread T - j at
// v[K-1-c][P-1-s] (one shuffle), or, for j = 0, in the thread itself. The
// channel-major layouts gather, for one register, Mi consecutive rows of the
// warp by Kc channels into one store instruction (lane l: row l mod Mi,
// channel l / Mi), two shuffles a float; the (M, N) layout stores each
// thread's own channels.
template <int N, int M, int K, int P, int T>
static __device__ __forceinline__ void store_warp(const Args& a, const float2 (&v)[K][P], int j,
                                                  long long mw, long long ma) {
  constexpr int kWarpRows = 64 / T;  // two rows a transform, 32/T transforms a warp
  constexpr int Mi = kWarpRows < 32 ? kWarpRows : 32;
  constexpr int Kc = 32 / Mi;
  const int lane = threadIdx.x & 31;
  const int partner = (T - j) & (T - 1);
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const float2 z = v[c][s];
      float2 zp = s == 0 ? v[(K - c) % K][0] : v[K - 1 - c][(P - s) % P];  // j = 0
      if constexpr (T > 1) {
        const float2 o = v[K - 1 - c][P - 1 - s];
        const float2 far = make_float2(__shfl_sync(0xffffffffu, o.x, partner, T),
                                       __shfl_sync(0xffffffffu, o.y, partner, T));
        zp = j == 0 ? zp : far;
      }
      const float2 ya = split_a(z, zp), yb = split_b(z, zp);
      const int k0 = s * T + M * c;
      if (a.layout == 0) {
        put(a, k0 + j, ma, ya);
        put(a, k0 + j, ma + 1, yb);
        continue;
      }
#pragma unroll
      for (int rc = 0; rc < kWarpRows / Mi; ++rc) {
#pragma unroll
        for (int jc = 0; jc < T / Kc; ++jc) {
          const int row = rc * Mi + lane % Mi;
          const int src = (row >> 1) * T + jc * Kc + lane / Mi;
          const float ar = __shfl_sync(0xffffffffu, ya.x, src);
          const float ai = __shfl_sync(0xffffffffu, ya.y, src);
          const float br = __shfl_sync(0xffffffffu, yb.x, src);
          const float bi = __shfl_sync(0xffffffffu, yb.y, src);
          const bool odd = row & 1;
          put(a, k0 + jc * Kc + lane / Mi, mw + row,
              make_float2(odd ? br : ar, odd ? bi : ai));
        }
      }
    }
  }
}

// The split and the store of a shared-memory plan: Z into the exchange
// buffer at its channel's slot, then every thread of the block takes (row,
// channel) elements with the row fastest (channel-major layouts) or the
// channel fastest.
template <int N, int M, int K, int P, int T, int XS>
static __device__ __forceinline__ void store_block(const Args& a, const float2 (&v)[K][P], int j,
                                                   int g, float2* xbuf, long long f) {
  constexpr int R = 2 * (kThreads / T);
  float2* mine = xbuf + g * XS;
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int s = 0; s < P; ++s) mine[xslot(j + s * T + M * c)] = v[c][s];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * N; e += kThreads) {
    int row, k;
    if (a.layout == 0) {
      row = e / N;
      k = e - row * N;
    } else {
      k = e / R;
      row = e - k * R;
    }
    const float2* x = xbuf + (row >> 1) * XS;
    const float2 z = x[xslot(k)], zp = x[xslot(k == 0 ? 0 : N - k)];
    put(a, k, f + row, (row & 1) ? split_b(z, zp) : split_a(z, zp));
  }
}

template <bool kRaw, int LOG, int K3>
__global__ void __launch_bounds__(kThreads, Plan<LOG, K3>::B) pfb_fft_kernel(Args a) {
  using Pl = Plan<LOG, K3>;
  constexpr int M = 1 << LOG, K = K3 ? 3 : 1, N = K * M, P = Pl::P, T = M / P;
  constexpr int XS = exchange_slots(N);
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float2* xbuf = reinterpret_cast<float2*>(ring + a.cap * a.rs);
  const int g = threadIdx.x / T;
  const int j = threadIdx.x - g * T;
  float2 wj1 = make_float2(1.0f, 0.0f), wj2 = wj1;
  if constexpr (K3) {
    wj1 = w3m<N>(j);
    wj2 = w3m<N>(2 * j);
  }
  walk<N>(a, ring, [&](long long f, int base) {
    float2 v[K][P];
    branch_fir<kRaw, N, K, P, T>(a, ring, base, f, 2 * g, j, v);
    // a row past the end is zero: its inputs may still be live (the look-back), and
    // its transform's rounding would land on its pair row's spectrum
    const bool past_a = f + 2 * g >= a.m, past_b = f + 2 * g + 1 >= a.m;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int s = 0; s < P; ++s) {
        v[c][s].x = past_a ? 0.0f : v[c][s].x;
        v[c][s].y = past_b ? 0.0f : v[c][s].y;
      }
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if constexpr (Pl::kWarp) {
        warp_fft<M, P>(v[c], j);
      } else {
        fft<M, P, Pl::R0, Pl::R1, Pl::R2, Pl::R3>(v[c], j, xbuf + g * XS);
      }
    }
    if constexpr (K3) radix3<N, P, T>(v, wj1, wj2);
    if constexpr (Pl::kWarp) {
      store_warp<N, M, K, P, T>(a, v, j, f + (threadIdx.x >> 5) * (64 / T), f + 2 * g);
    } else {
      store_block<N, M, K, P, T, XS>(a, v, j, g, xbuf, f);
    }
  });
}

// u[f + delta, q] (B20): the ring's copy for resident taps, else device memory.
static __device__ __forceinline__ float branch_input(const Args& a, const float* ring, int base,
                                                     long long f, int delta, int q,
                                                     bool ring_tap) {
  if (ring_tap) return ring_row(a, ring, base, delta)[q];
  return at(device_row(a, f + delta), q);
}

// Any other N (B20 only; B19's envelope is powers of two): v lines in shared
// memory (n + 1 floats a row), then each thread takes (row, k) outputs for
// k <= n/2, the row fastest for the channel-major layouts: Y[k] = sum_q v[q]
// W^(qk mod n) from the staged twiddles, and Y[n - k] = conj Y[k] beside it.
__global__ void __launch_bounds__(kThreads) pfb_direct_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int n = a.n, vs = n + 1, half = n / 2 + 1;
  float* ring = reinterpret_cast<float*>(smem4);
  float* lines = ring + a.cap * a.rs;
  float2* tws = reinterpret_cast<float2*>(lines + ((a.rows * vs + 1) & ~1));
  for (int q = threadIdx.x; q < n; q += kThreads) tws[q] = __ldg(a.tw + q);
  walk<0>(a, ring, [&](long long f, int base) {
    for (int e = threadIdx.x; e < a.rows * n; e += kThreads) {
      const int row = e / n, q = e - row * n;
      float acc = 0.0f;
      for (int r = 0; r < a.p; ++r) {
        const float x = branch_input(a, ring, base, f, row - a.d * r, q, r < a.resident);
        acc = fmaf(__ldg(a.hq + r * n + q), x, acc);
      }
      lines[row * vs + q] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < a.rows * half; e += kThreads) {
      int row, k;
      if (a.layout == 0) {
        row = e / half;
        k = e - row * half;
      } else {
        k = e / a.rows;
        row = e - k * a.rows;
      }
      const float* line = lines + row * vs;
      float2 y = make_float2(0.0f, 0.0f);
      int jj = 0;  // q*k mod n
      for (int q = 0; q < n; ++q) {
        const float2 w = tws[jj];
        y.x = fmaf(line[q], w.x, y.x);
        y.y = fmaf(line[q], w.y, y.y);
        jj += k;
        jj = jj >= n ? jj - n : jj;
      }
      put(a, k, f + row, y);
      if (k != 0 && 2 * k != n) put(a, n - k, f + row, make_float2(y.x, -y.y));
    }
  });
}

// A launchable kernel: its function, rows a step (0: the caller's) and
// shared bytes beyond the ring.
struct Launch {
  const void* kernel;
  int rows;
  int extra;
  int index;  // into the per-kernel record of shared-memory limits set
};

template <bool kRaw, int LOG, int K3>
static Launch fft_launch(int index) {
  using Pl = Plan<LOG, K3>;
  constexpr int N = (K3 ? 3 : 1) << LOG, T = (1 << LOG) / Pl::P, G = kThreads / T;
  return {reinterpret_cast<const void*>(pfb_fft_kernel<kRaw, LOG, K3>), 2 * G,
          Pl::kWarp ? 0 : 8 * G * exchange_slots(N), index};
}

constexpr int kLaunches = 2 * 32;

// The kernel for n: a power of two 2..8192 or 3 * 2^a up to 6144 takes its
// FFT plan (B19 only inside its envelope, n in 32..1024), any other n the
// direct DFT (B20 only).
template <bool kRaw>
static bool launch_for(int n, Launch* out) {
  constexpr int b = kRaw ? 0 : 32;
  if (kRaw) {
    switch (n) {
      case 32: *out = fft_launch<true, 5, 0>(b + 5); return true;
      case 64: *out = fft_launch<true, 6, 0>(b + 6); return true;
      case 128: *out = fft_launch<true, 7, 0>(b + 7); return true;
      case 256: *out = fft_launch<true, 8, 0>(b + 8); return true;
      case 512: *out = fft_launch<true, 9, 0>(b + 9); return true;
      case 1024: *out = fft_launch<true, 10, 0>(b + 10); return true;
      default: return false;
    }
  } else {
    switch (n) {
      case 2: *out = fft_launch<false, 1, 0>(b + 1); return true;
      case 4: *out = fft_launch<false, 2, 0>(b + 2); return true;
      case 8: *out = fft_launch<false, 3, 0>(b + 3); return true;
      case 16: *out = fft_launch<false, 4, 0>(b + 4); return true;
      case 32: *out = fft_launch<false, 5, 0>(b + 5); return true;
      case 64: *out = fft_launch<false, 6, 0>(b + 6); return true;
      case 128: *out = fft_launch<false, 7, 0>(b + 7); return true;
      case 256: *out = fft_launch<false, 8, 0>(b + 8); return true;
      case 512: *out = fft_launch<false, 9, 0>(b + 9); return true;
      case 1024: *out = fft_launch<false, 10, 0>(b + 10); return true;
      case 2048: *out = fft_launch<false, 11, 0>(b + 11); return true;
      case 4096: *out = fft_launch<false, 12, 0>(b + 12); return true;
      case 8192: *out = fft_launch<false, 13, 0>(b + 13); return true;
      case 3: *out = fft_launch<false, 0, 1>(b + 14); return true;
      case 6: *out = fft_launch<false, 1, 1>(b + 15); return true;
      case 12: *out = fft_launch<false, 2, 1>(b + 16); return true;
      case 24: *out = fft_launch<false, 3, 1>(b + 17); return true;
      case 48: *out = fft_launch<false, 4, 1>(b + 18); return true;
      case 96: *out = fft_launch<false, 5, 1>(b + 19); return true;
      case 192: *out = fft_launch<false, 6, 1>(b + 20); return true;
      case 384: *out = fft_launch<false, 7, 1>(b + 21); return true;
      case 768: *out = fft_launch<false, 8, 1>(b + 22); return true;
      case 1536: *out = fft_launch<false, 9, 1>(b + 23); return true;
      case 3072: *out = fft_launch<false, 10, 1>(b + 24); return true;
      case 6144: *out = fft_launch<false, 11, 1>(b + 25); return true;
      default:
        if (n < 1 || n > kMaxN) return false;
        *out = {reinterpret_cast<const void*>(pfb_direct_kernel), 0, 0, b + 26};
        return true;
    }
  }
}

// Floats a ring row: n rounded up to 16 bytes, 4 more where that is a
// multiple of 16 floats (neighbouring transforms' rows two apart then fall
// on other banks).
static int ring_stride(int n) {
  const int r4 = (n + 3) / 4 * 4;
  return r4 % 16 == 0 ? r4 + 4 : r4;
}

static int allowed[kLaunches][kMaxDevices] = {};

template <bool kRaw>
static int launch_pfb(const float* src, const float* hq, const void* tw, float* re, float* im,
                      int64_t m, int64_t n, int64_t p, int64_t d, int64_t sign, int64_t sk,
                      int64_t sm, int64_t layout, int64_t rows, int64_t steps, int64_t interleave,
                      int64_t lookback, int64_t prefetch, int64_t smem_bytes, void* stream) {
  Launch l;
  if (m < 1 || n < 1 || n > kMaxN || p < 1 || d < 1 || (sign != 1 && sign != -1) ||
      layout < 0 || layout > 2 || sk < 1 || sm < 1 || steps < 1 || lookback < 0 ||
      (interleave != 0 && interleave != 1) ||
      lookback > d * (p - 1) + (kRaw ? 1 : 0) || (prefetch != 0 && prefetch != 1) ||
      !launch_for<kRaw>(static_cast<int>(n), &l) || rows < 1 || (l.rows && rows != l.rows) ||
      rows * n > (int64_t{1} << 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ni = static_cast<int>(n), rs = ring_stride(ni);
  const int64_t cap =
      interleave ? (1 + prefetch) * (lookback + rows) : lookback + (1 + prefetch) * rows;
  const int64_t extra = l.rows ? l.extra : 4 * ((rows * (n + 1) + 1) / 2 * 2) + 8 * n;
  const int64_t total_steps = (m + rows - 1) / rows;
  const int64_t blocks = (total_steps + steps - 1) / steps;
  if (smem_bytes != 4 * cap * rs + extra || smem_bytes > 232448 || blocks > 0x7fffffff ||
      (!l.rows && tw == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t raw = kRaw ? 1 : 0;
  const int64_t resident = lookback < raw ? 0 : std::min<int64_t>(p, (lookback - raw) / d + 1);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  Args a{src, hq, static_cast<const float2*>(tw), re, im, m, sk, sm, total_steps, ni,
         static_cast<int>(p), static_cast<int>(d), static_cast<int>(rows), rs,
         static_cast<int>(lookback), static_cast<int>(cap), static_cast<int>(resident),
         static_cast<int>(steps), static_cast<int>(interleave), static_cast<int>(prefetch),
         vec ? 1 : 0,
         static_cast<int>(layout), -static_cast<float>(sign)};
  const int smem = static_cast<int>(smem_bytes);
  cudaError_t err = allow_smem(l.kernel, allowed[l.index], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchKernel(l.kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
                         static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pfb
}  // namespace dsp

// B19. x: the (m * n,) float32 stream; hq: (p, n) float32; tw: unused (may be
// null); re, im: outputs, element (row m, channel k) at m * sm + k * sk floats
// (im 4 bytes past re for complex64, layout 2). layout 0 (m, n) planes, 1
// (n, m) planes, 2 (n, m) complex64. rows, steps, interleave, lookback,
// prefetch and smem_bytes: the wrapper's PfbGeometry (rows the plan's;
// smem_bytes checked against the ring and the plan's exchange).
extern "C" int dsp_pfb_raw(const float* x, const float* hq, const void* tw, float* re, float* im,
                           int64_t m, int64_t n, int64_t p, int64_t d, int64_t sign, int64_t sk,
                           int64_t sm, int64_t layout, int64_t rows, int64_t steps,
                           int64_t interleave, int64_t lookback, int64_t prefetch,
                           int64_t smem_bytes, void* stream) {
  return dsp::pfb::launch_pfb<true>(x, hq, tw, re, im, m, n, p, d, sign, sk, sm, layout, rows,
                                    steps, interleave, lookback, prefetch, smem_bytes, stream);
}

// B20. u: the (m, n) float32 branch inputs; tw: n complex64 twiddles
// exp(-2 pi i q / n) for the direct route (n neither a power of two nor
// 3 * 2^a), else unused; the rest as for dsp_pfb_raw.
extern "C" int dsp_pfb_branch(const float* u, const float* hq, const void* tw, float* re,
                              float* im, int64_t m, int64_t n, int64_t p, int64_t d,
                              int64_t sign, int64_t sk, int64_t sm, int64_t layout, int64_t rows,
                              int64_t steps, int64_t interleave, int64_t lookback,
                              int64_t prefetch, int64_t smem_bytes, void* stream) {
  return dsp::pfb::launch_pfb<false>(u, hq, tw, re, im, m, n, p, d, sign, sk, sm, layout, rows,
                                     steps, interleave, lookback, prefetch, smem_bytes, stream);
}

// What the compiler gave B19 (kind 0) or B20 (kind 1) at n channels:
// registers a thread, local bytes a thread, shared bytes a block (static and
// smem_bytes of dynamic), blocks an SM at smem_bytes, threads a block (5
// int64 in out).
extern "C" int dsp_pfb_attrs(int64_t kind, int64_t n, int64_t smem_bytes, int64_t* out) {
  using namespace dsp::pfb;
  Launch l;
  if ((kind != 0 && kind != 1) || n < 1 || n > kMaxN || smem_bytes < 0 || smem_bytes > 232448 ||
      !(kind == 0 ? launch_for<true>(static_cast<int>(n), &l)
                  : launch_for<false>(static_cast<int>(n), &l))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(smem_bytes);
  cudaError_t err = dsp::allow_smem(l.kernel, allowed[l.index], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, l.kernel)) != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  out[2] = static_cast<int64_t>(a.sharedSizeBytes) + smem;
  out[3] = blocks;
  out[4] = kThreads;
  return 0;
}
