// Radix-2 FFT stages over lines of complex float32 in shared memory, for
// the four-step overlap-save kernel (fused_fir3.cu B9), and the segment
// addressing both fused kernels share (B8, fused_fir.cu, runs its own
// transform in registers).
//
// A buffer holds G lines of M = 2^logM points. Point `pos` of line `line`
// sits at slot(line, pos, logM): one padding point after every 16 and one
// after each line, so that the column passes (neighbouring threads on
// neighbouring lines) and the first stages (neighbouring threads 2 or 4
// points apart) spread over the shared-memory banks. Every stage spreads the
// work of all lines over the block's threads and ends with __syncthreads();
// a pass does two radix-2 stages (radix 4) from registers, one stage when
// log2 M is odd. Twiddles come from a table in device memory,
// tw[q] = exp(-2*pi*i*q/N) for q in [0, N), computed on the host in float64
// and rounded to float32; a line of M points reads W_M^q = tw[q * (N/M)], so
// one table serves every line length.
//
//   fft_dif   forward by decimation in frequency: natural order in,
//             bit-reversed order out
//   ifft_dit  inverse by decimation in time, without the 1/M scale:
//             bit-reversed order in, natural order out
//
// So a forward transform, a product with a spectrum stored in bit-reversed
// order (the wrappers permute the taps' spectrum once) and an inverse
// transform need no reordering pass, and no thread ever scatters to or
// gathers from bit-reversed addresses, which would put a warp's 32 accesses
// on one bank.
#pragma once

#include <cuda_runtime.h>

namespace dsp {

// Points a line of 2^logM points occupies, padding included.
static __host__ __device__ __forceinline__ int line_slots(int logM) {
  return (1 << logM) + (1 << logM) / 16 + 1;
}

static __device__ __forceinline__ int slot(int line, int pos, int logM) {
  return line * line_slots(logM) + pos + (pos >> 4);
}

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
static __device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// i reversed in its low `bits` bits (bits >= 1)
static __device__ __forceinline__ int bit_reverse(int i, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - bits));
}

// Unit i of a pass over two radix-2 stages whose groups are 4m = 2^(t+2)
// points: its four points are base + {0, m, 2m, 3m} of its line, and
// j = base mod m sets its twiddles W_{4m}^j, W_{4m}^(j+m) = -i W_{4m}^j and
// W_{2m}^j = W_M^(j * M / 2m).
struct Unit {
  int line;
  int base;
  int j;
};

static __device__ __forceinline__ Unit unit(int i, int logM, int t) {
  const int u = i & ((1 << (logM - 2)) - 1);
  const int j = u & ((1 << t) - 1);
  return {i >> (logM - 2), ((u >> t) << (t + 2)) + j, j};
}

static __device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

static __device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// -i * a
static __device__ __forceinline__ float2 mul_minus_i(float2 a) { return make_float2(a.y, -a.x); }

// One radix-2 stage of pairs (base, base + m), m = 2^s, over all lines.
template <bool kForward>
static __device__ void radix2_stage(float2* buf, int logM, int G, const float2* __restrict__ tw,
                                    int stride, int s) {
  const int total = G << (logM - 1);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int b = i & ((1 << (logM - 1)) - 1);
    const int line = i >> (logM - 1);
    const int j = b & ((1 << s) - 1);
    const int base = ((b >> s) << (s + 1)) + j;
    const int lo = slot(line, base, logM);
    const int hi = slot(line, base + (1 << s), logM);
    const float2 w = tw[(j << (logM - 1 - s)) * stride];
    const float2 u = buf[lo];
    if (kForward) {  // decimation in frequency
      const float2 v = buf[hi];
      buf[lo] = cadd(u, v);
      buf[hi] = cmul(csub(u, v), w);
    } else {  // decimation in time, conjugate twiddles
      const float2 v = cmul_conj(buf[hi], w);
      buf[lo] = cadd(u, v);
      buf[hi] = csub(u, v);
    }
  }
  __syncthreads();
}

// Radix-2 stages t+1 and t (forward) or t and t+1 (inverse) in one pass:
// each thread keeps a unit's four points in registers between the two.
template <bool kForward>
static __device__ void radix4_pass(float2* buf, int logM, int G, const float2* __restrict__ tw,
                                   int stride, int t) {
  const int total = G << (logM - 2);
  const int m = 1 << t;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const Unit f = unit(i, logM, t);
    const int p0 = slot(f.line, f.base, logM);
    const int p1 = slot(f.line, f.base + m, logM);
    const int p2 = slot(f.line, f.base + 2 * m, logM);
    const int p3 = slot(f.line, f.base + 3 * m, logM);
    const float2 w4 = tw[(f.j << (logM - 2 - t)) * stride];  // W_{4m}^j
    const float2 w2 = tw[(f.j << (logM - 1 - t)) * stride];  // W_{2m}^j
    const float2 x0 = buf[p0], x1 = buf[p1], x2 = buf[p2], x3 = buf[p3];
    if (kForward) {  // decimation in frequency: half-size 2m, then m
      const float2 a0 = cadd(x0, x2), a1 = cadd(x1, x3);
      const float2 a2 = cmul(csub(x0, x2), w4);
      const float2 a3 = cmul(csub(x1, x3), mul_minus_i(w4));
      buf[p0] = cadd(a0, a1);
      buf[p1] = cmul(csub(a0, a1), w2);
      buf[p2] = cadd(a2, a3);
      buf[p3] = cmul(csub(a2, a3), w2);
    } else {  // decimation in time: half-size m, then 2m; conjugate twiddles
      const float2 v1 = cmul_conj(x1, w2), v3 = cmul_conj(x3, w2);
      const float2 a0 = cadd(x0, v1), a1 = csub(x0, v1);
      const float2 a2 = cadd(x2, v3), a3 = csub(x2, v3);
      const float2 c2 = cmul_conj(a2, w4), c3 = cmul_conj(a3, mul_minus_i(w4));
      buf[p0] = cadd(a0, c2);
      buf[p2] = csub(a0, c2);
      buf[p1] = cadd(a1, c3);
      buf[p3] = csub(a1, c3);
    }
  }
  __syncthreads();
}

static __device__ void fft_dif(float2* buf, int logM, int G, const float2* __restrict__ tw,
                               int stride) {
  int s = logM - 1;
  if (logM & 1) radix2_stage<true>(buf, logM, G, tw, stride, s--);
  for (; s >= 1; s -= 2) radix4_pass<true>(buf, logM, G, tw, stride, s - 1);
}

static __device__ void ifft_dit(float2* buf, int logM, int G, const float2* __restrict__ tw,
                                int stride) {
  int t = 0;
  for (; t + 1 < logM; t += 2) radix4_pass<false>(buf, logM, G, tw, stride, t);
  if (t < logM) radix2_stage<false>(buf, logM, G, tw, stride, t);
}

// The segment of row r of the flattened (channels, segments) grid.
struct Segment {
  long long ch;     // its channel: samples at ch * t
  long long first;  // s*block - (k-1): signal index of transform point 0
  long long out;    // s*block: signal index of the first kept output
};

static __device__ __forceinline__ Segment segment(long long r, long long nb, long long k,
                                                  long long block) {
  const long long ch = r / nb;
  const long long s = r - ch * nb;
  return {ch, s * block - (k - 1), s * block};
}

// Sample g of a channel, zero outside [0, t).
static __device__ __forceinline__ float sample(const float* xc, long long g, long long t) {
  return (g >= 0 && g < t) ? xc[g] : 0.0f;
}

}  // namespace dsp
