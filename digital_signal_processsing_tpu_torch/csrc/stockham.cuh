// Register-resident Stockham FFT passes, shared by the fused overlap-save
// FIR (B8, fused_fir.cu) and the polyphase filter bank (B19, B20, pfb.cu).
//
// A transform of N points is carried by T = N/P threads, each holding P
// points in registers: thread j holds point j + s*T in v[s], s < P. A pass
// of radix R after passes whose radices multiply to Ns is the Stockham
// step: butterfly b = j + q*T (q < P/R) takes the points b + r*N/R, which
// are v[q + (P/R)*r], multiplies them by the twiddles W_{Ns R}^((b mod Ns) r),
// runs an R-point DFT in registers (radix-2 stages, the W_R constants folded
// at compile time) and sends output k to point (b / Ns)*Ns*R + (b mod Ns) +
// k*Ns. Between passes the points are exchanged: through shared memory
// (`pass`: written where they go, read where the next pass wants them, two
// barriers an exchange; one pad after every 16 points against bank
// conflicts), or, for a two-pass plan whose T threads sit in one warp, by
// shuffles (`warp_fft`: the exchange is a transpose of T x T blocks, done
// by log2 T rounds of __shfl_xor_sync). After the last pass output k of
// butterfly b is point b + k*N/R, which is v[q + (P/R)*k] again: the
// spectrum comes out in natural order in the layout the samples went in.
//
// Twiddles are computed, not read: W^e for e = (b mod Ns) r with
// sincospif, whose argument 2e/(Ns R) is exact in float32 (CUDA's
// sincospif is within 1 ulp); r = 4a + c takes the product of the exact
// W^(4ea) and W^(ec), so each twiddle is within about 3 ulp (2e-7) of
// exp(-2 pi i e / (Ns R)).
//
// Registers. Every index into v must fold to a constant, or v goes to local
// memory: the butterflies, DFT stages and bit reversals are template
// constants or flat loops of constant trip count.
#pragma once

#include <cuda_runtime.h>

#include "fft.cuh"

namespace dsp {
namespace stockham {

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

// k reversed in its low L bits; a constant where k is one (__brev folds).
template <int L>
static __device__ __forceinline__ int brev(int k) {
  return static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - L));
}

static __device__ __forceinline__ int xslot(int e) { return e + (e >> 4); }

// cos(pi m / 16) for 0 <= m <= 16; m is a constant wherever it is called.
static __device__ __forceinline__ float cospi16(int m) {
  switch (m) {
    case 0: return 1.0f;
    case 1: return 0.980785280403230449126f;
    case 2: return 0.923879532511286756128f;
    case 3: return 0.831469612302545237079f;
    case 4: return 0.707106781186547524401f;
    case 5: return 0.555570233019602224743f;
    case 6: return 0.382683432365089771728f;
    case 7: return 0.195090322016128267848f;
    case 8: return 0.0f;
    case 9: return -0.195090322016128267848f;
    case 10: return -0.382683432365089771728f;
    case 11: return -0.555570233019602224743f;
    case 12: return -0.707106781186547524401f;
    case 13: return -0.831469612302545237079f;
    case 14: return -0.923879532511286756128f;
    case 15: return -0.980785280403230449126f;
    default: return -1.0f;
  }
}

// z * W_32^m = z * exp(-2 pi i m / 32), 0 <= m < 16, m a constant.
static __device__ __forceinline__ float2 mul_w32(float2 z, int m) {
  if (m == 0) return z;
  if (m == 8) return make_float2(z.y, -z.x);  // times -i
  const float c = cospi16(m), s = cospi16(m < 8 ? 8 - m : m - 8);
  return make_float2(fmaf(z.x, c, z.y * s), fmaf(z.y, c, -z.x * s));
}

// One radix-2 stage of decimation in frequency over v[q + Q*r], r < R:
// pairs (r, r + H) of each run of 2H, the difference times W_{2H}^i. Every
// index is a template constant or one of a flat loop of constant trip count,
// so that they all fold and v stays in registers.
template <int R, int Q, int q, int H, int P>
static __device__ __forceinline__ void dif_stage(float2 (&v)[P]) {
#pragma unroll
  for (int u = 0; u < R / 2; ++u) {
    const int i = u % H;
    const int p0 = q + Q * ((u / H) * 2 * H + i), p1 = p0 + Q * H;
    const float2 a = v[p0], b = v[p1];
    v[p0] = cadd(a, b);
    v[p1] = mul_w32(csub(a, b), i * (16 / H));
  }
}

// The R-point DFT of v[q + Q*r], r < R, in place, by radix-2 decimation in
// frequency: output k lands in v[q + Q*brev<log2 R>(k)].
template <int R, int Q, int q, int H = R / 2, int P>
static __device__ __forceinline__ void dft(float2 (&v)[P]) {
  dif_stage<R, Q, q, H>(v);
  if constexpr (H > 1) dft<R, Q, q, H / 2>(v);
}

// v[q + Q*r] *= W_span^(e r) for 0 < r < R: W^(e c) for c < 4 and W^(4 e a)
// from sincospif, their product for the rest.
template <int R, int Q, int q, int P>
static __device__ __forceinline__ void twiddle(float2 (&v)[P], float x1) {
  // x1 = 2e / span: W^(e r) = cospi(r x1) - i sinpi(r x1), r x1 exact
  constexpr int C = R < 4 ? R : 4;
  float2 u[C];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    float s, co;
    sincospif(x1 * c, &s, &co);
    u[c] = make_float2(co, -s);
  }
#pragma unroll
  for (int a = 0; a < R / C; ++a) {
    float2 z = make_float2(1.0f, 0.0f);
    if (a > 0) {
      float s, co;
      sincospif(x1 * (C * a), &s, &co);
      z = make_float2(co, -s);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int r = C * a + c;
      if (r == 0) continue;
      const float2 w = a == 0 ? u[c] : (c == 0 ? z : cmul(z, u[c]));
      v[q + Q * r] = cmul(v[q + Q * r], w);
    }
  }
}

// Butterfly q (and those after it) of a Stockham pass of radix R after
// passes whose radices multiply to NS: b = j + q*T. Not the last pass: the
// outputs go to `buf`. The last: they stay in v, in natural order.
template <int N, int P, int R, int NS, bool LAST, int q = 0>
static __device__ __forceinline__ void butterflies(float2 (&v)[P], int j, float2* buf) {
  constexpr int T = N / P, Q = P / R, L = ilog2(R);
  const int b = j + q * T;
  if constexpr (NS > 1) twiddle<R, Q, q>(v, static_cast<float>(b % NS) * (2.0f / (NS * R)));
  dft<R, Q, q>(v);
  if constexpr (!LAST) {
    const int d = (b / NS) * (NS * R) + b % NS;
#pragma unroll
    for (int k = 0; k < R; ++k) buf[xslot(d + k * NS)] = v[q + Q * brev<L>(k)];
  } else {
    float2 o[R];
#pragma unroll
    for (int k = 0; k < R; ++k) o[k] = v[q + Q * brev<L>(k)];
#pragma unroll
    for (int k = 0; k < R; ++k) v[q + Q * k] = o[k];
  }
  if constexpr (q + 1 < Q) butterflies<N, P, R, NS, LAST, q + 1>(v, j, buf);
}

// One Stockham pass of radix R after passes whose radices multiply to NS.
// Not the last: the outputs go through `buf` and v is reloaded in the next
// pass's layout. The last: the outputs stay, in natural order.
template <int N, int P, int R, int NS, bool LAST>
static __device__ __forceinline__ void pass(float2 (&v)[P], int j, float2* buf) {
  constexpr int T = N / P;
  butterflies<N, P, R, NS, LAST>(v, j, buf);
  if constexpr (!LAST) {
    __syncthreads();
#pragma unroll
    for (int s = 0; s < P; ++s) v[s] = buf[xslot(j + s * T)];
    __syncthreads();  // read before the next pass writes
  }
}

// The forward DFT of a transform's N points, natural order in v and out, by
// two to four passes (R2 = 0 for two, R3 = 0 for three) exchanging through
// `buf` (N + N/16 slots a transform).
template <int N, int P, int R0, int R1, int R2, int R3 = 0>
static __device__ __forceinline__ void fft(float2 (&v)[P], int j, float2* buf) {
  pass<N, P, R0, 1, false>(v, j, buf);
  if constexpr (R2 == 0) {
    pass<N, P, R1, R0, true>(v, j, buf);
  } else if constexpr (R3 == 0) {
    pass<N, P, R1, R0, false>(v, j, buf);
    pass<N, P, R2, R0 * R1, true>(v, j, buf);
  } else {
    pass<N, P, R1, R0, false>(v, j, buf);
    pass<N, P, R2, R0 * R1, false>(v, j, buf);
    pass<N, P, R3, R0 * R1 * R2, true>(v, j, buf);
  }
}

// The exchange of a two-pass plan whose T threads sit in one warp (T a power
// of two <= 32, a transform's lanes consecutive and aligned to T): thread j's
// w[t*Q + q] goes to thread t's w[j*Q + q], a transpose of T x T blocks of Q
// points. Round h (h = 1, 2, ..., T/2) swaps bit h of the lane with bit h of
// t: the registers t and t ^ h cross between lanes j and j ^ h where those
// bits differ, one __shfl_xor_sync a float; the selects fold, so no index into
// w is a variable.
template <int T, int Q, int P>
static __device__ __forceinline__ void transpose_shfl(float2 (&w)[P], int j) {
#pragma unroll
  for (int h = 1; h < T; h <<= 1) {
    const bool hi = (j & h) != 0;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      if ((c / Q) & h) continue;  // t-bit h clear; its partner is c + h*Q
      const int c1 = c + h * Q;
      const float2 send = hi ? w[c] : w[c1];
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, h),
                                     __shfl_xor_sync(0xffffffffu, send.y, h));
      w[c] = hi ? got : w[c];
      w[c1] = hi ? w[c1] : got;
    }
  }
}

// The forward DFT of M = P*T points carried by T threads of one warp (T <= P),
// natural order in v and out, with no shared memory and no barrier. Pass 1 is
// the P-point DFT of each thread's points (radix P, no twiddles): output k1 of
// thread r is the Stockham intermediate r*P + k1. Pass 2 (radix T, after P)
// wants, at butterfly b = j + q*T, the outputs k1 = b of every thread r in
// v[q + Q*r]: the transpose above, with pass 1's outputs first placed at
// w[t*Q + q] for k1 = t + q*T. T = 1: one pass.
template <int M, int P>
static __device__ __forceinline__ void warp_fft(float2 (&v)[P], int j) {
  constexpr int T = M / P;
  if constexpr (T == 1) {
    if constexpr (P > 1) butterflies<M, P, P, 1, true>(v, 0, nullptr);
  } else {
    static_assert(T <= P && T <= 32, "a warp plan holds T <= P threads of one warp");
    constexpr int Q = P / T, L = ilog2(P);
    dft<P, 1, 0>(v);  // output k1 in v[brev(k1)]
    float2 w[P];
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int q = 0; q < Q; ++q) w[t * Q + q] = v[brev<L>(t + q * T)];
    }
    transpose_shfl<T, Q>(w, j);
    butterflies<M, P, T, P, true>(w, j, nullptr);
#pragma unroll
    for (int s = 0; s < P; ++s) v[s] = w[s];
  }
}

}  // namespace stockham
}  // namespace dsp
